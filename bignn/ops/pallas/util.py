"""Shared Pallas plumbing.

``out_struct`` builds a ``jax.ShapeDtypeStruct`` whose varying-mesh-axes
(vma) annotation is inherited from the kernel's operands. Pallas cannot
infer vma for kernel outputs, and without the annotation ``jax.shard_map``'s
replication check rejects a kernel called inside it (the data-parallel
minibatch step builds its block adjacency there). A kernel output varies over
exactly the axes its operands vary over: the kernels are per-shard compute
with no collectives.
"""

from __future__ import annotations

import jax


def out_struct(shape, dtype, *operands) -> jax.ShapeDtypeStruct:
    """ShapeDtypeStruct with vma = union of the operands' vma sets."""
    vma: frozenset = frozenset()
    for x in operands:
        v = getattr(jax.typeof(x), "vma", None)
        if v:
            vma |= frozenset(v)
    return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
