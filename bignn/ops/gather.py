"""Row gather (SURVEY.md §2.2 N4: replaces ATen index_select).

Used for: source-node lookup in message passing, endpoint-embedding lookup
for edge scoring / negative sampling (SURVEY.md §3.2 SCORING), and the
per-edge score lookups of attention convs.

``gather_rows`` is the plain row gather; its AD backward is a scatter-add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_rows(table: jax.Array, indices: jax.Array) -> jax.Array:
    """``table[indices]`` with clipped out-of-range indices (padding-safe)."""
    return jnp.take(table, indices, axis=0, mode="clip")


def permutation_scatter_rows(values: jax.Array, idx: jax.Array) -> jax.Array:
    """``out[idx[j]] = values[j]`` for a *permutation* ``idx`` — scatter-free.

    ``idx`` must be a permutation of ``range(len(values))`` (every output row
    written exactly once). Because the map is a bijection, the scatter is
    exactly a gather by the inverse permutation: forward is
    ``values[argsort(idx)]`` and the VJP is ``g[idx]`` — both row gathers, so
    neither direction emits a scatter. Used by ``BiGNN.embed_drugs`` to
    place bucket embeddings into the [num_drugs, d] matrix (SURVEY.md §3.2
    step 1)."""
    return _perm_scatter(values, idx)


@jax.custom_vjp
def _perm_scatter(values, idx):
    return jnp.take(values, jnp.argsort(idx), axis=0)


def _perm_scatter_fwd(values, idx):
    return _perm_scatter(values, idx), idx


def _perm_scatter_bwd(idx, g):
    return jnp.take(g, idx, axis=0), None


_perm_scatter.defvjp(_perm_scatter_fwd, _perm_scatter_bwd)
