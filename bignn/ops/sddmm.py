"""SDDMM: per-edge scores from dense node factors (SURVEY.md §2.2 N3).

Sampled dense-dense matmul: for each existing edge (s, d), compute
``score[e] = <q[d], k[s]>`` (or sum of per-head dots). Used by dot-product
attention on the outer DDI graph (BASELINE.json:5, 8) — only existing edges
are scored, never the dense N×N attention matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bignn.ops.gather import gather_rows


def sddmm(
    q: jax.Array,  # [N, H, D] or [N, D] destination factors
    k: jax.Array,  # [N, H, D] or [N, D] source factors
    src: jax.Array,  # [E]
    dst: jax.Array,  # [E]
) -> jax.Array:
    """Per-edge inner products; returns [E] or [E, H]."""
    qe = gather_rows(q, dst)
    ke = gather_rows(k, src)
    return jnp.sum(qe * ke, axis=-1)
