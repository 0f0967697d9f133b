"""Multi-head weighted aggregation: out[d,h] = sum_e alpha[e,h] * v[src_e,h]
(SURVEY.md §2.2 N3 — the GAT/DotAttn message aggregation).

One op instead of per-head SpMM calls. Every per-edge tensor lives in the
flat [E, H*D] layout: the per-head alpha broadcast is expressed so no
[E, H, D]-shaped value exists (broadcast and reshape fuse into the multiply).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bignn.ops.gather import gather_rows
from bignn.ops.segment import segment_sum


def _alpha_wide(alpha: jax.Array, d: int, dtype) -> jax.Array:
    """[E, H] -> [E, H*D] per-head broadcast, fusable (no 3D gather)."""
    e, h = alpha.shape
    return jnp.broadcast_to(
        alpha[:, :, None], (e, h, d)).reshape(e, h * d).astype(dtype)


def spmm_multihead(
    v: jax.Array,  # [N, H, D] per-head values
    src: jax.Array,  # [E]
    dst: jax.Array,  # [E] sorted
    alpha: jax.Array,  # [E, H] per-edge per-head weights
    num_out: int,
) -> jax.Array:
    """Returns [num_out, H, D]."""
    n, h, d = v.shape
    v2 = v.reshape(n, h * d)
    msgs = gather_rows(v2, src) * _alpha_wide(alpha, d, v2.dtype)
    agg = segment_sum(msgs, dst, num_out)
    return agg.reshape(num_out, h, d)
