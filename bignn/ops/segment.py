"""Sorted segment reductions (SURVEY.md §2.2 N1: replaces torch_scatter).

Padding uses out-of-range ids, which segment reductions drop. The layouts of
sparse/formats.py sort ``segment_ids`` ascending, but the quantized minibatch
layouts interleave masked padding, so every reduction passes
``indices_are_sorted=False``; XLA lowers them to scatter-adds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum(
    data: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
) -> jax.Array:
    """Sum rows of ``data`` into ``num_segments`` buckets."""
    return jax.ops.segment_sum(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )


def segment_mean(
    data: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
) -> jax.Array:
    """Mean over segments; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments)
    ones = jnp.ones(data.shape[:1], dtype=data.dtype)
    count = jax.ops.segment_sum(
        ones, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )
    return total / jnp.maximum(count, 1.0)[(...,) + (None,) * (data.ndim - 1)]


def segment_max(
    data: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
) -> jax.Array:
    """Max over segments; empty segments yield 0 (not -inf)."""
    out = jax.ops.segment_max(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )
    return jnp.where(jnp.isfinite(out), out, 0.0)


def segment_softmax(
    scores: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
) -> jax.Array:
    """Softmax of ``scores`` within each segment (GAT attention normalization).

    Replaces CUDA scatter-softmax (SURVEY.md §2.2 N3). ``scores`` is [E] or
    [E, H]; segments along axis 0. Out-of-range (padding) ids produce
    unspecified values on padded rows — downstream segment reductions drop
    their contributions.
    """
    seg_max = jax.ops.segment_max(
        scores, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    # softmax is shift-invariant: the max shift carries zero gradient, so
    # stop it and skip the scatter-heavy max backward entirely
    seg_max = jax.lax.stop_gradient(seg_max)
    # clip gathers for padding ids; their rows are dropped later anyway
    shifted = scores - jnp.take(seg_max, segment_ids, axis=0, mode="clip")
    expd = jnp.exp(shifted)
    denom = jax.ops.segment_sum(
        expd, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )
    return expd / jnp.maximum(jnp.take(denom, segment_ids, axis=0, mode="clip"), 1e-16)
