"""Sorted-COO SpMM: y[dst] += w * x[src] (SURVEY.md §2.2 N2).

This is the neighborhood-aggregation workhorse for both levels of the model
(BASELINE.json:5 names SpMM as a required kernel class):
  * inner convs aggregate atom states over molecular bonds,
  * outer convs propagate drug embeddings over the DDI graph.

Layout contract: ``dst`` sorted ascending, padding edges have ``dst ==
num_segments`` (dropped) and ``w == 0``. The adjacency is represented as
(src, dst, w) rather than CSR indptr because with sorted dst the two are
equivalent and the flat form is one gather plus one segment reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bignn.ops.gather import gather_rows
from bignn.ops.segment import segment_sum

BLOCK_ROWS = 128


def spmm_sorted_coo(
    x: jax.Array,  # [N, F] node features
    src: jax.Array,  # [E] int32
    dst: jax.Array,  # [E] int32, sorted ascending
    weight: jax.Array | None,  # [E] float or None (unweighted)
    num_out: int,
) -> jax.Array:
    """Compute ``out[i] = sum_{e: dst[e]==i} weight[e] * x[src[e]]``."""
    msgs = gather_rows(x, src)
    if weight is not None:
        msgs = msgs * weight[:, None].astype(msgs.dtype)
    return segment_sum(msgs, dst, num_out)


def build_block_adj_xla(src, dst, weight, num_nodes):
    """[N/128, 128, 128] f32 block-diagonal adjacency by one scatter-add.

    Edges whose endpoints do not share a 128-row block (padding) drop out:
    they get an out-of-range index, which the scatter skips. (Sending them
    all to one cell instead makes the GPU's atomics queue on that cell.)
    """
    nblk = num_nodes // BLOCK_ROWS
    size = nblk * BLOCK_ROWS * BLOCK_ROWS
    blk = dst // BLOCK_ROWS
    d_l = dst % BLOCK_ROWS
    s_l = src - blk * BLOCK_ROWS
    valid = (dst < num_nodes) & (s_l >= 0) & (s_l < BLOCK_ROWS)
    flat = jnp.where(valid, blk * BLOCK_ROWS * BLOCK_ROWS + d_l * BLOCK_ROWS
                     + s_l, size)
    w = (jnp.ones(flat.shape, jnp.float32) if weight is None
         else weight.astype(jnp.float32))
    out = jnp.zeros(size, jnp.float32).at[flat].add(w, mode="drop")
    return out.reshape(nblk, BLOCK_ROWS, BLOCK_ROWS)


def block_adjacency(
    src: jax.Array,
    dst: jax.Array,
    weight: jax.Array | None,
    num_nodes: int,
    out_dtype=jnp.float32,
) -> jax.Array:
    """[N/128, 128, 128] block-diagonal adjacency (weighted sum, or edge
    multiplicity when ``weight`` is None) from a block-local edge list, in
    ``out_dtype`` — the one-pass build that turns every later aggregation
    into a batched matmul."""
    return build_block_adj_xla(src, dst, weight, num_nodes).astype(out_dtype)


def block_diag_spmm(adj_blocks: jax.Array, x: jax.Array) -> jax.Array:
    """Dense block-diagonal SpMM: ``y = blockdiag(adj_blocks) @ x``.

    ``adj_blocks`` is [nblk, 128, 128] (dst-local x src-local within each
    128-row block of the block-local layout; sparse/formats.py builds it for
    small enough batches). One batched matmul in place of a gather and a
    scatter per edge; AD handles the backward (A^T stays block-diagonal).
    """
    nblk = adj_blocks.shape[0]
    n, f = x.shape
    assert n == nblk * BLOCK_ROWS, (n, nblk)
    y = jax.lax.dot_general(
        adj_blocks.astype(x.dtype),
        x.reshape(nblk, BLOCK_ROWS, f),
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    return y.reshape(n, f).astype(x.dtype)
