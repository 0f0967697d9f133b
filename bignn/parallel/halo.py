"""Halo exchange + distributed outer propagation (SURVEY.md P2 flagship).

The boundary-embedding all-to-all (BASELINE.json:5,11): each shard
owns a contiguous drug-node block and all incoming edges of its nodes
(parallel/partition.py). Per outer layer:

  1. transform owned rows (dense matmul, local);
  2. gather the boundary rows each peer needs (static plan indices) and
     exchange them with ONE ``lax.all_to_all`` over the 'graph' mesh axis —
     XLA lowers it to an NCCL all-to-all over NVLink;
  3. aggregate locally with the sorted-segment SpMM (edge dst ids are
     shard-local; the global destination sort is preserved by construction).

For GAT, the per-source attention logits ride in the same payload as the
transformed features (feature-concat), so attention costs no extra round.

Everything here is written for use inside ``jax.shard_map`` with axis name
'graph'; AD through shard_map transposes the collectives, so gradients are
correct without hand-written backward collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bignn.models.convs import GATConv, GCNConv, GINConv
from bignn.models.modules import parse_activation
from bignn.ops import segment_softmax, segment_sum, spmm_multihead, spmm_sorted_coo
from bignn.ops.gather import gather_rows


def _a2a(sendbuf: jax.Array, axis_name: str) -> jax.Array:
    """The wire step shared by every exchange below: one all-to-all of the
    [G, S, F] send buffer (XLA schedules it asynchronously)."""
    return jax.lax.all_to_all(sendbuf, axis_name, split_axis=0, concat_axis=0)


def halo_exchange(
    h_local: jax.Array,  # [B, F] owned rows
    send_idx: jax.Array,  # [G, S] local ids to send to each peer
    axis_name: str = "graph",
) -> jax.Array:
    """Return the extended array [B + G*S, F]: owned rows ++ received halos.

    Row B + h*S + k holds slot k received from shard h, matching the ext-id
    remapping baked into the plan's edge_src.
    """
    sendbuf = jnp.take(h_local, send_idx, axis=0, mode="clip")  # [G, S, F]
    g = send_idx.shape[0]
    recv = _a2a(sendbuf, axis_name)
    _, s, f = recv.shape
    return jnp.concatenate([h_local, recv.reshape(g * s, f)], axis=0)


# ---------------------------------------------------------------------------
# distributed outer conv layers (one halo exchange each)
# ---------------------------------------------------------------------------


def dist_gcn_apply(conv: GCNConv, params, h_local, src, dst, weight, send_idx,
                   axis_name: str = "graph", remat: bool = False):
    """Boundary-first schedule: the [G, S] boundary rows are transformed and
    put on the wire BEFORE the full-width transform, so the all-to-all is in
    flight while the [B, F] matmul runs (XLA async collectives overlap
    independent work). Transform commutes with the row gather, so values are
    identical to exchange-after-transform; boundary rows are transformed
    twice (G*S << B rows — negligible)."""
    b = h_local.shape[0]
    bnd = jnp.take(h_local, send_idx, axis=0, mode="clip")  # [G, S, in]
    sendbuf = jnp.dot(bnd, params["w"], preferred_element_type=jnp.float32)
    recv = _a2a(sendbuf, axis_name)
    h_t = jnp.dot(h_local, params["w"], preferred_element_type=jnp.float32)
    g, s, f = recv.shape
    ext = jnp.concatenate([h_t, recv.reshape(g * s, f)], axis=0)
    agg = spmm_sorted_coo(ext, src, dst, weight, b)
    return parse_activation(conv.activation)(agg + params["b"])


def dist_gin_apply(conv: GINConv, params, h_local, src, dst, weight, send_idx,
                   axis_name: str = "graph", remat: bool = False):
    """GIN sends RAW rows (its transform happens after aggregation), so
    boundary-first transform overlap doesn't apply — but aggregation is
    LINEAR, so the edge list splits by source locality:
    local-src edges (src < B, rows already resident) aggregate while the
    all-to-all is in flight; the remote-src contribution is added when the
    halo arrives. Masking rides the SpMM weight vector (0/1), which
    preserves the dst-sort; values equal the unsplit aggregation up to fp
    reassociation (the equality test runs at allclose tolerance,
    tests/test_p2_overlap.py)."""
    del weight
    b = h_local.shape[0]
    sendbuf = jnp.take(h_local, send_idx, axis=0, mode="clip")  # [G, S, d]
    recv = _a2a(sendbuf, axis_name)
    w_loc = (src < b).astype(h_local.dtype)
    g, s, f = recv.shape
    # local-src aggregation — no dependency on recv, overlaps the exchange
    agg = spmm_sorted_coo(h_local, jnp.minimum(src, b - 1), dst, w_loc, b)
    halo = recv.reshape(g * s, f)
    agg = agg + spmm_sorted_coo(
        halo, jnp.clip(src - b, 0, g * s - 1), dst, 1.0 - w_loc, b)
    from bignn.models.modules import MLP

    hidden = conv.hidden_dim or conv.out_dim
    mlp = MLP((conv.in_dim, hidden, conv.out_dim), conv.activation)
    out = mlp.apply(params["mlp"], agg + params["eps"] * h_local)
    return parse_activation(conv.activation)(out)


def dist_gat_apply(conv: GATConv, params, h_local, src, dst, weight, send_idx,
                   axis_name: str = "graph", remat: bool = False):
    del weight
    b = h_local.shape[0]
    H, D = conv.heads, conv.head_dim
    # boundary-first (see dist_gcn_apply): transform + score the [G, S]
    # boundary rows, launch the a2a, then do the full-width transform while
    # the exchange is in flight. One payload carries features + src logits.
    bnd = jnp.take(h_local, send_idx, axis=0, mode="clip")  # [G, S, in]
    bnd_t = jnp.dot(bnd, params["w"], preferred_element_type=jnp.float32)
    g, s = bnd_t.shape[0], bnd_t.shape[1]
    sr_bnd = jnp.sum(bnd_t.reshape(g, s, H, D) * params["a_r"], axis=-1)
    sendbuf = jnp.concatenate([bnd_t, sr_bnd], axis=-1)  # [G, S, H*D + H]
    recv = _a2a(sendbuf, axis_name)
    h_t = jnp.dot(h_local, params["w"], preferred_element_type=jnp.float32)
    hh = h_t.reshape(b, H, D)
    score_l = jnp.sum(hh * params["a_l"], axis=-1)  # [B, H] dst part (local)
    score_r = jnp.sum(hh * params["a_r"], axis=-1)  # [B, H] src part
    payload = jnp.concatenate([h_t, score_r], axis=1)  # [B, H*D + H]
    ext = jnp.concatenate([payload, recv.reshape(g * s, -1)], axis=0)
    h_ext, sr_ext = ext[:, : H * D], ext[:, H * D :]
    def attn(score_l, sr_ext):
        e = gather_rows(score_l, dst) + gather_rows(sr_ext, src)
        e = jax.nn.leaky_relu(e, conv.negative_slope)  # [E, H]
        return segment_softmax(e, dst, b)

    # remat: the [E, H] attention temps (e, exp, alpha residuals) dominate
    # per-shard activation memory at config-#4-class edge counts;
    # recomputing them in the backward trades two [E]-gathers + a segment
    # softmax per step
    alpha = (jax.checkpoint(attn) if remat else attn)(score_l, sr_ext)
    agg = spmm_multihead(h_ext.reshape(-1, H, D), src, dst, alpha, b)
    return parse_activation(conv.activation)(
        agg.reshape(-1, H * D) + params["b"]
    )


_DIST_APPLY = {GCNConv: dist_gcn_apply, GINConv: dist_gin_apply, GATConv: dist_gat_apply}


# ---------------------------------------------------------------------------
# ext-based variants: the halo was exchanged as RAW embeddings earlier (the
# overlap path — transform commutes with aggregation for GCN, and GIN/GAT
# only need raw source rows), so the conv works off a precomputed ext array.
# ---------------------------------------------------------------------------


def dist_gcn_apply_ext(conv: GCNConv, params, h_local, ext, src, dst, weight,
                       remat: bool = False):
    b = h_local.shape[0]
    h_t_ext = jnp.dot(ext, params["w"], preferred_element_type=jnp.float32)
    agg = spmm_sorted_coo(h_t_ext, src, dst, weight, b)
    return parse_activation(conv.activation)(agg + params["b"])


def dist_gin_apply_ext(conv: GINConv, params, h_local, ext, src, dst, weight,
                       remat: bool = False):
    del weight
    b = h_local.shape[0]
    agg = spmm_sorted_coo(ext, src, dst, None, b)
    from bignn.models.modules import MLP

    hidden = conv.hidden_dim or conv.out_dim
    mlp = MLP((conv.in_dim, hidden, conv.out_dim), conv.activation)
    out = mlp.apply(params["mlp"], agg + params["eps"] * h_local)
    return parse_activation(conv.activation)(out)


def dist_gat_apply_ext(conv: GATConv, params, h_local, ext, src, dst, weight,
                       remat: bool = False):
    del weight
    b = h_local.shape[0]
    H, D = conv.heads, conv.head_dim
    hh_ext = jnp.dot(ext, params["w"], preferred_element_type=jnp.float32)
    hh_ext = hh_ext.reshape(-1, H, D)
    score_l = jnp.sum(hh_ext[:b] * params["a_l"], axis=-1)  # [B, H]
    score_r = jnp.sum(hh_ext * params["a_r"], axis=-1)  # [B+G*S, H]

    def attn(score_l, score_r):
        e = gather_rows(score_l, dst) + gather_rows(score_r, src)
        e = jax.nn.leaky_relu(e, conv.negative_slope)
        return segment_softmax(e, dst, b)

    alpha = (jax.checkpoint(attn) if remat else attn)(score_l, score_r)
    agg = spmm_multihead(hh_ext, src, dst, alpha, b)
    return parse_activation(conv.activation)(
        agg.reshape(-1, H * D) + params["b"]
    )


_DIST_APPLY_EXT = {
    GCNConv: dist_gcn_apply_ext,
    GINConv: dist_gin_apply_ext,
    GATConv: dist_gat_apply_ext,
}


def p2_overlap_forward(
    model,
    params: dict,
    bnd_batch,  # this shard's boundary-molecule union (leading axis stripped)
    int_batch,  # this shard's interior-molecule union
    edge_src: jax.Array,
    edge_dst: jax.Array,
    edge_weight: jax.Array,
    send_idx: jax.Array,  # [G, S]
    axis_name: str = "graph",
    encode_fn=None,
    remat: bool = False,
) -> jax.Array:
    """Distributed bi-level forward with the flagship overlap
    (BASELINE.json:5,11): boundary drugs encode first, their RAW embeddings
    enter the all-to-all, and the interior molecules' inner aggregation runs
    while the exchange is in flight (no data dependency — XLA's async
    collectives schedule them concurrently). Outer layer 1 consumes the raw
    ext; deeper layers use the boundary-first schedule (dist_*_apply): their
    exchange overlaps the layer's own full-width transform.

    ``encode_fn``: inner-encode override — make_p2_train_step passes a
    jax.checkpoint-wrapped encode when remat is on."""
    enc = encode_fn if encode_fn is not None else model.encode_inner
    h_bnd = enc(params, bnd_batch)  # [B, d]
    sendbuf = jnp.take(h_bnd, send_idx, axis=0, mode="clip")  # [G, S, d]
    recv = _a2a(sendbuf, axis_name)
    h_int = enc(params, int_batch)  # overlapped with the a2a
    h_local = h_bnd + h_int  # disjoint slots
    g, s, f = recv.shape
    ext = jnp.concatenate([h_local, recv.reshape(g * s, f)], axis=0)

    _, inner_dim = model._inner_stack()
    outer_layers, _ = model._outer_stack(inner_dim)
    for i, conv in enumerate(outer_layers):
        p = params["outer"][f"layer_{i}"]
        if i == 0:
            h_local = _DIST_APPLY_EXT[type(conv)](
                conv, p, h_local, ext, edge_src, edge_dst, edge_weight,
                remat=remat,
            )
        else:
            h_local = _DIST_APPLY[type(conv)](
                conv, p, h_local, edge_src, edge_dst, edge_weight, send_idx,
                axis_name, remat=remat,
            )
    return h_local


def dist_outer_forward(
    model,
    params: dict,
    h_local: jax.Array,  # [B, F] this shard's drug embeddings
    edge_src: jax.Array,  # [E_cap] ext ids
    edge_dst: jax.Array,  # [E_cap] local ids, sorted; pad = B
    edge_weight: jax.Array,
    send_idx: jax.Array,  # [G, S]
    axis_name: str = "graph",
    remat: bool = False,
) -> jax.Array:
    """Distributed equivalent of BiGNN.propagate_outer for one shard."""
    _, inner_dim = model._inner_stack()
    outer_layers, _ = model._outer_stack(inner_dim)
    for i, conv in enumerate(outer_layers):
        try:
            fn = _DIST_APPLY[type(conv)]
        except KeyError:
            raise NotImplementedError(
                f"distributed outer layer for {type(conv).__name__}"
            )
        h_local = fn(
            conv, params["outer"][f"layer_{i}"], h_local,
            edge_src, edge_dst, edge_weight, send_idx, axis_name,
            remat=remat,
        )
    return h_local
