"""Graph convolution layers (SURVEY.md T3; reference layer zoo §2.1 R5).

Uniform interface: ``apply(params, x, edge_src, edge_dst, edge_weight,
num_nodes) -> x'`` where edges follow the sorted-by-dst + padded layout of
sparse/formats.py (edge_weight carries GCN normalization; convs that don't
want it pass unweighted aggregation instead).

The paper ablates inner conv types (GCN / GIN / GAT-family); BASELINE.json:8
names "GIN inner, GAT outer" as the full BI-GNN config. All four convs here
serve both levels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from bignn.models.modules import MLP, Dense, glorot, parse_activation
from bignn.ops import (
    block_diag_spmm,
    sddmm,
    segment_softmax,
    segment_sum,
    spmm_multihead,
    spmm_sorted_coo,
)
from bignn.ops.dispatch import use_gpu_kernels
from bignn.ops.gather import gather_rows


def _block_dense_masked_softmax_agg(e, cnt, v, compute_dtype):
    """Batched (per-128-block) masked attention aggregation.

    ``e``: [B, N, S, H], ``cnt``: [B, N, S], ``v``: [B, S, H, D] ->
    [B, N, H, D]. Blocks are independent molecules of the block-local
    layout, so this is exactly _dense_masked_softmax_agg vmapped over the
    block axis — attention never crosses a 128-row block (the layout
    contract), and padding blocks (cnt == 0 everywhere) aggregate to 0.
    """
    return jax.vmap(
        lambda eb, cb, vb: _dense_masked_softmax_agg(eb, cb, vb, compute_dtype)
    )(e, cnt, v)


def _dense_masked_softmax_agg(e, cnt, v, compute_dtype):
    """Dense attention aggregation over an adjacency-count mask.

    ``e``: [N, S, H] f32 edge scores (pre-softmax), ``cnt``: [N, S] edge
    multiplicity (0 = no edge), ``v``: [S, H, D] per-head values.
    Returns [N, H, D]. Exactly matches sparse ``segment_softmax`` +
    ``spmm_multihead``: multiplicity m scales exp(e) by m, and rows with no
    incoming edges aggregate to 0. The double-``where`` keeps exp() inputs
    finite so reverse-mode AD never multiplies a zero cotangent by inf.
    """
    valid = (cnt > 0)[:, :, None]  # [N, S, 1]
    m = jnp.max(jnp.where(valid, e, -jnp.inf), axis=1, keepdims=True)
    m = jnp.maximum(m, jnp.float32(-1e30))  # rows with no edges
    z = jnp.where(valid, e - m, -1.0)
    # floor must be a NORMAL f32: subnormals (e.g. 1e-38) flush to zero
    # under XLA's FTZ, which would reintroduce 0/0 here
    p = cnt[:, :, None] * jnp.exp(z)  # cnt==0 exactly where invalid
    denom = jnp.maximum(p.sum(axis=1, keepdims=True), jnp.float32(1e-30))
    alpha = (p / denom).astype(compute_dtype)
    return jnp.einsum(
        "dsh,shf->dhf", alpha, v, preferred_element_type=jnp.float32
    ).astype(compute_dtype)


@dataclasses.dataclass(frozen=True)
class GCNConv:
    """Kipf-Welling GCN: ``x' = act( A_norm (x W) + b )``.

    ``edge_weight`` must hold symmetric-normalized weights incl. self-loops
    (precomputed on host by sparse.formats.gcn_normalize).
    """

    in_dim: int
    out_dim: int
    activation: str = "relu"

    def init(self, key: jax.Array) -> dict:
        return {
            "w": glorot(key, (self.in_dim, self.out_dim)),
            "b": jnp.zeros((self.out_dim,), jnp.float32),
        }

    def apply(self, params, x, edge_src, edge_dst, edge_weight, num_nodes,
              dense=None, block_dense=None):
        h = jnp.dot(
            x, params["w"].astype(x.dtype), preferred_element_type=jnp.float32
        ).astype(x.dtype)
        if dense is not None:  # small outer graph: one dense matmul
            agg = jnp.dot(
                dense[0].astype(x.dtype), h, preferred_element_type=jnp.float32
            ).astype(x.dtype)
        elif block_dense is not None:  # block-diagonal batched matmul
            agg = block_diag_spmm(block_dense[0], h)
        else:
            agg = spmm_sorted_coo(h, edge_src, edge_dst, edge_weight, num_nodes)
        return parse_activation(self.activation)(agg + params["b"]).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class GINConv:
    """GIN: ``x' = MLP( (1+eps) x + sum_{u in N(v)} x_u )``.

    Aggregation is an *unweighted* sum. The stored edge list includes
    self-loops (layout contract), so the unweighted sum already contains
    ``x_v``; we therefore add ``eps * x`` to reach ``(1+eps) x + sum_neigh``.
    eps is learnable (train_eps=True behavior).
    """

    in_dim: int
    out_dim: int
    hidden_dim: int | None = None
    activation: str = "relu"

    def init(self, key: jax.Array) -> dict:
        hidden = self.hidden_dim or self.out_dim
        mlp = MLP((self.in_dim, hidden, self.out_dim), self.activation)
        return {"mlp": mlp.init(key), "eps": jnp.zeros((), jnp.float32)}

    def apply(self, params, x, edge_src, edge_dst, edge_weight, num_nodes,
              dense=None, block_dense=None):
        del edge_weight  # GIN ignores GCN normalization
        if dense is not None:  # unweighted sum = multiplicity matmul
            agg = jnp.dot(
                dense[1].astype(x.dtype), x, preferred_element_type=jnp.float32
            ).astype(x.dtype)
        elif block_dense is not None:  # unweighted block-diagonal matmul
            agg = block_diag_spmm(block_dense[1], x)
        else:
            agg = spmm_sorted_coo(x, edge_src, edge_dst, None, num_nodes)
        hidden = self.hidden_dim or self.out_dim
        mlp = MLP((self.in_dim, hidden, self.out_dim), self.activation)
        out = mlp.apply(params["mlp"], agg + params["eps"] * x)
        return parse_activation(self.activation)(out)


@dataclasses.dataclass(frozen=True)
class GATConv:
    """GAT (additive attention, multi-head concat).

    Per edge (s -> d): ``e = leaky_relu(a_l . Wx_d + a_r . Wx_s)``;
    ``alpha = segment_softmax(e over incoming edges of d)``;
    ``x'_d = act( concat_h sum_s alpha * Wx_s + b )``.
    Self-loop edges in the layout give each node attention over itself,
    matching PyG GATConv's add_self_loops default (SURVEY.md §2.1 R5).
    """

    in_dim: int
    out_dim: int  # total (heads * per-head dim)
    heads: int = 4
    activation: str = "relu"
    negative_slope: float = 0.2

    def __post_init__(self):
        if self.out_dim % self.heads:
            raise ValueError(f"out_dim {self.out_dim} not divisible by heads {self.heads}")

    @property
    def head_dim(self) -> int:
        return self.out_dim // self.heads

    def init(self, key: jax.Array) -> dict:
        kw, kl, kr = jax.random.split(key, 3)
        return {
            "w": glorot(kw, (self.in_dim, self.out_dim)),
            "a_l": glorot(kl, (self.heads, self.head_dim)),
            "a_r": glorot(kr, (self.heads, self.head_dim)),
            "b": jnp.zeros((self.out_dim,), jnp.float32),
        }

    def apply(self, params, x, edge_src, edge_dst, edge_weight, num_nodes,
              dense=None, block_dense=None):
        # attention replaces fixed normalization
        del edge_weight
        H, D = self.heads, self.head_dim
        h = jnp.dot(
            x, params["w"].astype(x.dtype), preferred_element_type=jnp.float32
        ).astype(x.dtype)
        hh = h.reshape(-1, H, D)
        score_l = jnp.sum(hh * params["a_l"], axis=-1)  # [N, H] (dst part)
        score_r = jnp.sum(hh * params["a_r"], axis=-1)  # [N, H] (src part)
        if block_dense is not None:  # block-diagonal masked attention:
            # molecules never cross a 128-row block, so per-block dense
            # attention is exact — GAT-inner models ride the same
            # block-local (and quantized resident) layouts as GIN/GCN
            cnt = block_dense[1]
            nblk = cnt.shape[0]
            e = jax.nn.leaky_relu(
                score_l.astype(jnp.float32).reshape(nblk, 128, 1, H)
                + score_r.astype(jnp.float32).reshape(nblk, 1, 128, H),
                self.negative_slope)
            agg = _block_dense_masked_softmax_agg(
                e, cnt, hh.reshape(nblk, 128, H, D), x.dtype
            ).reshape(-1, H, D)
        elif dense is not None:  # masked dense attention over [N, N]
            if use_gpu_kernels():
                # flash-tiled: no [N, N, H] intermediate reaches device memory
                from bignn.ops.pallas.flash_gat import flash_gat_attention

                agg = flash_gat_attention(
                    score_l.astype(jnp.float32), score_r.astype(jnp.float32),
                    hh, dense[1], self.negative_slope).astype(x.dtype)
            else:
                e = jax.nn.leaky_relu(
                    score_l[:, None, :] + score_r[None, :, :],
                    self.negative_slope)
                agg = _dense_masked_softmax_agg(e, dense[1], hh, x.dtype)
        else:
            e = gather_rows(score_l, edge_dst) + gather_rows(score_r, edge_src)
            e = jax.nn.leaky_relu(e, self.negative_slope)  # [E, H]
            alpha = segment_softmax(e, edge_dst, num_nodes)  # [E, H]
            agg = spmm_multihead(hh, edge_src, edge_dst, alpha.astype(x.dtype),
                                 num_nodes)
        return parse_activation(self.activation)(
            agg.reshape(-1, H * D) + params["b"]
        ).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class DotAttnConv:
    """Dot-product (transformer-style) attention conv — SDDMM consumer.

    ``e = <q_d, k_s> / sqrt(D)`` on existing edges only (SDDMM,
    BASELINE.json:5), segment-softmax over incoming edges, weighted sum of
    per-head values.
    """

    in_dim: int
    out_dim: int
    heads: int = 4
    activation: str = "relu"

    def __post_init__(self):
        if self.out_dim % self.heads:
            raise ValueError(f"out_dim {self.out_dim} not divisible by heads {self.heads}")

    @property
    def head_dim(self) -> int:
        return self.out_dim // self.heads

    def init(self, key: jax.Array) -> dict:
        kq, kk, kv = jax.random.split(key, 3)
        return {
            "wq": glorot(kq, (self.in_dim, self.out_dim)),
            "wk": glorot(kk, (self.in_dim, self.out_dim)),
            "wv": glorot(kv, (self.in_dim, self.out_dim)),
            "b": jnp.zeros((self.out_dim,), jnp.float32),
        }

    def apply(self, params, x, edge_src, edge_dst, edge_weight, num_nodes,
              dense=None, block_dense=None):
        del edge_weight
        H, D = self.heads, self.head_dim

        def _proj(w):
            return jnp.dot(
                x, w.astype(x.dtype), preferred_element_type=jnp.float32
            ).astype(x.dtype).reshape(-1, H, D)

        q = _proj(params["wq"])
        k = _proj(params["wk"])
        v = _proj(params["wv"])
        if block_dense is not None:  # per-block q.k (block-local layout)
            cnt = block_dense[1]
            nblk = cnt.shape[0]
            e = jnp.einsum(
                "bdhf,bshf->bdsh", q.reshape(nblk, 128, H, D),
                k.reshape(nblk, 128, H, D), preferred_element_type=jnp.float32,
            ) / jnp.sqrt(jnp.float32(D))
            agg = _block_dense_masked_softmax_agg(
                e, cnt, v.reshape(nblk, 128, H, D), x.dtype
            ).reshape(-1, H, D)
            return parse_activation(self.activation)(
                agg.reshape(-1, H * D) + params["b"]
            ).astype(x.dtype)
        if dense is not None:  # full q.k as one matmul, masked softmax
            e = jnp.einsum(
                "dhf,shf->dsh", q, k, preferred_element_type=jnp.float32
            ) / jnp.sqrt(jnp.float32(D))
            agg = _dense_masked_softmax_agg(e, dense[1], v, x.dtype)
            return parse_activation(self.activation)(
                agg.reshape(-1, H * D) + params["b"]
            ).astype(x.dtype)
        e = sddmm(q, k, edge_src, edge_dst) / jnp.sqrt(jnp.float32(D))  # [E, H]
        alpha = segment_softmax(e, edge_dst, num_nodes)
        agg = spmm_multihead(v, edge_src, edge_dst, alpha.astype(x.dtype), num_nodes)
        return parse_activation(self.activation)(
            agg.reshape(-1, H * D) + params["b"]
        ).astype(x.dtype)


def parse_conv(spec: str, in_dim: int):
    """Parse a layer spec string, e.g. ``"gcn:64"``, ``"gin:64"``,
    ``"gat:64:4"``, ``"dotattn:64:4"``, optional trailing ``:act``.

    Keeps the reference's config-driven layer construction
    (SURVEY.md §2.1 R2/R4) as data, typed.
    """
    parts = spec.split(":")
    kind = parts[0].lower()
    args = parts[1:]

    def _act(default="relu"):
        return args[-1] if args and not args[-1].isdigit() else default

    nums = [int(a) for a in args if a.isdigit()]
    if kind == "gcn":
        return GCNConv(in_dim, nums[0], activation=_act())
    if kind == "gin":
        hidden = nums[1] if len(nums) > 1 else None
        return GINConv(in_dim, nums[0], hidden_dim=hidden, activation=_act())
    if kind == "gat":
        heads = nums[1] if len(nums) > 1 else 4
        return GATConv(in_dim, nums[0], heads=heads, activation=_act())
    if kind == "dotattn":
        heads = nums[1] if len(nums) > 1 else 4
        return DotAttnConv(in_dim, nums[0], heads=heads, activation=_act())
    raise ValueError(f"unknown conv spec {spec!r}")
