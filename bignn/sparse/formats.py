"""Padded, destination-sorted sparse graph containers (SURVEY.md T1).

Design rationale (not a port):

The reference (codeKgu/BiLevel-Graph-Neural-Network; reconstructed in
SURVEY.md §2.1 R6) batches variable-size molecule graphs as a PyG disjoint
union ``Batch`` and aggregates with unsorted CUDA ``scatter_add``. Here
everything is laid out for static shapes and contiguous destination ranges:

  * Edges of the disjoint union are globally sorted by destination node id.
    Neighbor aggregation is then ``segment_sum(x[src] * w, dst)`` over sorted
    segments, and block-local layouts give each 128-row block one contiguous
    edge range.
  * All shapes are static (jit-stable). Padding slots use segment id
    ``num_segments`` (one past the end), which segment reductions drop, so the
    hot path needs no mask multiplies.
  * GCN normalization (symmetric, with self-loops) is precomputed on the host
    into per-edge weights — the device never touches degree computation.

Host-side builders use NumPy; the containers are JAX pytrees (registered
dataclasses) so they can be device_put / sharded / passed through jit
directly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from bignn.utils.pytree import pytree_dataclass, static_field


# ---------------------------------------------------------------------------
# Host-side (NumPy) input record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class COOGraph:
    """One inner graph (e.g. a molecule) in host memory, COO edge list.

    ``edges`` holds directed edges; for undirected inputs callers should pass
    both directions (see :func:`symmetrize`). ``node_feat`` is `[n, F]`
    (e.g. one-hot atom types — SURVEY.md §2.1 R4).
    """

    node_feat: np.ndarray  # [n, F] float
    src: np.ndarray  # [e] int
    dst: np.ndarray  # [e] int

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def symmetrize(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return both directions of an undirected edge list, deduplicated."""
    s = np.asarray(np.concatenate([src, dst]), np.int64)
    d = np.asarray(np.concatenate([dst, src]), np.int64)
    n = int(max(s.max(), d.max())) + 1 if len(s) else 0
    if n and n <= np.iinfo(np.int64).max // (n + 1):
        # composite-key unique: one int64 sort instead of np.unique(axis=0)
        # over [2E, 2] rows (~10x at 20M edges — the config-#4-scale
        # partition build needs it, parallel/partition.py)
        uk = np.unique(s * np.int64(n) + d)
        return uk // n, uk % n
    uniq = np.unique(np.stack([s, d], axis=1), axis=0)
    return uniq[:, 0], uniq[:, 1]


# ---------------------------------------------------------------------------
# Device-side pytree containers
# ---------------------------------------------------------------------------


@pytree_dataclass
class PaddedGraphBatch:
    """Disjoint union of up to ``num_graphs`` inner graphs, padded to caps.

    Static-shape invariants (enforced by :func:`build_padded_batch`):
      * ``node_feat``: [node_cap, F]; rows past the real nodes are zero.
      * ``edge_src``/``edge_dst``: [edge_cap]; sorted ascending by ``edge_dst``;
        padding entries have ``edge_src = 0`` and ``edge_dst = node_cap``
        (dropped by segment reductions with num_segments=node_cap).
      * ``edge_weight``: [edge_cap]; GCN-normalized weight (or 1.0), 0 on pads.
      * ``graph_ids``: [node_cap]; molecule index per node, ``num_graphs`` on
        padding rows (dropped by readout segment reductions).
      * ``node_mask``: [node_cap] float 1/0.
      * ``graph_n_nodes``: [num_graphs] float — real node count per graph (for
        mean readout without a device-side count).

    Replaces the reference's PyG ``Batch`` + ``batch`` vector
    (SURVEY.md §2.1 R6) with a jit-stable layout.
    """

    node_feat: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    graph_ids: np.ndarray
    graph_n_nodes: np.ndarray
    num_graphs: int = static_field()
    node_cap: int = static_field()
    edge_cap: int = static_field()
    # optional source-sort permutation (static per graph): edge_src_perm =
    # argsort(edge_src), edge_src_sorted = edge_src[edge_src_perm]. No op
    # consumes it any more.
    edge_src_perm: np.ndarray | None = None
    edge_src_sorted: np.ndarray | None = None
    # optional dense block-diagonal adjacency (block-local layouts only, small
    # enough batches): since every inner graph lies inside one 128-row block,
    # the whole union adjacency is block-diagonal — [nblk, 128, 128] with
    # block_adj[b, d, s] = sum of edge_weight over in-block edges s->d and
    # block_cnt the edge multiplicity (GIN's unweighted sum, attention masks).
    # Inner aggregation then becomes ONE batched matmul
    # (ops.block_diag_spmm) instead of a gather and a scatter per edge.
    block_adj: np.ndarray | None = None
    block_cnt: np.ndarray | None = None


@pytree_dataclass
class OuterGraph:
    """The outer interaction graph (drug-drug), destination-sorted + padded.

    Same layout contract as :class:`PaddedGraphBatch` but for a single graph
    whose "node features" are the drug embeddings produced by the inner level
    (SURVEY.md §3.2 OUTER LEVEL).
    """

    edge_src: np.ndarray  # [edge_cap] int32, sorted by edge_dst
    edge_dst: np.ndarray  # [edge_cap] int32
    edge_weight: np.ndarray  # [edge_cap] float32
    num_nodes: int = static_field()
    edge_cap: int = static_field()
    edge_src_perm: np.ndarray | None = None  # argsort(edge_src), see above
    edge_src_sorted: np.ndarray | None = None
    # Dense materialization (small outer graphs only): DDI graphs are tiny
    # (DrugBank ~1.7K drugs) but dense in edges (~9%); at that shape every
    # per-edge op becomes an [N, N] matmul or fused elementwise pass.
    #   dense_adj[d, s] = sum of edge_weight over edges s->d   (GCN SpMM)
    #   dense_cnt[d, s] = edge multiplicity                    (GIN sum,
    #     GAT/DotAttn softmax mask — exact even with duplicate edges:
    #     multiplicity m scales exp(e) by m, identical to m sparse edges)
    dense_adj: np.ndarray | None = None  # [num_nodes, num_nodes] f32
    dense_cnt: np.ndarray | None = None  # [num_nodes, num_nodes] f32


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``x`` to length ``n`` with ``fill``."""
    if x.shape[0] > n:
        raise ValueError(f"cannot pad length {x.shape[0]} down to {n}")
    pad_width = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def gcn_normalize(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric GCN normalization with optional self-loops.

    Returns ``(src, dst, weight)`` with ``weight[e] = 1/sqrt(d_src * d_dst)``
    where degrees count self-loops. Mirrors the reference's reliance on PyG
    ``GCNConv`` normalization (SURVEY.md §2.1 R5) but precomputed on host.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    # isolated nodes (deg 0 can only happen without self-loops)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
    w = inv_sqrt[src] * inv_sqrt[dst]
    return src, dst, w.astype(np.float32)


def src_sort_arrays(edge_src: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed (argsort(src), src[argsort]) over the PADDED edge
    array — static per graph, so the SpMM backward's sorted-segment scatter
    needs no device sort. Stable sort reproduces jnp.argsort exactly."""
    perm = np.argsort(edge_src, kind="stable").astype(np.int32)
    return perm, edge_src[perm].astype(np.int32)


def _sort_by_dst(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order], w[order]


def _build_sorted(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    normalize: bool,
    add_self_loops: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted-by-dst edges (+ self loops, + GCN weights).

    Uses the native C++ counting-sort builder when available (8x faster than
    the NumPy path at 10M edges — bignn/native), NumPy otherwise.
    """
    from bignn import native

    if native.available():
        s, d, w = native.build_sorted_graph(
            src, dst, num_nodes, add_self_loops=add_self_loops, normalize=normalize
        )
        return s.astype(np.int64), d.astype(np.int64), w
    if normalize:
        s, d, w = gcn_normalize(src, dst, num_nodes, add_self_loops)
    else:
        s, d = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        if add_self_loops:
            loop = np.arange(num_nodes, dtype=np.int64)
            s = np.concatenate([s, loop])
            d = np.concatenate([d, loop])
        w = np.ones(s.shape[0], np.float32)
    return _sort_by_dst(s, d, w)


def build_padded_batch(
    graphs: Sequence[COOGraph],
    node_cap: int,
    edge_cap: int,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    dtype=np.float32,
    block_local: bool = False,
    block_dense_max_nodes: int = 131072,
    graph_slots: Sequence[int] | None = None,
    num_graphs_override: int | None = None,
) -> PaddedGraphBatch:
    """Build the padded disjoint union of ``graphs``.

    ``edge_cap`` must account for self-loops when ``add_self_loops`` is set
    (i.e. ``sum(e_i) + sum(n_i)``).

    ``block_local=True`` places graphs at greedily packed 128-row block
    offsets (no graph straddles a block boundary; requires every graph
    <= 128 nodes and ``node_cap`` a multiple of 128 covering the packed
    extent). Real edges remain a dst-sorted prefix either way, so all
    non-block ops stay valid.

    When additionally ``node_cap <= block_dense_max_nodes`` the adjacency is
    also materialized as dense [nblk, 128, 128] blocks (``block_adj`` /
    ``block_cnt``) so inner aggregation runs as one batched matmul
    (ops.block_diag_spmm); 0 disables. At the default cap the two arrays
    together are <= 134 MB f32, uploaded once per dataset.

    ``graph_slots`` (r5, for the p2 sharded inner): readout graph id per
    POSITION — graph i's nodes get id ``graph_slots[i]`` instead of i, so a
    subset of a shard's drugs (e.g. its boundary molecules) reads out into
    the right [B, d] rows. Must be strictly increasing so edge dst-sort
    order equals slot order. ``num_graphs_override`` widens the readout
    segment count beyond ``len(graphs)`` (shards read out into a uniform
    [B, d] even when they own fewer drugs; empty slots stay zero).
    """
    num_graphs = len(graphs)
    if num_graphs == 0:
        raise ValueError("empty graph list")
    feat_dim = graphs[0].node_feat.shape[1]
    if graph_slots is not None:
        graph_slots = np.asarray(graph_slots, np.int32)
        if len(graph_slots) != num_graphs:
            raise ValueError("graph_slots must match len(graphs)")
        if num_graphs > 1 and not np.all(np.diff(graph_slots) > 0):
            raise ValueError("graph_slots must be strictly increasing")
    if num_graphs_override is not None:
        if num_graphs_override < num_graphs:
            raise ValueError("num_graphs_override < len(graphs)")
        if graph_slots is not None and len(graph_slots) and (
                int(graph_slots[-1]) >= num_graphs_override):
            raise ValueError("graph_slots exceed num_graphs_override")

    sizes = np.asarray([g.num_nodes for g in graphs], np.int32)
    if block_local:
        from bignn import native

        if node_cap % 128:
            raise ValueError("block_local needs node_cap % 128 == 0")
        offsets, extent = native.greedy_pack_blocks(sizes, 128)
        if extent > node_cap:
            raise ValueError(f"packed extent {extent} > node_cap {node_cap}")
    else:
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        extent = int(sizes.sum())
        if extent > node_cap:
            raise ValueError(f"total nodes {extent} > node_cap {node_cap}")

    out_graphs = (num_graphs if num_graphs_override is None
                  else int(num_graphs_override))
    node_feat = np.zeros((node_cap, feat_dim), dtype)
    node_mask = np.zeros(node_cap, dtype)
    graph_ids = np.full(node_cap, out_graphs, np.int32)
    srcs, dsts = [], []
    for gi, g in enumerate(graphs):
        n, off = int(sizes[gi]), int(offsets[gi])
        node_feat[off : off + n] = np.asarray(g.node_feat, dtype)
        node_mask[off : off + n] = 1.0
        graph_ids[off : off + n] = (
            gi if graph_slots is None else int(graph_slots[gi]))
        srcs.append(np.asarray(g.src, np.int64) + off)
        dsts.append(np.asarray(g.dst, np.int64) + off)
        if add_self_loops:
            # explicit per-graph loops: _build_sorted must NOT loop the
            # packing-gap rows, but normalization must still count loops
            loop = np.arange(off, off + n, dtype=np.int64)
            srcs.append(loop)
            dsts.append(loop)

    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    src, dst, w = _build_sorted(src, dst, extent, normalize, False)
    if src.shape[0] > edge_cap:
        raise ValueError(f"total edges {src.shape[0]} > edge_cap {edge_cap}")

    edge_src = pad_to(src.astype(np.int32), edge_cap, fill=0)
    edge_dst = pad_to(dst.astype(np.int32), edge_cap, fill=node_cap)
    edge_weight = pad_to(w, edge_cap, fill=0.0)
    sperm, ssorted = src_sort_arrays(edge_src)
    block = {}
    if block_local and 0 < node_cap <= block_dense_max_nodes:
        nblocks = node_cap // 128
        block_adj = np.zeros((nblocks, 128, 128), np.float32)
        block_cnt = np.zeros((nblocks, 128, 128), np.float32)
        b = dst // 128  # block locality: src // 128 == dst // 128
        np.add.at(block_adj, (b, dst % 128, src - b * 128), w)
        np.add.at(block_cnt, (b, dst % 128, src - b * 128), 1.0)
        block = dict(block_adj=block_adj, block_cnt=block_cnt)

    if graph_slots is None and num_graphs_override is None:
        n_nodes = sizes.astype(dtype)
    else:
        n_nodes = np.zeros(out_graphs, dtype)
        slots = (np.arange(num_graphs) if graph_slots is None
                 else graph_slots)
        n_nodes[slots] = sizes
    return PaddedGraphBatch(
        node_feat=node_feat,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_weight=edge_weight.astype(dtype),
        graph_ids=graph_ids,
        graph_n_nodes=n_nodes,
        num_graphs=out_graphs,
        node_cap=int(node_cap),
        edge_cap=int(edge_cap),
        edge_src_perm=sperm,
        edge_src_sorted=ssorted,
        **block,
    )


def build_outer_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    edge_cap: int | None = None,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    symmetrize_edges: bool = True,
    dense_max_nodes: int = 4096,
) -> OuterGraph:
    """Build the padded outer interaction graph from an undirected edge list.

    The reference treats DDI edges as undirected (SURVEY.md §2.1 R6); we store
    both directions so message passing covers each endpoint.

    When ``num_nodes <= dense_max_nodes`` the graph is also materialized
    densely (``dense_adj``/``dense_cnt``, <=2x67MB at the cap) so the outer
    convs take the dense path; 0 disables. Large graphs (config #4's
    100K drugs) stay sparse automatically.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize_edges:
        src, dst = symmetrize(src, dst)
    src, dst, w = _build_sorted(src, dst, num_nodes, normalize, add_self_loops)
    dense_adj = dense_cnt = None
    if 0 < num_nodes <= dense_max_nodes:
        dense_adj = np.zeros((num_nodes, num_nodes), np.float32)
        np.add.at(dense_adj, (dst, src), w)
        dense_cnt = np.zeros((num_nodes, num_nodes), np.float32)
        np.add.at(dense_cnt, (dst, src), 1.0)
    n_edges = src.shape[0]
    if edge_cap is None:
        edge_cap = ((n_edges + 127) // 128) * 128
    if n_edges > edge_cap:
        raise ValueError(f"edges {n_edges} > edge_cap {edge_cap}")
    edge_src = pad_to(src.astype(np.int32), edge_cap, fill=0)
    sperm, ssorted = src_sort_arrays(edge_src)
    return OuterGraph(
        edge_src=edge_src,
        edge_dst=pad_to(dst.astype(np.int32), edge_cap, fill=num_nodes),
        edge_weight=pad_to(w, edge_cap, fill=0.0),
        num_nodes=int(num_nodes),
        edge_cap=int(edge_cap),
        edge_src_perm=sperm,
        edge_src_sorted=ssorted,
        dense_adj=dense_adj,
        dense_cnt=dense_cnt,
    )
