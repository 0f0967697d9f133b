"""Outer-graph edge partitioning for multi-chip propagation (SURVEY.md P2).

Scheme (owner-computes, contiguous node blocks):

  * Drug nodes are split into G contiguous blocks of B = ceil(N/G); shard g
    owns nodes [g*B, (g+1)*B). With per-shard embedding buffers of exactly B
    rows, the all-gathered matrix index equals the global node id — pair
    scoring needs no id remapping.
  * Each *directed* edge (s -> d) lives on owner(d). All incoming edges of a
    node are therefore on one shard: aggregation (and GAT segment-softmax)
    stays local. Because the global edge list is destination-sorted and
    ownership is by contiguous dst ranges, each shard's edges are a
    contiguous slice of the global list — the partition preserves the
    sorted-segment layout contract for free.
  * Every remote source node a shard references is a **boundary node**; the
    plan records, for each ordered shard pair (h -> g), the local indices
    shard h must send to g. At runtime this drives one ragged-padded
    all-to-all per outer layer (parallel/halo.py), which is the BI-GNN
    boundary-embedding exchange mandated by BASELINE.json:5,11.
  * Edge src ids are pre-remapped into the shard's *extended* array:
    [0, B) = owned rows, B + h*S + k = k-th slot received from shard h.

GCN normalization is computed globally before partitioning (degrees must be
global), so distributed results match single-device bitwise up to reduction
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bignn.sparse.formats import OuterGraph, symmetrize, _build_sorted


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass
class OuterPartitionPlan:
    """Static halo-exchange plan for one outer graph on G shards.

    Shapes are uniform across shards (leading G axis) so the whole plan can
    be fed through shard_map:
      send_idx   [G, G, S]  — send_idx[g, h] = local node ids shard g sends
                              to shard h (pad: 0; receivers never read pads)
      edge_src   [G, E_cap] — src ids into the extended array (see module
                              docstring); pad: 0
      edge_dst   [G, E_cap] — local dst ids; pad: B (dropped by segment ops)
      edge_weight[G, E_cap] — GCN weights; pad: 0
    """

    num_nodes: int
    n_shards: int
    node_block: int  # B
    halo_size: int  # S
    edge_cap: int
    send_idx: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    # overlap split (communication/computation overlap, BASELINE.json:5,11):
    # local_* edges have src on this shard (no halo dependency — aggregated
    # while the all-to-all is in flight); remote_* edges read halo slots
    # (src stored as ext id, i.e. >= B) and are aggregated after the wait.
    local_src: np.ndarray | None = None  # [G, E_loc_cap]
    local_dst: np.ndarray | None = None
    local_weight: np.ndarray | None = None
    remote_src: np.ndarray | None = None  # [G, E_rem_cap] (ext ids)
    remote_dst: np.ndarray | None = None
    remote_weight: np.ndarray | None = None

    @property
    def ext_size(self) -> int:
        return self.node_block + self.n_shards * self.halo_size

    def owner(self, node: np.ndarray) -> np.ndarray:
        return np.asarray(node) // self.node_block

    def stats(self) -> dict:
        real_edges = (self.edge_dst < self.node_block).sum(axis=1)
        return {
            "edges_per_shard": real_edges.tolist(),
            "halo_slots": int(self.halo_size),
            "edge_cap": int(self.edge_cap),
            "replication_factor": float(
                1.0 + self.n_shards * self.halo_size / max(self.num_nodes, 1)
            ),
        }


def boundary_drugs(plan: OuterPartitionPlan) -> list[np.ndarray]:
    """Per shard: local drug slots some peer needs (appear in send_idx with a
    real entry). Used to split the inner level so the boundary drugs encode
    first and their halo exchange overlaps interior encoding."""
    out = []
    for g in range(plan.n_shards):
        slots = set()
        for h in range(plan.n_shards):
            if h == g:
                continue
            # send_idx pads with 0; slot 0 is only real if some real edge
            # needs it — over-approximating by including it is harmless
            # (a boundary drug merely encodes in the first batch).
            slots.update(int(x) for x in plan.send_idx[g, h])
        out.append(np.asarray(sorted(slots), np.int64))
    return out


def _empty_like_batch(template):
    """All-padding PaddedGraphBatch with ``template``'s caps/fields (for a
    shard whose molecule subset is empty — e.g. an interior union when every
    owned drug is boundary)."""
    import dataclasses as _dc

    import numpy as np

    def zero(x):
        if x is None:
            return None
        out = np.zeros_like(x)
        return out

    rep = {f.name: zero(getattr(template, f.name))
           for f in _dc.fields(template)
           if isinstance(getattr(template, f.name), np.ndarray)}
    # padding conventions: edge dst points past node_cap; graph ids
    # point past num_graphs; perms must stay valid permutations
    nc, ng, ec = template.node_cap, template.num_graphs, template.edge_cap
    rep["edge_dst"] = np.full(ec, nc, np.int32)
    rep["graph_ids"] = np.full(nc, ng, np.int32)
    rep["edge_src_perm"] = np.arange(ec, dtype=np.int32)
    return _dc.replace(template, **rep)


def _build_shard_batches(groups, B, normalize, add_self_loops, block_local,
                         feat_dim):
    """One stacked PaddedGraphBatch from per-shard (graphs, slots) groups.

    All shards share identical caps (max over shards, 128-aligned) so the
    stack feeds straight through shard_map; graph ids are the given LOCAL
    drug slots and every shard reads out into a uniform [B, d]."""
    import numpy as np

    from bignn.sparse.formats import build_padded_batch

    if block_local:
        from bignn import native

        extents = []
        for gs, _ in groups:
            if gs:
                _, ext = native.greedy_pack_blocks(
                    np.asarray([g.num_nodes for g in gs], np.int32), 128)
            else:
                ext = 0
            extents.append(ext)
        node_cap = _round_up(max(max(extents), 128), 128)
    else:
        node_cap = _round_up(
            max(max((sum(g.num_nodes for g in gs) for gs, _ in groups),
                    default=8), 8), 8)
    e_tot = max(
        max((sum(g.num_edges for g in gs)
             + (sum(g.num_nodes for g in gs) if add_self_loops else 0)
             for gs, _ in groups), default=128), 128)
    edge_cap = _round_up(e_tot, 128)

    batches, template = [], None
    for gs, slots in groups:
        if gs:
            b = build_padded_batch(
                gs, node_cap=node_cap, edge_cap=edge_cap,
                normalize=normalize, add_self_loops=add_self_loops,
                block_local=block_local, graph_slots=slots,
                num_graphs_override=B)
            if template is None:
                template = b
            batches.append(b)
        else:
            batches.append(None)
    if template is None:
        # every shard's subset is empty (e.g. the interior union when all
        # drugs are boundary): synthesize the field structure from a
        # 1-node dummy, then wipe it to all-padding below
        from bignn.sparse.formats import COOGraph

        dummy = COOGraph(
            node_feat=np.zeros((1, feat_dim), np.float32),
            src=np.zeros(0, np.int64), dst=np.zeros(0, np.int64))
        template = _empty_like_batch(build_padded_batch(
            [dummy], node_cap=node_cap, edge_cap=edge_cap,
            normalize=normalize, add_self_loops=add_self_loops,
            block_local=block_local, graph_slots=[0],
            num_graphs_override=B))
    batches = [b if b is not None else _empty_like_batch(template)
               for b in batches]
    import jax

    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


def build_sharded_inner(
    molecules,
    plan: OuterPartitionPlan,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    split_boundary: bool = False,
    block_local: bool | None = None,
):
    """Per-shard padded molecule unions, stacked on a leading G axis.

    Shard g encodes the molecules of its owned drugs [g*B, (g+1)*B); the
    readout's graph ids are *local* drug slots so the inner level needs no
    communication at all. All shards share identical caps (max over shards,
    128-aligned edges) so the stack feeds straight through shard_map.

    ``block_local`` (default auto — on when every molecule has <= 128
    atoms, the same rule as sparse/bucketing.bucket_graphs): lay each
    shard's union out in packed 128-row blocks, so the p2 inner encode
    takes the block-diagonal path of the single-device trainers when the
    union is small enough to densify.

    With ``split_boundary`` (the overlap path, BASELINE.json:5,11) returns
    TWO stacked batches ``(boundary, interior)``: boundary drugs encode
    first so their embeddings can enter the halo all-to-all while interior
    molecules are still aggregating. Each drug is in exactly one union and
    keeps its local slot as graph id, so the two readouts merge by addition.
    """
    G, B = plan.n_shards, plan.node_block
    n = len(molecules)
    feat_dim = molecules[0].node_feat.shape[1]
    if block_local is None:
        block_local = max(m.num_nodes for m in molecules) <= 128
    bnd = boundary_drugs(plan) if split_boundary else None

    def owned(g):
        lo = g * B
        hi = min((g + 1) * B, n)
        return list(range(lo, hi))

    if not split_boundary:
        groups = []
        for g in range(G):
            ids = owned(g)
            groups.append(([molecules[i] for i in ids],
                           [i - g * B for i in ids]))
        return _build_shard_batches(
            groups, B, normalize, add_self_loops, block_local, feat_dim)

    bnd_groups, int_groups = [], []
    for g in range(G):
        ids = owned(g)
        bset = {s for s in bnd[g] if s < len(ids)}
        b_ids = [g * B + s for s in sorted(bset)]
        i_ids = [i for i in ids if (i - g * B) not in bset]
        bnd_groups.append(([molecules[i] for i in b_ids],
                           [i - g * B for i in b_ids]))
        int_groups.append(([molecules[i] for i in i_ids],
                           [i - g * B for i in i_ids]))
    return (
        _build_shard_batches(bnd_groups, B, normalize, add_self_loops,
                             block_local, feat_dim),
        _build_shard_batches(int_groups, B, normalize, add_self_loops,
                             block_local, feat_dim),
    )


def build_outer_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    n_shards: int,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    symmetrize_edges: bool = True,
) -> OuterPartitionPlan:
    """Build the plan from an undirected edge list (same input contract as
    sparse.formats.build_outer_graph)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize_edges:
        src, dst = symmetrize(src, dst)
    # global normalization + destination sort (native fast path when built)
    s, d, w = _build_sorted(src, dst, num_nodes, normalize, add_self_loops)

    B = -(-num_nodes // n_shards)
    owner_d = d // B  # shard of each edge (contiguous in the sorted list)
    owner_s = s // B

    # --- boundary sets, fully vectorized (r5 — the per-pair np.unique +
    # Python-dict slot remap was O(E) dict lookups and took minutes at
    # config-#4 scale, 100K nodes / ~20M directed edges; this build is a
    # few array passes). Unique (dst-shard g, src id) pairs over remote
    # edges; within a fixed g the unique srcs in ascending order are ALSO
    # grouped by source shard h in ascending order (h = src // B is
    # monotone in src), which is exactly the original send-set order.
    rem = owner_s != owner_d
    key = owner_d[rem] * np.int64(num_nodes) + s[rem]
    uk = np.unique(key)  # sorted by (g, src) == (g, h, src)
    g_of = uk // num_nodes
    s_glob = uk % num_nodes
    h_of = s_glob // B
    cnt_hg = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(cnt_hg, (h_of, g_of), 1)
    S = int(cnt_hg.max()) if len(uk) else 0
    S = max(_round_up(max(S, 1), 8), 8)

    # send_idx[h, g, :k] = ascending local ids shard h sends to g: resort
    # the unique pairs by (h, g, src); groups are contiguous and appear in
    # increasing h*G+g order, so group starts are an exclusive cumsum
    send_idx = np.zeros((n_shards, n_shards, S), np.int32)
    order_hg = np.lexsort((s_glob, g_of, h_of))
    h_o, g_o, s_o = h_of[order_hg], g_of[order_hg], s_glob[order_hg]
    grp = h_o * n_shards + g_o
    starts = np.concatenate(
        [[0], np.cumsum(np.bincount(grp, minlength=n_shards * n_shards))])
    rank = np.arange(len(grp)) - starts[grp]
    send_idx[h_o, g_o, rank] = (s_o - h_o * B).astype(np.int32)

    # ext slot of each unique (g, src): B + h*S + (rank of src within the
    # (g, h) group) — uk's own (g, h, src) order gives the ranks directly
    grp2 = g_of * n_shards + h_of
    starts2 = np.concatenate(
        [[0], np.cumsum(np.bincount(grp2, minlength=n_shards * n_shards))])
    ext_of_uk = B + h_of * S + (np.arange(len(uk)) - starts2[grp2])
    # per-g slices of (sorted src ids, ext ids) for searchsorted remap
    g_starts = np.concatenate(
        [[0], np.cumsum(np.bincount(g_of, minlength=n_shards))])

    # --- per-shard edge slices with remapped src ids; d is sorted, so each
    # shard's edges are one contiguous slice
    bounds = np.searchsorted(d, np.arange(n_shards + 1) * B)
    e_counts = np.diff(bounds)
    edge_cap = max(_round_up(int(e_counts.max()), 128), 128)
    edge_src = np.zeros((n_shards, edge_cap), np.int32)
    edge_dst = np.full((n_shards, edge_cap), B, np.int32)
    edge_w = np.zeros((n_shards, edge_cap), np.float32)
    per_shard = []
    for g in range(n_shards):
        sl = slice(bounds[g], bounds[g + 1])
        sg, dg, wg = s[sl], d[sl], w[sl]
        is_local = sg // B == g
        keys_g = s_glob[g_starts[g]: g_starts[g + 1]]
        ext_g = ext_of_uk[g_starts[g]: g_starts[g + 1]]
        src_l = sg - g * B
        if len(keys_g):
            ridx = np.searchsorted(keys_g, sg[~is_local])
            src_l[~is_local] = ext_g[ridx]
        n_e = len(sg)
        edge_src[g, :n_e] = src_l
        edge_dst[g, :n_e] = dg - g * B
        edge_w[g, :n_e] = wg
        per_shard.append((src_l, dg - g * B, wg, is_local))

    # --- overlap split: local-src vs halo-src edge lists (both dst-sorted,
    # order preserved from the globally sorted slice)
    loc_cap = max(_round_up(max(int(p[3].sum()) for p in per_shard), 128), 128)
    rem_cap = max(
        _round_up(max(int((~p[3]).sum()) for p in per_shard), 128), 128
    )
    local_src = np.zeros((n_shards, loc_cap), np.int32)
    local_dst = np.full((n_shards, loc_cap), B, np.int32)
    local_w = np.zeros((n_shards, loc_cap), np.float32)
    remote_src = np.zeros((n_shards, rem_cap), np.int32)
    remote_dst = np.full((n_shards, rem_cap), B, np.int32)
    remote_w = np.zeros((n_shards, rem_cap), np.float32)
    for g, (src_l, dst_l, wg, is_local) in enumerate(per_shard):
        nl = int(is_local.sum())
        nr = len(src_l) - nl
        local_src[g, :nl] = src_l[is_local]
        local_dst[g, :nl] = dst_l[is_local]
        local_w[g, :nl] = wg[is_local]
        remote_src[g, :nr] = src_l[~is_local]
        remote_dst[g, :nr] = dst_l[~is_local]
        remote_w[g, :nr] = wg[~is_local]

    return OuterPartitionPlan(
        num_nodes=num_nodes,
        n_shards=n_shards,
        node_block=B,
        halo_size=S,
        edge_cap=edge_cap,
        send_idx=send_idx,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_weight=edge_w,
        local_src=local_src,
        local_dst=local_dst,
        local_weight=local_w,
        remote_src=remote_src,
        remote_dst=remote_dst,
        remote_weight=remote_w,
    )
