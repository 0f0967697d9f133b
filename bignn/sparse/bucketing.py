"""Size-bucketing of variable-size inner graphs (SURVEY.md T1, §7 hard parts).

Variable-size molecule graphs can't be jit-compiled per exact size (one
compilation per shape) nor padded to the global max (quadratic waste). The
compromise is a small set of **buckets**: graphs are grouped by node count into
buckets with fixed (node_cap, edge_cap) so the model compiles once per bucket.

``plan_buckets`` picks bucket boundaries that bound padding waste; the caps are
rounded up to multiples of 8 (edge caps to 128) so downstream kernels see
aligned shapes.

Replaces the reference's dynamic PyG batching (SURVEY.md §2.1 R6) with a
compile-cache-friendly scheme.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from bignn.sparse.formats import COOGraph, PaddedGraphBatch, build_padded_batch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Bucketing:
    """A partition of graphs into size buckets.

    ``batches[i]`` holds the graphs of bucket i as a PaddedGraphBatch;
    ``graph_index[i]`` maps bucket-local graph slot -> original graph id, so
    bucket embeddings can be scattered back into one [num_graphs, d] matrix.
    """

    batches: list[PaddedGraphBatch]
    graph_index: list[np.ndarray]
    num_graphs: int

    @property
    def num_buckets(self) -> int:
        return len(self.batches)


def plan_buckets(
    node_counts: Sequence[int],
    max_buckets: int = 4,
    waste_target: float = 0.25,
) -> list[int]:
    """Choose per-graph node-cap boundaries (ascending) for bucketing.

    Greedy: sort sizes, grow a bucket until padding waste (cap vs mean) would
    exceed ``waste_target``, up to ``max_buckets``. Returns the list of bucket
    upper bounds; every graph with ``n <= bounds[i]`` (and > bounds[i-1]) lands
    in bucket i.
    """
    sizes = np.sort(np.asarray(node_counts, np.int64))
    if len(sizes) == 0:
        return []
    if max_buckets <= 1:
        return [int(sizes[-1])]
    # Quantile-based boundaries: equal-count buckets, deduplicated.
    qs = np.linspace(0, 1, max_buckets + 1)[1:]
    bounds = sorted({int(np.quantile(sizes, q, method="higher")) for q in qs})
    # Merge buckets whose bound is within waste_target of the previous one.
    merged: list[int] = []
    for b in bounds:
        if merged and b <= merged[-1] * (1.0 + waste_target):
            merged[-1] = b
        else:
            merged.append(b)
    merged[-1] = int(sizes[-1])
    return merged


def bucket_graphs(
    graphs: Sequence[COOGraph],
    bounds: Sequence[int] | None = None,
    *,
    max_buckets: int = 4,
    normalize: bool = True,
    add_self_loops: bool = True,
    block_local: bool | None = None,
) -> Bucketing:
    """Partition ``graphs`` into size buckets and build one padded batch each.

    Caps are derived from the bucket contents: node_cap = sum of nodes (+pad to
    8), edge_cap = sum of edges (+self loops) (+pad to 8).

    ``block_local`` (default: auto — on when every graph has <= 128 nodes)
    lays each bucket out in greedily packed 128-row blocks and attaches the
    fused block-local SpMM plan (see formats.build_padded_batch).
    """
    n_counts = [g.num_nodes for g in graphs]
    if block_local is None:
        block_local = max(n_counts, default=0) <= 128
    if bounds is None:
        bounds = plan_buckets(n_counts, max_buckets=max_buckets)
    bounds = list(bounds)
    if not bounds:
        raise ValueError("no graphs")

    assignments: list[list[int]] = [[] for _ in bounds]
    for gi, n in enumerate(n_counts):
        for bi, b in enumerate(bounds):
            if n <= b:
                assignments[bi].append(gi)
                break
        else:
            raise ValueError(f"graph {gi} with {n} nodes exceeds max bound {bounds[-1]}")

    batches, graph_index = [], []
    for members in assignments:
        if not members:
            continue
        gs = [graphs[i] for i in members]
        if block_local:
            from bignn import native

            _, extent = native.greedy_pack_blocks(
                np.asarray([g.num_nodes for g in gs], np.int32), 128)
            node_cap = _round_up(max(extent, 128), 128)
        else:
            node_cap = _round_up(sum(g.num_nodes for g in gs), 8)
        e_total = sum(g.num_edges for g in gs)
        if add_self_loops:
            e_total += sum(g.num_nodes for g in gs)
        edge_cap = _round_up(max(e_total, 128), 128)
        batches.append(
            build_padded_batch(
                gs,
                node_cap=node_cap,
                edge_cap=edge_cap,
                normalize=normalize,
                add_self_loops=add_self_loops,
                block_local=block_local,
            )
        )
        graph_index.append(np.asarray(members, np.int32))
    return Bucketing(batches=batches, graph_index=graph_index, num_graphs=len(graphs))
