"""Layout-contract tests for sparse/formats.py and bucketing (SURVEY.md T1)."""

import numpy as np
import pytest

from bignn.sparse import (
    COOGraph,
    bucket_graphs,
    build_outer_graph,
    build_padded_batch,
    gcn_normalize,
    plan_buckets,
)


def _rand_graph(rng, n, feat_dim=8):
    parents = np.array([rng.integers(0, i) for i in range(1, n)], np.int64)
    src = np.concatenate([np.arange(1, n), parents])
    dst = np.concatenate([parents, np.arange(1, n)])
    feat = rng.normal(size=(n, feat_dim)).astype(np.float32)
    return COOGraph(node_feat=feat, src=src, dst=dst)


def test_gcn_normalize_row_sums():
    # For a symmetric graph, D^{-1/2} A_hat D^{-1/2} rows sum to <= 1 and the
    # self-loop weight of an isolated node is exactly 1.
    src = np.array([0, 1])
    dst = np.array([1, 0])
    s, d, w = gcn_normalize(src, dst, num_nodes=3)
    dense = np.zeros((3, 3))
    for a, b, x in zip(s, d, w):
        dense[b, a] += x
    assert np.isclose(dense[2, 2], 1.0)  # isolated node self-loop
    assert np.allclose(dense[0].sum(), dense[1].sum())
    # symmetric normalization => symmetric matrix
    assert np.allclose(dense, dense.T)


def test_padded_batch_invariants():
    rng = np.random.default_rng(0)
    graphs = [_rand_graph(rng, n) for n in (5, 9, 3)]
    total_n = sum(g.num_nodes for g in graphs)
    total_e = sum(g.num_edges for g in graphs) + total_n  # + self loops
    batch = build_padded_batch(graphs, node_cap=32, edge_cap=total_e + 10)

    # dst sorted ascending, padding at the end pointing one-past-the-end
    dst = np.asarray(batch.edge_dst)
    assert np.all(np.diff(dst) >= 0)
    assert np.all(dst[total_e:] == batch.node_cap)
    assert np.all(np.asarray(batch.edge_weight)[total_e:] == 0)
    # graph ids: padding rows carry num_graphs
    gids = np.asarray(batch.graph_ids)
    assert np.all(gids[total_n:] == batch.num_graphs)
    assert np.all(gids[:total_n] < batch.num_graphs)
    # node mask
    assert np.asarray(batch.node_mask).sum() == total_n
    assert batch.graph_n_nodes.tolist() == [5, 9, 3]


def test_padded_batch_cap_overflow_raises():
    rng = np.random.default_rng(0)
    graphs = [_rand_graph(rng, 10)]
    with pytest.raises(ValueError):
        build_padded_batch(graphs, node_cap=5, edge_cap=100)


def test_outer_graph_symmetrized_sorted():
    src = np.array([0, 1, 2])
    dst = np.array([1, 2, 0])
    g = build_outer_graph(src, dst, num_nodes=4, edge_cap=16)
    d = np.asarray(g.edge_dst)
    assert np.all(np.diff(d) >= 0)
    real = d < 4
    # each undirected edge appears in both directions + 4 self loops
    assert real.sum() == 2 * 3 + 4


def test_bucketing_partitions_all_graphs():
    rng = np.random.default_rng(1)
    sizes = list(rng.integers(4, 40, 50))
    graphs = [_rand_graph(rng, int(n)) for n in sizes]
    b = bucket_graphs(graphs, max_buckets=4)
    seen = np.concatenate([np.asarray(i) for i in b.graph_index])
    assert sorted(seen.tolist()) == list(range(50))
    assert b.num_graphs == 50
    for batch in b.batches:
        assert batch.node_cap % 8 == 0
        assert batch.edge_cap % 8 == 0


def test_plan_buckets_monotone():
    bounds = plan_buckets([3, 4, 5, 20, 21, 22, 100], max_buckets=3)
    assert bounds == sorted(bounds)
    assert bounds[-1] == 100


def test_padded_batch_graph_slots_and_override():
    """r5 (p2 sharded inner): graph_slots maps positions to readout slot
    ids and num_graphs_override widens the readout — graph_ids carry the
    slots, graph_n_nodes scatter to slot positions, padding rows carry
    the OVERRIDDEN id, and misuse raises."""
    from bignn.sparse.formats import build_padded_batch

    rng = np.random.default_rng(0)
    gs = [_rand_graph(rng, n) for n in (3, 5, 2)]
    slots = [1, 4, 6]
    b = build_padded_batch(gs, node_cap=16, edge_cap=128,
                           graph_slots=slots, num_graphs_override=8)
    assert b.num_graphs == 8
    ids = np.asarray(b.graph_ids)
    mask = np.asarray(b.node_mask) > 0
    assert set(np.unique(ids[mask])) == set(slots)
    assert (ids[~mask] == 8).all()
    nn = np.asarray(b.graph_n_nodes)
    assert nn.shape == (8,)
    for s, g in zip(slots, gs):
        assert nn[s] == g.num_nodes
    assert nn.sum() == sum(g.num_nodes for g in gs)
    with pytest.raises(ValueError, match="increasing"):
        build_padded_batch(gs, node_cap=16, edge_cap=128,
                           graph_slots=[4, 1, 6])
    with pytest.raises(ValueError, match="override"):
        build_padded_batch(gs, node_cap=16, edge_cap=128,
                           graph_slots=[1, 4, 6], num_graphs_override=2)
