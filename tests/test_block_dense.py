"""Parity of the dense block-diagonal inner path (ops.block_diag_spmm,
sparse.formats block_adj/block_cnt) vs the sparse layout it summarizes.

The block-local layout guarantees every inner graph lies inside one 128-row
block, so the union adjacency is block-diagonal; these tests pin that the
dense materialization is exactly the sparse edge list (weights, multiplicity,
self-loops) and that GCN/GIN convs and the full model produce identical
results through either path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bignn.ops as ops
from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.sparse.bucketing import bucket_graphs


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_ddi(
        num_drugs=120, feat_dim=12, avg_degree=6.0,
        min_atoms=4, max_atoms=30, seed=3,
    )


@pytest.fixture(scope="module")
def batch(ds):
    b = bucket_graphs(ds.molecules, max_buckets=1).batches[0]
    assert b.block_adj is not None and b.block_cnt is not None
    return b


def test_block_adj_matches_edge_list(batch):
    n = batch.node_cap
    nblk = n // 128
    assert batch.block_adj.shape == (nblk, 128, 128)
    # rebuild dense from the padded edge arrays (padding has dst == node_cap)
    src = np.asarray(batch.edge_src)
    dst = np.asarray(batch.edge_dst)
    w = np.asarray(batch.edge_weight)
    real = dst < n
    adj = np.zeros((nblk, 128, 128), np.float32)
    cnt = np.zeros((nblk, 128, 128), np.float32)
    b = dst[real] // 128
    np.add.at(adj, (b, dst[real] % 128, src[real] - b * 128), w[real])
    np.add.at(cnt, (b, dst[real] % 128, src[real] - b * 128), 1.0)
    np.testing.assert_allclose(np.asarray(batch.block_adj), adj, atol=0)
    np.testing.assert_allclose(np.asarray(batch.block_cnt), cnt, atol=0)


def test_block_diag_spmm_matches_sparse(batch):
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(
            (batch.node_cap, 16)).astype(np.float32))
    dense = ops.block_diag_spmm(jnp.asarray(batch.block_adj), x)
    sparse = ops.spmm_sorted_coo(
        x, jnp.asarray(batch.edge_src), jnp.asarray(batch.edge_dst),
        jnp.asarray(batch.edge_weight), batch.node_cap)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(sparse),
                               rtol=1e-5, atol=1e-5)
    # unweighted (GIN) via multiplicity blocks
    dense_u = ops.block_diag_spmm(jnp.asarray(batch.block_cnt), x)
    sparse_u = ops.spmm_sorted_coo(
        x, jnp.asarray(batch.edge_src), jnp.asarray(batch.edge_dst),
        None, batch.node_cap)
    np.testing.assert_allclose(np.asarray(dense_u), np.asarray(sparse_u),
                               rtol=1e-5, atol=1e-5)


def test_block_diag_spmm_grad_matches_sparse(batch):
    x = jnp.asarray(
        np.random.default_rng(1).standard_normal(
            (batch.node_cap, 8)).astype(np.float32))
    adj = jnp.asarray(batch.block_adj)

    def f_dense(x):
        return (ops.block_diag_spmm(adj, x) ** 2).sum()

    def f_sparse(x):
        y = ops.spmm_sorted_coo(
            x, jnp.asarray(batch.edge_src), jnp.asarray(batch.edge_dst),
            jnp.asarray(batch.edge_weight), batch.node_cap)
        return (y ** 2).sum()

    np.testing.assert_allclose(
        np.asarray(jax.grad(f_dense)(x)), np.asarray(jax.grad(f_sparse)(x)),
        rtol=1e-4, atol=1e-4)


def test_model_forward_parity_dense_vs_sparse(ds):
    """Full BI-GNN forward identical with and without the block-dense path."""
    data = prepare_device_data(ds, max_buckets=1)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=32, heads=4))
    params = model.init(jax.random.key(0))
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    pairs = jnp.asarray(
        np.random.default_rng(2).integers(0, ds.num_drugs, (32, 2)), jnp.int32)

    logits_dense = model.apply(params, buckets, gidx, outer, pairs)
    buckets_sparse = tuple(
        dataclasses.replace(b, block_adj=None, block_cnt=None) for b in buckets)
    logits_sparse = model.apply(params, buckets_sparse, gidx, outer, pairs)
    np.testing.assert_allclose(
        np.asarray(logits_dense), np.asarray(logits_sparse),
        rtol=2e-4, atol=2e-4)


def test_block_dense_disabled_above_cap(ds):
    b = bucket_graphs(ds.molecules, max_buckets=1).batches[0]
    from bignn.sparse.formats import build_padded_batch

    small = build_padded_batch(
        list(ds.molecules[:10]), node_cap=384, edge_cap=1024,
        block_local=True, block_dense_max_nodes=128)
    assert small.block_adj is None  # 384 > 128 cap -> disabled
    assert b.block_adj is not None
