"""Module parity vs the NumPy oracle (SURVEY.md §4 item 2; BASELINE.json:5
"per-layer activations allclose"). Same params fed to both paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.models import (
    AttentionReadout,
    BiGNN,
    BiGNNConfig,
    DotAttnConv,
    GATConv,
    GCNConv,
    GINConv,
    MLPScorer,
)
from bignn.oracle import (
    attention_readout_ref,
    bignn_forward_ref,
    dotattn_conv_ref,
    gat_conv_ref,
    gcn_conv_ref,
    gin_conv_ref,
    mlp_score_ref,
    readout_ref,
)
from bignn.sparse import COOGraph, bucket_graphs, build_outer_graph, build_padded_batch


def _graph_inputs(seed=0, n=12, e=40, f=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    dst = np.sort(rng.integers(0, n - 2, e)).astype(np.int32)  # leave empty rows
    src = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) + 0.1).astype(np.float32)
    return x, src, dst, w, n


def test_gcn_conv_parity():
    x, src, dst, w, n = _graph_inputs()
    conv = GCNConv(8, 16, activation="relu")
    params = conv.init(jax.random.key(0))
    out = np.asarray(conv.apply(params, jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), jnp.asarray(w), n))
    ref = gcn_conv_ref(params, x, src, dst, w, n, "relu")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_gin_conv_parity():
    x, src, dst, w, n = _graph_inputs(1)
    conv = GINConv(8, 16, activation="relu")
    params = conv.init(jax.random.key(1))
    out = np.asarray(conv.apply(params, jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), None, n))
    ref = gin_conv_ref(params, x, src, dst, n, 8, 16, None, "relu")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_gat_conv_parity():
    x, src, dst, w, n = _graph_inputs(2)
    conv = GATConv(8, 16, heads=4, activation="elu")
    params = conv.init(jax.random.key(2))
    out = np.asarray(conv.apply(params, jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), None, n))
    ref = gat_conv_ref(params, x, src, dst, n, 4, "elu")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_dotattn_conv_parity():
    x, src, dst, w, n = _graph_inputs(3)
    conv = DotAttnConv(8, 16, heads=2, activation="relu")
    params = conv.init(jax.random.key(3))
    out = np.asarray(conv.apply(params, jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), None, n))
    ref = dotattn_conv_ref(params, x, src, dst, n, 2, "relu")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_readouts_parity():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    gids = np.sort(rng.integers(0, 5, 20)).astype(np.int32)
    from bignn.models import MaxReadout, MeanReadout, SumReadout

    for kind, cls in [("sum", SumReadout), ("mean", MeanReadout), ("max", MaxReadout)]:
        ro = cls(8)
        out = np.asarray(ro.apply({}, jnp.asarray(x), jnp.asarray(gids), 5))
        ref = readout_ref(kind, x, gids, 5)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5, err_msg=kind)


def test_attention_readout_parity():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    gids = np.sort(rng.integers(0, 5, 20)).astype(np.int32)
    ro = AttentionReadout(8, hidden=16)
    params = ro.init(jax.random.key(5))
    out = np.asarray(ro.apply(params, jnp.asarray(x), jnp.asarray(gids), 5))
    ref = attention_readout_ref(params, x, gids, 5, 8, 16)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_mlp_scorer_parity():
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(10, 16)).astype(np.float32)
    pairs = rng.integers(0, 10, (7, 2)).astype(np.int32)
    sc = MLPScorer(16, hidden=32)
    params = sc.init(jax.random.key(6))
    out = np.asarray(sc.apply(params, jnp.asarray(emb), jnp.asarray(pairs)))
    ref = mlp_score_ref(params, emb, pairs, 16, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def _tiny_dataset(seed=0, n_drugs=12):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_drugs):
        n = int(rng.integers(3, 9))
        parents = np.array([rng.integers(0, i) for i in range(1, n)], np.int64)
        src = np.concatenate([np.arange(1, n), parents])
        dst = np.concatenate([parents, np.arange(1, n)])
        feat = rng.normal(size=(n, 6)).astype(np.float32)
        mols.append(COOGraph(node_feat=feat, src=src, dst=dst))
    b = bucket_graphs(mols, max_buckets=2)
    eu = rng.integers(0, n_drugs, 30)
    ev = rng.integers(0, n_drugs, 30)
    keep = eu != ev
    outer = build_outer_graph(eu[keep], ev[keep], num_nodes=n_drugs)
    pairs = np.stack([rng.integers(0, n_drugs, 9), rng.integers(0, n_drugs, 9)], 1).astype(np.int32)
    return b, outer, pairs


@pytest.mark.parametrize(
    "config",
    [
        BiGNNConfig(feat_dim=6),  # config #1: GCN/GCN
        BiGNNConfig(feat_dim=6, inner_layers=("gin:16", "gin:16"),
                    outer_layers=("gat:16:4",), scorer="mlp:8"),  # full BI-GNN
        BiGNNConfig(feat_dim=6, inner_layers=("gcn:16",), readout="mean",
                    outer_layers=("dotattn:16:2",), scorer="dot"),
    ],
    ids=["config1-gcn", "full-gin-gat", "dotattn-mean"],
)
def test_full_forward_parity(config):
    b, outer, pairs = _tiny_dataset()
    model = BiGNN(config)
    params = model.init(jax.random.key(7))
    buckets = tuple(jax.tree.map(jnp.asarray, bb) for bb in b.batches)
    gidx = tuple(jnp.asarray(i) for i in b.graph_index)
    outer_j = jax.tree.map(jnp.asarray, outer)
    logits = np.asarray(
        jax.jit(model.apply)(params, buckets, gidx, outer_j, jnp.asarray(pairs))
    )
    ref = bignn_forward_ref(model, params, b.batches, b.graph_index, outer, pairs)
    np.testing.assert_allclose(logits, ref, rtol=1e-3, atol=1e-4)


def test_bucketing_graph_index_is_permutation():
    """embed_drugs' scatter-free fast path requires the concatenated bucket
    graph_index to be a duplicate-free permutation of range(num_drugs) — its
    row-count guard alone cannot catch a double-assigned + missing drug
    (models/bignn.py embed_drugs precondition)."""
    b, _, _ = _tiny_dataset()
    cat = np.concatenate([np.asarray(i) for i in b.graph_index])
    np.testing.assert_array_equal(np.sort(cat), np.arange(len(cat)))
