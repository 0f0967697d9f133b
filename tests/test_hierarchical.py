"""Hierarchical mini-batch sampling (SURVEY.md T4; configs #3-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import HierarchicalSampler, make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import MinibatchTrainer, TrainConfig


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_ddi(num_drugs=200, feat_dim=12, avg_degree=8.0, seed=0)


def test_batch_static_shapes(ds):
    s = HierarchicalSampler(ds, batch_size=32, neg_ratio=1, fanouts=(5,), seed=0)
    b1, b2 = s.sample(), s.sample()
    for f in ("node_feat", "edge_src", "outer_src", "pairs", "labels", "mask"):
        assert getattr(b1, f).shape == getattr(b2, f).shape, f
    assert b1.edge_cap % 128 == 0 and b1.outer_edge_cap % 128 == 0


def test_batch_invariants(ds):
    s = HierarchicalSampler(ds, batch_size=16, neg_ratio=2, fanouts=(4,), seed=1)
    b = s.sample()
    # molecule edges destination-sorted, outer edges destination-sorted
    assert np.all(np.diff(b.edge_dst) >= 0)
    assert np.all(np.diff(b.outer_dst) >= 0)
    # labels: first bs positives then negatives
    assert b.labels[:16].sum() == 16 and b.labels[16:].sum() == 0
    # all masked-in pairs reference local slots within budget
    m = b.mask > 0
    assert b.pairs[m].max() < b.drug_budget
    # graph ids of real nodes < budget
    real = b.graph_ids < b.drug_budget
    assert real.sum() > 0


def test_minibatch_vs_full_forward_consistency(ds):
    """With fanout >= max degree (no subsampling) and all drugs in budget,
    the minibatch forward must equal the full-graph forward on those pairs."""
    small = make_synthetic_ddi(num_drugs=30, feat_dim=8, avg_degree=4.0,
                               min_atoms=4, max_atoms=8, seed=3)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gcn:16",),
                              outer_layers=("gcn:16:identity",)))
    params = model.init(jax.random.key(0))

    # full-graph reference (single bucket)
    from bignn.data import prepare_device_data
    data = prepare_device_data(small, max_buckets=1)
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)

    rng = np.random.default_rng(0)
    tr_pairs = small.split_edges("train")[:8].astype(np.int64)
    labels = np.ones(len(tr_pairs), np.float32)
    ref = np.asarray(model.apply(params, buckets, gidx, outer,
                                 jnp.asarray(tr_pairs, jnp.int32)))

    # one-layer outer GNN needs 1-hop; huge fanout -> exact neighborhoods
    s = HierarchicalSampler(small, batch_size=8, neg_ratio=0, fanouts=(64,), seed=0)
    hb = s.batch_from_pairs(tr_pairs, labels)
    mt = MinibatchTrainer.__new__(MinibatchTrainer)
    mt.model = model
    got = np.asarray(mt._forward(params, jax.tree.map(jnp.asarray, hb)))[: len(tr_pairs)]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_minibatch_trainer_loss_decreases(ds):
    model = BiGNN(BiGNNConfig.config1(feat_dim=12))
    tr = MinibatchTrainer(model, ds, TrainConfig(lr=5e-3, epochs=3, batch_size=64,
                                                 eval_every=3), fanouts=(6,))
    params, res = tr.fit()
    losses = [r["loss"] for r in res["history"]]
    assert losses[-1] < losses[0]
    assert np.isfinite(res["test_auc"])

def test_compact_resident_path_matches_host_path(ds):
    """CompactBatch + on-device ragged expansion must produce logits identical
    to the host-gathered HierarchicalBatch path for the same pairs."""
    model = BiGNN(BiGNNConfig(feat_dim=12, inner_layers=("gin:16", "gcn:16"),
                              outer_layers=("gat:16:relu",)))
    tr = MinibatchTrainer(model, ds, TrainConfig(lr=1e-3, epochs=1, batch_size=16),
                          fanouts=(5,), resident=True)
    params, _ = tr.init()
    rng = np.random.default_rng(7)
    pairs = ds.split_edges("train")[rng.choice(200, 16, replace=False)].astype(np.int64)
    labels = np.ones(len(pairs), np.float32)

    # neighbor subsampling draws from the sampler RNG; reset it so both
    # paths see the identical subgraph
    tr.sampler._rng = np.random.default_rng(123)
    hb = tr.sampler.batch_from_pairs(pairs, labels)
    tr.sampler._rng = np.random.default_rng(123)
    cb = tr.sampler.compact_from_pairs(pairs, labels)
    ref = np.asarray(tr._forward(params, jax.tree.map(jnp.asarray, hb)))
    got = np.asarray(tr._forward(params, jax.tree.map(jnp.asarray, cb), tr.tables))
    np.testing.assert_allclose(got[: len(pairs)], ref[: len(pairs)],
                               rtol=1e-5, atol=1e-5)


def test_compact_trainer_loss_decreases(ds):
    model = BiGNN(BiGNNConfig.config1(feat_dim=12))
    tr = MinibatchTrainer(model, ds, TrainConfig(lr=5e-3, epochs=2, batch_size=64,
                                                 eval_every=2),
                          fanouts=(6,), resident=True)
    params, res = tr.fit()
    losses = [r["loss"] for r in res["history"]]
    assert losses[-1] < losses[0]
    assert np.isfinite(res["test_auc"])


def test_truncation_counters_zero_by_default(ds):
    # default caps are generous: no silent drops in healthy configs
    s = HierarchicalSampler(ds, batch_size=32, neg_ratio=1, fanouts=(5,), seed=0)
    for _ in range(4):
        s.sample()
    st = s.truncation_stats()
    assert st["batches_sampled"] == 4
    assert st["trunc_batches"] == 0
    assert st["trunc_nodes_dropped"] == 0
    assert st["trunc_outer_edges_dropped"] == 0


def test_truncation_counters_fire_on_tight_budget(ds):
    # max_drugs below the natural expansion forces node truncation; the
    # counters must record it (no silent caps)
    s = HierarchicalSampler(
        ds, batch_size=16, neg_ratio=1, fanouts=(8, 8), seed=0, max_drugs=70
    )
    for _ in range(3):
        s.sample()
    st = s.truncation_stats(reset=True)
    assert st["trunc_nodes_dropped"] > 0
    assert st["trunc_batches"] > 0
    assert s.truncation_stats()["trunc_nodes_dropped"] == 0  # reset worked


def test_truncation_counters_in_fit_record(ds):
    model = BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim))
    tr = MinibatchTrainer(
        model, ds, TrainConfig(epochs=1, batch_size=16), fanouts=(4,)
    )
    _, result = tr.fit(steps_per_epoch=2)
    rec = result["history"][0]
    assert "trunc_batches" in rec and "trunc_nodes_dropped" in rec
    assert rec["batches_sampled"] >= 2  # train draws (+ eval chunks)
