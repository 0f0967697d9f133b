"""Exact (full-propagation) evaluation for the minibatch trainer:
metrics must be estimator-free — identical to the
full-graph Trainer on the same params, unlike the default fanout-sampled
evaluation which depends on sampler randomness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.train.trainer import MinibatchTrainer, Trainer, TrainConfig


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    params = model.init(jax.random.key(0))
    return ds, model, params


def test_exact_scores_match_full_graph_trainer(setup):
    ds, model, params = setup
    cfg = TrainConfig(batch_size=8, epochs=1)
    mb = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2)
    full = Trainer(model, prepare_device_data(ds), cfg)

    rng = np.random.default_rng(7)
    pairs = rng.integers(0, ds.num_drugs, (40, 2)).astype(np.int64)

    s_exact = mb.score_exact(params, pairs)
    s_full = np.asarray(full._score_pairs(params, jnp.asarray(pairs, jnp.int32)))
    np.testing.assert_allclose(s_exact, s_full, rtol=2e-4, atol=2e-5)


def test_exact_eval_metrics(setup):
    ds, model, params = setup
    cfg = TrainConfig(batch_size=8, epochs=1)
    mb = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2)
    m = mb.evaluate(params, "val", exact=True)
    assert 0.0 <= m["val_auc"] <= 1.0 and 0.0 <= m["val_ap"] <= 1.0
    # deterministic: exact eval twice gives the same numbers bit-for-bit
    m2 = mb.evaluate(params, "val", exact=True)
    assert m == m2


def test_exact_eval_nonresident(setup):
    ds, model, params = setup
    cfg = TrainConfig(batch_size=8, epochs=1)
    mb = MinibatchTrainer(model, ds, cfg, fanouts=(4,), resident=False,
                          calibrate_caps=2)
    m = mb.evaluate(params, "test", exact=True)
    assert 0.0 <= m["test_auc"] <= 1.0


def test_minibatch_eval_device_metrics_match_host(setup):
    """MinibatchTrainer.evaluate now keeps scores on device and uses the
    exact tie-aware device AUC/AP; values must equal the
    host-metric computation on the same scores."""
    from bignn.train.metrics import average_precision, roc_auc

    ds, model, params = setup
    mb = MinibatchTrainer(model, ds, TrainConfig(batch_size=8, epochs=1),
                          fanouts=(4,), calibrate_caps=2)
    m = mb.evaluate(params, "val", exact=True, neg_seed=99)

    # host reference: same negative draw + exact scores + host metrics
    pos = ds.split_edges("val").astype(np.int64)
    rng = np.random.default_rng(99)
    corrupt_right = rng.random(len(pos)) < 0.5
    rand = rng.integers(0, ds.num_drugs, len(pos))
    neg = np.stack([np.where(corrupt_right, pos[:, 0], rand),
                    np.where(corrupt_right, rand, pos[:, 1])], axis=1)
    pairs = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    scores = mb.score_exact(params, pairs)
    assert np.isclose(m["val_auc"], roc_auc(labels, scores), atol=1e-6)
    assert np.isclose(m["val_ap"], average_precision(labels, scores), atol=1e-6)
