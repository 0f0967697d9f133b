"""End-to-end convergence: milestone config #1 (BASELINE.json:7;
SURVEY.md §4 item 3). 2-layer GCN inner + 1-layer GCN outer on a small
synthetic DDI set; loss must decrease and val AUC must clear a threshold on a
fixed seed."""

import numpy as np
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import Trainer, TrainConfig


@pytest.fixture(scope="module")
def small_run():
    ds = make_synthetic_ddi(num_drugs=200, feat_dim=12, avg_degree=8.0, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(BiGNNConfig.config1(feat_dim=12))
    trainer = Trainer(model, data, TrainConfig(lr=5e-3, epochs=30, batch_size=256, seed=0))
    params, result = trainer.fit()
    return trainer, params, result


def test_loss_decreases(small_run):
    _, _, result = small_run
    losses = [r["loss"] for r in result["history"]]
    assert losses[-1] < losses[0] * 0.9, losses


def test_val_auc_above_threshold(small_run):
    _, _, result = small_run
    aucs = [r.get("val_auc") for r in result["history"] if "val_auc" in r]
    assert max(aucs) > 0.70, aucs


def test_test_metrics_present(small_run):
    _, _, result = small_run
    assert 0.0 <= result["test_auc"] <= 1.0
    assert 0.0 <= result["test_ap"] <= 1.0


def test_full_bignn_bf16_reaches_auc():
    """Accuracy gate for the headline-bench model: the full BI-GNN (GIN inner, GAT outer) in bfloat16 — the
    config the throughput benches time — must LEARN on the standin: best
    val AUC > 0.70 at a fixed seed (mirrors the config-#1 f32 gate above).
    A fast-path or precision regression that hurt learning fails here."""
    import dataclasses

    ds = make_synthetic_ddi(num_drugs=200, feat_dim=12, avg_degree=8.0, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=12, dim=32, heads=4),
        dtype="bfloat16"))
    trainer = Trainer(model, data, TrainConfig(
        lr=8e-3, epochs=100, batch_size=256, seed=0, eval_every=2))
    params, result = trainer.fit()
    aucs = [r["val_auc"] for r in result["history"] if "val_auc" in r]
    assert max(aucs) > 0.70, max(aucs)


def test_full_bignn_trains():
    """Full BI-GNN (GIN inner, GAT outer — BASELINE.json:8) smoke-trains."""
    ds = make_synthetic_ddi(num_drugs=60, feat_dim=12, avg_degree=6.0, seed=1)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=12, dim=32, heads=4))
    trainer = Trainer(model, data, TrainConfig(lr=3e-3, epochs=3, batch_size=64, seed=1))
    params, result = trainer.fit()
    losses = [r["loss"] for r in result["history"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_grad_clip_trains():
    """TrainConfig.grad_clip wires optax.clip_by_global_norm ahead of adam
    (train/trainer.make_optimizer) in every trainer; training still
    converges with it on."""
    ds = make_synthetic_ddi(num_drugs=100, feat_dim=8, avg_degree=6.0, seed=3)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    tr = Trainer(model, data, TrainConfig(lr=5e-3, epochs=8, batch_size=64,
                                          seed=0, grad_clip=1.0))
    params, result = tr.fit()
    losses = [r["loss"] for r in result["history"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8
