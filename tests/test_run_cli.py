"""CLI runner, config registry, checkpointing, metrics (SURVEY.md T5/T9)."""

import json
import os

import numpy as np
import pytest

from bignn.config import get_config
from bignn.run import main


def test_config_registry():
    for name in ("config1", "config2", "config3", "config4", "config5"):
        cfg = get_config(name)
        assert cfg.name == name
    assert get_config("drugbank").dataset == "drugbank"
    with pytest.raises(ValueError):
        get_config("config99")


def test_run_config1_end_to_end(tmp_path):
    res = main([
        "--config", "config1", "--epochs", "2", "--batch-size", "256",
        "--run-dir", str(tmp_path), "--checkpoint-every", "1",
    ])
    assert np.isfinite(res["test_auc"])
    assert (tmp_path / "metrics.jsonl").exists()
    with open(tmp_path / "result.json") as f:
        summary = json.load(f)
    assert "test_auc" in summary

    from bignn.train.checkpoint import CheckpointManager

    cm = CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.latest_step() is not None
    state = cm.restore()
    assert "params" in state
    cm.close()


def test_run_p2_mode(tmp_path):
    # config5 shape on the fake 8-device mesh, tiny sizes
    import dataclasses

    from bignn.config import get_config

    res = main([
        "--config", "config5", "--epochs", "1", "--batch-size", "64",
    ]) if False else None
    # config5 uses drugbank-scale data (slow on CPU); drive the p2 branch
    # through run._run_p2 with a small config instead
    from bignn.data import load_dataset
    from bignn.models import BiGNN
    from bignn.run import _run_p2
    from bignn.train import TrainConfig
    from bignn.utils import MetricLogger

    cfg = get_config("config5")
    cfg = dataclasses.replace(
        cfg,
        dataset="synthetic-small",
        dataset_kwargs=dict(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=8),
        train=TrainConfig(lr=1e-3, epochs=1, batch_size=32),
        graph_shards=4,
    )
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    import dataclasses as dc

    model = BiGNN(dc.replace(cfg.model, feat_dim=ds.feat_dim,
                             inner_layers=("gin:16",), outer_layers=("gat:16:2",)))
    best_params, result = _run_p2(model, ds, cfg, MetricLogger(stdout=False))
    assert np.isfinite(result["final_loss"])
    assert best_params is not None  # test metrics come from best params


def test_run_cli_dp_mode(tmp_path):
    """P1 from the CLI: --dp shards pair minibatches
    over a dp-only mesh in both full-graph and minibatch modes; the
    trajectory equality vs single-device is covered by tests/test_dp.py and
    tests/test_dp_minibatch.py — here we prove the wiring end-to-end."""
    res = main([
        "--config", "config1", "--epochs", "1", "--batch-size", "64",
        "--dp", "2", "--run-dir", str(tmp_path / "full"),
    ])
    assert np.isfinite(res["test_auc"])

    res = main([
        "--config", "config3", "--epochs", "1", "--batch-size", "64",
        "--dp", "2", "--run-dir", str(tmp_path / "mb"),
    ])
    assert np.isfinite(res["test_auc"])


def test_run_cli_device_sample(tmp_path):
    """--device-sample routes minibatch training through the device-resident
    sampler (data/device_sampler.py); config #4 defaults to it in the
    registry (config.py device_sample=True)."""
    from bignn.config import get_config

    assert get_config("config4").device_sample
    res = main([
        "--config", "config3", "--epochs", "1", "--batch-size", "64",
        "--device-sample", "--run-dir", str(tmp_path / "devs"),
    ])
    assert np.isfinite(res["test_auc"])


def test_run_cli_exact_eval(tmp_path):
    """--exact-eval (r5): minibatch runs additionally report
    estimator-free full-propagation final metrics (DESIGN.md §5)."""
    res = main([
        "--config", "config3", "--epochs", "1", "--batch-size", "64",
        "--exact-eval", "--run-dir", str(tmp_path / "ex"),
    ])
    for k in ("exact_val_auc", "exact_test_auc", "exact_test_ap"):
        assert np.isfinite(res[k]), res


def test_config5_large_registry():
    cfg = get_config("config5-large")
    assert cfg.mode == "p2" and cfg.graph_shards == 8
    assert cfg.dataset == "synthetic-large"
    assert cfg.model.dtype == "bfloat16"
