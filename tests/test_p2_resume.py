"""P2 mode as a first-class trainer: kill-and-resume
trajectory equality on the fake 8-device mesh, and best-params test-eval
semantics."""

import dataclasses

import jax
import numpy as np

from bignn.config import get_config
from bignn.data import load_dataset
from bignn.models import BiGNN
from bignn.run import _run_p2
from bignn.train import TrainConfig
from bignn.train.checkpoint import CheckpointManager
from bignn.utils import MetricLogger


def _setup(epochs):
    cfg = get_config("config5")
    cfg = dataclasses.replace(
        cfg,
        dataset="synthetic-small",
        dataset_kwargs=dict(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=8),
        train=TrainConfig(lr=1e-3, epochs=epochs, batch_size=32,
                          eval_every=1, seed=0),
        graph_shards=4,
    )
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    model = BiGNN(dataclasses.replace(
        cfg.model, feat_dim=ds.feat_dim,
        inner_layers=("gin:16",), outer_layers=("gat:16:2",)))
    return cfg, ds, model


def test_p2_kill_and_resume_matches_uninterrupted(tmp_path):
    log = MetricLogger(stdout=False)

    # uninterrupted 4-epoch reference
    cfg, ds, model = _setup(epochs=4)
    p_ref, r_ref = _run_p2(model, ds, cfg, log)

    # run 2 epochs with checkpointing, "die", resume to 4
    cfg2, ds2, model2 = _setup(epochs=2)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    _run_p2(model2, ds2, cfg2, log, ckpt=ckpt, checkpoint_every=1)
    ckpt.close()

    cfg3, ds3, model3 = _setup(epochs=4)
    ckpt2 = CheckpointManager(str(tmp_path / "ckpt"))
    p_res, r_res = _run_p2(model3, ds3, cfg3, log, ckpt=ckpt2,
                           checkpoint_every=1)
    ckpt2.close()

    # resumed run skipped the first two epochs...
    assert len(r_res["history"]) == 2
    assert r_res["history"][0]["epoch"] == 2
    # ...and lands on the identical trajectory
    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_res)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    for k in ("test_auc", "test_ap", "final_loss"):
        assert np.isclose(r_ref[k], r_res[k], rtol=1e-5), (k, r_ref[k], r_res[k])


def test_p2_best_params_drive_test_eval():
    """The returned params are the best-val-AUC epoch's, and the test
    metrics are computed from them (not last-epoch params)."""
    cfg, ds, model = _setup(epochs=3)
    log = MetricLogger(stdout=False)
    best_params, result = _run_p2(model, ds, cfg, log)
    assert result["best_epoch"] >= 0
    aucs = [r["val_auc"] for r in result["history"] if "val_auc" in r]
    assert result["history"][result["best_epoch"]]["val_auc"] == max(aucs)


def test_p2_resume_of_completed_run(tmp_path):
    """Resuming a run whose checkpoint already covers every epoch must not
    crash (r3 review findings): history is empty (final_loss None) and the
    RESTORED best params — re-placed on the mesh — drive the test eval."""
    cfg, ds, model = _setup(epochs=2)
    log = MetricLogger(stdout=False)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    p_ref, r_ref = _run_p2(model, ds, cfg, log, ckpt=ckpt, checkpoint_every=1)
    ckpt.close()

    ckpt2 = CheckpointManager(str(tmp_path / "ck"))
    p_res, r_res = _run_p2(model, ds, cfg, log, ckpt=ckpt2,
                           checkpoint_every=1)
    ckpt2.close()
    assert r_res["history"] == []
    assert r_res["final_loss"] is None
    # test metrics computed from the restored best params == original's
    for k in ("test_auc", "test_ap"):
        assert np.isclose(r_ref[k], r_res[k], atol=1e-6), (k, r_ref[k], r_res[k])
    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_res)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
