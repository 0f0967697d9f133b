"""Exact checkpoint-resume (SURVEY.md §5 checkpoint row).

Kill-and-resume equality: training interrupted at epoch k and resumed from
the checkpoint must produce the SAME loss trajectory and final metrics as an
uninterrupted run — params, opt_state, best-model selection, and all host +
device randomness (derived per (seed, epoch), not carried state) included.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import load_dataset
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import MinibatchTrainer, Trainer, TrainConfig
from bignn.train.checkpoint import CheckpointManager


@pytest.fixture(scope="module")
def ds():
    return load_dataset("synthetic-small", num_drugs=80, feat_dim=8,
                        avg_degree=5.0)


def _losses(result):
    return [r["loss"] for r in result["history"]]


def test_trainer_kill_and_resume_matches_uninterrupted(ds, tmp_path):
    from bignn.data import prepare_device_data

    model = BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim))
    data = prepare_device_data(ds)
    cfg4 = TrainConfig(epochs=4, batch_size=64, seed=3)

    # uninterrupted reference run
    _, ref = Trainer(model, data, cfg4).fit()

    # interrupted run: 2 epochs with checkpointing, then "killed"
    ck = CheckpointManager(str(tmp_path / "ck"))
    cfg2 = dataclasses.replace(cfg4, epochs=2)
    Trainer(model, data, cfg2).fit(ckpt=ck)
    ck.close()

    # resume in a fresh manager/trainer up to epoch 4
    ck2 = CheckpointManager(str(tmp_path / "ck"))
    _, res = Trainer(model, data, cfg4).fit(ckpt=ck2)
    ck2.close()

    assert [r["epoch"] for r in res["history"]] == [2, 3]
    np.testing.assert_allclose(_losses(res), _losses(ref)[2:], rtol=0, atol=1e-6)
    assert res["best_epoch"] == ref["best_epoch"]
    np.testing.assert_allclose(res["test_auc"], ref["test_auc"], atol=1e-6)


def test_minibatch_kill_and_resume_matches_uninterrupted(ds, tmp_path):
    model = BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim))
    cfg3 = TrainConfig(epochs=3, batch_size=32, seed=5)

    def make(cfg):
        return MinibatchTrainer(model, ds, cfg, fanouts=(6,))

    _, ref = make(cfg3).fit(steps_per_epoch=3)

    ck = CheckpointManager(str(tmp_path / "mb"))
    make(dataclasses.replace(cfg3, epochs=1)).fit(steps_per_epoch=3, ckpt=ck)
    ck.close()

    ck2 = CheckpointManager(str(tmp_path / "mb"))
    _, res = make(cfg3).fit(steps_per_epoch=3, ckpt=ck2)
    ck2.close()

    assert [r["epoch"] for r in res["history"]] == [1, 2]
    np.testing.assert_allclose(_losses(res), _losses(ref)[1:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["test_auc"], ref["test_auc"], atol=1e-6)


def test_device_sample_kill_and_resume_matches_uninterrupted(ds, tmp_path):
    """Device-resident sampling keeps exact resume: its draws are a pure
    function of (seed, epoch, step) via fold_in (data/device_sampler.py),
    so the resumed trajectory is identical."""
    model = BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim))
    cfg3 = TrainConfig(epochs=3, batch_size=16, seed=5)

    def make(cfg):
        return MinibatchTrainer(model, ds, cfg, fanouts=(6,),
                                calibrate_caps=2, device_sample=True,
                                dispatch_chunk=2)

    _, ref = make(cfg3).fit(steps_per_epoch=3)

    ck = CheckpointManager(str(tmp_path / "devs"))
    make(dataclasses.replace(cfg3, epochs=1)).fit(steps_per_epoch=3, ckpt=ck)
    ck.close()

    ck2 = CheckpointManager(str(tmp_path / "devs"))
    _, res = make(cfg3).fit(steps_per_epoch=3, ckpt=ck2)
    ck2.close()

    assert [r["epoch"] for r in res["history"]] == [1, 2]
    np.testing.assert_allclose(_losses(res), _losses(ref)[1:], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res["test_auc"], ref["test_auc"], atol=1e-6)


def test_resume_with_empty_dir_starts_fresh(ds, tmp_path):
    from bignn.data import prepare_device_data

    model = BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim))
    data = prepare_device_data(ds)
    cfg = TrainConfig(epochs=1, batch_size=64, seed=3)
    ck = CheckpointManager(str(tmp_path / "fresh"))
    _, res = Trainer(model, data, cfg).fit(ckpt=ck)
    ck.close()
    assert [r["epoch"] for r in res["history"]] == [0]


def test_npz_checkpoint_roundtrip_and_retention(tmp_path):
    """The .npz manager restores the exact pytree (optax state included)
    with a template, nested dicts without one, and keeps max_to_keep."""
    import optax

    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": {"x": jnp.ones(4)}}
    opt_state = optax.adam(1e-3).init(params)
    state = {"params": params, "opt_state": opt_state,
             "meta": {"epoch": 3, "best_val_auc": 0.5}}
    ck = CheckpointManager(str(tmp_path / "rt"), max_to_keep=2)
    for step in range(4):
        ck.save_state(step, state)
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert not [f for f in os.listdir(ck.directory) if "tmp" in f]
    got = ck.restore_state(state)
    assert jax.tree.structure(got) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    raw = ck.restore()
    np.testing.assert_array_equal(raw["params"]["w"], np.asarray(params["w"]))
    assert int(raw["meta"]["epoch"]) == 3
