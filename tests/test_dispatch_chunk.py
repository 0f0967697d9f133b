"""Chunked dispatch (train_chunk / dispatch_chunk): K scanned optimizer
steps in one jit call must reproduce the per-step trajectory exactly —
including across dp meshes and the checkpoint-resume path."""

import jax
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel import make_mesh
from bignn.train.trainer import MinibatchTrainer, TrainConfig


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                              min_atoms=4, max_atoms=10, seed=0)


def test_chunked_matches_per_step(ds):
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    cfg = TrainConfig(batch_size=8, epochs=1, seed=5)
    losses = {}
    final = {}
    for chunk in (1, 3):
        tr = MinibatchTrainer(ds=ds, model=model, config=cfg, fanouts=(4,),
                              calibrate_caps=2, dispatch_chunk=chunk)
        params, opt_state = tr.init()
        tr.sampler.reseed(0)
        hbs = [tr._draw_host(at=(0, i)) for i in range(7)]  # 2 chunks + tail
        ls = []
        if chunk == 1:
            for hb in hbs:
                params, opt_state, l = tr.train_step(
                    params, opt_state, tr._to_device(hb))
                ls.append(float(l))
        else:
            i = 0
            while i < len(hbs):
                pend = hbs[i : i + chunk]
                params, opt_state, ls2 = tr._flush(
                    params, opt_state, list(pend), [])
                ls.extend(float(x) for x in ls2)
                i += chunk
        losses[chunk] = ls
        final[chunk] = jax.tree.map(np.asarray, params)
    np.testing.assert_allclose(losses[1], losses[3], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(final[1]), jax.tree.leaves(final[3])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_chunked_fit_runs_dp(ds):
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    cfg = TrainConfig(batch_size=8, epochs=1, seed=5)
    mesh = make_mesh(dp=4, graph=1, devices=jax.devices()[:4])
    tr = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2,
                          mesh=mesh, dispatch_chunk=2)
    params, hist = tr.fit(steps_per_epoch=5)
    assert len(hist["history"]) == 1
    assert np.isfinite(hist["history"][0]["loss"])
