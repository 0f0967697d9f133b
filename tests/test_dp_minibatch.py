"""Data-parallel minibatch trainer correctness (SURVEY.md §2.3 P1 x §2.4
T4): the dp-sharded hierarchical step on N fake devices
must equal a single-device step over the union of the same N batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.models.loss import bce_with_logits_elementwise
from bignn.parallel import make_mesh
from bignn.train.trainer import MinibatchTrainer, TrainConfig

DP = 4


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                              min_atoms=4, max_atoms=10, seed=0)


def _trainers(ds, resident):
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    cfg = TrainConfig(batch_size=8, epochs=1, seed=3)
    mesh = make_mesh(dp=DP, graph=1, devices=jax.devices()[:DP])
    mb_dp = MinibatchTrainer(model, ds, cfg, fanouts=(4,), resident=resident,
                             calibrate_caps=2, mesh=mesh)
    mb_1 = MinibatchTrainer(model, ds, cfg, fanouts=(4,), resident=resident,
                            calibrate_caps=2)
    return model, mb_dp, mb_1


@pytest.mark.parametrize("resident", [True, False])
def test_dp_step_matches_union_batch(ds, resident):
    model, mb_dp, mb_1 = _trainers(ds, resident)
    # SGD, not Adam: adam's g/(sqrt(g^2)+eps) after ONE step amplifies f32
    # summation-order noise on near-zero grads to ~lr, which would make the
    # param comparison ill-conditioned; SGD is linear in the gradient.
    import optax

    mb_dp.optimizer = mb_1.optimizer = optax.sgd(0.1)
    params, _ = mb_dp.init()
    opt_state = mb_dp.optimizer.init(params)

    # identical sampler trajectories: both samplers share (seed, epoch)
    mb_dp.sampler.reseed(0)
    mb_1.sampler.reseed(0)

    p_dp, o_dp, loss_dp = mb_dp.train_step(params, opt_state)

    # reference: the SAME DP batches, union masked-mean on one device
    draw = (mb_1.sampler.sample_compact if resident else mb_1.sampler.sample)
    batches = [jax.tree.map(jnp.asarray, draw()) for _ in range(DP)]

    def union_loss(params):
        num = den = 0.0
        for hb in batches:
            logits = mb_1._forward(params, hb, mb_1.tables)
            per = bce_with_logits_elementwise(logits, hb.labels)
            num += jnp.sum(per * hb.mask)
            den += jnp.sum(hb.mask)
        return num / jnp.maximum(den, 1.0)

    loss_ref, grads = jax.value_and_grad(union_loss)(params)
    updates, o_ref = mb_1.optimizer.update(grads, opt_state, params)
    p_ref = jax.tree.map(np.asarray, jax.tree.map(
        lambda p, u: p + u, params, updates))

    assert np.isclose(float(loss_dp), float(loss_ref), rtol=1e-5), (
        float(loss_dp), float(loss_ref))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, p_dp)),
                    jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_dp_fit_runs_and_evaluates(ds):
    _, mb_dp, _ = _trainers(ds, True)
    best, hist = mb_dp.fit(steps_per_epoch=2)
    assert np.isfinite(hist["history"][0]["loss"])
    assert 0.0 <= hist["test_auc"] <= 1.0


def test_dp_mesh_validation(ds):
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    mesh = make_mesh(dp=2, graph=2, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="dp-only"):
        MinibatchTrainer(model, ds, TrainConfig(batch_size=8), fanouts=(4,),
                         mesh=mesh)
