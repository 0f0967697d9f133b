"""Device-resident sampling x data parallelism (P1 x T4): each dp shard
draws its own batch INSIDE shard_map with key (seed, epoch, step*dp+s); the
psum'd (sum, count) loss must make the trajectory equal a single-device run
over the union of the per-shard batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.models.loss import bce_with_logits_elementwise
from bignn.parallel import make_mesh
from bignn.train import MinibatchTrainer, TrainConfig


@pytest.fixture(scope="module")
def ds_model():
    ds = make_synthetic_ddi(num_drugs=60, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=2)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                              outer_layers=("gcn:16:identity",)))
    return ds, model


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_device_sample_matches_union(ds_model, dp):
    ds, model = ds_model
    cfg = TrainConfig(lr=1e-3, epochs=1, batch_size=8, seed=0)
    mesh = make_mesh(dp=dp, graph=1, devices=jax.devices()[:dp])
    tr_dp = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2,
                             mesh=mesh, device_sample=True, dispatch_chunk=2)
    p_dp, o_dp = tr_dp.init()
    p_dp, o_dp, losses, stats = tr_dp.train_chunk_device(p_dp, o_dp, 0, 0)
    assert losses.shape == (2,)
    assert int(stats["batches_sampled"]) == 2 * dp

    # single-device reference: same sampler caps, the union of the dp
    # per-shard draws (keys step*dp + s), masked-mean + one update per step
    tr_1 = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2,
                            device_sample=True)
    dev, consts = tr_1.dsampler, tr_1._dev_consts
    p_ref, o_ref = tr_1.init()
    import optax

    for step in range(2):
        def union_loss(p):
            num = den = 0.0
            for s in range(dp):
                cb, _ = dev.sample(consts, dev.key_at(0, step * dp + s))
                logits = tr_1._forward(p, cb, tr_1.tables)
                per = bce_with_logits_elementwise(logits, cb.labels)
                num = num + jnp.sum(per * cb.mask)
                den = den + jnp.sum(cb.mask)
            return num / jnp.maximum(den, 1.0)

        loss_ref, grads = jax.value_and_grad(union_loss)(p_ref)
        updates, o_ref = tr_1.optimizer.update(grads, o_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, updates)
        assert np.isclose(float(loss_ref), float(losses[step]),
                          rtol=1e-5), (step, float(loss_ref),
                                       float(losses[step]))

    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_dp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)


def test_dp_device_sample_fit_runs(ds_model):
    ds, model = ds_model
    mesh = make_mesh(dp=2, graph=1, devices=jax.devices()[:2])
    tr = MinibatchTrainer(model, ds,
                          TrainConfig(lr=2e-3, epochs=2, batch_size=8, seed=0),
                          fanouts=(4,), calibrate_caps=2, mesh=mesh,
                          device_sample=True, dispatch_chunk=2)
    params, result = tr.fit(steps_per_epoch=3)  # odd: exercises the tail chunk
    losses = [r["loss"] for r in result["history"]]
    assert np.isfinite(losses).all()
    assert "batches_sampled" in result["history"][0]
    assert result["history"][0]["batches_sampled"] == 6
