"""bfloat16 mixed-precision path: forward close to f32, training stable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import Trainer, TrainConfig


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_ddi(num_drugs=80, feat_dim=12, avg_degree=6.0, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    return ds, data


@pytest.mark.parametrize("arch", ["config1", "full"])
def test_bf16_forward_close_to_f32(setup, arch):
    ds, data = setup
    if arch == "config1":
        mk = lambda dt: BiGNNConfig.config1(feat_dim=12)
    else:
        mk = lambda dt: BiGNNConfig.full_bignn(feat_dim=12, dim=32, heads=4)
    import dataclasses

    cfg32 = mk(None)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    m32, m16 = BiGNN(cfg32), BiGNN(cfg16)
    params = m32.init(jax.random.key(0))
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    rng = np.random.default_rng(0)
    pairs = jnp.asarray(rng.integers(0, 80, (32, 2)), jnp.int32)

    o32 = np.asarray(m32.apply(params, buckets, gidx, outer, pairs))
    o16 = np.asarray(m16.apply(params, buckets, gidx, outer, pairs))
    assert o16.dtype == np.float32  # logits come back in f32
    scale = np.maximum(np.abs(o32), 1.0)
    assert np.max(np.abs(o32 - o16) / scale) < 0.1, (o32[:4], o16[:4])


def test_bf16_training_converges(setup):
    ds, data = setup
    import dataclasses

    cfg = dataclasses.replace(BiGNNConfig.config1(feat_dim=12), dtype="bfloat16")
    trainer = Trainer(BiGNN(cfg), data, TrainConfig(lr=5e-3, epochs=6, batch_size=256))
    params, res = trainer.fit()
    losses = [r["loss"] for r in res["history"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # master params stay f32
    assert all(
        l.dtype == jnp.float32
        for l in jax.tree.leaves(params)
        if jnp.issubdtype(l.dtype, jnp.floating)
    )
