"""Data-parallel correctness on 8 fake CPU devices (SURVEY.md §4 item 4):
the dp-sharded train step must match the single-device step allclose."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel import dp_train_step_fn, make_mesh, shard_pairs


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    params = model.init(jax.random.key(0))
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.integers(0, 40, (32, 2)), jnp.int32)
    mask = jnp.ones(32, jnp.float32)
    return model, data, params, optimizer, opt_state, buckets, gidx, outer, pos, mask


def _run(model, data, params, optimizer, opt_state, buckets, gidx, outer,
         pos, mask, n_dev):
    mesh = make_mesh(dp=n_dev, graph=1, devices=jax.devices()[:n_dev])
    step = dp_train_step_fn(model, optimizer, mesh, data.num_drugs)
    pos_s, mask_s = shard_pairs(mesh, pos, mask)
    with mesh:
        p, o, loss = step(params, opt_state, jax.random.key(5), pos_s, mask_s,
                          buckets, gidx, outer)
    return jax.tree.map(np.asarray, p), float(loss)


def test_dp8_matches_dp1(setup):
    model, data, params, optimizer, opt_state, buckets, gidx, outer, pos, mask = setup
    p1, loss1 = _run(model, data, params, optimizer, opt_state, buckets, gidx,
                     outer, pos, mask, 1)
    p8, loss8 = _run(model, data, params, optimizer, opt_state, buckets, gidx,
                     outer, pos, mask, 8)
    assert np.isclose(loss1, loss8, rtol=1e-5), (loss1, loss8)
    flat1 = jax.tree.leaves(p1)
    flat8 = jax.tree.leaves(p8)
    for a, b in zip(flat1, flat8):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
