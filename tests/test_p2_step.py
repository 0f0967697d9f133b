"""Full P2 train step on a dp x graph fake-CPU mesh: one step must match the
single-device trainer step allclose (loss and updated params)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel import (
    build_outer_partition,
    build_sharded_inner,
    device_put_plan,
    make_mesh,
    make_p2_train_step,
)
from bignn.train import Trainer, TrainConfig


@pytest.mark.parametrize("dp,graph", [(2, 4), (1, 8), (4, 2)])
def test_p2_step_matches_single_device(dp, graph):
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gcn:16",),
                              outer_layers=("gcn:16:identity",)))
    optimizer = optax.adam(1e-3)
    params = model.init(jax.random.key(0))
    opt_state = optimizer.init(params)

    rng = np.random.default_rng(1)
    batch = 16
    pos = rng.integers(0, 40, (batch, 2)).astype(np.int32)
    mask = np.ones(batch, np.float32)
    key = jax.random.key(9)

    # --- single-device reference (one bucket so embeddings match layout) ---
    # The P2 inner level packs all of a shard's molecules into one union, so
    # compare against a trainer with max_buckets=1.
    data = prepare_device_data(ds, max_buckets=1)
    trainer = Trainer(model, data, TrainConfig(lr=1e-3, neg_ratio=1, seed=0))
    p_ref, _, loss_ref = trainer._train_step(
        params, opt_state, key, jnp.asarray(pos), jnp.asarray(mask)
    )

    # --- distributed ---
    train_edges = ds.split_edges("train")
    plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                 ds.num_drugs, graph)
    inner = build_sharded_inner(ds.molecules, plan)
    mesh = make_mesh(dp=dp, graph=graph, devices=jax.devices()[: dp * graph])
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs, neg_ratio=1)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
    with mesh:
        p_dist, _, loss_dist = step(
            params, opt_state, key, jnp.asarray(pos), jnp.asarray(mask),
            inner_d, esrc, edst, ew, sidx,
        )

    assert np.isclose(float(loss_ref), float(loss_dist), rtol=1e-4), (
        float(loss_ref), float(loss_dist)
    )
    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_dist)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-5)


def test_p2_step_full_bignn_runs():
    """GIN inner + GAT outer through the distributed step (smoke + finite)."""
    ds = make_synthetic_ddi(num_drugs=24, feat_dim=8, avg_degree=5.0,
                            min_atoms=4, max_atoms=8, seed=2)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    optimizer = optax.adam(1e-3)
    params = model.init(jax.random.key(1))
    opt_state = optimizer.init(params)

    train_edges = ds.split_edges("train")
    plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                 ds.num_drugs, 4)
    inner = build_sharded_inner(ds.molecules, plan)
    mesh = make_mesh(dp=2, graph=4, devices=jax.devices()[:8])
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 24, (8, 2)).astype(np.int32)
    with mesh:
        p2, _, loss = step(
            params, opt_state, jax.random.key(5), jnp.asarray(pos),
            jnp.ones(8, jnp.float32), inner_d, esrc, edst, ew, sidx,
        )
    assert np.isfinite(float(loss))
    # params actually moved
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2))
    )
    assert moved


def test_multichip_dryrun_four_devices():
    """The four-device driver dry run (the p2 step vs one device, then dp
    minibatch and dp device-sampled parity) on a plain 1x4 mesh — the path
    chip_smoke.py --four-cards runs on four cards."""
    import __graft_entry__ as g

    g.dryrun_multichip(4)


@pytest.mark.parametrize("overlap", [False, True])
def test_p2_step_full_bignn_matches_single_device(overlap):
    """Full BI-GNN (GIN inner, GAT outer) p2 step on a 1x4 mesh: the halo
    all-to-all (lax collective), with and without the overlap schedule,
    gives the single-device trainer's loss."""
    ds = make_synthetic_ddi(num_drugs=32, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=8, seed=4)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    optimizer = optax.adam(1e-3)
    params = model.init(jax.random.key(3))
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.integers(0, 32, (8, 2)).astype(np.int32))
    mask = jnp.ones(8, jnp.float32)
    key = jax.random.key(11)

    train_edges = ds.split_edges("train")
    plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                 ds.num_drugs, 4)
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    mesh = make_mesh(dp=1, graph=4, devices=jax.devices()[:4])
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              neg_ratio=1, overlap=overlap)
    with mesh:
        _, _, loss = step(params, opt_state, key, pos, mask,
                          inner_d, esrc, edst, ew, sidx)

    ref = Trainer(model, prepare_device_data(ds, max_buckets=1),
                  TrainConfig(lr=1e-3, neg_ratio=1, seed=0))
    _, _, loss_ref = ref._train_step(params, opt_state, key, pos, mask)
    assert np.isclose(float(loss), float(loss_ref), rtol=2e-3), (
        float(loss), float(loss_ref))


@pytest.mark.parametrize("overlap", [False, True])
def test_p2_step_remat_inner_matches(overlap):
    """remat=True (jax.checkpoint over the inner encode and the
    outer attention temps) changes activation memory only — loss and
    updated params must equal the non-remat step exactly."""
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                              outer_layers=("gat:16:2",)))
    optimizer = optax.adam(1e-3)
    params = model.init(jax.random.key(0))
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 40, (16, 2)).astype(np.int32)
    mask = np.ones(16, np.float32)
    key = jax.random.key(9)

    train_edges = ds.split_edges("train")
    plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                 ds.num_drugs, 4)
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    mesh = make_mesh(dp=2, graph=4, devices=jax.devices()[:8])
    inner_d, esrc, edst, ew, sidx = device_put_plan(
        mesh, plan, inner)

    def run(remat):
        step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                                  neg_ratio=1, overlap=overlap,
                                  remat=remat)
        with mesh:
            p, _, loss = step(
                params, opt_state, key, jnp.asarray(pos), jnp.asarray(mask),
                inner_d, esrc, edst, ew, sidx)
        return p, float(loss)

    p0, l0 = run(False)
    p1, l1 = run(True)
    assert np.isclose(l0, l1, rtol=1e-6), (l0, l1)
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
