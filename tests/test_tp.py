"""Tensor parallelism (SURVEY.md §2.3 P3): the tp-sharded step must match
the single-device trajectory — parameters feature-sharded over 'tp', GSPMD
inserts all collectives (parallel/tp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bignn.data import make_synthetic_ddi, prepare_device_data
from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel import (
    make_mesh,
    shard_params_tp,
    tp_param_specs,
    tp_train_step_fn,
)
from jax.sharding import PartitionSpec as P


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    # GIN inner (tp pairs inside the conv MLPs) + GAT outer + MLP scorer
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=32, heads=4))
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    return ds, model, buckets, gidx, outer


def test_tp_param_specs_megatron_pairing(setup):
    ds, model, *_ = setup
    params = model.init(jax.random.key(0))
    specs = tp_param_specs(params, tp=4)
    # GIN conv MLP: layer_0 column-parallel, layer_1 row-parallel
    mlp = specs["inner"]["layer_0"]["mlp"]
    assert mlp["layer_0"]["w"] == P(None, "tp")
    assert mlp["layer_0"]["b"] == P("tp")
    assert mlp["layer_1"]["w"] == P("tp", None)
    assert mlp["layer_1"]["b"] == P()
    # GAT outer w column-parallel, attention vectors replicated
    assert specs["outer"]["layer_0"]["w"] == P(None, "tp")
    assert specs["outer"]["layer_0"]["a_l"] == P()
    # structures line up for tree.map
    jax.tree.map(lambda x, s: None, params, specs)


def test_tp_param_specs_gcn_stack_not_mlp():
    """A GCN conv stack ({layer_i: {w, b}}) is structurally identical to an
    MLP but must get the column-parallel conv treatment, never Megatron
    row/col pairing — _is_mlp only applies under an 'mlp' key."""
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gcn:16", "gcn:16"),
                              outer_layers=("gcn:16:identity",)))
    params = model.init(jax.random.key(0))
    specs = tp_param_specs(params, tp=4)
    for stack in (specs["inner"], specs["outer"]):
        for layer in stack.values():
            assert layer["w"] == P(None, "tp")  # all column-parallel
            assert layer["b"] == P("tp")
    jax.tree.map(lambda x, s: None, params, specs)


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4)])
def test_tp_matches_single_device(setup, dp, tp):
    ds, model, buckets, gidx, outer = setup
    optimizer = optax.adam(1e-3)
    params0 = model.init(jax.random.key(0))
    opt0 = optimizer.init(params0)
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.integers(0, ds.num_drugs, (16, 2)), jnp.int32)
    mask = jnp.ones(16, jnp.float32)
    key = jax.random.key(7)

    # single-device reference (same math, same PRNG)
    mesh1 = make_mesh(dp=1, tp=1, graph=1, devices=jax.devices()[:1])
    del mesh1  # reference runs unsharded
    from bignn.models.loss import bce_with_logits_loss
    from bignn.data.sampler import sample_negative_pairs

    def ref_loss(p, k):
        neg = sample_negative_pairs(k, pos, ds.num_drugs, 1)
        pairs = jnp.concatenate([pos, neg], axis=0)
        labels = jnp.concatenate([jnp.ones(16), jnp.zeros(16)])
        m = jnp.concatenate([mask, mask])
        return bce_with_logits_loss(
            model.apply(p, buckets, gidx, outer, pairs), labels, m)

    @jax.jit
    def ref_step(p, o, k):
        loss, g = jax.value_and_grad(ref_loss)(p, k)
        up, o = optimizer.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    p_ref, o_ref, l_ref = ref_step(params0, opt0, key)

    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    with mesh:
        p_tp = shard_params_tp(mesh, params0)
        o_tp = jax.jit(optimizer.init)(p_tp)
        step = tp_train_step_fn(model, optimizer, mesh, ds.num_drugs)
        p1, o1, l1 = step(p_tp, o_tp, key, pos, mask, buckets, gidx, outer)

    assert np.isclose(float(l_ref), float(l1), rtol=1e-5), (l_ref, l1)
    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-5)


def test_tp_param_specs_attention_gate_is_mlp():
    """AttentionReadout's gate MLP lives under a 'gate' key (not 'mlp');
    it must still get Megatron row/col pairing (r3 review finding)."""
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:32",),
                              readout="attention:32",
                              outer_layers=("gcn:32:identity",)))
    params = model.init(jax.random.key(0))
    specs = tp_param_specs(params, tp=4)
    gate = specs["readout"]["gate"]
    assert gate["layer_0"]["w"] == P(None, "tp")
    assert gate["layer_0"]["b"] == P("tp")
    assert gate["layer_1"]["w"] == P("tp", None)  # row-parallel pair
    jax.tree.map(lambda x, s: None, params, specs)
