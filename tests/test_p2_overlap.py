"""Overlap path correctness (BASELINE.json:5,11): the boundary-first inner
split + raw-embedding pre-exchange must produce the SAME loss and parameter
updates as the plain per-layer exchange path."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel import (
    boundary_drugs,
    build_outer_partition,
    build_sharded_inner,
    device_put_plan,
    make_mesh,
    make_p2_train_step,
)


@pytest.mark.parametrize(
    "outer_spec,opt",
    [(("gcn:16:identity",), "adam"), (("gat:16:2",), "adam"),
     (("gin:16",), "adam"), (("gcn:16", "gcn:16"), "adam"),
     # multi-layer GIN outer: deeper layers take the local/remote-split
     # aggregation overlap inside dist_gin_apply. The
     # split reassociates the segment sums, so near-zero gradient elements
     # can flip sign; Adam's first-step normalization turns that into an
     # O(lr) param diff, so these specs compare under SGD (update linear in
     # the gradient — the honest value-parity check).
     (("gin:16", "gin:16"), "sgd"),
     (("gin:16", "gat:16:2", "gin:16"), "sgd")],
)
def test_overlap_matches_plain(outer_spec, opt):
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                              outer_layers=outer_spec))
    optimizer = optax.adam(1e-3) if opt == "adam" else optax.sgd(1e-2)
    params = model.init(jax.random.key(0))
    opt_state = optimizer.init(params)

    te = ds.split_edges("train")
    plan = build_outer_partition(te[:, 0], te[:, 1], ds.num_drugs, 4)
    mesh = make_mesh(dp=2, graph=4, devices=jax.devices()[:8])
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.integers(0, 40, (16, 2)), jnp.int32)
    mask = jnp.ones(16, jnp.float32)
    key = jax.random.key(7)

    results = {}
    for overlap in (False, True):
        if overlap:
            inner = build_sharded_inner(ds.molecules, plan, split_boundary=True)
        else:
            inner = build_sharded_inner(ds.molecules, plan)
        step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                                  overlap=overlap)
        inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
        with mesh:
            p, _, loss = step(params, opt_state, key, pos, mask,
                              inner_d, esrc, edst, ew, sidx)
        results[overlap] = (jax.tree.map(np.asarray, p), float(loss))

    (p0, l0), (p1, l1) = results[False], results[True]
    assert np.isclose(l0, l1, rtol=1e-5), (l0, l1)
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_boundary_split_partitions_drugs():
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=8, seed=1)
    te = ds.split_edges("train")
    plan = build_outer_partition(te[:, 0], te[:, 1], 40, 4)
    bnd, interior = build_sharded_inner(ds.molecules, plan, split_boundary=True)
    B = plan.node_block
    for g in range(4):
        nb = np.asarray(bnd.graph_n_nodes[g])
        ni = np.asarray(interior.graph_n_nodes[g])
        # each real drug in exactly one of the two unions
        both = (nb > 0) & (ni > 0)
        assert not both.any()
        n_drugs_g = min((g + 1) * B, 40) - g * B
        assert int((nb > 0).sum() + (ni > 0).sum()) == n_drugs_g
