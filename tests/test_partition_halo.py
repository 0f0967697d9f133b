"""P2 correctness (SURVEY.md §4 items 4-5): the edge-partitioned outer
propagation with halo all-to-all must match single-device propagation, on a
fake-CPU-device 'graph' mesh; the plan builder is also tested as a pure
function (host-count parameterized, no runtime)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from bignn.models import BiGNN, BiGNNConfig
from bignn.parallel.halo import dist_outer_forward
from bignn.parallel.partition import build_outer_partition
from bignn.sparse import build_outer_graph


def _edges(n, e, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, e)
    v = rng.integers(0, n, e)
    keep = u != v
    return u[keep], v[keep]


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_plan_pure_function(n_shards):
    n = 37
    u, v = _edges(n, 200, seed=1)
    plan = build_outer_partition(u, v, n, n_shards)
    B = plan.node_block
    # every shard's dst ids are sorted and within [0, B]
    for g in range(plan.n_shards):
        d = plan.edge_dst[g]
        assert np.all(np.diff(d) >= 0)
        assert d.max() <= B
        # ext src ids within bounds
        assert plan.edge_src[g].max() < plan.ext_size
    # total real edges = global edge count (symmetrized + self loops)
    og = build_outer_graph(u, v, n)
    global_real = (np.asarray(og.edge_dst) < n).sum()
    part_real = (plan.edge_dst < B).sum()
    assert part_real == global_real
    # every send_idx entry is a valid local id
    assert plan.send_idx.min() >= 0 and plan.send_idx.max() < B


@pytest.mark.parametrize("outer_spec", [("gcn:32",), ("gat:32:4",),
                                        ("gin:32",), ("gcn:32", "gat:32:2")])
def test_dist_outer_matches_single_device(outer_spec):
    n, n_shards, f = 50, 4, 32
    u, v = _edges(n, 300, seed=2)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(n, f)).astype(np.float32)

    model = BiGNN(BiGNNConfig(feat_dim=f, inner_layers=(), readout="sum",
                              outer_layers=outer_spec))
    # params: build via init (inner empty -> readout dim = feat_dim)
    params = model.init(jax.random.key(0))

    # single-device reference
    og = build_outer_graph(u, v, n)
    ref = np.asarray(
        model.propagate_outer(params, jnp.asarray(h), jax.tree.map(jnp.asarray, og))
    )

    # distributed
    plan = build_outer_partition(u, v, n, n_shards)
    B = plan.node_block
    h_pad = np.zeros((n_shards * B, f), np.float32)
    h_pad[:n] = h
    h_blocks = h_pad.reshape(n_shards, B, f)

    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("graph",))

    def shard_fn(h_b, src, dst, w, send_idx):
        return dist_outer_forward(
            model, params, h_b[0], src[0], dst[0], w[0], send_idx[0]
        )[None]

    out = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("graph"),) * 5,
            out_specs=P("graph"),
        )
    )(
        jnp.asarray(h_blocks),
        jnp.asarray(plan.edge_src),
        jnp.asarray(plan.edge_dst),
        jnp.asarray(plan.edge_weight),
        jnp.asarray(plan.send_idx),
    )
    got = np.asarray(out).reshape(n_shards * B, -1)[:n]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
