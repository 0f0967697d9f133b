"""Dense outer-graph path parity (models/convs.py dense=...).

Small DDI graphs (DrugBank ~1.7K drugs, ~9% edge density) run the outer
convs through dense [N, N] matmuls / masked dense softmax instead
of sparse segment ops. These tests pin the dense path to the sparse one —
forward and gradients — including duplicate edges (multiplicity) and
isolated nodes (empty softmax segments).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bignn.models.convs import parse_conv
from bignn.sparse.formats import build_outer_graph


def _random_graph(n=60, e=400, seed=0, with_duplicates=False, isolated=True):
    rng = np.random.default_rng(seed)
    hi = n - 4 if isolated else n  # leave the last nodes edge-free
    src = rng.integers(0, hi, e)
    dst = rng.integers(0, hi, e)
    if with_duplicates:
        src = np.concatenate([src, src[:50]])
        dst = np.concatenate([dst, dst[:50]])
    return src, dst


def _outer_pair(src, dst, n, **kw):
    """Same graph twice: with and without the dense materialization."""
    sparse = build_outer_graph(src, dst, n, dense_max_nodes=0, **kw)
    dense = build_outer_graph(src, dst, n, dense_max_nodes=n, **kw)
    return sparse, dense


@pytest.mark.parametrize("spec", ["gcn:32", "gin:32", "gat:32:4", "dotattn:32:4"])
@pytest.mark.parametrize("dup", [False, True])
def test_dense_matches_sparse_fwd_and_grad(spec, dup):
    n = 60
    src, dst = _random_graph(n=n, with_duplicates=dup)
    # self-loops give isolated nodes a defined softmax; also test without
    sparse_g, dense_g = _outer_pair(src, dst, n)
    conv = parse_conv(spec, 24)
    params = conv.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (n, 24), jnp.float32)

    def run(g, dense):
        kw = {}
        if dense:
            kw["dense"] = (jnp.asarray(g.dense_adj), jnp.asarray(g.dense_cnt))
        return conv.apply(params, x, jnp.asarray(g.edge_src),
                          jnp.asarray(g.edge_dst), jnp.asarray(g.edge_weight),
                          g.num_nodes, **kw)

    out_s = run(sparse_g, False)
    out_d = run(dense_g, True)
    np.testing.assert_allclose(out_s, out_d, rtol=2e-5, atol=2e-5)

    def loss(p, dense):
        g = dense_g if dense else sparse_g
        kw = {}
        if dense:
            kw["dense"] = (jnp.asarray(g.dense_adj), jnp.asarray(g.dense_cnt))
        out = conv.apply(p, x, jnp.asarray(g.edge_src), jnp.asarray(g.edge_dst),
                         jnp.asarray(g.edge_weight), g.num_nodes, **kw)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape)))

    g_s = jax.grad(loss)(params, False)
    g_d = jax.grad(loss)(params, True)
    for (ka, a), (kb, b) in zip(jax.tree.leaves_with_path(g_s),
                                jax.tree.leaves_with_path(g_d)):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5,
                                   err_msg=f"grad leaf {ka}")
        assert np.all(np.isfinite(b)), f"non-finite dense grad {kb}"


def test_isolated_nodes_no_self_loops():
    """Without self-loops, edge-free rows must aggregate to exactly 0 in the
    attention convs (empty softmax segment) with finite gradients."""
    n = 32
    src = np.array([0, 1, 2, 3]); dst = np.array([1, 2, 3, 0])
    sparse_g, dense_g = _outer_pair(src, dst, n, add_self_loops=False,
                                    normalize=False)
    conv = parse_conv("gat:16:2", 8)
    params = conv.init(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (n, 8), jnp.float32)

    def run(p, g, dense):
        kw = {}
        if dense:
            kw["dense"] = (jnp.asarray(g.dense_adj), jnp.asarray(g.dense_cnt))
        return conv.apply(p, x, jnp.asarray(g.edge_src), jnp.asarray(g.edge_dst),
                          jnp.asarray(g.edge_weight), g.num_nodes, **kw)

    out_s = run(params, sparse_g, False)
    out_d = run(params, dense_g, True)
    np.testing.assert_allclose(out_s, out_d, rtol=2e-5, atol=2e-5)
    g = jax.grad(lambda p: run(p, dense_g, True).sum())(params)
    assert all(np.all(np.isfinite(l)) for l in jax.tree.leaves(g))


def test_builder_threshold():
    src, dst = _random_graph(n=60)
    g = build_outer_graph(src, dst, 60, dense_max_nodes=32)
    assert g.dense_adj is None and g.dense_cnt is None
    g = build_outer_graph(src, dst, 60, dense_max_nodes=64)
    assert g.dense_adj.shape == (60, 60) and g.dense_cnt.shape == (60, 60)
    # adjacency sums must reproduce the padded edge list exactly
    w = np.zeros((60, 60), np.float32)
    np.add.at(w, (g.edge_dst[g.edge_dst < 60], g.edge_src[g.edge_dst < 60]),
              g.edge_weight[g.edge_dst < 60])
    np.testing.assert_allclose(g.dense_adj, w, rtol=1e-6)
