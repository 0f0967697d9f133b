"""The XLA segment ops, SpMM and multi-head aggregation against the NumPy
oracle (bignn/oracle/numpy_ref.py) over a grid of shapes, with padding
segment ids, block-boundary rows, and gradients; and the full model on the
block-local / dense-outer layouts against the oracle forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn import ops
from bignn.oracle.numpy_ref import segment_softmax_ref, spmm_ref


def _sorted_ids(rng, e, n, pad_frac=0.1):
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    npad = max(int(e * pad_frac), 1)
    seg[-npad:] = n  # padding tail -> dropped
    return np.sort(seg)


def _np_segment_sum(data, seg, n):
    out = np.zeros((n,) + data.shape[1:])
    live = seg < n
    np.add.at(out, seg[live], data[live].astype(np.float64))
    return out


@pytest.mark.parametrize(
    "e,n,f",
    [(1000, 50, 16), (5000, 300, 64), (100, 5, 1), (8, 3, 4),
     (1024, 130, 128), (3000, 128, 128), (257, 9, 130)],
)
def test_segment_sum_matches_oracle(e, n, f):
    rng = np.random.default_rng(e + n + f)
    seg = _sorted_ids(rng, e, n)
    data = rng.normal(size=(e, f)).astype(np.float32)
    out = np.asarray(ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), n))
    np.testing.assert_allclose(out, _np_segment_sum(data, seg, n),
                               rtol=1e-4, atol=1e-4)


def test_segment_sum_block_boundary_rows():
    # segments exactly at multiples of 128 (the block-local row blocks)
    e, n = 4096, 300
    rng = np.random.default_rng(0)
    seg = np.sort(np.concatenate([
        np.full(50, 127), np.full(50, 128), np.full(50, 255), np.full(50, 256),
        rng.integers(0, n, e - 200),
    ])).astype(np.int32)
    data = rng.normal(size=(e, 32)).astype(np.float32)
    out = np.asarray(ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), n))
    np.testing.assert_allclose(out, _np_segment_sum(data, seg, n),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(), (4,)])
def test_segment_softmax_matches_oracle(shape):
    rng = np.random.default_rng(7)
    e, n = 600, 40
    seg = _sorted_ids(rng, e, n)
    scores = rng.normal(size=(e,) + shape).astype(np.float32)
    out = np.asarray(ops.segment_softmax(jnp.asarray(scores),
                                         jnp.asarray(seg), n))
    expect = segment_softmax_ref(np.asarray(scores, np.float64), seg, n)
    real = seg < n
    np.testing.assert_allclose(out[real], expect[real], rtol=1e-4, atol=1e-5)


def _np_segment_max(data, seg, n):
    out = np.full((n,) + data.shape[1:], -np.inf)
    live = seg < n
    np.maximum.at(out, seg[live], data[live])
    return np.where(np.isfinite(out), out, 0.0)


@pytest.mark.parametrize("shape", [(), (4,), (3,)])
def test_segment_max_matches_oracle(shape):
    rng = np.random.default_rng(11)
    e, n = 700, 45
    seg = _sorted_ids(rng, e, n)
    seg[seg == 7] = 8  # an empty segment -> 0, not -inf
    scores = rng.normal(size=(e,) + shape).astype(np.float32)
    out = np.asarray(ops.segment_max(jnp.asarray(scores), jnp.asarray(seg), n))
    np.testing.assert_allclose(out, _np_segment_max(scores, seg, n), atol=1e-6)
    assert np.all(out[7] == 0.0)


def test_segment_max_grad_routes_to_argmax():
    """d/dx sum(w * segment_max(x)) puts w[s] on each segment's maximum."""
    rng = np.random.default_rng(12)
    e, n = 300, 20
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    x = rng.normal(size=(e, 5)).astype(np.float32)  # ties have measure zero
    w = rng.normal(size=(n, 5)).astype(np.float32)
    g = np.asarray(jax.grad(lambda d: jnp.sum(
        ops.segment_max(d, jnp.asarray(seg), n) * w))(jnp.asarray(x)))
    expect = np.zeros_like(x)
    m = _np_segment_max(x, seg, n)
    for i, s in enumerate(seg):
        expect[i] = np.where(x[i] == m[s], w[s], 0.0)
    np.testing.assert_allclose(g, expect, atol=1e-6)


def _spmm_problem(seed, n=48, e_real=400, e_cap=512, f=16):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e_real)).astype(np.int32)
    dst = np.concatenate([dst, np.full(e_cap - e_real, n, np.int32)])
    src = np.concatenate([rng.integers(0, n, e_real),
                          np.zeros(e_cap - e_real, np.int64)]).astype(np.int32)
    w = np.concatenate([rng.random(e_real),
                        np.zeros(e_cap - e_real)]).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, src, dst, w, n


def test_spmm_sorted_coo_value_and_grad_match_oracle():
    """Values and d/dx of sum(out * g) = A^T g, including padded edges."""
    x, src, dst, w, n = _spmm_problem(3)
    g_out = np.random.default_rng(4).normal(size=(n, x.shape[1]))
    a = [jnp.asarray(v) for v in (x, src, dst, w)]
    out = np.asarray(ops.spmm_sorted_coo(*a, n))
    np.testing.assert_allclose(out, spmm_ref(x, src, dst, w, n),
                               rtol=1e-4, atol=1e-5)
    grad = np.asarray(jax.grad(lambda xx: jnp.sum(
        ops.spmm_sorted_coo(xx, *a[1:], n) * g_out))(a[0]))
    live = dst < n
    expect = np.zeros_like(x, np.float64)
    np.add.at(expect, src[live], w[live, None] * g_out[dst[live]])
    np.testing.assert_allclose(grad, expect, rtol=1e-4, atol=1e-5)


def test_spmm_multihead_value_and_grads_match_oracle():
    rng = np.random.default_rng(4)
    n, e, h, d = 32, 256, 2, 8
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst[-16:] = n  # padding edges
    src = rng.integers(0, n, e).astype(np.int32)
    alpha = rng.random((e, h)).astype(np.float32)
    v = rng.normal(size=(n, h, d)).astype(np.float32)
    g_out = rng.normal(size=(n, h, d))
    args = (jnp.asarray(src), jnp.asarray(dst))
    out = np.asarray(ops.spmm_multihead(jnp.asarray(v), *args,
                                        jnp.asarray(alpha), n))
    live = dst < n
    expect = _np_segment_sum(alpha[:, :, None] * v[src], dst, n)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)
    gv, ga = jax.grad(lambda vv, al: jnp.sum(
        ops.spmm_multihead(vv, *args, al, n) * g_out), argnums=(0, 1))(
            jnp.asarray(v), jnp.asarray(alpha))
    gd = np.where(live[:, None, None], g_out[np.minimum(dst, n - 1)], 0.0)
    ev = np.zeros_like(v, np.float64)
    np.add.at(ev, src, alpha[:, :, None] * gd)
    np.testing.assert_allclose(np.asarray(gv), ev, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ga), np.sum(v[src] * gd, axis=-1),
                               rtol=1e-4, atol=1e-5)


def test_full_model_block_local_dense_outer_matches_oracle():
    """Full BI-GNN on prepare_device_data's layouts (block-local inner with
    dense block adjacency, dense outer graph) against the oracle forward."""
    from bignn.data import make_synthetic_ddi, prepare_device_data
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.oracle.numpy_ref import bignn_forward_ref

    ds = make_synthetic_ddi(num_drugs=30, feat_dim=8, avg_degree=5.0,
                            min_atoms=4, max_atoms=8, seed=0)
    data = prepare_device_data(ds, max_buckets=2)
    assert data.outer.dense_cnt is not None
    assert all(b.block_adj is not None for b in data.bucketing.batches)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    params = model.init(jax.random.key(0))
    buckets = tuple(jax.tree.map(jnp.asarray, b)
                    for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    pairs = np.random.default_rng(0).integers(0, 30, (12, 2)).astype(np.int32)
    out = np.asarray(jax.jit(model.apply)(params, buckets, gidx, outer,
                                          jnp.asarray(pairs)))
    ref = bignn_forward_ref(model, params, data.bucketing.batches,
                            data.bucketing.graph_index, data.outer, pairs)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)
