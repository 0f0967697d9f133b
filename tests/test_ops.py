"""XLA-path op tests vs naive NumPy (SURVEY.md §4 item 1; ops ↔ oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.ops import (
    gather_rows,
    sddmm,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
    spmm_sorted_coo,
)
from bignn.oracle.numpy_ref import segment_softmax_ref, spmm_ref


def _sorted_segments(rng, n_rows, num_segments, with_oob=True):
    seg = np.sort(rng.integers(0, num_segments, n_rows))
    if with_oob:  # padding tail: one-past-the-end ids
        n_pad = max(n_rows // 5, 1)
        seg = np.concatenate([seg, np.full(n_pad, num_segments)])
    return seg.astype(np.int32)


@pytest.mark.parametrize("feat", [1, 7, 32])
def test_segment_sum_matches_numpy(feat):
    rng = np.random.default_rng(0)
    seg = _sorted_segments(rng, 100, 12)
    data = rng.normal(size=(len(seg), feat)).astype(np.float32)
    out = segment_sum(jnp.asarray(data), jnp.asarray(seg), 12)
    expect = np.zeros((12, feat))
    for i, s in enumerate(seg):
        if s < 12:
            expect[s] += data[i]
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-5)


def test_segment_mean_and_max():
    rng = np.random.default_rng(1)
    seg = _sorted_segments(rng, 50, 8)
    data = rng.normal(size=(len(seg), 4)).astype(np.float32)
    mean = np.asarray(segment_mean(jnp.asarray(data), jnp.asarray(seg), 8))
    mx = np.asarray(segment_max(jnp.asarray(data), jnp.asarray(seg), 8))
    for s in range(8):
        m = seg[: len(seg)] == s
        if m.any():
            np.testing.assert_allclose(mean[s], data[m].mean(0), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(mx[s], data[m].max(0), rtol=1e-5, atol=1e-5)
        else:
            assert np.all(mean[s] == 0) and np.all(mx[s] == 0)


def test_empty_segments_and_max_degree_row():
    # ragged edge cases from SURVEY.md §4: empty rows + one huge row
    seg = np.concatenate([np.zeros(90), np.full(5, 7)]).astype(np.int32)
    seg = np.sort(seg)
    data = np.ones((len(seg), 3), np.float32)
    out = np.asarray(segment_sum(jnp.asarray(data), jnp.asarray(seg), 8))
    assert np.all(out[0] == 90)
    assert np.all(out[7] == 5)
    assert np.all(out[1:7] == 0)


@pytest.mark.parametrize("shape", [(), (4,)])
def test_segment_softmax_matches_ref(shape):
    rng = np.random.default_rng(2)
    seg = _sorted_segments(rng, 60, 10)
    scores = rng.normal(size=(len(seg),) + shape).astype(np.float32)
    out = np.asarray(segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 10))
    expect = segment_softmax_ref(scores, seg, 10)
    real = seg < 10
    np.testing.assert_allclose(out[real], expect[real], rtol=1e-5, atol=1e-6)


def test_spmm_matches_ref():
    rng = np.random.default_rng(3)
    n, e, f = 20, 80, 16
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    out = np.asarray(spmm_sorted_coo(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n))
    np.testing.assert_allclose(out, spmm_ref(x, src, dst, w, n), rtol=1e-4, atol=1e-5)
    # unweighted
    out_u = np.asarray(spmm_sorted_coo(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), None, n))
    np.testing.assert_allclose(out_u, spmm_ref(x, src, dst, None, n), rtol=1e-4, atol=1e-5)


def test_sddmm_matches_dense():
    rng = np.random.default_rng(4)
    n, e, h, d = 10, 30, 2, 8
    q = rng.normal(size=(n, h, d)).astype(np.float32)
    k = rng.normal(size=(n, h, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    out = np.asarray(sddmm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(src), jnp.asarray(dst)))
    expect = np.einsum("ehd,ehd->eh", q[dst], k[src])
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_gather_rows_clips_oob():
    x = jnp.arange(12.0).reshape(4, 3)
    idx = jnp.asarray([0, 3, 5])  # 5 out of range -> clipped to 3
    out = np.asarray(gather_rows(x, idx))
    np.testing.assert_allclose(out[2], np.asarray(x)[3])


def test_permutation_scatter_rows_no_scatter_hlo():
    """out[idx[j]] = values[j] via inverse-permutation gather; neither the
    forward nor the VJP may emit a scatter primitive (embed_drugs places
    bucket embeddings with it instead of `.at[].set`)."""
    from bignn.ops.gather import permutation_scatter_rows

    rng = np.random.default_rng(0)
    n, d = 37, 5
    idx = rng.permutation(n).astype(np.int32)
    vals = rng.normal(size=(n, d)).astype(np.float32)

    out = permutation_scatter_rows(jnp.asarray(vals), jnp.asarray(idx))
    ref = np.zeros_like(vals)
    ref[idx] = vals
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6)

    # gradient parity vs the scatter formulation
    def f_perm(v):
        return jnp.sum(permutation_scatter_rows(v, jnp.asarray(idx)) ** 2 * 0.5)

    def f_scatter(v):
        return jnp.sum(jnp.zeros_like(v).at[jnp.asarray(idx)].set(v) ** 2 * 0.5)

    g1 = jax.grad(f_perm)(jnp.asarray(vals))
    g2 = jax.grad(f_scatter)(jnp.asarray(vals))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-6)

    # no scatter primitive anywhere in forward or backward jaxprs
    for fn in (f_perm, jax.grad(f_perm)):
        jaxpr = jax.make_jaxpr(fn)(jnp.asarray(vals))
        prims = {str(eqn.primitive) for eqn in jaxpr.jaxpr.eqns} | {
            str(e.primitive)
            for eqn in jaxpr.jaxpr.eqns
            if eqn.params.get("call_jaxpr") is not None
            for e in eqn.params["call_jaxpr"].eqns
        }
        assert not any("scatter" in p for p in prims), prims


def test_embed_drugs_matches_scatter_reference():
    """Multi-bucket embed_drugs (permutation-gather path) == zeros+scatter."""
    from bignn.data import make_synthetic_ddi, prepare_device_data
    from bignn.models import BiGNN, BiGNNConfig

    ds = make_synthetic_ddi(num_drugs=24, feat_dim=6, avg_degree=4.0,
                            min_atoms=4, max_atoms=16, seed=3)
    data = prepare_device_data(ds, max_buckets=3)
    assert len(data.bucketing.batches) > 1  # exercise the concat path
    model = BiGNN(BiGNNConfig(feat_dim=ds.feat_dim))
    params = model.init(jax.random.key(0))
    buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)

    emb = model.embed_drugs(params, buckets, gidx, ds.num_drugs)
    ref = np.zeros((ds.num_drugs, emb.shape[1]), np.float32)
    for b, i in zip(buckets, gidx):
        ref[np.asarray(i)] = np.asarray(model.encode_inner(params, b))
    np.testing.assert_allclose(np.asarray(emb), ref, rtol=1e-5, atol=1e-5)
