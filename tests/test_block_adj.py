"""On-device block-diagonal adjacency build (ops.block_adjacency, the XLA
scatter build) against a NumPy count, and end-to-end parity of the
dense-inner minibatch path vs the streaming sparse path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.ops.spmm import block_adjacency
from bignn.train.trainer import MinibatchTrainer, TrainConfig


def _random_block_local_edges(rng, nblk, max_deg=6):
    """Edges whose endpoints share a 128-row block, dst-sorted within each
    block, with padding edges (dst == n) between and after the blocks, as
    the minibatch expansion lays them out."""
    src_all, dst_all = [], []
    n = nblk * 128
    for b in range(nblk):
        n_e = rng.integers(10, 128 * max_deg)
        lo = b * 128
        src_all.append(rng.integers(lo, lo + 128, n_e))
        dst_all.append(np.sort(rng.integers(lo, lo + 128, n_e)))
        pad = rng.integers(0, 40)
        src_all.append(np.zeros(pad, np.int64))
        dst_all.append(np.full(pad, n))
    src = np.concatenate(src_all).astype(np.int32)
    dst = np.concatenate(dst_all).astype(np.int32)
    return src, dst, n


def _np_adjacency(src, dst, n, weight=None):
    live = dst < n
    out = np.zeros((n // 128, 128, 128))
    np.add.at(out, (dst[live] // 128, dst[live] % 128, src[live] % 128),
              1.0 if weight is None else weight[live])
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_build_matches_numpy(weighted):
    """Counts as int8 and int16, weights as bf16 and f32, padding dropped."""
    rng = np.random.default_rng(0)
    src, dst, n = _random_block_local_edges(rng, nblk=7)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    ref = _np_adjacency(src, dst, n, w)
    for dt in (jnp.bfloat16, jnp.float32) if weighted else (jnp.int8,
                                                            jnp.int16):
        out = block_adjacency(jnp.asarray(src), jnp.asarray(dst),
                              None if w is None else jnp.asarray(w), n, dt)
        assert out.dtype == jnp.dtype(dt)
        tol = 1e-2 if dt == jnp.bfloat16 else 1e-6
        np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                                   rtol=tol, atol=tol)


def test_cross_block_edges_drop_out():
    """An edge whose src lies outside its dst's 128-row block is not part of
    the block-diagonal adjacency."""
    src = np.array([5, 130, 200, 3], np.int32)
    dst = np.array([1, 1, 129, 256], np.int32)  # 2nd: cross-block; 4th: pad
    out = np.asarray(block_adjacency(jnp.asarray(src), jnp.asarray(dst),
                                     None, 256, jnp.int8))
    ref = np.zeros((2, 128, 128))
    ref[0, 1, 5] = 1
    ref[1, 1, 200 - 128] = 1
    np.testing.assert_array_equal(out, ref)


def test_build_int8_count_parity():
    """int8 count adjacency with duplicate edges: the trainer stores
    multiplicity counts as int8 when r_node^2 <= 127, and the f32 counts
    must cast without wrapping for in-range multiplicities."""
    rng = np.random.default_rng(7)
    src, dst, n = _random_block_local_edges(rng, nblk=3)
    # inject duplicate (dst, src) pairs to exercise multiplicity > 1
    src[1] = src[0]
    dst[1] = dst[0]
    ref = _np_adjacency(src, dst, n)
    assert ref.max() >= 2  # the injected duplicate
    assert ref.max() <= 127, "test edges must stay in int8 range"
    out = np.asarray(block_adjacency(
        jnp.asarray(src), jnp.asarray(dst), None, n, jnp.int8))
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out.astype(np.float64), ref)


def test_int8_guard_widens_for_large_superrows():
    """The trainer must not choose int8 counts when r_node^2 > 127 (a
    superrow pair's multiplicity is bounded by r_node^2 and the f32->int8
    cast wraps silently)."""
    import inspect

    from bignn.train import trainer as trainer_mod

    src = inspect.getsource(trainer_mod.MinibatchTrainer._expand_compact)
    assert "R_N * R_N <= 127" in src


def test_build_int16_count_parity():
    """The widened int16 branch the guard selects for r_node^2 > 127 builds
    multiplicities past the int8 range exactly."""
    rng = np.random.default_rng(11)
    src, dst, n = _random_block_local_edges(rng, nblk=2)
    # force one (dst, src) pair's multiplicity beyond int8 range
    src[1:201] = src[0]
    dst[1:201] = dst[0]
    ref = _np_adjacency(src, dst, n)
    assert ref.max() > 127, "test must exceed the int8 range"
    assert ref.max() <= 32767
    out = np.asarray(block_adjacency(
        jnp.asarray(src), jnp.asarray(dst), None, n, jnp.int16))
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out.astype(np.float64), ref)


@pytest.mark.parametrize("inner", [("gin:16", "gin:16"), ("gcn:16", "gin:16")])
def test_dense_inner_matches_streaming(inner):
    ds = make_synthetic_ddi(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=inner,
                              outer_layers=("gcn:16:identity",)))
    cfg = TrainConfig(batch_size=8, epochs=1)
    tr_dense = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2)
    tr_stream = MinibatchTrainer(model, ds, cfg, fanouts=(4,), calibrate_caps=2)
    tr_stream.dense_inner = False  # before the first trace

    assert tr_dense.dense_inner and tr_dense.sampler.block_local
    params, _ = tr_dense.init()
    tr_dense.sampler.reseed(0)
    cb = jax.tree.map(jnp.asarray, tr_dense.sampler.sample_compact())

    out_d = np.asarray(tr_dense._score_batch(params, cb, tr_dense.tables))
    out_s = np.asarray(tr_stream._score_batch(params, cb, tr_stream.tables))
    np.testing.assert_allclose(out_d, out_s, rtol=2e-4, atol=2e-5)

    # grads agree too (the dense backward is AD through the batched matmul)
    def loss(t, p):
        return jnp.sum(t._forward(p, cb, t.tables) ** 2)

    g_d = jax.grad(lambda p: loss(tr_dense, p))(params)
    g_s = jax.grad(lambda p: loss(tr_stream, p))(params)
    for a, b in zip(jax.tree.leaves(g_d), jax.tree.leaves(g_s)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-5)
