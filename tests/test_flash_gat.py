"""Parity of the flash-tiled masked GAT attention kernels
(ops/pallas/flash_gat.py, Triton route, interpret mode) vs the XLA dense
version (models/convs._dense_masked_softmax_agg) — values and gradients,
including empty rows, edge multiplicity > 1, and N not a multiple of the
kernel block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.models.convs import GATConv, _dense_masked_softmax_agg
from bignn.ops.pallas.flash_gat import NEG, _flash_fwd, flash_gat_attention

N, H, D = 200, 4, 16
SLOPE = 0.2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    score_l = jnp.asarray(rng.standard_normal((N, H)), jnp.float32)
    score_r = jnp.asarray(rng.standard_normal((N, H)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((N, H, D)), jnp.float32)
    cnt = (rng.random((N, N)) < 0.05).astype(np.float32)
    cnt += (rng.random((N, N)) < 0.01)  # some multiplicity-2 edges
    cnt[17] = 0.0  # a row with no incoming edges
    cnt[140:] = 0.0  # a tail of empty rows (mimics padding)
    return score_l, score_r, v, jnp.asarray(cnt)


def _reference(score_l, score_r, v, cnt):
    e = jax.nn.leaky_relu(score_l[:, None, :] + score_r[None, :, :], SLOPE)
    return _dense_masked_softmax_agg(e, cnt, v, jnp.float32)


def test_forward_parity(inputs):
    score_l, score_r, v, cnt = inputs
    got = flash_gat_attention(score_l, score_r, v, cnt, SLOPE, True)
    want = _reference(score_l, score_r, v, cnt)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(got)[17] == 0.0)


def test_forward_logsumexp(inputs):
    """The forward kernel's logsumexp residual (what the backward
    recomputes alpha from) equals the dense one; empty rows carry NEG."""
    score_l, score_r, v, cnt = inputs
    _, lse = _flash_fwd(score_l, score_r, v, cnt, slope=SLOPE, interpret=True)
    e = jax.nn.leaky_relu(score_l[:, None, :] + score_r[None, :, :], SLOPE)
    p = cnt[:, :, None] * jnp.exp(jnp.where(cnt[:, :, None] > 0, e, -jnp.inf))
    want = jnp.log(p.sum(axis=1))
    lse = np.asarray(lse)
    live = np.asarray(cnt).sum(axis=1) > 0
    np.testing.assert_allclose(lse[live], np.asarray(want)[live],
                               rtol=1e-5, atol=1e-5)
    assert np.all(lse[~live] == NEG)


def test_gradient_parity(inputs):
    score_l, score_r, v, cnt = inputs
    w = jnp.asarray(
        np.random.default_rng(1).standard_normal((N, H, D)), jnp.float32)

    def loss_flash(sl, sr, vv):
        return jnp.sum(flash_gat_attention(sl, sr, vv, cnt, SLOPE, True) * w)

    def loss_ref(sl, sr, vv):
        return jnp.sum(_reference(sl, sr, vv, cnt) * w)

    g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(score_l, score_r, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(score_l, score_r, v)
    for gf, gr, name in zip(g_flash, g_ref, ("d_score_l", "d_score_r", "d_v")):
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gr),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_gatconv_dense_path_takes_xla_off_gpu(monkeypatch):
    """GATConv over a dense outer graph calls the flash kernel only when
    ops.dispatch says so, and both paths agree."""
    import bignn.models.convs as convs
    from bignn.sparse.formats import build_outer_graph

    rng = np.random.default_rng(2)
    n = 150
    outer = build_outer_graph(rng.integers(0, n, 600),
                              rng.integers(0, n, 600), n)
    assert outer.dense_adj is not None
    conv = GATConv(in_dim=24, out_dim=32, heads=4)
    params = conv.init(jax.random.key(0))
    x = jnp.asarray(rng.standard_normal((n, 24)), jnp.float32)
    dense = (jnp.asarray(outer.dense_adj), jnp.asarray(outer.dense_cnt))

    def run():
        return conv.apply(params, x, jnp.asarray(outer.edge_src),
                          jnp.asarray(outer.edge_dst),
                          jnp.asarray(outer.edge_weight), n, dense=dense)

    want = run()  # CPU: the XLA composition
    import bignn.ops.pallas.flash_gat as fg

    monkeypatch.setattr(convs, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(
        fg, "flash_gat_attention",
        lambda *a: flash_gat_attention(*a, interpret=True))
    got = run()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu, inputs):
    """On a card: the compiled Triton kernels vs the XLA dense version."""
    score_l, score_r, v, cnt = inputs

    def loss(fn):
        return lambda sl, sr, vv: jnp.sum(fn(sl, sr, vv) ** 2)

    ker = jax.jit(jax.value_and_grad(loss(
        lambda a, b, c: flash_gat_attention(a, b, c, cnt, SLOPE)),
        argnums=(0, 1, 2)))
    ref = jax.jit(jax.value_and_grad(loss(
        lambda a, b, c: _reference(a, b, c, cnt)), argnums=(0, 1, 2)))
    (vk, gk), (vr, gr) = ker(score_l, score_r, v), ref(score_l, score_r, v)
    # both sides run f32 matmuls in TF32 on the card
    np.testing.assert_allclose(float(vk), float(vr), rtol=1e-2)
    for a, b in zip(gk, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-2, atol=2e-2)
