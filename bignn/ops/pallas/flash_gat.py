"""Flash-tiled masked GAT attention as Pallas kernels for the GPU (Triton).

The dense outer-graph GAT (models/convs.py ``_dense_masked_softmax_agg``)
computes, for a count mask ``cnt[d, s]`` (edge multiplicity, 0 = no edge):

    z[d, s, h]   = leaky_relu(score_l[d, h] + score_r[s, h])
    alpha[d,s,h] = cnt[d, s] * exp(z - max_s z) / sum_s(...)
                   (rows with no edges -> 0)
    out[d, h, :] = sum_s alpha[d, s, h] * v[s, h, :]

XLA materialises every [N, N, H] intermediate of that chain and of its
backward in device memory. These kernels keep them on chip:

  * forward: one program per (dst block, head) walks the src blocks with an
    online softmax and writes ``out`` and the logsumexp ``lse``;
  * backward: one program per (src block, head) walks the dst blocks,
    recomputes alpha from ``lse`` and accumulates ``d_v`` and ``d_score_r``.
    ``d_score_l`` needs a sum over src, which runs across programs, so each
    program writes its partial row sums and XLA adds the partials — the
    second pass that replaces a sum carried between grid steps.

Backward, with delta[d, h] = sum_f g * out:

    d_e       = alpha * (g[d] . v[s] - delta[d])
    d_z       = d_e * (1 if z > 0 else slope)
    d_score_l = sum_s d_z,   d_score_r = sum_d d_z,   d_v = sum_d alpha g[d]
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bignn.ops.pallas.util import out_struct

NEG = -1e30  # "minus infinity" that survives f32 arithmetic
BLOCK = 64


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _scores(sl, sr, c, slope):
    """Masked leaky-relu scores of one [dst, src] tile, and z for d_z."""
    z = sl[:, None] + sr[None, :]
    e = jnp.where(z > 0, z, slope * z)
    return z, jnp.where(c > 0, e, NEG)


def _fwd_kernel(sl_ref, sr_ref, v_ref, cnt_ref, out_ref, lse_ref, *,
                slope, block):
    # refs: sl [BQ], sr [Np], v [Np, D], cnt [BQ, Np]; out [BQ, D], lse [BQ]
    sl = sl_ref[...]
    bq = sl.shape[0]

    def body(j, carry):
        acc, m, l = carry
        ks = pl.ds(j * block, block)
        c = cnt_ref[:, ks].astype(jnp.float32)
        _, e = _scores(sl, sr_ref[ks], c, slope)
        m_new = jnp.maximum(m, jnp.max(e, axis=1))
        corr = jnp.exp(m - m_new)
        p = c * jnp.exp(e - m_new[:, None])  # no edge: c == 0
        l = l * corr + jnp.sum(p, axis=1)
        v = v_ref[ks, :]
        acc = acc * corr[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    n_k = sr_ref.shape[0] // block
    acc = jnp.zeros((bq, v_ref.shape[1]), jnp.float32)
    m = jnp.full((bq,), NEG, jnp.float32)
    l = jnp.zeros((bq,), jnp.float32)
    acc, m, l = jax.lax.fori_loop(0, n_k, body, (acc, m, l))
    safe = jnp.maximum(l, 1e-30)
    out_ref[...] = (acc / safe[:, None]).astype(out_ref.dtype)
    lse_ref[...] = jnp.where(l > 0, m + jnp.log(safe), NEG)


def _bwd_kernel(sl_ref, sr_ref, v_ref, cnt_ref, g_ref, lse_ref, delta_ref,
                dslp_ref, dsr_ref, dv_ref, *, slope, block):
    # refs: sl/lse/delta [Np], g [Np, D], cnt [Np, BK], sr [BK], v [BK, D];
    # outs: dslp [Np] (this program's partial d_score_l), dsr [BK], dv [BK, D]
    sr = sr_ref[...]
    v = v_ref[...]
    bk = sr.shape[0]

    def body(i, carry):
        dsr, dv = carry
        qs = pl.ds(i * block, block)
        c = cnt_ref[qs, :].astype(jnp.float32)
        z, e = _scores(sl_ref[qs], sr, c, slope)
        alpha = c * jnp.exp(jnp.minimum(e - lse_ref[qs][:, None], 0.0))
        g = g_ref[qs, :]
        d_e = alpha * (pl.dot(g, v, trans_b=True) - delta_ref[qs][:, None])
        d_z = jnp.where(z > 0, d_e, slope * d_e)
        dslp_ref[qs] = jnp.sum(d_z, axis=1)
        dv = dv + pl.dot(alpha.astype(g.dtype), g, trans_a=True)
        return dsr + jnp.sum(d_z, axis=0), dv

    n_q = sl_ref.shape[0] // block
    dsr = jnp.zeros((bk,), jnp.float32)
    dv = jnp.zeros((bk, v.shape[1]), jnp.float32)
    dsr, dv = jax.lax.fori_loop(0, n_q, body, (dsr, dv))
    dsr_ref[...] = dsr
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _pad_inputs(score_l, score_r, v, cnt, np_):
    """Head-major, zero-padded operands: sl/sr [H, Np], v [H, Np, D]."""
    n = score_l.shape[0]
    pad = np_ - n
    sl = jnp.pad(score_l.astype(jnp.float32).T, ((0, 0), (0, pad)))
    sr = jnp.pad(score_r.astype(jnp.float32).T, ((0, 0), (0, pad)))
    vt = jnp.pad(jnp.swapaxes(v, 0, 1), ((0, 0), (0, pad), (0, 0)))
    cnt = jnp.pad(cnt, ((0, pad), (0, pad)))
    return sl, sr, vt, cnt


def _params():
    return plgpu.CompilerParams(num_warps=4, num_stages=2)


@functools.partial(jax.jit, static_argnames=("slope", "interpret"))
def _flash_fwd(score_l, score_r, v, cnt, *, slope, interpret):
    n, heads, d = v.shape
    np_ = _round_up(n, BLOCK)
    sl, sr, vt, cnt = _pad_inputs(score_l, score_r, v, cnt, np_)
    operands = (sl, sr, vt, cnt)
    out, lse = pl.pallas_call(
        functools.partial(_fwd_kernel, slope=slope, block=BLOCK),
        grid=(np_ // BLOCK, heads),
        in_specs=[
            pl.BlockSpec((None, BLOCK), lambda i, h: (h, i)),
            pl.BlockSpec((None, np_), lambda i, h: (h, 0)),
            pl.BlockSpec((None, np_, d), lambda i, h: (h, 0, 0)),
            pl.BlockSpec((BLOCK, np_), lambda i, h: (i, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, BLOCK, d), lambda i, h: (h, i, 0)),
            pl.BlockSpec((None, BLOCK), lambda i, h: (h, i)),
        ],
        out_shape=[
            out_struct((heads, np_, d), v.dtype, *operands),
            out_struct((heads, np_), jnp.float32, *operands),
        ],
        compiler_params=_params(),
        interpret=interpret,
        name="flash_gat_fwd",
    )(*operands)
    return jnp.swapaxes(out[:, :n], 0, 1), lse[:, :n].T


@functools.partial(jax.jit, static_argnames=("slope", "interpret"))
def _flash_bwd(score_l, score_r, v, cnt, lse, out, g, *, slope, interpret):
    n, heads, d = v.shape
    np_ = _round_up(n, BLOCK)
    nb = np_ // BLOCK
    pad = np_ - n
    sl, sr, vt, cnt = _pad_inputs(score_l, score_r, v, cnt, np_)
    gt = jnp.pad(jnp.swapaxes(g.astype(v.dtype), 0, 1),
                 ((0, 0), (0, pad), (0, 0)))
    delta = jnp.sum(g.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    delta = jnp.pad(delta.T, ((0, 0), (0, pad)))
    lse = jnp.pad(lse.T, ((0, 0), (0, pad)), constant_values=NEG)
    operands = (sl, sr, vt, cnt, gt, lse, delta)
    dslp, dsr, dv = pl.pallas_call(
        functools.partial(_bwd_kernel, slope=slope, block=BLOCK),
        grid=(nb, heads),  # src blocks; each walks every dst block
        in_specs=[
            pl.BlockSpec((None, np_), lambda j, h: (h, 0)),  # score_l
            pl.BlockSpec((None, BLOCK), lambda j, h: (h, j)),  # score_r
            pl.BlockSpec((None, BLOCK, d), lambda j, h: (h, j, 0)),  # v
            pl.BlockSpec((np_, BLOCK), lambda j, h: (0, j)),  # cnt columns
            pl.BlockSpec((None, np_, d), lambda j, h: (h, 0, 0)),  # g
            pl.BlockSpec((None, np_), lambda j, h: (h, 0)),  # lse
            pl.BlockSpec((None, np_), lambda j, h: (h, 0)),  # delta
        ],
        out_specs=[
            pl.BlockSpec((None, None, np_), lambda j, h: (j, h, 0)),
            pl.BlockSpec((None, BLOCK), lambda j, h: (h, j)),
            pl.BlockSpec((None, BLOCK, d), lambda j, h: (h, j, 0)),
        ],
        out_shape=[
            out_struct((nb, heads, np_), jnp.float32, *operands),
            out_struct((heads, np_), jnp.float32, *operands),
            out_struct((heads, np_, d), v.dtype, *operands),
        ],
        compiler_params=_params(),
        interpret=interpret,
        name="flash_gat_bwd",
    )(*operands)
    dsl = jnp.sum(dslp, axis=0)[:, :n].T
    return dsl, dsr[:, :n].T, jnp.swapaxes(dv[:, :n], 0, 1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def flash_gat_attention(score_l, score_r, v, cnt, slope=0.2, interpret=False):
    """Masked additive-attention aggregation with flash-tiled kernels.

    score_l/score_r: [N, H] pre-activation attention halves (dst/src);
    v: [N, H, D] values; cnt: [N, N] edge multiplicity (cnt[d, s]).
    Returns [N, H, D] in ``v.dtype``; equals ``_dense_masked_softmax_agg``
    with ``e = leaky_relu(score_l[:, None] + score_r[None, :])``.
    """
    return _flash_fwd(score_l, score_r, v, cnt, slope=slope,
                      interpret=interpret)[0]


def _flash_vjp_fwd(score_l, score_r, v, cnt, slope, interpret):
    out, lse = _flash_fwd(score_l, score_r, v, cnt, slope=slope,
                          interpret=interpret)
    return out, (score_l, score_r, v, cnt, lse, out)


def _flash_vjp_bwd(slope, interpret, res, g):
    score_l, score_r, v, cnt, lse, out = res
    dsl, dsr, dv = _flash_bwd(score_l, score_r, v, cnt, lse, out, g,
                              slope=slope, interpret=interpret)
    return (dsl.astype(score_l.dtype), dsr.astype(score_r.dtype),
            dv.astype(v.dtype), jnp.zeros_like(cnt))


flash_gat_attention.defvjp(_flash_vjp_fwd, _flash_vjp_bwd)
