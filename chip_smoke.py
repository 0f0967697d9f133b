"""Smoke test of the BI-GNN train and serve path on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

Phases (each prints one JSON line; any failure ends the run non-zero):

  1. device    — the GPU JAX runs on, nvidia-smi's name and power limit,
                 JAX version, XLA_FLAGS, the compile-cache directory;
  2. parity    — each op of the train path on the card against a float64
                 NumPy reference (bignn/oracle/numpy_ref.py where it has the
                 op) at real widths, forward and gradient, in float32 and in
                 bf16; each hand-written kernel also against its plain XLA
                 version; the full BiGNN forward against bignn_forward_ref;
  3. memory    — compiled.memory_analysis() of the config-2 full-graph train
                 step and of the config-4 device-sampled minibatch chunk;
  4. config2   — ~20 Trainer steps of config 2 (GIN inner, GAT outer, dim
                 128, DrugBank standin): finite, decreasing loss;
  5. config4   — one 8-step chunk of MinibatchTrainer(device_sample=True)
                 on config 4 (100K drugs, 10M outer edges, bf16): finite loss;
  6. serve     — a Scorer on the config-2 model: top_k, and score_pairs on
                 64K pairs against BiGNN.apply.

The last line is ``{"ok": true, "device": {...}}``. Without a GPU the run
exits non-zero at phase 1. ``--four-cards`` runs only the config-5 p2 step
(dp=1 x graph=4, DrugBank standin) against one card, and dp=4 minibatch
training against the union of its per-shard batches.

The phase functions take their sizes as arguments so the CPU tests can run
them small; this script always runs them at the sizes below.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

# Tolerances on max|got - ref| / max|ref|. float32: XLA and the Triton
# kernels may run f32 matmuls in TF32 (10-bit mantissa) on this card, and
# sums run in another order than NumPy's. bf16: 8-bit mantissa inputs and
# intermediates.
TOL = {"float32": 5e-3, "bfloat16": 5e-2}

# Four-card p2 losses against one card (relative). The first step runs at
# the same parameters, so only summation order and TF32 separate the two.
# Later steps go through Adam, whose first updates are lr * sign(grad): the
# few parameters whose gradient is ~0 take opposite signs on the two paths,
# and the losses drift apart (5.7e-3 at step 3 on 4x H100). The gradient
# itself is checked at highest precision against TOL["float32"].
P2_LOSS_TOL = {"first": 2e-3, "later": 3e-2}

# config-4 outer-layer widths (GAT, 4 heads x 32 = 128 lanes) and
# config-2's dense outer graph (DrugBank standin)
HEADS, HEAD_DIM = 4, 32
DRUGBANK_N = 1704


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def _err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


class Checks:
    """Collects parity results; ``failed`` lists those over tolerance."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, op: str, dtype: str, **fields) -> None:
        """``fields``: float errors (checked) and str/bool labels."""
        tol = TOL[dtype]
        bad = [k for k, v in fields.items()
               if isinstance(v, float) and not v <= tol]
        if bad:
            self.failed.append(f"{op}[{dtype}]:{','.join(bad)}")
        emit("parity", op=op, dtype=dtype, tol=tol, ok=not bad, **fields)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from bignn.utils import enable_compile_cache
    from bignn.utils.device import device_info, nvidia_smi, require_gpu

    require_gpu()
    info = device_info()
    emit("device", **info, jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=enable_compile_cache())
    print(nvidia_smi(), flush=True)  # "<name>, <power limit>"
    return info


# ---------------------------------------------------------------------------
# 2. parity
# ---------------------------------------------------------------------------


def _segment_problem(rng, n_seg, n_edges, width):
    """Sorted segment ids with a padded tail (id == n_seg), random rows."""
    seg = np.sort(rng.integers(0, n_seg, n_edges)).astype(np.int32)
    seg[-max(n_edges // 20, 1):] = n_seg
    return seg, rng.standard_normal((n_edges, width))


def _np_segment_sum(data, seg, n):
    out = np.zeros((n,) + data.shape[1:])
    live = seg < n
    np.add.at(out, seg[live], data[live])
    return out


def parity_segment_ops(checks, n_seg: int, n_edges: int, heads: int = HEADS,
                       head_dim: int = HEAD_DIM, seed: int = 0) -> None:
    """segment_sum, segment_softmax and spmm_multihead at the outer GAT
    widths, forward and gradient of sum(out * w), against float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from bignn import ops
    from bignn.oracle.numpy_ref import segment_softmax_ref

    rng = np.random.default_rng(seed)
    width = heads * head_dim
    seg, data = _segment_problem(rng, n_seg, n_edges, width)
    src = rng.integers(0, n_seg, n_edges).astype(np.int32)
    scores = rng.standard_normal((n_edges, heads))
    v = rng.standard_normal((n_seg, heads, head_dim))
    w_sum = rng.standard_normal((n_seg, width))
    w_sm = rng.standard_normal((n_edges, heads))
    w_mh = rng.standard_normal((n_seg, heads, head_dim))
    live = seg < n_seg
    seg_j, src_j = jnp.asarray(seg), jnp.asarray(src)

    for dt in (jnp.float32, jnp.bfloat16):
        name = jnp.dtype(dt).name
        q = lambda a: np.asarray(jnp.asarray(a, dt), np.float64)  # noqa: E731
        x, s, vv = q(data), q(scores), q(v)
        alpha = segment_softmax_ref(s, seg, n_seg) * live[:, None]
        alpha = q(alpha)

        # segment_sum
        out = jax.jit(lambda d: ops.segment_sum(d, seg_j, n_seg))(
            jnp.asarray(x, dt))
        g = jax.jit(jax.grad(lambda d: jnp.sum(ops.segment_sum(
            d, seg_j, n_seg).astype(jnp.float32) * w_sum)))(
                jnp.asarray(x, dt))
        checks("segment_sum", name,
               fwd=_err(out, _np_segment_sum(x, seg, n_seg)),
               grad=_err(g, np.where(live[:, None],
                                     w_sum[np.minimum(seg, n_seg - 1)], 0)))

        # segment_softmax (real edges only: padding rows are unspecified)
        out = jax.jit(lambda a: ops.segment_softmax(a, seg_j, n_seg))(
            jnp.asarray(s, dt))
        p = segment_softmax_ref(s, seg, n_seg)
        g = jax.jit(jax.grad(lambda a: jnp.sum(jnp.where(
            live[:, None], ops.segment_softmax(a, seg_j, n_seg).astype(
                jnp.float32) * w_sm, 0.0))))(jnp.asarray(s, dt))
        pw = np.where(live[:, None], p * w_sm, 0.0)
        ref_g = p * (w_sm - _np_segment_sum(pw, seg, n_seg)[
            np.minimum(seg, n_seg - 1)])
        checks("segment_softmax", name,
               fwd=_err(np.asarray(out)[live], p[live]),
               grad=_err(np.asarray(g)[live], ref_g[live]))

        # spmm_multihead: out[d, h] = sum_e alpha[e, h] v[src_e, h]
        def mh(vv_, al):
            return ops.spmm_multihead(vv_, src_j, seg_j, al, n_seg)

        out = jax.jit(mh)(jnp.asarray(vv, dt), jnp.asarray(alpha, dt))
        gv, ga = jax.jit(jax.grad(lambda a, b: jnp.sum(
            mh(a, b).astype(jnp.float32) * w_mh), argnums=(0, 1)))(
                jnp.asarray(vv, dt), jnp.asarray(alpha, dt))
        msgs = alpha[:, :, None] * vv[src]
        wd = np.where(live[:, None, None], w_mh[np.minimum(seg, n_seg - 1)], 0)
        ref_gv = np.zeros_like(vv)
        np.add.at(ref_gv, src, alpha[:, :, None] * wd)
        checks("spmm_multihead", name,
               fwd=_err(out, _np_segment_sum(msgs, seg, n_seg)),
               grad_v=_err(gv, ref_gv),
               grad_alpha=_err(ga, np.sum(vv[src] * wd, axis=-1)))


def parity_block_adjacency(checks, num_nodes: int, num_edges: int,
                           seed: int = 0) -> None:
    """ops.block_adjacency at the config-4 inner batch shape (count as int8,
    weighted as bf16 and f32; a sixth of the edge slots padding) against
    float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from bignn import ops

    rng = np.random.default_rng(seed)
    nblk = num_nodes // 128
    n_real = num_edges - num_edges // 6
    blk = np.repeat(np.arange(nblk), rng.multinomial(
        n_real, np.ones(nblk) / nblk))
    dst = blk * 128 + rng.integers(0, 128, n_real)
    src = blk * 128 + rng.integers(0, 128, n_real)
    order = np.lexsort((src, dst))
    src = np.concatenate([src[order], np.zeros(num_edges - n_real, int)])
    dst = np.concatenate([dst[order], np.full(num_edges - n_real, num_nodes)])
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    w = rng.random(num_edges).astype(np.float32)
    live = dst < num_nodes

    def ref(weight):
        out = np.zeros((nblk, 128, 128))
        np.add.at(out, (dst[live] // 128, dst[live] % 128, src[live] % 128),
                  1.0 if weight is None else weight[live])
        return out

    for weighted, dt, name in ((False, jnp.int8, "bfloat16"),
                               (True, jnp.bfloat16, "bfloat16"),
                               (True, jnp.float32, "float32")):
        got = jax.jit(lambda s, d, ww: ops.block_adjacency(
            s, d, ww, num_nodes, dt))(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(w) if weighted else None)
        checks("block_adjacency", name, out_dtype=jnp.dtype(dt).name,
               weighted=weighted,
               vs_numpy=_err(got, ref(w if weighted else None)))


def _np_dense_gat(sl, sr, v, cnt, slope=0.2):
    z = sl[:, None, :] + sr[None, :, :]
    e = np.where(z > 0, z, slope * z)
    valid = (cnt > 0)[:, :, None]
    m = np.max(np.where(valid, e, -np.inf), axis=1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    p = cnt[:, :, None] * np.exp(np.where(valid, e - m, -np.inf))
    alpha = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-30)
    return np.einsum("dsh,shf->dhf", alpha, v)


def parity_dense_gat(checks, n: int = DRUGBANK_N, heads: int = HEADS,
                     head_dim: int = HEAD_DIM, density: float = 0.13,
                     seed: int = 0) -> None:
    """Masked dense GAT attention (the config-2 outer layer) as GATConv runs
    it on this platform, forward and gradient, against float64 NumPy (and,
    for the flash kernel, against the plain XLA version)."""
    import jax
    import jax.numpy as jnp

    from bignn.models.convs import _dense_masked_softmax_agg
    from bignn.ops.dispatch import use_gpu_kernels

    rng = np.random.default_rng(seed)
    sl = rng.standard_normal((n, heads))
    sr = rng.standard_normal((n, heads))
    cnt = (rng.random((n, n)) < density).astype(np.float32)
    cnt[: n // 50] = 0.0  # rows with no edges
    cnt_j = jnp.asarray(cnt)
    wt = rng.standard_normal((n, heads, head_dim))
    eps = 1e-4

    def plain(a, b, c, dt):
        e = jax.nn.leaky_relu(a[:, None, :] + b[None, :, :], 0.2)
        return _dense_masked_softmax_agg(e, cnt_j, c, dt)

    impls = {"xla": plain}
    if use_gpu_kernels():
        from bignn.ops.pallas.flash_gat import flash_gat_attention

        impls["flash"] = lambda a, b, c, dt: flash_gat_attention(
            a, b, c, cnt_j).astype(dt)

    for dt in (jnp.float32, jnp.bfloat16):
        name = jnp.dtype(dt).name
        v = np.asarray(jnp.asarray(rng.standard_normal((n, heads, head_dim)),
                                   dt), np.float64)
        inputs = (jnp.asarray(sl, jnp.float32), jnp.asarray(sr, jnp.float32),
                  jnp.asarray(v, dt))
        ref = _np_dense_gat(sl, sr, v, cnt)
        # gradient reference: the dense XLA version at highest precision,
        # spot-checked against float64 central differences below
        with jax.default_matmul_precision("highest"):
            ref_g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(plain(
                a, b, c.astype(jnp.float32), jnp.float32) * wt),
                argnums=(0, 1, 2)))(*inputs)
        i, h = n // 2, 1
        slp, slm = sl.copy(), sl.copy()
        slp[i, h] += eps
        slm[i, h] -= eps
        fd = (np.sum(_np_dense_gat(slp, sr, v, cnt) * wt)
              - np.sum(_np_dense_gat(slm, sr, v, cnt) * wt)) / (2 * eps)
        for impl, fn in impls.items():
            out = jax.jit(lambda a, b, c: fn(a, b, c, dt))(*inputs)
            g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
                fn(a, b, c, dt).astype(jnp.float32) * wt),
                argnums=(0, 1, 2)))(*inputs)
            checks("dense_gat", name, impl=impl, fwd=_err(out, ref),
                   grad_score_l=_err(g[0], ref_g[0]),
                   grad_score_r=_err(g[1], ref_g[1]),
                   grad_v=_err(g[2], ref_g[2]),
                   grad_ref_vs_fd=abs(float(ref_g[0][i, h]) - fd)
                   / max(abs(fd), 1e-3))


def parity_full_model(checks, num_drugs: int = 200, avg_degree: float = 20.0,
                      dim: int = 128, heads: int = HEADS, feat_dim: int = 64,
                      seed: int = 0) -> None:
    """BiGNN.apply (config-2 widths: GIN inner, GAT outer) against
    oracle.bignn_forward_ref on a DrugBank-standin subset."""
    import jax
    import jax.numpy as jnp

    from bignn.data import load_dataset, prepare_device_data
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.oracle.numpy_ref import bignn_forward_ref

    ds = load_dataset("drugbank", num_drugs=num_drugs, avg_degree=avg_degree,
                      feat_dim=feat_dim, seed=seed)
    data = prepare_device_data(ds, max_buckets=2)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=feat_dim, dim=dim,
                                         heads=heads))
    params = model.init(jax.random.key(seed))
    pairs = np.random.default_rng(seed).integers(0, num_drugs, (256, 2))
    buckets = tuple(jax.tree.map(jnp.asarray, b)
                    for b in data.bucketing.batches)
    gidx = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
    outer = jax.tree.map(jnp.asarray, data.outer)
    got = jax.jit(model.apply)(params, buckets, gidx, outer,
                               jnp.asarray(pairs, jnp.int32))
    ref = bignn_forward_ref(model, params, data.bucketing.batches,
                            data.bucketing.graph_index, data.outer, pairs)
    checks("bignn_forward", "float32", vs_oracle=_err(got, ref))


def phase_parity(seg_nodes: int, seg_edges: int, adj_nodes: int,
                 adj_edges: int, gat_nodes: int = DRUGBANK_N,
                 model_drugs: int = 200) -> None:
    checks = Checks()
    parity_segment_ops(checks, seg_nodes, seg_edges)
    parity_block_adjacency(checks, adj_nodes, adj_edges)
    parity_dense_gat(checks, gat_nodes)
    parity_full_model(checks, model_drugs)
    if checks.failed:
        raise AssertionError(f"parity over tolerance: {checks.failed}")


# ---------------------------------------------------------------------------
# 3-6. memory, training, serving
# ---------------------------------------------------------------------------


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes") if hasattr(m, k)}


def config2_trainer(**dataset_kwargs):
    """Config 2 as run.py builds it (full mode)."""
    from bignn.config import get_config
    from bignn.data import load_dataset, prepare_device_data
    from bignn.models import BiGNN
    from bignn.train import Trainer

    cfg = get_config("config2")
    ds = load_dataset(cfg.dataset, **{**cfg.dataset_kwargs, **dataset_kwargs})
    model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
    data = prepare_device_data(ds, max_buckets=cfg.max_buckets)
    return ds, Trainer(model, data, cfg.train)


def phase_config2(trainer, steps: int = 20) -> dict:
    """``steps`` Trainer steps over epoch batches; also the step's memory
    analysis. Returns the trained params."""
    import jax
    import jax.numpy as jnp

    from bignn.data.sampler import EdgeMinibatchSampler

    cfg = trainer.config
    params, opt_state = trainer.init()
    sampler = EdgeMinibatchSampler(trainer.data.train_pairs, cfg.batch_size,
                                   cfg.seed)
    batches = []
    epoch = 0
    while len(batches) < steps:
        batches += list(sampler.epoch(epoch))
        epoch += 1
    key = jax.random.key(cfg.seed)
    pairs0, mask0 = map(jnp.asarray, batches[0])
    compiled = trainer._train_step.lower(
        params, opt_state, key, pairs0, mask0).compile()
    emit("memory", step="config2_full_graph_train_step", **_memory(compiled))
    losses, times = [], []
    for i, (pairs, mask) in enumerate(batches[:steps]):
        t0 = time.perf_counter()
        params, opt_state, loss = trainer._train_step(
            params, opt_state, jax.random.fold_in(key, i),
            jnp.asarray(pairs), jnp.asarray(mask))
        losses.append(float(loss))  # waits for the step
        times.append(time.perf_counter() - t0)
    k = max(steps // 4, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    ok = bool(np.all(np.isfinite(losses)) and last < first)
    emit("train_config2", steps=steps, loss_first=losses[0],
         loss_last=losses[-1], mean_first=first, mean_last=last,
         step_ms_median=float(np.median(times[1:] or times)) * 1e3, ok=ok)
    if not ok:
        raise AssertionError(f"config2 loss not finite and decreasing: "
                             f"{losses}")
    return params


def phase_config4(trainer) -> None:
    """One dispatch chunk of device-sampled config-4 training, and the
    chunk's memory analysis."""
    import jax

    params, opt_state = trainer.init()
    t0 = time.perf_counter()
    params, opt_state, losses, stats = trainer.train_chunk_device(
        params, opt_state, 0, 0)
    losses = np.asarray(losses)
    first_s = time.perf_counter() - t0
    fn = trainer._device_chunk_fn[max(1, trainer.dispatch_chunk)]
    compiled = fn.lower(params, opt_state, 0, 0, trainer.tables,
                        trainer._dev_consts).compile()
    emit("memory", step="config4_device_sampled_chunk",
         chunk_steps=int(losses.shape[0]), **_memory(compiled))
    t0 = time.perf_counter()
    _, _, losses2, _ = trainer.train_chunk_device(
        params, opt_state, 0, trainer.dispatch_chunk)
    losses2 = np.asarray(jax.block_until_ready(losses2))
    chunk_s = time.perf_counter() - t0
    ok = bool(np.all(np.isfinite(losses)) and np.all(np.isfinite(losses2)))
    emit("train_config4", chunk_steps=int(losses.shape[0]),
         losses=losses.tolist(), first_chunk_s_incl_compile=first_s,
         step_ms=chunk_s / losses2.shape[0] * 1e3,
         batches_sampled=int(stats["batches_sampled"]), ok=ok)
    if not ok:
        raise AssertionError(f"config4 loss not finite: {losses}")


def phase_serve(ds, trainer, params, n_pairs: int = 65536,
                n_queries: int = 4, k: int = 20) -> None:
    """Scorer on the trained config-2 model: top_k, and score_pairs against
    BiGNN.apply on the same pairs."""
    import jax
    import jax.numpy as jnp

    from bignn.serve import Scorer

    model = trainer.model
    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    drugs = rng.integers(0, ds.num_drugs, n_queries)
    ids, top = zip(*(scorer.top_k(int(d), k) for d in drugs))
    pairs = rng.integers(0, ds.num_drugs, (n_pairs, 2)).astype(np.int32)
    t0 = time.perf_counter()
    got = scorer.score_pairs(pairs)
    score_s = time.perf_counter() - t0
    ref = jax.jit(model.apply)(params, trainer.buckets, trainer.graph_index,
                               trainer.outer, jnp.asarray(pairs))
    err = _err(got, ref)
    ok = bool(err <= TOL["float32"] and all(len(i) == k for i in ids)
              and np.all(np.isfinite(np.concatenate(top))))
    emit("serve", build_s=build_s, top_k_queries=len(drugs), k=k,
         score_pairs=n_pairs, score_pairs_s=score_s, tol=TOL["float32"],
         vs_apply=err, ok=ok)
    if not ok:
        raise AssertionError(f"serve parity {err} over {TOL['float32']}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_p2_four(num_drugs: int | None = None, steps: int = 3,
                  batch: int = 2048, **dataset_kwargs) -> None:
    """Config-5 p2 steps on a 1x4 (dp x graph) mesh against the
    single-device Trainer: the loss of every step (same key and batch), and
    the gradient at the initial parameters, read off one SGD(1) step so
    that it goes through the halo all-to-all's transpose."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bignn.config import get_config
    from bignn.data import load_dataset, prepare_device_data
    from bignn.models import BiGNN
    from bignn.parallel import (build_outer_partition, build_sharded_inner,
                                device_put_plan, make_mesh,
                                make_p2_train_step)
    from bignn.train import Trainer
    from bignn.train.trainer import make_optimizer

    cfg = get_config("config5")
    if num_drugs is not None:
        dataset_kwargs["num_drugs"] = num_drugs
    ds = load_dataset(cfg.dataset, **dataset_kwargs)
    model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
    optimizer = make_optimizer(cfg.train)
    params = model.init(jax.random.key(0))
    opt_state = optimizer.init(params)
    mesh = make_mesh(dp=1, graph=4, devices=jax.devices()[:4])
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs, 4)
    inner = build_sharded_inner(ds.molecules, plan)
    placed = device_put_plan(mesh, plan, inner)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              cfg.train.neg_ratio)
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.integers(0, ds.num_drugs, (batch, 2)), jnp.int32)
    mask = jnp.ones(batch, jnp.float32)
    key = jax.random.key(1)
    ref = Trainer(model, prepare_device_data(ds, max_buckets=1), cfg.train)
    losses, ref_losses, times = [], [], []
    # replicated on the mesh from the start, like the step's outputs, so
    # only the first step compiles
    rep = NamedSharding(mesh, P())
    p, o = jax.device_put((params, opt_state), rep)
    rp, ro = params, opt_state
    with mesh:
        for i in range(steps):
            t0 = time.perf_counter()
            p, o, loss = step(p, o, jax.random.fold_in(key, i), pos, mask,
                              *placed)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            rp, ro, loss = ref._train_step(rp, ro, jax.random.fold_in(key, i),
                                           pos, mask)
            ref_losses.append(float(loss))

    # gradient: the update of one SGD(1) step is -grad; both sides at
    # highest matmul precision, so the tolerance measures the p2 path
    key0 = jax.random.fold_in(key, 0)
    sgd = optax.sgd(1.0)
    with jax.default_matmul_precision("highest"):
        sgd_step = make_p2_train_step(model, sgd, mesh, ds.num_drugs,
                                      cfg.train.neg_ratio)
        with mesh:
            p_sgd, _, _ = sgd_step(
                *jax.device_put((params, sgd.init(params)), rep), key0, pos,
                mask, *placed)
        g_ref = jax.jit(jax.grad(ref._loss_fn))(params, key0, pos, mask)
    grad_err = max(
        _err(np.asarray(a, np.float64) - np.asarray(b, np.float64), g)
        for a, b, g in zip(jax.tree.leaves(params), jax.tree.leaves(p_sgd),
                           jax.tree.leaves(g_ref)))
    loss_err = np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)
    first_err, later_err = float(loss_err[0]), float(loss_err.max())
    ok = bool(np.all(np.isfinite(losses))
              and first_err <= P2_LOSS_TOL["first"]
              and later_err <= P2_LOSS_TOL["later"]
              and grad_err <= TOL["float32"])
    emit("p2_four_cards", dp=1, graph=4, num_drugs=ds.num_drugs,
         steps=steps, losses=losses, single_card_losses=ref_losses,
         first_loss_rel_err=first_err, loss_rel_err=later_err,
         loss_tol=P2_LOSS_TOL, grad_vs_single_card=grad_err,
         grad_tol=TOL["float32"], first_step_s_incl_compile=times[0],
         step_ms=float(np.median(times[1:] or times)) * 1e3, ok=ok)
    if not ok:
        raise AssertionError(
            f"p2 on four cards differs from one card: losses {losses} vs "
            f"{ref_losses}, gradient error {grad_err}")


def phase_dp_four() -> None:
    """dp=4 minibatch training (host- and device-sampled) against the union
    of its per-shard batches on one device."""
    import jax

    from __graft_entry__ import check_dp_minibatch

    losses = check_dp_minibatch(jax.devices()[:4])
    emit("dp_minibatch_four_cards", dp=4, **losses, ok=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card p2 and dp phases")
    args = p.parse_args(argv)
    info = phase_device()
    if args.four_cards:
        if info["device_count"] < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, have "
                             f"{info['device_count']}")
        phase_p2_four()
        phase_dp_four()
    else:
        import bench

        # built first: the parity phase takes its shapes from config 4
        tr4 = bench.config4_trainer()
        nc, ec = tr4.dsampler.NC, tr4.dsampler.EC
        emit("config4_shapes", inner_node_cap=nc, inner_edge_cap=ec,
             outer_node_cap=tr4.dsampler.D,
             outer_edge_cap=tr4.dsampler.OE)
        phase_parity(seg_nodes=tr4.dsampler.D, seg_edges=tr4.dsampler.OE,
                     adj_nodes=nc, adj_edges=ec)
        ds2, tr2 = config2_trainer()
        params = phase_config2(tr2)
        phase_config4(tr4)
        phase_serve(ds2, tr2, params)
    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
