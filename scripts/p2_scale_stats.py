"""Config #5 at config-#4 scale: characterize the edge-partitioned halo
path over the 100K-drug / 10M-outer-edge graph.

Three legs:

  1. PLAN BUILD (default; host-only, any machine):
         python scripts/p2_scale_stats.py --shards 8
     Builds build_outer_partition + build_sharded_inner at full scale and
     prints per-shard edge/node balance, boundary-set sizes, send_idx
     width S, ext-array + plan + molecule-union memory, and build times.

  2. FAKE-DEVICE STEPS (correctness + memory feasibility; CPU, numbers
     NOT representative of any device rate):
         python scripts/p2_scale_stats.py --fake-devices 8 --steps 2
     Runs real p2 train steps end-to-end over an 8-fake-device
     ('graph'=8) CPU mesh at full scale.

  3. GRAPH=1 OVERHEAD (on the GPU): bound the partition-machinery
     overhead by running the p2 step at graph=1 against the plain
     full-graph Trainer step on the same dataset:
         python scripts/p2_scale_stats.py --graph1-overhead --steps 4
"""
from __future__ import annotations

import argparse
import json
import os as _os
import sys as _sys
import time

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# --fake-devices must configure XLA BEFORE jax touches devices, and runs
# on the CPU backend whatever accelerator the machine has
_pre = argparse.ArgumentParser(add_help=False)
_pre.add_argument("--fake-devices", type=int, default=0)
_pre_args, _ = _pre.parse_known_args()
if _pre_args.fake_devices:
    _os.environ["XLA_FLAGS"] = (
        _os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_pre_args.fake_devices}")
    import jax

    jax.config.update("jax_platforms", "cpu")


def load_ds():
    from bignn.data import make_synthetic_ddi
    from bignn.data.datasets import load_npz_cache, save_npz_cache

    cache = _os.path.join(_os.path.dirname(__file__), "..", ".cache",
                          "config4_100000.npz")
    if _os.path.exists(cache):
        return load_npz_cache(cache, "config4")
    ds = make_synthetic_ddi(num_drugs=100_000, feat_dim=32,
                            avg_degree=200.0, min_atoms=8, max_atoms=40,
                            latent_dim=8, seed=0, name="config4")
    _os.makedirs(_os.path.dirname(cache), exist_ok=True)
    tmp = cache.replace(".npz", ".tmp.npz")
    save_npz_cache(ds, tmp)
    _os.replace(tmp, cache)
    return ds


def plan_leg(ds, shards: int, dim: int = 128):
    import numpy as np

    from bignn.parallel import build_outer_partition, build_sharded_inner

    train = ds.split_edges("train")
    t0 = time.perf_counter()
    plan = build_outer_partition(train[:, 0], train[:, 1],
                                 ds.num_drugs, shards)
    t_plan = time.perf_counter() - t0
    B, S, G = plan.node_block, plan.halo_size, plan.n_shards
    real_e = (plan.edge_dst < B).sum(axis=1)
    # real boundary widths per ordered pair (h -> g), recovered from the
    # remapped edge lists (ext id B + h*S + k <-> shard h, slot k)
    widths = np.zeros((G, G), np.int64)
    recv_tot = np.zeros(G, np.int64)
    for g in range(G):
        eg = plan.edge_src[g][plan.edge_dst[g] < B]
        ext = np.unique(eg[eg >= B]) - B
        recv_tot[g] = len(ext)
        h, k = ext // S, ext % S
        np.add.at(widths, (h, g), 1)
        del k
    send_tot = widths.sum(axis=1)
    plan_bytes = sum(
        a.nbytes for a in (plan.send_idx, plan.edge_src, plan.edge_dst,
                           plan.edge_weight, plan.local_src, plan.local_dst,
                           plan.local_weight, plan.remote_src,
                           plan.remote_dst, plan.remote_weight)
        if a is not None)
    out = {
        "num_drugs": ds.num_drugs,
        "outer_edges_undirected": int(len(train)),
        "shards": G,
        "node_block_B": int(B),
        "halo_slots_S": int(S),
        "edge_cap": int(plan.edge_cap),
        "edges_per_shard": real_e.tolist(),
        "edge_balance_max_over_mean": round(
            float(real_e.max() / real_e.mean()), 4),
        "send_width_max": int(widths.max()),
        "send_width_mean": round(float(widths[widths > 0].mean()), 1)
        if (widths > 0).any() else 0,
        "halo_pad_waste": round(float(1 - widths.max() / S), 4),
        "sent_rows_per_shard": send_tot.tolist(),
        "recv_rows_per_shard": recv_tot.tolist(),
        "ext_rows_per_shard": int(plan.ext_size),
        "ext_array_mb_bf16_per_shard": round(
            plan.ext_size * dim * 2 / 1e6, 1),
        "replication_factor": plan.stats()["replication_factor"],
        "plan_host_mb_total": round(plan_bytes / 1e6, 1),
        "plan_device_mb_per_shard": round(plan_bytes / G / 1e6, 1),
        "plan_build_s": round(t_plan, 2),
    }
    t0 = time.perf_counter()
    inner = build_sharded_inner(ds.molecules, plan)
    t_inner = time.perf_counter() - t0
    ib = sum(np.asarray(a).nbytes for a in (
        inner.node_feat, inner.edge_src, inner.edge_dst, inner.edge_weight,
        inner.graph_ids, inner.node_mask, inner.graph_n_nodes,
        inner.edge_src_perm, inner.edge_src_sorted))
    out.update({
        "inner_union_node_cap": int(inner.node_cap),
        "inner_union_edge_cap": int(inner.edge_cap),
        "inner_union_mb_per_shard": round(ib / plan.n_shards / 1e6, 1),
        "inner_build_s": round(t_inner, 2),
    })
    return plan, inner, out


def fake_device_leg(ds, shards: int, steps: int):
    """Real p2 train steps over fake CPU devices at full scale."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bignn.config import get_config
    from bignn.models import BiGNN
    from bignn.data.sampler import EdgeMinibatchSampler
    from bignn.parallel import (
        device_put_plan, make_mesh, make_p2_train_step)
    from bignn.parallel.partition import (
        build_outer_partition, build_sharded_inner)
    from bignn.train.trainer import make_optimizer

    cfg = get_config("config5-large", graph_shards=shards)
    assert len(jax.devices()) >= shards, jax.devices()
    mesh = make_mesh(dp=1, graph=shards,
                     devices=jax.devices()[:shards])
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1],
                                 ds.num_drugs, shards)
    inner = build_sharded_inner(ds.molecules, plan)
    model = BiGNN(cfg.model)
    optimizer = make_optimizer(cfg.train)
    params = model.init(jax.random.key(cfg.train.seed))
    opt_state = optimizer.init(params)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              cfg.train.neg_ratio)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
    sampler = EdgeMinibatchSampler(train.astype(np.int32),
                                   cfg.train.batch_size, cfg.train.seed)
    key = jax.random.key(cfg.train.seed + 1)
    losses, times = [], []
    with mesh:
        it = iter(sampler.epoch(0))
        for i in range(steps):
            pairs, mask = next(it)
            t0 = time.perf_counter()
            params, opt_state, loss = step(
                params, opt_state, jax.random.fold_in(key, i),
                jnp.asarray(pairs), jnp.asarray(mask),
                inner_d, esrc, edst, ew, sidx)
            losses.append(float(loss))
            times.append(round(time.perf_counter() - t0, 1))
    return {
        "fake_devices": shards,
        "steps": steps,
        "losses": [round(l, 4) for l in losses],
        "step_wall_s_NOT_REPRESENTATIVE": times,
        "note": "CPU fake-device leg: proves compile+memory+numerics at "
                "full scale; wall times are meaningless for device rates",
    }


def load_scaled_ds(num_drugs: int):
    """config-#4-statistics synthetic at a reduced drug count (same
    avg degree / molecule sizes), cached like the main dataset."""
    from bignn.data import make_synthetic_ddi
    from bignn.data.datasets import load_npz_cache, save_npz_cache

    cache = _os.path.join(_os.path.dirname(__file__), "..", ".cache",
                          f"config4_{num_drugs}.npz")
    if _os.path.exists(cache):
        return load_npz_cache(cache, "config4s")
    ds = make_synthetic_ddi(num_drugs=num_drugs, feat_dim=32,
                            avg_degree=200.0, min_atoms=8, max_atoms=40,
                            latent_dim=8, seed=0, name="config4s")
    _os.makedirs(_os.path.dirname(cache), exist_ok=True)
    tmp = cache.replace(".npz", ".tmp.npz")
    save_npz_cache(ds, tmp)
    _os.replace(tmp, cache)
    return ds


def graph1_overhead_leg(ds, steps: int, remat: bool = False,
                        skip_plain: bool = False):
    """GPU: p2 step at graph=1 vs the plain full-graph Trainer step.

    NOTE: whether the full 100K-drug full-graph step fits one card is not
    measured on the H100; run this leg with --num-drugs scaled so one card
    fits if it does not. The machinery
    whose overhead is being bounded (ext indirection, remapped edge
    lists, degenerate a2a) is identical at any scale."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bignn.config import get_config
    from bignn.models import BiGNN
    from bignn.data.sampler import EdgeMinibatchSampler
    from bignn.data.schema import prepare_device_data
    from bignn.parallel import (
        device_put_plan, make_mesh, make_p2_train_step)
    from bignn.parallel.partition import (
        build_outer_partition, build_sharded_inner)
    from bignn.train import Trainer
    from bignn.train.trainer import make_optimizer

    cfg = get_config("config5-large", graph_shards=1)
    model = BiGNN(cfg.model)
    train = ds.split_edges("train")
    out = {}

    def timed(fn, warm_args, n):
        ts = []
        for rep in range(n):
            t0 = time.perf_counter()
            r = fn(rep)
            jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape")
                         else x, r)
            ts.append(time.perf_counter() - t0)
        return ts

    # -- p2 at graph=1 ----------------------------------------------------
    mesh = make_mesh(dp=1, graph=1, devices=jax.devices()[:1])
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs, 1)
    inner = build_sharded_inner(ds.molecules, plan)
    optimizer = make_optimizer(cfg.train)
    params = model.init(jax.random.key(cfg.train.seed))
    opt_state = optimizer.init(params)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              cfg.train.neg_ratio, remat=remat)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
    sampler = EdgeMinibatchSampler(train.astype(np.int32),
                                   cfg.train.batch_size, cfg.train.seed)
    key = jax.random.key(cfg.train.seed + 1)
    batches = []
    it = iter(sampler.epoch(0))
    for _ in range(steps):
        p, m = next(it)
        batches.append((jnp.asarray(p), jnp.asarray(m)))
    with mesh:
        def p2_step(i):
            nonlocal params, opt_state
            p, m = batches[i % len(batches)]
            params, opt_state, loss = step(
                params, opt_state, jax.random.fold_in(key, i), p, m,
                inner_d, esrc, edst, ew, sidx)
            return loss

        float(p2_step(0))  # compile
        ts = timed(lambda i: p2_step(i), None, steps)
    out["p2_graph1_step_ms"] = [round(t * 1e3, 1) for t in ts]
    out["p2_graph1_best_ms"] = round(min(ts) * 1e3, 1)
    if skip_plain:
        return out

    # -- plain full-graph Trainer ----------------------------------------
    t0 = time.perf_counter()
    data = prepare_device_data(ds, max_buckets=1)
    out["prepare_device_data_s"] = round(time.perf_counter() - t0, 1)
    tr = Trainer(model, data, cfg.train)
    tp, to = tr.init()
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.integers(0, ds.num_drugs,
                                   (steps, cfg.train.batch_size, 2)),
                      jnp.int32)
    mask = jnp.ones(cfg.train.batch_size, jnp.float32)
    kk = jax.random.key(0)

    def plain_step(i):
        nonlocal tp, to
        tp, to, loss = tr._train_step(
            tp, to, jax.random.fold_in(kk, i), pos[i % steps], mask)
        return loss

    float(plain_step(0))  # compile
    ts2 = timed(lambda i: plain_step(i), None, steps)
    out["plain_trainer_step_ms"] = [round(t * 1e3, 1) for t in ts2]
    out["plain_trainer_best_ms"] = round(min(ts2) * 1e3, 1)
    out["p2_over_plain"] = round(min(ts) / min(ts2), 3)
    return out


def main():
    p = argparse.ArgumentParser(parents=[_pre])
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--skip-inner", action="store_true")
    p.add_argument("--graph1-overhead", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="graph1-overhead leg: remat the p2 inner encode")
    p.add_argument("--skip-plain", action="store_true",
                   help="graph1-overhead leg: only run the p2 side")
    p.add_argument("--num-drugs", type=int, default=0,
                   help="scale the dataset down (graph1-overhead leg: the "
                        "full 100K full-graph step OOMs one chip)")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    ds = load_scaled_ds(args.num_drugs) if args.num_drugs else load_ds()
    lines = []
    if args.graph1_overhead:
        rec = {"leg": "graph1_overhead", "remat": args.remat,
               "num_drugs": ds.num_drugs, **graph1_overhead_leg(
                   ds, args.steps, remat=args.remat,
                   skip_plain=args.skip_plain)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    elif args.fake_devices:
        rec = {"leg": "fake_device_steps", **fake_device_leg(
            ds, args.shards, args.steps)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    else:
        _, _, rec = plan_leg(ds, args.shards)
        rec = {"leg": "plan_build", **rec}
        lines.append(rec)
        print(json.dumps(rec, indent=1), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")


if __name__ == "__main__":
    main()
