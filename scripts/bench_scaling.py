"""Scaling-efficiency harness (BASELINE.json:5: >= 80% edges/s efficiency at
1 chip / 1 host / N hosts).

Measures the P2 distributed train step's aggregate edges/s on meshes of
increasing 'graph' width over the attached devices and reports efficiency
relative to the single-device run, over the GPUs of one host;
`--fake-cpu N` exercises the harness logic on N fake CPU devices (numbers
are NOT hardware-representative there).

Usage:
  python scripts/bench_scaling.py [--fake-cpu 8] [--steps 10]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fake-cpu", type=int, default=0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--num-drugs", type=int, default=1704)
    p.add_argument("--avg-degree", type=float, default=60.0)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--dp-device-sample", action="store_true",
                   help="scale the P1 axis instead: dp-wide meshes with "
                        "per-shard DEVICE-RESIDENT sampling (weak scaling; "
                        "each shard draws its own batch inside shard_map)")
    args = p.parse_args()

    if args.fake_cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.fake_cpu}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np
    import optax

    from bignn.data import load_dataset
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.parallel import (
        build_outer_partition,
        build_sharded_inner,
        device_put_plan,
        make_mesh,
        make_p2_train_step,
    )

    n_dev = len(jax.devices())
    ds = load_dataset("drugbank", num_drugs=args.num_drugs,
                      avg_degree=args.avg_degree)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=64, heads=4))
    optimizer = optax.adam(1e-3)
    params = model.init(jax.random.key(0))
    train_edges = ds.split_edges("train")
    rng = np.random.default_rng(0)

    widths = [g for g in (1, 2, 4, 8, 16) if g <= n_dev]

    if args.dp_device_sample:
        # P1 weak scaling with zero-host sampling: each dp shard draws its
        # own batch inside shard_map (train_chunk_device); per-chip rate
        # should stay flat as dp grows (only the gradient all-reduce rides
        # the interconnect).
        from bignn.train import MinibatchTrainer, TrainConfig

        base_rate = None
        results = []
        for dpw in widths:
            mesh = (make_mesh(dp=dpw, graph=1, devices=jax.devices()[:dpw])
                    if dpw > 1 else None)
            tr = MinibatchTrainer(
                model, ds, TrainConfig(lr=1e-3, epochs=1,
                                       batch_size=args.batch),
                fanouts=(10, 5), max_drugs=8192, mesh=mesh,
                device_sample=True, dispatch_chunk=4)
            s = tr.sampler
            e_per_batch = int(
                np.diff(s._tbl_eptr).mean() * s.drug_budget
                * len(model.config.inner_layers)
                + s.outer_edge_cap * len(model.config.outer_layers))
            pp, oo = tr.init()
            pp, oo, ls, _ = tr.train_chunk_device(pp, oo, 9, 0)  # compile
            _ = float(np.asarray(ls)[-1])
            t0 = time.perf_counter()
            step = 0
            while step < args.steps:
                pp, oo, ls, _ = tr.train_chunk_device(pp, oo, 0, step)
                step += 4
            _ = float(np.asarray(ls)[-1])
            dt = (time.perf_counter() - t0) / step
            rate = e_per_batch * dpw / dt
            per_chip = rate / dpw
            if base_rate is None:
                base_rate = per_chip
            results.append({
                "dp": dpw,
                "edges_per_s": round(rate, 1),
                "edges_per_s_per_chip": round(per_chip, 1),
                "efficiency_vs_1": round(per_chip / base_rate, 3),
            })
            print(json.dumps(results[-1]), flush=True)
        print(json.dumps({"summary": results}))
        return
    base_rate = None
    results = []
    for g in widths:
        plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                     ds.num_drugs, g)
        inner = build_sharded_inner(ds.molecules, plan,
                                    split_boundary=args.overlap)
        mesh = make_mesh(dp=1, graph=g, devices=jax.devices()[:g])
        step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                                  overlap=args.overlap)
        opt_state = optimizer.init(params)
        inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)
        pos = jnp.asarray(rng.integers(0, ds.num_drugs, (args.batch, 2)), jnp.int32)
        mask = jnp.ones(args.batch, jnp.float32)
        key = jax.random.key(1)

        inner_edges = inner[0].edge_cap + inner[1].edge_cap if args.overlap \
            else inner.edge_cap
        edges_per_step = (
            g * inner_edges * len(model.config.inner_layers)
            + g * plan.edge_cap * len(model.config.outer_layers)
        )

        with mesh:
            p_, o_, loss = step(params, opt_state, key, pos, mask,
                                inner_d, esrc, edst, ew, sidx)
            loss.block_until_ready()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                key, sub = jax.random.split(key)
                p_, o_, loss = step(p_, o_, sub, pos, mask,
                                    inner_d, esrc, edst, ew, sidx)
            _ = float(loss)
        dt = (time.perf_counter() - t0) / args.steps
        rate = edges_per_step / dt
        per_chip = rate / g
        if base_rate is None:
            base_rate = per_chip
        results.append({
            "graph_shards": g,
            "edges_per_s": round(rate, 1),
            "edges_per_s_per_chip": round(per_chip, 1),
            "efficiency_vs_1": round(per_chip / base_rate, 3),
        })
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"summary": results}))


if __name__ == "__main__":
    main()
