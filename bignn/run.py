"""Experiment runner CLI (SURVEY.md §2.1 R1 equivalent).

  python -m bignn.run --config config1
  python -m bignn.run --config config2 --epochs 5 --run-dir runs/db
  python -m bignn.run --config config5 --graph-shards 4   # needs devices

Replaces the reference's main.py + global FLAGS with typed configs
(bignn/config.py) and explicit wiring.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config1")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="epochs between checkpoints (0 = off)")
    p.add_argument("--graph-shards", type=int, default=None)
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel shards (SURVEY.md P1): shards pair "
                        "minibatches over a dp-only mesh in full/minibatch "
                        "modes (p2 mode derives dp from devices/graph-shards)")
    p.add_argument("--overlap", action="store_true",
                   help="p2 mode: overlap halo exchange with inner aggregation")
    p.add_argument("--device-sample", dest="device_sample", default=None,
                   action="store_true",
                   help="minibatch mode: sample on device (epoch = one "
                        "device scan; DESIGN.md §3). Default from config.")
    p.add_argument("--no-device-sample", dest="device_sample",
                   action="store_false")
    p.add_argument("--remat", action="store_true",
                   help="p2 mode: rematerialize the inner encode AND the "
                        "outer attention temps in the backward "
                        "(jax.checkpoint) — an extra inner forward + "
                        "attention recompute per step buys the dominant "
                        "activation memory, for larger per-shard graphs")
    p.add_argument("--exact-eval", action="store_true",
                   help="minibatch mode: after training, ALSO report "
                        "estimator-free final val/test metrics via full "
                        "propagation (evaluate(exact=True)) — the sampled "
                        "estimator under-reports at config-#4 scale "
                        "(DESIGN.md §5)")
    p.add_argument("--profile", default=None, help="jax profiler trace dir")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator host:port "
                        "(or env JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count "
                        "(or env JAX_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's index "
                        "(or env JAX_PROCESS_ID)")
    args = p.parse_args(argv)

    import jax

    from bignn.parallel import init_distributed
    from bignn.utils import enable_compile_cache

    # must run before anything touches jax.devices(); no-op single-process
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    enable_compile_cache()
    from bignn.config import get_config
    from bignn.data import load_dataset, prepare_device_data
    from bignn.models import BiGNN
    from bignn.train import MinibatchTrainer, Trainer
    from bignn.train.checkpoint import CheckpointManager
    from bignn.utils import MetricLogger, profile_trace

    cfg = get_config(args.config)
    train_over = {
        k: v
        for k, v in dict(
            epochs=args.epochs, batch_size=args.batch_size,
            lr=args.lr, seed=args.seed,
        ).items()
        if v is not None
    }
    if train_over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_over)
        )
    if args.graph_shards is not None:
        cfg = dataclasses.replace(cfg, graph_shards=args.graph_shards)

    logger = MetricLogger(args.run_dir)
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    logger.log({"event": "dataset", **{k: str(v) for k, v in ds.stats().items()}})
    model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))

    ckpt = CheckpointManager(f"{args.run_dir}/ckpt") if (
        args.run_dir and args.checkpoint_every
    ) else None

    dp_mesh = None
    if args.dp and cfg.mode in ("minibatch", "full"):
        from bignn.parallel import make_mesh

        if args.dp > len(jax.devices()):
            raise SystemExit(
                f"--dp {args.dp} exceeds {len(jax.devices())} devices")
        dp_mesh = make_mesh(dp=args.dp, graph=1,
                            devices=jax.devices()[: args.dp])
        logger.log({"event": "mesh", "dp": args.dp, "graph": 1})

    fit_kw = dict(log_fn=logger)
    if ckpt is not None:
        fit_kw.update(ckpt=ckpt, checkpoint_every=args.checkpoint_every)
    with profile_trace(args.profile):
        if cfg.mode == "minibatch":
            dev_sample = (cfg.device_sample if args.device_sample is None
                          else args.device_sample)
            trainer = MinibatchTrainer(model, ds, cfg.train, fanouts=cfg.fanouts,
                                       max_drugs=cfg.max_drugs,
                                       dispatch_chunk=cfg.dispatch_chunk,
                                       device_sample=dev_sample,
                                       mesh=dp_mesh)
            params, result = trainer.fit(**fit_kw)
            if args.exact_eval:
                for split in ("val", "test"):
                    ex = trainer.evaluate(params, split, exact=True)
                    result.update({f"exact_{k}": v for k, v in ex.items()})
                logger.log({"event": "exact_eval",
                            **{k: v for k, v in result.items()
                               if k.startswith("exact_")}})
        elif cfg.mode == "p2":
            if args.exact_eval:
                logger.log({"event": "note", "msg":
                            "p2/full modes evaluate by full propagation "
                            "already — finals are exact; --exact-eval is "
                            "a no-op outside minibatch mode"})
            params, result = _run_p2(
                model, ds, cfg, logger, overlap=args.overlap,
                remat_inner=args.remat,
                ckpt=ckpt, checkpoint_every=args.checkpoint_every or 1)
        else:
            data = prepare_device_data(ds, max_buckets=cfg.max_buckets)
            trainer = Trainer(model, data, cfg.train, mesh=dp_mesh)
            params, result = trainer.fit(**fit_kw)

    if ckpt is not None:
        ckpt.close()

    summary = {k: v for k, v in result.items() if k != "history"}
    logger.log({"event": "done", **summary})
    if args.run_dir:
        with open(f"{args.run_dir}/result.json", "w") as f:
            json.dump(summary, f, indent=2)
    return result


def _run_p2(model, ds, cfg, logger, overlap: bool = False, ckpt=None,
            checkpoint_every: int = 1, remat_inner: bool = False):
    """Distributed (edge-partitioned) training loop — config #5.

    First-class trainer semantics matching Trainer.fit / MinibatchTrainer.fit:
    best-val-AUC params retained and used for the final
    test eval, periodic checkpointing via ``ckpt``, and EXACT resume — the
    epoch shuffle and every negative-sampling key are pure functions of
    (seed, epoch, step), so a killed-and-resumed run reproduces the original
    trajectory bit-for-bit (tests/test_p2_resume.py). Returns
    (best_params, result)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from jax.sharding import PartitionSpec as P

    from bignn.data.sampler import EdgeMinibatchSampler
    from bignn.parallel import (
        build_outer_partition,
        build_sharded_inner,
        device_put_plan,
        global_put,
        make_hybrid_mesh,
        make_mesh,
        make_p2_train_step,
    )
    from bignn.parallel.step import make_p2_score_fn
    from bignn.train.metrics import average_precision_jnp, roc_auc_jnp

    n_dev = len(jax.devices())
    multihost = jax.process_count() > 1
    if multihost:
        # host-major mesh: per-host graph-shard groups, so the halo a2a
        # stays within a host where it can (parallel/mesh.py, SURVEY.md §5)
        graph = min(cfg.graph_shards, n_dev)
        mesh = make_hybrid_mesh(graph=graph)
        dp = int(mesh.shape["dp"])
    else:
        graph = min(cfg.graph_shards, n_dev)
        dp = n_dev // graph
        mesh = make_mesh(dp=dp, graph=graph, devices=jax.devices()[: dp * graph])
    logger.log({"event": "mesh", "dp": dp, "graph": graph,
                "processes": jax.process_count()})
    # every per-step host array must be a GLOBAL array on a multi-host mesh;
    # identical on all processes (shared seed), so replicated placement
    rep = (lambda x: global_put(mesh, P(), x)) if multihost else jnp.asarray

    train_edges = ds.split_edges("train")
    plan = build_outer_partition(
        train_edges[:, 0], train_edges[:, 1], ds.num_drugs, graph
    )
    logger.log({"event": "partition", **{k: str(v) for k, v in plan.stats().items()}})
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    from bignn.train.trainer import make_optimizer

    optimizer = make_optimizer(cfg.train)
    params = model.init(jax.random.key(cfg.train.seed))
    opt_state = optimizer.init(params)
    if multihost:
        params = jax.tree.map(rep, params)
        opt_state = jax.tree.map(rep, opt_state)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              cfg.train.neg_ratio, overlap=overlap,
                              remat=remat_inner)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)

    sampler = EdgeMinibatchSampler(train_edges.astype(np.int32),
                                   cfg.train.batch_size, cfg.train.seed)
    base_key = jax.random.key(cfg.train.seed + 1)
    if multihost:
        # globalize the (replicated, identical-per-process) PRNG key once;
        # fold_ins of a global key stay global
        base_key = jax.random.wrap_key_data(
            rep(np.asarray(jax.random.key_data(base_key))))
    score_fn = make_p2_score_fn(model, mesh, overlap=overlap)
    dp_pad = dp  # eval pair count must divide the dp axis

    # Metrics stay on device: scores are never funneled to host; the exact
    # tie-aware device AUC/AP (train/metrics.py) run under jit and only the
    # two scalars are transferred (DESIGN.md §8).
    @jax.jit
    def _device_metrics(scores, labels, mask):
        return (roc_auc_jnp(labels, scores, mask),
                average_precision_jnp(labels, scores, mask))

    def evaluate(eval_params, split):
        from bignn.data.sampler import sample_negative_pairs

        pos = jnp.asarray(ds.split_edges(split).astype(np.int32))
        neg = sample_negative_pairs(jax.random.key(1234), pos, ds.num_drugs, 1)
        n_pos, n_neg = pos.shape[0], neg.shape[0]
        pad = (-(n_pos + n_neg)) % dp_pad
        pairs_p = rep(np.concatenate(
            [np.asarray(pos), np.asarray(neg),
             np.zeros((pad, 2), np.int32)]).astype(np.int32))
        labels = rep(np.concatenate(
            [np.ones(n_pos, np.float32), np.zeros(n_neg + pad, np.float32)]))
        mask = rep(np.concatenate(
            [np.ones(n_pos + n_neg, np.float32), np.zeros(pad, np.float32)]))
        scores = score_fn(eval_params, pairs_p, inner_d, esrc, edst, ew, sidx)
        auc, ap = _device_metrics(scores, labels, mask)
        return {f"{split}_auc": float(auc), f"{split}_ap": float(ap)}

    import time as _time

    from bignn.train.trainer import _fit_state, _unpack_fit_state

    history = []
    best = {"val_auc": -1.0, "params": params, "epoch": -1}
    start_epoch = 0
    if ckpt is not None:
        restored = ckpt.restore_state(_fit_state(params, opt_state, best))
        if restored is not None:
            params, opt_state, best, start_epoch = _unpack_fit_state(restored)
            # restored leaves live on one device; re-place replicated on the
            # mesh (global_put on multihost, NamedSharding single-host)
            if multihost:
                replace = rep
            else:
                from jax.sharding import NamedSharding

                sh = NamedSharding(mesh, P())
                replace = lambda x: jax.device_put(x, sh)  # noqa: E731
            params = jax.tree.map(
                replace, jax.tree.map(np.asarray, params))
            opt_state = jax.tree.map(
                replace, jax.tree.map(np.asarray, opt_state))
            # best params feed the mesh-wide scorer for the final test
            # eval — they need the same re-placement
            best["params"] = jax.tree.map(
                replace, jax.tree.map(np.asarray, best["params"]))
    with mesh:
        for epoch in range(start_epoch, cfg.train.epochs):
            t0 = _time.perf_counter()
            losses = []
            # (seed, epoch, step)-derived shuffle + negative-sampling keys:
            # the trajectory is a pure function of the epoch/step indices,
            # so resume-from-checkpoint is exact
            ekey = jax.random.fold_in(base_key, epoch)
            for i, (pairs, mask) in enumerate(sampler.epoch(epoch)):
                params, opt_state, loss = step(
                    params, opt_state, jax.random.fold_in(ekey, i),
                    rep(pairs), rep(mask),
                    inner_d, esrc, edst, ew, sidx,
                )
                losses.append(loss)
            rec = {"epoch": epoch, "loss": float(jnp.mean(jnp.stack(losses))),
                   "epoch_time_s": _time.perf_counter() - t0}
            if (epoch + 1) % cfg.train.eval_every == 0 or epoch == cfg.train.epochs - 1:
                rec.update(evaluate(params, "val"))
                if rec["val_auc"] > best["val_auc"]:
                    best = {"val_auc": rec["val_auc"], "params": params,
                            "epoch": epoch}
            history.append(rec)
            logger.log(rec)
            if ckpt is not None and (epoch + 1) % checkpoint_every == 0:
                ckpt.save_state(
                    epoch, _fit_state(params, opt_state, best, epoch))
        # final test metrics on the BEST params (same semantics as
        # Trainer.fit / MinibatchTrainer.fit)
        final = evaluate(best["params"], "test")
    return best["params"], {
        "history": history,
        # resume of an already-completed run trains zero epochs
        "final_loss": history[-1]["loss"] if history else None,
        "best_epoch": best["epoch"], **final}


if __name__ == "__main__":
    main()
