"""Benchmark harness (SURVEY.md T7): aggregate edges/s per GPU.

Metric (BASELINE.json:2): outer+inner aggregate REAL edges processed per
second per device during training steps of the full BI-GNN model (GIN inner,
GAT outer). Two workloads:

  * the full-graph preset (default ``drugbank``: the DrugBank-scale standin,
    dense outer GAT), timed as a scan of training steps in one jit;
  * config #4 (100K drugs, 10M outer edges, bf16, device-sampled minibatch):
    ``config4_sustained_*`` is the chunked device-sampling training rate,
    ``config4_ceiling_*`` the same train step scanned over presampled device
    batches.

The line also carries this card's bf16 stream (GB/s) and bf16 4096^3 matmul
(TFLOP/s) rates, measured inline, as context for the other numbers.

Prints ONE JSON line naming the device (platform, device_kind, device count,
nvidia-smi name and power limit). Exits non-zero without a GPU or when any
phase fails.

Run: python bench.py [--preset small|drugbank|large] [--steps N]
"""

from __future__ import annotations

import argparse
import json
import os
import time

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def _timed(fn, *args, reps: int) -> list[float]:
    """Seconds per call of ``fn(*args)``, each ended by block_until_ready;
    the first call (compile + warm-up) is not timed."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def measure_anchors(reps: int = 3) -> dict:
    """This card's bf16 square-stream GB/s and 4096^3 matmul TFLOP/s.

    Carry-threaded scans: the array is the scan carry, so every iteration
    must materialize (no DCE or fusion escape)."""
    import jax
    import jax.numpy as jnp

    def carry_scan(f, n):
        @jax.jit
        def run(x):
            return jax.lax.scan(lambda x, _: (f(x), None), x, None,
                                length=n)[0]
        return run

    n = 16
    bigh = jnp.ones(256 * 1024 * 1024 // 2, jnp.bfloat16)  # 256 MB
    t = min(_timed(carry_scan(lambda x: x * x + jnp.bfloat16(1.5), n),
                   bigh, reps=reps)) / n
    stream = 2 * bigh.nbytes / t / 1e9
    n = 8
    mm = jnp.ones((4096, 4096), jnp.bfloat16)
    t = min(_timed(carry_scan(
        lambda x: (x @ x * jnp.bfloat16(1e-4)).astype(jnp.bfloat16), n),
        mm, reps=reps)) / n
    return {"anchor_stream_gbps": stream,
            "anchor_matmul_tflops": 2 * 4096**3 / t / 1e12}


def load_config4_dataset():
    """Config #4's 100K-drug dataset, generated once into
    ``.cache/config4_100000.npz`` and loaded from there afterwards."""
    from bignn.data import make_synthetic_ddi
    from bignn.data.datasets import load_npz_cache, save_npz_cache

    cache = os.path.join(CACHE_DIR, "config4_100000.npz")
    if os.path.exists(cache):
        return load_npz_cache(cache, "config4")
    ds = make_synthetic_ddi(num_drugs=100_000, feat_dim=32,
                            avg_degree=200.0, min_atoms=8, max_atoms=40,
                            latent_dim=8, seed=0, name="config4")
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = cache.replace(".npz", f".{os.getpid()}.tmp.npz")
    save_npz_cache(ds, tmp)
    os.replace(tmp, cache)
    return ds


def config4_trainer(ds=None):
    """The config-#4 trainer as the benchmark runs it: device-sampled
    minibatch training, chunked dispatch."""
    from bignn.config import get_config
    from bignn.models import BiGNN
    from bignn.train import MinibatchTrainer

    cfg = get_config("config4")
    ds = load_config4_dataset() if ds is None else ds
    model = BiGNN(cfg.model)
    return MinibatchTrainer(model, ds, cfg.train, fanouts=cfg.fanouts,
                            max_drugs=cfg.max_drugs, device_sample=True,
                            dispatch_chunk=cfg.dispatch_chunk)


def bench_config4(steps: int = 16, reps: int = 4) -> dict:
    """Sustained = MinibatchTrainer(device_sample=True) chunked-scan rate;
    ceiling = the same train step scanned over presampled device batches;
    edges/step probed from those batches (real edges, not caps)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    tr = config4_trainer()
    model, dev = tr.model, tr.dsampler
    chunks = -(-steps // tr.dispatch_chunk)

    def sustained(p, o, rep):
        for c in range(chunks):
            p, o, losses, _ = tr.train_chunk_device(
                p, o, rep, c * tr.dispatch_chunk)
        return losses

    p_, o_ = tr.init()
    jax.block_until_ready(sustained(p_, o_, 0))  # compile + warm
    dev_times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(sustained(p_, o_, rep + 1))
        dev_times.append((time.perf_counter() - t0)
                         / (chunks * tr.dispatch_chunk))

    cbs = [jax.jit(dev.sample)(tr._dev_consts, dev.key_at(1, j))[0]
           for j in range(8)]
    e_per = tr.sampler.mol_edge_counts
    probes = [(int(e_per[np.asarray(cb.nodes)[:int(cb.n_real)]].sum()),
               int((np.asarray(cb.outer_dst) < dev.D).sum()))
              for cb in cbs[:5]]
    eps = (np.median([p[0] for p in probes]) * len(model.config.inner_layers)
           + np.median([p[1] for p in probes])
           * len(model.config.outer_layers))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cbs)

    @jax.jit
    def run_scan(params, opt_state, stacked, tables):
        def body(carry, hb):
            params, opt_state, loss = tr._step(*carry, hb, tables)
            return (params, opt_state), loss
        return jax.lax.scan(body, (params, opt_state), stacked)[1]

    pp, oo = tr.init()
    scan_times = [t / len(cbs) for t in _timed(
        run_scan, pp, oo, stacked, tr.tables, reps=reps)]

    def stats(prefix, times):
        rates = sorted(float(eps / t) for t in times)
        med = float(np.median(rates))
        return {f"{prefix}_median": med, f"{prefix}_min": rates[0],
                f"{prefix}_spread": (rates[-1] - rates[0]) / med}

    out = {"config4_edges_per_step": float(eps),
           "config4_sustained_step_ms": float(np.median(dev_times)) * 1e3,
           "config4_ceiling_step_ms": float(np.median(scan_times)) * 1e3}
    out.update(stats("config4_sustained", dev_times))
    out.update(stats("config4_ceiling", scan_times))
    return out


def bench_full_graph(preset: str, steps: int, batch: int, dtype: str,
                     dim: int, reps: int = 3) -> dict:
    """edges/s of the full-graph Trainer step on a preset, timed as one jit
    scanning ``steps`` training steps."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bignn.data import load_dataset, prepare_device_data
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.train import Trainer, TrainConfig

    presets = {
        "small": dict(name="synthetic-small", num_drugs=500, feat_dim=16),
        "drugbank": dict(name="drugbank"),
        "large": dict(name="synthetic-large", num_drugs=20_000,
                      avg_degree=100.0),
    }
    spec = dict(presets[preset])
    ds = load_dataset(spec.pop("name"), **spec)
    # single bucket: the block-local packing already bounds padding, so size
    # bucketing only fragments the inner level into more kernel launches
    data = prepare_device_data(ds, max_buckets=1)
    model = BiGNN(dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=dim, heads=4),
        dtype=dtype))
    trainer = Trainer(model, data,
                      TrainConfig(lr=1e-3, epochs=1, batch_size=batch))
    params, opt_state = trainer.init()

    # REAL edges per step (forward), not padded caps
    inner_edges = sum(int((np.asarray(b.edge_dst) < b.node_cap).sum())
                      for b in data.bucketing.batches)
    outer_edges = int(
        (np.asarray(data.outer.edge_dst) < data.outer.num_nodes).sum())
    edges_per_step = (inner_edges * len(model.config.inner_layers)
                      + outer_edges * len(model.config.outer_layers))

    rng = np.random.default_rng(0)
    pos_all = jnp.asarray(
        rng.integers(0, ds.num_drugs, (steps, batch, 2)), jnp.int32)
    mask = jnp.ones(batch, jnp.float32)

    # every measured step runs inside ONE jit via lax.scan, so per-step
    # Python dispatch (which pipelines away in a training loop) is excluded
    @jax.jit
    def run_steps(params, opt_state, key, pos_all):
        def body(carry, pos):
            params, opt_state, key = carry
            key, sub = jax.random.split(key)
            params, opt_state, loss = trainer._step(
                params, opt_state, sub, pos, mask)
            return (params, opt_state, key), loss
        return jax.lax.scan(body, (params, opt_state, key), pos_all)[1]

    times = _timed(run_steps, params, opt_state, jax.random.key(0), pos_all,
                   reps=reps)
    step_s = float(np.median(times)) / steps
    return {"preset": preset, "edges_per_step": edges_per_step,
            "step_ms": step_s * 1e3,
            "value": edges_per_step / step_s,
            "value_min": edges_per_step * steps / max(times)}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="drugbank",
                        choices=["small", "drugbank", "large"])
    parser.add_argument("--no-config4", dest="config4", action="store_false",
                        help="skip the config-#4 device-sampled fields")
    parser.add_argument("--steps", type=int, default=200,
                        help="steps per timed scan of the full-graph preset")
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (params/optimizer stay f32)")
    parser.add_argument("--dim", type=int, default=64,
                        help="model hidden dim")
    args = parser.parse_args()

    from bignn.utils import enable_compile_cache
    from bignn.utils.device import device_info, require_gpu

    require_gpu()
    cache_dir = enable_compile_cache()
    line = {"metric": "edges_per_s_per_chip", "unit": "edges/s/chip",
            **device_info(), "compile_cache": cache_dir}
    line.update(bench_full_graph(args.preset, max(10, args.steps),
                                 args.batch, args.dtype, args.dim))
    line.update(measure_anchors())
    if args.config4:
        line.update(bench_config4())
    print(json.dumps(line))


if __name__ == "__main__":
    main()
