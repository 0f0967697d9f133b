"""Where the config-4 train step spends its device time.

Compiles the config-4 ceiling step (bench.py: the device-sampled minibatch
train step scanned over presampled device batches), times it, and with
``--trace-dir`` traces one scan and sums the device time per op per step,
with the device's busy time and idle share. It also checks the
block-diagonal count adjacency that the step builds (ops.block_adjacency)
against a NumPy count of the first batch's edges, and times that build
alone on those edges.

Run on the GPU: python scripts/trace_config4.py [--trace-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os as _os
import sys as _sys
import time
from collections import defaultdict

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def sample_batches(tr, n: int = 8):
    """``n`` device-sampled batches, stacked for a scan."""
    import jax
    import jax.numpy as jnp

    dev = tr.dsampler
    cbs = [jax.jit(dev.sample)(tr._dev_consts, dev.key_at(1, j))[0]
           for j in range(n)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cbs)


def check_block_adjacency(tr, stacked, reps: int = 20) -> dict:
    """The count adjacency the step builds for the first batch against a
    NumPy count of its edges, and the build's time alone."""
    import jax
    import numpy as np

    from bignn import ops

    pb = jax.jit(tr._expand_compact)(jax.tree.map(lambda x: x[0], stacked),
                                     tr.tables)
    nc = tr.dsampler.NC
    src, dst = np.asarray(pb.edge_src), np.asarray(pb.edge_dst)
    real = dst < nc
    same = real & (src // 128 == dst // 128)
    ref = np.zeros((nc // 128, 128, 128), np.int32)
    np.add.at(ref, (dst[same] // 128, dst[same] % 128, src[same] % 128), 1)
    dt = pb.block_cnt.dtype
    build = jax.jit(lambda s, d: ops.block_adjacency(s, d, None, nc, dt))
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(build(pb.edge_src, pb.edge_dst))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"count_dtype": dt.name, "real_edges": int(real.sum()),
            "edge_slots": int(dst.size),
            "cross_block_edges": int((real & ~same).sum()),
            "max_cell_multiplicity": int(ref.max()),
            "mismatches": int((np.asarray(pb.block_cnt, np.int32)
                               != ref).sum()),
            "build_alone_ms_median": float(np.median(times[1:]))}


def compile_ceiling_step(tr, stacked):
    """The config-4 ceiling scan (bench.py), compiled; returns (compiled,
    its arguments)."""
    import jax

    def run_scan(params, opt_state, stacked, tables):
        def body(carry, hb):
            params, opt_state, loss = tr._step(*carry, hb, tables)
            return (params, opt_state), loss
        return jax.lax.scan(body, (params, opt_state), stacked)[1]

    params, opt_state = tr.init()
    args = (params, opt_state, stacked, tr.tables)
    return jax.jit(run_scan).lower(*args).compile(), args


def device_op_times(trace_dir: str, steps: int, top: int = 12,
                    plane_prefix: str = "/device:GPU") -> dict:
    """Per line of each plane named ``plane_prefix``* in the newest trace
    under ``trace_dir``: busy ms per step (the union of its event
    intervals) and the ``top`` event names by ms per step."""
    import jax

    paths = sorted(glob.glob(_os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in prof.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            per_name = defaultdict(float)
            spans = []
            for ev in line.events:
                per_name[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
            if not spans:
                continue
            busy, end = 0.0, float("-inf")
            for s, e in sorted(spans):
                if e > end:
                    busy += e - max(s, end)
                    end = e
            ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
            out[f"{plane.name}|{line.name}"] = {
                "busy_ms_per_step": busy / steps / 1e6,
                "top_ms_per_step": {k: v / steps / 1e6 for k, v in ranked}}
    return out


def run(tr, reps: int = 10, trace_dir: str | None = None,
        emit=print) -> dict:
    """Check the adjacency, time the ceiling step and optionally trace it.
    Returns the timing line."""
    import jax
    import numpy as np

    stacked = sample_batches(tr)
    steps = int(jax.tree.leaves(stacked)[0].shape[0])
    adj = check_block_adjacency(tr, stacked)
    emit(json.dumps({"block_adjacency": adj}))
    if adj["mismatches"] or adj["cross_block_edges"]:
        raise AssertionError(f"block adjacency differs from NumPy: {adj}")
    t0 = time.perf_counter()
    compiled, args = compile_ceiling_step(tr, stacked)
    compile_s = time.perf_counter() - t0
    losses = np.asarray(jax.block_until_ready(compiled(*args)))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses not finite: {losses}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append((time.perf_counter() - t0) / steps * 1e3)
    line = {"compile_s": compile_s, "losses": losses.tolist(),
            "steps_per_scan": steps, "step_ms": times,
            "step_ms_median": float(np.median(times))}
    emit(json.dumps(line))
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(compiled(*args))
        dev = device_op_times(trace_dir, steps)
        busy = max((v["busy_ms_per_step"] for v in dev.values()), default=0)
        emit(json.dumps({"trace": trace_dir, "device_ms": dev,
                         "idle_share": 1 - busy / line["step_ms_median"]}))
    return line


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=10, help="timed scans")
    p.add_argument("--trace-dir", default=None,
                   help="trace one scan into DIR and reduce it")
    args = p.parse_args()

    import bench
    from bignn.utils import enable_compile_cache
    from bignn.utils.device import device_info, require_gpu

    require_gpu()
    enable_compile_cache()
    print(json.dumps(device_info()), flush=True)
    tr = bench.config4_trainer()
    print(json.dumps({"NC": tr.dsampler.NC, "EC": tr.dsampler.EC}),
          flush=True)
    run(tr, args.reps, args.trace_dir, emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
