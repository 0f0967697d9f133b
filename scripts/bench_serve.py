"""Serving micro-bench at config-#4 scale.

Builds a Scorer over the 100K-drug synthetic (fresh-init params — timing
does not depend on trained weights): offline full-propagation embed, then
online top-k latency single/batched, with and without the known-partner
exclusion CSR.

Run on the GPU: python scripts/bench_serve.py [--num-drugs 100000]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os as _os
import sys as _sys
import time

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-drugs", type=int, default=100_000)
    p.add_argument("--k", type=int, default=20)
    args = p.parse_args()

    import jax
    import numpy as np

    from bignn.config import get_config
    from bignn.models import BiGNN
    from bignn.serve import Scorer
    from scripts.p2_scale_stats import load_ds, load_scaled_ds

    ds = (load_ds() if args.num_drugs == 100_000
          else load_scaled_ds(args.num_drugs))
    cfg = get_config("config4")
    model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
    params = model.init(jax.random.key(0))

    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params)
    t_build = time.perf_counter() - t0
    out = {"num_drugs": ds.num_drugs,
           "scorer_build_s": round(t_build, 1),
           "embed_dim": int(scorer.embeddings.shape[1]),
           "known_kmax": scorer._kmax}

    def timed(fn, reps=8):
        fn()  # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    rng = np.random.default_rng(0)
    q1 = int(rng.integers(0, ds.num_drugs))
    qb = rng.integers(0, ds.num_drugs, 256)
    out["top_k_single_ms"] = round(
        timed(lambda: scorer.top_k(q1, args.k)) * 1e3, 2)
    out["top_k_single_excl_ms"] = round(
        timed(lambda: scorer.top_k(q1, args.k, exclude_known=True)) * 1e3, 2)
    out["top_k_batch256_ms"] = round(
        timed(lambda: scorer.top_k_batch(qb, args.k)) * 1e3, 2)
    out["top_k_batch256_excl_ms"] = round(
        timed(lambda: scorer.top_k_batch(qb, args.k, exclude_known=True))
        * 1e3, 2)
    out["per_query_batched_us"] = round(
        out["top_k_batch256_excl_ms"] / 256 * 1e3, 1)
    pairs = np.stack([rng.integers(0, ds.num_drugs, 65536),
                      rng.integers(0, ds.num_drugs, 65536)], 1)
    out["score_pairs_64k_ms"] = round(
        timed(lambda: scorer.score_pairs(pairs)) * 1e3, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
