"""Paired device-vs-host learning validation at config #4: train the
registry config4 model through BOTH sampling estimators at an IDENTICAL
step budget and seed, logging per-epoch loss + val AUC/AP and the final
test metrics for each.

The two pipelines are separate-but-equivalent estimators (different RNG
streams and packing order — data/device_sampler.py); equivalence here means
the curves track and the final AUCs agree within noise, not bit-equality.
CI covers the same property at small scale
(tests/test_device_vs_host_learning.py).

Run on the GPU: python scripts/validate_config4_learning.py \
    [--steps-per-epoch 500] [--epochs 4]
"""
from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import dataclasses
import json
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps-per-epoch", type=int, default=500)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--exact-eval", action="store_true",
                   help="additionally run FULL-propagation (estimator-free) "
                        "val/test eval after training and report it next to "
                        "the sampled estimator, with wall time")
    p.add_argument("--modes", default="device,host",
                   help="comma list: device,host")
    args = p.parse_args()

    from bignn.config import get_config
    from bignn.data.datasets import load_npz_cache
    from bignn.models import BiGNN
    from bignn.train import MinibatchTrainer

    cache = _os.path.join(_os.path.dirname(__file__), "..", ".cache",
                          "config4_100000.npz")
    ds = load_npz_cache(cache, "config4")
    cfg = get_config("config4")
    tcfg = dataclasses.replace(cfg.train, epochs=args.epochs, eval_every=1)

    lines = []
    for mode in args.modes.split(","):
        model = BiGNN(cfg.model)
        tr = MinibatchTrainer(
            model, ds, tcfg, fanouts=cfg.fanouts, max_drugs=cfg.max_drugs,
            device_sample=(mode == "device"),
            dispatch_chunk=cfg.dispatch_chunk)
        t0 = time.perf_counter()

        def log(rec, mode=mode, t0=t0):
            out = {"mode": mode,
                   "step": (rec["epoch"] + 1) * args.steps_per_epoch,
                   "loss": round(rec["loss"], 4),
                   "val_auc": round(rec.get("val_auc", float("nan")), 4),
                   "val_ap": round(rec.get("val_ap", float("nan")), 4),
                   "wall_s": round(time.perf_counter() - t0, 1)}
            lines.append(out)
            print(json.dumps(out), flush=True)

        params, result = tr.fit(steps_per_epoch=args.steps_per_epoch,
                                log_fn=log)
        fin = {"mode": mode, "final_test": {
            "test_auc": round(result["test_auc"], 4),
            "test_ap": round(result["test_ap"], 4)}}
        lines.append(fin)
        print(json.dumps(fin), flush=True)
        if args.exact_eval:
            # estimator-free final metrics: full inner encode of every
            # molecule + one outer pass over the whole train graph
            # (trainer.evaluate(exact=True)); negatives drawn identically
            # to the sampled eval, so the delta isolates the estimator
            best = params  # fit() returns best-val params
            for split in ("val", "test"):
                t1 = time.perf_counter()
                ex = tr.evaluate(best, split, exact=True)
                sp = tr.evaluate(best, split, exact=False)
                rec = {"mode": mode, "split": split,
                       "exact_auc": round(ex[f"{split}_auc"], 4),
                       "exact_ap": round(ex[f"{split}_ap"], 4),
                       "sampled_auc": round(sp[f"{split}_auc"], 4),
                       "sampled_ap": round(sp[f"{split}_ap"], 4),
                       "exact_minus_sampled_auc": round(
                           ex[f"{split}_auc"] - sp[f"{split}_auc"], 4),
                       "exact_eval_wall_s": round(
                           time.perf_counter() - t1, 1)}
                lines.append(rec)
                print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")


if __name__ == "__main__":
    main()
