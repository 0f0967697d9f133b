"""Inference / serving (production-deployment story; SURVEY.md §2.1 R3's
eval half, promoted to a first-class surface).

The BI-GNN serving workload factors cleanly on the device:

  1. OFFLINE (once per checkpoint): encode EVERY molecule through the
     inner level + one full outer propagation -> a [num_drugs, d] embedding
     matrix resident in device memory (exact full propagation, no sampling — the
     same estimator-free path as MinibatchTrainer.evaluate(exact=True)).
  2. ONLINE: scoring a (u, v) candidate pair is two embedding rows through
     the pair scorer — a gather + tiny matmul. Batched requests score
     in fixed-size jitted chunks; ranking all partners of one drug is a
     one-vs-all scorer pass (u's row broadcasts; dot = one matvec) +
     device top-k, with batched queries running in lax.map chunks so live
     memory stays O(qchunk * N * d).

Latencies at config-#4 scale (scripts/bench_serve.py) are not measured on
the H100 yet.

Usage (library):
    scorer = Scorer.from_checkpoint(cfg, ckpt_dir)   # or Scorer(model, ds, params)
    scores = scorer.score_pairs(pairs)               # [P] logits
    ids, s = scorer.top_k(drug_id, k=20)             # best candidate partners

CLI:
    python -m bignn.serve --config config2 --ckpt runs/x/ckpt \
        --pairs pairs.npy --out scores.npy
    python -m bignn.serve --config config2 --ckpt runs/x/ckpt \
        --topk 42 --k 20
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


class Scorer:
    """Device-resident batch scorer over a trained BI-GNN.

    ``chunk`` is the static jit batch for pair scoring; requests pad to it
    (one compilation, any request size).
    """

    def __init__(self, model, ds, params, chunk: int = 65536):
        from bignn.train.trainer import MinibatchTrainer, TrainConfig

        self.model = model
        self.ds = ds
        self.params = params
        self.chunk = int(chunk)
        # resident expansion machinery for the exact full encode; sampler
        # caps only shape the offline chunking, not results
        self._tr = MinibatchTrainer(
            model, ds, TrainConfig(epochs=0, batch_size=256), fanouts=(1,),
            calibrate_caps=0)
        self.embeddings = self._tr.embed_all_exact(params)  # [N, d] device
        # known-partner CSR over train+val edges (device-resident, both
        # directions): real DDI ranking wants NEW candidates — without the
        # mask, top-k is dominated by the partners already in the graph
        known = np.concatenate(
            [ds.split_edges("train"), ds.split_edges("val")]).astype(np.int64)
        und = np.concatenate([known, known[:, ::-1]])
        und = und[np.lexsort((und[:, 1], und[:, 0]))]
        n = ds.num_drugs
        kptr = np.searchsorted(und[:, 0], np.arange(n + 1))
        self._kmax = int(max(np.diff(kptr).max(), 1))
        self._kptr = jnp.asarray(kptr, jnp.int32)
        self._kdst = jnp.asarray(und[:, 1], jnp.int32)
        # params are jit ARGUMENTS, never closure constants: refresh() must
        # swap them without retracing (a closure would silently keep serving
        # the old scorer head), and constants would bake the param tree
        # into the HLO (trainer.py avoids that for compile-size reasons too)
        self._score = jax.jit(
            lambda prm, emb, pairs: model.score_pairs(prm, emb, pairs))
        self._rank = jax.jit(
            lambda prm, emb, d, k, excl: jax.lax.top_k(
                self._all_scores(prm, emb, d, excl), k),
            static_argnames=("k", "excl"))

        # batched ranking runs query CHUNKS through lax.map: a flat vmap
        # over B queries of an [N]-wide scorer lives O(B*N*d) — at 100K
        # drugs x 256 queries the r4 pairwise form OOMed the chip
        # (scripts/bench_serve.py); chunking caps live memory at
        # O(qchunk*N*d) with one compile for any B
        def _rank_batch(prm, emb, ds_, k, excl, qchunk=32):
            b = ds_.shape[0]
            pad = (-b) % qchunk
            dp = jnp.concatenate(
                [ds_, jnp.zeros(pad, jnp.int32)]).reshape(-1, qchunk)

            def one_chunk(q):
                return jax.lax.top_k(
                    jax.vmap(
                        lambda d: self._all_scores(prm, emb, d, excl))(q), k)

            scores, cand = jax.lax.map(one_chunk, dp)
            return (scores.reshape(-1, k)[:b], cand.reshape(-1, k)[:b])

        self._rank_batch = jax.jit(
            _rank_batch, static_argnames=("k", "excl", "qchunk"))

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str, chunk: int = 65536,
                        use_best: bool = True) -> "Scorer":
        """Restore a run's (best) params and build the scorer.

        ``cfg`` is an ExperimentConfig (config.get_config); the checkpoint
        layout is train.trainer._fit_state's (both trainers + p2 share it).
        """
        from bignn.data import load_dataset
        from bignn.models import BiGNN
        from bignn.train.checkpoint import CheckpointManager

        ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        mgr = CheckpointManager(ckpt_dir)
        key = "best_params" if use_best else "params"
        params = mgr.restore(template=model.init(jax.random.key(0)),
                             prefix=f"['{key}']")
        mgr.close()
        if params is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        params = jax.tree.map(jnp.asarray, params)
        return cls(model, ds, params, chunk=chunk)

    # -- online scoring ---------------------------------------------------
    def score_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """Logits for [P, 2] global drug-id pairs (any P; chunked jit)."""
        pairs = np.asarray(pairs, np.int32)
        out = np.empty(len(pairs), np.float32)
        for s in range(0, len(pairs), self.chunk):
            p = pairs[s : s + self.chunk]
            n = len(p)
            if n < self.chunk:  # pad to the static chunk shape
                p = np.concatenate(
                    [p, np.zeros((self.chunk - n, 2), np.int32)])
            out[s : s + n] = np.asarray(
                self._score(self.params, self.embeddings, jnp.asarray(p)))[:n]
        return out

    def _all_scores(self, params, emb, drug_id, exclude_known=False):
        n = emb.shape[0]
        # one-vs-all scorer: u's row broadcasts (dot: a single matvec) —
        # no [N, 2] pair materialization or [N, d] endpoint gathers (r5;
        # the pairwise form OOMed batched ranking at 100K drugs)
        scores = self.model.score_one_vs_all(params, emb, drug_id)
        scores = scores.astype(jnp.float32)
        # exclusions (self-interaction + optionally the drug's train/val
        # partners from the build-time CSR) apply as ONE dropped scatter
        # straight into the scores row — no per-query [N] bool mask
        # materialization (r5). Out-of-range sentinel
        # index n is dropped.
        excl = jnp.full(1, drug_id, jnp.int32)
        if exclude_known:
            lo = jnp.take(self._kptr, drug_id)
            deg = jnp.take(self._kptr, drug_id + 1) - lo
            idx = lo + jnp.arange(self._kmax, dtype=jnp.int32)
            part = jnp.take(
                self._kdst, jnp.minimum(idx, self._kdst.shape[0] - 1))
            part = jnp.where(jnp.arange(self._kmax) < deg, part, n)
            excl = jnp.concatenate([excl, part])
        return scores.at[excl].set(-jnp.inf, mode="drop")

    def top_k(self, drug_id: int, k: int = 20, exclude_known: bool = False):
        """(candidate_ids, logits) of the k best predicted partners.

        ``exclude_known=True`` additionally masks the drug's train/val
        partners, so the ranking surfaces NEW candidate interactions
        instead of re-ranking edges already in the graph."""
        scores, ids = self._rank(
            self.params, self.embeddings, jnp.int32(drug_id), k,
            bool(exclude_known))
        return np.asarray(ids), np.asarray(scores)

    def top_k_batch(self, drug_ids, k: int = 20,
                    exclude_known: bool = False):
        """Batched ranking: ([B, k] candidate ids, [B, k] logits) for a
        vector of query drugs in one device pass (vmapped [B, N] scoring +
        a single top-k)."""
        ids = jnp.asarray(np.asarray(drug_ids, np.int32))
        scores, cand = self._rank_batch(
            self.params, self.embeddings, ids, k, bool(exclude_known))
        return np.asarray(cand), np.asarray(scores)

    def refresh(self, params) -> None:
        """Swap in new params (e.g. a newer checkpoint) and re-embed."""
        self.params = params
        self.embeddings = self._tr.embed_all_exact(params)


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="CheckpointManager dir")
    p.add_argument("--pairs", default=None,
                   help=".npy/.npz [P, 2] int drug-id pairs to score")
    p.add_argument("--out", default=None, help="output .npy for scores")
    p.add_argument("--topk", default=None,
                   help="rank partners for this drug id (or a comma list "
                        "of ids for one batched pass) instead")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--exclude-known", action="store_true",
                   help="mask train/val partners from rankings (surface "
                        "NEW candidate interactions)")
    p.add_argument("--last", action="store_true",
                   help="use last params instead of best-val params")
    args = p.parse_args(argv)

    from bignn.config import get_config
    from bignn.utils import enable_compile_cache

    enable_compile_cache()
    scorer = Scorer.from_checkpoint(
        get_config(args.config), args.ckpt, use_best=not args.last)
    if args.topk is not None:
        drugs = [int(x) for x in str(args.topk).split(",")]
        if len(drugs) == 1:
            ids, scores = scorer.top_k(
                drugs[0], args.k, exclude_known=args.exclude_known)
        else:
            ids, scores = scorer.top_k_batch(
                drugs, args.k, exclude_known=args.exclude_known)
        print(json.dumps({
            "drug": drugs[0] if len(drugs) == 1 else drugs,
            "candidates": ids.tolist(),
            "logits": np.round(scores.astype(float), 4).tolist(),
        }))
        return ids, scores
    if args.pairs is None:
        raise SystemExit("need --pairs or --topk")
    arr = np.load(args.pairs)
    if hasattr(arr, "files"):  # npz
        arr = arr[arr.files[0]]
    scores = scorer.score_pairs(arr)
    if args.out:
        np.save(args.out, scores)
    print(json.dumps({
        "n": len(scores),
        "mean_logit": round(float(scores.mean()), 4),
        "out": args.out,
    }))
    return scores


if __name__ == "__main__":
    main()
