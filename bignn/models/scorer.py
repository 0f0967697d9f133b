"""Edge pair scorers (SURVEY.md §3.2 SCORING; reference §2.1 R4 (d)).

Score a pair of drug embeddings (u, v) -> interaction logit. ``pairs`` is an
[P, 2] int array of node ids (positives and sampled negatives alike).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from bignn.models.modules import MLP
from bignn.ops.gather import gather_rows


@dataclasses.dataclass(frozen=True)
class DotScorer:
    dim: int

    def init(self, key):
        return {}

    def apply(self, params, emb, pairs):
        hu = gather_rows(emb, pairs[:, 0])
        hv = gather_rows(emb, pairs[:, 1])
        return jnp.sum(hu * hv, axis=-1)

    def apply_one_vs_all(self, params, emb, u):
        """Scores of (u, v) for EVERY v — one matvec, no [N, 2] pair
        materialization (the serving rank-all path; serve.Scorer)."""
        return emb @ jnp.take(emb, u, axis=0)


@dataclasses.dataclass(frozen=True)
class MLPScorer:
    """MLP on the symmetric pair representation [u*v, |u-v|, u+v]."""

    dim: int
    hidden: int = 64

    def _mlp(self):
        return MLP((3 * self.dim, self.hidden, 1), "relu")

    def init(self, key):
        return {"mlp": self._mlp().init(key)}

    def apply(self, params, emb, pairs):
        hu = gather_rows(emb, pairs[:, 0])
        hv = gather_rows(emb, pairs[:, 1])
        feat = jnp.concatenate([hu * hv, jnp.abs(hu - hv), hu + hv], axis=-1)
        return self._mlp().apply(params["mlp"], feat)[:, 0]

    def apply_one_vs_all(self, params, emb, u):
        """Scores of (u, v) for EVERY v: broadcast u's row instead of
        gathering [N, 2] pairs — [N, 3d] features, no row gathers."""
        hu = jnp.take(emb, u, axis=0)[None, :]
        feat = jnp.concatenate(
            [hu * emb, jnp.abs(hu - emb), hu + emb], axis=-1)
        return self._mlp().apply(params["mlp"], feat)[:, 0]


def parse_scorer(spec: str, dim: int):
    parts = spec.split(":")
    kind = parts[0].lower()
    if kind == "dot":
        return DotScorer(dim)
    if kind == "mlp":
        hidden = int(parts[1]) if len(parts) > 1 else 64
        return MLPScorer(dim, hidden)
    raise ValueError(f"unknown scorer spec {spec!r}")
