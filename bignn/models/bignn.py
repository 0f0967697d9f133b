"""BiGNN — the bi-level graph-of-graphs model (SURVEY.md §2.1 R4, §3.2).

Forward (mirrors the reconstructed reference call stack, SURVEY.md §3.2):
  1. INNER: each bucket's padded disjoint union of molecule graphs runs
     through k shared message-passing layers; readout segment-pools node
     states into per-molecule embeddings; bucket embeddings are scattered
     back into one [num_drugs, d] matrix via the bucket's graph index.
  2. OUTER: m conv layers propagate drug embeddings over the DDI graph.
  3. SCORING: pair scorer on gathered endpoint embeddings -> logits.

Everything is static-shape; the bucket loop is a Python loop over a small
fixed set of shapes (one XLA computation containing all buckets).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from bignn.models.convs import parse_conv
from bignn.models.readout import parse_readout
from bignn.models.scorer import parse_scorer
from bignn.sparse.formats import OuterGraph, PaddedGraphBatch


@dataclasses.dataclass(frozen=True)
class BiGNNConfig:
    """Typed equivalent of the reference's per-layer spec strings
    (SURVEY.md §2.1 R2): e.g. inner=("gin:64", "gin:64"), outer=("gat:64:4",),
    readout="sum", scorer="dot".

    ``dtype`` is the compute precision: parameters are kept in f32 (master
    weights, optimizer math) and cast per-step; "bfloat16" halves memory
    traffic and runs matmuls at the tensor cores' bf16 rate, with f32
    accumulation inside matmuls.
    """

    feat_dim: int
    inner_layers: tuple[str, ...] = ("gcn:64", "gcn:64")
    readout: str = "sum"
    outer_layers: tuple[str, ...] = ("gcn:64",)
    scorer: str = "dot"
    dtype: str = "float32"  # "float32" | "bfloat16"

    @staticmethod
    def config1(feat_dim: int) -> "BiGNNConfig":
        """BASELINE.json:7 — 2-layer GCN inner + 1-layer GCN outer.

        The final outer conv is linear (no relu): clamping embeddings
        non-negative right before dot-product scoring throws away half the
        embedding space and measurably hurts link-prediction AUC.
        """
        return BiGNNConfig(feat_dim=feat_dim, outer_layers=("gcn:64:identity",))

    @staticmethod
    def full_bignn(feat_dim: int, dim: int = 64, heads: int = 4) -> "BiGNNConfig":
        """BASELINE.json:8 — full BI-GNN: GIN inner, GAT outer."""
        return BiGNNConfig(
            feat_dim=feat_dim,
            inner_layers=(f"gin:{dim}", f"gin:{dim}"),
            readout="sum",
            outer_layers=(f"gat:{dim}:{heads}:identity",),
            scorer="mlp:64",
        )


@dataclasses.dataclass(frozen=True)
class BiGNN:
    config: BiGNNConfig

    # ---- static layer construction -------------------------------------
    def _inner_stack(self):
        layers, dim = [], self.config.feat_dim
        for spec in self.config.inner_layers:
            conv = parse_conv(spec, dim)
            layers.append(conv)
            dim = conv.out_dim
        return layers, dim

    def _outer_stack(self, in_dim: int):
        layers, dim = [], in_dim
        for spec in self.config.outer_layers:
            conv = parse_conv(spec, dim)
            layers.append(conv)
            dim = conv.out_dim
        return layers, dim

    @property
    def embed_dim(self) -> int:
        _, inner_dim = self._inner_stack()
        _, outer_dim = self._outer_stack(inner_dim)
        return outer_dim

    @property
    def compute_dtype(self):
        return jnp.dtype(self.config.dtype)

    def cast(self, tree):
        """Cast float leaves to the compute dtype (no-op for f32 configs)."""
        dt = self.compute_dtype
        if dt == jnp.float32:
            return tree
        return jax.tree.map(
            lambda x: x.astype(dt) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            tree,
        )

    def _readout_obj(self):
        _, inner_dim = self._inner_stack()
        return parse_readout(self.config.readout, inner_dim)

    def _scorer_obj(self):
        return parse_scorer(self.config.scorer, self.embed_dim)

    # ---- params --------------------------------------------------------
    def init(self, key: jax.Array) -> dict:
        inner, inner_dim = self._inner_stack()
        readout = parse_readout(self.config.readout, inner_dim)
        outer, outer_dim = self._outer_stack(inner_dim)
        scorer = parse_scorer(self.config.scorer, outer_dim)
        n_keys = len(inner) + len(outer) + 2
        keys = list(jax.random.split(key, n_keys))
        params = {
            "inner": {f"layer_{i}": l.init(keys.pop()) for i, l in enumerate(inner)},
            "readout": readout.init(keys.pop()),
            "outer": {f"layer_{i}": l.init(keys.pop()) for i, l in enumerate(outer)},
            "scorer": scorer.init(keys.pop()),
        }
        return params

    # ---- forward -------------------------------------------------------
    def encode_inner(self, params: dict, batch: PaddedGraphBatch) -> jax.Array:
        """Inner GNN + readout on one padded bucket -> [num_graphs, d]."""
        inner, inner_dim = self._inner_stack()
        readout = parse_readout(self.config.readout, inner_dim)
        params = self.cast(params)
        x = batch.node_feat.astype(self.compute_dtype)
        block_dense = None
        if batch.block_adj is not None:
            block_dense = (batch.block_adj, batch.block_cnt)
        for i, conv in enumerate(inner):
            x = conv.apply(
                params["inner"][f"layer_{i}"],
                x,
                batch.edge_src,
                batch.edge_dst,
                batch.edge_weight,
                batch.node_cap,
                block_dense=block_dense,
            )
        return readout.apply(
            params["readout"], x, batch.graph_ids, batch.num_graphs, batch.graph_n_nodes
        )

    def embed_drugs(
        self,
        params: dict,
        buckets: Sequence[PaddedGraphBatch],
        graph_index: Sequence[jax.Array],
        num_drugs: int,
    ) -> jax.Array:
        """Run all buckets through the inner level; place into [num_drugs, d].

        Buckets partition the drug set (sparse/bucketing.py: every graph is
        assigned to exactly one bucket), so the concatenated bucket index is a
        permutation of ``range(num_drugs)`` and the placement is a
        permutation *gather* with a gather-only VJP — no scatter on
        either pass.
        A zeros+scatter fallback covers callers whose buckets don't cover
        every drug (none in-tree).

        PRECONDITION of the fast path: the concatenated ``graph_index`` must
        be duplicate-free (a true permutation of ``range(num_drugs)``). The
        guard only checks the total row count; a bucketing that
        double-assigns one drug while missing another would pass it and
        ``permutation_scatter_rows`` (an argsort of a non-permutation) would
        silently mis-place rows. In-tree bucketing (sparse/bucketing.py)
        partitions the drug set, so the precondition holds for every caller;
        tests/test_models_parity.py exercises a uniqueness check."""
        from bignn.ops.gather import permutation_scatter_rows

        _, inner_dim = self._inner_stack()
        embs = [self.encode_inner(params, batch) for batch in buckets]
        if sum(int(e.shape[0]) for e in embs) == num_drugs:
            cat_idx = jnp.concatenate(
                [jnp.asarray(i, jnp.int32) for i in graph_index])
            cat = embs[0] if len(embs) == 1 else jnp.concatenate(embs, axis=0)
            return permutation_scatter_rows(cat, cat_idx).astype(jnp.float32)
        emb = jnp.zeros((num_drugs, inner_dim), jnp.float32)
        for bucket_emb, idx in zip(embs, graph_index):
            emb = emb.at[jnp.asarray(idx)].set(bucket_emb)
        return emb

    def propagate_outer(self, params: dict, emb: jax.Array, outer: OuterGraph) -> jax.Array:
        _, inner_dim = self._inner_stack()
        outer_layers, _ = self._outer_stack(inner_dim)
        params = self.cast(params)
        emb = emb.astype(self.compute_dtype)
        dense = None
        if getattr(outer, "dense_adj", None) is not None:
            dense = (outer.dense_adj, outer.dense_cnt)
        for i, conv in enumerate(outer_layers):
            emb = conv.apply(
                params["outer"][f"layer_{i}"],
                emb,
                outer.edge_src,
                outer.edge_dst,
                outer.edge_weight,
                outer.num_nodes,
                dense=dense,
            )
        return emb

    def score_pairs(self, params: dict, emb: jax.Array, pairs: jax.Array) -> jax.Array:
        scorer = parse_scorer(self.config.scorer, self.embed_dim)
        params = self.cast(params)
        logits = scorer.apply(params["scorer"], emb.astype(self.compute_dtype), pairs)
        return logits.astype(jnp.float32)

    def score_one_vs_all(self, params: dict, emb: jax.Array, u) -> jax.Array:
        """[N] logits of (u, v) for every v — the serving rank-all path:
        u's row broadcasts instead of gathering [N, 2] endpoint pairs
        (at 100K drugs the pairwise form gathered 2 x [N, d] per query;
        scripts/bench_serve.py)."""
        scorer = parse_scorer(self.config.scorer, self.embed_dim)
        params = self.cast(params)
        logits = scorer.apply_one_vs_all(
            params["scorer"], emb.astype(self.compute_dtype), u)
        return logits.astype(jnp.float32)

    def apply(
        self,
        params: dict,
        buckets: Sequence[PaddedGraphBatch],
        graph_index: Sequence[jax.Array],
        outer: OuterGraph,
        pairs: jax.Array,
    ) -> jax.Array:
        """Full forward: molecule graphs + DDI graph + [P, 2] pairs -> logits."""
        emb = self.embed_drugs(params, buckets, graph_index, outer.num_nodes)
        emb = self.propagate_outer(params, emb, outer)
        return self.score_pairs(params, emb, pairs)
