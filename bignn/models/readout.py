"""Segment-pool readouts: node states -> per-graph embeddings (SURVEY.md §3.2).

Readout is the bridge between the levels: pool atom states by molecule id into
one drug embedding (reference: global_add_pool / attention pooling,
SURVEY.md §2.1 R5). ``graph_ids`` follows the layout contract: sorted,
padding rows carry id ``num_graphs`` and are dropped by the segment ops.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from bignn.models.modules import MLP, glorot
from bignn.ops import segment_max, segment_mean, segment_softmax, segment_sum


@dataclasses.dataclass(frozen=True)
class SumReadout:
    dim: int

    def init(self, key):
        return {}

    def apply(self, params, x, graph_ids, num_graphs, graph_n_nodes=None):
        return segment_sum(x, graph_ids, num_graphs)


@dataclasses.dataclass(frozen=True)
class MeanReadout:
    dim: int

    def init(self, key):
        return {}

    def apply(self, params, x, graph_ids, num_graphs, graph_n_nodes=None):
        if graph_n_nodes is not None:
            total = segment_sum(x, graph_ids, num_graphs)
            return total / jnp.maximum(graph_n_nodes, 1.0)[:, None]
        return segment_mean(x, graph_ids, num_graphs)


@dataclasses.dataclass(frozen=True)
class MaxReadout:
    dim: int

    def init(self, key):
        return {}

    def apply(self, params, x, graph_ids, num_graphs, graph_n_nodes=None):
        return segment_max(x, graph_ids, num_graphs)


@dataclasses.dataclass(frozen=True)
class AttentionReadout:
    """Gated attention pooling: ``g = sum_v softmax_v(gate(x_v)) * proj(x_v)``.

    Gate scores are segment-softmaxed within each graph; padding node rows
    carry graph id ``num_graphs`` so they are dropped.
    """

    dim: int
    hidden: int = 64

    def init(self, key):
        kg, kp = jax.random.split(key)
        gate = MLP((self.dim, self.hidden, 1), "tanh")
        return {"gate": gate.init(kg), "proj": glorot(kp, (self.dim, self.dim))}

    def apply(self, params, x, graph_ids, num_graphs, graph_n_nodes=None):
        gate = MLP((self.dim, self.hidden, 1), "tanh")
        scores = gate.apply(params["gate"], x)[:, 0]  # [N]
        alpha = segment_softmax(scores, graph_ids, num_graphs)  # [N]
        proj = jnp.dot(x, params["proj"], preferred_element_type=jnp.float32)
        return segment_sum(proj * alpha[:, None], graph_ids, num_graphs)


def parse_readout(spec: str, dim: int):
    """``"sum" | "mean" | "max" | "attention[:hidden]"``."""
    parts = spec.split(":")
    kind = parts[0].lower()
    if kind == "sum":
        return SumReadout(dim)
    if kind == "mean":
        return MeanReadout(dim)
    if kind == "max":
        return MaxReadout(dim)
    if kind == "attention":
        hidden = int(parts[1]) if len(parts) > 1 else 64
        return AttentionReadout(dim, hidden)
    raise ValueError(f"unknown readout spec {spec!r}")
