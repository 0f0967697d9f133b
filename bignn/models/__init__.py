"""Pure-pytree GNN modules (SURVEY.md T3; reference layer zoo §2.1 R4-R5).

Modules are config dataclasses with ``init(key) -> params`` (nested dict
pytrees) and ``apply(params, ...)`` pure functions — no framework state, fully
jit/grad/shard_map-compatible. The layer registry keeps the reference's
"model described by per-layer spec strings" idea (SURVEY.md §5 config row) in
typed form: ``"gin:64"``, ``"gat:64:4"``, ``"attention:64"`` etc.
"""

from bignn.models.modules import Dense, MLP, glorot, parse_activation
from bignn.models.convs import GCNConv, GINConv, GATConv, DotAttnConv, parse_conv
from bignn.models.readout import (
    SumReadout,
    MeanReadout,
    MaxReadout,
    AttentionReadout,
    parse_readout,
)
from bignn.models.scorer import DotScorer, MLPScorer, parse_scorer
from bignn.models.loss import bce_with_logits_loss
from bignn.models.bignn import BiGNN, BiGNNConfig

__all__ = [
    "Dense",
    "MLP",
    "glorot",
    "parse_activation",
    "GCNConv",
    "GINConv",
    "GATConv",
    "DotAttnConv",
    "parse_conv",
    "SumReadout",
    "MeanReadout",
    "MaxReadout",
    "AttentionReadout",
    "parse_readout",
    "DotScorer",
    "MLPScorer",
    "parse_scorer",
    "bce_with_logits_loss",
    "BiGNN",
    "BiGNNConfig",
]
