"""NumPy reference oracle (SURVEY.md T8).

With the reference mount empty (SURVEY.md header), this oracle temporarily
*is* the reference for per-layer activation parity (BASELINE.json:5 "match
per-layer activations allclose"). It is written independently from the model
equations — edge loops and dense adjacency, no segment ops — so agreement with
the JAX path is a genuine cross-check, not a tautology.
"""

from bignn.oracle.numpy_ref import (
    gcn_conv_ref,
    gin_conv_ref,
    gat_conv_ref,
    dotattn_conv_ref,
    readout_ref,
    attention_readout_ref,
    dot_score_ref,
    mlp_score_ref,
    segment_softmax_ref,
    spmm_ref,
    bignn_forward_ref,
)
