"""Sparse compute ops (SURVEY.md T2; kernel classes from BASELINE.json:5).

Each op is composed from XLA primitives (take / segment_sum /
dot_general). Where a hand-written Pallas kernel for the GPU exists
(ops/pallas/), ops/dispatch.py picks it on a CUDA GPU and the XLA
composition everywhere else.

Mapping to the reference's native dependency ops (SURVEY.md §2.2):
  N1 torch_scatter.scatter_*   -> segment_sum / segment_mean / segment_max
  N2 torch_sparse.spmm         -> spmm_sorted_coo
  N3 GAT scatter-softmax       -> sddmm + segment_softmax
  N4 ATen index_select         -> gather_rows
  N5 cuDNN GEMM                -> plain jnp dot (no custom op needed)
"""

from bignn.ops.segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax,
)
from bignn.ops.spmm import spmm_sorted_coo, block_diag_spmm, block_adjacency
from bignn.ops.multihead import spmm_multihead
from bignn.ops.sddmm import sddmm
from bignn.ops.gather import gather_rows

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "spmm_sorted_coo",
    "block_diag_spmm",
    "block_adjacency",
    "spmm_multihead",
    "sddmm",
    "gather_rows",
]
