"""Static-shape sparse graph formats (SURVEY.md §2.4 T1).

The layout contract (SURVEY.md §7 "The hard parts"): every aggregation in the
framework is a *sorted* segment reduction. Edges are stored destination-sorted
so neighbor aggregation is a sorted-segment-sum (CSR row order), which XLA and
the Pallas kernels can execute without unsorted scatter. Padding always maps to
one-past-the-end segment ids so out-of-range ids are dropped by segment
reductions — no mask multiplies on the hot path.
"""

from bignn.sparse.formats import (
    COOGraph,
    PaddedGraphBatch,
    OuterGraph,
    build_padded_batch,
    build_outer_graph,
    gcn_normalize,
    pad_to,
)
from bignn.sparse.bucketing import (
    Bucketing,
    plan_buckets,
    bucket_graphs,
)

__all__ = [
    "COOGraph",
    "PaddedGraphBatch",
    "OuterGraph",
    "build_padded_batch",
    "build_outer_graph",
    "gcn_normalize",
    "pad_to",
    "Bucketing",
    "plan_buckets",
    "bucket_graphs",
]
