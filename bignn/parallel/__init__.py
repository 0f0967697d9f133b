"""Distribution layer (SURVEY.md T6, §2.3 P1-P2).

The reference is single-device (SURVEY.md §2.3); all parallelism here is new
scope mandated by BASELINE.json:5,11:

  * mesh.py      — device mesh construction (dp × model axes).
  * dp.py        — data parallelism: positive-edge minibatch sharded over the
                   'dp' axis, parameters replicated, gradients psum'd by XLA
                   (P1 — first distribution milestone).
  * partition.py — outer-graph edge partitioner (P2 prerequisite).
  * halo.py      — boundary drug-embedding all-to-all (P2 flagship).
"""

from bignn.parallel.mesh import (
    global_put,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
)
from bignn.parallel.dp import shard_pairs, dp_train_step_fn
from bignn.parallel.tp import (
    shard_params_tp,
    tp_param_specs,
    tp_train_step_fn,
)
from bignn.parallel.partition import (
    OuterPartitionPlan,
    build_outer_partition,
    build_sharded_inner,
)
from bignn.parallel.halo import (
    halo_exchange,
    dist_outer_forward,
    p2_overlap_forward,
)
from bignn.parallel.partition import boundary_drugs
from bignn.parallel.step import make_p2_train_step, device_put_plan

__all__ = [
    "make_mesh",
    "make_hybrid_mesh",
    "init_distributed",
    "global_put",
    "shard_pairs",
    "dp_train_step_fn",
    "OuterPartitionPlan",
    "build_outer_partition",
    "build_sharded_inner",
    "halo_exchange",
    "dist_outer_forward",
    "p2_overlap_forward",
    "boundary_drugs",
    "make_p2_train_step",
    "device_put_plan",
    "shard_params_tp",
    "tp_param_specs",
    "tp_train_step_fn",
]
