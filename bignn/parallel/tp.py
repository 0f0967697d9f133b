"""Tensor parallelism (SURVEY.md §2.3 P3) — feature-dim sharding over 'tp'.

Design: parameters get NamedShardings and XLA's SPMD partitioner
inserts every collective; no hand-written comms. The layout is the standard
Megatron pairing expressed as sharding annotations:

  * inside each MLP (GIN conv MLPs, the pair scorer), even layers are
    column-parallel (``w``: P(None, 'tp'), ``b``: P('tp')) and odd layers
    row-parallel (``w``: P('tp', None), ``b`` replicated) — the activation
    between the pair stays tp-sharded and the partitioner places one
    all-reduce after the row-parallel matmul;
  * standalone conv weights (GCN/GAT ``w``) are column-parallel: the
    feature dimension of every aggregation (SpMM rides on the feature axis)
    is then tp-sharded end-to-end;
  * attention vectors (``a_l``/``a_r``) and any axis not divisible by tp
    stay replicated — the partitioner reshards around them.

When to use: the BI-GNN configs in this repo run hidden dims 64–256.
Sharding dim 128 over tp=8 leaves 16-wide shards — matmuls far too small to
pay for the collectives TP adds (docs/DESIGN.md §4.2). TP pays off when the
hidden dim (or the GIN MLP hidden) grows past ~1–2K per shard; config
presets therefore default to
dp×graph meshes and this module serves wide-model experiments + P3 scope
completeness.

Correctness vs single-device is tested on the 8-fake-CPU-device mesh
(tests/test_tp.py).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bignn.data.sampler import sample_negative_pairs
from bignn.models.bignn import BiGNN
from bignn.models.loss import bce_with_logits_loss


def _is_mlp(d: dict) -> bool:
    """An MLP param dict: layer_i -> {"w": ..., "b": ...} Dense leaves.

    Structure alone cannot distinguish an MLP from a GCN conv stack (a GCN
    layer's params are exactly {"w", "b"} too), so the walk below only
    consults this under the model's MLP-holding keys — ``'mlp'`` (GIN layer
    MLPs, the pair scorer) and ``'gate'`` (AttentionReadout's gate MLP,
    models/readout.py) — while conv stacks hang directly off
    ``'inner'``/``'outer'``. Conv stacks therefore always get the
    column-parallel conv treatment, never Megatron row/col pairing."""
    return (
        isinstance(d, dict)
        and bool(d)
        and all(k.startswith("layer_") for k in d)
        and all(
            isinstance(v, dict) and v and set(v) <= {"w", "b"}
            for v in d.values()
        )
    )


def tp_param_specs(params: dict, tp: int) -> Any:
    """PartitionSpec pytree for a BiGNN param tree (see module docstring).

    Only axes divisible by ``tp`` are sharded; everything else replicates.
    """

    def leaf_spec(name: str, x, col: bool) -> P:
        if name.startswith("w") and getattr(x, "ndim", 0) == 2:
            if col and x.shape[1] % tp == 0:
                return P(None, "tp")
            if not col and x.shape[0] % tp == 0:
                return P("tp", None)
        if name.startswith("b") and getattr(x, "ndim", 0) == 1 and col \
                and x.shape[0] % tp == 0:
            return P("tp")
        return P()

    def mlp_specs(node: dict) -> dict:
        keys = sorted(node, key=lambda s: int(s.split("_")[1]))
        return {
            k: {n: leaf_spec(n, v, col=i % 2 == 0) for n, v in node[k].items()}
            for i, k in enumerate(keys)
        }

    def walk(node, key=""):
        if key in ("mlp", "gate") and _is_mlp(node):
            return mlp_specs(node)
        return {
            k: (walk(v, k) if isinstance(v, dict)
                else leaf_spec(k, v, col=True))
            for k, v in node.items()
        }

    return walk(params)


def shard_params_tp(mesh: Mesh, params: dict) -> dict:
    """Place a param tree on the mesh per :func:`tp_param_specs`."""
    tp = int(mesh.shape["tp"])
    specs = tp_param_specs(params, tp)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs
    )


def tp_train_step_fn(
    model: BiGNN,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    num_drugs: int,
    neg_ratio: int = 1,
) -> Callable:
    """Build a jit'd TP train step (mesh axes: 'tp', optionally 'dp').

    Closure signature matches parallel.dp.dp_train_step_fn:
      step(params, opt_state, key, pos_pairs, pos_mask, buckets, graph_index,
           outer) -> (params, opt_state, loss)

    ``params`` must already be placed via :func:`shard_params_tp` (and
    ``opt_state = jax.jit(optimizer.init)(params)`` so the Adam moments
    inherit the param shardings). GSPMD propagates the tp sharding through
    the forward/backward and inserts all collectives.
    """
    has_dp = "dp" in mesh.axis_names
    replicated = NamedSharding(mesh, P())

    def loss_fn(params, key, pos_pairs, pos_mask, buckets, graph_index, outer):
        neg = sample_negative_pairs(key, pos_pairs, num_drugs, neg_ratio)
        pairs = jnp.concatenate([pos_pairs, neg], axis=0)
        labels = jnp.concatenate(
            [jnp.ones(pos_pairs.shape[0]), jnp.zeros(neg.shape[0])]
        )
        mask = jnp.concatenate([pos_mask, jnp.tile(pos_mask, (neg_ratio,))])
        logits = model.apply(params, buckets, graph_index, outer, pairs)
        return bce_with_logits_loss(logits, labels, mask)

    @jax.jit
    def step(params, opt_state, key, pos_pairs, pos_mask, buckets,
             graph_index, outer):
        if has_dp:
            pos_pairs = jax.lax.with_sharding_constraint(
                pos_pairs, NamedSharding(mesh, P("dp", None)))
        loss, grads = jax.value_and_grad(loss_fn)(
            params, key, pos_pairs, pos_mask, buckets, graph_index, outer
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax.lax.with_sharding_constraint(
            loss, replicated)

    return step
