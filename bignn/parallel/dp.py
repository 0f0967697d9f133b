"""Data parallelism (SURVEY.md §2.3 P1).

The training batch (positive pairs + their PRNG-derived negatives) is sharded
across the 'dp' mesh axis; parameters and graph structure are replicated.
Gradients are averaged by XLA-inserted psum — we express the step with
sharding annotations (GSPMD) rather than translating any collective calls.

Correctness vs single-device is tested on the 8-fake-CPU-device mesh
(SURVEY.md §4 item 4, tests/test_dp.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bignn.data.sampler import sample_negative_pairs
from bignn.models.bignn import BiGNN
from bignn.models.loss import bce_with_logits_loss


def shard_pairs(mesh: Mesh, pairs: jax.Array, mask: jax.Array):
    """Place a [B, 2] pair batch + [B] mask on the dp axis (B % dp == 0)."""
    s_pairs = NamedSharding(mesh, P("dp", None))
    s_mask = NamedSharding(mesh, P("dp"))
    return jax.device_put(pairs, s_pairs), jax.device_put(mask, s_mask)


def dp_train_step_fn(
    model: BiGNN,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    num_drugs: int,
    neg_ratio: int = 1,
) -> Callable:
    """Build a jit'd DP train step.

    Closure signature:
      step(params, opt_state, key, pos_pairs, pos_mask, buckets, graph_index,
           outer) -> (params, opt_state, loss)

    ``pos_pairs`` must be dp-sharded (see :func:`shard_pairs`); params /
    graph structures replicated. XLA inserts the gradient all-reduce.
    """
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

    @partial(
        jax.jit,
        out_shardings=(replicated, replicated, replicated),
    )
    def step(params, opt_state, key, pos_pairs, pos_mask, buckets, graph_index, outer):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, key, pos_pairs, pos_mask, buckets, graph_index, outer
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
