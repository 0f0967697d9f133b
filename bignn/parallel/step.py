"""Full distributed training step: dp x graph mesh (SURVEY.md P1 + P2).

Layout per (dp, graph) mesh cell:
  * inner level    — each 'graph' shard encodes the molecules of its owned
                     drug block locally (zero communication), replicated
                     across 'dp';
  * outer level    — halo all-to-all over 'graph' per layer (parallel/halo);
  * scoring        — final shard embeddings all-gathered over 'graph'
                     (contiguous ownership makes gathered index == global
                     drug id); the pair minibatch is sharded over 'dp';
  * loss/grads     — masked-mean loss psum'd over 'dp'; gradient collectives
                     come from AD transposing the shard_map — nothing is
                     hand-written.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bignn.data.sampler import sample_negative_pairs
from bignn.models.bignn import BiGNN
from bignn.parallel.halo import dist_outer_forward, p2_overlap_forward
from bignn.parallel.partition import OuterPartitionPlan


def make_p2_train_step(
    model: BiGNN,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    num_drugs: int,
    neg_ratio: int = 1,
    overlap: bool = False,
    remat: bool = False,
) -> Callable:
    """Build the jit'd dp x graph train step.

    Closure signature:
      step(params, opt_state, key, pos_pairs, pos_mask,
           inner_batch, edge_src, edge_dst, edge_weight, send_idx)
        -> (params, opt_state, loss)

    ``inner_batch`` is the stacked PaddedGraphBatch from
    parallel.partition.build_sharded_inner; edge_* / send_idx come from the
    OuterPartitionPlan (device_put_plan returns them in call order).
    ``pos_pairs`` [B_glob, 2] with B_glob divisible by the dp axis size.

    ``remat``: rematerialize the two per-shard activation whales in the
    backward (jax.checkpoint) — (a) the inner encode's per-atom activations
    ([node_cap, dim] per conv layer) and (b) the outer GAT's [E, H]
    attention temps — at the cost of one extra inner forward + attention
    recompute per step. Values and gradients are unchanged
    (tests/test_p2_step.py remat case). Use it to fit larger per-shard
    graphs before adding shards.
    """
    encode = (jax.checkpoint(model.encode_inner)
              if remat else model.encode_inner)

    def shard_loss(params, pairs, labels, mask, inner_batch, esrc, edst, ew,
                   sidx):
        # strip the leading per-shard axis kept by shard_map
        if overlap:
            bnd, interior = inner_batch
            h_local = p2_overlap_forward(
                model, params,
                jax.tree.map(lambda x: x[0], bnd),
                jax.tree.map(lambda x: x[0], interior),
                esrc[0], edst[0], ew[0], sidx[0],
                encode_fn=encode, remat=remat,
            )
        else:
            batch = jax.tree.map(lambda x: x[0], inner_batch)
            h_local = encode(params, batch)  # [B, d]
            h_local = dist_outer_forward(
                model, params, h_local, esrc[0], edst[0], ew[0], sidx[0],
                remat=remat,
            )
        emb = jax.lax.all_gather(h_local, "graph", tiled=True)  # [G*B, d]
        logits = model.score_pairs(params, emb, pairs).astype(jnp.float32)
        per = (jnp.maximum(logits, 0.0) - logits * labels
               + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        num = jax.lax.psum(jnp.sum(per * mask), "dp")
        den = jax.lax.psum(jnp.sum(mask), "dp")
        # pmean over 'graph' is a numerical no-op (every graph shard computes
        # the same loss from the gathered embeddings) but makes replication
        # provable for shard_map's out_specs check.
        return jax.lax.pmean(num / jnp.maximum(den, 1.0), "graph")

    def loss_fn(params, key, pos_pairs, pos_mask, inner_batch, esrc, edst,
                ew, sidx):
        sharded_loss = jax.shard_map(
            shard_loss,
            mesh=mesh,
            in_specs=(
                P(),            # params (replicated)
                P("dp", None),  # pairs
                P("dp"),        # labels
                P("dp"),        # mask
                P("graph"),     # inner_batch (prefix spec: all leaves)
                P("graph"), P("graph"), P("graph"), P("graph"),
            ),
            out_specs=P(),
        )
        # Negatives are sampled on the GLOBAL batch, outside shard_map, so
        # results are identical across device counts (SURVEY.md §4 item 6).
        neg = sample_negative_pairs(key, pos_pairs, num_drugs, neg_ratio)
        pairs = jnp.concatenate([pos_pairs, neg], axis=0)
        labels = jnp.concatenate(
            [jnp.ones(pos_pairs.shape[0]), jnp.zeros(neg.shape[0])]
        )
        mask = jnp.concatenate([pos_mask, jnp.tile(pos_mask, (neg_ratio,))])
        return sharded_loss(
            params, pairs, labels, mask, inner_batch, esrc, edst, ew, sidx
        )

    @jax.jit
    def step(params, opt_state, key, pos_pairs, pos_mask,
             inner_batch, esrc, edst, ew, sidx):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, key, pos_pairs, pos_mask, inner_batch, esrc, edst, ew,
            sidx
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_p2_score_fn(
    model: BiGNN,
    mesh: Mesh,
    overlap: bool = False,
) -> Callable:
    """Distributed scorer for evaluation: (params, pairs, inner_batch,
    esrc, edst, ew, sidx) -> logits for dp-sharded global pairs."""

    def shard_score(params, pairs, inner_batch, esrc, edst, ew, sidx):
        if overlap:
            bnd, interior = inner_batch
            h_local = p2_overlap_forward(
                model, params,
                jax.tree.map(lambda x: x[0], bnd),
                jax.tree.map(lambda x: x[0], interior),
                esrc[0], edst[0], ew[0], sidx[0],
            )
        else:
            batch = jax.tree.map(lambda x: x[0], inner_batch)
            h_local = model.encode_inner(params, batch)
            h_local = dist_outer_forward(
                model, params, h_local, esrc[0], edst[0], ew[0], sidx[0],
            )
        emb = jax.lax.all_gather(h_local, "graph", tiled=True)
        logits = model.score_pairs(params, emb, pairs)
        # numerically a no-op (each graph shard scores the same gathered
        # embeddings); makes replication over 'graph' provable
        return jax.lax.pmean(logits, "graph")

    @jax.jit
    def score(params, pairs, inner_batch, esrc, edst, ew, sidx):
        return jax.shard_map(
            shard_score,
            mesh=mesh,
            in_specs=(P(), P("dp", None), P("graph"),
                      P("graph"), P("graph"), P("graph"), P("graph")),
            out_specs=P("dp"),
        )(params, pairs, inner_batch, esrc, edst, ew, sidx)

    return score


def device_put_plan(mesh: Mesh, plan: OuterPartitionPlan, inner_batch):
    """Place the stacked plan arrays on the 'graph' axis, replicated on dp.

    Uses global_put (make_array_from_callback) so the same code path works
    on a multi-host mesh: every process holds the full plan (deterministic
    from the shared seed) and contributes only its addressable shards.

    Returns ``(inner, esrc, edst, ew, sidx)``."""
    from bignn.parallel.mesh import global_put

    put = lambda x: global_put(mesh, P("graph"), x)
    inner = jax.tree.map(put, inner_batch)
    return (
        inner,
        put(plan.edge_src),
        put(plan.edge_dst),
        put(plan.edge_weight),
        put(plan.send_idx),
    )
