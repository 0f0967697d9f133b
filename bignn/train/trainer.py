"""Training driver (SURVEY.md T5; reference train loop §2.1 R3, §3.1).

One jit'd train step covers: negative sampling (PRNG-keyed, on device),
full bi-level forward, masked BCE loss, grad, optax update. The epoch loop,
eval hooks and best-model selection mirror the reference's driver
(SURVEY.md §3.1) without its host-side hot loops.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bignn.data.hierarchical import (
    CompactBatch,
    HierarchicalBatch,
    HierarchicalSampler,
)
from bignn.data.sampler import EdgeMinibatchSampler, sample_negative_pairs
from bignn.data.schema import DDIDataset, DeviceData
from bignn.models.bignn import BiGNN
from bignn.models.loss import bce_with_logits_loss
from bignn.sparse.formats import OuterGraph, PaddedGraphBatch
from bignn.train.metrics import average_precision, roc_auc


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3
    epochs: int = 20
    batch_size: int = 256
    neg_ratio: int = 1
    eval_every: int = 1  # epochs
    seed: int = 0
    weight_decay: float = 0.0
    # global-norm gradient clip (0 = off). Verified correct at small
    # scale (tests/CPU); note the r3 config-#4 finding: lr 1e-3 unclipped
    # collapses the model to constant prediction within ~1.5K steps, and
    # clip=1.0 also degraded there — the stable recipe at that scale is
    # simply lr 3e-4 (config.py config4 note).
    grad_clip: float = 0.0
    # OPT-IN per-epoch reshuffle of the device sampler's neighbor lists
    # (DeviceSampler.reshuffle_adj), for long-horizon runs that want
    # explicit window-draw decorrelation. WARNING — measured REGRESSION
    # as a default (r4): at config #4 a 4x500-step run reached test AUC
    # 0.567 with a loss spike at each epoch boundary vs 0.635 with the
    # fixed init-time shuffle (the co-occurrence shift perturbs Adam's
    # moment estimates at the config's borderline lr); the fixed-shuffle
    # window estimator already beats the host iid estimator at equal step
    # budget. Only meaningful with
    # device_sample=True; ignored otherwise.
    reshuffle_epochs: bool = False


def make_optimizer(config: TrainConfig) -> optax.GradientTransformation:
    """The shared optimizer stack: [clip ->] adam/adamw per TrainConfig."""
    opt = (optax.adamw(config.lr, weight_decay=config.weight_decay)
           if config.weight_decay else optax.adam(config.lr))
    if config.grad_clip:
        opt = optax.chain(
            optax.clip_by_global_norm(config.grad_clip), opt)
    return opt


class Trainer:
    """Single-host trainer. Distribution lives in parallel/ (SURVEY.md T6).

    ``mesh`` (a dp-only jax.sharding.Mesh) turns the step data-parallel
    (SURVEY.md §2.3 P1): pair minibatches shard over 'dp', params/graph
    structure replicate, XLA inserts the gradient all-reduce
    (parallel/dp.py). The trajectory equals the single-device one on the
    same global batch (tests/test_dp.py)."""

    def __init__(self, model: BiGNN, data: DeviceData, config: TrainConfig,
                 mesh=None):
        self.model = model
        self.data = data
        self.config = config
        self.optimizer = make_optimizer(config)
        # device-resident graph structures (tuples -> stable pytree structure)
        self.buckets = tuple(jax.tree.map(jnp.asarray, b) for b in data.bucketing.batches)
        self.graph_index = tuple(jnp.asarray(i) for i in data.bucketing.graph_index)
        self.outer = jax.tree.map(jnp.asarray, data.outer)
        self.mesh = mesh
        if mesh is not None:
            import math as _math

            from bignn.parallel.dp import dp_train_step_fn, shard_pairs

            if "dp" not in mesh.axis_names:
                raise ValueError("Trainer DP mesh needs a 'dp' axis")
            dp = int(mesh.shape["dp"])
            if _math.prod(mesh.shape.values()) != dp:
                raise ValueError("Trainer DP mesh must be dp-only")
            if config.batch_size % dp:
                raise ValueError(
                    f"batch_size {config.batch_size} not divisible by dp={dp}")
            dp_step = dp_train_step_fn(
                model, self.optimizer, mesh, data.num_drugs, config.neg_ratio
            )

            def _dp_train_step(params, opt_state, key, pairs, mask):
                pairs, mask = shard_pairs(mesh, pairs, mask)
                return dp_step(params, opt_state, key, pairs, mask,
                               self.buckets, self.graph_index, self.outer)

            self._train_step = _dp_train_step
        else:
            self._train_step = jax.jit(self._step)
        self._score_pairs = jax.jit(self._score)

    # -- jitted bodies ---------------------------------------------------
    def _loss_fn(self, params, key, pos_pairs, pos_mask):
        neg = sample_negative_pairs(
            key, pos_pairs, self.data.num_drugs, self.config.neg_ratio
        )
        pairs = jnp.concatenate([pos_pairs, neg], axis=0)
        labels = jnp.concatenate(
            [jnp.ones(pos_pairs.shape[0]), jnp.zeros(neg.shape[0])]
        )
        mask = jnp.concatenate([pos_mask, jnp.tile(pos_mask, (self.config.neg_ratio,))])
        logits = self.model.apply(
            params, self.buckets, self.graph_index, self.outer, pairs
        )
        return bce_with_logits_loss(logits, labels, mask)

    def _step(self, params, opt_state, key, pos_pairs, pos_mask):
        loss, grads = jax.value_and_grad(self._loss_fn)(params, key, pos_pairs, pos_mask)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def _score(self, params, pairs):
        return self.model.apply(
            params, self.buckets, self.graph_index, self.outer, pairs
        )

    # -- host loop -------------------------------------------------------
    def init(self, key: jax.Array | None = None):
        key = key if key is not None else jax.random.key(self.config.seed)
        params = self.model.init(key)
        opt_state = self.optimizer.init(params)
        return params, opt_state

    def evaluate(self, params, split: str = "val", neg_seed: int = 1234,
                 on_device: bool = False) -> dict:
        """Score held-out positives + an equal number of sampled negatives
        (SURVEY.md §3.3). ``on_device=True`` computes sort-based AUC/AP in
        jnp without funneling scores to the host — the at-scale path
        (SURVEY.md §7 "AUC/AP at scale"); the default uses the exact
        tie-aware host implementation."""
        pos = {"val": self.data.val_pairs, "test": self.data.test_pairs,
               "train": self.data.train_pairs}[split]
        pos = jnp.asarray(pos)
        key = jax.random.key(neg_seed)
        neg = sample_negative_pairs(key, pos, self.data.num_drugs, 1)
        pairs = jnp.concatenate([pos, neg], axis=0)
        scores_dev = self._score_pairs(params, pairs)
        labels = np.concatenate([np.ones(pos.shape[0]), np.zeros(neg.shape[0])])
        if on_device:
            from bignn.train.metrics import average_precision_jnp, roc_auc_jnp

            lab = jnp.asarray(labels)
            return {
                f"{split}_auc": float(roc_auc_jnp(lab, scores_dev)),
                f"{split}_ap": float(average_precision_jnp(lab, scores_dev)),
            }
        scores = np.asarray(scores_dev)
        return {
            f"{split}_auc": roc_auc(labels, scores),
            f"{split}_ap": average_precision(labels, scores),
        }

    def fit(
        self,
        params=None,
        opt_state=None,
        log_fn: Callable[[dict], None] | None = None,
        ckpt=None,
        checkpoint_every: int = 1,
    ) -> tuple[Any, dict]:
        """Full training run; returns (best_params, history).

        ``ckpt`` (a train.checkpoint.CheckpointManager) enables periodic
        checkpointing + exact resume: every epoch's randomness is derived
        from (seed, epoch) — fold_in for the device PRNG, per-epoch-seeded
        shuffles on the host — so restoring {params, opt_state, epoch, best}
        reproduces the uninterrupted loss trajectory bit-for-bit (tested in
        tests/test_checkpoint_resume.py). On resume, ``history`` covers only
        the epochs run in this process."""
        cfg = self.config
        if params is None:
            params, opt_state = self.init()
        sampler = EdgeMinibatchSampler(self.data.train_pairs, cfg.batch_size, cfg.seed)
        base_key = jax.random.key(cfg.seed + 1)
        best = {"val_auc": -1.0, "params": params, "epoch": -1}
        start_epoch = 0
        if ckpt is not None:
            restored = ckpt.restore_state(_fit_state(params, opt_state, best))
            if restored is not None:
                params, opt_state, best, start_epoch = _unpack_fit_state(restored)
        history = []
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            losses = []
            ekey = jax.random.fold_in(base_key, epoch)
            for i, (pairs, mask) in enumerate(sampler.epoch(epoch)):
                params, opt_state, loss = self._train_step(
                    params, opt_state, jax.random.fold_in(ekey, i),
                    jnp.asarray(pairs), jnp.asarray(mask)
                )
                losses.append(loss)
            rec = {
                "epoch": epoch,
                "loss": float(jnp.mean(jnp.stack(losses))),
                "epoch_time_s": time.perf_counter() - t0,
            }
            if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
                rec.update(self.evaluate(params, "val"))
                if rec["val_auc"] > best["val_auc"]:
                    best = {"val_auc": rec["val_auc"], "params": params, "epoch": epoch}
            history.append(rec)
            if log_fn:
                log_fn(rec)
            if ckpt is not None and (epoch + 1) % checkpoint_every == 0:
                ckpt.save_state(epoch, _fit_state(params, opt_state, best, epoch))
        final = self.evaluate(best["params"], "test")
        return best["params"], {"history": history, "best_epoch": best["epoch"], **final}


def _fit_state(params, opt_state, best, epoch: int = 0) -> dict:
    """Full training state pytree for periodic checkpointing (both trainers)."""
    return {
        "params": params,
        "opt_state": opt_state,
        "best_params": best["params"],
        "meta": {
            "epoch": epoch,
            "best_val_auc": float(best["val_auc"]),
            "best_epoch": int(best["epoch"]),
        },
    }


def _unpack_fit_state(state: dict):
    best = {
        "val_auc": float(state["meta"]["best_val_auc"]),
        "params": state["best_params"],
        "epoch": int(state["meta"]["best_epoch"]),
    }
    return state["params"], state["opt_state"], best, int(state["meta"]["epoch"]) + 1


class MinibatchTrainer:
    """Hierarchical mini-batch trainer (SURVEY.md T4/T5; configs #3-4).

    Each step trains on a host-sampled L-hop subgraph around the pair batch
    (data/hierarchical.py) instead of the full graph; shapes are static so
    the step compiles once. Evaluation reuses the same machinery: held-out
    pairs are scored in fixed-size chunks with their sampled neighborhoods.
    """

    def __init__(
        self,
        model: BiGNN,
        ds: DDIDataset,
        config: TrainConfig,
        fanouts: tuple[int, ...] = (10,),
        max_drugs: int | None = None,
        resident: bool = True,
        calibrate_caps: int = 8,
        mesh=None,
        prefetch_workers: int = 2,
        dispatch_chunk: int = 1,
        device_sample: bool = False,
    ):
        """``resident=True`` (default) uploads the per-molecule tables to the
        device once and ships only index-sized batches per step (CompactBatch
        + on-device ragged expansion) — at config-#4 scale the host->device
        feature transfer otherwise dominates the step.

        ``mesh`` (a jax.sharding.Mesh with a 'dp' axis, all other axes size
        1) turns on data parallelism (SURVEY.md §2.3 P1 x §2.4 T4): each step
        samples one batch PER dp shard, shards them over 'dp' with shard_map,
        and psums the (sum, count) loss pair so the update equals a
        single-device step on the union batch (tests/test_dp_minibatch.py).
        Tables and params stay replicated; gradient collectives come from AD.
        """
        self.model = model
        self.ds = ds
        self.config = config
        self.resident = resident
        self.prefetch_workers = prefetch_workers
        self.mesh = mesh
        if mesh is not None:
            import math

            if "dp" not in mesh.axis_names:
                raise ValueError("minibatch DP mesh needs a 'dp' axis")
            self.dp = int(mesh.shape["dp"])
            if math.prod(mesh.shape.values()) != self.dp:
                raise ValueError(
                    "minibatch DP mesh must be dp-only (other axes size 1)")
        else:
            self.dp = 1
        # superrow-quantized tables put masked padding between molecules
        # (breaks strict dst-sortedness) — valid because every inner conv
        # kind rides a block-local path: GIN/GCN via the dense block-diagonal
        # adjacency, GAT/DotAttn via per-block dense masked attention
        # (models/convs.py block_dense)
        block_capable = all(
            spec.split(":")[0] in ("gin", "gcn", "gat", "dotattn")
            for spec in model.config.inner_layers
        )
        # dense-inner fast path: build the block-diagonal adjacency ONCE per
        # step on device (ops.block_adjacency), then every inner
        # aggregation pass (fwd + bwd x layers) is a batched 128x128
        # matmul instead of a gather and a scatter per edge
        self.dense_inner = block_capable
        self.sampler = HierarchicalSampler(
            ds,
            batch_size=config.batch_size,
            neg_ratio=config.neg_ratio,
            fanouts=fanouts,
            seed=config.seed,
            max_drugs=max_drugs,
            calibrate_caps=calibrate_caps,
            quantize=block_capable,
        )
        self.optimizer = make_optimizer(config)
        if resident:
            tables = self.sampler.tables()
            if model.compute_dtype == jnp.bfloat16:
                # bf16 feature table: halves the expansion's feature-gather
                # HBM traffic and feeds the convs their compute dtype
                tables = tables.replace(
                    feat=tables.feat.astype(jnp.bfloat16))
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                tables = jax.device_put(
                    jax.tree.map(np.asarray, tables),
                    NamedSharding(mesh, P()))
            self.tables = jax.tree.map(jnp.asarray, tables)
        else:
            self.tables = None
        self._full_outer_cached = None
        self._exact_fns = None
        self._chunk_step = None
        self._device_chunk_fn = None
        self._metrics_jit = None
        self.dispatch_chunk = int(dispatch_chunk)
        self.device_sample = bool(device_sample)
        if device_sample:
            # fully device-resident sampling: the epoch is a device-only
            # scan (data/device_sampler.py) — per-step host work and H2D
            # drop to zero, so sustained == the device scan ceiling. Under
            # a dp mesh, each shard draws its own batch INSIDE shard_map
            # (key = (seed, epoch, step*dp + shard)), matching the host
            # path's batch numbering — zero host sampling at pod scale.
            if not resident:
                raise ValueError("device_sample requires resident tables")
            from bignn.data.device_sampler import DeviceSampler

            self.dsampler = DeviceSampler(self.sampler)
            consts = self.dsampler.constants()
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                consts = jax.device_put(consts, NamedSharding(mesh, P()))
            self._dev_consts = jax.tree.map(jnp.asarray, consts)
            # the epoch-0 constants, kept so the opt-in per-epoch
            # reshuffle (TrainConfig.reshuffle_epochs) always derives
            # epoch e's adjacency from the INIT shuffle — a pure function
            # of (seed, epoch), so kill-and-resume at any epoch is exact
            self._dev_consts0 = self._dev_consts
        if mesh is None:
            self._train_step = jax.jit(self._step)
            self._score_batch = jax.jit(self._score)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(mesh, P())
            self._dp_sharding = NamedSharding(mesh, P("dp"))
            self._train_step = self._make_dp_step()
            # eval stays logically single-stream: replicated in/out shardings
            # keep the mesh-resident tables usable without a reshard
            self._score_batch = jax.jit(
                self._score, in_shardings=rep, out_shardings=rep)

    # -- device-side ragged expansion (resident path) --------------------
    @staticmethod
    def _rank_slots(cum: jax.Array, length: int) -> jax.Array:
        """slot[p] = #{d : cum[d] <= p} == searchsorted(cum, p, 'right'),
        for p in [0, length) — computed as scatter-add + one cumsum pass.
        jnp.searchsorted's scan lowering makes log2(D) full-length gather
        passes; this is one pass.
        """
        ind = jnp.zeros(length + 1, jnp.int32).at[
            jnp.minimum(cum, length)
        ].add(1, mode="drop")
        return jnp.cumsum(ind[:length])

    def _expand_compact(self, cb: CompactBatch, tb) -> PaddedGraphBatch:
        """CompactBatch (indices) -> PaddedGraphBatch, entirely on device.

        Rows of each sampled molecule are located with cumsum + a one-pass
        rank computation (static shapes); because per-molecule edge blocks
        are pre-sorted by local dst and offsets increase monotonically, the
        expanded edge list is globally dst-sorted (up to masked quantization
        padding) with zero per-step sorting.

        Gather discipline: all table data is fetched through TWO SUPERROW gathers — one
        [EC/r_e, r_e*8] over the packed molecule edge table and one
        [NC/r_n, r_n*F] over the feature table (quantized layouts, see
        MoleculeTables) — plus two small per-slot side-table row gathers at
        superrow granularity, in place of narrow per-edge 1D gathers (a
        layout chosen on earlier hardware; not re-measured on the H100).
        r_e = r_n = 1 degenerates to exact (non-quantized) tables for layouts that need
        strict global dst-sortedness (e.g. GAT inner convs).
        """
        D, NC, EC = cb.drug_budget, cb.node_cap, cb.edge_cap
        s = self.sampler
        block_local = getattr(s, "block_local", False)
        R_N = getattr(s, "r_node", 1)
        R_E = getattr(s, "r_edge", 1)
        NCs, ECs = NC // R_N, EC // R_E

        def rep(x, r):  # expand a per-superrow value to per-row
            if r == 1:
                return x
            return jnp.broadcast_to(x[:, None], (x.shape[0], r)).reshape(-1)

        nodes = cb.nodes.astype(jnp.int32)
        slot_valid = jnp.arange(D) < cb.n_real
        mol_ptr = tb.mol_ptr.astype(jnp.int32)  # quantized
        qstart = jnp.take(mol_ptr, nodes, mode="clip")  # [D]
        n_q = jnp.where(
            slot_valid, jnp.take(mol_ptr, nodes + 1, mode="clip") - qstart, 0)
        n_x = jnp.where(
            slot_valid, jnp.take(tb.mol_ncnt.astype(jnp.int32), nodes,
                                 mode="clip"), 0)
        if block_local:
            # host greedy packing (native.greedy_pack_blocks): molecules
            # never straddle 128-row blocks, offsets strictly increase
            # across real slots, all multiples of r_node.
            off = cb.pack_off.astype(jnp.int32)
        else:
            cum = jnp.cumsum(n_q)
            off = jnp.concatenate([jnp.zeros(1, cum.dtype), cum[:-1]])
        # slot of each node superrow: rank over superrow-granular offsets
        # (empty/padding slots rank to NCs and are masked below)
        off_eff = jnp.where(n_q > 0, off // R_N, NCs)
        slot_s = jnp.maximum(self._rank_slots(off_eff, NCs) - 1, 0)  # [NCs]
        slot_sc = jnp.minimum(slot_s, D - 1)
        node_tbl = jnp.stack([off, n_x, qstart], axis=1)  # [D, 3]
        nrow = jax.lax.optimization_barrier(
            jnp.take(node_tbl, slot_sc, axis=0, mode="clip"))  # [NCs, 3]
        # feature superrow gather: qstart and off are r_node-multiples, so
        # superrow index = qstart/r_n + (superrow pos - off/r_n)
        sr_idx = nrow[:, 2] // R_N + (
            jnp.arange(NCs, dtype=jnp.int32) - nrow[:, 0] // R_N)
        feat_s = jax.lax.optimization_barrier(jnp.take(
            tb.feat, jnp.clip(sr_idx, 0, tb.feat.shape[0] - 1), axis=0))
        F = tb.feat.shape[1] // R_N
        row_pos = jnp.arange(NC, dtype=jnp.int32)
        slot_c = rep(slot_sc, R_N)
        local_row = row_pos - rep(nrow[:, 0], R_N)
        row_valid = (local_row >= 0) & (local_row < rep(nrow[:, 1], R_N))
        node_feat = jnp.where(row_valid[:, None], feat_s.reshape(NC, F), 0.0)
        graph_ids = jnp.where(row_valid, slot_c, D).astype(jnp.int32)

        eptr = tb.mol_eptr.astype(jnp.int32)  # quantized
        qe = jnp.take(eptr, nodes, mode="clip")  # [D]
        e_q = jnp.where(
            slot_valid, jnp.take(eptr, nodes + 1, mode="clip") - qe, 0)
        e_x = jnp.where(
            slot_valid, jnp.take(tb.mol_ecnt.astype(jnp.int32), nodes,
                                 mode="clip"), 0)
        ecum = jnp.cumsum(e_q)
        ecum0 = jnp.concatenate([jnp.zeros(1, ecum.dtype), ecum])  # [D+1]
        eslot_s = self._rank_slots(ecum // R_E, ECs)  # [ECs] in [0, D]
        # per-slot side table, one superrow-granular row gather for all four
        # fields. Row D (tail padding) is only read by masked outputs.
        edge_tbl = jnp.stack([
            jnp.pad(off, (0, 1)),  # node offset of the molecule
            jnp.pad(qe, (0, 1)),  # table edge-row start (quantized)
            ecum0,  # batch edge offset (quantized)
            jnp.pad(e_x, (0, 1)),  # exact edge count (validity)
        ], axis=1)  # [D+1, 4]
        erow = jax.lax.optimization_barrier(
            jnp.take(edge_tbl, eslot_s, axis=0, mode="clip"))  # [ECs, 4]
        esr_idx = erow[:, 1] // R_E + (
            jnp.arange(ECs, dtype=jnp.int32) - erow[:, 2] // R_E)
        packed_s = jax.lax.optimization_barrier(jnp.take(
            tb.edge_packed,
            jnp.clip(esr_idx, 0, tb.edge_packed.shape[0] - 1), axis=0))
        # superrows are FIELD-MAJOR ([R_E src][R_E dst]... — see tables()):
        # each field is a contiguous slice of the gather output, so the 8
        # column extractions below are free reshapes, not a [EC,8]
        # transpose (which XLA materialized at ~8 ms/step at config-#4
        # scale when these feed the SpMM kernel).
        pf = packed_s.reshape(ECs, 8, R_E)

        def col(j):
            return pf[:, j, :].reshape(EC)

        epos = jnp.arange(EC, dtype=jnp.int32)
        node_off = rep(erow[:, 0], R_E)
        ecum0e = rep(erow[:, 2], R_E)
        evalid = (epos - ecum0e) < rep(erow[:, 3], R_E)
        edge_src = jnp.where(evalid, col(0) + node_off, 0)
        edge_dst = jnp.where(evalid, col(1) + node_off, NC)
        edge_w = jnp.where(
            evalid, jax.lax.bitcast_convert_type(col(2), jnp.float32),
            0.0,
        )
        dense_inner = block_local and getattr(self, "dense_inner", False)
        if not dense_inner and getattr(s, "quantized", False) and (
            {sp.split(":")[0] for sp in self.model.config.inner_layers}
            & {"gat", "dotattn"}
        ):
            raise ValueError(
                "GAT/DotAttn inner convs on quantized tables require the "
                "dense-inner path (quantized layouts break the strict "
                "dst-sortedness the sparse attention ops need)")
        if dense_inner:
            # the dense-inner path needs no src-sort permutation and no
            # transposed edge stream (AD transposes the block-diagonal
            # matmul for free) — skipping them keeps ~33 MB/step of dead
            # fields out of the expansion barrier's materialization
            sperm = ssorted = None
        else:
            # source-sort permutation, expanded from the per-molecule
            # tables: block b of the batch edge list holds molecule b's
            # edges, so (batch edge offset) + (local src-sorted position)
            # enumerates the real batch edges in GLOBAL src order (offsets
            # increase monotonically); padding positions map to themselves
            # with segment id NC (dropped), so sperm stays a permutation of
            # [0, EC).
            sperm = jnp.where(evalid, ecum0e + col(3), epos)
            ssorted = jnp.where(evalid, col(4) + node_off, NC)
        block = {}
        if dense_inner:
            from bignn.ops import block_adjacency

            kinds = {s.split(":")[0]
                     for s in self.model.config.inner_layers}
            dt = self.model.compute_dtype
            cnt = adj = None
            if kinds & {"gin", "gat", "dotattn"}:
                # int8 storage: counts are small integers, and every
                # consumer either compares (cnt > 0), promotes
                # (cnt * exp), or casts inside block_diag_spmm, where the
                # int8->bf16 convert fuses into the batched dot. A superrow
                # pair's multiplicity is bounded by r_node^2 (every
                # quantized row pair between two molecules of r_node rows),
                # so int8 is exact only when r_node^2 <= 127 — guard it
                # (an f32->int8 cast would wrap silently; parity covered by
                # test_block_adj.py int8 case).
                cdt = jnp.int8 if R_N * R_N <= 127 else jnp.int16
                cnt = jax.lax.stop_gradient(block_adjacency(
                    edge_src, edge_dst, None, NC, cdt))
            if "gcn" in kinds:
                adj = jax.lax.stop_gradient(block_adjacency(
                    edge_src, edge_dst, edge_w, NC, dt))
            block = dict(
                block_adj=adj if adj is not None else cnt,
                block_cnt=cnt if cnt is not None else adj,
            )
        return PaddedGraphBatch(
            node_feat=node_feat,
            node_mask=row_valid.astype(jnp.float32),
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_weight=edge_w,
            graph_ids=graph_ids,
            graph_n_nodes=n_x.astype(jnp.float32),
            num_graphs=D,
            node_cap=NC,
            edge_cap=EC,
            edge_src_perm=sperm,
            edge_src_sorted=ssorted,
            **block,
        )

    # -- jitted bodies ---------------------------------------------------
    def _forward(self, params, hb, tables=None):
        if isinstance(hb, CompactBatch):
            # tables are jit ARGUMENTS (device-resident), never closure
            # constants — embedding them in the HLO blows up compilation
            pb = self._expand_compact(hb, tables)
            # Materialize the expanded batch ONCE. Without this fence XLA
            # re-fuses pieces of the expansion chain (superrow gathers +
            # unpack) into each downstream consumer (the fence's effect has
            # not been measured on the H100).
            pb = jax.lax.optimization_barrier(pb)
        else:
            pb = PaddedGraphBatch(
                node_feat=hb.node_feat,
                node_mask=jnp.ones(hb.node_cap, jnp.float32),
                edge_src=hb.edge_src,
                edge_dst=hb.edge_dst,
                edge_weight=hb.edge_weight,
                graph_ids=hb.graph_ids,
                graph_n_nodes=hb.graph_n_nodes,
                num_graphs=hb.drug_budget,
                node_cap=hb.node_cap,
                edge_cap=hb.edge_cap,
                edge_src_perm=getattr(hb, "edge_src_perm", None),
                edge_src_sorted=getattr(hb, "edge_src_sorted", None),
            )
        emb = self.model.encode_inner(params, pb)
        emb = self.model.propagate_outer(
            params, emb, self._derive_outer(hb, tables))
        return self.model.score_pairs(
            params, emb, hb.pairs.astype(jnp.int32))

    def _derive_outer(self, hb, tables=None) -> OuterGraph:
        """Outer subgraph from the batch, deriving on device what the compact
        path no longer ships (H2D minimization — CompactBatch docstring):
        GCN edge weights from the resident inv_sqrt_deg table
        (invdeg[src]*invdeg[dst], matching the host's global-degree weights)
        and the src-sort permutation via stable argsort (identical to the
        host's np.argsort(kind='stable'), sparse/formats.src_sort_arrays)."""
        osrc = hb.outer_src.astype(jnp.int32)
        odst = hb.outer_dst.astype(jnp.int32)
        D = hb.drug_budget
        if getattr(hb, "outer_weight", None) is None:
            gw = jnp.take(
                tables.inv_sqrt_deg, hb.nodes.astype(jnp.int32), mode="clip")
            w = jnp.where(
                odst < D,
                jnp.take(gw, jnp.minimum(osrc, D - 1))
                * jnp.take(gw, jnp.minimum(odst, D - 1)),
                0.0,
            )
        else:
            w = hb.outer_weight
        operm = getattr(hb, "outer_src_perm", None)
        osorted = getattr(hb, "outer_src_sorted", None)
        if operm is not None:
            operm = operm.astype(jnp.int32)
            osorted = osorted.astype(jnp.int32)
        elif getattr(hb, "outer_weight", None) is None:
            # host compact path ships neither: derive the stable src-sort
            # on device (identical to np.argsort(kind='stable'))
            operm = jnp.argsort(osrc, stable=True).astype(jnp.int32)
            osorted = jnp.take(osrc, operm)
        return OuterGraph(
            edge_src=osrc,
            edge_dst=odst,
            edge_weight=w,
            num_nodes=D,
            edge_cap=hb.outer_edge_cap,
            edge_src_perm=operm,
            edge_src_sorted=osorted,
        )

    def _loss(self, params, hb, tables=None):
        logits = self._forward(params, hb, tables)
        return bce_with_logits_loss(logits, hb.labels, hb.mask)

    def _step(self, params, opt_state, hb, tables=None):
        loss, grads = jax.value_and_grad(self._loss)(params, hb, tables)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def _score(self, params, hb, tables=None):
        return self._forward(params, hb, tables)

    # -- data-parallel step (mesh is not None) ----------------------------
    def _make_dp_step(self):
        """shard_map dp step: one sampled batch per shard, global masked-mean
        loss via psum'd (sum, count); grads come from AD of the shard_map.
        The single-vs-multi-device equality test covers values."""
        from jax.sharding import PartitionSpec as P

        from bignn.models.loss import bce_with_logits_elementwise

        def shard_loss(params, hb, tables):
            hb = jax.tree.map(lambda x: x[0], hb)  # strip the shard axis
            logits = self._forward(params, hb, tables)
            per = bce_with_logits_elementwise(logits, hb.labels)
            num = jax.lax.psum(jnp.sum(per * hb.mask), "dp")
            den = jax.lax.psum(jnp.sum(hb.mask), "dp")
            return num / jnp.maximum(den, 1.0)

        sharded_loss = jax.shard_map(
            shard_loss,
            mesh=self.mesh,
            in_specs=(P(), P("dp"), P()),
            out_specs=P(),
        )
        self._dp_sharded_loss = sharded_loss  # reused by train_chunk's scan

        def step(params, opt_state, hbs, tables):
            loss, grads = jax.value_and_grad(sharded_loss)(params, hbs, tables)
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return jax.jit(step)

    def _draw_host(self, at: tuple[int, int] | None = None):
        """Sample one step's NumPy batch: a single batch, or (dp mode) one
        batch per shard stacked on a leading dp axis. Pure host work — safe
        to run on prefetch threads (data/prefetch.py).

        ``at=(epoch, step)`` uses the indexed, order-independent draws
        (sampler.sample_compact_at) so fit() can sample CONCURRENTLY with a
        deterministic trajectory; None keeps the sequential-RNG draw."""
        s = self.sampler
        if at is None:
            draw = s.sample_compact if self.resident else s.sample
            batches = [draw() for _ in range(self.dp)]
        else:
            epoch, step = at
            draw = s.sample_compact_at if self.resident else s.sample_at
            batches = [
                draw(epoch, step * self.dp + i) for i in range(self.dp)
            ]
        if self.mesh is None:
            return batches[0]
        return jax.tree.map(lambda *xs: np.stack(xs), *batches)

    def _to_device(self, hb):
        if self.mesh is not None:
            return jax.device_put(hb, self._dp_sharding)
        return jax.tree.map(jnp.asarray, hb)

    def _draw_stacked(self, draw=None):
        """Sample self.dp batches, stacked + placed with a P('dp') sharding."""
        assert self.mesh is not None
        return self._to_device(self._draw_host())

    def train_step(self, params, opt_state, hb=None):
        """One optimizer step; samples a fresh batch (or one per dp shard)
        unless ``hb`` is given. Used by fit(), the driver dryrun and tests."""
        if hb is None:
            hb = self._to_device(self._draw_host())
        return self._train_step(params, opt_state, hb, self.tables)

    def train_chunk(self, params, opt_state, hbs):
        """K sequential optimizer steps in ONE dispatch: ``hbs`` carries a
        leading chunk axis; a jitted lax.scan applies the K updates in
        order, so the trajectory is identical to K train_step calls
        (tests/test_dispatch_chunk.py) while fixed per-dispatch costs —
        launch and host-to-device overhead — are paid once per K steps.
        Returns (params, opt_state, losses[K])."""
        if self._chunk_step is None:
            def chunk(params, opt_state, hbs, tables):
                def body(carry, hb):
                    p, o = carry
                    p, o, loss = (
                        self._dp_scan_body(p, o, hb, tables)
                        if self.mesh is not None
                        else self._step(p, o, hb, tables))
                    return (p, o), loss
                (params, opt_state), losses = jax.lax.scan(
                    body, (params, opt_state), hbs)
                return params, opt_state, losses

            self._chunk_step = jax.jit(chunk)
        return self._chunk_step(params, opt_state, hbs, self.tables)

    def _dp_device_loss(self):
        """shard_map loss with PER-SHARD on-device sampling: shard s of
        step i draws batch (epoch, i*dp + s) — the host dp path's exact
        batch numbering — and the (sum, count) psum makes the update equal
        a single-device step on the union batch
        (tests/test_dp_device_sample.py)."""
        from jax.sharding import PartitionSpec as P

        from bignn.models.loss import bce_with_logits_elementwise

        dev = self.dsampler

        def shard_loss(params, epoch, step, tables, consts):
            s = jax.lax.axis_index("dp")
            cb, stats = dev.sample(
                consts, dev.key_at(epoch, step * self.dp + s))
            logits = self._forward(params, cb, tables)
            per = bce_with_logits_elementwise(logits, cb.labels)
            num = jax.lax.psum(jnp.sum(per * cb.mask), "dp")
            den = jax.lax.psum(jnp.sum(cb.mask), "dp")
            stats = jax.tree.map(lambda x: jax.lax.psum(x, "dp"), stats)
            return num / jnp.maximum(den, 1.0), stats

        return jax.shard_map(
            shard_loss,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
        )

    def train_chunk_device(self, params, opt_state, epoch, step0,
                           k: int | None = None):
        """``k`` optimizer steps with ON-DEVICE sampling in one dispatch: a
        jitted lax.scan whose body samples batch (epoch, step0+j) via
        DeviceSampler (pure function of (seed, epoch, step) — deterministic
        and resume-exact like the host path) and applies one update; under
        a dp mesh each shard samples its own batch (see _dp_device_loss).
        Zero per-step host work or H2D. Returns (params, opt_state,
        losses[k], stats) with stats summed over the chunk (device
        scalars). One compilation per distinct ``k`` (the epoch tail)."""
        K = int(k if k is not None else max(1, self.dispatch_chunk))
        if self._device_chunk_fn is None:
            self._device_chunk_fn = {}
        if K not in self._device_chunk_fn:
            dp_loss = self._dp_device_loss() if self.mesh is not None else None

            def chunk(params, opt_state, epoch, step0, tables, consts):
                def body(carry, i):
                    p, o = carry
                    if dp_loss is None:
                        cb, stats = self.dsampler.sample(
                            consts, self.dsampler.key_at(epoch, i))
                        p, o, loss = self._step(p, o, cb, tables)
                    else:
                        (loss, stats), grads = jax.value_and_grad(
                            dp_loss, has_aux=True)(
                                p, epoch, i, tables, consts)
                        updates, o = self.optimizer.update(grads, o, p)
                        p = optax.apply_updates(p, updates)
                    return (p, o), (loss, stats)

                (params, opt_state), (losses, stats) = jax.lax.scan(
                    body, (params, opt_state), step0 + jnp.arange(K))
                return params, opt_state, losses, jax.tree.map(
                    jnp.sum, stats)

            self._device_chunk_fn[K] = jax.jit(chunk)
        return self._device_chunk_fn[K](
            params, opt_state, epoch, step0, self.tables, self._dev_consts)

    def _fit_epoch_device(self, params, opt_state, epoch, n_steps):
        """One epoch over the device-sampling scan; losses and truncation
        stats stay on device until the epoch ends (no per-chunk D2H)."""
        # NOTE (r4, measured): per-epoch neighbor-list reshuffling
        # (DeviceSampler.reshuffle_adj) is NOT applied by default. It is
        # mechanically sound (segment multisets invariant, tested at
        # config-#4 scale) but measurably HURTS learning: 4x500 steps at
        # config #4 reached test AUC 0.567 with a loss spike at an epoch
        # boundary vs 0.635 without it —
        # the co-occurrence shift at each boundary perturbs Adam's moment
        # estimates at the config's borderline lr. The fixed-shuffle
        # window estimator itself BEATS the host iid estimator at equal
        # budget, so window co-occurrence needs no mitigation. Long-horizon
        # runs that want explicit decorrelation can opt in via
        # TrainConfig.reshuffle_epochs (r5).
        if getattr(self.config, "reshuffle_epochs", False):
            self._dev_consts = self.dsampler.reshuffle_adj(
                self._dev_consts0, epoch)
        K = max(1, self.dispatch_chunk)
        loss_chunks, stat_chunks = [], []
        step = 0
        while step + K <= n_steps:
            params, opt_state, ls, st = self.train_chunk_device(
                params, opt_state, epoch, step)
            loss_chunks.append(ls)
            stat_chunks.append(st)
            step += K
        if step < n_steps:  # epoch tail: one shorter chunk (own compile)
            params, opt_state, ls, st = self.train_chunk_device(
                params, opt_state, epoch, step, k=n_steps - step)
            loss_chunks.append(ls)
            stat_chunks.append(st)
        losses = jnp.concatenate(loss_chunks) if loss_chunks else jnp.zeros(0)
        stats = jax.tree.map(
            lambda *xs: int(np.sum([np.asarray(x) for x in xs])),
            *stat_chunks) if stat_chunks else {}
        for k, v in stats.items():
            self.sampler.truncation[k] = self.sampler.truncation.get(k, 0) + v
        # the device-calibrated node cap is a statistical max over
        # simulated real draws (DeviceSampler._calibrate_node_hops);
        # persistent truncation means the real class mix runs larger than
        # calibrated — a standing estimator bias worth surfacing, not a
        # rare-tail event
        if stats.get("trunc_ncap_dropped", 0) > 0 and not getattr(
                self, "_warned_ncap", False):
            self._warned_ncap = True
            import warnings

            warnings.warn(
                f"device sampler node cap truncated "
                f"{stats['trunc_ncap_dropped']} molecules this epoch; "
                "persistent drops bias the estimator — raise the "
                "calibration margin/draws (DeviceSampler._calibrate_"
                "node_hops) or the host node_cap", RuntimeWarning)
        return params, opt_state, losses

    def _dp_scan_body(self, params, opt_state, hb, tables):
        loss, grads = jax.value_and_grad(self._dp_sharded_loss)(
            params, hb, tables)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    def _flush(self, params, opt_state, pending, losses):
        """Dispatch the buffered host batches: one chunked scan when full,
        per-step calls for a short tail (avoids a second scan compilation
        per tail length)."""
        if len(pending) == self.dispatch_chunk and len(pending) > 1:
            stacked = jax.tree.map(lambda *xs: np.stack(xs), *pending)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                # chunk axis leads; the dp axis moved to axis 1
                hbs = jax.device_put(
                    stacked, NamedSharding(self.mesh, P(None, "dp")))
            else:
                hbs = jax.tree.map(jnp.asarray, stacked)
            params, opt_state, ls = self.train_chunk(params, opt_state, hbs)
            losses.extend(list(ls))
        else:
            for hb in pending:
                params, opt_state, loss = self.train_step(
                    params, opt_state, self._to_device(hb))
                losses.append(loss)
        pending.clear()
        return params, opt_state, losses

    # -- host loop -------------------------------------------------------
    def init(self, key=None):
        key = key if key is not None else jax.random.key(self.config.seed)
        params = self.model.init(key)
        return params, self.optimizer.init(params)

    def evaluate(self, params, split: str = "val", neg_seed: int = 1234,
                 exact: bool = False) -> dict:
        """Score held-out positives + sampled negatives.

        Default: fanout-sampled neighborhoods (the training estimator —
        metrics depend on sampler randomness). ``exact=True`` runs FULL
        propagation — every molecule encoded, one outer pass over the whole
        train graph — so reported metrics are estimator-free; matches the
        full-graph Trainer allclose (tests/test_exact_eval.py). Negatives are
        drawn identically in both modes, so the two are comparable.

        Scores STAY ON DEVICE end to end: per-chunk
        score arrays are concatenated on device and fed to the exact
        tie-aware device metrics (train/metrics.py roc_auc_jnp /
        average_precision_jnp, == host sklearn-style values,
        tests/test_metrics.py); only the two metric scalars cross to host —
        at config-#4 eval sizes the per-epoch score funnel disappears."""
        pos = self.ds.split_edges(split).astype(np.int64)
        rng = np.random.default_rng(neg_seed)
        corrupt_right = rng.random(len(pos)) < 0.5
        rand = rng.integers(0, self.ds.num_drugs, len(pos))
        neg = np.stack(
            [np.where(corrupt_right, pos[:, 0], rand),
             np.where(corrupt_right, rand, pos[:, 1])], axis=1,
        )
        pairs = np.concatenate([pos, neg])
        labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        if exact:
            parts = self._score_exact_parts(params, pairs)
        else:
            cap = self.sampler.pair_cap
            make = (self.sampler.compact_from_pairs if self.resident
                    else self.sampler.batch_from_pairs)
            parts = []
            for start in range(0, len(pairs), cap):
                chunk = pairs[start : start + cap]
                lab = labels[start : start + cap].astype(np.float32)
                hb = make(chunk, lab)
                s = self._score_batch(
                    params, jax.tree.map(jnp.asarray, hb), self.tables)
                parts.append(s[: len(chunk)])
        if self._metrics_jit is None:
            from bignn.train.metrics import (
                average_precision_jnp, roc_auc_jnp)

            self._metrics_jit = jax.jit(lambda l, s: (
                roc_auc_jnp(l, s), average_precision_jnp(l, s)))
        auc, ap = self._metrics_jit(
            jnp.asarray(labels, jnp.float32),
            jnp.concatenate([p.astype(jnp.float32) for p in parts]))
        return {f"{split}_auc": float(auc), f"{split}_ap": float(ap)}

    # -- exact (full-propagation) evaluation ------------------------------
    def _full_outer(self):
        """Full train-edge outer graph, built identically to the full-graph
        path (schema.prepare_device_data) so exact eval matches Trainer."""
        if self._full_outer_cached is None:
            from bignn.sparse.formats import build_outer_graph

            tr = self.ds.split_edges("train")
            self._full_outer_cached = jax.tree.map(
                jnp.asarray,
                build_outer_graph(tr[:, 0], tr[:, 1], self.ds.num_drugs),
            )
        return self._full_outer_cached

    def _exact(self):
        if self._exact_fns is None:
            kw = {}
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                rep = NamedSharding(self.mesh, P())
                kw = dict(in_shardings=rep, out_shardings=rep)

            def encode(params, cb, tables):
                pb = jax.lax.optimization_barrier(
                    self._expand_compact(cb, tables))
                return self.model.encode_inner(params, pb)

            def prop(params, emb, outer):
                return self.model.propagate_outer(params, emb, outer)

            def score(params, emb, pairs):
                return self.model.score_pairs(params, emb, pairs)

            self._exact_fns = (
                jax.jit(encode, **kw), jax.jit(prop, **kw), jax.jit(score, **kw)
            )
        return self._exact_fns

    def embed_all_exact(self, params) -> jax.Array:
        """[num_drugs, d] drug embeddings from FULL inner encoding (every
        molecule, chunked through the resident expansion) + one outer pass
        over the full train graph — no sampling anywhere."""
        encode, prop, _ = self._exact()
        tables = self.tables
        if tables is None:  # non-resident trainer: build tables on demand
            tables = jax.tree.map(jnp.asarray, self.sampler.tables())
            self.tables = tables
        parts = []
        for cb, ids in self.sampler.compact_chunks_all_nodes():
            e = encode(params, jax.tree.map(jnp.asarray, cb), tables)
            parts.append(np.asarray(e[: len(ids)], np.float32))
        emb = jnp.asarray(np.concatenate(parts))
        return prop(params, emb, self._full_outer())

    def _score_exact_parts(self, params, pairs: np.ndarray,
                           chunk: int = 65536) -> list:
        """Per-chunk DEVICE score arrays for [P, 2] global drug-id pairs via
        full propagation (no host funnel — see evaluate)."""
        _, _, score = self._exact()
        emb = self.embed_all_exact(params)
        return [
            score(params, emb, jnp.asarray(pairs[s : s + chunk], jnp.int32))
            for s in range(0, len(pairs), chunk)
        ]

    def score_exact(self, params, pairs: np.ndarray, chunk: int = 65536):
        """Exact logits for [P, 2] global drug-id pairs via full propagation
        (host np view of _score_exact_parts, for external callers/tests)."""
        return np.concatenate([
            np.asarray(p, np.float32)
            for p in self._score_exact_parts(params, pairs, chunk)
        ])

    def fit(self, params=None, opt_state=None, steps_per_epoch=None, log_fn=None,
            ckpt=None, checkpoint_every: int = 1):
        """``ckpt`` enables periodic checkpointing + exact resume; the
        sampler is reseeded per epoch so the sampled trajectory is a pure
        function of (seed, epoch) — see Trainer.fit."""
        cfg = self.config
        if params is None:
            params, opt_state = self.init()
        n_steps = steps_per_epoch or -(-len(self.sampler) // self.dp)
        best = {"val_auc": -1.0, "params": params, "epoch": -1}
        start_epoch = 0
        if ckpt is not None:
            restored = ckpt.restore_state(_fit_state(params, opt_state, best))
            if restored is not None:
                params, opt_state, best, start_epoch = _unpack_fit_state(restored)
        history = []
        from bignn.data.prefetch import ParallelPrefetcher

        for epoch in range(start_epoch, cfg.epochs):
            self.sampler.reseed(epoch)
            t0 = time.perf_counter()
            losses = []
            if self.device_sample:
                params, opt_state, ls = self._fit_epoch_device(
                    params, opt_state, epoch, n_steps)
                losses = [ls] if ls.shape[0] else []
            else:
                # concurrent prefetched sampling overlaps device compute;
                # each step's batch is a pure function of (seed, epoch,
                # step), so the trajectory is deterministic and resume-exact
                # regardless of worker count (data/prefetch.py,
                # sampler.sample_compact_at)
                draws = ParallelPrefetcher(
                    lambda i, _e=epoch: self._draw_host(at=(_e, i)),
                    n_steps, workers=self.prefetch_workers)
                K = max(1, self.dispatch_chunk)
                pending = []
                for hb in draws:
                    pending.append(hb)
                    if len(pending) == K:
                        params, opt_state, losses = self._flush(
                            params, opt_state, pending, losses)
                if pending:
                    params, opt_state, losses = self._flush(
                        params, opt_state, pending, losses)
            rec = {
                "epoch": epoch,
                "loss": float(jnp.mean(jnp.stack(losses))),
                "epoch_time_s": time.perf_counter() - t0,
                # sampler cap-truncation counters ("no silent caps"): dropped
                # far-neighbor nodes / outer edges this epoch; zero in healthy
                # configs (data/hierarchical.py truncation_stats)
                **self.sampler.truncation_stats(reset=True),
            }
            if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
                rec.update(self.evaluate(params, "val"))
                if rec["val_auc"] > best["val_auc"]:
                    best = {"val_auc": rec["val_auc"], "params": params, "epoch": epoch}
            history.append(rec)
            if log_fn:
                log_fn(rec)
            if ckpt is not None and (epoch + 1) % checkpoint_every == 0:
                ckpt.save_state(epoch, _fit_state(params, opt_state, best, epoch))
        final = self.evaluate(best["params"], "test")
        return best["params"], {"history": history, "best_epoch": best["epoch"], **final}
