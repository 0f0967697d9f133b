"""Device-resident hierarchical sampling (SURVEY.md T4, config #4).

The host sampler (hierarchical.py) spends host CPU on every step and ships
each batch host-to-device. This module moves the ENTIRE per-step sampling
pipeline into the jitted step so an epoch runs as a device-only `lax.scan` —
zero per-step host work, zero per-step H2D, sustained == ceiling by
construction.

Pipeline per step (all static shapes, one `jax.random` key):
  1. positive pair draw + negative endpoint corruption;
  2. L-hop fanout neighbor expansion over the resident train-graph CSR
     (full neighborhood when degree <= fanout; otherwise a random
     contiguous WINDOW of the once-shuffled neighbor list — see the
     estimator notes at the window draw in sample());
  3. sort-based dedup per hop + seed-preserving budget truncation
     (ascending unique order == the host's np.unique prefix order);
  4. CLASS-PACKED block layout: molecules sorted by quantized size class,
     each class packed `floor(128/size)` per 128-row block. This replaces
     the host's sequential greedy packer (native.greedy_pack_blocks) with a
     fully parallel rank computation — same invariants (offsets
     non-decreasing, multiples of r_node, no molecule straddles a block),
     different slot order (size-class-major instead of BFS), which only
     permutes slot ids;
  5. outer-subgraph construction: canonical-pair dedup of the sampled tree
     edges, both directions + live self-loops, stable-sorted by dst.

The emitted CompactBatch is bitwise-compatible with the trainer's resident
expansion (_expand_compact); outer weights/src-sort stay device-derived
(MinibatchTrainer._derive_outer). Draws are a pure function of
(seed, epoch, step) via fold_in — the trajectory is deterministic,
order-independent, and checkpoint-resume exact, mirroring
HierarchicalSampler.sample_compact_at. The node/pair SETS differ from the
host sampler's draws (different RNG streams and packing order), so the two
modes are separate-but-equivalent estimators, not bit-identical.

Reference: the PyG/torch-cluster `NeighborSampler` host loop this replaces
(SURVEY.md §2.1 R6) has no device-side analogue in the reference — this is
new scope.

Design notes (chosen on the hardware the system was first built for; none
has been re-measured on the H100):

  * Sorts stay 1D and the scan sequential: drawing K steps' batches in one
    fused call (vmap, or a hand-batched rewrite) measured slower.
  * The last hop at budget-saturated configs (config #4: seeds+hop0
    uniques = 1.7x the drug budget) keeps ZERO new nodes, so four changes
    target its dedup, the random gathers and the per-step src-sort:

1. EDGE-ONLY TRAILING HOPS: a numpy calibration at init (statistics only,
   no RNG coupling) finds the first hop after which the drug budget is
   always saturated with margin; later hops skip dedup/budget entirely —
   they can only contribute outer-graph EDGES (between already-sampled
   nodes), never nodes. At saturated configs this is bit-identical to the
   r3 pipeline (which sorted 2x81920 elements to keep 0 nodes); hops past
   the first edge-only hop are statically skipped (the r3 pipeline gave
   them an all-sentinel frontier -> zero candidates anyway).
2. CLASS PACKING WITHOUT ARGSORT: the stable rank of each molecule within
   its size class comes from a one-hot [M, C] cumsum (ranks == stable
   argsort ranks by construction); slot ids/offsets/locals are then built
   with three scatters over the BFS-order arrays — no sort, and the
   segment-compaction pass the argsort needed is gone too.
3. FUSED OUTER BUILD + FREE SRC-SORT PERM: the dst-sort runs on the
   composite key dst*D+src, so within each dst block edges are src-sorted;
   because the emitted edge list is SYMMETRIC (both directions + loops),
   the src-sorted enumeration is the pointwise mirror of the dst-sorted
   one — edge_src_sorted[k] == outer_dst[k], and the permutation is the
   mirror involution, recovered with two scatters from the argsort's
   origin indices. The trainer's per-step argsort in _derive_outer
   (~83K, previously re-run inside EVERY jitted step) disappears for
   device-sampled batches.
4. Destination slot ids come from one [frontier]-sized gather broadcast
   over the fanout axis (the dst of every sampled edge IS its frontier
   node) instead of a [sum(frontier*fanout)]-sized gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SamplerConsts(NamedTuple):
    """Device-resident constants (uploaded once, ~O(E) int32)."""

    adj_ptr: jax.Array  # [N+1] int32 undirected train-graph CSR
    adj_dst: jax.Array  # [E16/16, 16] int32 SHUFFLED neighbor lists,
    #   16-aligned rows (window sampling — see sample())
    train_pairs: jax.Array  # [T, 2] int32 positive train edges
    qn: jax.Array  # [N] int32 quantized molecule node counts
    qe: jax.Array  # [N] int32 quantized molecule edge counts
    cls_of_size: jax.Array  # [max_qn+1] int32 size -> class id
    class_size: jax.Array  # [C] int32 ascending distinct quantized sizes
    class_pb: jax.Array  # [C] int32 molecules per 128-row block


class DeviceSampler:
    """Jittable sampler built over a calibrated HierarchicalSampler.

    Reuses the host sampler's caps (drug_budget/node_cap/edge_cap/
    outer_edge_cap — including its empirical calibration) and its molecule
    tables; only the per-step draw moves on device. Requires the
    block-local quantized layout (the class packer needs molecules <= 128
    rows; GAT-inner non-quantized layouts keep the host path).
    """

    def __init__(self, host_sampler):
        s = host_sampler
        if not getattr(s, "block_local", False):
            raise ValueError(
                "DeviceSampler requires the block-local layout "
                "(molecules <= 128 rows); use the host sampler otherwise")
        self.host = s
        self.N = int(s.num_nodes)
        self.D = int(s.drug_budget)
        self.NC = int(s.node_cap)
        self.EC = int(s.edge_cap)
        self.OE = int(s.outer_edge_cap)
        self.batch_size = int(s.batch_size)
        self.neg_ratio = int(s.neg_ratio)
        self.pair_cap = int(s.pair_cap)
        self.fanouts = tuple(int(f) for f in s.fanouts)
        self.r_node = int(s.r_node)
        self.T = int(len(s.train_pairs))
        self.seed = int(s.seed)
        # r5: canonical-pair dedup runs on TWO sort keys (lo, hi) instead of
        # the r4 composite lo*D+hi int32 key, so the drug budget carries no
        # D <= 46340 ceiling anymore (tests/test_device_sampler.py covers a
        # 64K budget on CPU). Validated bit-identical to the r4
        # implementation: same-seed draws from both versions produced
        # byte-equal CompactBatches over the test fixture (r5 session
        # cross-check against the committed r4 module).
        # Window sampling draws a contiguous window spanning at most two
        # aligned 16-rows, so each hop's fanout must be <= 16; validate at
        # construction (a trace-time error would surface only on the first
        # jitted draw).
        if any(f > 16 for f in self.fanouts):
            raise ValueError(
                f"window sampling supports fanout <= 16 per hop, got "
                f"fanouts={self.fanouts}; use the host sampler (or split "
                "the hop) for wider fanouts")
        # per-hop frontier caps: seeds, then min(D, prev*fanout)
        caps = [min(self.pair_cap * 2, max(self.D, 1))]
        for f in self.fanouts:
            caps.append(min(self.D, caps[-1] * f))
        self.fcaps = caps
        # edge-only trailing hops (module docstring, r4 change 1): numpy
        # calibration finds the first hop after which the drug budget is
        # ALWAYS saturated with margin; later hops skip dedup/budget (they
        # can only contribute outer edges), and hops past the first
        # edge-only hop are statically skipped (their frontier would be
        # all-sentinel -> zero candidates in the r3 pipeline too).
        qn = np.diff(s._mol_qptr).astype(np.int32)
        sizes = np.unique(qn[qn > 0])
        if sizes.size == 0 or int(sizes.max()) > 128:
            raise ValueError("class packer needs 0 < quantized size <= 128")
        cls_of_size = np.zeros(int(sizes.max()) + 1, np.int32)
        cls_of_size[sizes] = np.arange(len(sizes), dtype=np.int32)
        self.C = int(len(sizes))
        self._qn_np = qn
        self._cls_of_size_np = cls_of_size
        self._class_pb_np = (128 // sizes).astype(np.int32)
        self._class_size_np = sizes.astype(np.int32)
        # MIXED-CLASS packing statics: each class c's per-block leftover
        # (128 - pb_c*s_c) hosts fillers of the LARGEST smaller class
        # whose size fits (gidx[c]; -1 when none fits). fpb[c] = fillers
        # per class-c block; client_mask[g, c] marks c as a client of g.
        C0 = len(sizes)
        leftover = 128 - self._class_pb_np * self._class_size_np
        gidx = np.full(C0, -1, np.int32)
        fpb = np.zeros(C0, np.int32)
        for c in range(C0):
            fits_g = np.flatnonzero(
                (self._class_size_np[:c] <= leftover[c]))
            if len(fits_g):
                g = int(fits_g[-1])
                gidx[c] = g
                fpb[c] = leftover[c] // self._class_size_np[g]
        self._gidx_np = gidx
        self._fpb_np = fpb
        self._client_mask_np = (
            gidx[None, :] == np.arange(C0, dtype=np.int32)[:, None])

        # WINDOW SAMPLING layout (r4): each node's neighbor list is
        # shuffled ONCE (deterministic in seed) and stored as 16-aligned
        # int32 rows. A fanout draw then takes a random CONTIGUOUS window
        # of the shuffled list — two aligned row gathers + a one-hot
        # select — instead of `fanout` independent element gathers. See
        # sample() for the
        # estimator notes. Built BEFORE the node-hop calibration (r5) so
        # the calibration can simulate the REAL window-draw semantics over
        # the same shuffled lists.
        rng_sh = np.random.default_rng((self.seed, 0x5FFE))
        _deg = np.diff(s._adj_ptr)
        _owner = np.repeat(np.arange(self.N, dtype=np.int64), _deg)
        _order = np.lexsort((rng_sh.random(len(s._adj_dst)), _owner))
        _adj_sh = np.asarray(s._adj_dst, np.int32)[_order]
        self._adj_sh_np = _adj_sh
        _e16 = -(-len(_adj_sh) // 16) * 16
        _adj2d = np.zeros(_e16, np.int32)
        _adj2d[: len(_adj_sh)] = _adj_sh
        self._adj2d_np = _adj2d

        self.n_node_hops, nc_dev = self._calibrate_node_hops(s)
        # DEVICE-CALIBRATED node cap (r4): the host NC was calibrated
        # against the host greedy first-fit packer; the class packer's
        # extent is closed-form in the per-class counts and ~10% tighter at
        # config-#4 scale (500K -> ~450K rows). Every NC-proportional step
        # cost (block-adjacency build + its 4 pass reads, inner MLP matmuls,
        # expansion writes and feature-gather rows) shrinks with it.
        # Overflow beyond the calibrated max stays a counted suffix
        # truncation (ncap_dropped), exactly like the host's statistical
        # caps.
        self.NC = min(self.NC, nc_dev)
        self.active_hops = min(len(self.fanouts), self.n_node_hops + 1)
        # undirected dedup cap: su/sv = both directions + D self loops must
        # fit the host-calibrated outer_edge_cap exactly; also bounded by
        # the total sampled-edge buffer (on small graphs the calibrated OE
        # can exceed every edge the hops could possibly produce)
        e_total = sum(self.fcaps[h] * self.fanouts[h]
                      for h in range(self.active_hops))
        self.U = max(min((self.OE - self.D) // 2, e_total), 1)
        if 2 * self.U + self.D > self.OE:
            raise ValueError(
                f"outer_edge_cap {self.OE} cannot hold {self.D} self-loops "
                "plus one undirected pair in both directions")
        self.idt = jnp.int16 if self.D <= np.iinfo(np.int16).max else jnp.int32

        qn = self._qn_np
        qe = np.diff(s._tbl_eptr).astype(np.int32)
        cls_of_size = self._cls_of_size_np
        sizes = np.unique(qn[qn > 0])
        self._consts_np = SamplerConsts(
            adj_ptr=s._adj_ptr.astype(np.int32),
            adj_dst=self._adj2d_np.reshape(-1, 16),
            train_pairs=s.train_pairs.astype(np.int32),
            qn=qn,
            qe=qe,
            cls_of_size=cls_of_size,
            class_size=sizes.astype(np.int32),
            class_pb=(128 // sizes).astype(np.int32),
        )

    def constants(self) -> SamplerConsts:
        """NumPy constants; callers jax.device_put once."""
        return self._consts_np

    def reshuffle_adj(self, consts: SamplerConsts, epoch: int):
        """Epoch-fresh segmented shuffle of the neighbor lists (pure
        function of (seed, epoch); epoch 0 = the init shuffle).

        MEASURED DEAD END as a default (r4): wiring this into the
        trainer's epoch loop HURT learning at config #4 — 4x500 steps
        reached test AUC 0.567 with a loss spike at an epoch boundary vs
        0.635 with the fixed init-time shuffle (the per-epoch
        co-occurrence shift perturbs Adam's moment estimates at the
        config's borderline lr), while the fixed-shuffle window estimator
        already BEATS the host iid estimator at equal step budget. Kept as
        a tested building block
        for long-horizon runs that want explicit decorrelation.

        Implementation: one three-operand two-KEY sort of the flat
        adjacency by (owner, fresh random); owners are recovered from the
        CSR pointers with a scatter-max + cummax (no searchsorted), padding
        is forced to the tail via owner = N. ~one [E] sort per call. (r5:
        the r4 composite key owner*16384+kr overflowed int32 for graphs
        with more than 131071 drugs — config #4's 100K was 25% below the
        limit; the two-key sort removes the packing entirely.)
        """
        if int(epoch) == 0:
            return consts
        if not hasattr(self, "_shuf_fn"):
            E16 = int(consts.adj_dst.size)
            E = int(self.host._adj_dst.shape[0])
            i32 = jnp.int32

            def shuf(adj_ptr, flat, ep):
                starts = jnp.zeros(E16, i32).at[adj_ptr[:-1]].max(
                    jnp.arange(self.N, dtype=i32), mode="drop")
                owner = jax.lax.cummax(starts)
                owner = jnp.where(
                    jnp.arange(E16) < E, owner, jnp.int32(self.N))
                kr = jax.random.randint(
                    jax.random.fold_in(
                        jax.random.key(self.seed ^ 0x5FFE), ep),
                    (E16,), 0, jnp.iinfo(jnp.int32).max, dtype=i32)
                _, _, shuffled = jax.lax.sort(
                    (owner, kr, flat), num_keys=2)
                return shuffled.reshape(-1, 16)

            self._shuf_fn = jax.jit(shuf)
        return consts._replace(adj_dst=self._shuf_fn(
            consts.adj_ptr, consts.adj_dst.reshape(-1), epoch))

    def key_at(self, epoch: int, step) -> jax.Array:
        """The (seed, epoch, step)-derived PRNG key (fold_in chain)."""
        k = jax.random.fold_in(jax.random.key(self.seed), epoch)
        return jax.random.fold_in(k, step)

    def _calibrate_node_hops(self, s, draws: int = 12,
                             margin: float = 1.3) -> tuple[int, int]:
        """(node hops, device-calibrated node cap).

        Node hops: the number of hops that must run the node-adding
        (dedup + budget) path; trailing hops are edge-only — the smallest h
        such that after hop h-1 the drug budget D was saturated in EVERY
        draw with ``margin``x more unique candidates available than budget
        remained. Node cap: the max CLASS-PACK extent (sum_c 128 *
        ceil(n_c / pb_c) over the kept node set) across the simulated
        draws, with 5% + one-block headroom. Simulates ``draws`` full
        hierarchical draws in NumPy with the REAL window-draw semantics
        (r5): contiguous windows of the once-shuffled neighbor lists
        (without replacement), full neighborhood when deg <= fanout,
        ascending-unique budget truncation — the same draw distribution
        sample() runs, so the calibrated extent is an unbiased max over
        simulated real draws rather than an iid-with-replacement proxy.
        The simulation applies no edge-cap, which can only OVERestimate
        the packed extent (edge-cap removes molecules before packing) —
        conservative for a cap. Statistics only — no coupling to the
        device RNG streams; deterministic in (seed, dataset), so resume
        and cross-process draws stay exact. Persistent nonzero
        ncap_dropped at train time is surfaced as a warning by
        MinibatchTrainer (trunc_ncap_dropped counter)."""
        ptr = np.asarray(s._adj_ptr, np.int64)
        adj_sh = np.asarray(self._adj_sh_np, np.int64)
        tp = np.asarray(s.train_pairs, np.int64)
        H = len(self.fanouts)
        rng = np.random.default_rng(self.seed + 0x5EED)
        sat = np.full(H, True)
        max_ext = 0
        for _ in range(draws):
            bs = self.batch_size
            pos = tp[rng.integers(0, len(tp), bs)]
            endpoints = [pos.reshape(-1)]
            for _ in range(self.neg_ratio):
                right = rng.random(bs) < 0.5
                rand = rng.integers(0, self.N, bs)
                endpoints.append(np.where(right, pos[:, 0], rand))
                endpoints.append(np.where(right, rand, pos[:, 1]))
            seeds = np.unique(np.concatenate(endpoints))
            seen = np.zeros(self.N, bool)
            seen[seeds] = True
            total = min(len(seeds), self.D)
            frontier = seeds[: self.fcaps[0]]
            for h in range(H):
                f = self.fanouts[h]
                deg = ptr[frontier + 1] - ptr[frontier]
                # mirror sample()'s window rule: uniform start in
                # [0, deg-f], contiguous window of the shuffled list;
                # whole neighborhood when deg <= f
                start = (rng.random(len(frontier))
                         * np.maximum(deg - f + 1, 1)).astype(np.int64)
                start = np.where(deg <= f, 0, start)
                cols = start[:, None] + np.arange(f)[None, :]
                ev = np.arange(f)[None, :] < deg[:, None]
                cand = adj_sh[np.minimum(ptr[frontier][:, None] + cols,
                                         len(adj_sh) - 1)][ev]
                cand = np.unique(cand[~seen[cand]])
                rem = self.D - total
                keep = min(len(cand), rem)
                sat[h] &= (total + keep >= self.D) and (
                    len(cand) >= margin * max(rem, 1))
                newf = cand[:keep]
                seen[newf] = True
                total += keep
                frontier = newf[: self.fcaps[h + 1]]
            kept = np.flatnonzero(seen)[: self.D]
            cls = self._cls_of_size_np[self._qn_np[kept]]
            cnt = np.bincount(cls, minlength=self.C)
            # mixed-class extent: mirror of sample()'s descending-order
            # resolution (a class's filler demand comes only from larger
            # classes)
            pbn = self._class_pb_np
            fpbn = self._fpb_np
            gx = self._gidx_np
            blocks = np.zeros(self.C, np.int64)
            for c in range(self.C - 1, -1, -1):
                demand = sum(int(blocks[c2]) * int(fpbn[c2])
                             for c2 in range(c + 1, self.C)
                             if gx[c2] == c)
                own_c = int(cnt[c]) - min(int(cnt[c]), demand)
                blocks[c] = -(-own_c // int(pbn[c]))
            ext = int(128 * blocks.sum())
            max_ext = max(max_ext, ext)
        nc_dev = -(-int(max_ext * 1.05 + 128) // 128) * 128
        n_node_hops = H
        for h in range(H):
            if sat[h]:
                n_node_hops = h + 1
                break
        return n_node_hops, nc_dev

    # -- the jittable draw -------------------------------------------------
    def sample(self, consts: SamplerConsts, key: jax.Array):
        """One CompactBatch + truncation-stat scalars, fully on device."""
        from bignn.data.hierarchical import CompactBatch

        N, D, C = self.N, self.D, self.C
        i32 = jnp.int32
        kp, kn, *khop = jax.random.split(key, 2 + len(self.fanouts))

        # 1. pairs ---------------------------------------------------------
        bs = self.batch_size
        pos = jnp.take(
            consts.train_pairs,
            jax.random.randint(kp, (bs,), 0, self.T), axis=0)  # [bs, 2]
        negs = []
        for kr in jax.random.split(kn, self.neg_ratio):
            k1, k2 = jax.random.split(kr)
            right = jax.random.uniform(k1, (bs,)) < 0.5
            rand = jax.random.randint(k2, (bs,), 0, N)
            negs.append(jnp.stack(
                [jnp.where(right, pos[:, 0], rand),
                 jnp.where(right, rand, pos[:, 1])], axis=1))
        all_pairs = jnp.concatenate([pos] + negs).astype(i32)  # [pair_cap,2]
        labels = jnp.concatenate([
            jnp.ones(bs, jnp.float32),
            jnp.zeros(bs * self.neg_ratio, jnp.float32)])

        # 2-3. seeds + hop expansion --------------------------------------
        def sorted_unique(x, sent):
            """Ascending unique of x (sentinel-padded), sentinel tail.

            The compaction is a SECOND sort on purpose: the alternatives
            (jnp.searchsorted's scan lowering, cumsum+scatter compaction)
            were no faster on the earlier hardware; not re-measured on the
            H100."""
            xs = jnp.sort(x)
            m = (xs < sent) & jnp.concatenate(
                [jnp.ones(1, bool), xs[1:] != xs[:-1]])
            return jnp.sort(jnp.where(m, xs, sent)), m.sum().astype(i32)

        seeds, n_seeds = sorted_unique(all_pairs.reshape(-1), N)
        total = jnp.minimum(n_seeds, D)
        node_segs = [seeds]  # sentinel-N beyond each segment's valid prefix
        es_bufs, frs = [], []
        hop_dropped = jnp.zeros((), i32)
        frontier = seeds[: self.fcaps[0]]
        ER = int(consts.adj_dst.shape[0])  # 16-wide aligned rows
        for h in range(self.active_hops):
            fanout = self.fanouts[h]  # <= 16, validated in __init__
            FC = self.fcaps[h]
            fr = frontier
            frv = fr < N
            frc = jnp.minimum(fr, N - 1)
            lo = jnp.take(consts.adj_ptr, frc)
            deg = jnp.where(frv, jnp.take(consts.adj_ptr, frc + 1) - lo, 0)
            j = jnp.arange(fanout, dtype=i32)
            # WINDOW DRAW (r4): whole neighborhood when deg <= fanout
            # (window start 0, validity mask), else a uniform-start
            # contiguous window of the ONCE-SHUFFLED neighbor list.
            # Estimator notes vs the host's iid with-replacement rule:
            # draws are without replacement (a strict improvement);
            # neighbors adjacent in the fixed shuffle co-occur across
            # steps (correlated batches), and clamping the start to
            # [0, deg-fanout] under-weights each list's 2*(fanout-1)
            # endpoint positions — both map to a RANDOM fixed subset per
            # node (the shuffle is seed-derived), are diluted by degree
            # (config #4 avg degree 200), and are validated end-to-end by
            # the device-vs-host learning gate
            # (tests/test_device_vs_host_learning.py).
            u = jax.random.uniform(khop[h], (FC,))
            start = jnp.where(
                deg <= fanout, 0,
                (u * (deg - fanout + 1).astype(jnp.float32)).astype(i32))
            pos0 = lo + start  # absolute start in the flat shuffled list
            row0 = pos0 // 16
            # two aligned 16-rows cover any window of <= 16 elements
            rows = jnp.stack([row0, row0 + 1], axis=1)  # [FC, 2]
            flat = jnp.take(
                consts.adj_dst, jnp.clip(rows, 0, ER - 1), axis=0
            ).reshape(FC, 32)  # [FC, 32]
            # one-hot select of window positions (p..p+fanout) — VPU
            # streams, no per-element gather
            p = (pos0 % 16)[:, None, None]  # [FC, 1, 1]
            k = jnp.arange(32, dtype=i32)[None, :, None]
            sel = (k == p + j[None, None, :])  # [FC, 32, fanout]
            es = jnp.sum(
                jnp.where(sel, flat[:, :, None], 0), axis=1).astype(i32)
            ev = j[None, :] < deg[:, None]
            es = jnp.where(ev, es, N)
            es_bufs.append(es.reshape(-1))
            frs.append(fr)  # edge dst == frontier node (broadcast later)
            if h >= self.n_node_hops:
                continue  # edge-only hop: no dedup, no budget, no frontier
            # JOIN-DEDUP (r4): one sort over (already-kept nodes, candidates)
            # on the composite key id*2+flag replaces the r3 `seen` bitmap —
            # its init/update scatters and the [FC*fanout] seen-gather were
            # the hop's most expensive ops on the earlier hardware. A node
            # already kept sorts FIRST within its id group (flag 0), so a
            # candidate occurrence is NEW iff it is the first occurrence of
            # its id AND carries flag 1 — bit-identical node sets and
            # ascending-prefix budget semantics to the seen-bitmap version.
            prev = (jnp.concatenate(node_segs) if len(node_segs) > 1
                    else node_segs[0])
            joint = jnp.concatenate(
                [prev * 2, es.reshape(-1) * 2 + 1])
            xs = jnp.sort(joint)
            ids = xs >> 1
            m_new = ((xs < 2 * N) & (xs & 1 == 1) & jnp.concatenate(
                [jnp.ones(1, bool), ids[1:] != ids[:-1]]))
            rank = jnp.cumsum(m_new.astype(i32))
            ucount = rank[-1]
            keep = jnp.minimum(ucount, D - total)
            NF = self.fcaps[h + 1]
            newf = jnp.sort(
                jnp.where(m_new & (rank <= keep), ids, N))[:NF]
            newf = jnp.where(jnp.arange(NF) < keep, newf, N)
            hop_dropped += ucount - keep
            node_segs.append(newf)
            total += keep
            frontier = newf

        # BFS-order node arrays (seeds first, then each node hop's kept
        # set). Segments stay sentinel-padded; validity/budget/edge-cap
        # masks are computed IN PLACE — the class packer below absorbs the
        # compaction the r3 pipeline did with segment arithmetic over [D].
        nodes_b = jnp.concatenate(node_segs)  # [M]
        M = int(nodes_b.shape[0])
        # drug budget needs no cumsum here: seeds fit by construction
        # (drug_budget >= pair_cap*2, hierarchical.py cap setup) and every
        # hop segment was already rank-truncated to keep <= D - total, so
        # the valid count over node_segs can never exceed D.
        bvalid = valid_b = nodes_b < N
        nb_c = jnp.minimum(nodes_b, N - 1)
        # edge-cap prefix truncation (BFS order, seeds first — host line
        # hierarchical.py:567)
        eq = jnp.where(bvalid, jnp.take(consts.qe, nb_c), 0)
        ecv = bvalid & (jnp.cumsum(eq) <= self.EC)
        ecap_dropped = (jnp.sum(bvalid) - jnp.sum(ecv)).astype(i32)

        # 4. MIXED-CLASS packed layout (r4): stable rank within each size
        # class via one [M, C] one-hot cumsum, then closed-form offsets.
        # Each block of a class c reserves its leftover rows
        # (128 - pb_c*s_c) for floor(leftover / s_g) FILLER molecules of
        # class g = gidx[c] — the LARGEST smaller class whose size fits
        # the leftover (no filler when gidx[c] = -1). Molecules of a
        # filler class g occupy their host blocks in ascending-base order
        # before falling back to class g's own end-of-layout blocks. Pure arithmetic over [C]/[M, C] — no new sorts or
        # scatters vs the unmixed packer — and the packed extent drops
        # ~5% at config #4 (the per-block waste moves from dead rows to
        # real molecules). Slot ids enumerate molecules in OFFSET order
        # (block-major, fillers after the block's own-class extent), so
        # off stays non-decreasing over slot order and node-cap overflow
        # stays a pure suffix drop — the two invariants _expand_compact
        # and the ncap accounting require.
        qn_b = jnp.where(ecv, jnp.take(consts.qn, nb_c), 0)
        cls_b = jnp.where(
            ecv, jnp.take(consts.cls_of_size, jnp.minimum(
                qn_b, consts.cls_of_size.shape[0] - 1)), C)
        oh = (cls_b[:, None] == jnp.arange(C)[None, :]).astype(i32)
        ranks = jnp.cumsum(oh, axis=0)  # [M, C]
        cnt = ranks[-1]  # per-class totals [C]
        cidx = jnp.minimum(cls_b, C - 1)
        rank0 = jnp.take_along_axis(ranks, cidx[:, None], axis=1)[:, 0] - 1
        pb = consts.class_pb
        sz = consts.class_size
        # Resolve the mixed layout in DESCENDING class order: a class's
        # filler demand comes only from LARGER classes (gidx[c] < c), so
        # used/own/blocks are well-defined scalars after one static
        # C-length unrolled loop. All remaining bookkeeping is [C]/[C, C]
        # arithmetic (C ~ 10).
        gx = self._gidx_np  # static: filler class per class, -1 if none
        fpb_np = self._fpb_np  # static: fillers per block
        blocks_l = [None] * C
        used_l = [jnp.zeros((), i32) for _ in range(C)]
        own_l = [None] * C
        for c in range(C - 1, -1, -1):
            demand = sum((blocks_l[c2] * int(fpb_np[c2])
                          for c2 in range(c + 1, C) if gx[c2] == c),
                         jnp.zeros((), i32))
            used_l[c] = jnp.minimum(cnt[c], demand)
            own_l[c] = cnt[c] - used_l[c]
            blocks_l[c] = -(-own_l[c] // int(self._class_pb_np[c]))
        used = jnp.stack(used_l)
        own = jnp.stack(own_l)
        blocks = jnp.stack(blocks_l)
        fpb = jnp.asarray(fpb_np)
        cap = blocks * fpb  # filler capacity hosted per class
        base = 128 * (jnp.cumsum(blocks) - blocks)
        # fill_c: fillers actually hosted in class c's blocks. Class g's
        # pool serves its clients in ascending-base order: exclusive
        # cumsum of cap over each g's client set (static [C, C] mask).
        Wg = jnp.asarray(self._client_mask_np)  # [g, c] bool
        capW = jnp.where(Wg, cap[None, :], 0)  # [C, C]
        capxW = jnp.cumsum(capW, axis=1) - capW  # exclusive per row
        fill_by = jnp.clip(used[:, None] - capxW, 0, capW)  # [g, c]
        fill = jnp.sum(fill_by, axis=0)  # [C] fillers hosted in class c
        occ = own + fill
        slotbase = jnp.cumsum(occ) - occ
        # own molecules (rank >= used): standard placement, fill-aware slot
        ro = rank0 - jnp.take(used, cidx)
        pbc = jnp.take(pb, cidx)
        fc = jnp.take(fpb, cidx)
        kb = ro // jnp.maximum(pbc, 1)
        mb = ro % jnp.maximum(pbc, 1)
        off_own = jnp.take(base, cidx) + kb * 128 + mb * jnp.take(sz, cidx)
        slot_own = (jnp.take(slotbase, cidx) + kb * pbc
                    + jnp.minimum(jnp.take(fill, cidx), kb * fc) + mb)
        # filler molecules (rank < used): client class via this class's
        # capacity windows ([M, C] compare against row cidx of capxW)
        capx_row = jnp.take(capxW, cidx, axis=0)  # [M, C]
        capW_row = jnp.take(capW, cidx, axis=0)
        inc = ((rank0[:, None] >= capx_row)
               & (rank0[:, None] < capx_row + capW_row))
        cf = jnp.argmax(inc, axis=1).astype(i32)  # client class
        qf = rank0 - jnp.take_along_axis(
            capx_row, cf[:, None], axis=1)[:, 0]
        ff = jnp.maximum(jnp.take(fpb, cf), 1)
        kf = qf // ff
        mf = qf % ff
        off_f = (jnp.take(base, cf) + kf * 128
                 + jnp.take(pb, cf) * jnp.take(sz, cf)
                 + mf * jnp.take(sz, cidx))
        slot_f = (jnp.take(slotbase, cf)
                  + jnp.minimum(jnp.take(own, cf), (kf + 1) * jnp.take(pb, cf))
                  + kf * ff + mf)
        isfill = rank0 < jnp.take(used, cidx)
        off_b = jnp.where(isfill, off_f, off_own)
        slot_b = jnp.where(isfill, slot_f, slot_own)
        fits = ecv & (off_b + qn_b <= self.NC)
        ncap_dropped = (jnp.sum(ecv) - jnp.sum(fits)).astype(i32)
        n_real = jnp.sum(fits).astype(i32)
        slot_w = jnp.where(fits, slot_b, D)  # D = drop row
        # ONE row scatter fills nodes+off together (one scatter instead of
        # two)
        init2 = jnp.stack([jnp.zeros(D, i32), jnp.full(D, self.NC, i32)], 1)
        out2 = init2.at[slot_w].set(
            jnp.stack([nodes_b, off_b], 1), mode="drop")
        nodes_out, off = out2[:, 0], out2[:, 1]

        # local slot ids; invalid rows write the sentinel VALUE D into the
        # sentinel ROW N, so local[N] stays D
        local = jnp.full(N + 1, D, i32).at[
            jnp.where(fits, nodes_b, N)
        ].set(slot_w)

        # 5. outer subgraph (module docstring, change 3) -------------------
        es = jnp.concatenate(es_bufs)
        la = jnp.take(local, jnp.minimum(es, N))
        # frontier slots by SLICE, not lookup: hop h's frontier is the
        # fcaps[h]-prefix of node seg min(h, n_node_hops) (edge-only hops
        # reuse the last node seg), and slot_w is ordered exactly like
        # concat(node_segs), so the id->slot gather through `local` is a
        # positional slice of slot_w (r4 op-count cut).
        seg_off = np.cumsum(
            [0] + [int(s.shape[0]) for s in node_segs]).tolist()
        lb = jnp.concatenate([
            jnp.broadcast_to(
                jax.lax.dynamic_slice_in_dim(
                    slot_w, seg_off[min(h, len(node_segs) - 1)],
                    fr.shape[0])[:, None],
                (fr.shape[0], self.fanouts[h])).reshape(-1)
            for h, fr in enumerate(frs)])
        ok = (la < D) & (lb < D) & (la != lb)
        # Canonical-pair dedup on TWO sort keys (lo, hi) — r5, replacing
        # the r4 composite lo*D+hi int32 key, whose range capped the drug
        # budget at floor(sqrt(2^31)) = 46340. Sentinel pairs (D, 0) sort
        # after every valid pair (lo < D); ordering and the
        # ascending-prefix truncation semantics are identical to the
        # composite key's (lexicographic == composite order).
        # NOTE: letting the dedup holes flow through the final dst-sort (one
        # fewer sort, but over 2*Etot+D instead of 2U+D elements) measured
        # slower on the earlier hardware. The compaction sort stays (as a
        # second two-key sort, mirroring sorted_unique).
        plo = jnp.where(ok, jnp.minimum(la, lb), D)
        phi = jnp.where(ok, jnp.maximum(la, lb), 0)
        lo_s, hi_s = jax.lax.sort((plo, phi), num_keys=2)
        m_u = (lo_s < D) & jnp.concatenate(
            [jnp.ones(1, bool),
             (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])])
        ucnt = m_u.sum().astype(i32)
        klo_c, khi_c = jax.lax.sort(
            (jnp.where(m_u, lo_s, D), jnp.where(m_u, hi_s, 0)), num_keys=2)
        kept = jnp.minimum(ucnt, self.U)
        outer_dropped = (ucnt - kept) * 2  # both directions drop
        uval = jnp.arange(self.U) < kept
        klo = klo_c[: self.U]
        khi = khi_c[: self.U]
        # dst-major (dst, src) two-key sort (r5, same composite-free
        # rationale): canonical pair (lo, hi) emits (src=hi, dst=lo) and
        # (src=lo, dst=hi); live self-loops (d, d). The three families are
        # disjoint (src<dst / src>dst / src==dst), so (dst, src) pairs are
        # unique across families and the stable sort yields the dst-sorted
        # edge list with each dst block internally src-sorted — exactly
        # the composite dst*D+src order. Sentinels carry (D, 0) and tie
        # stably in origin order, as the equal composite sentinels did.
        U = self.U
        slot = jnp.arange(D, dtype=i32)
        lv = slot < n_real
        dst_all = jnp.concatenate([
            jnp.where(uval, klo, D), jnp.where(uval, khi, D),
            jnp.where(lv, slot, D)])  # [L = 2U + D]
        src_all = jnp.concatenate([
            jnp.where(uval, khi, 0), jnp.where(uval, klo, 0),
            jnp.where(lv, slot, 0)])
        L = int(dst_all.shape[0])
        # one three-operand stable sort gives keys AND permutation
        # together (argsort-then-gather pays an extra [L] element gather)
        sv_s, su_s, o3 = jax.lax.sort(
            (dst_all, src_all, jnp.arange(L, dtype=i32)), num_keys=2)
        vale = sv_s < D
        # free src-sort perm: the edge list is SYMMETRIC, so the k-th
        # src-sorted edge is the mirror of the k-th dst-sorted edge —
        # edge_src_sorted[k] == sv_s[k] and the permutation is the mirror
        # involution (canonical pair c's dirA entry at origin c and dirB
        # entry at origin U+c point at each other; loops and padding are
        # fixed points). One scatter inverts o3, one gather follows the
        # mirrored origin.
        idxL = jnp.arange(L, dtype=i32)
        is_a = vale & (o3 < U)
        is_b = vale & (o3 >= U) & (o3 < 2 * U)
        inv = jnp.zeros(L, i32).at[o3].set(idxL)
        mir_origin = jnp.where(
            is_a, o3 + U, jnp.where(is_b, o3 - U, o3))
        operm = jnp.take(inv, mir_origin)
        pad = self.OE - L  # init asserts 2U + D <= OE
        outer_src = jnp.pad(su_s, (0, pad)).astype(self.idt)
        outer_dst = jnp.pad(
            sv_s, (0, pad), constant_values=D).astype(self.idt)
        outer_perm = jnp.concatenate(
            [operm, jnp.arange(L, self.OE, dtype=i32)])

        # pairs -> local slots; endpoints dropped by any truncation mask out
        pa = jnp.take(local, all_pairs[:, 0])
        pb2 = jnp.take(local, all_pairs[:, 1])
        pv = (pa < D) & (pb2 < D)
        pairs_local = jnp.stack(
            [jnp.where(pv, pa, 0), jnp.where(pv, pb2, 0)],
            axis=1).astype(self.idt)
        mask = pv.astype(jnp.float32)

        stats = {
            "trunc_nodes_dropped": (
                hop_dropped + ecap_dropped + ncap_dropped).astype(i32),
            # surfaced separately so the trainer can warn when the
            # device-calibrated node cap truncates persistently (a
            # persistent estimator bias the host cap did not have)
            "trunc_ncap_dropped": ncap_dropped.astype(i32),
            "trunc_outer_edges_dropped": outer_dropped.astype(i32),
            "trunc_batches": (
                (hop_dropped + ecap_dropped + ncap_dropped + outer_dropped)
                > 0).astype(i32),
            "batches_sampled": jnp.ones((), i32),
        }
        cb = CompactBatch(
            nodes=nodes_out,
            n_real=n_real,
            pack_off=off.astype(i32),
            outer_src=outer_src,
            outer_dst=outer_dst,
            outer_weight=None,  # GCN weights still derived on device
            # mirror identity: src-sorted src values == dst-sorted dst
            # values (outer_dst doubles as outer_src_sorted)
            outer_src_perm=outer_perm,
            outer_src_sorted=outer_dst,
            pairs=pairs_local,
            labels=labels,
            mask=mask,
            drug_budget=D,
            node_cap=self.NC,
            edge_cap=self.EC,
            outer_edge_cap=self.OE,
        )
        return cb, stats
