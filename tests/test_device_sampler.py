"""Device-resident sampler (data/device_sampler.py): structural invariants
of the emitted CompactBatch, determinism of the (seed, epoch, step)-keyed
draws, membership correctness of the sampled outer subgraph, and end-to-end
training through MinibatchTrainer(device_sample=True)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bignn.data import make_synthetic_ddi
from bignn.data.device_sampler import DeviceSampler
from bignn.data.hierarchical import HierarchicalSampler
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import MinibatchTrainer, TrainConfig


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_ddi(num_drugs=80, feat_dim=8, avg_degree=8.0,
                            min_atoms=4, max_atoms=14, seed=3)
    host = HierarchicalSampler(ds, batch_size=16, neg_ratio=1,
                               fanouts=(4, 3), seed=0, calibrate_caps=4)
    dev = DeviceSampler(host)
    consts = jax.tree.map(jnp.asarray, dev.constants())
    sample = jax.jit(dev.sample)
    return ds, host, dev, consts, sample


def _draw(dev, consts, sample, epoch, step):
    cb, stats = sample(consts, dev.key_at(epoch, step))
    return jax.tree.map(np.asarray, cb), jax.tree.map(np.asarray, stats)


def test_structural_invariants(setup):
    ds, host, dev, consts, sample = setup
    qn = np.diff(host._mol_qptr).astype(np.int64)
    for step in range(4):
        cb, stats = _draw(dev, consts, sample, 0, step)
        n = int(cb.n_real)
        assert 0 < n <= dev.D
        nodes = cb.nodes[:n]
        # sampled drugs are unique, real ids
        assert len(np.unique(nodes)) == n
        assert nodes.min() >= 0 and nodes.max() < ds.num_drugs
        # packing invariants: offsets non-decreasing r_node multiples, no
        # molecule straddles a 128-row block, extent fits node_cap
        off = cb.pack_off[:n].astype(np.int64)
        sizes = qn[nodes]
        assert np.all(np.diff(off) >= 0)
        assert np.all(off % dev.r_node == 0)
        assert np.all(off % 128 + sizes <= 128)
        assert np.all(off + sizes <= dev.NC)
        # disjoint row ranges
        assert np.all(off[1:] >= off[:-1] + sizes[:-1])
        # outer subgraph: dst-sorted, endpoints live, each non-loop edge is
        # a REAL train edge (membership in the undirected train adjacency)
        od = cb.outer_dst.astype(np.int64)
        live = od < dev.D
        assert np.all(np.diff(od) >= 0)
        osrc = cb.outer_src.astype(np.int64)[live]
        odst = od[live]
        assert osrc.max() < n and odst.max() < n
        gs, gd = nodes[osrc], nodes[odst]
        train = ds.split_edges("train")
        eset = set(map(tuple, np.concatenate([train, train[:, ::-1]])))
        nonloop = gs != gd
        for a, b in zip(gs[nonloop], gd[nonloop]):
            assert (int(a), int(b)) in eset
        # every live slot has exactly one self-loop
        loops = osrc[~nonloop]
        np.testing.assert_array_equal(np.sort(loops), np.arange(n))
        # pairs: masked entries only reference live slots
        m = cb.mask > 0
        if m.any():
            assert cb.pairs[m].max() < n
        assert stats["batches_sampled"] == 1


def test_determinism_and_variation(setup):
    _, _, dev, consts, sample = setup
    a, _ = _draw(dev, consts, sample, 1, 5)
    b, _ = _draw(dev, consts, sample, 1, 5)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(la, lb)
    c, _ = _draw(dev, consts, sample, 1, 6)
    assert any(
        not np.array_equal(la, lc)
        for la, lc in zip(jax.tree.leaves(a), jax.tree.leaves(c))
    )


def test_expansion_consumes_device_batch(setup):
    """The emitted CompactBatch flows through the trainer's resident
    expansion + forward, and the loss is finite."""
    ds, host, dev, consts, sample = setup
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=16,
                                         heads=2))
    tr = MinibatchTrainer(model, ds, TrainConfig(lr=1e-3, epochs=1,
                                                 batch_size=16),
                          fanouts=(4, 3), calibrate_caps=4)
    params, opt_state = tr.init()
    cb, _ = jax.jit(dev.sample)(consts, dev.key_at(0, 0))
    params, opt_state, loss = tr._train_step(params, opt_state, cb, tr.tables)
    assert np.isfinite(float(loss))


def test_device_sample_gat_inner(setup):
    """GAT/DotAttn inner convs ride the dense-block path on quantized
    layouts; the device-sampled batch must flow through it too."""
    ds, host, dev, consts, sample = setup
    model = BiGNN(BiGNNConfig(feat_dim=ds.feat_dim,
                              inner_layers=("gat:16:2",),
                              outer_layers=("gcn:16:identity",)))
    tr = MinibatchTrainer(model, ds, TrainConfig(lr=1e-3, epochs=1,
                                                 batch_size=16),
                          fanouts=(4, 3), calibrate_caps=4,
                          device_sample=True)
    params, opt_state = tr.init()
    cb, _ = jax.jit(tr.dsampler.sample)(
        tr._dev_consts, tr.dsampler.key_at(0, 0))
    params, opt_state, loss = tr._train_step(params, opt_state, cb, tr.tables)
    assert np.isfinite(float(loss))


def test_device_fit_trains_and_is_deterministic():
    ds = make_synthetic_ddi(num_drugs=60, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=1)
    model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                              outer_layers=("gcn:16:identity",)))

    def run():
        tr = MinibatchTrainer(
            model, ds, TrainConfig(lr=3e-3, epochs=3, batch_size=16, seed=0),
            fanouts=(4,), calibrate_caps=2, device_sample=True,
            dispatch_chunk=2,
        )
        return tr.fit(steps_per_epoch=5)

    p1, r1 = run()
    p2, r2 = run()
    losses = [r["loss"] for r in r1["history"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # same (seed, epoch, step) trajectory => identical runs
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # truncation counters surfaced per epoch
    assert "batches_sampled" in r1["history"][0]


def test_large_budget_draw(setup):
    """r5: the pair dedup and outer build run on two-key (lo, hi) sorts,
    so a 64K drug budget — over the r4 composite-key ceiling of
    floor(sqrt(2^31)) = 46340 — constructs and draws correctly on CPU."""
    ds, host, *_ = setup
    import copy

    big = copy.copy(host)
    big.drug_budget = 65_536
    # outer_edge_cap must hold D self-loops + both directions of U pairs
    big.outer_edge_cap = 65_536 + 4096
    dev = DeviceSampler(big)
    assert dev.D == 65_536
    consts = jax.tree.map(jnp.asarray, dev.constants())
    cb, stats = jax.jit(dev.sample)(consts, dev.key_at(0, 0))
    cb = jax.tree.map(np.asarray, cb)
    n = int(cb.n_real)
    assert 0 < n <= ds.num_drugs
    nodes = cb.nodes[:n]
    assert len(np.unique(nodes)) == n
    # outer edges: dst-sorted, each non-loop edge a real train edge, one
    # self-loop per live slot (same membership contract as the structural
    # test, at the large-D index dtype/int32 path)
    od = cb.outer_dst.astype(np.int64)
    live = od < dev.D
    assert np.all(np.diff(od) >= 0)
    osrc = cb.outer_src.astype(np.int64)[live]
    odst = od[live]
    gs, gd = nodes[osrc], nodes[odst]
    train = ds.split_edges("train")
    eset = set(map(tuple, np.concatenate([train, train[:, ::-1]])))
    nonloop = gs != gd
    assert nonloop.any()
    for a, b in zip(gs[nonloop], gd[nonloop]):
        assert (int(a), int(b)) in eset
    np.testing.assert_array_equal(
        np.sort(osrc[~nonloop]), np.arange(n))
    # pair list is canonical-deduped: no duplicate undirected pairs
    pairs = np.stack([np.minimum(gs[nonloop], gd[nonloop]),
                      np.maximum(gs[nonloop], gd[nonloop])], 1)
    # each canonical pair appears exactly twice (both directions)
    _, cnts = np.unique(pairs, axis=0, return_counts=True)
    assert np.all(cnts == 2)


def test_fanout_validated_at_construction(setup):
    """fanouts > 16 must fail in __init__ (window draws span at most two
    aligned 16-rows), not at the first jitted draw."""
    _, host, *_ = setup
    import copy

    wide = copy.copy(host)
    wide.fanouts = (32,)
    with pytest.raises(ValueError, match="fanout"):
        DeviceSampler(wide)


def test_emitted_src_sort_perm(setup):
    """r4: the sampler ships the src-sort permutation for free via the
    mirror involution of its symmetric outer edge list (device_sampler.py
    module docstring, change 3). Contract used by ops/spmm + ops/multihead:
    outer_src_perm is a permutation of [0, OE), outer_src[perm] is
    non-decreasing with padding ids == D at the tail, and equals
    outer_src_sorted."""
    _, _, dev, consts, sample = setup
    for step in range(3):
        cb, _ = _draw(dev, consts, sample, 2, step)
        perm = cb.outer_src_perm.astype(np.int64)
        assert perm.shape == (dev.OE,)
        np.testing.assert_array_equal(np.sort(perm), np.arange(dev.OE))
        osrc = cb.outer_src.astype(np.int64)
        odst = cb.outer_dst.astype(np.int64)
        # padding entries (dst == D) have src 0 and must sort as id D, the
        # segment-drop sentinel — the emitted sorted array encodes that
        src_eff = np.where(odst < dev.D, osrc, dev.D)
        got = src_eff[perm]
        assert np.all(np.diff(got) >= 0)
        np.testing.assert_array_equal(got, cb.outer_src_sorted.astype(np.int64))
        # mirror identity on live edges: the k-th src-sorted edge is the
        # swap of the k-th dst-sorted edge, so dst[perm[k]] == src[k]
        live = odst < dev.D
        np.testing.assert_array_equal(odst[perm][live], osrc[live])


def test_edge_only_hop_calibration():
    """r4: on a budget-saturating config the trailing hop is calibrated
    edge-only (adds outer edges but no nodes); on the roomy default config
    every hop stays node-adding."""
    ds = make_synthetic_ddi(num_drugs=300, feat_dim=8, avg_degree=40.0,
                            min_atoms=4, max_atoms=12, seed=5)
    host_sat = HierarchicalSampler(ds, batch_size=32, neg_ratio=1,
                                   fanouts=(8, 4), seed=0, calibrate_caps=4,
                                   max_drugs=96)
    dev_sat = DeviceSampler(host_sat)
    assert dev_sat.n_node_hops < len(dev_sat.fanouts)
    # edges from the edge-only hop still appear: sample and check that the
    # batch has live outer edges beyond the loop count and valid structure
    consts = jax.tree.map(jnp.asarray, dev_sat.constants())
    cb, _ = jax.jit(dev_sat.sample)(consts, dev_sat.key_at(0, 0))
    cb = jax.tree.map(np.asarray, cb)
    n = int(cb.n_real)
    live = cb.outer_dst.astype(np.int64) < dev_sat.D
    assert int(live.sum()) > n  # loops + real sampled edges
    host_roomy = HierarchicalSampler(ds, batch_size=4, neg_ratio=1,
                                     fanouts=(2,), seed=0, calibrate_caps=4)
    dev_roomy = DeviceSampler(host_roomy)
    assert dev_roomy.n_node_hops == 1


def test_window_draw_coverage(setup):
    """Window draws (r4) must reach EVERY neighbor of every drawn node
    over enough steps: the shuffled-list window start is uniform, so no
    train edge may be unreachable. Collects sampled outer edges over many
    draws and checks that each frequently-sampled seed-adjacent node's
    neighborhood is fully covered."""
    ds, host, dev, consts, sample = setup
    train = ds.split_edges("train")
    adj = {}
    for a, b in train:
        adj.setdefault(int(a), set()).add(int(b))
        adj.setdefault(int(b), set()).add(int(a))
    seen_pairs = set()
    drawn = {}
    for step in range(40):
        cb, _ = _draw(dev, consts, sample, 0, step)
        n = int(cb.n_real)
        nodes = cb.nodes[: n].astype(np.int64)
        od = cb.outer_dst.astype(np.int64)
        live = od < dev.D
        gs = nodes[cb.outer_src.astype(np.int64)[live]]
        gd = nodes[od[live]]
        for a, b in zip(gs, gd):
            if a != b:
                seen_pairs.add((int(a), int(b)))
        for x in nodes:
            drawn[int(x)] = drawn.get(int(x), 0) + 1
    # nodes drawn in (nearly) every step had 40 windows over their list:
    # coverage of their full neighborhood is overwhelmingly likely; a
    # miss means windows cannot reach part of the list (an indexing bug)
    hot = [x for x, c in drawn.items() if c >= 35 and len(adj.get(x, ())) > 0]
    assert hot, "fixture should have frequently-drawn nodes"
    for x in hot:
        nbrs = {b for b in adj[x] if drawn.get(b, 0) >= 35}
        covered = {b for (a, b) in seen_pairs if a == x}
        missing = nbrs - covered
        assert not missing, (x, sorted(missing))


def test_reshuffle_adj_invariants(setup):
    """Per-epoch reshuffle permutes WITHIN each node's neighbor segment:
    the per-node neighbor multiset is invariant, the order changes for
    some multi-neighbor node, and the result is deterministic in epoch."""
    _, host, dev, consts, _ = setup
    ptr = np.asarray(host._adj_ptr)
    base = np.asarray(consts.adj_dst).reshape(-1)
    r1 = np.asarray(dev.reshuffle_adj(consts, 3).adj_dst).reshape(-1)
    r1b = np.asarray(dev.reshuffle_adj(consts, 3).adj_dst).reshape(-1)
    r2 = np.asarray(dev.reshuffle_adj(consts, 4).adj_dst).reshape(-1)
    np.testing.assert_array_equal(r1, r1b)
    assert not np.array_equal(r1, r2)
    E = int(ptr[-1])
    changed = False
    for k in range(len(ptr) - 1):
        lo, hi = int(ptr[k]), int(ptr[k + 1])
        np.testing.assert_array_equal(
            np.sort(base[lo:hi]), np.sort(r1[lo:hi]), err_msg=f"node {k}")
        if hi - lo > 1 and not np.array_equal(base[lo:hi], r1[lo:hi]):
            changed = True
    assert changed
    # epoch 0 is the identity (init-time shuffle)
    np.testing.assert_array_equal(
        np.asarray(dev.reshuffle_adj(consts, 0).adj_dst).reshape(-1), base)
    # padding tail intact (sorted to the end as zeros)
    np.testing.assert_array_equal(r1[E:], base[E:])


def test_reshuffle_epochs_knob(setup):
    """TrainConfig.reshuffle_epochs (r5, opt-in): the trainer applies the
    per-epoch reshuffle from the INIT constants, so the trajectory is a
    pure function of (seed, epoch) — two identical runs match exactly —
    and differs from the fixed-shuffle default after epoch 0."""
    ds, *_ = setup

    def run(reshuffle):
        model = BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                                  outer_layers=("gcn:16:identity",)))
        tr = MinibatchTrainer(
            model, ds,
            TrainConfig(lr=3e-3, epochs=3, batch_size=16, seed=0,
                        eval_every=3, reshuffle_epochs=reshuffle),
            fanouts=(4, 3), calibrate_caps=4, device_sample=True,
            dispatch_chunk=2)
        params, _ = tr.fit(steps_per_epoch=4)
        return params

    p1 = run(True)
    p2 = run(True)
    p0 = run(False)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    diff = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p0)))
    assert diff, "reshuffle_epochs=True must change the post-epoch-0 draws"


def test_node_cap_calibration_covers_real_draws(setup):
    """The device-calibrated node cap (r5: simulation mirrors the real
    window-draw semantics) must cover real draws — persistent
    ncap_dropped would be a standing estimator bias. The
    draws are (seed, epoch, step)-deterministic, so this gate is exact,
    not flaky."""
    _, _, dev, consts, sample = setup
    total = 0
    for step in range(32):
        _, stats = sample(consts, dev.key_at(0, step))
        total += int(np.asarray(stats["trunc_ncap_dropped"]))
    assert total == 0, total
