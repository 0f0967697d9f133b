"""Native C++ graph builder parity vs the NumPy path (bignn/native)."""

import numpy as np
import pytest

from bignn import native
from bignn.sparse import formats as F


def _rand_edges(n, e, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


def test_build_sorted_graph_matches_numpy():
    n, e = 500, 4000
    src, dst = _rand_edges(n, e)
    s, d, w = native.build_sorted_graph(src, dst, n)
    assert np.all(np.diff(d) >= 0)
    assert len(s) == e + n  # self loops appended
    s2, d2, w2 = F.gcn_normalize(src, dst, n, add_self_loops=True)
    order = np.argsort(d2, kind="stable")
    d2, w2 = d2[order], w2[order]
    assert np.array_equal(d, d2)
    # per-destination weighted sums are order-invariant -> must match exactly
    np.testing.assert_allclose(
        np.bincount(d, weights=w, minlength=n),
        np.bincount(d2.astype(np.int64), weights=w2, minlength=n),
        rtol=1e-5,
    )


def test_build_sorted_graph_no_norm_no_loops():
    n, e = 100, 700
    src, dst = _rand_edges(n, e, 1)
    s, d, w = native.build_sorted_graph(
        src, dst, n, add_self_loops=False, normalize=False
    )
    assert len(s) == e
    assert np.all(w == 1.0)
    assert np.all(np.diff(d) >= 0)
    assert np.array_equal(np.sort(d), np.sort(dst))


def test_build_sorted_graph_oob_raises():
    if not native.available():
        pytest.skip("no native lib")
    src = np.array([0, 5], np.int32)
    dst = np.array([1, 2], np.int32)
    with pytest.raises(ValueError):
        native.build_sorted_graph(src, dst, num_nodes=3)


def test_in_degrees():
    n, e = 50, 300
    src, dst = _rand_edges(n, e, 2)
    deg = native.in_degrees(dst, n)
    np.testing.assert_array_equal(deg, np.bincount(dst, minlength=n))


def test_partition_hash_consistent_and_balanced():
    n, e = 1000, 50_000
    src, dst = _rand_edges(n, e, 3)
    p1 = native.partition_edges_hash(src, dst, 8)
    # both directions of an undirected edge land on the same shard
    p2 = native.partition_edges_hash(dst, src, 8)
    np.testing.assert_array_equal(p1, p2)
    frac = np.bincount(p1, minlength=8) / e
    assert frac.max() < 0.2 and frac.min() > 0.05
