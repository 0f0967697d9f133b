"""Negative sampler determinism + minibatcher shape stability
(SURVEY.md §4 item 6)."""

import jax
import jax.numpy as jnp
import numpy as np

from bignn.data import EdgeMinibatchSampler, make_training_pairs, sample_negative_pairs


def test_negative_sampler_deterministic():
    pos = jnp.asarray(np.random.default_rng(0).integers(0, 50, (20, 2)), jnp.int32)
    a = sample_negative_pairs(jax.random.key(7), pos, 50, ratio=2)
    b = sample_negative_pairs(jax.random.key(7), pos, 50, ratio=2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = sample_negative_pairs(jax.random.key(8), pos, 50, ratio=2)
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_negative_sampler_corrupts_one_endpoint():
    pos = jnp.asarray([[3, 9]] * 100, jnp.int32)
    neg = np.asarray(sample_negative_pairs(jax.random.key(0), pos, 1000))
    keeps_left = neg[:, 0] == 3
    keeps_right = neg[:, 1] == 9
    # exactly one endpoint kept per row (modulo the tiny chance the random
    # node equals the original — impossible here since nodes < 1000 drawn
    # uniformly would rarely hit; assert at least one side kept)
    assert np.all(keeps_left | keeps_right)
    assert 20 < keeps_left.sum() < 80  # fair coin


def test_training_pairs_labels():
    pos = jnp.asarray([[0, 1], [2, 3]], jnp.int32)
    pairs, labels = make_training_pairs(jax.random.key(0), pos, 10, neg_ratio=2)
    assert pairs.shape == (6, 2)
    np.testing.assert_array_equal(np.asarray(labels), [1, 1, 0, 0, 0, 0])


def test_minibatch_static_shapes_and_coverage():
    pos = np.arange(20).reshape(10, 2).astype(np.int32)
    s = EdgeMinibatchSampler(pos, batch_size=4, seed=0)
    seen = []
    for pairs, mask in s.epoch():
        assert pairs.shape == (4, 2)
        assert mask.shape == (4,)
        seen.extend(pairs[mask > 0].tolist())
    assert sorted(p[0] for p in seen) == sorted(pos[:, 0].tolist())
