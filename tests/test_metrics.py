"""Metric correctness vs sklearn (reference uses sklearn — SURVEY.md §2.1 R7)."""

import jax.numpy as jnp
import numpy as np
from sklearn.metrics import average_precision_score, roc_auc_score

from bignn.train import average_precision, average_precision_jnp, roc_auc, roc_auc_jnp


def test_host_metrics_match_sklearn():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 500)
    scores = rng.normal(size=500)
    assert np.isclose(roc_auc(labels, scores), roc_auc_score(labels, scores))
    assert np.isclose(
        average_precision(labels, scores), average_precision_score(labels, scores)
    )


def test_host_auc_with_ties_matches_sklearn():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 300)
    scores = rng.integers(0, 5, 300).astype(float)  # heavy ties
    assert np.isclose(roc_auc(labels, scores), roc_auc_score(labels, scores))


def test_device_metrics_match_host():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, 400).astype(np.float32)
    scores = rng.normal(size=400).astype(np.float32)
    assert np.isclose(
        float(roc_auc_jnp(jnp.asarray(labels), jnp.asarray(scores))),
        roc_auc(labels, scores),
        atol=1e-5,
    )
    assert np.isclose(
        float(average_precision_jnp(jnp.asarray(labels), jnp.asarray(scores))),
        average_precision(labels, scores),
        atol=1e-5,
    )


def test_device_auc_tie_aware_matches_host():
    # Heavily tied integer scores (bf16 logits at scale produce exactly this):
    # the device AUC must average tied ranks, matching the exact host metric.
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 2, 300).astype(np.float32)
    scores = rng.integers(0, 4, 300).astype(np.float32)
    assert np.isclose(
        float(roc_auc_jnp(jnp.asarray(labels), jnp.asarray(scores))),
        roc_auc(labels, scores),
        atol=1e-6,
    )
    # a 6-element adversarial tie case (a raw argsort gives 0.556)
    labels6 = np.array([1, 0, 1, 0, 1, 0], np.float32)
    scores6 = np.array([1.0, 1.0, 1.0, 0.0, 2.0, 2.0], np.float32)
    assert np.isclose(
        float(roc_auc_jnp(jnp.asarray(labels6), jnp.asarray(scores6))),
        roc_auc(labels6, scores6),
        atol=1e-6,
    )


def test_device_auc_tie_aware_masked():
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 2, 200).astype(np.float32)
    scores = rng.integers(0, 3, 200).astype(np.float32)
    mask = np.ones(200, np.float32)
    mask[160:] = 0.0
    auc_masked = float(
        roc_auc_jnp(jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask))
    )
    assert np.isclose(auc_masked, roc_auc(labels[:160], scores[:160]), atol=1e-6)


def test_device_metrics_masked():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, 200).astype(np.float32)
    scores = rng.normal(size=200).astype(np.float32)
    mask = np.ones(200, np.float32)
    mask[150:] = 0.0  # padded tail
    auc_masked = float(roc_auc_jnp(jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask)))
    auc_sub = roc_auc(labels[:150], scores[:150])
    assert np.isclose(auc_masked, auc_sub, atol=1e-5)
    ap_masked = float(
        average_precision_jnp(jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask))
    )
    ap_sub = average_precision(labels[:150], scores[:150])
    assert np.isclose(ap_masked, ap_sub, atol=1e-5)
