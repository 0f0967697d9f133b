"""Serving surface (bignn/serve.py): precomputed-embedding scorer must
match the trainer's exact scores, top-k must rank consistently, and the
checkpoint-loading CLI path must work end to end."""

import json

import numpy as np
import pytest

from bignn.data import load_dataset
from bignn.models import BiGNN, BiGNNConfig
from bignn.serve import Scorer, main as serve_main
from bignn.train import MinibatchTrainer, TrainConfig


@pytest.fixture(scope="module")
def trained():
    ds = load_dataset("synthetic-small", num_drugs=60, feat_dim=8,
                      avg_degree=6.0)
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    tr = MinibatchTrainer(model, ds, TrainConfig(epochs=1, batch_size=32),
                          fanouts=(4,), calibrate_caps=2)
    params, _ = tr.fit(steps_per_epoch=3)
    return ds, model, tr, params


def test_scorer_matches_exact_scores(trained):
    ds, model, tr, params = trained
    scorer = Scorer(model, ds, params, chunk=64)
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, ds.num_drugs, (100, 2)).astype(np.int64)
    s_serve = scorer.score_pairs(pairs)  # chunked (64 -> pad path too)
    s_exact = tr.score_exact(params, pairs)
    np.testing.assert_allclose(s_serve, s_exact, rtol=1e-5, atol=1e-5)


def test_top_k_ranks_consistently(trained):
    ds, model, tr, params = trained
    scorer = Scorer(model, ds, params, chunk=64)
    ids, scores = scorer.top_k(3, k=5)
    assert len(ids) == 5
    assert 3 not in ids  # self excluded
    # the returned scores are the pair scores, descending
    assert np.all(np.diff(scores) <= 1e-6)
    all_pairs = np.stack([np.full(ds.num_drugs, 3),
                          np.arange(ds.num_drugs)], axis=1)
    full = scorer.score_pairs(all_pairs)
    full[3] = -np.inf
    np.testing.assert_allclose(np.sort(full)[::-1][:5], scores, rtol=1e-5)


def test_serve_cli_from_checkpoint(tmp_path):
    from bignn.config import get_config
    from bignn.run import main as run_main

    run_main([
        "--config", "config1", "--epochs", "1", "--batch-size", "128",
        "--run-dir", str(tmp_path), "--checkpoint-every", "1",
    ])
    pairs = np.stack([np.arange(10), (np.arange(10) * 3 + 1) % 100], axis=1)
    np.save(tmp_path / "pairs.npy", pairs)
    scores = serve_main([
        "--config", "config1", "--ckpt", str(tmp_path / "ckpt"),
        "--pairs", str(tmp_path / "pairs.npy"),
        "--out", str(tmp_path / "scores.npy"),
    ])
    assert np.isfinite(scores).all() and len(scores) == 10
    saved = np.load(tmp_path / "scores.npy")
    np.testing.assert_array_equal(saved, scores)

    ids, s = serve_main([
        "--config", "config1", "--ckpt", str(tmp_path / "ckpt"),
        "--topk", "7", "--k", "5",
    ])
    assert len(ids) == 5 and np.isfinite(s).all()


def test_refresh_swaps_params_live(trained):
    """refresh() must change SERVED scores (r3 review finding: the jitted
    scorer previously closed over the construction-time params, silently
    serving stale weights after refresh)."""
    import jax

    ds, model, tr, params = trained
    scorer = Scorer(model, ds, params, chunk=64)
    pairs = np.stack([np.arange(8), (np.arange(8) * 5 + 2) % ds.num_drugs], 1)
    s1 = scorer.score_pairs(pairs)
    ids1, top1 = scorer.top_k(2, k=4)
    new_params = model.init(jax.random.key(999))  # different weights
    scorer.refresh(new_params)
    s2 = scorer.score_pairs(pairs)
    assert not np.allclose(s1, s2)
    np.testing.assert_allclose(
        s2, tr.score_exact(new_params, pairs), rtol=1e-5, atol=1e-5)
    _, top2 = scorer.top_k(2, k=4)
    assert not np.allclose(top1, top2)


def test_top_k_exclude_known(trained):
    """r4: exclude_known=True masks the query drug's
    train/val partners, so rankings surface NEW candidates; unknown pairs'
    relative order is unchanged."""
    ds, model, tr, params = trained
    scorer = Scorer(model, ds, params, chunk=64)
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    # pick a drug with at least one known partner
    drug = int(known[0, 0])
    partners = set(known[known[:, 0] == drug][:, 1].tolist())
    partners |= set(known[known[:, 1] == drug][:, 0].tolist())
    assert partners
    ids_all, _ = scorer.top_k(drug, k=ds.num_drugs - 1)
    ids_new, scores_new = scorer.top_k(drug, k=10, exclude_known=True)
    assert drug not in ids_new
    assert not (set(ids_new.tolist()) & partners)
    # the surviving ranking equals the unmasked ranking with knowns removed
    expect = [i for i in ids_all.tolist()
              if i not in partners and i != drug][:10]
    # ties could permute equal scores; compare score values instead of ids
    full = scorer.top_k(drug, k=ds.num_drugs - 1)
    np.testing.assert_allclose(
        scores_new,
        np.asarray([full[1][full[0].tolist().index(i)] for i in expect]),
        rtol=1e-6)


def test_top_k_batch(trained):
    """Batched multi-drug top-k == per-drug top_k rows, both mask modes."""
    ds, model, tr, params = trained
    scorer = Scorer(model, ds, params, chunk=64)
    drugs = [0, 3, 7, 11]
    for excl in (False, True):
        ids_b, scores_b = scorer.top_k_batch(drugs, k=6, exclude_known=excl)
        assert ids_b.shape == (4, 6) and scores_b.shape == (4, 6)
        for row, d in enumerate(drugs):
            ids1, scores1 = scorer.top_k(d, k=6, exclude_known=excl)
            np.testing.assert_allclose(scores_b[row], scores1, rtol=1e-6)


def test_one_vs_all_matches_pairwise():
    """The serving rank-all path's one-vs-all scorers (r5: broadcast u's
    row, no [N, 2] pair materialization) must equal the pairwise scorer
    for both heads."""
    import jax
    import jax.numpy as jnp

    from bignn.models.scorer import DotScorer, MLPScorer

    rng = np.random.default_rng(0)
    emb = jnp.asarray(rng.normal(size=(37, 16)).astype(np.float32))
    n = emb.shape[0]
    pairs = jnp.stack([jnp.full(n, 5, jnp.int32),
                       jnp.arange(n, dtype=jnp.int32)], 1)
    dot = DotScorer(16)
    np.testing.assert_allclose(
        np.asarray(dot.apply_one_vs_all({}, emb, jnp.int32(5))),
        np.asarray(dot.apply({}, emb, pairs)), rtol=1e-5, atol=1e-6)
    mlp = MLPScorer(16, hidden=8)
    p = mlp.init(jax.random.key(0))
    np.testing.assert_allclose(
        np.asarray(mlp.apply_one_vs_all(p, emb, jnp.int32(5))),
        np.asarray(mlp.apply(p, emb, pairs)), rtol=1e-5, atol=1e-6)
