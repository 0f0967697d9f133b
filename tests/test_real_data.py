"""Real-data readiness: the in-repo REAL drug
sample trains end-to-end through the SMILES pipeline, and the reference
klepto/pickle cache converter round-trips a synthetic fixture into the .npz
schema."""

import os
import pickle

import numpy as np
import pytest

from bignn.data import load_dataset, prepare_device_data
from bignn.data.convert import convert_reference_cache
from bignn.data.datasets import load_npz_cache
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import Trainer, TrainConfig


def test_real_sample_loads():
    ds = load_dataset("ddi-sample")
    assert ds.num_drugs > 50
    assert ds.edges.shape[0] > 100
    # real molecular graphs: aspirin-sized molecules, one-hot element rows
    sizes = [m.num_nodes for m in ds.molecules]
    assert min(sizes) >= 2 and max(sizes) <= 60
    for m in ds.molecules[:5]:
        assert m.node_feat.sum(axis=1).min() >= 1.0  # element one-hot set


def test_real_sample_trains_end_to_end():
    ds = load_dataset("ddi-sample")
    data = prepare_device_data(ds)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=32, heads=4))
    tr = Trainer(model, data, TrainConfig(lr=2e-3, epochs=8, batch_size=64))
    params, result = tr.fit()
    hist = result["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(result["test_auc"]) and result["test_auc"] > 0.0


def test_real_sample_reaches_auc():
    """The REAL accuracy gate (BASELINE.json:5 AUC axis): config2-real — the full BI-GNN on real molecular graphs + real
    documented interactions — must LEARN, not just run.

    r4 de-flake: the gate averages seeds 0 and 1 so a
    single-seed RNG/rounding wobble cannot flip CI. Measured on CPU CI
    (2026-08-21): seed 0 best_val/test = 0.744/0.724, seed 1 = 0.794/0.790
    -> means 0.769/0.757, clearing the unchanged 0.70 bar with >= 0.05
    margin."""
    import dataclasses

    from bignn.config import get_config

    cfg = get_config("config2-real")
    ds = load_dataset(cfg.dataset)
    data = prepare_device_data(ds)
    best_vals, tests = [], []
    for seed in (0, 1):
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        tr = Trainer(model, data, dataclasses.replace(cfg.train, seed=seed))
        params, result = tr.fit()
        aucs = [r["val_auc"] for r in result["history"] if "val_auc" in r]
        best_vals.append(max(aucs))
        tests.append(result["test_auc"])
    assert np.mean(best_vals) >= 0.70, best_vals
    assert np.mean(tests) >= 0.70, tests


def _fixture_graphs_feat(nx, rng, n_graphs=6):
    graphs = {}
    for i in range(n_graphs):
        g = nx.gnm_random_graph(int(rng.integers(4, 9)),
                                int(rng.integers(4, 12)), seed=int(i))
        for n in g.nodes():
            g.nodes[n]["feat"] = rng.random(5).astype(np.float32)
        graphs[f"drug_{i}"] = g
    return graphs


def test_converter_pickle_feat_vectors(tmp_path):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(0)
    graphs = _fixture_graphs_feat(nx, rng)
    ids = sorted(graphs)
    inter = [(ids[0], ids[1]), (ids[1], ids[2]), (ids[3], ids[4]),
             (ids[0], ids[5]), (ids[2], ids[5]), (ids[1], ids[4])]
    src = tmp_path / "cache.pkl"
    with open(src, "wb") as f:
        pickle.dump({"graphs": graphs, "interactions": inter}, f)
    out = tmp_path / "converted.npz"
    ds = convert_reference_cache(str(src), str(out), "fixture")
    assert ds.num_drugs == len(graphs) and ds.edges.shape == (6, 2)
    ds2 = load_npz_cache(str(out), "fixture")
    assert ds2.num_drugs == ds.num_drugs
    for a, b in zip(ds.molecules, ds2.molecules):
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    # edge symmetry preserved (both bond directions)
    assert all(m.num_edges % 2 == 0 for m in ds.molecules)


def test_converter_type_attr_and_smiles(tmp_path):
    nx = pytest.importorskip("networkx")
    g1 = nx.Graph()
    g1.add_nodes_from([(0, {"type": "C"}), (1, {"type": "O"}),
                       (2, {"type": "C"})])
    g1.add_edges_from([(0, 1), (1, 2)])
    g2 = nx.Graph()
    g2.add_nodes_from([(0, {"type": "N"}), (1, {"type": "C"})])
    g2.add_edge(0, 1)
    src = tmp_path / "cache.pkl"
    with open(src, "wb") as f:
        pickle.dump({"drug_graphs": {"a": g1, "b": g2},
                     "ddi_edges": [("a", "b")]}, f)
    ds = convert_reference_cache(str(src), str(tmp_path / "o.npz"), "t")
    # one-hot over the shared {C, O, N} vocabulary, consistent width
    assert all(m.node_feat.shape[1] == 3 for m in ds.molecules)
    np.testing.assert_allclose(ds.molecules[0].node_feat.sum(axis=1), 1.0)

    # SMILES featurization path: graphs carry no features, smiles dict does
    g3 = nx.Graph()
    g3.add_nodes_from([0, 1])
    g3.add_edge(0, 1)
    with open(src, "wb") as f:
        pickle.dump({"graphs": {"x": g3, "y": g3},
                     "edges": [("x", "y")],
                     "smiles": {"x": "CCO", "y": "CC(=O)O"}}, f)
    ds = convert_reference_cache(str(src), str(tmp_path / "o2.npz"), "t2")
    from bignn.data.molecules import FEAT_DIM

    assert all(m.node_feat.shape[1] == FEAT_DIM for m in ds.molecules)
    assert ds.molecules[0].num_nodes == 3  # CCO parsed, not the bare graph


def test_converter_klepto_dir_layout(tmp_path):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(1)
    graphs = _fixture_graphs_feat(nx, rng, n_graphs=4)
    ids = sorted(graphs)
    # klepto dir_archive layout: one pickled object per key directory
    arch = tmp_path / "archive"
    for key, obj in (("graphs", graphs),
                     ("interactions", [(ids[0], ids[1]), (ids[2], ids[3])])):
        d = arch / f"K_{key}"
        os.makedirs(d)
        with open(d / "output.pkl", "wb") as f:
            pickle.dump(obj, f)
    ds = convert_reference_cache(str(arch), str(tmp_path / "k.npz"), "k")
    assert ds.num_drugs == 4 and ds.edges.shape[0] == 2


def test_load_dataset_converts_raw_cache(tmp_path, monkeypatch):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(2)
    graphs = _fixture_graphs_feat(nx, rng, n_graphs=5)
    ids = sorted(graphs)
    root = tmp_path / "data"
    os.makedirs(root)
    with open(root / "drugbank.pkl", "wb") as f:
        pickle.dump({"graphs": graphs,
                     "interactions": [(ids[0], ids[1]), (ids[1], ids[2])]}, f)
    ds = load_dataset("drugbank", data_root=str(root))
    assert ds.num_drugs == 5  # converted, not the 1704-drug standin
    assert os.path.exists(root / "drugbank.npz")  # cached for next time
    ds2 = load_dataset("drugbank", data_root=str(root))
    assert ds2.num_drugs == 5
