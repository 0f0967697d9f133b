"""SMILES parser + featurizer (reference R9 dataset-prep parity)."""

import numpy as np
import pytest

from bignn.data.molecules import (
    FEAT_DIM,
    SmilesError,
    build_dataset_from_smiles,
    parse_smiles,
    smiles_to_graph,
)


@pytest.mark.parametrize(
    "smiles,n_atoms,n_bonds",
    [
        ("C", 1, 0),                    # methane
        ("CCO", 3, 2),                  # ethanol
        ("CC(C)C", 4, 3),               # isobutane
        ("c1ccccc1", 6, 6),             # benzene (aromatic ring)
        ("C1CCCCC1", 6, 6),             # cyclohexane
        ("CC(=O)O", 4, 3),              # acetic acid
        ("N#N", 2, 1),                  # dinitrogen, triple bond
        ("ClCCl", 3, 2),                # dichloromethane (two-letter atoms)
        ("c1ccc2ccccc2c1", 10, 11),     # naphthalene (fused rings)
        ("CC(=O)Oc1ccccc1C(=O)O", 13, 13),  # aspirin
        ("[Na].[Cl]", 2, 0),            # disconnected ions (bracket atoms)
        ("CN1CCC[C@H]1c1ccncc1", 12, 13),   # nicotine (chirality ignored)
    ],
)
def test_parse_known_molecules(smiles, n_atoms, n_bonds):
    atoms, bonds = parse_smiles(smiles)
    assert len(atoms) == n_atoms
    assert len(bonds) == n_bonds


def test_bond_orders():
    _, bonds = parse_smiles("C=C")
    assert bonds[0][2] == 2
    _, bonds = parse_smiles("C#N")
    assert bonds[0][2] == 3


def test_aromatic_flag():
    atoms, _ = parse_smiles("c1ccccc1")
    assert all(a["aromatic"] for a in atoms)
    g = smiles_to_graph("c1ccccc1")
    assert np.all(g.node_feat[:, -1] == 1.0)


def test_features_shape_and_degree():
    g = smiles_to_graph("CC(C)C")  # central carbon degree 3
    assert g.node_feat.shape == (4, FEAT_DIM)
    # degree one-hot: central atom (index 1) has degree 3
    from bignn.data.molecules import ELEMENTS
    deg_slot = len(ELEMENTS) + 1 + 3
    assert g.node_feat[1, deg_slot] == 1.0


@pytest.mark.parametrize("bad", ["C1CC", "(C)C)", "C$", ""])
def test_bad_smiles_raise(bad):
    with pytest.raises(SmilesError):
        parse_smiles(bad)


def test_build_dataset_from_smiles_trains():
    import jax

    smiles = ["CCO", "CC(C)C", "c1ccccc1", "CC(=O)O", "CCN", "CCC",
              "c1ccncc1", "CC(=O)Oc1ccccc1C(=O)O"]
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 8, 20), rng.integers(0, 8, 20)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    ds = build_dataset_from_smiles(smiles, edges)
    assert ds.num_drugs == 8 and ds.feat_dim == FEAT_DIM

    from bignn.data import prepare_device_data
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.train import Trainer, TrainConfig

    data = prepare_device_data(ds, max_buckets=2)
    tr = Trainer(BiGNN(BiGNNConfig.config1(feat_dim=ds.feat_dim)), data,
                 TrainConfig(epochs=2, batch_size=16))
    params, res = tr.fit()
    assert np.isfinite(res["history"][-1]["loss"])
