"""Dataset registry + on-disk cache format (SURVEY.md T4; reference R6/R9).

The reference ships preprocessed DrugBank / BioSNAP ChCh-Miner caches
downloaded out-of-band (SURVEY.md §2.1 R9). This module defines the
equivalent array cache format (.npz, documented below) and a registry:

  * ``synthetic-small``  — config #1 stand-in (~500 drugs), generated.
  * ``ddi-sample``       — in-repo REAL data: ~66 real drug SMILES + ~146
                           documented interactions (data/real_sample.py).
  * ``drugbank``         — loads ``<root>/drugbank.npz`` if present; else
                           converts a raw reference cache at
                           ``<root>/drugbank{.pkl,/}`` (data/convert.py);
                           else a generated stand-in with DrugBank-like
                           statistics (~1.7K drugs, ~190K interactions).
  * ``biosnap``          — same lookup chain; stand-in is ~1.5K drugs,
                           ~48K interactions.
  * ``synthetic-large``  — config #4 (100K subgraphs / 10M outer edges by
                           default; scaled down via kwargs for tests).

.npz cache schema (per dataset):
  edges          [E, 2] int64          undirected positive interactions
  mol_ptr        [D+1] int64           molecule node offsets
  mol_feat       [sum_n, F] float32    atom features, concatenated
  mol_edge_ptr   [D+1] int64           molecule edge offsets
  mol_src        [sum_e] int64         per-molecule edges (local ids)
  mol_dst        [sum_e] int64
  (optional) train_idx / val_idx / test_idx int64 — else a seeded 80/10/10
  random split is applied.

To convert the reference's klepto caches: iterate its networkx molecule
graphs, emit the concatenated arrays above. (Not runnable here: reference
mount empty + no RDKit; see SURVEY.md header.)
"""

from __future__ import annotations

import os

import numpy as np

from bignn.data.schema import DDIDataset, random_split
from bignn.data.synthetic import make_synthetic_ddi
from bignn.sparse.formats import COOGraph


def load_npz_cache(path: str, name: str, seed: int = 0) -> DDIDataset:
    with np.load(path) as f:
        edges = f["edges"]
        mol_ptr = f["mol_ptr"]
        mol_feat = f["mol_feat"]
        mol_edge_ptr = f["mol_edge_ptr"]
        mol_src = f["mol_src"]
        mol_dst = f["mol_dst"]
        molecules = []
        for i in range(len(mol_ptr) - 1):
            n0, n1 = mol_ptr[i], mol_ptr[i + 1]
            e0, e1 = mol_edge_ptr[i], mol_edge_ptr[i + 1]
            molecules.append(
                COOGraph(
                    node_feat=mol_feat[n0:n1],
                    src=mol_src[e0:e1],
                    dst=mol_dst[e0:e1],
                )
            )
        if "train_idx" in f:
            tr, va, te = f["train_idx"], f["val_idx"], f["test_idx"]
        else:
            tr, va, te = random_split(edges.shape[0], 0.1, 0.1, seed)
    return DDIDataset(
        name=name, molecules=molecules, edges=edges,
        train_idx=tr, val_idx=va, test_idx=te,
    )


def save_npz_cache(ds: DDIDataset, path: str) -> None:
    mol_ptr = np.cumsum([0] + [m.num_nodes for m in ds.molecules]).astype(np.int64)
    mol_edge_ptr = np.cumsum([0] + [m.num_edges for m in ds.molecules]).astype(np.int64)
    np.savez_compressed(
        path,
        edges=ds.edges,
        mol_ptr=mol_ptr,
        mol_feat=np.concatenate([m.node_feat for m in ds.molecules], axis=0),
        mol_edge_ptr=mol_edge_ptr,
        mol_src=np.concatenate([m.src for m in ds.molecules]),
        mol_dst=np.concatenate([m.dst for m in ds.molecules]),
        train_idx=ds.train_idx,
        val_idx=ds.val_idx,
        test_idx=ds.test_idx,
    )


# DrugBank-DDI / BioSNAP ChCh-Miner scale stand-ins (statistics per the BI-GNN
# paper's dataset table [HIGH]; used when no real cache file is available).
_STANDIN_SPECS = {
    "drugbank": dict(num_drugs=1704, avg_degree=222.0, feat_dim=64,
                     min_atoms=8, max_atoms=48, latent_dim=8),
    "biosnap": dict(num_drugs=1514, avg_degree=63.0, feat_dim=64,
                    min_atoms=8, max_atoms=48, latent_dim=8),
}


def load_dataset(
    name: str,
    data_root: str | None = None,
    seed: int = 0,
    **overrides,
) -> DDIDataset:
    """Load a registered dataset by name (see module docstring)."""
    name = name.lower()
    data_root = data_root or os.environ.get("BIGNN_DATA_ROOT", "data")

    if name == "ddi-sample":
        from bignn.data.real_sample import load_real_sample

        return load_real_sample(seed=seed, **overrides)
    if name in ("synthetic-small", "synthetic"):
        kw = dict(num_drugs=500, feat_dim=16, seed=seed, name="synthetic-small")
        kw.update(overrides)
        return make_synthetic_ddi(**kw)
    if name == "synthetic-large":
        kw = dict(
            num_drugs=100_000, feat_dim=32, avg_degree=200.0,
            min_atoms=8, max_atoms=40, latent_dim=8, seed=seed,
            name="synthetic-large",
        )
        kw.update(overrides)
        return make_synthetic_ddi(**kw)
    if name in _STANDIN_SPECS:
        path = os.path.join(data_root, f"{name}.npz")
        if os.path.exists(path):
            return load_npz_cache(path, name, seed)
        # raw reference cache (klepto dir / pickle): convert once, then load
        for raw in (os.path.join(data_root, f"{name}.pkl"),
                    os.path.join(data_root, f"{name}.pickle"),
                    os.path.join(data_root, name)):
            if os.path.exists(raw):
                from bignn.data.convert import convert_reference_cache

                return convert_reference_cache(raw, path, name, seed)
        kw = dict(_STANDIN_SPECS[name])
        kw.update(overrides)
        return make_synthetic_ddi(seed=seed, name=f"{name}-standin", **kw)
    raise ValueError(
        f"unknown dataset {name!r}; known: synthetic-small, synthetic-large, "
        f"{sorted(_STANDIN_SPECS)}"
    )
