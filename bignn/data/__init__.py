"""Datasets and samplers (SURVEY.md T4; reference data model §2.1 R6/R9).

Array-based schema (no networkx/PyG): a dataset is the outer interaction edge
list + one COOGraph per drug molecule + edge splits. Loaders cover the
synthetic generators (BASELINE.json:7,10) and on-disk DrugBank / BioSNAP
ChCh-Miner caches (BASELINE.json:8-9) with a documented .npz format.
"""

from bignn.data.schema import DDIDataset, DeviceData, prepare_device_data
from bignn.data.synthetic import make_synthetic_ddi
from bignn.data.datasets import load_dataset
from bignn.data.sampler import (
    sample_negative_pairs,
    make_training_pairs,
    EdgeMinibatchSampler,
)
from bignn.data.hierarchical import HierarchicalBatch, HierarchicalSampler
from bignn.data.molecules import (
    smiles_to_graph,
    build_dataset_from_smiles,
    parse_smiles,
)

__all__ = [
    "DDIDataset",
    "DeviceData",
    "prepare_device_data",
    "make_synthetic_ddi",
    "load_dataset",
    "sample_negative_pairs",
    "make_training_pairs",
    "EdgeMinibatchSampler",
    "HierarchicalBatch",
    "HierarchicalSampler",
    "smiles_to_graph",
    "build_dataset_from_smiles",
    "parse_smiles",
]
