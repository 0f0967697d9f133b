"""Experiment configs (SURVEY.md §5 config row; BASELINE.json:7-11).

Typed replacement for the reference's global argparse FLAGS: one frozen
dataclass per experiment, the model described as layer-spec data (the
reference's good idea, kept). The five milestone configs from BASELINE.json
are registered by name.
"""

from __future__ import annotations

import dataclasses

from bignn.models.bignn import BiGNNConfig
from bignn.train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    dataset: str
    dataset_kwargs: dict
    model: BiGNNConfig
    train: TrainConfig
    mode: str = "full"  # "full" | "minibatch" | "p2"
    fanouts: tuple[int, ...] = (10,)
    max_drugs: int | None = None  # minibatch drug budget cap
    dispatch_chunk: int = 1  # K scanned steps per dispatch (minibatch mode)
    # device-resident sampling (data/device_sampler.py): the epoch runs as
    # a device-only scan with zero per-step host work — the fastest
    # minibatch mode; composes with dp (per-shard draws inside shard_map).
    # Requires the block-local quantized layout.
    device_sample: bool = False
    max_buckets: int = 4
    # distribution (used by run.py when the mesh has >1 device)
    dp: int | None = None
    graph_shards: int = 1


def _feat(dataset_kwargs, default):
    return dataset_kwargs.get("feat_dim", default)


def get_config(name: str, **overrides) -> ExperimentConfig:
    """Milestone configs #1-#5 (BASELINE.json:7-11) + aliases."""
    registry = {
        # 1: 2-layer GCN inner + 1-layer GCN outer, small DDI, CPU-runnable
        "config1": ExperimentConfig(
            name="config1",
            dataset="synthetic-small",
            dataset_kwargs=dict(num_drugs=500, feat_dim=16),
            model=BiGNNConfig.config1(feat_dim=16),
            train=TrainConfig(lr=5e-3, epochs=20, batch_size=256),
        ),
        # 2: full BI-GNN (GIN inner, GAT outer) on DrugBank DDI
        "config2": ExperimentConfig(
            name="config2",
            dataset="drugbank",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=2048),
        ),
        # 2r: config #2's model on the in-repo REAL drug sample (real SMILES
        # -> molecular graphs, real documented interactions) — the
        # real-molecular-data end-to-end path while the reference caches are
        # unreachable (data/real_sample.py)
        "config2-real": ExperimentConfig(
            name="config2-real",
            dataset="ddi-sample",
            dataset_kwargs=dict(),
            # dim 16 / wd 1e-3: tuned for the 66-drug sample (a dim-64
            # model overfits 104 train edges); hits val/test AUC >= 0.70 at
            # fixed seeds — the real-data accuracy gate
            # (tests/test_real_data.py::test_real_sample_reaches_auc)
            model=BiGNNConfig.full_bignn(feat_dim=21, dim=16, heads=2),
            train=TrainConfig(lr=3e-3, epochs=60, batch_size=64, seed=1,
                              weight_decay=1e-3),
        ),
        # 3: BioSNAP, mini-batched hierarchical sampling, bucketed molecules
        "config3": ExperimentConfig(
            name="config3",
            dataset="biosnap",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=512),
            mode="minibatch",
            fanouts=(10, 5),
        ),
        # 4: large synthetic graph-of-graphs, neighbor sampling
        "config4": ExperimentConfig(
            name="config4",
            dataset="synthetic-large",
            dataset_kwargs=dict(),
            # bf16 compute: the dtype the benches measure
            model=dataclasses.replace(
                BiGNNConfig.full_bignn(feat_dim=32, dim=128, heads=4),
                dtype="bfloat16"),
            # lr 3e-4: at this scale lr 1e-3 collapses the model to
            # constant prediction (loss -> ln 2) within ~1.5K steps
            # (measured r3 on host AND device sampling); 3e-4 trains stably
            # (loss 0.70 -> 0.67 over 1.6K steps, val AUC 0.61 at 2K).
            # grad_clip=1.0 measured WORSE here (loss rising by 1K steps in
            # both dtypes) despite being correct at small scale - left off.
            train=TrainConfig(lr=3e-4, epochs=5, batch_size=1024),
            mode="minibatch",
            # r4: ONE hop — the model has a single outer GAT layer, so the
            # outer receptive field of every scored pair is its 1-hop
            # neighborhood (the GraphSAGE depth rule: sampling hops =
            # propagation layers). A (10, 5) second hop adds no nodes at
            # this scale (the drug budget saturates at hop 0,
            # device_sampler calibration) and only ~9K net outer edges.
            fanouts=(10,),
            max_drugs=16384,
            dispatch_chunk=8,
            device_sample=True,
        ),
        # 5: edge-partitioned outer graph across devices (halo a2a)
        "config5": ExperimentConfig(
            name="config5",
            dataset="drugbank",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=2048),
            mode="p2",
            graph_shards=4,
        ),
        # 5L (r5): the edge-partitioned path AT THE SCALE THAT MOTIVATES
        # IT — config #4's 100K-drug / 10M-outer-edge graph partitioned
        # over 8 shards. Same model/dtype/lr recipe as
        # config4 (bf16, lr 3e-4 — the measured-stable recipe at this
        # scale); full-graph p2 steps, so batch counts pairs per step.
        # Plan/balance/memory characterization: scripts/p2_scale_stats.py;
        # invariants gated by tests/test_p2_scale_plan.py.
        "config5-large": ExperimentConfig(
            name="config5-large",
            dataset="synthetic-large",
            dataset_kwargs=dict(),
            model=dataclasses.replace(
                BiGNNConfig.full_bignn(feat_dim=32, dim=128, heads=4),
                dtype="bfloat16"),
            train=TrainConfig(lr=3e-4, epochs=5, batch_size=1024),
            mode="p2",
            graph_shards=8,
        ),
    }
    registry["small"] = registry["config1"]
    registry["real"] = registry["config2-real"]
    registry["drugbank"] = registry["config2"]
    registry["biosnap"] = registry["config3"]
    registry["large"] = registry["config4"]
    registry["distributed"] = registry["config5"]
    try:
        cfg = registry[name]
    except KeyError:
        raise ValueError(f"unknown config {name!r}; known: {sorted(registry)}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
