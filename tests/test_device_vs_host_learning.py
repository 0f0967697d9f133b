"""Device-vs-host sampling estimators LEARN equivalently.

The two pipelines are separate-but-equivalent estimators (different RNG
streams and packing order — device_sampler.py docstring); this gate trains
the same model through BOTH at an identical step budget and seed on a
latent-structure synthetic and requires (a) both clear an above-chance AUC
bar and (b) their final AUCs agree within a tolerance. If the device
sampler's class-packed layout, truncation order, or edge-only-hop
calibration biased sampling in a way that hurts learning, (a)/(b) catch it.
The flagship-scale paired curves come from
scripts/validate_config4_learning.py, run on the GPU.
"""

import numpy as np

from bignn.data import make_synthetic_ddi
from bignn.models import BiGNN, BiGNNConfig
from bignn.train import MinibatchTrainer, TrainConfig


def test_device_vs_host_learning():
    ds = make_synthetic_ddi(num_drugs=150, feat_dim=16, avg_degree=10.0,
                            min_atoms=4, max_atoms=12, latent_dim=4, seed=7)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=16, dim=32, heads=2))
    # r5: THREE seeds averaged per mode and a +-0.03
    # gate — a single-seed +-0.06 tolerance could hide a device-estimator
    # bias eating a third of the learnable signal (~0.13 above chance).
    # Per-seed spread is real (host seeds measured 0.610-0.713); the
    # 3-seed means are stable enough for the tight gate.
    auc = {}
    for mode in (True, False):
        runs = []
        for seed in (0, 1, 2):
            tr = MinibatchTrainer(
                model, ds,
                TrainConfig(lr=3e-3, epochs=10, batch_size=48, seed=seed,
                            eval_every=10),
                fanouts=(6,), calibrate_caps=4, device_sample=mode,
                dispatch_chunk=4)
            _, result = tr.fit(steps_per_epoch=16)
            runs.append(result["test_auc"])
        auc[mode] = float(np.mean(runs))
    # measured on CPU CI (3-seed means): device 0.640 / host 0.656,
    # |delta| = 0.017
    assert auc[True] >= 0.58, auc
    assert auc[False] >= 0.58, auc
    assert abs(auc[True] - auc[False]) <= 0.03, auc
