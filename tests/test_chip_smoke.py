"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself runs
them at full size on a card), and its refusal to run without a GPU."""

import dataclasses
import os
import subprocess
import sys

import jax

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_parity_phase_tiny():
    chip_smoke.phase_parity(seg_nodes=64, seg_edges=600, adj_nodes=256,
                            adj_edges=1000, gat_nodes=70, model_drugs=40)


def test_parity_check_fails_over_tolerance():
    checks = chip_smoke.Checks()
    checks("op", "float32", fwd=0.0)
    checks("op", "bfloat16", fwd=1.0)
    checks("op", "float32", fwd=float("nan"))
    assert checks.failed == ["op[bfloat16]:fwd", "op[float32]:fwd"]


def test_config2_train_and_serve_tiny():
    ds, tr = chip_smoke.config2_trainer(num_drugs=60, avg_degree=10.0)
    params = chip_smoke.phase_config2(tr, steps=8)
    chip_smoke.phase_serve(ds, tr, params, n_pairs=512, n_queries=2, k=5)


def test_config4_chunk_tiny():
    from bignn.data import make_synthetic_ddi
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.train import MinibatchTrainer, TrainConfig

    ds = make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        dtype="bfloat16"))
    tr = MinibatchTrainer(model, ds, TrainConfig(batch_size=8),
                          fanouts=(4,), calibrate_caps=2, device_sample=True,
                          dispatch_chunk=2)
    chip_smoke.phase_config4(tr)


def test_p2_four_devices_tiny():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_p2_four(num_drugs=40, avg_degree=8.0, steps=2, batch=64)
