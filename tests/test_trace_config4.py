"""scripts/trace_config4.py at a tiny size on the CPU: the in-step block
adjacency check, the timed ceiling step, and the trace reduction."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest

from scripts import trace_config4 as tc4


@pytest.fixture(scope="module")
def trainer():
    from bignn.data import make_synthetic_ddi
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.train import MinibatchTrainer, TrainConfig

    ds = make_synthetic_ddi(num_drugs=48, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        dtype="bfloat16"))
    return MinibatchTrainer(model, ds, TrainConfig(batch_size=8),
                            fanouts=(4,), calibrate_caps=2,
                            device_sample=True, dispatch_chunk=2)


def test_block_adjacency_of_a_real_batch(trainer):
    adj = tc4.check_block_adjacency(trainer, tc4.sample_batches(trainer, 1),
                                    reps=1)
    assert adj["count_dtype"] == "int8"
    assert adj["mismatches"] == 0 and adj["cross_block_edges"] == 0
    assert 1 <= adj["max_cell_multiplicity"] <= 127
    assert 0 < adj["real_edges"] <= adj["edge_slots"]


def test_run_tiny(trainer, tmp_path):
    lines = []
    line = tc4.run(trainer, reps=2, trace_dir=str(tmp_path), emit=lines.append)
    assert line["steps_per_scan"] == 8 and len(line["step_ms"]) == 2
    recs = [json.loads(s) for s in lines]
    assert [next(iter(r)) for r in recs] == [
        "block_adjacency", "compile_s", "trace"]
    assert recs[-1]["device_ms"] == {}  # no GPU plane in a CPU trace


def test_device_op_times_reduces_a_recorded_trace(tmp_path):
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    out = tc4.device_op_times(str(tmp_path), steps=1, plane_prefix="/host")
    assert out
    for v in out.values():
        assert v["busy_ms_per_step"] > 0
        assert sum(v["top_ms_per_step"].values()) >= 0
