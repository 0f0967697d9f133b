"""Shared program for the 2-process CPU multihost parity test
(tests/test_multihost.py).

Run as a worker:  JAX_COORDINATOR_ADDRESS=... JAX_NUM_PROCESSES=2
JAX_PROCESS_ID=i python tests/_multihost_prog.py   (2 fake CPU devices each)
Imported by the parent test, it computes the single-process reference on the
same dp=2 x graph=2 topology.
"""

import json
import os
import sys


def run_once():
    """One P2 train step on a dp=2 x graph=2 mesh; returns (loss, checksum).

    Deterministic from fixed seeds, so every process — and the
    single-process reference — must produce the same numbers."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import PartitionSpec as P

    from bignn.data import make_synthetic_ddi
    from bignn.models import BiGNN, BiGNNConfig
    from bignn.parallel import (
        build_outer_partition,
        build_sharded_inner,
        device_put_plan,
        global_put,
        make_hybrid_mesh,
        make_mesh,
        make_p2_train_step,
    )

    ds = make_synthetic_ddi(num_drugs=32, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=0)
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    if jax.process_count() > 1:
        mesh = make_hybrid_mesh(graph=2)  # graph spans the host dim
    else:
        mesh = make_mesh(dp=2, graph=2, devices=jax.devices()[:4])
    tr = ds.split_edges("train")
    plan = build_outer_partition(tr[:, 0], tr[:, 1], ds.num_drugs, 2)
    inner = build_sharded_inner(ds.molecules, plan)

    rep = lambda x: global_put(mesh, P(), x)
    optimizer = optax.adam(1e-3)
    params = jax.tree.map(
        lambda x: rep(np.asarray(x)), model.init(jax.random.key(0)))
    opt_state = optimizer.init(params)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs)
    inner_d, esrc, edst, ew, sidx = device_put_plan(mesh, plan, inner)

    rng = np.random.default_rng(0)
    pos = rep(rng.integers(0, ds.num_drugs, (16, 2)).astype(np.int32))
    mask = rep(np.ones(16, np.float32))
    key = jax.random.wrap_key_data(
        rep(np.asarray(jax.random.key_data(jax.random.key(1)))))
    with mesh:
        params, opt_state, loss = step(
            params, opt_state, key, pos, mask, inner_d, esrc, edst, ew, sidx)
    checksum = sum(
        float(jnp.sum(jnp.abs(l))) for l in jax.tree.leaves(params)
    )
    return float(loss), checksum


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bignn.parallel import init_distributed

    init_distributed()  # env-driven (JAX_COORDINATOR_ADDRESS / ..._ID)
    loss, checksum = run_once()
    print(json.dumps({
        "proc": jax.process_index(), "loss": loss, "checksum": checksum,
        "global_devices": jax.device_count(),
    }), flush=True)
