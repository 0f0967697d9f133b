"""Device mesh construction (SURVEY.md T6; conventions from SNIPPETS.md:160-200).

Single entry point so every component agrees on axis names:
  * ``dp``    — data parallel over edge minibatches (P1).
  * ``graph`` — outer-graph edge partition axis (P2); on several hosts it
                is laid out host-major, so the halo all-to-all stays within
                a host group and crosses between hosts only where it must.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(
    dp: int | None = None,
    graph: int = 1,
    devices: list | None = None,
    tp: int = 1,
) -> Mesh:
    """Build a ('dp', 'graph') mesh — or ('dp', 'tp') when ``tp`` > 1
    (P3 feature-dim sharding, parallel/tp.py; tp and graph don't compose:
    the halo path assumes full-width rows). Defaults: all devices on 'dp'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tp > 1:
        if graph != 1:
            raise ValueError("tp and graph axes don't compose (see docstring)")
        if dp is None:
            dp = n // tp
        if dp * tp != n:
            raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
        return Mesh(np.asarray(devices).reshape(dp, tp),
                    axis_names=("dp", "tp"))
    if dp is None:
        dp = n // graph
    if dp * graph != n:
        raise ValueError(f"dp({dp}) * graph({graph}) != device count ({n})")
    arr = np.asarray(devices).reshape(dp, graph)
    return Mesh(arr, axis_names=("dp", "graph"))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> int:
    """Multi-host entry: wire up jax.distributed so jax.devices() is the
    GLOBAL device set (config #5, BASELINE.json:11).

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); a multi-process launch must give all
    three (a coordinator on ``localhost:<port>`` for one host).
    Returns this host's process index. Idempotent: repeated calls (or a
    single-process launch with no coordinator anywhere) are no-ops.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return jax.process_index()  # single-process: nothing to initialize
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return jax.process_index()


def make_hybrid_mesh(dp: int | None = None, graph: int | None = None) -> Mesh:
    """('dp', 'graph') mesh over ALL processes' devices, host-major.

    The 'graph' axis (the P2 edge-partition / halo all-to-all axis) is laid
    out so each host's shards are contiguous: graph = (host dim, between
    hosts) x (per-host dim, within a host). Per-outer-layer halo exchange
    then stays within a host group and crosses between hosts only between
    groups — the layout SURVEY.md §5 (dist-comm row) prescribes. Defaults:
    graph spans the host dimension exactly (one graph shard group per
    host), dp fills the rest of each host's devices.

    Single-process (or 1 host) falls back to a plain local mesh.
    """
    nproc = jax.process_count()
    nloc = jax.local_device_count()
    if nproc == 1:
        return make_mesh(dp=dp, graph=graph or 1)
    graph = graph if graph is not None else nproc
    if graph % nproc != 0:
        raise ValueError(
            f"graph ({graph}) must be a multiple of process count ({nproc}) "
            "so every host owns whole graph-shard groups")
    host_graph = graph // nproc
    if nloc % host_graph != 0:
        raise ValueError(
            f"per-host graph dim ({host_graph}) must divide local device "
            f"count ({nloc})")
    host_dp = nloc // host_graph
    if dp is not None and dp != host_dp:
        raise ValueError(
            f"dp ({dp}) inconsistent with {nloc} local devices / "
            f"{host_graph} per-host graph shards (expected {host_dp})")
    # graph axis host-major, so each host's graph shards stay contiguous
    # (intra-host links) and only adjacent host groups cross between hosts
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    arr = (
        np.asarray(devs)
        .reshape(nproc, host_dp, host_graph)
        .transpose(1, 0, 2)
        .reshape(host_dp, nproc * host_graph)
    )
    return Mesh(arr, axis_names=("dp", "graph"))


def global_put(mesh: Mesh, spec: PartitionSpec, x) -> jax.Array:
    """Place a host-replicated NumPy array as a GLOBAL jax.Array.

    Works identically in single- and multi-process runs (device_put cannot
    target non-addressable shardings, make_array_from_callback can): every
    process holds the full ``x`` (plans/batches are deterministic from the
    shared seed) and contributes its local shards.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
