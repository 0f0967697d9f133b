"""Multi-host plumbing test: two REAL processes,
each with 2 fake CPU devices, form a 4-device dp=2 x graph=2 hybrid mesh via
jax.distributed and run one P2 train step. Loss and the post-step parameter
checksum must match a single-process run of the same topology, proving the
global-array placement (parallel.global_put), hybrid mesh construction and
the cross-host halo path compose correctly without accelerators."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PROG = os.path.join(REPO, "tests", "_multihost_prog.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_parity():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, PROG], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    for o in outs:
        assert o["global_devices"] == 4, o

    # reference: same topology, one process (this one, 8 fake devices)
    import importlib.util

    spec = importlib.util.spec_from_file_location("_multihost_prog", PROG)
    prog = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prog)
    loss_ref, cs_ref = prog.run_once()
    for o in outs:
        assert np.isclose(o["loss"], loss_ref, rtol=1e-5), (o, loss_ref)
        assert np.isclose(o["checksum"], cs_ref, rtol=1e-5), (o, cs_ref)
