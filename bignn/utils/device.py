"""The accelerator a run is on, as JAX and ``nvidia-smi`` report it.

Every measurement this repository prints names its device with
``device_info()``; measurement entry points call ``require_gpu()`` first so
that no number from a CPU run is ever read as a GPU one.
"""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi() -> str | None:
    """``name, power.limit`` of the first card, or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_info() -> dict:
    d = jax.devices()[0]
    smi = nvidia_smi()
    name, _, limit = (smi or "").partition(",")
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "gpu_name": name.strip() or None,
        "power_limit": limit.strip() or None,
    }


def require_gpu() -> None:
    """Exit non-zero unless JAX's default device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {platform!r}; this "
            "measurement runs only on the GPU")
