"""Which implementation an op with a hand-written GPU kernel takes.

One rule: on a CUDA GPU the Pallas (Triton) kernels in ``ops/pallas/`` run;
on every other platform the plain XLA composition runs. Tests reach the
kernels on the CPU by calling them directly with ``interpret=True``.
"""

from __future__ import annotations

import jax


def use_gpu_kernels() -> bool:
    return jax.default_backend() == "gpu"
