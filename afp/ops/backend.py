"""Backend selection: which implementation of each stage runs.

* ``"gpu"`` — the compiled kernels (Pallas through Triton), never in
  interpret mode;
* ``"cpu"`` — the plain JAX references, for tests and small runs.

Any other JAX backend is an error: nothing here is written for it.
"""
from __future__ import annotations

import jax

__all__ = ["device_platform"]


def device_platform() -> str:
    """``"gpu"`` or ``"cpu"`` from ``jax.default_backend()``; raises on
    anything else."""
    p = jax.default_backend()
    if p in ("gpu", "cpu"):
        return p
    raise RuntimeError(
        f"unsupported JAX backend {p!r}: afp runs its compiled kernels on "
        "NVIDIA GPUs and its plain references on the CPU")
