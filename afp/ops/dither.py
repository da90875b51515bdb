"""Requantization dither (device hot path, JAX).

The reference's ``apply_dither`` (`reference/stream_process.py:61-64`)
adds a *single* uniform noise sample per output — rectangular-PDF (RPDF)
dither despite the "TPDF" docstring — with amplitude ``2/2**bit_depth`` and
unseeded ``np.random``.

Here both flavors are first-class, keyed on a threefry PRNG so batched
streams decorrelate deterministically (SURVEY.md §7 "TPDF dither
determinism"):

* ``kind='rpdf'`` — bit-compatible with the reference's math:
  ``(u − 0.5) · 2 / 2**bits``,
* ``kind='tpdf'`` — proper triangular dither (difference of two uniforms,
  ±1 LSB peak), the documented fidelity upgrade,
* ``kind='off'``  — pass-through (for golden-diff tests).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["dither"]


def dither(key: jax.Array, x: jnp.ndarray, bit_depth: int = 24,
           kind: str = "tpdf") -> jnp.ndarray:
    """Add requantization dither to `x` ([..., T]); one key per block."""
    x = jnp.asarray(x, dtype=jnp.float32)
    if kind == "off":
        return x
    lsb = 2.0 ** (1 - bit_depth)  # == 2 / 2**bit_depth, reference amplitude
    if kind == "rpdf":
        u = jax.random.uniform(key, x.shape, dtype=jnp.float32)
        return x + (u - 0.5) * lsb
    if kind == "tpdf":
        k1, k2 = jax.random.split(key)
        u1 = jax.random.uniform(k1, x.shape, dtype=jnp.float32)
        u2 = jax.random.uniform(k2, x.shape, dtype=jnp.float32)
        return x + (u1 - u2) * lsb
    raise ValueError(f"kind must be 'rpdf', 'tpdf' or 'off', got {kind!r}")
