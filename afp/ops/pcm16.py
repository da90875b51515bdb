"""int16 PCM conversion at the device boundary.

Sample ``n`` means ``n / 32768`` (−32768 → −1.0), the convention of WAV PCM,
`utils.wavio.read_wav` and the sounddevice int16 mapping.  The scale is a
power of two, so ingest is exact in float32.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["PCM16_SCALE", "quantize_pcm16", "pcm16_to_f32"]

PCM16_SCALE = 1.0 / 32768.0


def pcm16_to_f32(x: jnp.ndarray) -> jnp.ndarray:
    """int16 PCM → float32 (exact)."""
    return jnp.asarray(x).astype(jnp.float32) * PCM16_SCALE


def quantize_pcm16(y: jnp.ndarray) -> jnp.ndarray:
    """float32 → int16 PCM: ``int16(clip(round(y·32768), −32768, 32767))``,
    round half-to-even.  The inverse is :func:`pcm16_to_f32`."""
    return jnp.clip(jnp.round(y * 32768.0), -32768.0, 32767.0
                    ).astype(jnp.int16)
