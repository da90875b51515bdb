"""Spectrum analysis ops (device, JAX).

Re-creates the live spectrum / waterfall math of the reference GUIs:

* per-block windowed rfft magnitude in dB with peak pick
  (`reference/stream_process_EQ_GUI.py:395-411`),
* waterfall ring buffer of the last 50 spectra
  (`reference/stream_process_GUI_Waterfall.py:112, 471-478`),
* frequency axis scaled to the original rate when analyzing the upsampled
  signal (`stream_process_EQ_GUI.py:400-401`).

All ops are batched ([..., T]) and jit-friendly; the waterfall ring is a
fixed-shape rolling buffer suitable as a `lax.scan` carry.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["spectrum_db", "spectrum_db_np", "spectrum_peak",
           "waterfall_init", "waterfall_push",
           "WATERFALL_DEPTH"]

#: History depth of the reference's waterfall deque
#: (`stream_process_GUI_Waterfall.py:112`).
WATERFALL_DEPTH = 50


def spectrum_db(x: jnp.ndarray, window: np.ndarray | None = None,
                floor: float = 1e-10) -> jnp.ndarray:
    """Windowed |rfft| in dB: [..., T] → [..., T//2+1].

    Default window is Hann (periodic), the reference's analysis window
    (`stream_process_GUI_Waterfall.py:471-474`).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    T = x.shape[-1]
    if window is None:
        from ..design.windows import hann

        window = hann(T)  # periodic, matches scipy get_window default
    w = jnp.asarray(np.asarray(window), dtype=jnp.float32)
    mag = jnp.abs(jnp.fft.rfft(x * w))
    return 20.0 * jnp.log10(mag + floor)


def spectrum_freqs(T: int, fs: float) -> np.ndarray:
    """rfft bin frequencies in Hz (host-side, static)."""
    return np.fft.rfftfreq(T, d=1.0 / fs)


def spectrum_db_np(x: np.ndarray, window: np.ndarray | None = None,
                   floor: float = 1e-10) -> np.ndarray:
    """Host-side (numpy) :func:`spectrum_db` — the serving drain tap's
    analysis path (`runtime.serving.RingServer(spectrum_every=)`): a
    device dispatch per observed block would steal serving throughput,
    and the drained block is already host-resident.  Same Hann window
    and dB mapping as the device version (float32 end to end)."""
    x = np.asarray(x, dtype=np.float32)
    T = x.shape[-1]
    if window is None:
        from ..design.windows import hann

        window = hann(T)
    w = np.asarray(window, dtype=np.float32)
    mag = np.abs(np.fft.rfft(x * w)).astype(np.float32)
    return 20.0 * np.log10(mag + np.float32(floor))


def spectrum_peak(db: jnp.ndarray, freqs: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Peak (freq, level) per spectrum — the GUI's peak annotation
    (`stream_process_EQ_GUI.py:404-409`)."""
    idx = jnp.argmax(db, axis=-1)
    f = jnp.asarray(freqs, dtype=jnp.float32)[idx]
    return f, jnp.take_along_axis(db, idx[..., None], axis=-1)[..., 0]


def waterfall_init(n_bins: int, depth: int = WATERFALL_DEPTH,
                   batch_shape: tuple = ()) -> jnp.ndarray:
    """Fixed-shape spectrum history ring: [..., depth, n_bins], primed with
    the dB floor."""
    return jnp.full(batch_shape + (depth, n_bins), -200.0, dtype=jnp.float32)


def waterfall_push(ring: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Roll the ring one step and append the newest spectrum (newest last,
    like the reference's deque append)."""
    rolled = jnp.roll(ring, -1, axis=-2)
    return rolled.at[..., -1, :].set(db)
