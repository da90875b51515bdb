"""Minimum-phase FIR conversion (homomorphic / Hilbert cepstral method).

Re-creates the capability the reference gets from
``scipy.signal.minimum_phase(h, method="hilbert")``, which the GUI engines
apply to symmetric (linear-phase) kernels and then re-normalize by peak |H|
(`reference/stream_process_EQ_GUI.py:57-63, 377-379`).

Both the 'hilbert' (Chen–Parks style spectral factorization via the discrete
Hilbert transform) and 'homomorphic' (cepstral, Oppenheim & Schafer §13)
methods are implemented first-party; golden tests diff against scipy.

Host-side float64 numpy (cold design path).

Attribution: the 'hilbert' branch (including the ``dp``/``ds`` passband/
stopband deviation scaling and the ``_dhtm`` spectral-factorization helper)
is derived from ``scipy.signal.minimum_phase`` (BSD-3-Clause, Copyright (c)
2001-2002 Enthought, Inc. 2003+ SciPy Developers) — reproducing scipy's exact
numerics is required for the golden-oracle contract, so the algorithm
structure intentionally follows scipy's implementation.
"""
from __future__ import annotations

import numpy as np

from .freqz import freqz

__all__ = ["minimum_phase", "is_symmetric", "normalize_peak"]


def is_symmetric(h: np.ndarray, tol: float = 1e-8) -> bool:
    """Linear-phase symmetry check (`stream_process_EQ_GUI.py:53-54`)."""
    h = np.asarray(h)
    return bool(np.allclose(h, h[::-1], atol=tol))


def _dhtm(mag: np.ndarray) -> np.ndarray:
    """Modified 1-D discrete Hilbert transform: reconstruct a minimum-phase
    signal from its magnitude spectrum (DC/Nyquist sign left at zero)."""
    sig = np.zeros(len(mag))
    midpt = len(mag) // 2
    sig[1:midpt] = 1
    sig[midpt + 1:] = -1
    return np.fft.ifft(mag * np.exp(np.fft.fft(sig * np.fft.ifft(np.log(mag))))).real


def minimum_phase(h: np.ndarray, method: str = "hilbert", n_fft: int | None = None) -> np.ndarray:
    """Convert a linear-phase FIR filter to minimum phase (half-length output).

    Output length is ``len(h)//2 + len(h)%2``, matching scipy's convention.
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1:
        raise ValueError("minimum_phase expects a 1-D filter")
    if len(h) <= 2:
        # scipy's guard: the homomorphic/hilbert construction is undefined
        # this short (len 1 also overflows the default n_fft formula)
        raise ValueError("h must have at least 3 taps")
    if n_fft is None:
        n_fft = 2 ** int(np.ceil(np.log2(2 * (len(h) - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < len(h):
        raise ValueError("n_fft must be at least len(h)")
    n_half = len(h) // 2

    if method == "hilbert":
        # zero-phase response of the (assumed symmetric) filter
        w = np.arange(n_fft) * (2 * np.pi / n_fft * n_half)
        H = np.real(np.fft.fft(h, n_fft) * np.exp(1j * w))
        dp = max(H) - 1
        ds = 0 - min(H)
        S = 4.0 / (np.sqrt(1 + dp + ds) + np.sqrt(1 - dp + ds)) ** 2
        H += ds
        H *= S
        H = np.sqrt(H, out=H)
        H += 1e-10  # keep log() finite
        h_minimum = _dhtm(H)
    elif method == "homomorphic":
        h_temp = np.abs(np.fft.fft(h, n_fft))
        h_temp += 1e-7 * h_temp[h_temp > 0].min()  # keep log() finite
        np.log(h_temp, out=h_temp)
        h_temp *= 0.5  # sqrt of magnitude in the cepstral domain
        h_temp = np.fft.ifft(h_temp).real
        # homomorphic window: double positive quefrencies, zero negative ones
        win = np.zeros(n_fft)
        win[0] = 1
        stop = n_fft // 2
        win[1:stop] = 2
        if n_fft % 2:
            win[stop] = 1
        h_temp *= win
        h_minimum = np.fft.ifft(np.exp(np.fft.fft(h_temp))).real
    else:
        raise ValueError(f"method must be 'hilbert' or 'homomorphic', got {method!r}")

    n_out = n_half + len(h) % 2
    return h_minimum[:n_out]


def normalize_peak(h: np.ndarray, fs: float) -> np.ndarray:
    """Scale so peak |H| = 1 on the 8000-pt freqz grid — the GUI's
    post-min-phase normalization (`stream_process_EQ_GUI.py:55-63`)."""
    _, H = freqz(h, worN=8000, fs=fs)
    max_gain = np.max(np.abs(H))
    if max_gain < 1e-10:
        return h
    return h / max_gain
