"""First-party window functions (no scipy at runtime).

Re-creates the full window vocabulary used by the reference
(`reference/window_types.py:5-53` and the GUI window list,
`reference/stream_process_EQ_GUI.py:253-255`):

    boxcar, triang, blackman, hamming, hann, bartlett, flattop, parzen,
    bohman, blackmanharris, nuttall, barthann, kaiser

Numerics follow the textbook definitions used by scipy.signal.windows so the
golden-oracle tests (`tests/test_windows.py`) can diff against scipy at
machine precision.  The reference reaches these through
``scipy.signal.get_window(name, numtaps)`` which defaults to *periodic*
(fftbins=True) windows — so ``get_window`` here is periodic by default too.

This is the cold design path: host-side float64 numpy. Device code only ever
sees the finished float32 coefficient vectors.

Attribution: several window formulas (notably ``parzen``, ``bohman``,
``triang`` and the general-cosine family) are derived from
``scipy.signal.windows`` (BSD-3-Clause, Copyright (c) 2001-2002 Enthought,
Inc. 2003+ SciPy Developers) — bit-compatibility with scipy's evaluation
order is a design requirement (the −90 dB golden-oracle contract), so the
piecewise structure intentionally mirrors scipy's.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "get_window",
    "boxcar",
    "triang",
    "bartlett",
    "hann",
    "hamming",
    "blackman",
    "blackmanharris",
    "nuttall",
    "flattop",
    "parzen",
    "bohman",
    "barthann",
    "kaiser",
    "general_cosine",
    "WINDOW_NAMES",
]


def _len_guard(M: int) -> bool:
    """Handle trivial window lengths (scipy _len_guards semantics)."""
    if int(M) != M or M < 0:
        raise ValueError("Window length M must be a non-negative integer")
    return M <= 1


def _extend(M: int, sym: bool):
    """Extend window length by 1 for periodic windows."""
    if not sym:
        return M + 1, True
    return M, False


def _truncate(w: np.ndarray, needed: bool) -> np.ndarray:
    return w[:-1] if needed else w


def general_cosine(M: int, a, sym: bool = True) -> np.ndarray:
    """Generic weighted-cosine-series window: w[n] = sum_k a[k] cos(k * fac)."""
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.linspace(-np.pi, np.pi, M)
    w = np.zeros(M)
    for k, coef in enumerate(a):
        w += coef * np.cos(k * fac)
    return _truncate(w, needs_trunc)


def boxcar(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    return np.ones(M, dtype=float)


def hann(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.5, 0.5], sym)


def hamming(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.54, 0.46], sym)


def blackman(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.42, 0.50, 0.08], sym)


def blackmanharris(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def nuttall(M: int, sym: bool = True) -> np.ndarray:
    return general_cosine(M, [0.3635819, 0.4891775, 0.1365995, 0.0106411], sym)


def flattop(M: int, sym: bool = True) -> np.ndarray:
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(M, a, sym)


def triang(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(1, (M + 1) // 2 + 1)
    if M % 2 == 0:
        w = (2 * n - 1.0) / M
        w = np.r_[w, w[::-1]]
    else:
        w = 2 * n / (M + 1.0)
        w = np.r_[w, w[-2::-1]]
    return _truncate(w, needs_trunc)


def bartlett(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    w = np.where(
        np.less_equal(n, (M - 1) / 2.0),
        2.0 * n / (M - 1),
        2.0 - 2.0 * n / (M - 1),
    )
    return _truncate(w, needs_trunc)


def parzen(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(-(M - 1) / 2.0, (M - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(n < -(M - 1) / 4.0, n)
    nb = np.extract(abs(n) <= (M - 1) / 4.0, n)
    wa = 2 * (1 - np.abs(na) / (M / 2.0)) ** 3.0
    wb = 1 - 6 * (np.abs(nb) / (M / 2.0)) ** 2.0 + 6 * (np.abs(nb) / (M / 2.0)) ** 3.0
    w = np.r_[wa, wb, wa[::-1]]
    return _truncate(w, needs_trunc)


def bohman(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.abs(np.linspace(-1, 1, M)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    w = np.r_[0, w, 0]
    return _truncate(w, needs_trunc)


def barthann(M: int, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    fac = np.abs(n / (M - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _truncate(w, needs_trunc)


def kaiser(M: int, beta: float, sym: bool = True) -> np.ndarray:
    if _len_guard(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(0, M)
    alpha = (M - 1) / 2.0
    w = np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2.0)) / np.i0(beta)
    return _truncate(w, needs_trunc)


# name → (fn, needs_param). Aliases follow scipy.signal.get_window's registry.
_WINDOWS = {
    "boxcar": boxcar,
    "rect": boxcar,
    "rectangular": boxcar,
    "ones": boxcar,
    "triang": triang,
    "triangle": triang,
    "tri": triang,
    "bartlett": bartlett,
    "bart": bartlett,
    "brt": bartlett,
    "hann": hann,
    "han": hann,
    "hanning": hann,
    "hamming": hamming,
    "hamm": hamming,
    "ham": hamming,
    "blackman": blackman,
    "black": blackman,
    "blk": blackman,
    "blackmanharris": blackmanharris,
    "blackharr": blackmanharris,
    "bkh": blackmanharris,
    "nuttall": nuttall,
    "nutl": nuttall,
    "nut": nuttall,
    "flattop": flattop,
    "flat": flattop,
    "flt": flattop,
    "parzen": parzen,
    "parz": parzen,
    "par": parzen,
    "bohman": bohman,
    "bman": bohman,
    "bmn": bohman,
    "barthann": barthann,
    "brthan": barthann,
    "bth": barthann,
}

#: Canonical names exposed to config/UI layers (matches the reference GUI list
#: plus kaiser; `reference/stream_process_EQ_GUI.py:253-255`).
WINDOW_NAMES = (
    "boxcar",
    "triang",
    "blackman",
    "hamming",
    "hann",
    "bartlett",
    "flattop",
    "parzen",
    "bohman",
    "blackmanharris",
    "nuttall",
    "barthann",
    "kaiser",
)


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Return a window of length `Nx`, periodic by default (scipy-compatible).

    `window` is a string name, or a ``('kaiser', beta)`` tuple.  Matches the
    call surface the reference uses (`scipy.signal.get_window`,
    `reference/window_types.py:42-45`).
    """
    sym = not fftbins
    if isinstance(window, (tuple, list)):
        name = str(window[0]).lower()
        args = tuple(window[1:])
        if name in ("kaiser", "ksr"):
            if len(args) != 1:
                raise ValueError("kaiser window needs exactly one parameter (beta)")
            return kaiser(Nx, float(args[0]), sym=sym)
        raise ValueError(f"Unknown parameterized window: {window!r}")
    if isinstance(window, str):
        name = window.lower()
        if name in ("kaiser", "ksr"):
            raise ValueError(
                "The 'kaiser' window needs a parameter -- pass a tuple ('kaiser', beta)"
            )
        fn = _WINDOWS.get(name)
        if fn is None:
            raise ValueError(f"Unknown window type: {window!r}")
        return fn(Nx, sym=sym)
    raise ValueError(f"Window spec must be a string or tuple, got {type(window)}")
