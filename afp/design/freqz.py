"""FIR frequency-response evaluation (first-party `freqz`).

The reference's band-filter normalization is *defined in terms of* an 8000-pt
`scipy.signal.freqz` evaluation (`reference/filter_methods.py:63-74`)
and the response plots use the same grid (`reference/plot_filter.py:49`).
To keep the −90 dB contract we evaluate on exactly scipy's grid:

    w = linspace(0, fs/2, worN, endpoint=False)
    H[k] = Σ_n h[n] · exp(−j·2π·(w[k]/fs)·n)

computed — as scipy's fast path does — via a zero-padded real FFT of length
``2·worN``, which is bit-for-bit the same evaluation points.

Both a numpy (float64 design path) and a jax (on-device) implementation are
provided; the design path uses numpy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["freqz", "freqz_jax"]


def freqz(h: np.ndarray, worN: int = 8000, fs: float = 2 * np.pi):
    """Frequency response of an FIR filter on scipy's half-spectrum grid.

    Returns ``(w, H)`` with `w` in the same units as `fs` (Hz when `fs` is a
    samplerate), matching ``scipy.signal.freqz(h, worN=worN, fs=fs)``.
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1:
        raise ValueError("freqz expects a 1-D coefficient vector")
    worN = int(worN)
    if worN < 1:
        raise ValueError("worN must be >= 1")
    n_fft = 2 * worN
    if len(h) <= n_fft:
        # scipy's FFT fast path: rfft of length 2*worN, keep the first worN
        # bins => response at w = linspace(0, pi, worN, endpoint=False).
        H = np.fft.rfft(h, n=n_fft)[:worN]
    else:
        # Filter longer than the grid: direct evaluation, chunked over the
        # frequency axis — the full [worN, n_taps] phase matrix is quadratic
        # memory (12.8 GB complex128 at the 100k-tap kernels kp.py handles);
        # cap each chunk at ~4M elements (≤64 MB), same as the JAX path.
        wr = np.linspace(0, np.pi, worN, endpoint=False)
        n = np.arange(len(h))
        H = np.empty(worN, dtype=np.complex128)
        chunk = max(8, (1 << 22) // len(h))
        for s in range(0, worN, chunk):
            H[s : s + chunk] = np.exp(-1j * np.outer(wr[s : s + chunk], n)) @ h
    w = np.linspace(0, fs / 2, worN, endpoint=False)
    return w, H


def _mulmod_tables(n_host: np.ndarray, M: int):
    """Host tables for :func:`_mulmod_i32`: ``(n mod M, (s·n) mod M,
    s_bits)`` with the split point ``s = 2^s_bits ~ sqrt(M)``."""
    import jax.numpy as jnp

    s_bits = (M.bit_length() + 1) // 2
    s = 1 << s_bits
    n_mod = jnp.asarray((n_host % M).astype(np.int32))
    n_shift = jnp.asarray(((s * n_host) % M).astype(np.int32))
    return n_mod, n_shift, s_bits


def _mulmod_i32(k, n_mod, n_shift, s_bits: int, M: int):
    """Exact ``(k·n) mod M`` without 64-bit ints (jax x64 is off).

    Split ``k = hi·s + lo`` at ``s = 2^s_bits ~ sqrt(M)`` with the
    host-precomputed ``n_shift = (s·n) mod M``; then both device products
    stay below 2^31 for ``M <= 2^20``::

        hi < M/s ~ sqrt(M),  n_shift < M  ->  hi·n_shift < M^1.5
        lo < s,              n_mod   < M  ->  lo·n_mod   < s·M
    """
    hi = k >> s_bits
    lo = k & ((1 << s_bits) - 1)
    return ((hi * n_shift) % M + lo * n_mod) % M


def freqz_jax(h, worN: int = 8000, fs: float = 2 * np.pi):
    """JAX version of :func:`freqz` (float32 on device; jit/vmap friendly).

    Matches the numpy path on both branches: the rfft fast path for
    ``len(h) <= 2·worN`` and direct evaluation for longer filters (the rfft
    of a too-long `h` would alias taps past ``2·worN`` back onto the grid).
    """
    import jax
    import jax.numpy as jnp

    h = jnp.asarray(h)
    worN = int(worN)
    n_fft = 2 * worN
    if h.shape[-1] <= n_fft:
        H = jnp.fft.rfft(h, n=n_fft)[..., :worN]
    else:
        # direct evaluation, chunked over the frequency axis: the full
        # [worN, n_taps] phase matrix for a 100k-tap kernel at worN=8000
        # would be ~6.4 GB complex64 — cap the chunk at ~4M
        # elements and scan.  The phase π·k·n/worN reaches ~1e5 rad for long
        # filters (f32 trig args lose ~1e-2 there), so reduce it EXACTLY in
        # integer space first: m = (k·n) mod 2·worN stays < 2^20, making
        # the f32 phase exact (see _mulmod_i32 for the overflow-safe
        # product — a plain int32 k·n wraps at worN >= ~2^15).
        n_taps = h.shape[-1]
        M = 2 * worN
        if M > (1 << 20):
            raise ValueError(
                f"worN={worN} exceeds the exact-phase-reduction bound "
                "(2*worN must be <= 2^20); evaluate on the numpy path")
        chunk = max(8, min(worN, (1 << 22) // max(n_taps, 1)))
        n_chunks = -(-worN // chunk)
        k_pad = jnp.arange(n_chunks * chunk, dtype=jnp.int32) % M
        hc = h.astype(jnp.complex64)
        scale = jnp.float32(np.pi / worN)
        n_host = np.arange(n_taps, dtype=np.int64)
        n_mod, n_shift, s_bits = _mulmod_tables(n_host, M)

        def eval_chunk(_, kc):
            m = _mulmod_i32(kc[:, None], n_mod[None, :], n_shift[None, :],
                            s_bits, M)
            E = jnp.exp(-1j * (scale * m.astype(jnp.float32)))
            return None, jnp.einsum("wn,...n->...w", E, hc)

        _, Hs = jax.lax.scan(eval_chunk, None,
                             k_pad.reshape(n_chunks, chunk))
        H = jnp.moveaxis(Hs, 0, -2).reshape(h.shape[:-1] + (-1,))[..., :worN]
    w = jnp.linspace(0.0, fs / 2, worN, endpoint=False)
    return w, H
