"""FFT convolution ops (device hot path, JAX).

Device replacement for the reference's convolution surface:

* ``scipy.signal.oaconvolve(x, h, mode='valid'|'same'|'full')``
  (`reference/stream_process.py:102`,
   `reference/stream_process_EQ_GUI.py:87-93`) →
  :func:`fft_convolve` — one rfft/irfft round-trip on power-of-two length,
  batched over leading axes, fp32.
* the sliding-buffer + valid-mode streaming pattern
  (`stream_process.py:97-106`) → :class:`OverlapSave` — carry is the last
  ``N−1`` input samples; block output identical to the one-shot convolution
  (streaming-equivalence invariant, SURVEY.md §4 item 3).
* the reference's stateful ``OverlapAddFilter``
  (`stream_process_GUI_Presets.py:35-123`) → :class:`OverlapAdd` — same
  pow-2 FFT sizing and N−1 overlap-carry semantics, expressed functionally so
  the state threads through ``lax.scan``.

Shapes: signals are ``[..., T]`` (any leading batch axes), kernels are
``[N]`` (shared) or broadcastable ``[..., N]`` (per-stream filter banks).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "next_pow2",
    "fft_convolve",
    "OverlapSave",
    "OverlapAdd",
    "kernel_rfft",
    "band_matrix",
    "band_conv",
    "BAND_TILE",
    "BAND_ALGORITHM",
]

#: output columns per band-matrix product (one row of output tiles)
BAND_TILE = 128
#: dot algorithm of the band-matrix product.  A named algorithm, never
#: DEFAULT: the GPU may run a DEFAULT float32 dot as TF32 (10 mantissa
#: bits), which misses the −90 dB contract.
BAND_ALGORITHM = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference FFT sizing,
    `stream_process_GUI_Presets.py:56-57`)."""
    return 1 << (int(n) - 1).bit_length()


def _mode_slice(full: jnp.ndarray, T: int, N: int, mode: str) -> jnp.ndarray:
    """Slice a full convolution [..., T+N-1] down to the requested mode."""
    if mode == "full":
        return full
    if mode == "same":
        start = (N - 1) // 2
        return jax.lax.slice_in_dim(full, start, start + T, axis=-1)
    if mode == "valid":
        if T < N:
            raise ValueError("valid mode requires len(x) >= len(h)")
        return jax.lax.slice_in_dim(full, N - 1, T, axis=-1)
    raise ValueError(f"mode must be 'full', 'same' or 'valid', got {mode!r}")


def fft_convolve(x: jnp.ndarray, h: jnp.ndarray, mode: str = "full") -> jnp.ndarray:
    """Linear convolution via one pow-2 rfft round-trip (oaconvolve-compatible).

    `x`: [..., T]; `h`: [N] or [..., N] (broadcast against x's batch axes).
    Returns fp32 with scipy's mode semantics (output length follows `x`).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    h = jnp.asarray(h, dtype=jnp.float32)
    T = x.shape[-1]
    N = h.shape[-1]
    nfft = next_pow2(T + N - 1)
    X = jnp.fft.rfft(x, n=nfft)
    H = jnp.fft.rfft(h, n=nfft)
    full = jnp.fft.irfft(X * H, n=nfft)[..., : T + N - 1]
    return _mode_slice(full, T, N, mode)


def kernel_rfft(h: jnp.ndarray, nfft: int) -> jnp.ndarray:
    """Precompute a kernel spectrum for repeated block convolution."""
    return jnp.fft.rfft(jnp.asarray(h, dtype=jnp.float32), n=nfft)


def _band_pattern(n_taps: int, tile: int):
    """Static gather pattern of :func:`band_matrix`: ``(idx, mask)`` over
    ``[K·tile, tile]`` rows, ``K = ceil((N−1+tile)/tile)``."""
    K = -(-(n_taps - 1 + tile) // tile)
    i = np.arange(K * tile)[:, None]
    j = np.arange(tile)[None, :]
    k = n_taps - 1 + j - i
    mask = (k >= 0) & (k < n_taps)
    return np.clip(k, 0, n_taps - 1).astype(np.int32), mask


def band_matrix(h: jnp.ndarray, tile: int = BAND_TILE) -> jnp.ndarray:
    """Banded-Toeplitz operator ``[K·tile, tile]`` for convolution by `h`
    ([N]): ``T[i, j] = h[N−1 + j − i]`` inside the band, zero elsewhere
    (rows padded with zeros to a multiple of `tile`), so that for a window
    ``w = x_ext[s : s + K·tile]`` (oldest sample first)
    ``w @ T = (h ⊛ x)[s+N−1 : s+N−1+tile]``.  Built on the device (`h` is
    runtime data — a kernel swap never recompiles)."""
    h = jnp.asarray(h, jnp.float32)
    idx, mask = _band_pattern(h.shape[-1], tile)
    return jnp.where(mask, jnp.take(h, jnp.asarray(idx)), 0.0)


def band_conv(x_ext: jnp.ndarray, h: jnp.ndarray,
              algorithm=None, tile: int = BAND_TILE) -> jnp.ndarray:
    """Valid convolution ``[..., T+N−1] ⊛ h[N] → [..., T]`` as one dense
    product with the band matrix.

    The signal is cut into hop-`tile` windows of ``K·tile`` samples — K
    shifted views of one ``[..., T/tile + K − 1, tile]`` reshape, no
    gather — and multiplied by :func:`band_matrix` in one ``dot_general``
    with the named `algorithm` (default :data:`BAND_ALGORITHM`).  `T`
    need not be a multiple of `tile` (the last window is zero-padded and
    cut off)."""
    x_ext = jnp.asarray(x_ext, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    N = h.shape[-1]
    T = x_ext.shape[-1] - (N - 1)
    if T < 1:
        raise ValueError("band_conv needs len(x_ext) >= len(h)")
    band = band_matrix(h, tile)
    K = band.shape[0] // tile
    nt = -(-T // tile)
    need = (nt + K - 1) * tile
    lead = x_ext.shape[:-1]
    pad = [(0, 0)] * len(lead) + [(0, need - x_ext.shape[-1])]
    view = jnp.pad(x_ext, pad).reshape(lead + (nt + K - 1, tile))
    frames = jnp.concatenate([view[..., q:q + nt, :] for q in range(K)],
                             axis=-1)  # [..., nt, K·tile]
    y = jax.lax.dot_general(
        frames, band, (((frames.ndim - 1,), (0,)), ((), ())),
        precision=BAND_ALGORITHM if algorithm is None else algorithm,
        preferred_element_type=jnp.float32)
    return y.reshape(lead + (nt * tile,))[..., :T]


class OverlapSave(NamedTuple):
    """Streaming overlap-save convolution state (functional).

    Mirrors the reference's sliding input buffer of ``N + L − 1`` samples
    (`stream_process.py:45-46, 97-98`): `tail` holds the last ``N−1`` input
    samples; each block emits exactly ``L`` valid-mode outputs.  Initial state
    is zeros — identical to the reference's zero-primed buffer.
    """

    tail: jnp.ndarray  # [..., N-1] input history
    H: jnp.ndarray  # [..., nfft//2+1] precomputed kernel spectrum
    taps: int  # static: N
    block: int  # static: L
    nfft: int  # static

    @classmethod
    def init(cls, h: jnp.ndarray, block: int, batch_shape: tuple = ()) -> "OverlapSave":
        h = jnp.asarray(h, dtype=jnp.float32)
        N = h.shape[-1]
        L = int(block)
        nfft = next_pow2(L + N - 1)
        tail = jnp.zeros(batch_shape + (N - 1,), dtype=jnp.float32)
        return cls(tail=tail, H=kernel_rfft(h, nfft), taps=N, block=L, nfft=nfft)

    def process(self, block: jnp.ndarray) -> tuple["OverlapSave", jnp.ndarray]:
        """One streaming step: [..., L] in → ([..., L] out, new state)."""
        x = jnp.concatenate(
            [self.tail, jnp.asarray(block, dtype=jnp.float32)], axis=-1
        )  # [..., N-1+L]
        X = jnp.fft.rfft(x, n=self.nfft)
        y = jnp.fft.irfft(X * self.H, n=self.nfft)
        # valid-mode outputs live at offsets [N-1, N-1+L)
        out = jax.lax.slice_in_dim(y, self.taps - 1, self.taps - 1 + self.block, axis=-1)
        new_tail = jax.lax.slice_in_dim(x, x.shape[-1] - (self.taps - 1), x.shape[-1], axis=-1)
        return self._replace(tail=new_tail), out

    def with_kernel(self, h: jnp.ndarray) -> "OverlapSave":
        """Glitch-free kernel swap: same shapes, new spectrum (no recompile)."""
        h = jnp.asarray(h, dtype=jnp.float32)
        if h.shape[-1] != self.taps:
            raise ValueError("kernel swap must preserve tap count (shape-static)")
        return self._replace(H=kernel_rfft(h, self.nfft))


class OverlapAdd(NamedTuple):
    """Streaming overlap-add state — functional re-expression of the
    reference's ``OverlapAddFilter`` (`stream_process_GUI_Presets.py:35-123`):
    pow-2 FFT of ``L+N−1``, carry = ``N−1`` tail of each block's convolution.

    Unlike the reference — whose ``OverlapAddFilter`` silently *replaces* the
    carry each block and is therefore numerically wrong whenever
    ``numtaps−1 > blocksize`` (`stream_process_GUI_Presets.py:110-121`, a
    regime its own config clamps permit: numtaps ≤ 2048, blocksize ≥ 256) —
    this implementation accumulates the shifted remainder of the previous
    carry, so streaming ≡ one-shot for **every** (N, L) pair.  That defect is
    deliberately not reproduced.
    """

    overlap: jnp.ndarray  # [..., N-1] carried convolution tail
    H: jnp.ndarray
    taps: int
    block: int
    nfft: int

    @classmethod
    def init(cls, h: jnp.ndarray, block: int, batch_shape: tuple = ()) -> "OverlapAdd":
        h = jnp.asarray(h, dtype=jnp.float32)
        if h.shape[-1] == 0:
            h = jnp.ones((1,), dtype=jnp.float32)  # identity fallback (`:46-48`)
        N = h.shape[-1]
        L = int(block)
        nfft = next_pow2(L + N - 1)
        overlap = jnp.zeros(batch_shape + (max(N - 1, 1),), dtype=jnp.float32)
        return cls(overlap=overlap, H=kernel_rfft(h, nfft), taps=N, block=L, nfft=nfft)

    def process(self, block: jnp.ndarray) -> tuple["OverlapAdd", jnp.ndarray]:
        x = jnp.asarray(block, dtype=jnp.float32)
        X = jnp.fft.rfft(x, n=self.nfft)
        conv = jnp.fft.irfft(X * self.H, n=self.nfft)  # [..., nfft]
        L, N = self.block, self.taps
        out = jax.lax.slice_in_dim(conv, 0, L, axis=-1)
        if N > 1:
            ov_len = min(L, N - 1)
            pad = jnp.zeros(self.overlap.shape[:-1] + (L - ov_len,), dtype=jnp.float32)
            out = out + jnp.concatenate(
                [jax.lax.slice_in_dim(self.overlap, 0, ov_len, axis=-1), pad], axis=-1
            )
            new_overlap = jax.lax.slice_in_dim(conv, L, L + (N - 1), axis=-1)
            if N - 1 > L:
                # long-filter regime: the previous carry extends past this
                # block — shift it left by L and accumulate (more than two
                # blocks overlap each output position when N−1 > L)
                rem = jax.lax.slice_in_dim(self.overlap, L, N - 1, axis=-1)
                zpad = jnp.zeros(self.overlap.shape[:-1] + (L,), dtype=jnp.float32)
                new_overlap = new_overlap + jnp.concatenate([rem, zpad], axis=-1)
        else:
            new_overlap = self.overlap
        return self._replace(overlap=new_overlap), out

    def with_kernel(self, h: jnp.ndarray) -> "OverlapAdd":
        h = jnp.asarray(h, dtype=jnp.float32)
        if h.shape[-1] != self.taps:
            raise ValueError("kernel swap must preserve tap count (shape-static)")
        return self._replace(H=kernel_rfft(h, self.nfft))


# Register the states as pytrees with static metadata so they thread through
# jit/scan without retracing on state value changes.
jax.tree_util.register_pytree_node(
    OverlapSave,
    lambda s: ((s.tail, s.H), (s.taps, s.block, s.nfft)),
    lambda aux, leaves: OverlapSave(leaves[0], leaves[1], *aux),
)
jax.tree_util.register_pytree_node(
    OverlapAdd,
    lambda s: ((s.overlap, s.H), (s.taps, s.block, s.nfft)),
    lambda aux, leaves: OverlapAdd(leaves[0], leaves[1], *aux),
)
