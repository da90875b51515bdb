"""Polyphase resampling ops (device hot path, JAX).

Device replacement for the reference's three resampling paths:

* ``soxr.resample`` 1–4× up/down (`reference/stream_process.py:66-77`,
  `stream_process_EQ_GUI.py:420-436`),
* ``samplerate.Resampler('sinc_best')`` ASRC
  (`stream_process_AGC.py:126-129`),
* naive decimation ``[::UPF]`` after the anti-alias main filter
  (`stream_process.py:106`).

Rather than reverse-engineering soxr's proprietary kernel, the framework
*publishes* its resampling kernels (SURVEY.md §7 "soxr-equivalence") as
**quality tiers** — the reference exposes two soxr tiers (VHQ in the baseline
hot path, `stream_process.py:69-74`; HQ in the GUI path,
`stream_process_EQ_GUI.py:424`), so the capability is a selectable
kaiser-windowed-sinc family (:data:`QUALITY_TIERS`):

========  ===============  ======================================  =============
tier      (mult, β)        measured anti-image stopband / ripple   soxr analog
========  ===============  ======================================  =============
'fast'    (10, 5.0)        −43 dB @ +15% of cutoff                 MQ-class
'hq'      (40, 12.26)      −119 dB @ +10% of cutoff                HQ-class
'vhq'     (64, 14.47)      −141 dB @ +8% of cutoff                 VHQ-class
========  ===============  ======================================  =============

(β from the kaiserord attenuation formula β = 0.1102·(A − 8.7); taps sized
N ≈ (A − 7.95)/(2.285·Δω) for the tier's transition width; numbers measured
by ``tests/test_resample.py::test_quality_tier_stopbands``.)  The 'fast' tier
is bit-identical to the scipy ``resample_poly`` default recipe — kaiser(β=5)
sinc with ``half_len = 10·max(up, down)``, scaled by ``up`` — so the golden
oracle for it is exactly ``scipy.signal.resample_poly(x, up, down)``; 'hq'
and 'vhq' are golden-tested against the same recipe at their published
parameters.  Per-tier resampling error vs a reference-grade float64 oracle
(and vs soxr, when importable) is measured and reported by ``bench.py``
under the ``resample_err_db`` key.

The compute primitive is :func:`upfirdn` — zero-stuff by `up`, FIR, decimate
by `down` — implemented as explicit zero-stuffing + one pow-2 FFT convolution
+ a stride slice (``conv_general_dilated`` with ``lhs_dilation`` is avoided:
its 1-D lowering compiles poorly; see upfirdn's own docstring).
Streaming mode carries an input-history tail so blocked output equals the
one-shot transform (SURVEY.md §4 item 3).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..design.firwin import design_windowed_sinc
from ..design.windows import kaiser as kaiser_window

__all__ = [
    "QUALITY_TIERS",
    "design_resample_kernel",
    "quality_kernel",
    "upfirdn",
    "resample_poly",
    "PolyResampler",
    "decimate",
    "output_len",
]

#: quality tier → (half_len_mult, kaiser β).  See the module docstring for
#: the measured stopband/ripple of each tier and the soxr analogs
#: (`reference/stream_process.py:69-74` VHQ,
#: `stream_process_EQ_GUI.py:424` HQ).
QUALITY_TIERS = {
    "fast": (10, 5.0),
    "hq": (40, 12.26),
    "vhq": (64, 14.47),
}


def _reduce_ratio(up: int, down: int) -> tuple[int, int]:
    """Lowest terms of the rational ratio — every entry point reduces the
    SAME way, so kernel design and padding always agree."""
    up, down = int(up), int(down)
    g = math.gcd(up, down)
    return up // g, down // g


def _prepad_kernel(h: np.ndarray, down: int):
    """scipy's centering pre-pad: ``(h_padded, n_pre_remove)``.  The single
    source of truth shared by :func:`streaming_kernel` and
    :class:`PolyResampler` — their streamed-equals-one-shot invariant
    depends on byte-identical padding."""
    half_len = (len(h) - 1) // 2
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return np.concatenate([np.zeros(n_pre_pad), h]), n_pre_remove


def quality_kernel(up: int, down: int, quality: str = "fast") -> np.ndarray:
    """The published tier kernel for a rational `up/down` resample."""
    try:
        mult, beta = QUALITY_TIERS[quality]
    except KeyError:
        raise ValueError(
            f"unknown resample quality {quality!r}; "
            f"expected one of {sorted(QUALITY_TIERS)}") from None
    return design_resample_kernel(up, down, half_len_mult=mult, beta=beta)


@lru_cache(maxsize=64)
def design_resample_kernel(up: int, down: int, half_len_mult: int = 10,
                           beta: float = 5.0) -> np.ndarray:
    """Anti-alias/anti-image FIR for a rational `up/down` resample.

    Published recipe (matches scipy.signal.resample_poly's default): symmetric
    kaiser(beta)-windowed sinc, cutoff 1/max(up, down) of Nyquist,
    ``2·half_len_mult·max(up,down)+1`` taps, scaled by `up`.  float64 design.
    """
    up, down = _reduce_ratio(up, down)
    if up == down == 1:
        return np.ones(1)
    max_rate = max(up, down)
    half_len = half_len_mult * max_rate
    numtaps = 2 * half_len + 1
    # windowed sinc, unity DC gain (lowpass normalization h /= sum h), i.e.
    # firwin(numtaps, 1/max_rate, window=('kaiser', beta), scale=True)
    win = kaiser_window(numtaps, beta, sym=True)
    h = design_windowed_sinc(
        cutoff=1.0 / max_rate,
        numtaps=numtaps,
        window=win,
        filter_type="lowpass",
        samplerate=2.0,  # Nyquist-normalized axis
    )
    h = h * up
    # this array is CACHED (lru_cache) and handed to every caller: freeze
    # it so an in-place edit cannot poison later resamples
    h.setflags(write=False)
    return h


def output_len(len_h: int, in_len: int, up: int, down: int) -> int:
    """upfirdn output length (scipy `_output_len` semantics)."""
    return (((in_len - 1) * up + len_h) - 1) // down + 1


def upfirdn(h: jnp.ndarray, x: jnp.ndarray, up: int = 1, down: int = 1) -> jnp.ndarray:
    """Zero-stuff by `up`, filter by `h`, decimate by `down` (scipy-compatible).

    `x`: [..., T] (any leading batch axes); `h`: [K].  Returns
    [..., output_len(K, T, up, down)] in fp32.

    Implemented as explicit zero-stuffing + one pow-2 FFT convolution + a
    stride slice — all ops XLA fuses well (``conv_general_dilated``
    with ``lhs_dilation`` is avoided: its 1-D lowering compiles poorly).
    """
    from .convolve import fft_convolve

    x = jnp.asarray(x, dtype=jnp.float32)
    h = jnp.asarray(h, dtype=jnp.float32)
    K = h.shape[-1]
    T = x.shape[-1]
    if up > 1:
        # dilated signal of length (T-1)*up + 1
        xd = jnp.zeros(x.shape[:-1] + ((T - 1) * up + 1,), dtype=jnp.float32)
        xd = xd.at[..., ::up].set(x)
    else:
        xd = x
    full = fft_convolve(xd, h, mode="full")  # [..., (T-1)*up + K]
    y = full[..., ::down] if down > 1 else full
    n_out = output_len(K, T, up, down)
    return y[..., :n_out]


def _poly_pad(h_len: int, in_len: int, up: int, down: int):
    """scipy resample_poly's centering: pre/post zero-padding of the kernel and
    number of leading outputs to drop."""
    half_len = (h_len - 1) // 2
    n_out = in_len * up
    n_out = n_out // down + bool(n_out % down)
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (
        output_len(h_len + n_pre_pad + n_post_pad, in_len, up, down)
        < n_out + n_pre_remove
    ):
        n_post_pad += 1
    return n_pre_pad, n_post_pad, n_pre_remove, n_out


def resample_poly(x: jnp.ndarray, up: int, down: int,
                  h: np.ndarray | None = None,
                  quality: str = "fast") -> jnp.ndarray:
    """Rational-ratio resample with zero-phase centering.  At the default
    ``quality='fast'`` tier the output is bit-compatible with
    ``scipy.signal.resample_poly(x, up, down)``; 'hq'/'vhq' swap in the
    steeper published tier kernels (same centering rules).

    `x`: [..., T].  Output: [..., ceil(T·up/down)].
    """
    up, down = _reduce_ratio(up, down)
    if up == down == 1:
        return jnp.asarray(x, dtype=jnp.float32)
    if h is None:
        h = quality_kernel(up, down, quality)
    h = np.asarray(h)
    T = x.shape[-1]
    n_pre_pad, n_post_pad, n_pre_remove, n_out = _poly_pad(len(h), T, up, down)
    h_padded = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    y = upfirdn(h_padded, x, up, down)
    return y[..., n_pre_remove : n_pre_remove + n_out]


def streaming_kernel(up: int, down: int, h: np.ndarray | None = None,
                     quality: str = "fast") -> np.ndarray:
    """Host-side copy of the pre-padded kernel :class:`PolyResampler` uses —
    the exact impulse response of the causal streaming resampler, for
    building fused cascade kernels (float64 numpy)."""
    up, down = int(up), int(down)
    up, down = _reduce_ratio(up, down)
    if h is None:
        h = quality_kernel(up, down, quality)
    h = np.asarray(h, dtype=np.float64)
    if up == down == 1:
        return h
    return _prepad_kernel(h, down)[0]


def decimate(x: jnp.ndarray, factor: int, offset: int = 0) -> jnp.ndarray:
    """Naive stride decimation (`stream_process.py:106`) — relies on a
    preceding lowpass as the anti-alias stage; free on the device (a strided
    slice)."""
    return x[..., offset::factor]


class PolyResampler(NamedTuple):
    """Streaming rational resampler with carried input history.

    Per block of `L` input samples it emits exactly ``L·up/down`` outputs
    (static shape; `L` must be a multiple of `down`).  The streamed sequence
    equals the *causal* full-signal ``upfirdn(h, x, up, down)`` output —
    i.e. :func:`resample_poly`'s centered output delayed by
    :attr:`delay_outputs` samples:

        streamed[G] == resample_poly(x, up, down)[G - delay_outputs]

    Derivation: with `hist_len` a multiple of `down` and ``hist_len·up ≥ K−1``
    every output's receptive field lies inside ``[hist | block]``, and the
    dilated positions past the block's last sample are structural zeros, so
    blocked output is bit-identical to the one-shot transform (the streaming-
    equivalence invariant, SURVEY.md §4 item 3).  This improves on the
    reference, which re-runs a one-shot resampler per block and accepts edge
    artifacts at every block boundary (`stream_process.py:66-77`).
    """

    hist: jnp.ndarray  # [..., hist_len] input history
    h: jnp.ndarray  # [K] pre-padded kernel
    up: int
    down: int
    hist_len: int
    skip: int  # leading outputs of each windowed conv to drop
    delay_outputs: int  # streamed-vs-centered output delay

    @classmethod
    def init(cls, up: int, down: int, block: int, batch_shape: tuple = (),
             h: np.ndarray | None = None,
             quality: str = "fast") -> "PolyResampler":
        up, down = _reduce_ratio(up, down)
        if block % down:
            raise ValueError("block length must be a multiple of down")
        if h is None:
            h = quality_kernel(up, down, quality)
        h = np.asarray(h)
        if up == down == 1:
            return cls(
                hist=jnp.zeros(batch_shape + (0,), dtype=jnp.float32),
                h=jnp.asarray(h, dtype=jnp.float32),
                up=1, down=1, hist_len=0, skip=0, delay_outputs=0,
            )
        h_padded, n_pre_remove = _prepad_kernel(h, down)
        K = len(h_padded)
        # smallest multiple of `down` with hist_len*up >= K-1
        hist_len = -(-(K - 1) // up)
        hist_len = -(-hist_len // down) * down
        skip = (hist_len * up) // down
        return cls(
            hist=jnp.zeros(batch_shape + (hist_len,), dtype=jnp.float32),
            h=jnp.asarray(h_padded, dtype=jnp.float32),
            up=up, down=down, hist_len=hist_len, skip=skip,
            delay_outputs=n_pre_remove,
        )

    def process(self, block: jnp.ndarray) -> tuple["PolyResampler", jnp.ndarray]:
        """[..., L] in → ([..., L·up/down] out, new state)."""
        x = jnp.asarray(block, dtype=jnp.float32)
        if self.up == self.down == 1:
            return self, x
        L = x.shape[-1]
        if L % self.down:
            # a ragged block would shift the decimation phase of every
            # subsequent block — enforce init()'s contract where it is
            # actually consumed
            raise ValueError(
                f"block length {L} must be a multiple of down={self.down}")
        n_out = (L * self.up) // self.down
        ext = jnp.concatenate([self.hist, x], axis=-1)
        y = upfirdn(self.h, ext, self.up, self.down)
        out = jax.lax.slice_in_dim(y, self.skip, self.skip + n_out, axis=-1)
        new_hist = jax.lax.slice_in_dim(
            ext, ext.shape[-1] - self.hist_len, ext.shape[-1], axis=-1
        )
        return self._replace(hist=new_hist), out


jax.tree_util.register_pytree_node(
    PolyResampler,
    lambda s: ((s.hist, s.h), (s.up, s.down, s.hist_len, s.skip, s.delay_outputs)),
    lambda aux, leaves: PolyResampler(leaves[0], leaves[1], *aux),
)
