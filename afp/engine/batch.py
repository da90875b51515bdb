"""Per-stream parameter banks (SURVEY.md §7 step 5).

The reference runs one stream with one parameter set.  The engine's
scaling axis is thousands of concurrent streams — and each can carry its OWN
EQ gain vector (and, via gain-weighted band combination, its own effective
kernel): `combined_response` is a ``[B, n_bands] × [n_bands, F]`` contraction
followed by a broadcast multiply, so per-stream banks cost one small matmul
and zero recompilation.

Row-level banks always run the FFT path, whichever conv strategy is
configured: the gains contract into a [B, F] response (one small matmul)
and multiply the block spectra.  Per-stream *tap-level*
kernels (different numtaps per stream) are intentionally out of scope: that
is a shape change, which the static-shape contract forbids mid-stream.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from .config import PipelineParams
from .pipeline import DeviceParams, Pipeline

__all__ = ["with_per_stream_gains", "with_per_stream_filters",
           "with_per_stream_agc", "broadcast_gains"]


def with_per_stream_agc(pipe: Pipeline, params: DeviceParams,
                        target_level=None, max_gain=None,
                        attack=None, release=None) -> DeviceParams:
    """Per-stream AGC POLICY banks: promote any of the
    batch-global AGC knobs to a [batch] vector — a mixed-tenant batch can
    then carry one AGC policy per stream through the same fused kernels.

    `target_level` / `max_gain`: scalars or [batch] vectors, stored
    directly.  `attack` / `release`: per-stream TIME constants (the
    reference's knobs, `reference/stream_process_AGC.py:43-89`),
    converted per stream with the reference α rule
    (:func:`afp.ops.agc.agc_alphas` at the pipeline's static
    ``agc_window_size``).  Omitted knobs keep their current (scalar or
    vector) value.

    The vectors broadcast over time in the desired-gain and clip stages
    and enter the recurrence kernel as per-stream α, the serving ring
    consumes them unchanged, and checkpointing round-trips them
    (DeviceParams is flattened generically).  ``agc_link_group`` members
    should share a policy (linked streams share one gain — per-member
    targets would be overridden by the group-min semantics anyway).
    """
    cfg = pipe.cfg
    if not cfg.agc_enabled:
        raise ValueError("with_per_stream_agc requires agc_enabled=True")
    B = pipe.batch

    def vec(v, name):
        a = np.asarray(v, dtype=np.float32)
        if a.ndim == 0:
            return jnp.float32(a)
        if a.shape != (B,):
            raise ValueError(f"{name} must be a scalar or [{B}] vector, "
                             f"got shape {a.shape}")
        return jnp.asarray(a)

    upd = {}
    if target_level is not None:
        upd["agc_target"] = vec(target_level, "target_level")
    if max_gain is not None:
        upd["agc_max_gain"] = vec(max_gain, "max_gain")
    from ..ops.agc import agc_alphas

    for name, times, field in (("attack", attack, "agc_a_att"),
                               ("release", release, "agc_a_rel")):
        if times is None:
            continue
        t = np.asarray(times, dtype=np.float64)
        if t.ndim == 0:
            a_att, a_rel = agc_alphas(cfg.agc_window_size, float(t), float(t))
            upd[field] = jnp.float32(a_att if name == "attack" else a_rel)
            continue
        if t.shape != (B,):
            raise ValueError(f"{name} must be a scalar or [{B}] vector, "
                             f"got shape {t.shape}")
        alphas = np.empty(B, dtype=np.float32)
        for b in range(B):
            a_att, a_rel = agc_alphas(cfg.agc_window_size,
                                      float(t[b]), float(t[b]))
            alphas[b] = a_att if name == "attack" else a_rel
        upd[field] = jnp.asarray(alphas)
    return params._replace(**upd)


def broadcast_gains(gains, batch: int, n_bands: int) -> jnp.ndarray:
    """Normalize a gain spec to [batch, n_bands]: accepts [n_bands] (shared),
    [batch, n_bands] (per-stream), or a scalar."""
    g = jnp.asarray(np.asarray(gains, dtype=np.float32))
    if g.ndim == 0:
        g = jnp.full((batch, n_bands), g)
    elif g.ndim == 1:
        if g.shape[0] != n_bands:
            raise ValueError(f"expected {n_bands} gains, got {g.shape[0]}")
        g = jnp.broadcast_to(g[None, :], (batch, n_bands))
    elif g.ndim == 2:
        if g.shape != (batch, n_bands):
            raise ValueError(f"expected gains [{batch}, {n_bands}], got {g.shape}")
    else:
        raise ValueError("gains must be scalar, [n_bands], or [batch, n_bands]")
    return g


def with_per_stream_gains(pipe: Pipeline, params: DeviceParams,
                          gains) -> DeviceParams:
    """Return params with a per-stream gain matrix [batch, n_bands].

    ``combined_response`` then yields a [batch, F] response — each stream is
    filtered by its own EQ curve in the same fused FFT pass.
    """
    cfg = pipe.cfg
    if not (cfg.eq_enabled and len(cfg.eq_bands)):
        # H_bands is a [1, F] placeholder then and combined_response
        # statically ignores eq_gains — accepting the call would silently
        # no-op (or reject a correct [B, n_bands] matrix with a
        # misleading shape error)
        raise ValueError(
            "with_per_stream_gains requires eq_enabled=True with at "
            "least one EQ band (per-stream gains weight the band bank)")
    n_bands = params.H_bands.shape[0]
    g = broadcast_gains(gains, pipe.batch, n_bands)
    return params._replace(eq_gains=g)


def _batched_convolve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full linear conv of shared `a` [K] with each row of `b` [B, N]
    (float64, one batched FFT — the cold design path for stream banks)."""
    K, N = len(a), b.shape[-1]
    n = 1 << (K + N - 2).bit_length()
    out = np.fft.irfft(np.fft.rfft(a, n) * np.fft.rfft(b, n, axis=-1), n,
                       axis=-1)
    return out[..., : K + N - 1]


def with_per_stream_filters(pipe: Pipeline, variants: Sequence[dict]):
    """Per-stream MAIN-FILTER banks (SURVEY §7 step 5: "each stream can have
    its own kernel"): design one main filter per stream from `variants`
    (dicts of dynamic design-field overrides — cutoff, filter_type,
    window_type, design_method) and upload a [B, F] response bank.  Each
    stream is then filtered by its own kernel in the same fused FFT pass —
    the response multiply broadcasts over the batch, so the hot path is
    unchanged and swaps stay glitch-free.  The bank is row-granular: any
    stream order works, on both conv strategies (a row-level bank always
    runs the FFT pass), staged and ring alike.

    Constraints (all enforced):
    * one variant per stream (len == batch),
    * overrides must be shape-preserving (numtaps/blocksize/… are static —
      change them per stream and the batch no longer shares one program),
    * ``eq_enabled=False`` (per-band × per-stream cascade banks would be
      [B, n_bands, F] — design per-stream EQ by folding band gains into
      the per-stream kernel instead).
    """
    cfg = pipe.cfg
    if len(variants) != pipe.batch:
        raise ValueError(f"need {pipe.batch} variants, got {len(variants)}")
    if cfg.eq_enabled and len(cfg.eq_bands):
        raise NotImplementedError(
            "per-stream filter banks require eq_enabled=False "
            "(fold per-stream EQ into the kernel design instead)"
        )
    _STATIC = {"numtaps", "blocksize", "upsample_factor", "batch",
               "samplerate", "min_phase", "agc_window_size"}
    mains = []
    design0 = None
    for ov in variants:
        bad = _STATIC.intersection(ov)
        if bad:
            raise ValueError(f"per-stream overrides cannot change {sorted(bad)}"
                             " (shape-static fields)")
        c = dataclasses.replace(cfg, **ov).validate()
        if c.numtaps != cfg.numtaps:
            # validate() bumps even numtaps to odd for highpass/bandstop
            # (a type-II FIR has a forced Nyquist zero) — a per-variant
            # bump changes the kernel length, which np.stack would reject
            raise ValueError(
                f"variant {ov!r} changes numtaps {cfg.numtaps} → "
                f"{c.numtaps} (the even→odd bump for "
                f"{c.filter_type}): use an odd base numtaps so every "
                "per-stream kernel shares one static length")
        d = PipelineParams.design(c)
        if design0 is None:
            design0 = d
        mains.append(d.main_taps.astype(np.float64))
    mains = np.stack(mains)  # [B, n_kernel]

    if pipe.fused:
        casc = _batched_convolve(pipe._h_up_np, mains)
        if pipe._h_down_np is not None:
            casc = _batched_convolve(pipe._h_down_np, casc)
        casc = casc[:, :: pipe.upf]  # phase-0 polyphase component
        bank = np.zeros((pipe.batch, pipe.n_casc))
        bank[:, : casc.shape[-1]] = casc[:, : pipe.n_casc]
    else:
        bank = mains
    # base params built from variant 0's already-computed design (its
    # H_main is replaced on the next line anyway; every other field
    # depends only on the shared cfg — re-designing the base filter here
    # would double the cold bank-build cost for nothing)
    params = pipe.device_params(design0)
    H_main = jnp.fft.rfft(jnp.asarray(bank, jnp.float32), n=pipe.nfft,
                          axis=-1)
    return params._replace(H_main=H_main)
