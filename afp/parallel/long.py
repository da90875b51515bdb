"""Long-signal processing: the fused pipeline over a time-sharded mesh
(SURVEY.md §5.7 "context parallelism", applied to the production engine).

Because the engine's linear chain collapses to one base-rate FIR (the fused
cascade, see `engine/pipeline.py`), filtering an arbitrarily long signal
across D devices is exactly :func:`~afp.parallel.halo.halo_convolve` with
the cascade kernel: shard the time axis, exchange an ``n_casc−1`` halo with
one `ppermute`, convolve locally.  Output equals the streaming engine's
block-scan output bit-near (equivalence-tested).

The nonlinear stages are handled per their structure:
* dither is position-independent → applied per-shard with decorrelated keys,
* AGC splits into its parallel and sequential parts:
  the moving-RMS → desired-gain front half is per-engine-block local math
  and runs sharded (chunk edges aligned to block boundaries, so the per-
  block 'same' zero-padding matches the streaming engine exactly); the
  attack/release smoothing recurrence is inherently sequential in time, so
  shards are smoothed in mesh order with the boundary gain ([B] scalars —
  one tiny transfer per shard) handed to the next shard.  The heavy stages
  (RMS, gain apply, the fused-cascade convolution) stay parallel; only the
  O(T) scalar recurrence serializes, as it must.  Output ≡ the streaming
  engine with ``agc_mode='exact', agc_carry=True`` (equivalence-tested).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.pipeline import DeviceParams, Pipeline
from .halo import halo_convolve

__all__ = ["filter_long_signal"]


def _agc_apply_long(pipe: Pipeline, params: DeviceParams, x: jnp.ndarray,
                    mesh: Mesh, axis: str) -> jnp.ndarray:
    """The C8 AGC stage over a time-sharded long signal.

    Reproduces the streaming engine's semantics
    (`reference/stream_process_AGC.py:43-89` + the carry upgrade):
    per-`blocksize`-block moving-RMS/desired gain (parallel, sharded), then
    the exact per-sample smoothing recurrence in shard order with the
    boundary gain carried ([B] floats per hand-off), clip [0.1, max_gain],
    apply, clip ±0.99.
    """
    from ..ops.agc import (desired_gain, link_desired, moving_rms,
                           smooth_gain_scan)

    from .halo import batch_axis_of

    cfg = pipe.cfg
    L = cfg.blocksize
    B, T = x.shape
    D = mesh.shape[axis]
    C = T // D
    if C % L:
        raise ValueError(
            f"per-device chunk {C} must be a multiple of blocksize {L} for "
            "AGC (the engine's per-block RMS centering is part of the "
            "reference semantics)")
    bax = batch_axis_of(mesh, axis)
    if bax and B == 1:
        bax = None  # mono signal on a 2-D mesh: replicate the row
    if bax:
        S = mesh.shape[bax]
        if B % S or (B // S) % cfg.agc_link_group:
            raise ValueError(
                f"batch {B} must divide over the {S}-way '{bax}' axis in "
                f"whole agc_link_group={cfg.agc_link_group} groups "
                "(groups are shard-local, like ShardedPipeline)")

    w = cfg.agc_window_size

    def local_desired(chunk):
        # chunk [B_local, C] → per-engine-block RMS ('same' zero-padded per
        # block, the reference's np.convolve centering) → desired gain
        nb = chunk.shape[-1] // L
        blk = chunk.reshape(chunk.shape[0], nb, L)
        rms = moving_rms(blk, w)
        d = desired_gain(rms, params.agc_target, params.agc_max_gain)
        # the linked-AGC group-min (`StreamConfig.agc_link_group`), exactly
        # where the streaming engine applies it — between the RMS and the
        # recurrence; groups are shard-local (validated above), so every
        # shard sees whole groups
        d = link_desired(d, cfg.agc_link_group)
        if not cfg.agc_carry:
            # reference per-block restart (`stream_process_AGC.py:66-67`):
            # the recurrence is block-local → fully parallel, no hand-off
            d = smooth_gain_scan(d, float(pipe.agc.a_att),
                                 float(pipe.agc.a_rel), init=None)
        return d.reshape(chunk.shape[0], -1)

    d = jax.jit(jax.shard_map(
        local_desired, mesh=mesh,
        in_specs=P(bax, axis), out_specs=P(bax, axis), check_vma=False,
    ))(x)

    if cfg.agc_carry:
        # sequential hand-off in ENGINE-BLOCK granularity: the streaming
        # engine clips the smoothed gain to [0.1, max_gain] per block and
        # feeds the CLIPPED last value as the next block's recurrence init
        # (pipeline.py) — carrying an unclipped shard-wide gain would
        # diverge from streaming whenever the gain hits a bound
        a_att, a_rel = float(pipe.agc.a_att), float(pipe.agc.a_rel)
        mg = params.agc_max_gain

        def smooth_chunk(dc, g0):
            nb = dc.shape[-1] // L

            def body(gc, dblk):
                gb = smooth_gain_scan(dblk, a_att, a_rel, init=gc)
                gb = jnp.clip(gb, 0.1, mg)
                return gb[..., -1], gb

            g_last, gbs = jax.lax.scan(
                body, g0, jnp.moveaxis(dc.reshape(B, nb, L), 1, 0))
            return jnp.moveaxis(gbs, 0, 1).reshape(B, -1), g_last

        smooth = jax.jit(smooth_chunk)
        carry = jnp.ones((B,), dtype=jnp.float32)  # engine init_state gain
        gs = []
        for i in range(D):
            g, carry = smooth(
                jax.lax.slice_in_dim(d, i * C, (i + 1) * C, axis=-1), carry)
            gs.append(g)
        g = jnp.concatenate(gs, axis=-1)
    else:
        g = d  # already smoothed block-locally above
    g = jnp.clip(g, 0.1, params.agc_max_gain)
    return jnp.clip(x * g, -0.99, 0.99)  # `stream_process_AGC.py:180`


def filter_long_signal(pipe: Pipeline, params: DeviceParams, x: jnp.ndarray,
                       mesh: Mesh, axis: str = "time",
                       dither_seed: Optional[int] = None) -> jnp.ndarray:
    """Filter [T] or [B, T] through the fused cascade, time-sharded.

    `T` must divide over the mesh axis and the per-device chunk must exceed
    the cascade length.  Equivalent to streaming the signal through the
    pipeline (dither-off) block by block.

    On a 2-D (streams × time) mesh — ``make_mesh(8, ('streams', 'time'),
    shape=(2, 4))`` — the batch rows additionally shard over 'streams'
    (combined stream DP × context parallelism): rows are independent, so
    the halo ppermute stays within each streams row and the AGC hand-off
    still transfers only [B] scalars per time shard.  Per-stream kernel
    banks shard with their rows; `agc_link_group` groups must be
    shard-local (batch//S divisible, like ShardedPipeline).
    """
    if not pipe.fused:
        raise ValueError("long-signal mode requires fuse_rate_conversion=True")
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if pipe.cfg.agc_enabled:
        x = _agc_apply_long(pipe, params, x, mesh, axis)
    if squeeze:
        x = x[0]
    has_eq = pipe.cfg.eq_enabled and len(pipe.cfg.eq_bands) > 0
    if params.casc_main is not None:
        k = params.combined_cascade(has_eq)
    else:
        # reconstruct time-domain cascade from the spectrum
        H = params.combined_response(has_eq, premultiplied=True)
        # taps axis is LAST: H may be per-stream [B, F] (a leading-axis
        # slice would truncate streams and keep nfft wraparound taps)
        k = jnp.fft.irfft(H, n=pipe.nfft)[..., : pipe.n_casc]
    y = halo_convolve(x, k, mesh, axis=axis)
    if pipe.cfg.dither_kind != "off" and dither_seed is not None:
        from ..ops.dither import dither

        y = dither(jax.random.PRNGKey(dither_seed), y,
                   pipe.cfg.dither_bits, pipe.cfg.dither_kind)
    if pipe.cfg.output_clip is not None:
        y = jnp.clip(y, -pipe.cfg.output_clip, pipe.cfg.output_clip)
    return y
