"""Pallas kernel (Triton route) for the AGC attack/release recurrence.

The reference's per-sample one-pole with data-dependent α
(`reference/stream_process_AGC.py:68-79`) is serial in time.  Its
plain form, :func:`afp.ops.agc.smooth_gain_scan`, lowers to a device
while-loop with at least one kernel launch per sample.  Here one program
owns a tile of ``block_b`` streams, loops over time inside the kernel and
keeps the running gain in registers:

* the desired gain arrives time-major ``[T, B]``, so each step's load of
  ``block_b`` neighbouring streams is one coalesced row segment;
* α values arrive as ``[B]`` vectors (scalars are broadcast by the
  wrapper), so per-stream AGC policies need no separate variant;
* ``chunk > 1`` runs the blockwise recurrence of
  :func:`afp.ops.agc.smooth_gain_blockwise` (``agc_mode='fast'``): one
  step per ``chunk``-sample mean, linear interpolation within the chunk.

Seeding the carry with ``g₋₁ = desired[0]`` (or the first chunk mean)
makes step 0 reproduce the reference's per-block restart under either
branch, so the kernel always scans the full T.

Semantics equal :func:`smooth_gain_scan` / :func:`smooth_gain_blockwise`
up to float32 rounding (the compiler may contract ``α·d + (1−α)·g`` into
an FMA); tested in interpret mode on the CPU and against the plain
version on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["smooth_gain_pallas"]

#: streams per program for the exact (chunk 1) and blockwise recurrences.  Measured on an
#: H100 at [T, B] = [2048, 4096] (PERF.md): the exact recurrence is fastest
#: with 128-stream tiles (4 warps), the blockwise one with 32 (one warp,
#: 128 programs — one wave on the 132 SMs).
BLOCK_B_EXACT = 128
BLOCK_B_CHUNKED = 32
#: time steps per loop iteration (unrolled by hand — the Triton route
#: lowers only plain fori_loops); the loads of one iteration overlap the
#: gain chain of the previous one
UNROLL = 32


def _agc_kernel(d_ref, g0_ref, att_ref, rel_ref, g_ref, *, n_steps: int,
                chunk: int, unroll: int):
    a_att = att_ref[...][None, :]  # [1, BT]
    a_rel = rel_ref[...][None, :]
    g = g0_ref[...][None, :]
    last = n_steps - 1

    # Software pipeline: each iteration first issues the loads of the NEXT
    # iteration's rows (carried in registers), then runs its own steps.
    # The loads are independent of the gain chain, so their latency hides
    # behind it; issued after the previous steps' stores they could not be
    # hoisted (the compiler cannot prove the refs do not alias).
    if chunk == 1:
        def load(i):  # the `unroll` rows of iteration i, [1, BT] each
            return tuple(
                d_ref[pl.ds(jnp.minimum(i * unroll + u, last), 1), :]
                for u in range(unroll))

        def body(i, carry):
            g, rows = carry[0], carry[1:]
            nxt = load(i + 1)
            for u in range(unroll):
                alpha = jnp.where(rows[u] > g, a_att, a_rel)
                g = alpha * rows[u] + (1.0 - alpha) * g
                g_ref[pl.ds(i * unroll + u, 1), :] = g
            return (g,) + nxt

        jax.lax.fori_loop(0, n_steps // unroll, body, (g,) + load(0))
    else:
        fr = ((jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)
               .astype(jnp.float32) + 1.0) * jnp.float32(1.0 / chunk))

        def load(c):  # the [chunk, BT] rows of chunk c
            return d_ref[pl.ds(jnp.minimum(c, last) * chunk, chunk), :]

        def body(c, carry):
            g, rows = carry
            nxt = load(c + 1)
            d_mean = jnp.mean(rows, axis=0, keepdims=True)
            alpha = jnp.where(d_mean > g, a_att, a_rel)
            gn = alpha * d_mean + (1.0 - alpha) * g
            g_ref[pl.ds(c * chunk, chunk), :] = g + (gn - g) * fr
            return gn, nxt

        jax.lax.fori_loop(0, n_steps, body, (g, load(0)))


@functools.partial(jax.jit, static_argnames=("chunk", "block_b", "unroll",
                                             "interpret"))
def _agc_call(d_tm, g0, a_att, a_rel, *, chunk: int, block_b: int,
              unroll: int, interpret: bool):
    T, B = d_tm.shape
    unroll = math.gcd(unroll, T // chunk)
    grid = (B // block_b,)
    row = pl.BlockSpec((block_b,), lambda i: (i,))
    col = pl.BlockSpec((T, block_b), lambda i: (0, i))
    return pl.pallas_call(
        functools.partial(_agc_kernel, n_steps=T // chunk, chunk=chunk,
                          unroll=unroll),
        grid=grid,
        in_specs=[col, row, row, row],
        out_specs=col,
        out_shape=jax.ShapeDtypeStruct((T, B), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=max(1, block_b // 32),
                                             num_stages=1),
        interpret=interpret,
        name="agc_recurrence",
    )(d_tm, g0, a_att, a_rel)


def smooth_gain_pallas(desired_tm: jnp.ndarray, a_att, a_rel, init=None,
                       chunk: int = 1, block_b: int | None = None,
                       interpret: bool = False) -> jnp.ndarray:
    """Attack/release gains ``[T, B]`` from the time-major desired gain
    ``[T, B]``.

    `a_att`, `a_rel`: scalars or ``[B]`` vectors.  `init`: ``[B]`` carried
    gain, or None for the per-block restart.  ``chunk == 1`` is
    :func:`~afp.ops.agc.smooth_gain_scan`; ``chunk > 1`` is
    :func:`~afp.ops.agc.smooth_gain_blockwise` with that chunk (``T`` a
    multiple of it).  The batch is padded to a multiple of `block_b` (a
    power of two, as the Triton route requires; default by `chunk`, see
    :data:`BLOCK_B_EXACT`) and cut back after.
    """
    if block_b is None:
        block_b = BLOCK_B_EXACT if chunk == 1 else BLOCK_B_CHUNKED
    d = jnp.asarray(desired_tm, jnp.float32)
    T, B = d.shape
    if T % chunk:
        raise ValueError(f"signal length {T} must be a multiple of chunk "
                         f"{chunk}")
    if block_b & (block_b - 1):
        raise ValueError(f"block_b {block_b} must be a power of two")
    if init is not None:
        g0 = jnp.broadcast_to(jnp.asarray(init, jnp.float32).reshape(-1),
                              (B,))
    else:
        g0 = d[0] if chunk == 1 else jnp.mean(d[:chunk], axis=0)
    a_att = jnp.asarray(a_att, jnp.float32)
    a_rel = jnp.asarray(a_rel, jnp.float32)
    if chunk > 1:  # per-chunk coefficients, as smooth_gain_blockwise
        a_att = 1.0 - (1.0 - a_att) ** chunk
        a_rel = 1.0 - (1.0 - a_rel) ** chunk
    a_att = jnp.broadcast_to(a_att, (B,))
    a_rel = jnp.broadcast_to(a_rel, (B,))
    Bp = -(-B // block_b) * block_b
    if Bp != B:
        pad = lambda v: jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, Bp - B)])
        d, g0, a_att, a_rel = pad(d), pad(g0), pad(a_att), pad(a_rel)
    g = _agc_call(d, g0, a_att, a_rel, chunk=chunk, block_b=block_b,
                  unroll=UNROLL, interpret=interpret)
    return g[:, :B] if Bp != B else g
