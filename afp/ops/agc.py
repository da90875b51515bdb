"""Automatic gain control (device hot path, JAX).

Re-creates `apply_agc` (`reference/stream_process_AGC.py:43-89`)
semantics exactly:

1. moving-window RMS: ``sqrt(convolve(x², ones(w)/w, mode='same'))``,
2. desired gain ``clip(target/(rms+1e-10), 0, max_gain)``,
3. per-sample attack/release one-pole smoothing — branch on whether the
   desired gain is rising (attack α) or falling (release α), with
   ``α_eff = 1 − exp(−1/τ_samples)`` and τ truncated to int samples,
4. final ``clip(gain, 0.1, max_gain)``.

The input-dependent recurrence (3) is the sequential core (SURVEY.md §7 "hard
parts").  Two implementations:

* :func:`smooth_gain_scan` — exact `lax.scan` recurrence (batched over
  streams; per-sample sequential in time),
* :func:`smooth_gain_blockwise` — throughput-oriented approximation that
  applies the recurrence on ``chunk``-sample granularity (associative within
  a chunk via the closed-form one-pole on the chunk mean); used only when the
  engine is configured with ``agc_mode='fast'``.

A cross-block carry (the last smoothed gain) keeps streaming output
block-size-invariant, which the reference does NOT have (its AGC restarts at
``desired[0]`` every block, `stream_process_AGC.py:66-67`).  `carry=None`
reproduces the reference's per-block restart exactly.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["agc_alphas", "moving_rms", "desired_gain", "link_desired",
           "smooth_gain_scan", "smooth_gain_parallel",
           "smooth_gain_blockwise", "apply_agc", "AGCParams"]


def agc_alphas(window_size: int, attack: float = 0.01, release: float = 0.1):
    """Reference α computation (`stream_process_AGC.py:56-58, 70-76`):
    τ = int(time·window_size) samples; α = 1 − exp(−1/τ).  τ == 0 → α = 1
    (instant), matching the reference's 1/0 → inf → exp(−inf)=0 path."""
    attack_samples = int(attack * window_size)
    release_samples = int(release * window_size)
    a_att = 1.0 - math.exp(-1.0 / attack_samples) if attack_samples > 0 else 1.0
    a_rel = 1.0 - math.exp(-1.0 / release_samples) if release_samples > 0 else 1.0
    return a_att, a_rel


def moving_rms(x: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """sqrt of the boxcar moving average of x², mode='same' (zero-padded
    edges, like ``np.convolve(x², ones(w)/w, 'same')``,
    `stream_process_AGC.py:60-62`).

    Uses the FFT boxcar convolution rather than a cumulative-sum difference:
    cumsum in fp32 cancels catastrophically for quiet samples late in a block
    (absolute error ~Σx²·ε swamping small x² values); the FFT path keeps
    absolute error at the 1e-7 level uniformly.  `x`: [..., T].
    """
    from .convolve import fft_convolve

    w = int(window_size)
    sq = jnp.square(jnp.asarray(x, dtype=jnp.float32))
    if w == 1:
        return jnp.abs(x)
    box = jnp.full((w,), 1.0 / w, dtype=jnp.float32)
    ssum = fft_convolve(sq, box, mode="same")
    return jnp.sqrt(jnp.maximum(ssum, 0.0))


def desired_gain(rms: jnp.ndarray, target_level: float, max_gain: float) -> jnp.ndarray:
    """``clip(target/(rms+1e-10), 0, max_gain)``.  `target_level` and
    `max_gain` may be scalars or per-stream [B] vectors (`rms` then
    [B, T] — the batched form of the reference's single AGC policy)."""
    t = jnp.asarray(target_level, jnp.float32)
    m = jnp.asarray(max_gain, jnp.float32)
    if t.ndim == 1:
        t = t[:, None]
    if m.ndim == 1:
        m = m[:, None]
    return jnp.clip(t / (rms + 1e-10), 0.0, m)


def link_desired(d: jnp.ndarray, group: int, batch_axis: int = 0) -> jnp.ndarray:
    """Link the AGC across groups of `group` ADJACENT streams: every stream
    in a group gets the group's MINIMUM desired gain — equivalently the gain
    its loudest member's RMS demands (``desired_gain`` is monotone
    non-increasing in RMS and ``clip`` is monotone, so the group-min of
    ``clip(target/(rms+ε))`` IS ``clip(target/(max_rms+ε))``).  The standard
    stereo/multichannel link: with independent per-channel gains a stereo
    pair's image wanders toward the quieter channel; linking pins the
    inter-channel balance while the loudest channel drives the recurrence
    (identical desired rows ⇒ the attack/release recurrence yields identical
    gains, so no kernel changes downstream).

    The reference never faces this — it is mono (CHANNELS = 1,
    `reference/stream_process.py:22`; the AGC variant inherits it).

    `d`: desired-gain signal, stream axis at `batch_axis` (size a multiple
    of `group`; groups are adjacent rows, e.g. one file's channels).
    `group=1` is the identity.
    """
    if group == 1:
        return d
    b = d.shape[batch_axis]
    if b % group:
        raise ValueError(f"batch {b} is not a multiple of link group {group}")
    ax = batch_axis % d.ndim
    shape = d.shape[:ax] + (b // group, group) + d.shape[ax + 1:]
    dg = jnp.min(d.reshape(shape), axis=ax + 1, keepdims=True)
    return jnp.broadcast_to(dg, shape).reshape(d.shape)


def smooth_gain_scan(desired: jnp.ndarray, a_att: float, a_rel: float,
                     init: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Exact attack/release one-pole recurrence via lax.scan.

    `desired`: [..., T].  `init`: [...] previous smoothed gain, or None to
    restart at ``desired[..., 0]`` (the reference's per-block behavior,
    `stream_process_AGC.py:66-67`).
    """
    d = jnp.asarray(desired, dtype=jnp.float32)
    d_t = jnp.moveaxis(d, -1, 0)  # [T, ...]
    if init is None:
        g0 = d_t[0]
        seq = d_t[1:]
    else:
        g0 = jnp.asarray(init, dtype=jnp.float32)
        seq = d_t

    def step(g_prev, d_i):
        alpha = jnp.where(d_i > g_prev, a_att, a_rel)
        g = alpha * d_i + (1.0 - alpha) * g_prev
        return g, g

    _, gains = jax.lax.scan(step, g0, seq)
    if init is None:
        gains = jnp.concatenate([g0[None], gains], axis=0)
    return jnp.moveaxis(gains, 0, -1)


def _solve_linear_recurrence(alpha: jnp.ndarray, d_t: jnp.ndarray,
                             g0: jnp.ndarray) -> jnp.ndarray:
    """Solve g[t] = (1−α[t])·g[t−1] + α[t]·d[t] for t = 0..T−1 with g[−1]=g0,
    fully parallel via `lax.associative_scan` over affine-map composition.
    `alpha`, `d_t`: [T, ...]; `g0`: [...].  Returns [T, ...]."""
    A = 1.0 - alpha
    B = alpha * d_t
    # fold g0 into element 0 (making it the constant map g → g[0]) so the
    # inclusive prefix composition directly yields g[t] with no carry-in
    B = B.at[0].add(A[0] * jnp.broadcast_to(g0, d_t.shape[1:]))
    A = A.at[0].set(0.0)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, b_l * a_r + b_r

    _, Q = jax.lax.associative_scan(combine, (A, B), axis=0)
    return Q


def smooth_gain_parallel(desired: jnp.ndarray, a_att: float, a_rel: float,
                         init: Optional[jnp.ndarray] = None,
                         max_iters: int = 24) -> jnp.ndarray:
    """Parallel evaluation of the exact attack/release recurrence
    (`reference/stream_process_AGC.py:68-79`) via branch-consistent
    fixed-point iteration.

    **Status: REFERENCE IMPLEMENTATION, not a performance mode.**  On the
    GPU the Triton recurrence kernel (`ops.pallas.agc_scan`,
    ``agc_mode='exact'``) is faster at the C8 shape (PERF.md).  The solver
    earns its keep as the algorithm-independent consistency oracle for the
    recurrence (`bench.py::agc_parallel_vs_exact_db`).  Pick
    ``agc_mode='exact'`` or ``'fast'`` for throughput.

    The recurrence is *conditionally linear*: given the branch pattern
    ``b[t] = (desired[t] > g[t−1])`` it is a first-order linear recurrence,
    solvable in O(log T) depth with `lax.associative_scan`.  So iterate:

        1. guess b  (seeded from the desired-gain slope),
        2. solve the linear recurrence with α[t] = b[t] ? a_att : a_rel,
        3. recompute b from the solved gains; repeat until unchanged.

    **Convergence is prefix-monotone**: if decisions before position t are
    correct, the solved gains before t are exact, so the recomputed decision
    at the earliest wrong position is the true one and never regresses —
    each iteration extends the correct prefix.  For the smooth desired-gain
    signals AGC sees (RMS over a ≥64-sample window) convergence takes a
    handful of iterations; `max_iters` bounds the worst case (output then
    equals the recurrence with at most the last unconverged decisions
    differing, each at a point where ``desired ≈ g`` so both branches give
    nearly identical gains).  Equality with :func:`smooth_gain_scan` is
    asserted in tests over realistic and adversarial inputs.

    Same signature/semantics as :func:`smooth_gain_scan`.
    """
    d = jnp.asarray(desired, dtype=jnp.float32)
    d_t = jnp.moveaxis(d, -1, 0)  # [T, ...]
    if init is None:
        g0 = d_t[0]
        seq = d_t[1:]
    else:
        g0 = jnp.broadcast_to(jnp.asarray(init, dtype=jnp.float32), d_t.shape[1:])
        seq = d_t
    T = seq.shape[0]
    if T == 0:
        return jnp.moveaxis(g0[None], 0, -1) if init is None else d

    # [B]-vector α broadcasts over the time-major [T, ...] decision mask
    # (per-stream attack/release policies — `batch.with_per_stream_agc`)
    a_att = jnp.asarray(a_att, jnp.float32)
    a_rel = jnp.asarray(a_rel, jnp.float32)

    def solve(b):
        alpha = jnp.where(b, a_att, a_rel)
        return _solve_linear_recurrence(alpha, seq, g0)

    def decisions(g):
        g_prev = jnp.concatenate([g0[None], g[:-1]], axis=0)
        return seq > g_prev

    # seed: attack wherever the desired gain is rising (true whenever the
    # smoothed gain tracks below a rising target — the common case)
    b_seed = seq > jnp.concatenate([g0[None], seq[:-1]], axis=0)

    def cond(carry):
        _, _, it, changed = carry
        return jnp.logical_and(changed, it < max_iters)

    def body(carry):
        b, _, it, _ = carry
        g = solve(b)
        b_new = decisions(g)
        changed = jnp.any(b_new != b)
        return b_new, g, it + 1, changed

    init_carry = (b_seed, jnp.zeros_like(seq), jnp.int32(0), jnp.bool_(True))
    _, gains, _, _ = jax.lax.while_loop(cond, body, init_carry)
    if init is None:
        gains = jnp.concatenate([g0[None], gains], axis=0)
    return jnp.moveaxis(gains, 0, -1)


def smooth_gain_blockwise(desired: jnp.ndarray, a_att: float, a_rel: float,
                          chunk: int = 32,
                          init: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Throughput-oriented approximation of :func:`smooth_gain_scan`.

    The exact recurrence is per-sample sequential — the batched pipeline's
    only serial bottleneck (SURVEY.md §7 "AGC recurrence").  This variant
    runs the attack/release one-pole at `chunk` granularity (`T/chunk`
    sequential steps instead of `T`), with the equivalent per-chunk
    coefficient ``α_c = 1 − (1−α)^chunk``, then linearly interpolates gains
    within chunks.  Exact when the desired gain is chunkwise-constant;
    otherwise deviation is bounded by the within-chunk gain variation (small
    for τ ≫ chunk).  Selected via the engine's ``agc_mode='fast'``.
    """
    d = jnp.asarray(desired, dtype=jnp.float32)
    T = d.shape[-1]
    if T % chunk:
        raise ValueError(f"signal length {T} must be a multiple of chunk {chunk}")
    n_chunks = T // chunk
    # per-chunk target: mean desired gain over the chunk
    d_c = d.reshape(d.shape[:-1] + (n_chunks, chunk)).mean(axis=-1)
    a_att_c = 1.0 - (1.0 - a_att) ** chunk
    a_rel_c = 1.0 - (1.0 - a_rel) ** chunk
    g_c = smooth_gain_scan(d_c, a_att_c, a_rel_c, init=init)  # [..., n_chunks]
    # linear interpolation between chunk endpoints
    g_prev = jnp.concatenate(
        [
            (g_c[..., :1] if init is None else
             jnp.broadcast_to(jnp.asarray(init, jnp.float32)[..., None],
                              g_c[..., :1].shape)),
            g_c[..., :-1],
        ],
        axis=-1,
    )  # gain at each chunk start
    frac = (jnp.arange(chunk, dtype=jnp.float32) + 1.0) / chunk
    g = g_prev[..., :, None] + (g_c - g_prev)[..., :, None] * frac
    return g.reshape(d.shape)


class AGCParams:
    """Static AGC configuration (host-side); α values precomputed so gain
    changes never trigger recompilation."""

    def __init__(self, target_level: float = 0.1, window_size: int = 512,
                 max_gain: float = 10.0, attack: float = 0.01, release: float = 0.1):
        self.target_level = float(target_level)
        self.window_size = int(window_size)
        self.max_gain = float(max_gain)
        self.attack = float(attack)
        self.release = float(release)
        self.a_att, self.a_rel = agc_alphas(self.window_size, attack, release)


def apply_agc(x: jnp.ndarray, params: AGCParams,
              carry: Optional[jnp.ndarray] = None):
    """Full AGC chain on a block: [..., T] → (gained [..., T], last_gain [...]).

    With ``carry=None`` this reproduces the reference block semantics
    (`stream_process_AGC.py:43-89`); passing the previous block's returned
    gain makes the stream block-size-invariant.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    rms = moving_rms(x, params.window_size)
    d = desired_gain(rms, params.target_level, params.max_gain)
    g = smooth_gain_scan(d, params.a_att, params.a_rel, init=carry)
    g = jnp.clip(g, 0.1, params.max_gain)
    return x * g, g[..., -1]
