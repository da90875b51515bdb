#!/usr/bin/env python3
"""Proof that the serving path runs on one NVIDIA GPU.

Drives the two operating points of the benchmark at full width (batch 4096)
through the entry points a user calls, in one process:

* C5 headline — 44.1 kHz, block 4096, 4× 'vhq' upsample, 1001-tap hamming
  lowpass at 11 kHz, EQ off, TPDF dither, f32 ingest;
* C8 AGC chain — block 2048, 2× upsample, 129 taps, 9-band EQ, exact-mode
  AGC (window 512, carry on), clip 0.99, TPDF dither.

Phases, in order (any failure exits non-zero before the final line):

0. device — platform, kind, count, JAX version, compile cache, and the
   card's name and power limit from ``nvidia-smi``; anything but a GPU
   exits 1;
1. compile — C5 and C8 steps at full width, with ``memory_analysis()``;
2. kernel checks — each translated stage against its plain reference
   (error printed beside its tolerance);
3. C5 through ``RingServer`` (f32, then pcm16 ingest + emit) — bitwise
   equal to ``Pipeline.run`` on the same blocks;
4. C8 through ``RingServer`` and ``StreamEngine`` — ring equal to staged,
   and the chain against a float64 numpy oracle on sampled rows;
5. the README quick start (batch 512 ``StreamEngine``);
6. the CLI (``afp process``) on a WAV made from a seed, fold vs scan.

The StreamEngine degradation ladder's counters (replays, silence, design
fallbacks) must stay 0 in every phase.  ``--timings`` adds the candidate
timings of each stage (µs per block); ``--four`` runs only the four-card
stream-parallel phase.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage::

    python chip_smoke.py [--timings] [--four] [--seed N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


class SmokeError(RuntimeError):
    """A phase failed."""


@dataclasses.dataclass(frozen=True)
class Size:
    """Shapes of one smoke run: `batch` streams per card, `chunks` ×
    `chunk` served blocks; the C5/C8 block sizes are the configs' own
    unless overridden (CPU toy runs)."""

    batch: int = 4096
    chunks: int = 4
    chunk: int = 4
    c5_block: int = 4096
    c8_block: int = 2048
    quick_batch: int = 512
    oracle_rows: int = 8

    @property
    def blocks(self) -> int:
        return self.chunks * self.chunk


FULL = Size()


def c5_config(size: Size = FULL, **kw):
    from afp.engine import StreamConfig

    fields = dict(
        samplerate=44100, blocksize=size.c5_block, upsample_factor=4,
        numtaps=1001, batch=size.batch, filter_type="lowpass",
        cutoff=11000.0, window_type="hamming", eq_enabled=False,
        agc_enabled=False, downsample_mode="decimate", dither_kind="tpdf",
        output_clip=None, resample_quality="vhq")
    return StreamConfig(**{**fields, **kw}).validate()


def c8_config(size: Size = FULL, **kw):
    from afp.engine import StreamConfig

    fields = dict(
        samplerate=44100, blocksize=size.c8_block, upsample_factor=2,
        numtaps=129, batch=size.batch, cutoff=14000.0, eq_enabled=True,
        agc_enabled=True, agc_mode="exact", agc_window_size=512,
        agc_carry=True, downsample_mode="decimate", dither_kind="tpdf",
        output_clip=0.99)
    return StreamConfig(**{**fields, **kw}).validate()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def rel_db(out, gold) -> float:
    out = np.asarray(out, np.float64)
    gold = np.asarray(gold, np.float64)
    err = np.max(np.abs(out - gold)) / (np.max(np.abs(gold)) + 1e-300)
    return float(20 * np.log10(err + 1e-300))


def sample_rows(batch: int, n: int) -> np.ndarray:
    return np.unique(np.linspace(0, batch - 1, min(n, batch)).astype(int))


def blocks_f32(seed: int, n: int, batch: int, block: int, scale: float):
    import jax
    import jax.numpy as jnp

    return jax.random.normal(jax.random.PRNGKey(seed), (n, batch, block),
                             jnp.float32) * scale


def make_pipe(cfg):
    from afp.engine import Pipeline, PipelineParams

    pipe = Pipeline(cfg)
    return pipe, pipe.device_params(PipelineParams.design(pipe.cfg))


def ladder_zero(engine, where: str) -> None:
    m = engine.metrics
    log(f"  ladder[{where}]: fallback_replays={m.fallback_replays} "
        f"fallback_silence={m.fallback_silence} "
        f"design_fallbacks={m.design_fallbacks}")
    check(m.fallback_replays == 0 and m.fallback_silence == 0
          and m.design_fallbacks == 0, f"degradation ladder engaged ({where})")


def serve(pipe, params, blocks, seed: int, chunk: int):
    """Serve `blocks` ([n, B, L]) through a RingServer; stacked outputs."""
    from afp.runtime.serving import RingServer

    n = blocks.shape[0]
    slots = max(2 * chunk, -(-n // chunk) * chunk)
    srv = RingServer(pipe, params, slots=slots, chunk=chunk, max_inflight=1,
                     seed=seed)
    outs = np.stack(list(srv.stream(blocks[i] for i in range(n))))
    check(outs.shape[0] == n, f"served {outs.shape[0]} of {n} blocks")
    return outs


# ---------------------------------------------------------------- oracles

def c5_oracle(x: np.ndarray, pipe, design) -> np.ndarray:
    """float64 causal C5 chain on rows [R, n]: zero-insert upsample, the
    up-kernel, the main FIR, phase-0 decimation (dither off, no clip)."""
    from afp.ops.resample import streaming_kernel

    up = pipe.upf
    h_up = streaming_kernel(up, 1, quality=pipe.cfg.resample_quality)
    main = np.asarray(design.main_taps, np.float64)
    out = []
    for row in np.asarray(x, np.float64):
        n = row.size
        z = np.zeros(n * up)
        z[::up] = row
        y = np.convolve(z, h_up)[: n * up]
        y = np.convolve(y, main)[: n * up]
        out.append(y[::up])
    return np.stack(out)


def c8_oracle(x: np.ndarray, pipe, design) -> np.ndarray:
    """float64 C8 chain on rows [R, n]: per-block AGC (moving RMS 'same',
    desired gain, attack/release with carried gain, clips), then the EQ ⊛
    main cascade at the upsampled rate, phase-0 decimation, output clip
    (dither off)."""
    from afp.ops.agc import agc_alphas
    from afp.ops.resample import streaming_kernel

    cfg = pipe.cfg
    L, w, up = cfg.blocksize, cfg.agc_window_size, pipe.upf
    a_att, a_rel = agc_alphas(w, cfg.agc_attack, cfg.agc_release)
    tgt, mg = cfg.agc_target_level, cfg.agc_max_gain
    box = np.full(w, 1.0 / w)
    x = np.asarray(x, np.float64)
    R, n = x.shape
    xa = np.empty_like(x)
    g = np.ones(R)
    for b0 in range(0, n, L):
        blk = x[:, b0:b0 + L]
        rms = np.sqrt(np.maximum(np.stack(
            [np.convolve(r * r, box, mode="same") for r in blk]), 0.0))
        d = np.clip(tgt / (rms + 1e-10), 0.0, mg)
        gs = np.empty_like(d)
        for t in range(L):
            a = np.where(d[:, t] > g, a_att, a_rel)
            g = a * d[:, t] + (1.0 - a) * g
            gs[:, t] = g
        gs = np.clip(gs, 0.1, mg)
        g = gs[:, -1]
        xa[:, b0:b0 + L] = np.clip(blk * gs, -0.99, 0.99)
    h_up = streaming_kernel(up, 1, quality=cfg.resample_quality)
    main = np.asarray(design.main_taps, np.float64)
    k = sum(float(gn) * np.convolve(np.asarray(b, np.float64), main)
            for gn, b in zip(design.eq_gains, design.eq_taps))
    out = []
    for row in xa:
        z = np.zeros(n * up)
        z[::up] = row
        y = np.convolve(z, h_up)[: n * up]
        y = np.convolve(y, k)[: n * up]
        out.append(np.clip(y[::up], -cfg.output_clip, cfg.output_clip))
    return np.stack(out)


# ---------------------------------------------------------------- phases

def phase_device(expect_platform: str = "gpu") -> dict:
    import jax

    from afp.utils.jax_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    log(f"[0] device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__} compile_cache={cache}")
    check(d.platform == expect_platform,
          f"platform {d.platform!r}, expected {expect_platform!r}")
    if expect_platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0 and smi.stdout.strip(),
              f"nvidia-smi failed: {smi.stderr.strip()}")
        info["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        log(f"  nvidia-smi: {info['nvidia_smi']}")
    return info


def phase_compile(size: Size) -> None:
    import jax.numpy as jnp

    for name, cfg in (("C5", c5_config(size)), ("C8", c8_config(size))):
        pipe, params = make_pipe(cfg)
        state = pipe.init_state(0)
        blk = jnp.zeros((pipe.batch, pipe.block), jnp.float32)
        t0 = time.perf_counter()
        compiled = pipe._step.lower(params, state, blk).compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        mem = {k: getattr(ma, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if ma is not None and hasattr(ma, k)}
        log(f"[1] compile {name}: batch={pipe.batch} block={pipe.block} "
            f"n_casc={pipe.n_casc} strategy={cfg.conv_strategy} "
            f"compile_s={dt:.2f} memory={mem}")


def phase_kernels(size: Size, seed: int, platform: str) -> None:
    import jax
    import jax.numpy as jnp

    from afp.ops.agc import smooth_gain_blockwise, smooth_gain_scan
    from afp.ops.dither import dither
    from afp.ops.pallas.agc_scan import smooth_gain_pallas
    from afp.ops.pcm16 import pcm16_to_f32, quantize_pcm16

    # conv chain vs the float64 oracle, both strategies, dither off
    for strategy in ("td_mxu", "fft"):
        cfg = c5_config(size, dither_kind="off", conv_strategy=strategy)
        pipe, params = make_pipe(cfg)
        blocks = blocks_f32(seed, 2, pipe.batch, pipe.block, 0.3)
        _, ys = pipe.run(params, pipe.init_state(0), blocks)
        rows = sample_rows(pipe.batch, size.oracle_rows)
        x = np.concatenate(np.asarray(blocks[:, rows]), axis=-1)
        y = np.concatenate(np.asarray(ys[:, rows]), axis=-1)
        from afp.engine import PipelineParams

        db = rel_db(y, c5_oracle(x, pipe, PipelineParams.design(pipe.cfg)))
        log(f"[2] conv C5 {strategy}: {db:.1f} dB vs float64 oracle on "
            f"{len(rows)} rows (tolerance < -90 dB: the repo's accuracy "
            "contract)")
        check(db < -90, f"C5 {strategy} conv {db:.1f} dB")

    # AGC recurrence kernel vs smooth_gain_scan / blockwise on the device,
    # and vs a float64 loop on sampled rows
    T, B = size.c8_block, size.batch
    key = jax.random.PRNGKey(seed + 1)
    walk = jnp.cumsum(jax.random.normal(key, (B, T)) * 0.02, axis=-1)
    d = jnp.abs(walk) % 4.0 + 0.25  # smooth positive desired gains
    g0 = jnp.ones((B,), jnp.float32)
    a_att, a_rel = 0.18, 0.02
    interpret = platform != "gpu"
    for mode, chunk, ref_fn in (
            ("exact", 1, lambda d: smooth_gain_scan(d, a_att, a_rel, init=g0)),
            ("fast", 32, lambda d: smooth_gain_blockwise(
                d, a_att, a_rel, chunk=32, init=g0))):
        g = jax.jit(lambda dt: smooth_gain_pallas(
            dt, a_att, a_rel, init=g0, chunk=chunk,
            interpret=interpret))(d.T).T
        ref = jax.jit(ref_fn)(d)
        err = float(jnp.max(jnp.abs(g - ref)))
        tol = 1e-6 * max(1.0, float(jnp.max(jnp.abs(ref))))
        log(f"[2] agc kernel {mode}: max abs err {err:.3e} vs the plain "
            f"recurrence on the device (tolerance {tol:.3e}: 1e-6 relative, "
            "float32 rounding — FMA contraction and the chunk-mean sum "
            "order may differ)")
        check(err <= tol, f"AGC kernel {mode} err {err}")
        check(bool(jnp.all(jnp.isfinite(g))), f"AGC kernel {mode} non-finite")
    rows = sample_rows(B, size.oracle_rows)
    dn = np.asarray(d[rows], np.float64)
    g = np.ones(len(rows))
    gold = np.empty_like(dn)
    for t in range(T):
        a = np.where(dn[:, t] > g, a_att, a_rel)
        g = a * dn[:, t] + (1 - a) * g
        gold[:, t] = g
    gk = np.asarray(jax.jit(lambda dt: smooth_gain_pallas(
        dt, a_att, a_rel, init=g0, interpret=interpret))(d.T).T)[rows]
    rel = float(np.max(np.abs(gk - gold)) / np.max(np.abs(gold)))
    log(f"[2] agc kernel exact: max rel err {rel:.3e} vs a float64 loop on "
        f"{len(rows)} rows (tolerance 1e-5: float32 rounding accumulated "
        f"over {T} steps)")
    check(rel <= 1e-5, f"AGC kernel vs float64 {rel}")

    # dither: bounds, mean and variance; same key, same bits
    shape = (size.batch, size.c5_block)
    zeros = jnp.zeros(shape, jnp.float32)
    bits = 16
    lsb = 2.0 ** (1 - bits)
    k = jax.random.PRNGKey(seed + 2)
    for kind, var_lsb2, bound in (("tpdf", 1 / 6, 1.0), ("rpdf", 1 / 12, 0.5)):
        f = jax.jit(lambda k, z, kind=kind: dither(k, z, bits, kind))
        n1 = f(k, zeros)
        n2 = f(k, zeros)
        same = bool(jnp.all(n1 == n2))
        m = float(jnp.mean(n1)) / lsb
        v = float(jnp.var(n1)) / lsb ** 2
        mx = float(jnp.max(jnp.abs(n1))) / lsb
        # 6-sigma sampling bounds for N draws (the sample variance of
        # these distributions has a standard deviation below 0.2/sqrt(N))
        N = n1.size
        tol_m = 6 * np.sqrt(var_lsb2 / N)
        tol_v = 1.2 / np.sqrt(N)
        log(f"[2] dither {kind}: |n|max={mx:.4f} lsb (bound {bound}), "
            f"mean={m:+.2e} lsb (tolerance {tol_m:.1e}), var={v:.5f} lsb^2 "
            f"(expected {var_lsb2:.5f} ± {tol_v:.1e}, 6 sigma over {N} "
            f"draws), same key same bits={same}")
        check(mx <= bound and abs(m) <= tol_m
              and abs(v - var_lsb2) <= tol_v and same,
              f"dither {kind} statistics")

    # pcm16 round trip over every int16 value
    allv = jnp.arange(-32768, 32768, dtype=jnp.int32).astype(jnp.int16)
    rt = jax.jit(lambda v: quantize_pcm16(pcm16_to_f32(v)))(allv)
    exact = bool(jnp.all(rt == allv))
    log(f"[2] pcm16 round trip over all 65536 values: exact={exact} "
        "(tolerance: exact)")
    check(exact, "pcm16 round trip")


def phase_c5_ring(size: Size, seed: int) -> None:
    import jax.numpy as jnp

    for label, kw in (("f32", {}),
                      ("pcm16", {"ingest": "pcm16", "emit": "pcm16"})):
        pipe, params = make_pipe(c5_config(size, **kw))
        blocks = blocks_f32(seed + 3, size.blocks, pipe.batch, pipe.block,
                            0.3)
        if label == "pcm16":
            blocks = jnp.round(blocks * 32767.0).astype(jnp.int16)
        _, ys = pipe.run(params, pipe.init_state(seed), blocks)
        staged = np.asarray(ys)
        served = serve(pipe, params, blocks, seed, size.chunk)
        same = bool(np.array_equal(served, staged))
        log(f"[3] C5 ring {label}: {size.chunks} chunks x {size.chunk} "
            f"blocks x {pipe.batch} streams, ring == staged bitwise: {same}, "
            f"out dtype={served.dtype}")
        check(same, f"C5 {label} ring != staged")
        if label == "f32":
            check(bool(np.all(np.isfinite(served))), "C5 non-finite output")


def phase_c8(size: Size, seed: int) -> None:
    from afp.engine import PipelineParams, StreamEngine

    cfg = c8_config(size)
    pipe, params = make_pipe(cfg)
    blocks = blocks_f32(seed + 4, size.blocks, pipe.batch, pipe.block, 0.1)
    _, ys = pipe.run(params, pipe.init_state(seed), blocks)
    staged = np.asarray(ys)
    served = serve(pipe, params, blocks, seed, size.chunk)
    same = bool(np.array_equal(served, staged))
    log(f"[4] C8 ring: {size.blocks} blocks x {pipe.batch} streams, "
        f"ring == staged bitwise: {same}")
    check(same, "C8 ring != staged")
    check(bool(np.all(np.isfinite(served))), "C8 non-finite output")

    engine = StreamEngine(cfg, seed=seed)
    eng = np.stack([engine.process_block(np.asarray(blocks[i]))
                    for i in range(2)])
    db = rel_db(eng, staged[:2])
    log(f"[4] C8 StreamEngine: 2 blocks, {db:.1f} dB vs Pipeline.run "
        "(tolerance < -90 dB: the same chain, jitted per block)")
    check(db < -90, f"C8 engine {db:.1f} dB")
    ladder_zero(engine, "C8")

    opipe, oparams = make_pipe(c8_config(size, dither_kind="off"))
    _, yo = opipe.run(oparams, opipe.init_state(0), blocks[:2])
    rows = sample_rows(opipe.batch, size.oracle_rows)
    x = np.concatenate(np.asarray(blocks[:2, rows]), axis=-1)
    y = np.concatenate(np.asarray(yo[:, rows]), axis=-1)
    db = rel_db(y, c8_oracle(x, opipe, PipelineParams.design(opipe.cfg)))
    log(f"[4] C8 chain: {db:.1f} dB vs float64 numpy chain on {len(rows)} "
        "rows, dither off (tolerance < -90 dB: the accuracy contract)")
    check(db < -90, f"C8 chain {db:.1f} dB")


def phase_quickstart(size: Size, seed: int) -> None:
    from afp.engine import StreamConfig, StreamEngine

    engine = StreamEngine(StreamConfig(batch=size.quick_batch,
                                       upsample_factor=2, numtaps=129,
                                       cutoff=14000.0))
    sig = np.random.default_rng(seed).standard_normal(
        (size.quick_batch, 44100)).astype(np.float32) * 0.1
    out = engine.process_signal(sig)
    engine.set_eq_gains([1.5, 1.2, 1.0, 1.0, 0.8, 1.0, 1.0, 1.2, 1.0])
    out2 = engine.process_signal(sig)
    ok = (out.shape == out2.shape and np.all(np.isfinite(out))
          and np.all(np.isfinite(out2)) and not np.array_equal(out, out2))
    log(f"[5] quick start: batch {size.quick_batch}, out {out.shape}, "
        f"set_eq_gains changed the output: {not np.array_equal(out, out2)}")
    check(bool(ok), "quick start")
    ladder_zero(engine, "quick start")


def phase_cli(seed: int, workdir: str) -> None:
    from afp import cli
    from afp.engine import StreamEngine
    from afp.utils import read_wav, write_wav

    rate, n = 44100, 44100 * 2
    x = (np.random.default_rng(seed).standard_normal((2, n)) * 0.2
         ).astype(np.float32)
    src = os.path.join(workdir, "in.wav")
    dst = os.path.join(workdir, "out.wav")
    write_wav(src, x, rate)
    argv = ["process", src, dst, "--dither", "off", "--cutoff", "11000"]
    rc = cli.main(argv)
    check(rc in (0, None), f"cli rc {rc}")
    folded, out_rate = read_wav(dst)
    xr, _ = read_wav(src)
    args = cli.build_parser().parse_args(argv)
    cfg = cli._configure(args, rate, batch_rows=2, link_group=2)
    engine = StreamEngine(cfg)
    L = cfg.blocksize
    pad = -n % L
    scan = engine.process_signal(
        np.concatenate([xr, np.zeros((2, pad), np.float32)], axis=1),
        fold=False)[:, :n]
    db = rel_db(folded, scan)
    log(f"[6] cli process: {folded.shape} at {out_rate} Hz, fold vs scan "
        f"{db:.1f} dB (tolerance < -90 dB: one batched product vs per-block "
        "products, float32 rounding)")
    check(folded.shape == scan.shape and db < -90, f"cli fold vs scan {db}")
    ladder_zero(engine, "cli scan")


def phase_four(size: Size, seed: int) -> None:
    """C5 over a 4-device stream mesh: each card holds the one-card shape."""
    import jax

    from afp.parallel import ShardedPipeline, make_mesh
    from afp.engine import PipelineParams

    n_dev = 4
    check(len(jax.devices()) >= n_dev,
          f"--four needs {n_dev} devices, found {len(jax.devices())}")
    cfg = c5_config(size, dither_kind="off")
    gcfg = dataclasses.replace(cfg, batch=cfg.batch * n_dev)
    sp = ShardedPipeline(gcfg, make_mesh(n_dev))
    params = sp.device_params(PipelineParams.design(sp.cfg))
    blocks = blocks_f32(seed + 5, size.blocks, gcfg.batch, cfg.blocksize,
                        0.3)
    from afp.runtime.serving import RingServer

    srv = RingServer(sp, params, slots=2 * size.chunk, chunk=size.chunk,
                     max_inflight=1, seed=seed)
    served = np.stack(list(srv.stream(blocks[i]
                                      for i in range(size.blocks))))
    devs = {d.id for d in srv._out.sharding.device_set}
    log(f"[4x] C5 over make_mesh({n_dev}): {gcfg.batch} streams, output "
        f"ring on devices {sorted(devs)}")
    check(len(devs) == n_dev, "output not spread over 4 devices")
    ring_fn = [v for k, v in sp._exec_cache.items() if k[0] == "ring"][0]
    st = sp.init_state(seed)
    hlo = ring_fn.lower(params, st, srv._ring, srv._out,
                        np.int32(0)).compile().as_text()
    coll = [c for c in ("all-reduce", "all-gather", "collective-permute",
                        "all-to-all", "reduce-scatter") if c in hlo]
    log(f"[4x] collectives in the compiled serving HLO: {coll or 'none'}")
    check(not coll, f"collectives in the serving HLO: {coll}")
    one, oparams = make_pipe(cfg)
    B = cfg.batch
    for s in range(n_dev):
        _, ys = one.run(oparams, one.init_state(seed),
                        jax.device_put(blocks[:, s * B:(s + 1) * B],
                                       jax.devices()[0]))
        same = bool(np.array_equal(served[:, s * B:(s + 1) * B],
                                   np.asarray(ys)))
        log(f"[4x] shard {s}: equal to a one-device Pipeline bitwise "
            f"(dither off): {same}")
        check(same, f"shard {s} differs from the one-device pipeline")


# ---------------------------------------------------------------- timings

def _time(f, *args, n: int = 10) -> float:
    import jax

    jax.block_until_ready(f(*args))
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        r = f(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n * 1e6


def phase_timings(size: Size, seed: int, card: str) -> dict:
    """Candidate times of each stage at the C5/C8 shapes (µs per block,
    after warm-up, ending in block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from afp.ops.agc import (smooth_gain_blockwise, smooth_gain_parallel,
                             smooth_gain_scan)
    from afp.ops.convolve import band_conv, next_pow2
    from afp.ops.dither import dither
    from afp.ops.pallas.agc_scan import smooth_gain_pallas

    res = {}
    P = jax.lax.DotAlgorithmPreset
    for name, cfg in (("C5", c5_config(size)), ("C8", c8_config(size))):
        pipe, params = make_pipe(cfg)
        nc, L, B = pipe.n_casc, pipe.block, pipe.batch
        x = blocks_f32(seed, 1, B, L + nc - 1, 0.3)[0]
        h = jnp.asarray(np.random.default_rng(seed).standard_normal(nc)
                        .astype(np.float32) / np.sqrt(nc))
        nfft = next_pow2(L + nc - 1)
        H = jnp.fft.rfft(h, n=nfft)
        fft = jax.jit(lambda x, H: jax.lax.slice_in_dim(
            jnp.fft.irfft(jnp.fft.rfft(x, n=nfft) * H, n=nfft),
            nc - 1, nc - 1 + L, axis=-1))
        res[f"{name}_conv_fft_us"] = _time(fft, x, H)
        for alg in ("BF16_BF16_F32_X3", "F32_F32_F32"):
            f = jax.jit(lambda x, h, a=getattr(P, alg): band_conv(
                x, h, algorithm=a))
            res[f"{name}_conv_band_{alg}_us"] = _time(f, x, h)
        key = jax.random.PRNGKey(seed)
        res[f"{name}_dither_tpdf_us"] = _time(
            jax.jit(lambda k, y: dither(k, y, 24, "tpdf")), key, x[:, :L])
        st = pipe.init_state(0)
        res[f"{name}_step_us"] = _time(pipe.step, params, st, x[:, :L])
        blocks = blocks_f32(seed, 8, B, L, 0.3)
        res[f"{name}_run8_us_per_block"] = _time(
            pipe.run, params, st, blocks, n=3) / 8
        if name == "C8":
            # end to end without the hand-written kernel: the plain
            # recurrences XLA compiles, in the same step
            for mode in ("exact", "fast"):
                ppipe, pparams = make_pipe(c8_config(size, agc_mode=mode))
                ppipe._agc_kernel = False
                res[f"C8_{mode}_step_plain_agc_us"] = _time(
                    ppipe.step, pparams, ppipe.init_state(0), x[:, :L], n=3)
            fpipe, fparams = make_pipe(c8_config(size, agc_mode="fast"))
            res["C8_fast_step_us"] = _time(fpipe.step, fparams,
                                           fpipe.init_state(0), x[:, :L])
    T, B = size.c8_block, size.batch
    d = jnp.abs(jnp.cumsum(jax.random.normal(
        jax.random.PRNGKey(seed), (B, T)) * 0.02, axis=-1)) % 4.0 + 0.25
    g0 = jnp.ones((B,), jnp.float32)
    aa, ar = 0.18, 0.02
    dt = d.T
    res["agc_exact_kernel_us"] = _time(jax.jit(
        lambda dt: smooth_gain_pallas(dt, aa, ar, init=g0)), dt)
    res["agc_fast_kernel_us"] = _time(jax.jit(
        lambda dt: smooth_gain_pallas(dt, aa, ar, init=g0, chunk=32)), dt)
    res["agc_exact_scan_us"] = _time(jax.jit(
        lambda d: smooth_gain_scan(d, aa, ar, init=g0)), d, n=3)
    res["agc_parallel_us"] = _time(jax.jit(
        lambda d: smooth_gain_parallel(d, aa, ar, init=g0)), d, n=3)
    res["agc_fast_blockwise_us"] = _time(jax.jit(
        lambda d: smooth_gain_blockwise(d, aa, ar, chunk=32, init=g0)), d,
        n=3)
    for k, v in res.items():
        log(f"[t] {k}={v:.1f} ({card})")
    return res


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timings", action="store_true",
                    help="also print the candidate timings of each stage")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card stream-parallel phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        info = phase_device("gpu")
        if args.four:
            phase_four(FULL, args.seed)
        else:
            phase_compile(FULL)
            phase_kernels(FULL, args.seed, "gpu")
            phase_c5_ring(FULL, args.seed)
            phase_c8(FULL, args.seed)
            phase_quickstart(FULL, args.seed)
            with tempfile.TemporaryDirectory() as tmp:
                phase_cli(args.seed, tmp)
            if args.timings:
                phase_timings(FULL, args.seed, info["nvidia_smi"])
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
