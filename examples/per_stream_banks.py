#!/usr/bin/env python
"""Per-stream parameter banks: every stream gets its OWN filter and EQ curve.

The reference runs one mono stream with one parameter set; the engine's
scaling axis is thousands of concurrent streams, and SURVEY §7 step 5
promises each can carry its own kernel/gains.  This example runs a batch
where stream k is a different filter design (rotating cutoffs/types), all in
the SAME fused FFT pass — one [B, F] response bank, zero recompilation on
swaps.

Run: python examples/per_stream_banks.py [--streams 8] [--blocks 20]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse
import time

import numpy as np

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.engine.batch import with_per_stream_filters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=20)
    args = ap.parse_args()

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=257,
        batch=args.streams, eq_enabled=False, agc_enabled=False,
        dither_kind="off", downsample_mode="decimate", output_clip=None,
    )
    pipe = Pipeline(cfg)

    # one design per stream: rotating lowpass cutoffs + a bandpass + a highpass
    variants = []
    for k in range(args.streams):
        if k % 4 == 3:
            variants.append(dict(filter_type="bandpass",
                                 cutoff=(300.0 * (k + 1), 4000.0 + 800.0 * k)))
        elif k % 4 == 2:
            variants.append(dict(filter_type="highpass", cutoff=500.0 + 400.0 * k))
        else:
            variants.append(dict(cutoff=4000.0 + 1500.0 * k))
    bank = with_per_stream_filters(pipe, variants)

    rng = np.random.default_rng(0)
    sig = (rng.standard_normal((args.streams, cfg.blocksize * args.blocks))
           * 0.3).astype(np.float32)
    t0 = time.perf_counter()
    _, out = pipe.process_signal(bank, pipe.init_state(), sig)
    out = np.asarray(out)
    dt = time.perf_counter() - t0
    audio = sig.size / cfg.samplerate
    print(f"{args.streams} streams × {args.blocks} blocks, each with its own "
          f"kernel: {audio / dt:,.0f}× realtime")
    for k in (0, min(2, args.streams - 1), min(3, args.streams - 1)):
        print(f"  stream {k} ({variants[k]}): out rms {out[k].std():.4f}")

    # --- per-stream AGC policy banks: one batch, two AGC targets ---
    import dataclasses

    from afp.engine.batch import with_per_stream_agc

    acfg = dataclasses.replace(
        cfg, blocksize=2048, batch=max(2, args.streams),
        agc_enabled=True, agc_mode="fast", agc_window_size=256,
        conv_strategy="td_mxu")
    apipe = Pipeline(acfg)
    ap = apipe.device_params(
        __import__("afp.engine", fromlist=["PipelineParams"]
                   ).PipelineParams.design(apipe.cfg))
    half = acfg.batch // 2
    ap = with_per_stream_agc(
        apipe, ap,
        target_level=np.r_[np.full(half, 0.05),
                           np.full(acfg.batch - half, 0.3)])
    quiet = (np.random.default_rng(1).standard_normal(
        (acfg.batch, acfg.blocksize)) * 0.01).astype(np.float32)
    _, y = apipe.step(ap, apipe.init_state(), quiet)
    y = np.asarray(y)
    print(f"per-stream AGC targets 0.05 vs 0.30 on quiet input: "
          f"out rms {y[:half].std():.4f} vs {y[half:].std():.4f}")


if __name__ == "__main__":
    main()
