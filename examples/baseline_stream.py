#!/usr/bin/env python
"""Baseline streaming engine — the `stream_process.py` analog (C5).

Reference operating point (`reference/stream_process.py:19-30`):
fs 44.1 kHz, 4× upsample, block 4096, 301-tap hamming lowpass at 11 kHz,
dither, last-good fallback.  Here the same pipeline runs as a device batch over
`--streams` concurrent channels, driven by the simulated-clock stream driver
(no audio hardware needed); throughput and the response plot are
reported at the end.

Run: python examples/baseline_stream.py [--streams 64] [--blocks 50]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse

import numpy as np

from afp.engine import StreamConfig, StreamEngine
from afp.runtime import SimulatedStream
from afp.viz import plot_filter_response


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=50)
    ap.add_argument("--realtime", action="store_true",
                    help="pace at the real block rate (default: free-run)")
    args = ap.parse_args()

    cfg = StreamConfig(
        samplerate=44100,
        blocksize=4096,
        upsample_factor=4,
        numtaps=301,
        batch=args.streams,
        filter_type="lowpass",
        cutoff=11000.0,
        window_type="hamming",
        eq_enabled=False,
        agc_enabled=False,
        downsample_mode="decimate",
        dither_kind="tpdf",
        output_clip=None,
    )
    engine = StreamEngine(cfg)
    print(f"Starting DSP processing with {cfg.upsample_factor}x upsampling...")
    print(f"Streams: {cfg.batch}  block: {cfg.blocksize}  "
          f"upsampled rate: {cfg.upsampled_rate} Hz")

    # response plot of the main filter (the reference plots at startup,
    # `stream_process.py:43`)
    from afp.engine.config import PipelineParams

    design = PipelineParams.design(engine.cfg)
    plot_filter_response(design.main_taps, fs=cfg.upsampled_rate,
                         filter_type=cfg.filter_type,
                         save_path="/tmp/afp_baseline_response.png")
    print("Response plot: /tmp/afp_baseline_response.png")

    rng = np.random.default_rng(0)
    t = np.arange(cfg.blocksize) / cfg.samplerate

    def source(i):
        tone = 0.3 * np.sin(2 * np.pi * 440 * (t + i * cfg.blocksize / cfg.samplerate))
        noise = 0.01 * rng.standard_normal((cfg.batch, cfg.blocksize))
        return (tone[None, :] + noise).astype(np.float32)

    stream = SimulatedStream(engine, source=source, realtime=args.realtime)
    snap = stream.run(args.blocks)
    print("metrics:", snap)
    print(f"aggregate xRT (busy): {engine.metrics.xrt_busy(cfg.samplerate):,.0f}")


if __name__ == "__main__":
    main()
