#!/usr/bin/env python
"""Serving rings — the throughput-first production loop.

The headline operating point (1001-tap lowpass, 4x upsample folded to one
base-rate cascade, tpdf dither) served through `RingServer`: blocks land
in donated device-memory input-ring slots, each device dispatch advances a
chunk of blocks, each step reading one ring slot and writing its output
slot in place (`Pipeline.run_ring`), and outputs drain in order while
later chunks are already queued.

Run: python examples/ring_serving.py [--streams 64] [--blocks 32]

`--pcm16` serves raw int16 PCM blocks (``ingest='pcm16'`` — the source
format of WAV files and sound-card DMA): the input ring holds int16, the
step converts at device entry (n/32768, exact), and the ingest bytes
halve.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse
import time

import numpy as np

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.runtime import RingServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--pcm16", action="store_true",
                    help="serve raw int16 PCM blocks (ingest='pcm16')")
    ap.add_argument("--retune", action="store_true",
                    help="swap the filter design mid-serve — glitch-free "
                         "live reconfiguration ON the rings: the new "
                         "bank is designed on this thread and takes effect "
                         "atomically at the next chunk dispatch")
    args = ap.parse_args()
    cfg = StreamConfig(
        samplerate=44100,
        blocksize=4096,
        upsample_factor=4,
        numtaps=1001,
        batch=args.streams,
        filter_type="lowpass",
        cutoff=11000.0,
        window_type="hamming",
        eq_enabled=False,
        agc_enabled=False,
        downsample_mode="decimate",
        dither_kind="tpdf",
        output_clip=None,
        conv_strategy="td_mxu",
        ingest="pcm16" if args.pcm16 else "f32",
    )
    pipe = Pipeline(cfg)
    srv = RingServer(pipe, slots=4 * args.chunk, chunk=args.chunk)

    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal(
        (args.blocks, args.streams, cfg.blocksize)) * 0.3).astype(np.float32)
    if args.pcm16:
        # the pcm16 contract: the source data IS 16-bit PCM
        blocks = np.clip(np.round(blocks * 32768.0), -32768, 32767
                         ).astype(np.int16)

    # warm-up dispatch (compile), then the timed serve
    _ = list(srv.stream(iter(blocks[: args.chunk])))
    source = iter(blocks)
    if args.retune:
        import dataclasses

        half = args.blocks // 2

        def source():
            for i, b in enumerate(blocks):
                if i == half:
                    srv.retune(dataclasses.replace(cfg, cutoff=6000.0))
                    print(f"retuned to 6 kHz at block {i} "
                          "(effective next chunk)")
                yield b
        source = source()
    peak = [0.0]
    t0 = time.time()
    m = srv.serve(source, lambda out: peak.__setitem__(
        0, max(peak[0], float(np.max(np.abs(out))))))
    print(f"served {m['blocks']} blocks x {args.streams} streams "
          f"in {m['wall_s']:.3f}s -> {m['xrt']:.0f}x realtime "
          f"(peak out {peak[0]:.3f})")
    assert m["blocks"] == args.blocks
    print(f"total wall (incl. warmup): {time.time() - t0:.3f}s")


if __name__ == "__main__":
    main()
