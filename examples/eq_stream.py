#!/usr/bin/env python
"""Multiband-EQ engine — the `stream_process_EQ.py` / `stream_process_EQ_GUI.py`
analog (C6/C7).

The reference's 3-band inline variant (`stream_process_EQ.py:33-37`: bass
1.0×, mid 1.2×, treble 1.5×) and the GUI's 9-band combined-kernel variant
(`stream_process_EQ_GUI.py:87-90`) are both just gain vectors here — the EQ
bank folds into the fused frequency response either way.

Run: python examples/eq_stream.py [--bands 9|3]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse
import dataclasses

import numpy as np

from afp.engine import EQBand, StreamConfig, StreamEngine
from afp.ui import EqualizerController

#: the 3-band table of `stream_process_EQ.py:33-37`
THREE_BAND = (
    EQBand("Bass", 60.0, 250.0, 1.0),
    EQBand("Mid", 500.0, 2000.0, 1.2),
    EQBand("Treble", 4000.0, 16000.0, 1.5),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", type=int, choices=(3, 9), default=9)
    ap.add_argument("--streams", type=int, default=16)
    args = ap.parse_args()

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
        batch=args.streams, cutoff=14000.0, eq_enabled=True,
        agc_enabled=False, dither_kind="tpdf", downsample_mode="resample",
        output_clip=None,
    )
    if args.bands == 3:
        cfg = dataclasses.replace(cfg, eq_bands=THREE_BAND)
    ctl = EqualizerController(StreamEngine(cfg))
    print(f"{args.bands}-band EQ, gains: {ctl.get_gains()}")

    rng = np.random.default_rng(1)
    sig = (0.2 * rng.standard_normal((cfg.batch, cfg.blocksize * 20))).astype(np.float32)
    out1 = ctl.engine.process_signal(sig[:, : cfg.blocksize * 10])

    # live gain change — glitch-free, no recompile (the apply_changes path)
    if args.bands == 9:
        ctl.set_gains([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0])  # treble boost
    else:
        ctl.set_gains([1.5, 1.0, 0.5])
    out2 = ctl.engine.process_signal(sig[:, cfg.blocksize * 10 :])
    print("output rms before/after gain change:",
          float(np.std(out1)), float(np.std(out2)))
    print(f"aggregate xRT (busy): {ctl.engine.metrics.xrt_busy(cfg.samplerate):,.0f}")
    ctl.plot_response(save_path="/tmp/afp_eq_response.png")
    print("Response plot: /tmp/afp_eq_response.png")


if __name__ == "__main__":
    main()
