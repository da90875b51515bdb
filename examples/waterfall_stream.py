#!/usr/bin/env python
"""Waterfall engine — the `stream_process_GUI_Waterfall.py` analog (C10).

Per-block Hann-windowed spectra accumulate into the 50-deep history ring
(`Waterfall.py:112, 471-478`), computed ON DEVICE and rendered to a 3-D
surface PNG (`:312-339`).

Run: python examples/waterfall_stream.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import numpy as np

from afp.engine import StreamConfig, StreamEngine
from afp.ops.spectrum import (
    spectrum_db, spectrum_freqs, spectrum_peak, waterfall_init, waterfall_push,
)
from afp.viz import plot_waterfall


def main():
    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=1, numtaps=129,
        batch=1, cutoff=14000.0, eq_enabled=True, agc_enabled=False,
        dither_kind="off", downsample_mode="resample", output_clip=None,
    )
    engine = StreamEngine(cfg)
    freqs = spectrum_freqs(cfg.blocksize, cfg.samplerate)
    ring = waterfall_init(len(freqs))

    rng = np.random.default_rng(4)
    t0 = np.arange(cfg.blocksize) / cfg.samplerate
    for i in range(60):
        f = 500 + 50 * i  # sweeping tone
        block = (0.3 * np.sin(2 * np.pi * f * (t0 + i * cfg.blocksize / cfg.samplerate))
                 + 0.01 * rng.standard_normal(cfg.blocksize)).astype(np.float32)
        out = engine.process_block(block[None, :])
        db = spectrum_db(out[0])
        ring = waterfall_push(ring, db)
        if i % 20 == 0:
            pf, pl = spectrum_peak(db, freqs)
            print(f"block {i}: peak {float(pf):.0f} Hz @ {float(pl):.1f} dB")

    plot_waterfall(np.asarray(ring), freqs,
                   block_seconds=cfg.blocksize / cfg.samplerate,
                   save_path="/tmp/afp_waterfall.png")
    print("Waterfall: /tmp/afp_waterfall.png")


if __name__ == "__main__":
    main()
