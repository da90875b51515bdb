#!/usr/bin/env python
"""Stateful-OLA engine with presets — the `stream_process_GUI_Presets.py`
analog (C9).

The reference's `OverlapAddFilter` state-carry is the engine's native
streaming mode; this example exercises the preset system (save/load/delete,
excluding samplerate/blocksize, `Presets.py:153-195`), validated config
(`:358-398`), and engine-state checkpointing (the disk-persistence upgrade).

Run: python examples/presets_stream.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import tempfile

import numpy as np

from afp.engine import StreamConfig, StreamEngine, save_checkpoint, load_checkpoint
from afp.ui import EqualizerController


def main():
    cfg = StreamConfig(
        samplerate=44100, blocksize=1024, upsample_factor=1, numtaps=129,
        batch=4, cutoff=14000.0, eq_enabled=True, agc_enabled=False,
        dither_kind="off", downsample_mode="resample", output_clip=None,
    )
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        ctl = EqualizerController(StreamEngine(cfg), preset_path=f.name)

        # save two presets, flip between them
        ctl.set_gains([2.0] * 3 + [1.0] * 6)
        ctl.save_preset("bass boost")
        ctl.set_gains([1.0] * 6 + [2.0] * 3)
        ctl.save_preset("treble boost")
        print("presets:", ctl.preset_names)

        ctl.load_preset("bass boost")
        print("loaded 'bass boost', gains:", ctl.get_gains())

        # config validation clamps (the Presets-generation rules)
        ctl.set_field(numtaps=5000)
        ctl.apply_changes()
        print("clamped: numtaps", ctl.engine.cfg.numtaps, "(requested 5000)")
        ctl.set_field(numtaps=129)
        ctl.apply_changes()

        # process, checkpoint mid-stream, resume bit-exact
        rng = np.random.default_rng(3)
        sig = (0.2 * rng.standard_normal((4, 1024 * 8))).astype(np.float32)
        ctl.engine.process_signal(sig[:, : 1024 * 4])
        with tempfile.NamedTemporaryFile(suffix=".npz") as ck:
            save_checkpoint(ck.name, ctl.engine)
            resumed = load_checkpoint(ck.name)
            a = ctl.engine.process_signal(sig[:, 1024 * 4 :])
            b = resumed.process_signal(sig[:, 1024 * 4 :])
            print("resume max diff:", float(np.max(np.abs(a - b))))

        ctl.delete_preset("treble boost")
        print("after delete:", ctl.preset_names)


if __name__ == "__main__":
    main()
