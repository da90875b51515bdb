#!/usr/bin/env python
"""Live duplex audio through the device engine — the `stream_process.py` analog
with REAL audio hardware (`reference/stream_process.py:128-139`).

Requires the optional sounddevice/PortAudio backend; on machines without it
(accelerator hosts, CI) this prints the device report and exits cleanly — the
simulated-clock driver (`examples/baseline_stream.py`) is the hardware-free
path.

Run: python examples/live_audio.py [--device-in 1 --device-out 0] [--seconds 10]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse
import time

from afp.engine import StreamConfig, StreamEngine
from afp.runtime import AudioStream, audio_available


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-in", type=int, default=None)
    ap.add_argument("--device-out", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cutoff", type=float, default=11000.0)
    ap.add_argument("--numtaps", type=int, default=301)
    args = ap.parse_args()

    if not audio_available():
        print("No PortAudio backend here — live audio unavailable.")
        print("Use examples/baseline_stream.py (simulated clock) instead.")
        from afp.runtime.devices import format_devices

        print("\nCompute devices:\n" + format_devices())
        return 0

    import sounddevice as sd

    print(sd.query_devices())
    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2,
        numtaps=args.numtaps, cutoff=args.cutoff, batch=1,
        eq_enabled=True, agc_enabled=False, dither_kind="tpdf",
    )
    engine = StreamEngine(cfg)
    device = None
    if args.device_in is not None or args.device_out is not None:
        device = (args.device_in, args.device_out)
    with AudioStream(engine, device=device) as stream:
        t_end = time.time() + args.seconds
        while time.time() < t_end:
            time.sleep(1.0)
            m = engine.metrics
            print(f"blocks {m.blocks_processed}  underruns {m.underruns}  "
                  f"cpu_load {stream.cpu_load:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
