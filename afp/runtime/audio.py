"""Optional real-audio host bridge (import-gated sounddevice backend).

The reference is, at heart, a live duplex audio program: a PortAudio stream
whose callback moves blocks between the sound card and the DSP
(`reference/stream_process.py:128-136`,
`stream_process_EQ_GUI.py:445-484`).  This module provides that last mile for
deployments that DO have audio hardware: a thin `sd.Stream` wrapper that
plugs the existing :class:`~afp.runtime.dispatcher.BlockDispatcher`
between the real-time callback and the device engine, honoring the reference's
contract:

* duplex stream, ``latency='high'``, explicit ``device=(in, out)`` pair
  (`stream_process.py:134-135`),
* callback = nowait submit + nowait fetch with the underrun blend
  (`stream_process_EQ_GUI.py:462-484`),
* stream ``status`` flags counted as under/overflows
  (`stream_process.py:83-85`),
* input channels map onto the engine's stream-batch axis (channel k is
  stream k), so a multichannel interface drives a batch>1 engine directly.

sounddevice/PortAudio is NOT a dependency: everything degrades cleanly when
absent (`audio_available()` gates; constructing without it raises a
RuntimeError naming the missing piece).  CI exercises this module with a
mock sounddevice (tests/test_audio_bridge.py); the simulated-clock driver
remains the default and the only CI-run stream path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..engine.engine import StreamEngine
from ..utils.log import get_logger
from .dispatcher import BlockDispatcher

logger = get_logger("audio")

__all__ = ["audio_available", "AudioStream"]


def _sounddevice():
    try:
        import sounddevice as sd

        return sd
    except Exception:  # ImportError or PortAudio load failure
        return None


def audio_available() -> bool:
    """True when sounddevice + a usable PortAudio backend are present."""
    sd = _sounddevice()
    if sd is None:
        return False
    try:
        sd.query_devices()
        return True
    except Exception:
        return False


class AudioStream:
    """Duplex PortAudio stream feeding a :class:`BlockDispatcher`.

    Usage (mirrors `stream_process.py:128-139`)::

        eng = StreamEngine(cfg)
        with AudioStream(eng, device=(1, 0)) as stream:
            while True:
                sd.sleep(1000)
    """

    def __init__(self, engine: StreamEngine,
                 device: Optional[tuple] = None,
                 latency: str = "high",
                 queue_depth: Optional[int] = None,
                 sd_module=None):
        self.sd = sd_module if sd_module is not None else _sounddevice()
        if self.sd is None:
            raise RuntimeError(
                "sounddevice/PortAudio is not available — install the "
                "'sounddevice' extra or use runtime.dispatcher.SimulatedStream"
            )
        self.engine = engine
        cfg = engine.cfg
        if (cfg.source_samplerate and cfg.source_samplerate != cfg.samplerate
                and cfg.asrc_mode == "exact"):
            # a duplex card runs ONE clock: exact-mode ASRC (variable block
            # counts) cannot satisfy the 1-in-1-out callback contract — the
            # output would pitch-shift and the queues diverge.
            # 'compat' reproduces the reference's per-block pad/trim, which
            # is what its live-audio path actually did
            # (`stream_process_AGC.py:126-129`).
            raise ValueError(
                "AudioStream requires asrc_mode='compat' when "
                "source_samplerate differs: a duplex stream runs one clock "
                "(use AsrcFrontend/process_source_block for offline exact "
                "conversion)"
            )
        if cfg.output_rate == "upsampled":
            # the same one-clock hazard: each engine block then yields
            # blocksize·upf output samples, but the card drains only
            # `frames` at cfg.samplerate — the output ring would overflow
            # permanently and playback would be time-stretched by upf
            raise ValueError(
                "AudioStream requires output_rate='base': a duplex stream "
                "runs one clock, so upsampled-rate output cannot be played "
                "at the card's samplerate"
            )
        kw = {} if queue_depth is None else {"queue_depth": queue_depth}
        self.dispatcher = BlockDispatcher(engine, **kw)
        self.channels = cfg.batch  # channel k ↔ stream k
        # Residual framers: PortAudio may deliver `frames != blocksize`
        # (driver-chosen frame counts, the final partial buffer).  The
        # reference's residual callback handles this losslessly
        # (`stream_process_GUI_Presets.py:617-686`); these regroup arbitrary
        # callback chunks into exact engine blocks and back, so the ladder's
        # pad/trim rung never fires on a size mismatch.
        from .framer import BlockFramer

        # ingest='pcm16': request int16 from PortAudio itself — the card's
        # native DMA sample format rides untouched from driver to device
        # kernel (zero host conversion passes; the engine converts exactly
        # on the VPU).  emit='pcm16' does the same on the OUTPUT side: the
        # device quantizes in the conv store and PortAudio hands the raw
        # int16 blocks to the card (no host float→int16 conversion).
        in_np = engine._in_dtype
        out_np = engine._out_dtype
        self._in_framer = BlockFramer(cfg.batch, dtype=in_np)
        self._out_framer = BlockFramer(cfg.batch, dtype=out_np)
        self._stream = self.sd.Stream(
            samplerate=cfg.samplerate,  # the card clock = engine rate
            blocksize=cfg.blocksize,
            channels=self.channels,
            dtype=(np.dtype(in_np).name, np.dtype(out_np).name),
            latency=latency,
            device=device,
            callback=self._callback,
        )

    # --- the PortAudio real-time contract ---

    def _callback(self, indata, outdata, frames, time_info, status) -> None:
        if status:  # under/overflow flags (`stream_process.py:83-85`)
            logger.warning("Stream status: %s", status)
            # PortAudio CallbackFlags distinguishes the directions: an
            # UNDERflow starves the stream (→ underruns); an OVERflow
            # loses data (→ drops).  Opaque/fake status objects without
            # the flag attributes keep the coarse underrun count.
            under = getattr(status, "output_underflow", None)
            if under is None:
                self.engine.metrics.underruns += 1
            else:
                if under or getattr(status, "input_underflow", False):
                    self.engine.metrics.underruns += 1
                if (getattr(status, "input_overflow", False)
                        or getattr(status, "output_overflow", False)):
                    self.engine.metrics.drops += 1
        bs = self.engine.cfg.blocksize
        self._in_framer.push(
            np.ascontiguousarray(indata.T, dtype=self.engine._in_dtype))
        while True:
            blk = self._in_framer.pull(bs)
            if blk is None:
                break
            if not self.dispatcher.submit(blk):
                self.engine.metrics.drops += 1
        # output side: pull whole processed blocks (underrun-blended by the
        # dispatcher) until `frames` samples are buffered, then emit exactly
        # `frames` — the residual carries to the next callback
        while self._out_framer.available() < frames:
            self._out_framer.push(self.dispatcher.fetch())
        out = self._out_framer.pull(frames)
        outdata[:, :] = out.T

    # --- lifecycle ---

    def start(self) -> None:
        self.dispatcher.start()
        self._stream.start()

    def stop(self) -> None:
        self._stream.stop()
        self.dispatcher.stop()

    def close(self) -> None:
        # stop the dispatcher worker too: close() without stop() otherwise
        # leaves the daemon thread pumping silence through the engine for
        # the life of the process
        self.dispatcher.stop()
        self._stream.close()

    @property
    def cpu_load(self) -> float:
        """PortAudio's callback load estimate — the reference's watchdog
        input (`stream_process_EQ_GUI.py:454-457`)."""
        return float(getattr(self._stream, "cpu_load", 0.0))

    def __enter__(self) -> "AudioStream":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        self.close()
