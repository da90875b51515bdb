"""Host block dispatcher + simulated-clock stream driver (SURVEY.md §2.4,
§5.3).

Re-creates the reference's 3-thread streaming architecture
(`reference/stream_process_EQ_GUI.py:47-48, 65-113, 462-484`) around
the device engine:

    source → [input ring] → DSP thread (engine.process_block, async XLA)
           → [output ring] → paced consumer (the "audio callback")

with the exact queue semantics: bounded rings (default 20, the reference's
``Queue(maxsize=20)``), put_nowait + drop-on-full on the output side, timeout
→ process-silence on the input side, underrun → 0.8·last + 0.2·silence blend,
and output-queue priming with silence blocks
(`stream_process_EQ_GUI.py:147-148`).

The :class:`SimulatedStream` drives the consumer at the real block rate off
the native monotonic pacer — the authoritative latency-semantics harness
(SURVEY.md §7 "latency semantics") — with fault-injection hooks
(drop / late / corrupt) for failure-path tests.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..engine.engine import StreamEngine
from ..utils.log import get_logger

logger = get_logger("runtime")
from .host import BlockRing, Pacer

__all__ = ["BlockDispatcher", "SimulatedStream", "FaultInjector"]

#: reference queue depth (`stream_process_EQ_GUI.py:47-48`).
DEFAULT_QUEUE_DEPTH = 20
#: silence blocks pre-filled into the output queue (`:147-148`).
PRIME_BLOCKS = 15


@dataclass
class FaultInjector:
    """Deterministic fault injection for the simulated driver (§5.3)."""

    drop_every: Optional[int] = None  # drop every Nth input block
    late_every: Optional[int] = None  # delay every Nth block by `late_seconds`
    late_seconds: float = 0.0
    corrupt_every: Optional[int] = None  # NaN-poison every Nth block
    _n: int = field(default=0, repr=False)

    def apply(self, block: np.ndarray) -> Optional[np.ndarray]:
        self._n += 1
        if self.drop_every and self._n % self.drop_every == 0:
            return None
        if self.late_every and self._n % self.late_every == 0:
            time.sleep(self.late_seconds)
        if self.corrupt_every and self._n % self.corrupt_every == 0:
            bad = np.asarray(block).copy()
            if np.issubdtype(bad.dtype, np.floating):
                bad.flat[0] = np.nan
            else:
                # integer PCM (ingest='pcm16') cannot carry NaN — the
                # ladder's non-finite guard is structurally unreachable
                # from int ingest; inject a full-scale click instead so
                # the corruption is at least audible/testable downstream
                bad.flat[0] = np.iinfo(bad.dtype).min
            return bad
        return block


class BlockDispatcher:
    """Input ring → engine thread → output ring, with reference semantics.

    ``realtime=True`` (the default) is the reference's callback contract:
    input starvation fabricates a silence block
    (`stream_process_AGC.py:111-115`), the processed output is pushed
    nowait and DROPPED when the ring is full (`:198-199`), and the output
    ring is primed.  ``realtime=False`` is offline LOCKSTEP: the worker
    never fabricates input (a stalled driver just waits) and never drops
    a processed block (it waits for the consumer) — 1-in-1-out with no
    phantom silence, the mode :class:`SimulatedStream` uses for offline
    file runs."""

    def __init__(self, engine: StreamEngine,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 prime: int = PRIME_BLOCKS, realtime: bool = True):
        self.engine = engine
        self._realtime = realtime
        shape = (engine.cfg.batch, engine.cfg.blocksize)
        # output blocks may be longer than input blocks
        # (output_rate='upsampled' → blocksize·upf) — size the output ring
        # from the engine's actual output shape, not the input shape
        out_shape = tuple(engine._out_shape)
        # both rings ride the engine's I/O dtypes: raw int16 input for
        # ingest='pcm16' (half the queue bytes, no conversion) and raw
        # int16 OUTPUT for emit='pcm16' (the sound-card transport format —
        # half the drain bytes; blends requantize via engine._scale_out)
        self.in_ring = BlockRing(queue_depth, shape, dtype=engine._in_dtype)
        self.out_ring = BlockRing(queue_depth, out_shape,
                                  dtype=engine._out_dtype)
        self._shape = shape
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # prime the output queue with silence so the consumer never starves
        # at startup (`stream_process_EQ_GUI.py:147-148`)
        for _ in range(min(prime, queue_depth)):
            self.out_ring.push(np.zeros(out_shape, dtype=engine._out_dtype))
        self._last_out = np.zeros(out_shape, dtype=engine._out_dtype)

    # --- producer side (the "audio callback" input half) ---

    def submit(self, block: np.ndarray) -> bool:
        """Nowait enqueue of an input block; False = dropped (ring full)."""
        return self.in_ring.push(block)

    # --- worker ---

    def _worker(self) -> None:
        while not self._stop.is_set():
            blk = self.in_ring.pop(timeout=0.1)
            if blk is None:
                if not self._realtime:
                    # lockstep: a stalled driver is not starvation — wait
                    # for real input, never fabricate (fabricated silence
                    # would shift every later output by one block)
                    continue
                # input timeout → process silence (in the ingest dtype —
                # int16 zeros for pcm16; `stream_process_AGC.py:111-115`)
                blk = np.zeros(self._shape, dtype=self.engine._in_dtype)
            out = self.engine.process_block(blk)
            if self._realtime:
                # put_nowait; drop frame when full
                # (`stream_process_AGC.py:198-199`)
                if not self.out_ring.push(out):
                    self.engine.metrics.drops += 1
            else:
                # lockstep: never drop processed data — wait for the
                # consumer (bounded polls so stop() can interrupt)
                while not self._stop.is_set():
                    if self.out_ring.push(out, timeout=0.2):
                        break

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="afp-dsp-worker")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # --- consumer side (the "audio callback" output half) ---

    def _fetch(self, timeout: float) -> np.ndarray:
        """Dequeue; on underrun, the 0.8·last + 0.2·silence blend
        (`stream_process_EQ_GUI.py:476-480`) — one definition for both
        the nowait and the lockstep entry points."""
        out = self.out_ring.pop(timeout=timeout)
        if out is None:
            self.engine.metrics.underruns += 1
            out = self.engine._scale_out(self._last_out, 0.8)
        self._last_out = out
        return out

    def fetch(self) -> np.ndarray:
        """Nowait dequeue with the underrun blend (the RT callback side)."""
        return self._fetch(0.0)

    def fetch_blocking(self, timeout: float = 60.0) -> np.ndarray:
        """Lockstep dequeue for offline (non-realtime) mode; falls back to
        the underrun blend only after `timeout` seconds (generous: the
        first block includes jit compilation on a cold cache)."""
        return self._fetch(timeout)


class SimulatedStream:
    """Paced duplex stream without audio hardware: the `sd.Stream` analog.

    Drives `callback(indata) -> None`-style consumption at exactly
    blocksize/samplerate seconds per tick off the native monotonic pacer, so
    one-block-in/one-block-out latency is enforced and measurable.
    """

    def __init__(self, engine: StreamEngine,
                 source: Callable[[int], np.ndarray],
                 sink: Optional[Callable[[np.ndarray], None]] = None,
                 faults: Optional[FaultInjector] = None,
                 realtime: bool = True):
        self.engine = engine
        # offline lockstep: no silence priming (the 15 primed blocks would
        # lead the output and push the last 15 REAL blocks past the stop —
        # tail data loss), no fabricated input, no processed-block drops
        self.dispatcher = BlockDispatcher(
            engine, prime=PRIME_BLOCKS if realtime else 0,
            realtime=realtime)
        self.source = source
        self.sink = sink
        self.faults = faults
        self.realtime = realtime
        cfg = engine.cfg
        self.block_seconds = cfg.blocksize / cfg.samplerate
        self._stop = threading.Event()

    def stop(self) -> None:
        """Ask a running :meth:`run` loop (possibly in another thread) to
        exit after the current block — the GUI's Stop button hook."""
        self._stop.set()

    def run(self, n_blocks: Optional[int] = None, load_warn: float = 0.8) -> dict:
        """Run the paced loop for `n_blocks` (None = until :meth:`stop`);
        returns a metrics snapshot.

        `load_warn` mirrors the reference's PortAudio cpu_load watchdog
        (warn when device-busy fraction exceeds 0.8 of the block budget,
        `stream_process_EQ_GUI.py:454-457`).
        """
        self._stop.clear()
        # lockstep + exact-mode ASRC: the source and engine block grids
        # disagree (a source block completes 0, 1, or 2 engine blocks), so
        # a threaded 1-in-1-out handoff would interleave underrun blends
        # into the capture.  Drive the engine synchronously instead —
        # outputs are emitted exactly when a full converted block exists
        # (engine.drain_source_blocks), nothing fabricated, nothing lost.
        lockstep_asrc = (not self.realtime
                        and self.engine._asrc_frontend is not None)
        if not lockstep_asrc:
            self.dispatcher.start()
        pacer = Pacer(self.block_seconds) if self.realtime else None
        warned_load = False
        try:
            i = -1
            while not self._stop.is_set():
                i += 1
                if n_blocks is not None and i >= n_blocks:
                    break
                if (
                    self.realtime
                    and not warned_load
                    and self.engine.metrics.blocks_processed >= 8
                ):
                    load = self.engine.metrics.busy_seconds / max(
                        self.engine.metrics.blocks_processed * self.block_seconds,
                        1e-9,
                    )
                    if load > load_warn:
                        logger.warning("High engine load: %.2f", load)
                        warned_load = True
                blk = self.source(i)
                if self.faults is not None:
                    blk = self.faults.apply(blk)
                if lockstep_asrc:
                    if blk is not None:
                        for out in self.engine.drain_source_blocks(blk):
                            if self.sink is not None:
                                self.sink(out)
                    continue
                if blk is not None:
                    self.dispatcher.submit(blk)
                elif not self.realtime:
                    # lockstep: a dropped input produces no output block —
                    # fetching anyway would block on a tick that will
                    # never be processed
                    continue
                if self.realtime:
                    out = self.dispatcher.fetch()
                else:
                    out = self.dispatcher.fetch_blocking()
                if self.sink is not None:
                    self.sink(out)
                if pacer is not None:
                    missed = pacer.wait()
                    if missed:
                        self.engine.metrics.overruns += missed
        finally:
            self.dispatcher.stop()
        snap = self.engine.metrics.snapshot()
        snap["in_ring"] = self.dispatcher.in_ring.stats
        snap["out_ring"] = self.dispatcher.out_ring.stats
        if pacer is not None:
            snap["pacer_overruns"] = pacer.overruns
        return snap
