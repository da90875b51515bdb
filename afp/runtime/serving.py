"""Host driver for the serving rings.

The device side of sustained serving is `Pipeline.run_ring`: one dispatch
advances `chunk` blocks around a device-resident input ring and a donated
output ring, each step reading one ring slot and writing its output slot in
place.  This module is the host side: a pump that

    1. lands incoming engine-sized blocks in the next input-ring slots
       (a donated in-place slot write, the only per-block copy),
    2. dispatches ``run_ring(n_steps=chunk, start=slot)``,
    3. drains the produced output slots to the sink,

keeping up to `max_inflight` dispatches enqueued on the device stream so
ingest/drain overlap compute.  Everything rides ONE in-order device
stream, which is what makes the aliasing safe: the output-slot slice for
chunk *i* is enqueued before dispatch *i+1* donates that ring version, so
the runtime sequences the read before the in-place overwrite; a refill
write for chunk *i+1* is enqueued after dispatch *i* and therefore can
never race the scan that reads slot *i*.

This is the production analog of the reference's callback → queue →
worker pipeline (`reference/stream_process_EQ_GUI.py:47-48,65-113`)
at the throughput operating point: maximal device occupancy, worst-case
latency ~``(max_inflight + 1) × chunk`` blocks (a chunk's first block is
drained only after `max_inflight` further chunks have been landed and
dispatched).  For the latency-first, callback-shaped operating point use
`BlockDispatcher`/`StreamEngine`.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..engine.config import PipelineParams, StreamConfig
from ..engine.pipeline import DeviceParams, Pipeline, StreamState
from ..utils.log import get_logger

logger = get_logger("serving")

__all__ = ["RingServer"]


def _write_slot(ring, blk, slot):
    return jax.lax.dynamic_update_index_in_dim(ring, blk, slot, 0)


class RingServer:
    """Sustained-throughput serving over device-memory rings.

    Parameters
    ----------
    pipeline:
        A `Pipeline` with ``supports_ring_step`` (fused chain, waterfall
        off, no device ASRC).  The input ring is float32, or raw int16
        with ``ingest='pcm16'``; the output ring is float32, or int16 with
        ``emit='pcm16'``.
        A `parallel.ShardedPipeline` works unchanged — the rings are
        placed with its published `ring_sharding` (global batch over the
        'streams' mesh), so one RingServer serves every device.
    params:
        Device parameter bank (defaults to the pipeline's own design).
    slots:
        Ring depth K (slots of [batch, blocksize]).
    chunk:
        Blocks per device dispatch.  Must divide `slots` so a dispatch
        never wraps into slots being refilled for the next one.
    max_inflight:
        How many chunks may be enqueued on the device ahead of the
        oldest undrained one — bounds host runahead (and with it serve
        latency).  ``(max_inflight + 1) * chunk`` must fit in `slots` so
        a refill never lands in a slot whose output is still undrained.
    spectrum_every:
        Serving-path observability (the reference captures spectra
        inside its hot callback,
        `reference/stream_process_GUI_Waterfall.py:471-478`): every Nth
        DRAINED block, compute the host-FFT dB spectrum of
        row ``spectrum_row`` (numpy — the drained block is already
        host-resident, so the tap steals no device time) and push it
        into the server's own depth-50 :attr:`waterfall_ring`
        (newest-last, the reference's deque layout) + the
        :attr:`spectrum_peak` readout.  Set :attr:`spectrum_sink` to a
        callable to ALSO receive the observed f32 [batch, L] block —
        the GUI hookup (`EqualizerController.update_spectrum`).
        0 disables the tap.
    """

    def __init__(self, pipeline: Pipeline,
                 params: Optional[DeviceParams] = None,
                 slots: int = 16, chunk: int = 4,
                 max_inflight: int = 2, seed: int = 0,
                 spectrum_every: int = 0, spectrum_row: int = 0):
        if not pipeline.supports_ring_step:
            raise ValueError(
                "RingServer requires a ring-capable pipeline: the fused "
                "chain with the waterfall and device ASRC disabled (see "
                "Pipeline.supports_ring_step)")
        if slots % chunk:
            raise ValueError(f"chunk {chunk} must divide slots {slots}")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if (max_inflight + 1) * chunk > slots:
            raise ValueError(
                f"(max_inflight+1)*chunk = {(max_inflight + 1) * chunk} "
                f"exceeds slots {slots}: refills would overwrite undrained "
                "output slots")
        self.pipe = pipeline
        #: reconfig (control thread) vs dispatch (serving thread) meet here —
        #: the serving-surface analog of the reference's `filter_lock`
        #: (`reference/stream_process_EQ_GUI.py:50-55, 380-385`) and of
        #: StreamEngine._swap_lock.  Dispatches snapshot `self.params` once
        #: per chunk, so a swap takes effect atomically at the next CHUNK
        #: boundary (never mid-chunk, never blended).
        self._swap_lock = threading.Lock()
        self.params = params if params is not None else (
            pipeline.device_params(PipelineParams.design(pipeline.cfg)))
        self.K = slots
        self.chunk = chunk
        self.max_inflight = max_inflight
        B, T = pipeline.batch, pipeline.block
        self._state: StreamState = pipeline.init_state(seed=seed)
        # multi-chip pipelines (ShardedPipeline) publish a ring sharding:
        # place the rings once so dispatches never pay a resharding copy
        shard = getattr(pipeline, "ring_sharding", None)

        def _alloc(dtype):
            z = jnp.zeros((slots, B, T), dtype)
            return z if shard is None else jax.device_put(z, shard)

        inner = getattr(pipeline, "pipeline", pipeline)  # ShardedPipeline
        self.pcm16 = bool(inner._i16_ingest)
        self._ring = _alloc(jnp.int16 if self.pcm16 else jnp.float32)
        self._out = _alloc(jnp.int16 if inner._emit16 else jnp.float32)
        self.blocks_served = 0
        #: blocks landed into input slots so far — `swap_params` records it
        #: so callers/tests can pin the exact swap boundary
        self.blocks_landed = 0
        #: block index (in landed order) of the most recent swap: every
        #: block from the first chunk dispatched at-or-after it runs the
        #: new bank (None until the first swap)
        self._swap_at_block: Optional[int] = None
        #: land→drain wall latency per served block (seconds, host clock),
        #: appended by stream(); read via latency_stats().  Bounded: a
        #: sustained server at ~23 blocks/s would otherwise leak ~2M list
        #: entries/day — the stats cover the most recent window
        from collections import deque

        self._latencies: deque = deque(maxlen=65536)
        #: drain-side spectrum tap (see `spectrum_every` in the class doc)
        self.spectrum_every = int(spectrum_every)
        if not 0 <= int(spectrum_row) < B:
            raise ValueError(
                f"spectrum_row {spectrum_row} out of range for batch {B}")
        self.spectrum_row = int(spectrum_row)
        self.spectrum_sink = None  # optional callable([batch, L] f32 block)
        self.waterfall_ring: Optional[np.ndarray] = None  # [50, n_bins]
        self.last_spectrum: Optional[np.ndarray] = None  # [n_bins] dB
        self.spectrum_peak: Optional[tuple] = None  # (freq_hz, level_db)

        self._write = jax.jit(_write_slot, donate_argnums=(0,))

    # -------------------------------------------------- live reconfiguration

    def swap_params(self, new_params: DeviceParams) -> None:
        """Atomically swap the device parameter bank mid-serve — the
        serving-ring expression of the reference's glitch-free live
        reconfiguration (`reference/stream_process_EQ_GUI.py:280-306`,
        lock swap `:380-385`).

        Semantics (the chunk-boundary atomicity contract):

        * takes effect at the next DISPATCH: every block of a chunk is
          processed with one bank (never mid-chunk, never blended);
        * chunks already dispatched (in flight) keep the old bank — the
          first affected output block is the first block of the next
          dispatched chunk, so reconfig-to-effect latency is bounded by
          ``(max_inflight + 1) * chunk`` blocks of drain;
        * zero blocks are dropped, replayed, or faded: the carried conv
          tail is pure INPUT history, so post-swap outputs are bit-identical
          to a stream that ran the new bank from the start (the same
          property the staged `StreamEngine.apply_config` relies on);
        * same shapes → no recompile.  Shape/dtype/structure changes are
          rejected (a new server is needed for them).
        """
        old = self.params
        for name, o, n in zip(old._fields, old, new_params):
            if (o is None) != (n is None):
                raise ValueError(
                    f"swap_params: field {name!r} changes presence "
                    f"({'set' if o is not None else 'None'} → "
                    f"{'set' if n is not None else 'None'}) — structural "
                    "changes recompile; build a new RingServer")
            if o is None:
                continue
            if o.shape != n.shape or o.dtype != n.dtype:
                raise ValueError(
                    f"swap_params: field {name!r} changes shape/dtype "
                    f"{o.shape}/{o.dtype} → {n.shape}/{n.dtype} — swaps "
                    "must preserve shapes (no recompile); rebuild the "
                    "server for static changes")
        with self._swap_lock:
            self.params = new_params
            self._swap_at_block = self.blocks_landed

    def set_eq_gains(self, gains) -> None:
        """Live gain-only update (runtime data — no redesign, no recompile),
        same chunk-boundary atomicity as :meth:`swap_params`."""
        g = jnp.asarray(np.asarray(gains, dtype=np.float32))
        with self._swap_lock:
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count")
            self.params = self.params._replace(eq_gains=g)
            self._swap_at_block = self.blocks_landed

    def retune(self, new_cfg: StreamConfig) -> None:
        """Design a new parameter bank from `new_cfg` (dynamic fields only —
        cutoff, window, gains, AGC knobs …) and :meth:`swap_params` it in:
        the serving-surface analog of `StreamEngine.apply_config`.  The cold
        design path (host convolutions + device upload, tens of ms) runs on
        the CALLER's thread, entirely outside the swap lock — the serving
        pump never stalls.  Static (shape) changes are rejected."""
        new_cfg = new_cfg.validate()
        if new_cfg.static_key() != self.pipe.cfg.static_key():
            raise ValueError(
                "retune is dynamic-only (same static_key); shape changes "
                "need a new Pipeline + RingServer")
        from ..ops.agc import AGCParams

        design = PipelineParams.design(new_cfg)
        new_agc = AGCParams(
            target_level=new_cfg.agc_target_level,
            window_size=new_cfg.agc_window_size,
            max_gain=new_cfg.agc_max_gain,
            attack=new_cfg.agc_attack,
            release=new_cfg.agc_release,
        )
        params = self.pipe.device_params(design, cfg=new_cfg, agc=new_agc)
        self.pipe.refresh_dynamic(new_cfg)
        self.swap_params(params)

    # -------------------------------------------------- spectrum tap

    def _tap_spectrum(self, block: np.ndarray) -> None:
        """Observe one drained [batch, L] block: host-FFT dB of the chosen
        row into the depth-50 ring + peak readout; forward the f32 block
        to `spectrum_sink` when set (the GUI/controller feed)."""
        from ..ops.spectrum import (WATERFALL_DEPTH, spectrum_db_np,
                                    spectrum_freqs)

        if block.dtype == np.int16:  # emit='pcm16': dequantize (exact)
            block = block.astype(np.float32) / np.float32(32768.0)
        db = spectrum_db_np(block[self.spectrum_row])
        if (self.waterfall_ring is None
                or self.waterfall_ring.shape[-1] != db.shape[-1]):
            self.waterfall_ring = np.full(
                (WATERFALL_DEPTH, db.shape[-1]), -200.0, dtype=np.float32)
        self.waterfall_ring = np.roll(self.waterfall_ring, -1, axis=0)
        self.waterfall_ring[-1] = db
        self.last_spectrum = db
        freqs = spectrum_freqs(block.shape[-1], self.pipe.cfg.samplerate)
        i = int(np.argmax(db))
        self.spectrum_peak = (float(freqs[i]), float(db[i]))
        if self.spectrum_sink is not None:
            self.spectrum_sink(block)

    # -------------------------------------------------- core pump

    def _land(self, slot: int, block) -> None:
        """Stage one engine-sized block into ring slot `slot` (in-place
        donated write — the ingest DMA analog)."""
        if self.pcm16:
            blk = jnp.asarray(block)
            if blk.dtype != jnp.int16:  # never silently quantize floats
                raise ValueError(
                    f"pcm16 RingServer blocks must be int16, got {blk.dtype}")
        else:
            blk = jnp.asarray(block, jnp.float32)
        self._ring = self._write(self._ring, blk, slot)

    def stream(self, source: Iterable) -> Iterator[np.ndarray]:
        """Pump `source` (an iterable of [batch, blocksize] f32 blocks, or
        raw int16 PCM blocks for ``ingest='pcm16'`` pipelines) through the
        rings; yield one [batch, blocksize] output per input block, in
        order.  The
        tail of a non-multiple-of-chunk source is served with a final
        short dispatch."""
        import time as _time

        inflight: list[tuple[jnp.ndarray, list[float]]] = []
        land_ts: list[float] = []  # land time per pending block
        slot = 0
        pending = 0
        src = iter(source)
        exhausted = False
        while not exhausted or inflight or pending:
            while not exhausted and pending < self.chunk:
                try:
                    block = next(src)
                except StopIteration:
                    exhausted = True
                    break
                self._land(slot + pending, block)
                land_ts.append(_time.perf_counter())
                pending += 1
                self.blocks_landed += 1
            if pending and (pending == self.chunk or exhausted):
                # snapshot the bank ONCE per dispatch: the whole chunk runs
                # one parameter set (swap_params' chunk-boundary atomicity)
                with self._swap_lock:
                    params = self.params
                self._state, self._out = self.pipe.run_ring(
                    params, self._state, self._ring, self._out, pending,
                    start=slot)
                # slice the produced slots out of THIS ring version now —
                # the next dispatch donates it, so the slice must be on
                # the stream first (in-order execution makes it safe)
                chunk_out = self._out[slot:slot + pending]
                try:
                    chunk_out.copy_to_host_async()
                except AttributeError:  # older jax: fetch blocks in drain
                    pass
                inflight.append((chunk_out, land_ts))
                land_ts = []
                slot = (slot + self.chunk) % self.K
                pending = 0
            # (pending is always 0 here once the source is exhausted —
            # the final short chunk dispatches in the same iteration)
            limit = 0 if exhausted else self.max_inflight
            while len(inflight) > limit:
                dev, ts = inflight.pop(0)
                arr = np.asarray(dev)
                now = _time.perf_counter()
                self._latencies.extend(now - t for t in ts)
                if not self.spectrum_every:
                    self.blocks_served += arr.shape[0]
                    yield from arr
                    continue
                for blk in arr:  # per-block drain: the Nth-block tap
                    if self.blocks_served % self.spectrum_every == 0:
                        self._tap_spectrum(blk)
                    self.blocks_served += 1
                    yield blk

    def serve(self, source: Iterable,
              sink: Callable[[np.ndarray], None]) -> dict:
        """Pump the whole `source` through :meth:`stream` into `sink`;
        return simple throughput metrics."""
        import time

        t0 = time.perf_counter()
        n = 0
        for out in self.stream(source):
            sink(out)
            n += 1
        wall = time.perf_counter() - t0
        cfg = self.pipe.cfg
        audio_s = n * self.pipe.batch * self.pipe.block / cfg.samplerate
        xrt = audio_s / wall if wall > 0 else float("inf")
        logger.info("served %d blocks, %.1f xRT", n, xrt)
        return {"blocks": n, "wall_s": wall, "xrt": xrt,
                "latency": self.latency_stats()}

    def latency_stats(self) -> dict:
        """Land→drain wall latency over the most recent served blocks
        (bounded window, host clock): the serving analog of the reference
        GUI's overrun/cpu_load self-monitoring
        (`stream_process_EQ_GUI.py:107-111,454-457`).
        Returns {n, p50_ms, p95_ms, max_ms, mean_ms} (zeros when empty)."""
        lat = np.asarray(self._latencies, dtype=np.float64)
        if not lat.size:
            return {"n": 0, "p50_ms": 0.0, "p95_ms": 0.0, "max_ms": 0.0,
                    "mean_ms": 0.0}
        q = np.quantile(lat, [0.5, 0.95])
        return {"n": int(lat.size),
                "p50_ms": float(q[0] * 1e3), "p95_ms": float(q[1] * 1e3),
                "max_ms": float(lat.max() * 1e3),
                "mean_ms": float(lat.mean() * 1e3)}

    @property
    def state(self) -> StreamState:
        """The carried device state (overlap tail, AGC gain, PRNG key) —
        checkpointable via the engine.checkpoint conventions."""
        return self._state
