"""StreamEngine — host-side orchestration of the device pipeline.

The L3 runtime: owns a compiled :class:`~afp.engine.pipeline.Pipeline`,
its parameter bank and streaming state, and implements the reference's two
operational disciplines on top:

* **Glitch-free live reconfiguration** (`reference/
  stream_process_EQ_GUI.py:280-306, 364-388`): `apply_config()` re-designs
  kernels on the host (cold path) and swaps the device parameter arrays
  between blocks — audio never stops, no recompilation, mirroring the
  `filter_lock` double-buffer swap.  Only *shape* changes (blocksize, upf,
  numtaps, batch…) rebuild the compiled pipeline.

* **Degradation ladder** (SURVEY.md §5.3, `stream_process.py:115-120`,
  `stream_process_AGC.py:493-496`): on a processing error the engine replays
  the last good block (deque of 4) or emits silence; on a design error it
  substitutes the reference's moving-average fallback kernel
  (``ones(128)/128``); underruns blend ``0.8·last + 0.2·silence``
  (`stream_process_EQ_GUI.py:476-480`).  Every event is counted in
  :class:`~afp.engine.metrics.EngineMetrics`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional
import jax
import jax.numpy as jnp
import numpy as np

from ..utils.log import RateLimited, get_logger

logger = get_logger("engine")
_rate = RateLimited(logger)

from .config import PipelineParams, StreamConfig
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState

__all__ = ["StreamEngine"]

#: last-good-block history depth (`stream_process.py:50`).
LAST_GOOD_DEPTH = 4


def _fallback_params(cfg: StreamConfig, n_kernel: int, n_bands: int) -> PipelineParams:
    """The reference's design-failure fallback: a 128-tap moving average
    (`stream_process_AGC.py:493-496`), zero-padded to the static kernel
    length; EQ bands become pass-through (zeros with unity center gain
    handled by gains=0)."""
    k = min(128, n_kernel)
    main = np.zeros(n_kernel, dtype=np.float32)
    main[:k] = 1.0 / k
    eq = np.zeros((n_bands, n_kernel), dtype=np.float32)
    if n_bands:
        eq[:, 0] = 1.0  # identity per band; gains select contribution
    return PipelineParams(
        main_taps=main, eq_taps=eq, eq_gains=np.zeros(n_bands, dtype=np.float32)
    )


class StreamEngine:
    """Single-slice streaming engine over `cfg.batch` concurrent streams."""

    def __init__(self, cfg: StreamConfig, seed: int = 0):
        self.cfg = cfg.validate()
        self.metrics = EngineMetrics(streams=self.cfg.batch)
        self._seed = seed
        # the reference's filter_lock (`stream_process_EQ_GUI.py:50-55`):
        # reconfig (control thread) vs block processing (worker thread)
        # synchronize here; dynamic swaps are a single attribute store, but a
        # shape rebuild replaces pipeline+params+state together.
        self._swap_lock = threading.Lock()
        self._build(self.cfg)

    # ---------------- construction / reconfig ----------------

    def _build(self, cfg: StreamConfig) -> None:
        self.pipeline = Pipeline(cfg)
        self.cfg = self.pipeline.cfg
        try:
            design = PipelineParams.design(self.cfg)
        except Exception as e:  # design-failure rung of the ladder
            logger.error("Filter design failed (%s); using moving-average fallback", e)
            self.metrics.design_fallbacks += 1
            design = _fallback_params(
                self.cfg, self.pipeline.n_kernel, len(self.cfg.eq_bands)
            )
        #: the host-side design (raw taps) behind :attr:`params` — for
        #: observation surfaces (response plots) that need the kernels
        #: without re-running the cold design path
        self.design: PipelineParams = design
        self.params: DeviceParams = self.pipeline.device_params(design)
        self.state: StreamState = self.pipeline.init_state(seed=self._seed)
        # block-exact host ASRC (asrc_mode='exact'): the frontend regroups
        # source-rate pushes into engine-rate blocks; the device pipeline
        # never sees the rate conversion (supersedes the reference's
        # stateless per-block pad/trim, `stream_process_AGC.py:126-129`)
        self._asrc_frontend = None
        if (cfg.source_samplerate and cfg.source_samplerate != cfg.samplerate
                and cfg.asrc_mode == "exact"):
            from ..runtime.asrc import AsrcFrontend

            self._asrc_frontend = AsrcFrontend(
                cfg.source_samplerate, cfg.samplerate, batch=cfg.batch,
                quality=cfg.resample_quality,
            )
            self._asrc_outq: deque = deque(maxlen=64)
        self._last_good: deque = deque(maxlen=LAST_GOOD_DEPTH)
        # ingest='pcm16': host blocks are raw int16 PCM end-to-end (ladder
        # pad/trim, framing, checkpointed residuals all carry int16; the
        # device converts exactly — see Pipeline._step_impl).  Never coerce
        # floats to int16 here: that would silently quantize.
        self._in_dtype = (np.int16 if getattr(self.pipeline, "_i16_ingest",
                                              False) else np.float32)
        # emit='pcm16': outputs are raw int16 PCM end-to-end (ladder
        # fallbacks, underrun blends, output framer residuals all carry
        # int16; blends compute in f32 and requantize — see _scale_out)
        self._out_dtype = (np.int16 if getattr(self.pipeline, "_emit16",
                                               False) else np.float32)
        self._block_seconds = self.cfg.blocksize / self.cfg.samplerate
        out_len = (self.cfg.upsampled_block if self.pipeline.upsampled_out
                   else self.cfg.blocksize)
        self._out_shape = (self.cfg.batch, out_len)
        # lossless arbitrary-frames ingest (process_frames): residual framers
        # created lazily on first use, with the output side primed by ONE
        # block of silence — the fixed framing latency that makes "n samples
        # in → n·r samples out" hold for every chunking (r = out_len/bs)
        self._in_framer = None
        self._out_framer = None

    def apply_config(self, new_cfg: StreamConfig) -> bool:
        """Apply a new configuration.  Returns True if the swap was
        glitch-free (dynamic-only), False if shapes changed and the pipeline
        was rebuilt (stream state resets, like the reference's re-init)."""
        new_cfg = new_cfg.validate()
        if new_cfg.static_key() == self.cfg.static_key():
            try:
                design = PipelineParams.design(new_cfg)
            except Exception as e:
                logger.error("Filter design failed (%s); keeping previous parameters", e)
                self.metrics.design_fallbacks += 1
                return True
            # Build the NEW bank entirely OUTSIDE the swap lock (host
            # convolutions + device uploads take tens of ms — holding the
            # lock would stall the real-time thread),
            # derived from the NEW config's dynamic fields via overrides.
            from ..ops.agc import AGCParams

            new_agc = AGCParams(
                target_level=new_cfg.agc_target_level,
                window_size=new_cfg.agc_window_size,
                max_gain=new_cfg.agc_max_gain,
                attack=new_cfg.agc_attack,
                release=new_cfg.agc_release,
            )
            params = self.pipeline.device_params(design, cfg=new_cfg,
                                                 agc=new_agc)
            # atomic swap between blocks — the filter_lock analog (cheap:
            # attribute stores only)
            with self._swap_lock:
                self.pipeline.refresh_dynamic(new_cfg)
                self.design = design
                self.params = params
                self.cfg = new_cfg
                self._block_seconds = new_cfg.blocksize / new_cfg.samplerate
            return True
        with self._swap_lock:
            self.cfg = new_cfg
            self._build(new_cfg)
        return False

    def set_eq_gains(self, gains) -> None:
        """Live gain update — runtime data only (no redesign, no recompile)."""
        import jax.numpy as jnp

        g = jnp.asarray(np.asarray(gains, dtype=np.float32))
        with self._swap_lock:
            # read-modify-write under the swap lock: an unlocked writer here
            # could resurrect a pre-apply_config parameter bank mid-swap
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count")
            self.params = self.params._replace(eq_gains=g)

    # ---------------- block processing with the ladder ----------------

    def process_source_block(self, block: np.ndarray):
        """Block-exact ASRC path: push a source-rate block of ANY length,
        get an engine-rate [batch, blocksize] output when one is ready, else
        None (the stream is still buffering — an honest Optional, unlike the
        reference's time-stretching pad/trim).  Without ASRC this is just
        :meth:`process_block`."""
        if self._asrc_frontend is None:
            return self.process_block(block)
        self._asrc_drain(block)
        return self._asrc_outq.popleft() if self._asrc_outq else None

    def drain_source_blocks(self, block: np.ndarray) -> list:
        """Push one source-rate block and return EVERY engine block it
        completes — none, one, or several (up-conversion produces more
        engine blocks than source blocks).  This is the lockstep-streaming
        ASRC surface: an output exists exactly when a full converted block
        does, so no underrun blend or fabricated silence is ever
        interleaved into the stream (that padding is the REALTIME
        contract's job).  Without ASRC: one block in, one block out."""
        if self._asrc_frontend is None:
            return [self.process_block(block)]
        self._asrc_drain(block)
        outs = list(self._asrc_outq)
        self._asrc_outq.clear()
        return outs

    def _asrc_drain(self, block: np.ndarray) -> None:
        """Push a source-rate block (any length; batch coerced — the
        never-raises contract) and process EVERY completed engine block into
        the bounded host queue.  Draining fully matters: up-conversion
        produces more engine blocks than calls, so pulling one per call
        would grow the frontend buffer without bound.  Queue overflow counts
        as drops (the reference's full-output-queue rung,
        `stream_process_AGC.py:198-199`)."""
        block = np.asarray(block, dtype=np.float32)
        if block.ndim == 1:
            block = np.broadcast_to(
                block[None, :], (self.cfg.batch, block.shape[-1])
            )
        elif block.shape[0] != self.cfg.batch:
            fixed = np.zeros((self.cfg.batch, block.shape[1]), np.float32)
            b = min(block.shape[0], self.cfg.batch)
            fixed[:b] = block[:b]
            block = fixed
        self._asrc_frontend.push(block)
        while True:
            pulled = self._asrc_frontend.pull(self.cfg.blocksize)
            if pulled is None:
                break
            if len(self._asrc_outq) == self._asrc_outq.maxlen:
                # full output queue drops the INCOMING frame (the
                # reference's put_nowait semantics,
                # `stream_process_AGC.py:198-199`) — appending would evict
                # the oldest buffered block and skip ahead in the timeline
                self.metrics.drops += 1
                continue
            self._asrc_outq.append(self._process_engine_block(pulled))

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """One [batch, blocksize] block in → [batch, blocksize] out.

        Never raises: on failure, degrades per the reference ladder.
        With exact-mode ASRC active, the input is source-rate: it routes
        through the frontend, and a not-yet-filled engine block degrades to
        the underrun blend (use :meth:`process_source_block` for the honest
        Optional contract).
        """
        block = self._coerce_in(block)
        if self._asrc_frontend is not None:
            self._asrc_drain(block)
            if not self._asrc_outq:
                return self.underrun_block()
            return self._asrc_outq.popleft()
        if block.ndim == 1:
            block = block[None, :]
        return self._process_engine_block(block)

    def _coerce_in(self, block: np.ndarray) -> np.ndarray:
        """Host-block dtype contract: f32 ingest coerces (the reference's
        float callback buffers); pcm16 ingest REQUIRES int16 — coercing a
        float block would silently quantize, so that is a caller error."""
        block = np.asarray(block)
        if self._in_dtype == np.int16:
            if block.dtype != np.int16:
                raise ValueError(
                    f"ingest='pcm16' engine blocks must be int16, got "
                    f"{block.dtype}")
            return block
        return np.asarray(block, dtype=np.float32)

    def process_frames(self, chunk: np.ndarray) -> np.ndarray:
        """Lossless arbitrary-frames ingest: [batch, n] in → [batch, n·r] out
        for ANY n (r = upsample_factor when ``output_rate='upsampled'``,
        else 1), at a fixed one-block latency.

        This is the reference's residual-carrying callback
        (`reference/stream_process_GUI_Presets.py:617-686`) — input
        residual concatenation, whole-block processing, output residual
        carry — made lossless (the reference drops its output residual on
        callbacks with zero complete blocks).  Unlike :meth:`process_block`,
        a size mismatch is NEVER padded or truncated: samples are regrouped,
        so the ladder's pad/trim rung fires only on true corruption.

        The first ``blocksize·r`` output samples are the silence of the
        framing latency (analogous to the reference's output-queue priming,
        `stream_process_EQ_GUI.py:147-148`); thereafter output[k] is the
        processed stream delayed by exactly one block.
        """
        if self._asrc_frontend is not None:
            raise ValueError(
                "process_frames requires source_samplerate == samplerate; "
                "use process_source_block for exact-mode ASRC (it already "
                "accepts arbitrary chunk lengths)")
        chunk = self._coerce_in(chunk)
        if chunk.ndim == 1:
            chunk = np.broadcast_to(chunk[None, :],
                                    (self.cfg.batch, chunk.shape[-1]))
        out_len = self._out_shape[1]
        r = out_len // self.cfg.blocksize
        if self._in_framer is None:
            from ..runtime.framer import BlockFramer

            # residuals ride the transport dtypes: raw int16 ingest for
            # pcm16, raw int16 output for emit='pcm16' (a float framer
            # would silently coerce the device's PCM to raw-integer f32)
            self._in_framer = BlockFramer(self.cfg.batch,
                                          dtype=self._in_dtype)
            self._out_framer = BlockFramer(self.cfg.batch,
                                           dtype=self._out_dtype)
            self._out_framer.push(
                np.zeros((self.cfg.batch, out_len), dtype=self._out_dtype))
        self._in_framer.push(chunk)
        while True:
            blk = self._in_framer.pull(self.cfg.blocksize)
            if blk is None:
                break
            self._out_framer.push(self._process_engine_block(blk))
        out = self._out_framer.pull(chunk.shape[1] * r)
        # the one-block priming guarantees availability: emitted ≤ r·pushed,
        # buffered = prime + r·bs·floor(pushed/bs) ≥ r·pushed
        assert out is not None, "framer invariant violated"
        return out

    def _process_engine_block(self, block: np.ndarray) -> np.ndarray:
        """Device step + degradation ladder on an engine-rate block."""
        expected = (self.cfg.batch, self.cfg.blocksize)
        if block.shape != expected:
            # pad/trim rung (`stream_process_EQ.py:110-117`)
            fixed = np.zeros(expected, dtype=self._in_dtype)
            b = min(block.shape[0], expected[0])
            t = min(block.shape[1], expected[1])
            fixed[:b, :t] = block[:b, :t]
            block = fixed
        t0 = time.monotonic()
        try:
            with self._swap_lock:
                pipeline, params, state_in = self.pipeline, self.params, self.state
            state, out = pipeline.step(params, state_in, block)
            out_np = np.asarray(jax.block_until_ready(out))
            # int16 output (emit='pcm16') is finite by construction — the
            # isfinite rung only guards the float contract
            if np.issubdtype(out_np.dtype, np.floating) and not np.all(
                    np.isfinite(out_np)):
                raise FloatingPointError("non-finite output")
            with self._swap_lock:
                if self.pipeline is pipeline:  # drop state if rebuilt mid-block
                    self.state = state
            self._last_good.append(out_np)
            busy = time.monotonic() - t0
            self.metrics.record_block(self.cfg.blocksize, busy, self._block_seconds)
            return out_np
        except Exception as e:  # replay / silence rungs
            _rate.warn("proc_err", "Processing error: %s", e)
            self.metrics.underruns += 1
            if self._last_good:
                self.metrics.fallback_replays += 1
                return self._last_good[-1]
            self.metrics.fallback_silence += 1
            return np.zeros(self._out_shape, dtype=self._out_dtype)

    def _scale_out(self, block: np.ndarray, factor: float) -> np.ndarray:
        """Scale an output block in the engine's emit dtype: f32 scales
        directly; int16 PCM scales in f32 and requantizes (round
        half-to-even — the framework's single quantizer semantics)."""
        if self._out_dtype == np.int16:
            return np.clip(np.round(factor * block.astype(np.float64)),
                           -32768, 32767).astype(np.int16)
        return (factor * block).astype(np.float32)

    def underrun_block(self) -> np.ndarray:
        """Output to emit when no processed block is ready: the reference's
        0.8·last + 0.2·silence blend (`stream_process_EQ_GUI.py:476-480`)."""
        self.metrics.underruns += 1
        if self._last_good:
            return self._scale_out(self._last_good[-1], 0.8)
        self.metrics.fallback_silence += 1
        return np.zeros(self._out_shape, dtype=self._out_dtype)

    def waterfall_ring(self) -> np.ndarray:
        """Fetch the scan-carried spectrum ring ([batch, 50, n_bins] dB;
        requires ``waterfall_enabled=True``)."""
        if self.state.wf is None:
            raise ValueError("waterfall_enabled=False: no on-device ring")
        return np.asarray(self.state.wf)

    def profile(self, logdir: str):
        """jax.profiler trace context (SURVEY.md §5.1): wraps a region of
        block processing; view with TensorBoard/xprof.  Usage::

            with engine.profile("/tmp/afp_trace"):
                engine.process_signal(x)
        """
        return jax.profiler.trace(logdir)

    def process_signal(self, signal: np.ndarray, fold="auto") -> np.ndarray:
        """Whole-signal convenience: [batch, T] → [batch, T'] via lax.scan.
        With exact-mode ASRC, `signal` is source-rate: it streams through the
        frontend and every completed engine block is processed in order.

        ``fold`` is forwarded to :meth:`Pipeline.process_signal` — the
        offline time-folded fast path ('auto' folds only when bit-exact vs
        the scan; 'prefer' folds whenever supported, for offline callers
        like the CLI; False keeps the literal scan)."""
        signal = self._coerce_in(signal)
        if signal.ndim == 1:
            # broadcast to the full batch — the same coercion contract as
            # process_block (a [1, T] array would raise in the ASRC
            # frontend and batch-mismatch the non-ASRC path at batch > 1)
            signal = np.broadcast_to(
                signal[None, :], (self.cfg.batch, signal.shape[-1]))
        if self._asrc_frontend is not None:
            # batched offline path: pull every complete engine block at once
            # and run them through ONE lax.scan dispatch (per-block stepping
            # costs a device round-trip each)
            self._asrc_frontend.push(signal)
            L = self.cfg.blocksize
            nblocks = self._asrc_frontend.available() // L
            if nblocks == 0:
                return np.zeros((self.cfg.batch, 0), dtype=self._out_dtype)
            data = self._asrc_frontend.pull(nblocks * L)
            # device transfer OUTSIDE the busy window — host→device copies
            # of GB-class signals are not device busy time
            data = jnp.asarray(np.asarray(data, dtype=np.float32))
            t0 = time.monotonic()
            # same lock discipline as _process_engine_block: snapshot under
            # the swap lock, write state back only if no rebuild intervened
            # (Pipeline.process_signal keeps the contiguous-transfer layout
            # and applies the offline fold when eligible)
            with self._swap_lock:
                pipeline, params, state_in = self.pipeline, self.params, self.state
            state, outs = pipeline.process_signal(params, state_in, data,
                                                  fold=fold)
            out = np.asarray(jax.block_until_ready(outs))
            with self._swap_lock:
                if self.pipeline is pipeline:
                    self.state = state
            busy = time.monotonic() - t0
            n = out.shape[-1]
            self.metrics.record_block(n, busy, n / self.cfg.samplerate)
            return out
        t0 = time.monotonic()
        with self._swap_lock:
            pipeline, params, state_in = self.pipeline, self.params, self.state
        chunk = self._stage_chunk_blocks(signal)
        nb_sig = signal.shape[-1] // pipeline.block
        if chunk is not None and nb_sig > chunk:
            # double-buffered host→device staging: upload
            # chunk k+1 (async device_put) while chunk k computes, so the
            # H2D link and the device overlap instead of serializing.
            # Chunk boundaries sit on block multiples and the state threads
            # through, so the result is exactly the unchunked scan's; the
            # fold runs per chunk (same float32-rounding class vs the scan — with
            # dither on, the noise realization differs per chunking, the
            # documented fold caveat).
            L = pipeline.block
            bounds = [(i * L, min(nb_sig, i + chunk) * L)
                      for i in range(0, nb_sig, chunk)]
            # the trailing partial block is dropped exactly as
            # Pipeline.process_signal itself drops it (it slices to whole
            # blocks) — dispatching it would be a zero-block scan
            dev = jax.device_put(signal[:, bounds[0][0]:bounds[0][1]])
            outs = []
            state = state_in
            for j, (lo, hi) in enumerate(bounds):
                nxt = (jax.device_put(
                    signal[:, bounds[j + 1][0]:bounds[j + 1][1]])
                    if j + 1 < len(bounds) else None)
                state, y = pipeline.process_signal(params, state, dev,
                                                   fold=fold)
                outs.append(y)
                dev = nxt
            out = jnp.concatenate(outs, axis=-1)
        else:
            state, out = pipeline.process_signal(params, state_in, signal,
                                                 fold=fold)
        out = np.asarray(jax.block_until_ready(out))
        with self._swap_lock:
            if self.pipeline is pipeline:
                self.state = state
        busy = time.monotonic() - t0
        n = out.shape[-1]
        self.metrics.record_block(n, busy, n / self.cfg.samplerate)
        return out

    def _stage_chunk_blocks(self, signal) -> Optional[int]:
        """Blocks per staging chunk for the double-buffered upload path, or
        None to stage the whole signal in one piece.

        OPT-IN (``AFP_STAGE_CHUNK_MB=<mb>``; default off): on hosts whose
        copy engine overlaps H2D with compute (PCIe), chunked device_put
        hides the upload behind the previous chunk's dispatch; each chunk
        also adds a dispatch, so the default stages in one piece (not
        measured on the GPU yet)."""
        import os

        mb = float(os.environ.get("AFP_STAGE_CHUNK_MB", "0"))
        if mb <= 0:
            return None
        nbytes = signal.size * signal.dtype.itemsize
        if nbytes <= 2 * mb * 2 ** 20:  # <2 chunks: nothing to overlap
            return None
        row_bytes = signal.shape[0] * self.cfg.blocksize * signal.dtype.itemsize
        return max(1, int(mb * 2 ** 20 / max(row_bytes, 1)))
