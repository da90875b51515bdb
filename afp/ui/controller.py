"""Headless equalizer controller (L5, SURVEY.md §1).

Mirrors the control surface of the reference's ``EqualizerGUI`` family
(`reference/stream_process_EQ_GUI.py:115-418`,
`stream_process_GUI_Presets.py:130-240`) without tkinter: the control plane
(pending-config edits → validated apply → glitch-free engine swap → response
plot) separated from the data plane (the engine), per SURVEY.md §2.4.

Surface parity:

* ``apply_changes()``         — parse/clamp pending fields, re-design filters,
  atomic parameter swap (`:280-306`), returns whether the swap was
  glitch-free,
* ``reset_to_defaults()``     — the GUI defaults (`:308-344`),
* ``set_gain(i, g)`` / ``get_gains()`` — live EQ sliders (no redesign),
* ``save/load/delete_preset`` — the Presets generation (`Presets.py:153-195`),
* ``plot_response(path)``     — freqz plot with optional live-spectrum
  overlay (`:390-418`),
* ``waterfall(path)``         — 3-D spectrum history (`Waterfall.py:312-339`).

A tkinter front-end can wrap this class; the engine never depends on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..engine import PresetStore, StreamConfig, StreamEngine

__all__ = ["EqualizerController", "DEFAULT_CONFIG"]

#: the reference GUI defaults (`stream_process_EQ_GUI.py:182-191, 308-334`).
DEFAULT_CONFIG = StreamConfig(
    samplerate=44100,
    upsample_factor=2,
    blocksize=2048,
    cutoff=14000.0,
    numtaps=129,
    window_type="hamming",
    filter_type="lowpass",
    min_phase=False,
)


class EqualizerController:
    """Control plane over a :class:`StreamEngine`."""

    def __init__(self, engine: Optional[StreamEngine] = None,
                 preset_path: Optional[str] = None):
        self.engine = engine or StreamEngine(DEFAULT_CONFIG)
        self.pending = self.engine.cfg  # edits accumulate here
        self.presets = PresetStore(preset_path)
        self.show_spectrum = False
        self._last_spectrum: Optional[np.ndarray] = None
        self._spectrum_freqs: Optional[np.ndarray] = None
        #: (freq_hz, level_db) of the latest captured spectrum peak
        self.spectrum_peak: Optional[tuple] = None
        #: rolling [50, n_bins] spectrum history for the waterfall view
        self.waterfall_ring: Optional[np.ndarray] = None
        # live stream ownership (the reference GUIs run the audio stream
        # concurrently with the control loop, `stream_process_EQ_GUI.py
        # :486-494`); populated by start_stream/stop_stream
        self._stream = None
        self._stream_thread = None
        self._audio_stream = None

    # ---------------- pending edits (the tk variables analog) ----------------

    def set_field(self, **kwargs) -> None:
        """Stage config edits (cutoff=..., numtaps=..., window_type=..., …)."""
        if "cutoff_low" in kwargs or "cutoff_high" in kwargs:
            lo = float(kwargs.pop("cutoff_low", self._cutoff_pair()[0]))
            hi = float(kwargs.pop("cutoff_high", self._cutoff_pair()[1]))
            kwargs["cutoff"] = (lo, hi)
        self.pending = dataclasses.replace(self.pending, **kwargs)

    def _cutoff_pair(self):
        c = self.pending.cutoff
        return c if isinstance(c, tuple) else (500.0, 15000.0)

    # ---------------- gains (live, no redesign) ----------------

    def get_gains(self) -> list:
        """Per-band gains.  With per-stream 2-D banks the controller view
        is the cross-stream mean (one slider per band, like the GUI)."""
        g = np.asarray(self.engine.params.eq_gains)
        if g.ndim == 2:
            g = g.mean(axis=0)
        return [float(v) for v in g]

    def set_gain(self, index: int, gain: float) -> None:
        g = np.asarray(self.engine.params.eq_gains)
        if g.ndim == 2:
            # per-stream banks: the GUI slider sets band `index` for EVERY
            # stream (column broadcast), preserving the other bands'
            # per-stream values
            g = g.copy()
            g[:, index] = float(gain)
            self.engine.set_eq_gains(g)
            gains = [float(v) for v in g.mean(axis=0)]
            bands = tuple(
                dataclasses.replace(b, gain=v)
                for b, v in zip(self.pending.eq_bands, gains)
            )
            self.pending = dataclasses.replace(self.pending, eq_bands=bands)
            return
        gains = self.get_gains()
        gains[index] = float(gain)
        self.engine.set_eq_gains(gains)
        bands = tuple(
            dataclasses.replace(b, gain=g)
            for b, g in zip(self.pending.eq_bands, gains)
        )
        self.pending = dataclasses.replace(self.pending, eq_bands=bands)

    def set_gains(self, gains: Sequence[float]) -> None:
        g = np.asarray(list(gains), dtype=np.float32)
        if np.asarray(self.engine.params.eq_gains).ndim == 2 and g.ndim == 1:
            # per-stream banks: broadcast the per-band vector to all streams
            g = np.broadcast_to(
                g, np.asarray(self.engine.params.eq_gains).shape).copy()
        self.engine.set_eq_gains(g)
        bands = tuple(
            dataclasses.replace(b, gain=float(g))
            for b, g in zip(self.pending.eq_bands, gains)
        )
        self.pending = dataclasses.replace(self.pending, eq_bands=bands)

    # ---------------- apply / reset ----------------

    def apply_changes(self) -> bool:
        """Validate + apply the pending config.  True = glitch-free swap."""
        return self.engine.apply_config(self.pending)

    def reset_to_defaults(self) -> bool:
        """GUI reset (`stream_process_EQ_GUI.py:308-344`): unity gains +
        the default filter DESIGN — deployment and static execution fields
        (blocksize, batch, rates, AGC, strategy, ...) stay as deployed, so
        a reset never forces a pipeline rebuild or reframes the stream."""
        sound_fields = ("cutoff", "numtaps", "window_type", "filter_type",
                        "design_method", "eq_enabled", "eq_bands")
        keep = {k: getattr(DEFAULT_CONFIG, k) for k in sound_fields}
        self.pending = dataclasses.replace(self.engine.cfg, **keep)
        return self.apply_changes()

    @property
    def upsampled_rate(self) -> int:
        """The GUI's rate display (`:303-304`)."""
        return self.engine.cfg.upsampled_rate

    # ---------------- presets ----------------

    def save_preset(self, name: str) -> None:
        # snapshot `pending`, which tracks live gain edits the engine config
        # hasn't absorbed (gains are runtime data, not config swaps)
        self.presets.save_preset(name, self.pending)

    def load_preset(self, name: str) -> bool:
        self.pending = self.presets.load_preset(name, self.engine.cfg)
        ok = self.apply_changes()
        self.set_gains([b.gain for b in self.pending.eq_bands])
        return ok

    def delete_preset(self, name: str) -> None:
        self.presets.delete_preset(name)

    @property
    def preset_names(self):
        return self.presets.names

    # ---------------- live stream (the reference's GUI+stream shape) -------

    @property
    def streaming(self) -> bool:
        return (self._stream_thread is not None
                and self._stream_thread.is_alive()) or (
                    self._audio_stream is not None)

    def start_stream(self, source=None, realtime: bool = False,
                     use_audio: bool = False, device=None) -> None:
        """Start the controller-owned live stream, concurrent with the
        control surface — the reference spawns its audio thread alongside
        `root.mainloop()` (`stream_process_EQ_GUI.py:486-494`).

        `use_audio=True` opens a real PortAudio duplex
        :class:`~afp.runtime.audio.AudioStream` (raises if the backend
        is absent); otherwise a :class:`~afp.runtime.dispatcher.
        SimulatedStream` runs in a daemon thread, pulling blocks from
        `source(i) -> [batch, blocksize]` (zeros when None) and feeding
        every output block to :meth:`update_spectrum` — the periodic
        spectrum/waterfall feed.  `realtime=True` paces the simulated loop
        at the true block rate; False runs lockstep (offline/tests).
        """
        import threading

        if self.streaming:
            raise RuntimeError("stream already running; stop_stream() first")
        if use_audio:
            from ..runtime.audio import AudioStream

            self._audio_stream = AudioStream(self.engine, device=device)
            self._audio_stream.start()
            return
        from ..runtime.dispatcher import SimulatedStream

        cfg = self.engine.cfg
        if source is None:
            silence = np.zeros((cfg.batch, cfg.blocksize), dtype=np.float32)
            source = lambda i: silence
        self._stream = SimulatedStream(
            self.engine, source, sink=self.update_spectrum, realtime=realtime)
        self._stream_thread = threading.Thread(
            target=self._stream.run, kwargs={"n_blocks": None},
            daemon=True, name="afp-gui-stream")
        self._stream_thread.start()

    def start_ring_stream(self, server, source, sink=None,
                          spectrum_every: int = 8) -> None:
        """Serve through a :class:`~afp.runtime.serving.RingServer`
        while the GUI observes — the serving-path observability hookup:
        the server's drain-side spectrum tap feeds
        :meth:`update_spectrum`, so the live overlay, peak readout, and
        :meth:`waterfall` all work AT the serving operating point (the
        reference captures spectra inside its hot callback,
        `stream_process_GUI_Waterfall.py:471-478` — here the tap rides
        the drain, stealing no device time).

        `server`: a RingServer over this controller's config class;
        `source`: iterable of input blocks (the server's `stream`
        contract); `sink`: optional callable for every output block
        (default: discard — observation-only); `spectrum_every`: applied
        to the server when its own tap is off.
        """
        import threading

        if self.streaming:
            raise RuntimeError("stream already running; stop_stream() first")
        if not server.spectrum_every:
            server.spectrum_every = int(spectrum_every)
        self.show_spectrum = True
        server.spectrum_sink = self.update_spectrum
        self._ring_stop = threading.Event()
        stop = self._ring_stop

        def gated():
            for blk in source:
                if stop.is_set():
                    return
                yield blk

        def run():
            for out in server.stream(gated()):
                if sink is not None:
                    sink(out)

        self._stream = server
        self._stream_thread = threading.Thread(
            target=run, daemon=True, name="afp-gui-ring-stream")
        self._stream_thread.start()

    def stop_stream(self, timeout: float = 5.0) -> None:
        """Stop the live stream (either backend); idempotent."""
        ring_stop = getattr(self, "_ring_stop", None)
        if ring_stop is not None:
            ring_stop.set()
        if self._audio_stream is not None:
            self._audio_stream.stop()
            self._audio_stream.close()
            self._audio_stream = None
        if self._stream is not None and hasattr(self._stream, "stop"):
            self._stream.stop()  # SimulatedStream; RingServer stops via
            # the gated source (`_ring_stop`)
        if self._stream_thread is not None:
            self._stream_thread.join(timeout=timeout)
            if self._stream_thread.is_alive():
                # the stream thread did not exit in time: KEEP the
                # references (streaming stays True) so a start_stream()
                # cannot race a second thread into the non-thread-safe
                # engine; the caller can retry stop_stream()
                raise TimeoutError(
                    "stream thread did not stop within "
                    f"{timeout}s; retry stop_stream()")
            self._stream_thread = None
        self._stream = None
        self._ring_stop = None

    def metrics_snapshot(self) -> dict:
        """Live counters + xRT for the GUI's metrics readout (the cpu_load
        watchdog analog, `stream_process_EQ_GUI.py:454-457`)."""
        snap = self.engine.metrics.snapshot()
        snap["xrt_busy"] = round(
            self.engine.metrics.xrt_busy(self.engine.cfg.samplerate), 1)
        if self._audio_stream is not None:
            snap["cpu_load"] = self._audio_stream.cpu_load
        return snap

    # ---------------- observation ----------------

    def update_spectrum(self, block: np.ndarray) -> None:
        """Feed an output block for the live-spectrum overlay + peak readout
        (`stream_process_EQ_GUI.py:395-411`)."""
        from ..ops.spectrum import spectrum_db, spectrum_freqs, spectrum_peak

        if self.show_spectrum:
            block = np.asarray(block)
            if block.dtype == np.int16:
                # emit='pcm16' engines hand raw int16 PCM — dequantize
                # (n/32768, the framework convention) so dB levels match
                # the f32 contract's
                block = block.astype(np.float32) / np.float32(32768.0)
            db = np.asarray(spectrum_db(block))
            self._last_spectrum = db
            # host-side waterfall history (depth-50 deque analog,
            # `stream_process_GUI_Waterfall.py:112, 471-478`)
            row = db[0] if db.ndim > 1 else db
            if (self.waterfall_ring is None
                    or self.waterfall_ring.shape[-1] != row.shape[-1]):
                self.waterfall_ring = np.full((50, row.shape[-1]), -200.0,
                                              dtype=np.float32)
            self.waterfall_ring = np.roll(self.waterfall_ring, -1, axis=0)
            self.waterfall_ring[-1] = row
            # frequency axis from the ACTUAL block fed: base-rate output
            # equals the reference's upsampled-analysis axis after its 1/upf
            # scaling (`:400-401`); upsampled-rate output uses the high rate
            cfg = self.engine.cfg
            rate = (cfg.upsampled_rate
                    if self.engine.pipeline.upsampled_out else cfg.samplerate)
            self._spectrum_freqs = spectrum_freqs(block.shape[-1], rate)
            f, lvl = spectrum_peak(db[0] if db.ndim > 1 else db,
                                   self._spectrum_freqs)
            self.spectrum_peak = (float(f), float(lvl))

    def plot_response(self, save_path: Optional[str] = None):
        """The 3-panel response figure of the *current* main filter at the
        upsampled design rate, with the live output spectrum overlaid when
        `show_spectrum` captured one (`:390-418`)."""
        from ..engine.config import PipelineParams
        from ..viz import plot_filter_response

        design = PipelineParams.design(self.engine.cfg)
        spectrum = None
        if self._last_spectrum is not None:
            spectrum = (self._spectrum_freqs, self._last_spectrum)
        return plot_filter_response(
            design.main_taps,
            fs=self.engine.cfg.upsampled_rate,
            filter_type=self.engine.cfg.filter_type,
            save_path=save_path,
            spectrum=spectrum,
        )

    def waterfall(self, ring: Optional[np.ndarray] = None,
                  save_path: Optional[str] = None):
        """3-D spectrum-history surface; defaults to the controller's own
        rolling history (fed by :meth:`update_spectrum`)."""
        from ..ops.spectrum import spectrum_freqs
        from ..viz import plot_waterfall

        if ring is None:
            ring = self.waterfall_ring
        if ring is None:
            raise ValueError(
                "no spectrum history: enable show_spectrum and feed "
                "update_spectrum, or pass a ring explicitly"
            )
        ring = np.asarray(ring)
        if ring.ndim == 3:  # engine's [batch, depth, bins] ring: first stream
            ring = ring[0]
        cfg = self.engine.cfg
        # axis sized from the RING rows (not blocksize — the output block may
        # be upsampled-rate or externally sized)
        n_time = 2 * (ring.shape[-1] - 1)
        if (self._spectrum_freqs is not None
                and len(self._spectrum_freqs) == ring.shape[-1]):
            freqs = self._spectrum_freqs
        else:
            rate = (cfg.upsampled_rate if self.engine.pipeline.upsampled_out
                    else cfg.samplerate)
            freqs = spectrum_freqs(n_time, rate)
        return plot_waterfall(
            ring, freqs, block_seconds=n_time / (freqs[-1] * 2),
            save_path=save_path,
        )
