"""Headless exercise of the tkinter GUI handlers.

CI has no display, so a minimal in-memory tkinter stub stands in for the
widget toolkit; the point is to drive every handler the reference GUI has
(`apply_changes`, reset, gain sliders, presets, spectrum toggle, canvas
redraw) through the REAL EqualizerGUI class so signature drift in
EqualizerController breaks loudly.
"""
import sys
import types

import numpy as np
import pytest


class _Var:
    def __init__(self, master=None, value=None):
        self._v = value

    def get(self):
        return self._v

    def set(self, v):
        self._v = v


class _Widget:
    def __init__(self, *a, **k):
        self.master = a[0] if a else k.get("master")
        self.kw = k
        self.children = []

    def grid(self, *a, **k):
        return self

    def pack(self, *a, **k):
        return self

    def configure(self, **k):
        self.kw.update(k)

    def destroy(self):
        pass

    def title(self, *a):
        pass

    def mainloop(self):
        pass

    def protocol(self, *a, **k):
        pass

    def after(self, ms, fn=None):
        # no event loop in the stub: record but never re-invoke (the poll
        # chain is driven by the test, not a scheduler)
        self.kw.setdefault("after_calls", 0)
        self.kw["after_calls"] += 1


def _fake_tk():
    tk = types.ModuleType("tkinter")
    tk.Tk = _Widget
    tk.Toplevel = _Widget
    tk.Scale = _Widget
    tk.StringVar = lambda master=None, value=None: _Var(value=value)
    tk.DoubleVar = lambda master=None, value=None: _Var(value=value)
    tk.BooleanVar = lambda master=None, value=None: _Var(value=value)
    ttk = types.ModuleType("tkinter.ttk")
    for name in ("Label", "LabelFrame", "Entry", "Combobox", "Button",
                 "Frame", "Checkbutton"):
        setattr(ttk, name, _Widget)
    tk.ttk = ttk
    return tk, ttk


class _FakeCanvas:
    draws = 0

    def __init__(self, fig, master=None):
        self.fig = self.figure = fig

    def draw(self):
        _FakeCanvas.draws += 1

    def get_tk_widget(self):
        return _Widget()


@pytest.fixture
def gui(monkeypatch, tmp_path):
    tk, ttk = _fake_tk()
    monkeypatch.setitem(sys.modules, "tkinter", tk)
    monkeypatch.setitem(sys.modules, "tkinter.ttk", ttk)
    tkagg = types.ModuleType("matplotlib.backends.backend_tkagg")
    tkagg.FigureCanvasTkAgg = _FakeCanvas
    monkeypatch.setitem(sys.modules, "matplotlib.backends.backend_tkagg", tkagg)

    from afp.engine import StreamConfig, StreamEngine
    from afp.ui import EqualizerController
    from afp.ui.gui import EqualizerGUI

    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=1, eq_enabled=True, agc_enabled=False, dither_kind="off",
        downsample_mode="decimate", output_clip=None,
    )
    ctl = EqualizerController(StreamEngine(cfg),
                              preset_path=str(tmp_path / "p.json"))
    _FakeCanvas.draws = 0
    return EqualizerGUI(ctl)


def test_gui_builds_and_draws_canvas(gui):
    assert _FakeCanvas.draws >= 1  # response canvas rendered at startup


def test_gui_apply_changes_flows_to_engine(gui):
    gui._fields["cutoff"].set("9000")
    draws_before = _FakeCanvas.draws
    gui.apply_changes()
    assert gui.ctl.engine.cfg.cutoff == 9000.0
    assert _FakeCanvas.draws > draws_before  # canvas redrawn on apply


def test_gui_gain_slider_handler(gui):
    gui._gain_vars[2].set(2.5)
    gui._on_gain(2)
    assert gui.ctl.get_gains()[2] == 2.5


def test_gui_reset_handler(gui):
    gui._gain_vars[0].set(3.0)
    gui._on_gain(0)
    gui.reset()
    assert gui.ctl.get_gains() == [1.0] * 9


def test_gui_preset_handlers(gui):
    gui._preset_var.set("mine")
    gui._save_preset()
    assert "mine" in gui.ctl.preset_names
    gui._gain_vars[0].set(2.0)
    gui._on_gain(0)
    gui._load_preset()
    assert gui.ctl.get_gains()[0] == 1.0
    gui._delete_preset()
    assert "mine" not in gui.ctl.preset_names


def test_gui_spectrum_toggle_and_waterfall(gui):
    gui._spectrum_var.set(True)
    gui._toggle_spectrum()
    assert gui.ctl.show_spectrum is True
    gui.ctl.update_spectrum(np.random.default_rng(0)
                            .normal(size=(1, 512)).astype(np.float32))
    draws_before = _FakeCanvas.draws
    gui.open_waterfall()
    assert _FakeCanvas.draws > draws_before


def test_controller_live_stream_feeds_spectrum():
    """The controller-owned live loop: pumping N blocks
    through the GUI-owned dispatcher updates the spectrum/waterfall and the
    metrics readout — the reference's concurrent GUI+stream shape
    (`stream_process_EQ_GUI.py:486-494`)."""
    import time

    from afp.engine import StreamConfig, StreamEngine
    from afp.ui import EqualizerController

    cfg = StreamConfig(samplerate=44100, blocksize=512, upsample_factor=2,
                       numtaps=65, batch=1, eq_enabled=True,
                       dither_kind="off", downsample_mode="decimate",
                       output_clip=None)
    ctl = EqualizerController(StreamEngine(cfg))
    ctl.show_spectrum = True
    t = np.arange(512) / 44100.0
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)[None]

    ctl.start_stream(source=lambda i: tone, realtime=False)
    assert ctl.streaming
    with pytest.raises(RuntimeError, match="already running"):
        ctl.start_stream()
    deadline = time.time() + 20
    while ctl.engine.metrics.blocks_processed < 8 and time.time() < deadline:
        time.sleep(0.02)
    ctl.stop_stream()
    assert not ctl.streaming

    snap = ctl.metrics_snapshot()
    assert snap["blocks"] >= 8 and snap["xrt_busy"] > 0
    # the periodic feed populated the spectrum + waterfall history
    assert ctl.waterfall_ring is not None
    assert np.any(ctl.waterfall_ring[-1] > -200.0)
    f_peak, _lvl = ctl.spectrum_peak
    assert abs(f_peak - 1000.0) < 200.0  # the 1 kHz tone dominates

    # restartable after stop
    ctl.start_stream(source=lambda i: tone, realtime=False)
    ctl.stop_stream()


def test_gui_toggle_stream_handler(gui):
    """The Start/Stop button drives the controller's live loop and the
    metrics label; stop is idempotent via the close handler."""
    import time

    gui.toggle_stream()  # start (no PortAudio in CI → SimulatedStream)
    assert gui.ctl.streaming
    deadline = time.time() + 20
    while (gui.ctl.engine.metrics.blocks_processed < 2
           and time.time() < deadline):
        time.sleep(0.02)
    gui._poll_metrics()
    assert "blocks" in gui._metrics_label.kw.get("text", "")
    gui.toggle_stream()  # stop
    assert not gui.ctl.streaming
    assert gui._metrics_label.kw["text"] == "stopped"
    gui._on_close()  # idempotent stop + destroy
