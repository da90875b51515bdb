"""Controller (L5) and visualization (L4) tests."""
import numpy as np
import pytest

from afp.engine import StreamConfig, StreamEngine
from afp.ops.spectrum import (
    WATERFALL_DEPTH,
    spectrum_db,
    spectrum_freqs,
    spectrum_peak,
    waterfall_init,
    waterfall_push,
)
from afp.ui import EqualizerController


@pytest.fixture
def ctl(tmp_path):
    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=1, eq_enabled=True, agc_enabled=False, dither_kind="off",
        downsample_mode="decimate", output_clip=None,
    )
    return EqualizerController(StreamEngine(cfg),
                               preset_path=str(tmp_path / "p.json"))


def test_gain_surface(ctl):
    assert ctl.get_gains() == [1.0] * 9
    ctl.set_gain(3, 2.5)
    assert ctl.get_gains()[3] == 2.5
    ctl.set_gains([0.5] * 9)
    assert ctl.get_gains() == [0.5] * 9


def test_apply_changes_glitch_free(ctl):
    ctl.set_field(cutoff=9000.0)
    assert ctl.apply_changes()  # dynamic-only → glitch-free
    assert ctl.engine.cfg.cutoff == 9000.0
    ctl.set_field(numtaps=129)
    assert not ctl.apply_changes()  # shape change → rebuild


def test_bandpass_cutoff_pair(ctl):
    ctl.set_field(filter_type="bandpass", cutoff_low=400.0, cutoff_high=8000.0)
    ctl.apply_changes()
    assert ctl.engine.cfg.cutoff == (400.0, 8000.0)


def test_reset_to_defaults(ctl):
    """Reset restores unity gains + the default filter DESIGN, but never
    touches deployment/static execution fields (blocksize, batch, rates) —
    a GUI reset must not force a pipeline rebuild or reframe the stream."""
    before = ctl.engine.cfg
    ctl.set_gains([2.0] * 9)
    ctl.set_field(cutoff=5000.0)
    ctl.apply_changes()
    ctl.reset_to_defaults()
    cfg = ctl.engine.cfg
    assert cfg.cutoff == 14000.0 and cfg.numtaps == 129
    assert all(abs(b.gain - 1.0) < 1e-6 for b in cfg.eq_bands)
    # deployment shape untouched
    assert cfg.blocksize == before.blocksize
    assert cfg.upsample_factor == before.upsample_factor
    assert cfg.batch == before.batch


def test_presets_via_controller(ctl):
    ctl.set_gains([1.5] * 9)
    ctl.save_preset("loud")
    ctl.set_gains([1.0] * 9)
    assert ctl.load_preset("loud")
    assert ctl.get_gains() == [1.5] * 9
    ctl.delete_preset("loud")
    assert "loud" not in ctl.preset_names


def test_plot_response_renders(ctl, tmp_path):
    path = str(tmp_path / "resp.png")
    fig = ctl.plot_response(save_path=path)
    assert fig is not None
    import os

    assert os.path.getsize(path) > 1000


def test_spectrum_ops(rng):
    fs, T = 44100, 2048
    t = np.arange(T) / fs
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    db = np.asarray(spectrum_db(x))
    freqs = spectrum_freqs(T, fs)
    pf, pl = spectrum_peak(db, freqs)
    assert abs(float(pf) - 1000) < fs / T * 2  # peak at ~1 kHz
    ring = waterfall_init(len(freqs))
    assert ring.shape == (WATERFALL_DEPTH, len(freqs))
    ring = waterfall_push(ring, db)
    np.testing.assert_array_equal(np.asarray(ring[-1]), db)
    ring2 = waterfall_push(ring, db * 0 - 100)
    np.testing.assert_array_equal(np.asarray(ring2[-2]), db)


def test_waterfall_renders(ctl, tmp_path, rng):
    from afp.viz import plot_waterfall

    ring = rng.normal(size=(WATERFALL_DEPTH, 257)).astype(np.float32) * 10 - 60
    freqs = spectrum_freqs(512, 44100)
    path = str(tmp_path / "wf.png")
    fig = plot_waterfall(ring, freqs, save_path=path)
    assert fig is not None
    import os

    assert os.path.getsize(path) > 1000


def test_device_listing():
    from afp.runtime import format_devices, list_devices

    devs = list_devices()
    assert len(devs) >= 1
    assert "index" in devs[0]
    assert isinstance(format_devices(), str)


def test_wav_roundtrip(tmp_path, rng):
    from afp.utils import read_wav, write_wav

    x = (0.5 * rng.standard_normal((2, 4410))).astype(np.float32).clip(-1, 1)
    for width, tol in [(2, 1e-4), (3, 1e-6), (4, 1e-7)]:
        p = str(tmp_path / f"t{width}.wav")
        write_wav(p, x, 44100, width=width)
        y, rate = read_wav(p)
        assert rate == 44100 and y.shape == x.shape
        np.testing.assert_allclose(y, x, atol=tol)


def test_gui_import_gated():
    from afp.ui.gui import gui_available

    assert isinstance(gui_available(), bool)  # no display in CI → False is fine


def test_wav_ieee_float_roundtrip(tmp_path, rng):
    from afp.utils import read_wav, write_wav

    x = (0.5 * rng.standard_normal((2, 4410))).astype(np.float32)
    p = str(tmp_path / "f32.wav")
    write_wav(p, x, 48000, float_format=True)
    y, rate = read_wav(p)
    assert rate == 48000
    np.testing.assert_array_equal(y, x)  # float path is lossless


def test_spectrum_overlay_lands_in_figure(ctl, tmp_path):
    """the captured output spectrum must actually be rendered
    on the response plot, with the peak annotated."""
    ctl.show_spectrum = True
    t = np.arange(512) / 44100
    block = (0.5 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)[None, :]
    ctl.update_spectrum(block)
    assert ctl.spectrum_peak is not None
    assert abs(ctl.spectrum_peak[0] - 2000) < 44100 / 512 * 2
    assert ctl.waterfall_ring is not None and ctl.waterfall_ring.shape[0] == 50

    fig = ctl.plot_response(save_path=str(tmp_path / "overlay.png"))
    ax_mag = fig.axes[0]
    labels = [ln.get_label() for ln in ax_mag.get_lines()]
    assert "Output spectrum" in labels
    texts = [t.get_text() for t in ax_mag.texts]
    assert any(t.startswith("Peak:") for t in texts)
    # without a captured spectrum there is no overlay
    ctl2_lines = len(ax_mag.get_lines())
    ctl._last_spectrum = None
    fig2 = ctl.plot_response()
    assert len(fig2.axes[0].get_lines()) < ctl2_lines


def test_controller_waterfall_from_own_history(ctl, tmp_path):
    ctl.show_spectrum = True
    rng = np.random.default_rng(0)
    for _ in range(5):
        ctl.update_spectrum(rng.normal(size=(1, 512)).astype(np.float32) * 0.1)
    path = str(tmp_path / "wf2.png")
    fig = ctl.waterfall(save_path=path)
    assert fig is not None
    import os

    assert os.path.getsize(path) > 1000


def test_controller_waterfall_requires_history(ctl):
    with pytest.raises(ValueError):
        ctl.waterfall()


def test_engine_scan_carried_waterfall(rng):
    """waterfall_enabled=True: the depth-50 spectrum ring rides the device
    scan (no host contact per block) and shows the tone."""
    from afp.engine import StreamConfig, StreamEngine
    from afp.ops.spectrum import spectrum_freqs

    eng = StreamEngine(StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
        batch=2, eq_enabled=False, agc_enabled=False, dither_kind="off",
        downsample_mode="decimate", output_clip=None, waterfall_enabled=True,
        cutoff=11000.0,
    ))
    t = np.arange(512 * 6) / 44100
    sig = np.stack([
        0.5 * np.sin(2 * np.pi * 1000 * t),
        0.5 * np.sin(2 * np.pi * 5000 * t),
    ]).astype(np.float32)
    eng.process_signal(sig)
    ring = eng.waterfall_ring()
    assert ring.shape == (2, 50, 257)
    freqs = spectrum_freqs(512, 44100)
    # newest rows carry the per-stream tones; oldest rows still primed
    assert abs(freqs[np.argmax(ring[0, -1])] - 1000) < 200
    assert abs(freqs[np.argmax(ring[1, -1])] - 5000) < 200
    assert np.all(ring[0, 0] == -200.0)  # only 6 blocks pushed

    eng2 = StreamEngine(StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
        batch=2, eq_enabled=False, agc_enabled=False, dither_kind="off",
        downsample_mode="decimate", output_clip=None, cutoff=11000.0,
    ))
    with pytest.raises(ValueError):
        eng2.waterfall_ring()


def test_controller_per_stream_gain_banks(tmp_path):
    """With per-stream 2-D gain banks the controller view is the
    cross-stream mean; a slider write broadcasts its band to every stream
    and preserves the other bands' per-stream values (used to TypeError)."""
    import jax.numpy as jnp

    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
        batch=2, eq_enabled=True, dither_kind="off",
        downsample_mode="decimate", output_clip=None,
    )
    eng = StreamEngine(cfg)
    n = len(cfg.eq_bands)
    bank = np.tile(np.linspace(0.5, 1.5, n, dtype=np.float32), (2, 1))
    bank[1] *= 2.0
    eng.params = eng.params._replace(eq_gains=jnp.asarray(bank))
    ctl = EqualizerController(eng, preset_path=str(tmp_path / "p.json"))
    got = ctl.get_gains()
    np.testing.assert_allclose(got, bank.mean(axis=0), rtol=1e-6)
    ctl.set_gain(2, 3.0)
    g = np.asarray(eng.params.eq_gains)
    assert g.shape == (2, n)
    np.testing.assert_allclose(g[:, 2], 3.0)
    np.testing.assert_allclose(g[0, 3], bank[0, 3])  # others preserved
    ctl.set_gains([1.0] * n)  # 1-D broadcast onto the 2-D bank
    np.testing.assert_allclose(np.asarray(eng.params.eq_gains), 1.0)
