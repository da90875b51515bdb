"""AudioStream bridge tests against a mock sounddevice.

No PortAudio in CI: a fake `sd` module records the stream configuration and
lets the test fire the real-time callback by hand, proving the bridge honors
the reference's duplex contract (`reference/stream_process.py:128-136`)
and degrades cleanly when the backend is absent.
"""
import types

import numpy as np
import pytest

from afp.engine import StreamConfig, StreamEngine
from afp.runtime.audio import AudioStream, audio_available


class _FakeStream:
    def __init__(self, **kw):
        self.kw = kw
        self.started = self.stopped = self.closed = False
        self.cpu_load = 0.1

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True

    def close(self):
        self.closed = True


def _fake_sd():
    sd = types.ModuleType("sounddevice")
    sd.Stream = _FakeStream
    sd.query_devices = lambda: []
    return sd


def make_engine(batch=1):
    return StreamEngine(StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=batch, eq_enabled=True, agc_enabled=False, dither_kind="off",
        downsample_mode="decimate", output_clip=None,
    ))


def test_stream_configured_per_reference_contract():
    eng = make_engine()
    bridge = AudioStream(eng, device=(1, 0), sd_module=_fake_sd())
    kw = bridge._stream.kw
    assert kw["latency"] == "high"  # `stream_process.py:134`
    assert kw["device"] == (1, 0)
    assert kw["blocksize"] == 512
    assert kw["samplerate"] == 44100
    assert kw["channels"] == 1


def test_callback_duplex_roundtrip():
    eng = make_engine()
    bridge = AudioStream(eng, sd_module=_fake_sd())
    bridge.start()
    assert bridge._stream.started
    rng = np.random.default_rng(0)
    indata = rng.normal(size=(512, 1)).astype(np.float32) * 0.3
    outdata = np.empty((512, 1), dtype=np.float32)
    # prime: first callbacks return the silence-primed queue
    bridge._callback(indata, outdata, 512, None, None)
    np.testing.assert_array_equal(outdata, 0.0)
    # let the DSP worker drain the submitted block, then fetch real output
    import time

    deadline = time.time() + 5
    while eng.metrics.blocks_processed < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert eng.metrics.blocks_processed >= 1
    bridge.stop()
    assert bridge._stream.stopped


def test_callback_counts_status_flags():
    eng = make_engine()
    bridge = AudioStream(eng, sd_module=_fake_sd())
    indata = np.zeros((512, 1), dtype=np.float32)
    outdata = np.empty((512, 1), dtype=np.float32)
    before = eng.metrics.underruns
    bridge._callback(indata, outdata, 512, None, "input overflow")
    assert eng.metrics.underruns == before + 1


def test_callback_status_flags_map_by_direction():
    """PortAudio CallbackFlags-shaped status: UNDERflows count as engine
    underruns, OVERflows (data loss) count as drops — not everything as
    underruns (review fix)."""
    from types import SimpleNamespace

    eng = make_engine()
    bridge = AudioStream(eng, sd_module=_fake_sd())
    indata = np.zeros((512, 1), dtype=np.float32)
    outdata = np.empty((512, 1), dtype=np.float32)
    u0, d0 = eng.metrics.underruns, eng.metrics.drops

    def flags(**kw):
        base = dict(output_underflow=False, input_underflow=False,
                    input_overflow=False, output_overflow=False)
        base.update(kw)
        ns = SimpleNamespace(**base)
        ns.__bool__ = None  # SimpleNamespace is always truthy anyway
        return ns

    bridge._callback(indata, outdata, 512, None,
                     flags(input_overflow=True))
    assert eng.metrics.drops == d0 + 1 and eng.metrics.underruns == u0
    bridge._callback(indata, outdata, 512, None,
                     flags(output_underflow=True))
    assert eng.metrics.underruns == u0 + 1


def test_upsampled_output_rejected():
    """output_rate='upsampled' cannot ride a one-clock duplex card (the
    output ring would overflow and playback time-stretch) — same hazard
    class as exact-mode ASRC, same explicit rejection."""
    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=1, eq_enabled=False, agc_enabled=False, dither_kind="off",
        output_rate="upsampled", conv_strategy="fft",
    ).validate()
    eng = StreamEngine(cfg)
    with pytest.raises(ValueError, match="output_rate"):
        AudioStream(eng, sd_module=_fake_sd())


def test_multichannel_maps_to_batch():
    eng = make_engine(batch=4)
    bridge = AudioStream(eng, sd_module=_fake_sd())
    assert bridge._stream.kw["channels"] == 4
    indata = np.random.default_rng(1).normal(size=(512, 4)).astype(np.float32)
    outdata = np.empty((512, 4), dtype=np.float32)
    bridge._callback(indata, outdata, 512, None, None)  # no crash, primes


def test_asrc_exact_rejected_compat_allowed():
    """A duplex card runs one clock: exact-mode ASRC (variable block counts)
    is rejected with guidance; 'compat' (the reference's own live-audio
    behavior) opens the stream at the ENGINE rate."""
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, source_samplerate=48000, blocksize=512,
        upsample_factor=1, numtaps=65, batch=1, eq_enabled=False,
        dither_kind="off", downsample_mode="decimate", output_clip=None,
    )
    with pytest.raises(ValueError, match="compat"):
        AudioStream(StreamEngine(StreamConfig(**base)), sd_module=_fake_sd())
    eng = StreamEngine(StreamConfig(asrc_mode="compat", **base))
    bridge = AudioStream(eng, sd_module=_fake_sd())
    assert bridge._stream.kw["samplerate"] == 44100  # one clock: engine rate


def test_callback_arbitrary_frames():
    """Driver-chosen frame counts (frames != blocksize) must stream through
    the callback's residual framers without the pad/trim rung or a ring-size
    ValueError: every input sample is submitted in exact engine blocks, and
    every callback emits exactly `frames` samples (the reference's residual
    callback contract, `stream_process_GUI_Presets.py:617-686`)."""
    import time

    eng = make_engine()
    bridge = AudioStream(eng, sd_module=_fake_sd())
    bridge.dispatcher.start()
    rng = np.random.default_rng(2)
    chunks = [300, 212, 700, 324, 512, 1000, 24, 1024]  # total 4096 = 8·512
    emitted = 0
    for n in chunks:
        indata = (rng.normal(size=(n, 1)) * 0.3).astype(np.float32)
        outdata = np.full((n, 1), np.nan, dtype=np.float32)
        bridge._callback(indata, outdata, n, None, None)
        assert np.all(np.isfinite(outdata)), "callback must fill all frames"
        emitted += n
    # all whole blocks were submitted losslessly (no pad/trim corruption)
    deadline = time.time() + 10
    while eng.metrics.blocks_processed < 8 and time.time() < deadline:
        time.sleep(0.01)
    assert eng.metrics.blocks_processed == 8
    assert bridge._in_framer.available() == 0  # 4096 % 512 == 0: no residual
    assert emitted == 4096
    bridge.dispatcher.stop()


def test_missing_backend_raises_cleanly(monkeypatch):
    import afp.runtime.audio as audio

    monkeypatch.setattr(audio, "_sounddevice", lambda: None)
    assert audio.audio_available() is False
    with pytest.raises(RuntimeError, match="sounddevice"):
        AudioStream(make_engine())


def test_audio_available_is_bool():
    assert isinstance(audio_available(), bool)
