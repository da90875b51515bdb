"""int16 PCM output (``StreamConfig.emit='pcm16'``): the final output stage
quantizes ``int16(clip(round(y·32768), ±fs))`` in the output epilogue
(`ops.pcm16.quantize_pcm16`) on every path.  The device→host drain
halves.

This is the dither's actual target format: the reference dithers so the
sound card's 16-bit requantization decorrelates
(`reference/stream_process.py:83-90`); emit='pcm16' makes that
quantization explicit and on-device (validate() clamps dither_bits to ≤16
so the dither actually sits at the output quantizer's LSB).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.ops.pcm16 import quantize_pcm16

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



@pytest.fixture
def rng():
    return np.random.default_rng(1357)


def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=4, filter_type="lowpass", cutoff=11000.0, eq_enabled=True,
        agc_enabled=False, downsample_mode="decimate", dither_kind="off",
        output_clip=0.8, conv_strategy="td_mxu", emit="pcm16",
    )
    base.update(kw)
    return StreamConfig(**base).validate()


def blocks_f32(rng, shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- config


def test_emit_validation():
    cfg = make_cfg()
    assert cfg.emit == "pcm16"
    with pytest.raises(ValueError, match="emit"):
        dataclasses.replace(cfg, emit="i24").validate()
    # dither clamps to the output quantizer's depth — deeper dither would
    # under-dither the 16-bit truncation
    c = make_cfg(dither_kind="tpdf", dither_bits=24)
    assert c.dither_bits == 16
    # no clamp when dither is off, or for the f32 contract
    assert make_cfg(dither_kind="off", dither_bits=24).dither_bits == 24
    assert make_cfg(emit="f32", dither_kind="tpdf",
                    dither_bits=24).dither_bits == 24


def test_emit_preset_excluded(tmp_path):
    """emit is deployment-shape: presets must not carry it."""
    from afp.engine.presets import PresetStore

    store = PresetStore(str(tmp_path / "p.json"))
    store.save_preset("p", make_cfg())
    assert store.load_preset("p", make_cfg(emit="f32")).emit == "f32"


def test_quantizer_semantics():
    y = jnp.asarray([0.0, 1.0, -1.0, 0.5, 2.0, -2.0, 1.0 / 32768.0],
                    jnp.float32)
    q = np.asarray(quantize_pcm16(y))
    assert q.dtype == np.int16
    np.testing.assert_array_equal(q, [0, 32767, -32768, 16384, 32767,
                                      -32768, 1])


# ------------------------------------------------------------- pipeline


@pytest.mark.parametrize("strategy,down", [("td_mxu", "decimate"),
                                           ("fft", "resample")])
def test_staged_emit_matches_quantized_f32(rng, strategy, down):
    """emit='pcm16' staged steps ≡ quantize(emit='f32' steps) BITWISE on
    both conv strategies.  Dither on: both sides at 16 bits (the clamp)."""
    cfg16 = make_cfg(conv_strategy=strategy, downsample_mode=down,
                     dither_kind="tpdf", dither_bits=16)
    cfgf = dataclasses.replace(cfg16, emit="f32").validate()
    assert cfgf.dither_bits == 16
    p16, pf = Pipeline(cfg16), Pipeline(cfgf)
    pp16 = p16.device_params(PipelineParams.design(cfg16))
    ppf = pf.device_params(PipelineParams.design(cfgf))
    sig = blocks_f32(rng, (3, 4, 512))
    st16, stf = p16.init_state(seed=5), pf.init_state(seed=5)
    for i in range(3):
        st16, y16 = p16._step_impl(pp16, st16, jnp.asarray(sig[i]))
        stf, yf = pf._step_impl(ppf, stf, jnp.asarray(sig[i]))
        assert y16.dtype == jnp.int16
        np.testing.assert_array_equal(np.asarray(y16),
                                      np.asarray(quantize_pcm16(yf)))


def test_ring_and_mega_emit_match(rng):
    """Serving rings with an int16 output ring equal quantize(f32 ring)
    bitwise (the megakernel form this once covered is gone)."""
    cfg16 = make_cfg()
    cfgf = dataclasses.replace(cfg16, emit="f32").validate()
    p16, pf = Pipeline(cfg16), Pipeline(cfgf)
    assert p16.supports_ring_step
    pp16 = p16.device_params(PipelineParams.design(cfg16))
    ppf = pf.device_params(PipelineParams.design(cfgf))
    K = 3
    ring = jnp.asarray(blocks_f32(rng, (K, 4, 512)))
    out16 = jnp.zeros((K, 4, 512), jnp.int16)
    _, out16 = p16.run_ring(pp16, p16.init_state(seed=2), ring,
                            out16, K)
    outf = jnp.zeros((K, 4, 512), jnp.float32)
    _, outf = pf.run_ring(ppf, pf.init_state(seed=2), ring, outf, K)
    np.testing.assert_array_equal(np.asarray(out16),
                                  np.asarray(quantize_pcm16(outf)))


def test_ring_dtype_contract(rng):
    p16 = Pipeline(make_cfg())
    pp16 = p16.device_params(PipelineParams.design(p16.cfg))
    ring = jnp.zeros((2, 4, 512), jnp.float32)
    with pytest.raises(ValueError, match="int16"):
        p16.run_ring(pp16, p16.init_state(), ring,
                     jnp.zeros((2, 4, 512), jnp.float32), 2)
    pf = Pipeline(make_cfg(emit="f32"))
    ppf = pf.device_params(PipelineParams.design(pf.cfg))
    with pytest.raises(ValueError, match="float32"):
        pf.run_ring(ppf, pf.init_state(), ring,
                    jnp.zeros((2, 4, 512), jnp.int16), 2)


def test_ring_interpret_dither_refused(rng):
    """Dither composes with the int16 quantize on the ring (it runs before
    it in the shared epilogue): the dithered int16 ring equals the staged
    int16 steps."""
    p = Pipeline(make_cfg(dither_kind="tpdf"))
    pp = p.device_params(PipelineParams.design(p.cfg))
    sig = blocks_f32(rng, (2, 4, 512))
    st = p.init_state(seed=6)
    gold = []
    for b in sig:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        gold.append(np.asarray(y))
    _, out = p.run_ring(pp, p.init_state(seed=6), jnp.asarray(sig),
                        jnp.zeros((2, 4, 512), jnp.int16), 2)
    np.testing.assert_array_equal(np.asarray(out), np.stack(gold))


def test_full_int16_io_agc_chain(rng, monkeypatch):
    """The complete production transport: pcm16 IN and pcm16 OUT through
    the AGC (C8) chain — int16 ring to int16 ring, bit-equal to
    quantize(f32-in/f32-out chain fed the same n/32768 floats)."""
    cfg = make_cfg(ingest="pcm16", batch=16, agc_enabled=True,
                   agc_mode="exact", agc_window_size=256, agc_carry=True,
                   output_clip=0.99)
    cfgf = dataclasses.replace(cfg, ingest="f32", emit="f32").validate()
    p, pf = Pipeline(cfg), Pipeline(cfgf)
    assert p._i16_ingest and p._emit16 and p.supports_ring_step
    pp = p.device_params(PipelineParams.design(cfg))
    ppf = pf.device_params(PipelineParams.design(cfgf))
    K = 2
    iring = jnp.asarray(rng.integers(-32768, 32768, size=(K, 16, 512),
                                     dtype=np.int16))
    fring = iring.astype(jnp.float32) / 32768.0
    out16 = jnp.zeros((K, 16, 512), jnp.int16)
    st, out16 = p.run_ring(pp, p.init_state(seed=3), iring, out16, K)
    outf = jnp.zeros((K, 16, 512), jnp.float32)
    stf, outf = pf.run_ring(ppf, pf.init_state(seed=3), fring,
                            outf, K)
    np.testing.assert_array_equal(np.asarray(out16),
                                  np.asarray(quantize_pcm16(outf)))
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(stf.agc_gain))


def test_waterfall_on_quantized_output(rng):
    """emit='pcm16' + waterfall: the spectrum ring captures the quantized
    (listener's) signal — dequantized only to feed the f32 FFT."""
    cfg = make_cfg(waterfall_enabled=True)
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(cfg))
    st = p.init_state(seed=1)
    st, y = p._step_impl(pp, st, jnp.asarray(blocks_f32(rng, (4, 512))))
    assert y.dtype == jnp.int16
    wf = np.asarray(st.wf.ring if hasattr(st.wf, "ring") else st.wf[0])
    assert np.all(np.isfinite(wf[np.isfinite(wf)]))  # ring holds dB rows


# ----------------------------------------------------- engine / serving


def test_engine_emit16_surfaces(rng):
    from afp.engine.engine import StreamEngine

    eng = StreamEngine(make_cfg(), seed=0)
    assert eng._out_dtype == np.int16
    y = eng.process_block(blocks_f32(rng, (4, 512)))
    assert y.dtype == np.int16
    u = eng.underrun_block()
    assert u.dtype == np.int16
    # the 0.8 blend requantizes (round half-to-even), never truncates
    exp = np.clip(np.round(0.8 * y.astype(np.float64)), -32768, 32767
                  ).astype(np.int16)
    np.testing.assert_array_equal(eng.underrun_block(), exp)


def test_dispatcher_emit16(rng):
    from afp.engine.engine import StreamEngine
    from afp.runtime.dispatcher import BlockDispatcher

    eng = StreamEngine(make_cfg(), seed=0)
    d = BlockDispatcher(eng)
    assert d.out_ring.dtype == np.int16
    assert d._last_out.dtype == np.int16
    d.submit(blocks_f32(rng, (4, 512)))
    d.start()
    try:
        out = d.fetch_blocking(timeout=30.0)
    finally:
        d.stop()
    assert out.dtype == np.int16


def test_ring_server_emit16(rng):
    from afp.runtime.serving import RingServer

    p = Pipeline(make_cfg())
    pp = p.device_params(PipelineParams.design(p.cfg))
    blocks = blocks_f32(rng, (4, 4, 512))
    st, ref = p.init_state(seed=0), []
    for b in blocks:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    srv = RingServer(p, params=pp, slots=4, chunk=2, max_inflight=1, seed=0)
    assert srv._out.dtype == jnp.int16
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == 4
    for i in range(4):
        assert outs[i].dtype == np.int16
        np.testing.assert_array_equal(outs[i], ref[i])


def test_controller_spectrum_dequantizes(rng):
    """GUI live-spectrum feed with emit='pcm16': int16 blocks dequantize
    (n/32768) before the FFT so dB levels match the f32 contract."""
    from afp.engine.engine import StreamEngine
    from afp.ui.controller import EqualizerController

    eng = StreamEngine(make_cfg(), seed=0)
    c = EqualizerController(eng)
    c.show_spectrum = True
    y = eng.process_block(blocks_f32(rng, (4, 512)))
    assert y.dtype == np.int16
    c.update_spectrum(y)
    db_i = c._last_spectrum.copy()
    c.update_spectrum(y.astype(np.float32) / np.float32(32768.0))
    np.testing.assert_allclose(db_i, c._last_spectrum, atol=1e-5)
    assert np.max(db_i) < 40.0  # ±1.0-scale dB, not raw-int16 (+90 dB)


def test_cli_emit16_roundtrip(rng, tmp_path):
    """CLI --emit pcm16: the output WAV holds the device's raw int16
    samples (no host float round trip, ×32768 quantizer semantics)."""
    from afp.cli import main
    from afp.utils import read_wav_pcm16, write_wav

    x = (rng.normal(size=(1, 4096)) * 0.3).astype(np.float32)
    src = str(tmp_path / "in.wav")
    dst = str(tmp_path / "out.wav")
    write_wav(src, x, 44100, float_format=True)
    rc = main(["process", src, dst, "--cutoff", "8000", "--numtaps", "65",
               "--blocksize", "512", "--upsample", "1", "--dither", "off",
               "--emit", "pcm16"])
    assert rc == 0
    out, rate = read_wav_pcm16(dst)
    assert rate == 44100 and out.dtype == np.int16
    assert out.shape[1] == 4096 and np.any(out != 0)


def test_engine_emit16_process_frames_keeps_int16(rng):
    """The output framer must carry raw int16 residuals under emit='pcm16':
    arbitrary-sized chunks through process_frames return int16 blocks that
    are sample-identical to blocksize-fed process_block output (the framer
    used to default to float32 and silently coerce the PCM to raw-integer
    floats)."""
    from afp.engine.engine import StreamEngine

    total = 512 * 4
    sig = blocks_f32(rng, (4, total))
    eng_a = StreamEngine(make_cfg(), seed=0)
    out_a, pos = [], 0
    while pos < total:
        n = int(min(rng.integers(1, 700), total - pos))
        y = eng_a.process_frames(sig[:, pos:pos + n])
        assert y.dtype == np.int16, y.dtype
        out_a.append(y)
        pos += n
    out_a = np.concatenate(out_a, axis=-1)

    eng_b = StreamEngine(make_cfg(), seed=0)
    out_b = np.concatenate(
        [eng_b.process_frames(sig[:, i * 512:(i + 1) * 512])
         for i in range(4)], axis=-1)
    assert out_b.dtype == np.int16
    assert out_a.shape == out_b.shape
    np.testing.assert_array_equal(out_a, out_b)

    # content check vs process_block: process_frames primes one output
    # block of zeros (framer latency), then carries the raw int16 PCM
    eng_c = StreamEngine(make_cfg(), seed=0)
    blocks = np.concatenate(
        [eng_c.process_block(sig[:, i * 512:(i + 1) * 512])
         for i in range(4)], axis=-1)
    out_len = out_a.shape[1] // 4
    assert not np.any(out_a[:, :out_len])
    np.testing.assert_array_equal(out_a[:, out_len:],
                                  blocks[:, :-out_len])


def test_engine_emit16_checkpoint_restores_int16_out_framer(rng, tmp_path):
    """Checkpoint restore must rebuild the OUTPUT framer as int16 under
    emit='pcm16' (it used to restore float32, coercing saved residuals)."""
    from afp.engine.checkpoint import load_checkpoint, save_checkpoint
    from afp.engine.engine import StreamEngine

    sig = blocks_f32(rng, (4, 512 * 3 + 137))
    eng = StreamEngine(make_cfg(), seed=3)
    eng.process_frames(sig[:, :700])  # residuals in both framers
    path = str(tmp_path / "ck16.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    assert eng2._out_dtype == np.int16
    assert eng2._out_framer._dtype == np.int16
    rest = sig[:, 700:]
    out1 = eng.process_frames(rest)
    out2 = eng2.process_frames(rest)
    assert out1.dtype == out2.dtype == np.int16
    np.testing.assert_array_equal(out1, out2)
