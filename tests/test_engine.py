"""StreamEngine tests: degradation ladder, glitch-free reconfig, presets,
checkpoint/resume (SURVEY.md §5.3, §5.4, §5.6)."""
import os

import numpy as np
import pytest

from afp.engine import (

    PresetStore,
    StreamConfig,
    StreamEngine,
    load_checkpoint,
    save_checkpoint,
)

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow


def make_engine(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=2, cutoff=11000.0, eq_enabled=True, agc_enabled=False,
        downsample_mode="decimate", dither_kind="off", output_clip=None,
    )
    base.update(kw)
    return StreamEngine(StreamConfig(**base))


def test_process_block_shapes(rng):
    eng = make_engine()
    out = eng.process_block(rng.normal(size=(2, 512)).astype(np.float32))
    assert out.shape == (2, 512)
    assert eng.metrics.blocks_processed == 1


def test_pad_trim_rung(rng):
    """Mis-sized blocks are padded/trimmed, not errors
    (`stream_process_EQ.py:110-117`)."""
    eng = make_engine()
    out = eng.process_block(rng.normal(size=(2, 300)).astype(np.float32))
    assert out.shape == (2, 512)
    out = eng.process_block(rng.normal(size=(2, 999)).astype(np.float32))
    assert out.shape == (2, 512)
    out = eng.process_block(rng.normal(size=512).astype(np.float32))  # 1-D
    assert out.shape == (2, 512)


def test_replay_and_silence_rungs(rng):
    """Non-finite output triggers last-good replay; with no history,
    silence (`stream_process.py:115-120`)."""
    eng = make_engine()
    bad = np.full((2, 512), np.nan, dtype=np.float32)
    out = eng.process_block(bad)
    np.testing.assert_array_equal(out, np.zeros((2, 512), dtype=np.float32))
    assert eng.metrics.fallback_silence == 1

    good = rng.normal(size=(2, 512)).astype(np.float32)
    ref = eng.process_block(good)
    out = eng.process_block(bad)
    np.testing.assert_array_equal(out, ref)  # last-good replay
    assert eng.metrics.fallback_replays == 1


def test_underrun_blend(rng):
    eng = make_engine()
    ref = eng.process_block(rng.normal(size=(2, 512)).astype(np.float32))
    blend = eng.underrun_block()
    np.testing.assert_allclose(blend, 0.8 * ref, atol=1e-7)


def test_glitch_free_reconfig(rng):
    """Dynamic-only change (cutoff) swaps params without rebuild; static
    change (numtaps) rebuilds."""
    eng = make_engine()
    import dataclasses

    glitch_free = eng.apply_config(dataclasses.replace(eng.cfg, cutoff=8000.0))
    assert glitch_free
    rebuilt = eng.apply_config(dataclasses.replace(eng.cfg, numtaps=129))
    assert not rebuilt
    out = eng.process_block(rng.normal(size=(2, 512)).astype(np.float32))
    assert np.all(np.isfinite(out))


def test_samplerate_only_reconfig_refreshes_derived_state(rng):
    """A live 44.1k→48k change is dynamic (same shapes) but must re-price
    the per-block real-time budget."""
    import dataclasses

    eng = make_engine()
    assert eng._block_seconds == 512 / 44100
    glitch_free = eng.apply_config(dataclasses.replace(eng.cfg, samplerate=48000))
    assert glitch_free  # samplerate is not shape-affecting without ASRC
    assert eng._block_seconds == 512 / 48000
    assert eng.pipeline.cfg.samplerate == 48000
    out = eng.process_block(rng.normal(size=(2, 512)).astype(np.float32))
    assert np.all(np.isfinite(out))


def test_dynamic_agc_param_change_takes_effect(rng):
    """Live AGC target/attack changes must reach the device bank — the bank
    is derived AFTER the pipeline absorbs the new dynamic fields."""
    import dataclasses

    eng = make_engine(agc_enabled=True, agc_target_level=0.1)
    t0 = float(np.asarray(eng.params.agc_target))
    a0 = float(np.asarray(eng.params.agc_a_att))
    assert eng.apply_config(
        dataclasses.replace(eng.cfg, agc_target_level=0.4, agc_attack=0.05)
    )
    assert float(np.asarray(eng.params.agc_target)) == pytest.approx(0.4)
    assert float(np.asarray(eng.params.agc_a_att)) != a0
    assert t0 == pytest.approx(0.1)
    # the louder target must actually change the audio (input loud enough
    # that neither desired gain clips at max_gain)
    x = (rng.normal(size=(2, 512)) * 0.05).astype(np.float32)
    loud = eng.process_block(x)
    eng2 = make_engine(agc_enabled=True, agc_target_level=0.1)
    quiet = eng2.process_block(x)
    assert np.mean(np.abs(loud)) > 1.5 * np.mean(np.abs(quiet))


def test_set_eq_gains_rejects_bad_length():
    eng = make_engine()
    with pytest.raises(ValueError):
        eng.set_eq_gains([1.0, 2.0])


def test_dispatcher_upsampled_output(rng):
    """BlockDispatcher must size the output ring from the ENGINE's output
    shape: output_rate='upsampled' emits blocksize*upf samples per block —
    the input-shaped ring used to kill the worker thread on first push."""
    from afp.runtime import BlockDispatcher

    eng = make_engine(output_rate="upsampled")
    d = BlockDispatcher(eng, queue_depth=4, prime=1)
    d.start()
    try:
        assert d.submit(rng.normal(size=(2, 512)).astype(np.float32))
        out = d.fetch_blocking(timeout=30.0)
        import time as _time
        t0 = _time.perf_counter()
        while not np.any(out):  # drain the silence priming
            assert _time.perf_counter() - t0 < 30.0
            assert out.shape == (2, 1024)
            out = d.fetch_blocking(timeout=30.0)
        assert out.shape == (2, 1024), "output ring must carry upf-long blocks"
    finally:
        d.stop()


def test_process_signal_1d_broadcasts_to_batch(rng):
    """A 1-D signal broadcasts to the full batch (the process_block
    contract) — it used to become batch 1 and raise in the ASRC frontend
    / mismatch the non-ASRC path at batch > 1."""
    sig = (rng.normal(size=4 * 512) * 0.3).astype(np.float32)
    eng = make_engine()
    out = eng.process_signal(sig)
    assert out.shape[0] == 2
    np.testing.assert_array_equal(out[0], out[1])  # identical streams

    aeng = make_engine(source_samplerate=48000, asrc_mode="exact")
    aout = aeng.process_signal(sig)  # used to raise ValueError
    assert aout.shape[0] == 2 and np.all(np.isfinite(aout))


def test_asrc_queue_overflow_drops_newest(rng):
    """A full ASRC output queue must drop the INCOMING frame (reference
    put_nowait semantics) — not silently evict the oldest buffered block."""
    from collections import deque

    eng = make_engine(source_samplerate=48000, asrc_mode="exact")
    eng._asrc_outq = deque(maxlen=2)
    # enough source data for several engine blocks in one drain (the
    # frontend converts in l_dev-sized device steps)
    n_src = 2 * eng._asrc_frontend.l_dev
    sig = (rng.normal(size=(2, n_src)) * 0.3).astype(np.float32)
    eng._asrc_drain(sig)
    assert eng.metrics.drops >= 1
    first = eng._asrc_outq[0].copy()

    # replaying the same ingest on a fresh engine: the FIRST completed
    # block must be what the full queue preserved (oldest kept)
    eng2 = make_engine(source_samplerate=48000, asrc_mode="exact")
    eng2._asrc_drain(sig)
    np.testing.assert_array_equal(first, eng2._asrc_outq[0])


def test_checkpoint_restores_device_arrays(tmp_path, rng):
    """load_checkpoint must install device arrays, not raw numpy — numpy
    params re-upload host→device on EVERY jitted step."""
    import jax

    eng = make_engine()
    eng.process_block(rng.normal(size=(2, 512)).astype(np.float32))
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    for leaf in jax.tree_util.tree_leaves(eng2.params):
        assert isinstance(leaf, jax.Array), type(leaf)
    for leaf in jax.tree_util.tree_leaves(eng2.state):
        assert isinstance(leaf, jax.Array), type(leaf)


def test_checkpoint_roundtrip(tmp_path, rng):
    eng = make_engine()
    sig = rng.normal(size=(2, 512 * 3)).astype(np.float32)
    for i in range(3):
        eng.process_block(sig[:, i * 512 : (i + 1) * 512])
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng)

    eng2 = load_checkpoint(path)
    nxt = rng.normal(size=(2, 512)).astype(np.float32)
    out1 = eng.process_block(nxt)
    out2 = eng2.process_block(nxt)
    np.testing.assert_allclose(out1, out2, atol=1e-7)  # bit-exact resume


def _pair_cfg(**kw):
    base = dict(batch=8, blocksize=512, upsample_factor=4, numtaps=101,
                eq_enabled=False, agc_enabled=False,
                downsample_mode="decimate", conv_strategy="td_mxu",
                dither_kind="off", output_clip=None)
    base.update(kw)
    return StreamConfig(**base)


def test_engine_pair_ingest_matches_f32(rng):
    """StreamEngine with pcm16 ingest (the bf16 pair ingest is gone): same
    output as the f32 engine fed n/32768, with the full ladder available
    on the int16 contract."""
    q = rng.integers(-20000, 20000, (8, 512)).astype(np.int16)
    out_f32 = StreamEngine(_pair_cfg(ingest="f32")).process_block(
        q.astype(np.float32) / np.float32(32768.0))
    eng = StreamEngine(_pair_cfg(ingest="pcm16"))
    out16 = eng.process_block(q)
    np.testing.assert_array_equal(out_f32, out16)
    assert eng.metrics.underruns == 0

    # the ladder operates on the int16 contract: a mis-sized block goes
    # through the pad/trim rung, not a crash
    bad = rng.integers(-100, 100, (3, 100)).astype(np.int16)
    out = eng.process_block(bad)
    assert out.shape == (8, 512) and np.all(np.isfinite(out))

    # a float block into an int16 engine is refused, not quantized
    with pytest.raises(ValueError, match="int16"):
        eng.process_block(np.zeros((8, 512), np.float32))


def test_engine_pair_ingest_checkpoint_and_frames(rng, tmp_path):
    """Pair-mode engine: process_frames and bit-exact checkpoint resume
    (the pair tail serialization) work through the engine surface."""
    eng = StreamEngine(_pair_cfg(batch=8), seed=2)
    sig = (rng.normal(size=(8, 1500)) * 0.3).astype(np.float32)
    out = eng.process_frames(sig[:, :700])
    assert out.shape == (8, 700)
    path = str(tmp_path / "pair_ckpt.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    a = eng.process_frames(sig[:, 700:])
    b = eng2.process_frames(sig[:, 700:])
    np.testing.assert_array_equal(a, b)


def test_process_frames_lossless_vs_blocksize_feed(rng):
    """A stream fed in random-sized chunks is sample-identical to the same
    stream fed in exact engine blocks."""
    import dataclasses

    base = StreamConfig(batch=2, blocksize=512, upsample_factor=2,
                        numtaps=65, eq_enabled=True, agc_enabled=True,
                        downsample_mode="decimate")
    T = 512 * 6
    sig = (rng.normal(size=(2, T)) * 0.2).astype(np.float32)

    def run(chunks):
        eng = StreamEngine(base, seed=3)
        outs, pos = [], 0
        for n in chunks:
            outs.append(eng.process_frames(sig[:, pos : pos + n]))
            pos += n
        assert eng.metrics.underruns == 0  # the ladder never fired
        return np.concatenate(outs, axis=1)

    out_blocks = run([512] * 6)
    out_chunks = run([1, 700, 212, 300, 511, 513, 161, 512, 162])  # Σ = 3072
    assert out_blocks.shape == out_chunks.shape == (2, T)
    np.testing.assert_array_equal(out_blocks, out_chunks)

    # the fixed framing latency: one block of silence, then the processed
    # stream (which equals process_block's output shifted by one block)
    eng = StreamEngine(base, seed=3)
    direct = np.concatenate(
        [eng.process_block(sig[:, i * 512 : (i + 1) * 512]) for i in range(6)],
        axis=1)
    np.testing.assert_array_equal(out_blocks[:, :512], 0.0)
    np.testing.assert_array_equal(out_blocks[:, 512:], direct[:, : T - 512])

    # upsampled output rate: n in → n·upf out
    ucfg = dataclasses.replace(base, output_rate="upsampled",
                               agc_enabled=False)
    eng = StreamEngine(ucfg)
    out = eng.process_frames(sig[:, :300])
    assert out.shape == (2, 600)
    out = eng.process_frames(sig[:, 300:1024])
    assert out.shape == (2, 1448)


def test_process_frames_checkpoint_resume(rng, tmp_path):
    """Framer residuals ride the checkpoint: resume mid-chunk is bit-exact."""
    cfg = StreamConfig(batch=1, blocksize=512, upsample_factor=2, numtaps=65,
                       downsample_mode="decimate")
    sig = (rng.normal(size=(1, 2000)) * 0.2).astype(np.float32)
    eng = StreamEngine(cfg, seed=1)
    out_a = eng.process_frames(sig[:, :777])
    path = str(tmp_path / "framer_ckpt.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    out_b = eng.process_frames(sig[:, 777:])
    out_c = eng2.process_frames(sig[:, 777:])
    np.testing.assert_array_equal(out_b, out_c)
    assert out_a.shape[1] == 777 and out_b.shape[1] == 2000 - 777


def test_preset_store_roundtrip(tmp_path):
    import dataclasses

    store = PresetStore(str(tmp_path / "presets.json"))
    cfg = StreamConfig()
    bands = tuple(dataclasses.replace(b, gain=1.5) for b in cfg.eq_bands)
    cfg = dataclasses.replace(cfg, eq_bands=bands, cutoff=9000.0,
                              samplerate=48000, blocksize=4096)
    store.save_preset("warm", cfg)
    assert "warm" in store

    # reload from disk; deployment fields (samplerate/blocksize) must come
    # from base, not the preset (`stream_process_GUI_Presets.py:163-164`)
    store2 = PresetStore(str(tmp_path / "presets.json"))
    base = StreamConfig()  # 44100 / 2048
    loaded = store2.load_preset("warm", base)
    assert loaded.samplerate == 44100
    assert loaded.blocksize == 2048
    assert loaded.cutoff == 9000.0
    assert all(b.gain == 1.5 for b in loaded.eq_bands)

    store2.delete_preset("warm")
    assert "warm" not in store2


def test_preset_excludes_execution_strategy_fields(tmp_path):
    """A preset saved from a pcm16/fft config must not re-apply those
    deployment/execution fields on load — that would silently change the
    input contract or the strategy."""
    import dataclasses

    store = PresetStore(str(tmp_path / "presets.json"))
    cfg = StreamConfig(ingest="pcm16", conv_strategy="fft",
                       eq_enabled=False, agc_enabled=False,
                       downsample_mode="decimate", output_clip=None)
    store.save_preset("fastpath", cfg)
    saved = store._presets["fastpath"]["settings"]
    assert "ingest" not in saved and "conv_strategy" not in saved

    base = StreamConfig()  # f32 / td_mxu deployment
    loaded = store.load_preset("fastpath", base)
    assert loaded.ingest == "f32"
    assert loaded.conv_strategy == "td_mxu"


def test_preset_store_schema_versioning(tmp_path):
    import json

    from afp.engine.presets import FORMAT_VERSION

    # the store writes a versioned envelope
    path = str(tmp_path / "presets.json")
    store = PresetStore(path)
    store.save_preset("flat", StreamConfig())
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == FORMAT_VERSION
    assert "flat" in raw["presets"]

    # version-0 (pre-versioning bare map) files migrate on read...
    legacy = str(tmp_path / "legacy.json")
    with open(legacy, "w") as f:
        json.dump(raw["presets"], f)
    s0 = PresetStore(legacy)
    assert "flat" in s0
    # ...and are rewritten in the current schema on the next flush
    s0.save_preset("flat2", StreamConfig())
    with open(legacy) as f:
        assert json.load(f)["version"] == FORMAT_VERSION

    # a NEWER writer's file loads best-effort: unknown settings keys are
    # dropped instead of crashing StreamConfig.from_dict
    future = {
        "version": FORMAT_VERSION + 1,
        "presets": {
            "tomorrow": {
                "gains": [1.0] * len(StreamConfig().eq_bands),
                "settings": {"cutoff": 9876.0, "quantum_flux": 42},
            }
        },
    }
    fpath = str(tmp_path / "future.json")
    with open(fpath, "w") as f:
        json.dump(future, f)
    sf = PresetStore(fpath)
    loaded = sf.load_preset("tomorrow", StreamConfig())
    assert loaded.cutoff == 9876.0
    assert not hasattr(loaded, "quantum_flux")


def test_config_validation_clamps():
    cfg = StreamConfig(blocksize=5000, numtaps=9999, samplerate=500,
                       upsample_factor=9, cutoff=1.0).validate()
    assert cfg.blocksize == 8192  # pow2 clamp
    assert cfg.numtaps == 2048
    assert cfg.samplerate == 8000
    assert cfg.upsample_factor == 4
    assert cfg.cutoff == 20.0


def test_config_json_roundtrip():
    cfg = StreamConfig(cutoff=(500.0, 5000.0), filter_type="bandpass")
    cfg2 = StreamConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_concurrent_reconfig_thread_safety(rng):
    """Reconfig from a control thread while a worker processes blocks — the
    filter_lock discipline: no crashes, no corrupt output, every block
    finite."""
    import dataclasses
    import threading

    eng = make_engine(batch=1, blocksize=512)
    sig = rng.normal(size=(200, 1, 512)).astype(np.float32) * 0.3
    errors = []

    def reconfigure():
        try:
            for i in range(30):
                cut = 5000.0 + (i % 10) * 1000.0
                eng.apply_config(dataclasses.replace(eng.cfg, cutoff=cut))
                if i % 10 == 5:  # shape change → full rebuild mid-stream
                    eng.apply_config(dataclasses.replace(eng.cfg, numtaps=97))
                    eng.apply_config(dataclasses.replace(eng.cfg, numtaps=65))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=reconfigure)
    t.start()
    for i in range(200):
        out = eng.process_block(sig[i])
        assert out.shape[1] == 512
        assert np.all(np.isfinite(out))
    t.join()
    assert not errors


def test_profile_context(tmp_path, rng):
    eng = make_engine(batch=1)
    with eng.profile(str(tmp_path / "trace")):
        eng.process_block(rng.normal(size=(1, 512)).astype(np.float32))
    import os

    assert any(os.scandir(str(tmp_path / "trace")))  # trace files written


class TestExactAsrcEngine:
    """asrc_mode='exact': block-exact conversion through the
    full engine for a NON-divisible (rate, block) pair — 48k→44.1k at block
    2048 (reduced down-factor 160 does not divide 2048)."""

    def _make(self):
        return make_engine(
            samplerate=44100, source_samplerate=48000, blocksize=2048,
            upsample_factor=1, numtaps=65, batch=2, eq_enabled=False,
        )

    def test_chunking_invariance(self, rng):
        sig = (rng.normal(size=(2, 48000)) * 0.3).astype(np.float32)
        eng1 = self._make()
        out1 = eng1.process_signal(sig)

        eng2 = self._make()
        outs, i = [], 0
        rng2 = np.random.default_rng(1)
        while i < sig.shape[1]:
            n = int(rng2.integers(100, 4000))
            blk = sig[:, i : i + n]
            i += n
            y = eng2.process_source_block(blk)
            if y is not None:
                outs.append(y)
        out2 = np.concatenate(outs, axis=-1)
        n = min(out1.shape[1], out2.shape[1])
        np.testing.assert_array_equal(out1[:, :n], out2[:, :n])

    def test_matches_zero_phase_oracle(self, rng):
        """Streamed output == (group-delayed) resample_poly → direct engine
        chain: no block-edge artifacts at ANY boundary (the reference's
        stateless conversion fails this, `stream_process_AGC.py:126-129`)."""
        from afp.ops.resample import resample_poly

        sig = (rng.normal(size=(2, 48000)) * 0.3).astype(np.float32)
        eng = self._make()
        streamed = eng.process_signal(sig)
        delay = eng._asrc_frontend.delay_outputs

        ref_in = np.asarray(resample_poly(sig, 147, 160,
                                          quality=eng.cfg.resample_quality))
        eng_direct = make_engine(
            samplerate=44100, blocksize=2048, upsample_factor=1,
            numtaps=65, batch=2, eq_enabled=False,
        )
        gold = eng_direct.process_signal(ref_in)
        n = min(streamed.shape[1] - delay, gold.shape[1])
        # skip the FIR warm-up: the direct chain is zero-primed while the
        # streamed chain's first `delay` samples are the resampler transient
        w = 64  # numtaps - 1
        err = np.max(np.abs(streamed[:, delay + w : delay + n] - gold[:, w:n]))
        scale = np.max(np.abs(gold[:, w:n]))
        assert 20 * np.log10(err / scale + 1e-300) < -90

    def test_process_block_blends_while_buffering(self, rng):
        eng = self._make()
        # tiny first push cannot fill an engine block → underrun blend
        out = eng.process_block((rng.normal(size=(2, 64)) * 0.3).astype(np.float32))
        assert out.shape == (2, 2048)

    def test_checkpoint_roundtrip_with_frontend(self, tmp_path, rng):
        sig = (rng.normal(size=(2, 9000)) * 0.3).astype(np.float32)
        eng = self._make()
        eng.process_source_block(sig)
        path = str(tmp_path / "asrc.npz")
        save_checkpoint(path, eng)
        eng2 = load_checkpoint(path)
        nxt = (rng.normal(size=(2, 5000)) * 0.3).astype(np.float32)
        y1 = eng.process_source_block(nxt)
        y2 = eng2.process_source_block(nxt)
        assert (y1 is None) == (y2 is None)
        if y1 is not None:
            np.testing.assert_array_equal(y1, y2)


def test_exact_asrc_upconversion_bounded(rng):
    """Engine rate > source rate produces MORE
    engine blocks than calls; the frontend buffer must stay bounded and the
    extra blocks must drain through the host queue in order."""
    eng = make_engine(
        samplerate=48000, source_samplerate=44100, blocksize=512,
        upsample_factor=1, numtaps=65, batch=2, eq_enabled=False,
    )
    blk = (rng.normal(size=(2, 512)) * 0.3).astype(np.float32)
    for _ in range(200):
        out = eng.process_block(blk)
        assert out.shape == (2, 512)
    # frontend accumulators bounded (was: ~56 samples/call unbounded growth)
    assert eng._asrc_frontend._out.shape[1] < 512 * 4
    assert len(eng._asrc_outq) <= eng._asrc_outq.maxlen


def test_exact_asrc_never_raises_on_bad_shapes(rng):
    """process_block's never-raises contract holds on the ASRC path too."""
    eng = make_engine(
        samplerate=44100, source_samplerate=48000, blocksize=512,
        upsample_factor=1, numtaps=65, batch=2, eq_enabled=False,
    )
    out = eng.process_block(rng.normal(size=300).astype(np.float32))  # 1-D
    assert out.shape == (2, 512)
    out = eng.process_block(rng.normal(size=(5, 700)).astype(np.float32))
    assert out.shape == (2, 512)


def test_checkpoint_roundtrip_pair_state(tmp_path, rng):
    """Checkpoint round-trips the AGC chain's state (the f32 overlap tail
    and the carried gain) bit-exactly; a checkpoint that carries the old
    bf16 pair tail is refused with a clear error."""
    import json

    eng = make_engine(
        batch=16, blocksize=256, numtaps=33, agc_enabled=True,
        agc_mode="exact", agc_window_size=64, agc_carry=True,
        output_clip=0.99, conv_strategy="td_mxu",
    )
    sig = rng.normal(size=(16, 256 * 2)).astype(np.float32) * 0.1
    for i in range(2):
        eng.process_block(sig[:, i * 256 : (i + 1) * 256])
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    assert eng2.state.conv_tail.dtype == np.float32
    nxt = rng.normal(size=(16, 256)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(eng.process_block(nxt),
                                  eng2.process_block(nxt))

    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["conv_pair"] = True
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    old = str(tmp_path / "old.npz")
    np.savez(old, **arrays)
    with pytest.raises(ValueError, match="pair"):
        load_checkpoint(old)


def test_preset_flush_is_atomic_and_mismatched_gains_logged(tmp_path, rng):
    """_flush must go through a temp file + os.replace (a crash mid-dump
    then can't destroy the store), and a preset whose gains count doesn't
    match its bands loads without silent truncation surprises."""
    import json

    path = str(tmp_path / "p.json")
    store = PresetStore(path)
    eng = make_engine()
    store.save_preset("a", eng.cfg)
    assert not os.path.exists(path + ".tmp")  # temp file replaced away
    with open(path) as f:
        data = json.load(f)  # valid JSON on disk
    # hand-truncate the gains list (older build / hand-edited preset)
    n_bands = len(eng.cfg.eq_bands)
    data["presets"]["a"]["gains"] = [0.25, 0.5]
    with open(path, "w") as f:
        json.dump(data, f)
    store2 = PresetStore(path)
    cfg = store2.load_preset("a", eng.cfg)  # logs a warning, no crash
    # the band STRUCTURE never shrinks to the gain count (review fix —
    # truncation used to silently drop the upper bands): bands without a
    # saved gain keep their own
    assert len(cfg.eq_bands) == n_bands
    assert cfg.eq_bands[0].gain == 0.25 and cfg.eq_bands[1].gain == 0.5
    for b, orig in zip(cfg.eq_bands[2:], eng.cfg.eq_bands[2:]):
        assert b.gain == orig.gain


def test_preset_band_forward_compat(tmp_path):
    """A newer writer's extra per-band fields are dropped with a warning
    instead of crashing EQBand(**b) (review fix)."""
    import json

    path = str(tmp_path / "p.json")
    store = PresetStore(path)
    eng = make_engine()
    store.save_preset("a", eng.cfg)
    with open(path) as f:
        data = json.load(f)
    for b in data["presets"]["a"]["settings"]["eq_bands"]:
        b["q_factor"] = 1.2  # a field this build doesn't have
    with open(path, "w") as f:
        json.dump(data, f)
    cfg = PresetStore(path).load_preset("a", eng.cfg)
    assert len(cfg.eq_bands) == len(eng.cfg.eq_bands)


def test_process_signal_chunked_staging_matches_unchunked(rng, monkeypatch):
    """The double-buffered staging path (signal > 2 chunks → per-chunk
    device_put + dispatch overlap) must produce exactly the
    unchunked scan's output — chunk boundaries sit on block multiples and
    the state threads through."""
    sig = (rng.normal(size=(2, 512 * 7 + 100)) * 0.3).astype(np.float32)
    eng = make_engine()
    gold = eng.process_signal(sig, fold=False)
    # force ~1-block chunks (row_bytes = 2·512·4 B; 0.003 MB ≈ 1.5 blocks)
    monkeypatch.setenv("AFP_STAGE_CHUNK_MB", "0.003")
    eng2 = make_engine()
    assert eng2._stage_chunk_blocks(sig) is not None
    out = eng2.process_signal(sig, fold=False)
    np.testing.assert_array_equal(out, gold)
    # fold='prefer' through the chunked path stays in the fold class
    eng3 = make_engine()
    f = eng3.process_signal(sig, fold="prefer")
    np.testing.assert_allclose(f, gold, atol=1e-5)


def test_chunked_staging_short_signal_no_crash(rng, monkeypatch):
    """With chunking opted in, a signal shorter than one block
    (nb == 0) used to dereference bounds[0] of an empty list — it must fall
    through to the unchunked path and return the same empty result."""
    monkeypatch.setenv("AFP_STAGE_CHUNK_MB", "0.001")
    eng = make_engine()
    out = eng.process_signal(
        (rng.normal(size=(2, 300)) * 0.3).astype(np.float32), fold=False)
    assert out.shape == (2, 0)
