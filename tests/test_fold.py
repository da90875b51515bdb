"""Offline time-folded fast path (`Pipeline.process_signal_folded`): blocks
fold into the BATCH axis and the whole signal runs as ONE batched kernel
call.  With dither off the fold agrees with the streaming scan to float32
rounding (same per-row windows, one larger product); with dither on the
noise realization differs too.  No reference analog — the reference runs offline
files through the same per-block callback loop (`stream_process.py:79-120`).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



@pytest.fixture
def rng():
    return np.random.default_rng(4242)


def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=129,
        batch=1, filter_type="lowpass", cutoff=11000.0, eq_enabled=True,
        agc_enabled=False, downsample_mode="decimate", dither_kind="off",
        output_clip=0.9, conv_strategy="td_mxu",
    )
    base.update(kw)
    return StreamConfig(**base).validate()


CPU_ATOL = 1e-5  # the batched product may block (and round) differently


def assert_close(a, b, int_lsb=1):
    """The fold's batched product may reassociate: allow the ~1e-7-class
    bound (±int_lsb for int16)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.int16:
        d = np.max(np.abs(a.astype(np.int64) - b.astype(np.int64)))
        assert d <= int_lsb, d
    else:
        np.testing.assert_allclose(a, b, atol=CPU_ATOL)


def run_both(cfg, sig, seed=0, fold="prefer", warm_blocks=0):
    """(scan_out, fold_out, scan_state, fold_state) from identical starts.
    `warm_blocks` streams a few blocks first so the carried tail is real."""
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    st_a = pipe.init_state(seed=seed)
    st_b = pipe.init_state(seed=seed)
    if warm_blocks:
        warm = sig[:, : warm_blocks * cfg.blocksize]
        st_a, _ = pipe.process_signal(params, st_a, warm, fold=False)
        st_b, _ = pipe.process_signal(params, st_b, warm, fold=False)
        sig = sig[:, warm_blocks * cfg.blocksize:]
    st_a, y_a = pipe.process_signal(params, st_a, sig, fold=False)
    st_b, y_b = pipe.process_signal(params, st_b, sig, fold=fold)
    return (np.asarray(y_a), np.asarray(y_b), st_a, st_b, pipe)


def assert_state_match(st_a, st_b):
    ta, tb = st_a.conv_tail, st_b.conv_tail
    if isinstance(ta, tuple):
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        # the scan carries n_conv-1 history; the fold does the same
        # slice — widths must agree exactly
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


@pytest.mark.parametrize("batch,nb", [(1, 5), (4, 6), (3, 3)])
def test_fold_bitexact_td(rng, batch, nb):
    cfg = make_cfg(batch=batch)
    sig = (rng.normal(size=(batch, nb * 512)) * 0.4).astype(np.float32)
    y_a, y_b, st_a, st_b, _ = run_both(cfg, sig, warm_blocks=1)
    assert_close(y_a, y_b)
    assert_state_match(st_a, st_b)
    np.testing.assert_array_equal(np.asarray(st_a.key), np.asarray(st_b.key))


def test_fold_bitexact_fft(rng):
    cfg = make_cfg(conv_strategy="fft", batch=2)
    sig = (rng.normal(size=(2, 5 * 512)) * 0.4).astype(np.float32)
    y_a, y_b, st_a, st_b, _ = run_both(cfg, sig, warm_blocks=1)
    # batched vs per-block XLA FFTs: same math per row; allow the backend
    # a few ulp if it specializes the batched plan
    np.testing.assert_allclose(y_a, y_b, atol=1e-6)
    assert_state_match(st_a, st_b)


def test_fold_bitexact_pcm16_ingest(rng):
    cfg = make_cfg(ingest="pcm16", batch=1)
    f = (rng.normal(size=(1, 5 * 512)) * 0.3).astype(np.float32)
    sig = np.clip(np.round(f * 32768.0), -32768, 32767).astype(np.int16)
    y_a, y_b, st_a, st_b, _ = run_both(cfg, sig, warm_blocks=1)
    assert_close(y_a, y_b)
    assert st_b.conv_tail.dtype == jnp.float32  # exact n/32768 history
    assert_state_match(st_a, st_b)


def test_fold_bitexact_emit16(rng):
    cfg = make_cfg(emit="pcm16", batch=1)
    sig = (rng.normal(size=(1, 5 * 512)) * 0.4).astype(np.float32)
    y_a, y_b, st_a, st_b, _ = run_both(cfg, sig, warm_blocks=1)
    assert y_a.dtype == y_b.dtype == np.int16
    assert_close(y_a, y_b)  # a ~1e-7 CPU GEMM diff can flip a rounding edge
    assert_state_match(st_a, st_b)


def test_fold_continuation_matches_scan(rng):
    """Streaming AFTER a fold must continue bit-exactly (the fold's final
    conv tail equals the scan's)."""
    cfg = make_cfg(batch=2)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = (rng.normal(size=(2, 4 * 512)) * 0.4).astype(np.float32)
    nxt = (rng.normal(size=(2, 512)) * 0.4).astype(np.float32)
    st_a, _ = pipe.process_signal(params, pipe.init_state(0), sig, fold=False)
    st_b, _ = pipe.process_signal(params, pipe.init_state(0), sig, fold=True)
    # the carried tails are SLICES of the input — exact on every backend —
    # so the continuation steps are bit-identical
    assert_state_match(st_a, st_b)
    _, y_a = pipe.step(params, st_a, nxt)
    _, y_b = pipe.step(params, st_b, nxt)
    np.testing.assert_array_equal(np.asarray(y_a), np.asarray(y_b))


def test_fold_dither_auto_gates_and_prefer_differs_sub_lsb(rng):
    cfg = make_cfg(dither_kind="tpdf", dither_bits=24, batch=1)
    sig = (rng.normal(size=(1, 4 * 512)) * 0.4).astype(np.float32)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    # auto NEVER changes semantics: with dither on it scans
    st_auto, y_auto = pipe.process_signal(params, pipe.init_state(0), sig)
    st_scan, y_scan = pipe.process_signal(params, pipe.init_state(0), sig,
                                          fold=False)
    np.testing.assert_array_equal(np.asarray(y_auto), np.asarray(y_scan))
    # prefer folds: same filter output, different (deterministic) noise
    _, y_f1 = pipe.process_signal(params, pipe.init_state(0), sig,
                                  fold="prefer")
    _, y_f2 = pipe.process_signal(params, pipe.init_state(0), sig,
                                  fold="prefer")
    np.testing.assert_array_equal(np.asarray(y_f1), np.asarray(y_f2))
    # TPDF amplitude is ±2^(1-bits): filter content identical underneath
    lsb = 2.0 ** (1 - cfg.dither_bits)
    assert np.max(np.abs(np.asarray(y_f1) - np.asarray(y_scan))) <= (
        2 * lsb + CPU_ATOL)


def test_fold_unsupported_raises_and_auto_falls_back(rng):
    sig = (rng.normal(size=(4, 2 * 512)) * 0.3).astype(np.float32)
    for bad in (dict(agc_enabled=True, batch=4),
                dict(waterfall_enabled=True, batch=4),
                dict(output_rate="upsampled", upsample_factor=2, batch=4)):
        cfg = make_cfg(**bad)
        pipe = Pipeline(cfg)
        assert not pipe.supports_fold
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        with pytest.raises(ValueError, match="fold"):
            pipe.process_signal(params, pipe.init_state(0), sig, fold=True)
        # auto silently scans
        st, y = pipe.process_signal(params, pipe.init_state(0), sig)
        assert np.asarray(y).shape[0] == 4


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_fold_per_stream_banks(rng, strategy):
    """Per-stream gain banks fold too: the gain row repeats nb× to match
    the B-major folded rows (both strategies)."""
    from afp.engine.batch import with_per_stream_gains

    cfg = make_cfg(batch=4, conv_strategy=strategy)
    pipe = Pipeline(cfg)
    assert pipe.supports_fold
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n_bands = params.eq_gains.shape[-1]
    gains = np.ones((4, n_bands), np.float32)
    gains[1] *= 0.5
    gains[3, :4] = 2.0
    params_ps = with_per_stream_gains(pipe, params, gains)
    sig = (rng.normal(size=(4, 3 * 512)) * 0.3).astype(np.float32)
    st_a, y_a = pipe.process_signal(params_ps, pipe.init_state(0), sig,
                                    fold=False)
    st_b, y_b = pipe.process_signal(params_ps, pipe.init_state(0), sig,
                                    fold=True)
    assert_close(y_a, y_b)
    assert_state_match(st_a, st_b)


def test_engine_fold_prefer_matches_scan(rng):
    from afp.engine.engine import StreamEngine

    cfg = make_cfg(batch=1)
    sig = (rng.normal(size=(1, 6 * 512)) * 0.4).astype(np.float32)
    e1 = StreamEngine(cfg, seed=0)
    e2 = StreamEngine(cfg, seed=0)
    y_scan = e1.process_signal(sig, fold=False)
    y_fold = e2.process_signal(sig, fold="prefer")
    assert_close(y_scan, y_fold)


def test_sharded_process_signal_fold(rng):
    """ShardedPipeline.process_signal: stream-DP offline processing with
    the per-shard fold — sharded fold ≡ sharded scan (interpret-mode GEMM
    bound) and ≡ the single-device scan, per-shard dither keys off."""
    from afp.parallel import ShardedPipeline, make_mesh

    mesh = make_mesh(8, axis_names=("streams",))
    cfg = make_cfg(batch=8, conv_strategy="td_mxu")
    sig = (rng.normal(size=(8, 4 * 512)) * 0.35).astype(np.float32)

    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    _, gold = pipe.process_signal(params, pipe.init_state(0), sig,
                                  fold=False)

    sp = ShardedPipeline(cfg, mesh)
    sparams = sp.device_params(PipelineParams.design(sp.cfg))
    st_scan, y_scan = sp.process_signal(sparams, sp.init_state(0), sig,
                                        fold=False)
    st_fold, y_fold = sp.process_signal(sparams, sp.init_state(0), sig,
                                        fold="prefer")
    assert_close(np.asarray(y_scan), np.asarray(gold))
    assert_close(np.asarray(y_fold), np.asarray(y_scan))
    # final sharded states agree between fold and scan (tails are slices)
    np.testing.assert_array_equal(np.asarray(st_scan.conv_tail),
                                  np.asarray(st_fold.conv_tail))


def test_fold_per_stream_banks_pcm16(rng):
    """Per-stream banks + pcm16 ingest in fold mode: the ext rows convert
    int16→f32 exactly and the carried f32 tail matches the scan's."""
    from afp.engine.batch import with_per_stream_gains

    cfg = make_cfg(batch=4, ingest="pcm16")
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    gains = np.ones((4, params.eq_gains.shape[-1]), np.float32)
    gains[2] *= 0.25
    params_ps = with_per_stream_gains(pipe, params, gains)
    f = (rng.normal(size=(4, 3 * 512)) * 0.3).astype(np.float32)
    sig = np.clip(np.round(f * 32768.0), -32768, 32767).astype(np.int16)
    st_a, y_a = pipe.process_signal(params_ps, pipe.init_state(0), sig,
                                    fold=False)
    st_b, y_b = pipe.process_signal(params_ps, pipe.init_state(0), sig,
                                    fold=True)
    assert_close(y_a, y_b)
    assert_state_match(st_a, st_b)


def test_fold_auto_excludes_fft():
    """'auto' never changes results, and no strategy's batched product is
    certified bit-exact against the scan: 'auto' scans on both
    strategies, while 'prefer' folds on both."""
    fft_p = Pipeline(make_cfg(conv_strategy="fft", batch=1))
    td_p = Pipeline(make_cfg(conv_strategy="td_mxu", batch=1))
    assert fft_p.supports_fold and td_p.supports_fold
    assert not fft_p._fold_decision("auto")
    assert not td_p._fold_decision("auto")
    assert fft_p._fold_decision("prefer") and td_p._fold_decision("prefer")


def test_fold_invalid_value_raises():
    """Typos like fold='Prefer' must raise, not silently scan."""
    pipe = Pipeline(make_cfg(batch=1))
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = np.zeros((1, 1024), np.float32)
    for bad in ("Prefer", "fold", 1, None):
        with pytest.raises(ValueError, match="fold"):
            pipe.process_signal(params, pipe.init_state(0), sig, fold=bad)


def test_fold_empty_signal_guarded():
    """fold=True/'prefer' with under one block of samples takes the fold
    path's guarded empty return (no zero-block device scan)."""
    pipe = Pipeline(make_cfg(batch=2))
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    for fold in (True, "prefer"):
        st, y = pipe.process_signal(params, pipe.init_state(0),
                                    np.zeros((2, 100), np.float32),
                                    fold=fold)
        assert np.asarray(y).shape == (2, 0)
