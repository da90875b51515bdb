"""Golden tests for AGC (vs a numpy replica of the reference's apply_agc) and
dither statistics."""
import numpy as np
import jax
import pytest

from afp.ops import AGCParams, apply_agc, dither, moving_rms
from afp.ops.agc import smooth_gain_scan

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



def oracle_agc(signal, target_level=0.1, window_size=512, max_gain=10.0,
               attack=0.01, release=0.1):
    """numpy float64 replica of reference/stream_process_AGC.py:43-89
    (1-D in, 1-D out)."""
    attack_samples = int(attack * window_size)
    release_samples = int(release * window_size)
    squared = np.square(signal.astype(np.float64))
    window = np.ones(window_size) / window_size
    rms = np.sqrt(np.convolve(squared, window, mode="same"))
    desired = np.clip(target_level / (rms + 1e-10), 0, max_gain)
    sm = np.zeros_like(desired)
    sm[0] = desired[0]
    for i in range(1, len(desired)):
        if desired[i] > sm[i - 1]:
            a = 1 - np.exp(-1.0 / attack_samples) if attack_samples else 1.0
        else:
            a = 1 - np.exp(-1.0 / release_samples) if release_samples else 1.0
        sm[i] = a * desired[i] + (1 - a) * sm[i - 1]
    sm = np.clip(sm, 0.1, max_gain)
    return signal * sm, sm


@pytest.mark.parametrize("window_size", [512, 256, 64])
def test_agc_matches_reference_oracle(rng, window_size):
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(2048) / 44100)
         * (1 + 0.5 * np.sin(2 * np.pi * 2 * np.arange(2048) / 44100))).astype(np.float32)
    params = AGCParams(target_level=0.1, window_size=window_size)
    ours, _ = apply_agc(x, params)
    gold, _ = oracle_agc(x.astype(np.float64), window_size=window_size)
    np.testing.assert_allclose(np.asarray(ours), gold, rtol=2e-4, atol=2e-5)


def test_agc_batched(rng):
    x = rng.normal(size=(4, 1024)).astype(np.float32) * 0.2
    params = AGCParams(window_size=128)
    ours, last = apply_agc(x, params)
    assert ours.shape == x.shape and last.shape == (4,)
    for i in range(4):
        gold, sm = oracle_agc(x[i].astype(np.float64), window_size=128)
        np.testing.assert_allclose(np.asarray(ours[i]), gold, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(np.asarray(last[i]), sm[-1], rtol=2e-3)


def test_agc_carry_continuity(rng):
    """With the cross-block carry, splitting a signal into blocks matches the
    carried recurrence run over the concatenation."""
    x = rng.normal(size=1024).astype(np.float32) * 0.3
    params = AGCParams(window_size=64)
    # full-signal smoothed gain with carry started at desired[0]
    full_out, _ = apply_agc(x, params)

    # NOTE: RMS uses 'same' zero-padded windows, so exact block equality holds
    # only for the recurrence part; verify the recurrence carry itself:
    from afp.ops.agc import desired_gain

    d = desired_gain(moving_rms(x, 64), params.target_level, params.max_gain)
    g_full = smooth_gain_scan(d, params.a_att, params.a_rel)
    g1 = smooth_gain_scan(d[:512], params.a_att, params.a_rel)
    g2 = smooth_gain_scan(d[512:], params.a_att, params.a_rel, init=g1[-1])
    np.testing.assert_allclose(
        np.concatenate([np.asarray(g1), np.asarray(g2)]), np.asarray(g_full), rtol=1e-5
    )


class TestSmoothGainParallel:
    """smooth_gain_parallel must equal the sequential scan exactly (it is the
    throughput answer to the per-sample recurrence)."""

    def _check(self, d, a_att=0.3935, a_rel=0.0194, init=None, rtol=3e-5):
        from afp.ops.agc import smooth_gain_parallel

        g_seq = np.asarray(smooth_gain_scan(d, a_att, a_rel, init=init))
        g_par = np.asarray(smooth_gain_parallel(d, a_att, a_rel, init=init))
        np.testing.assert_allclose(g_par, g_seq, rtol=rtol, atol=1e-6)

    def test_realistic_rms_desired(self, rng):
        from afp.ops.agc import desired_gain

        x = (rng.normal(size=4096) * 0.2).astype(np.float32)
        x[1000:1500] *= 0.05  # quiet stretch
        x[2500:2600] *= 5.0  # burst
        d = desired_gain(moving_rms(x, 512), 0.1, 10.0)
        self._check(d)

    def test_alternating_extremes(self):
        d = np.tile(np.array([10.0, 0.0], dtype=np.float32), 512)
        self._check(d)

    def test_crossing_oscillation(self):
        # desired hovers around the smoothed gain — branch flips every few
        # samples, the hardest case for branch-consistent iteration
        t = np.arange(2048, dtype=np.float32)
        d = (1.0 + 0.01 * np.sin(2 * np.pi * t / 7) + 0.001 * np.sin(t)).astype(np.float32)
        self._check(d)

    def test_random_walk(self, rng):
        d = np.abs(np.cumsum(rng.normal(size=4096) * 0.05) + 1.0).astype(np.float32)
        self._check(d)

    def test_with_carry_and_batch(self, rng):
        d = np.abs(rng.normal(size=(3, 2048)) * 0.5 + 1.0).astype(np.float32)
        init = np.array([0.5, 1.0, 2.0], dtype=np.float32)
        self._check(d, init=init)

    def test_equal_alphas_degenerate(self, rng):
        d = np.abs(rng.normal(size=1024)).astype(np.float32)
        self._check(d, a_att=0.1, a_rel=0.1)

    def test_instant_attack(self, rng):
        # attack_samples == 0 → α = 1 (instant), matching the reference path
        d = np.abs(rng.normal(size=1024)).astype(np.float32)
        self._check(d, a_att=1.0, a_rel=0.05)


class TestAgcScanPallas:
    """The Triton-route AGC recurrence kernel ≡ the lax.scan recurrence
    (interpret mode here; the engine selects it on the GPU backend)."""

    def _check(self, d, init=None, a_att=0.3935, a_rel=0.0194):
        from afp.ops.pallas.agc_scan import smooth_gain_pallas

        d = np.atleast_2d(d)
        g_seq = np.asarray(smooth_gain_scan(d, a_att, a_rel, init=init))
        g_pl = np.asarray(smooth_gain_pallas(d.T, a_att, a_rel, init=init,
                                             block_b=16, interpret=True)).T
        np.testing.assert_allclose(g_pl, g_seq, rtol=1e-6, atol=1e-7)

    def test_single_stream(self, rng):
        self._check(np.abs(rng.normal(size=96)).astype(np.float32))

    def test_batched_with_carry(self, rng):
        d = np.abs(rng.normal(size=(5, 64)) + 1.0).astype(np.float32)
        init = np.linspace(0.2, 2.0, 5).astype(np.float32)
        self._check(d, init=init)

    def test_batch_padding_regimes(self, rng):
        # batch not a multiple of the 16-stream test tile: padding path
        for B in (1, 3, 17):
            d = np.abs(rng.normal(size=(B, 48)) + 1.0).astype(np.float32)
            self._check(d)

    def test_no_init_restart_semantics(self, rng):
        # g[0] == desired[0] (the reference's per-block restart)
        from afp.ops.pallas.agc_scan import smooth_gain_pallas

        d = np.abs(rng.normal(size=(2, 32)) + 1.0).astype(np.float32)
        g = np.asarray(smooth_gain_pallas(d.T, 0.2, 0.02, block_b=16,
                                          interpret=True)).T
        np.testing.assert_allclose(g[:, 0], d[:, 0])


def test_engine_agc_parallel_mode_matches_exact(rng):
    """Full pipeline with agc_mode='parallel' ≡ agc_mode='exact'."""
    import dataclasses

    from afp.engine import Pipeline, PipelineParams, StreamConfig

    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=2, eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=128, dither_kind="off", downsample_mode="decimate",
        output_clip=0.99,
    )
    sig = (0.05 * rng.normal(size=(2, 512 * 4))).astype(np.float32)
    outs = {}
    for mode in ("exact", "parallel"):
        c = dataclasses.replace(cfg, agc_mode=mode)
        pipe = Pipeline(c)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, out = pipe.process_signal(params, pipe.init_state(), sig)
        outs[mode] = np.asarray(out)
    np.testing.assert_allclose(outs["parallel"], outs["exact"], rtol=1e-4, atol=1e-6)


def test_moving_rms_matches_npconvolve(rng):
    x = rng.normal(size=777).astype(np.float32)
    for w in (512, 511, 64, 1):
        ours = np.asarray(moving_rms(x, w))
        gold = np.sqrt(np.convolve(np.square(x.astype(np.float64)), np.ones(w) / w, "same"))
        np.testing.assert_allclose(ours, gold, rtol=1e-4, atol=1e-5)


def test_dither_stats_and_determinism():
    key = jax.random.PRNGKey(42)
    x = np.zeros(200000, dtype=np.float32)
    lsb = 2 / 2**24
    rp = np.asarray(dither(key, x, 24, "rpdf"))
    tp = np.asarray(dither(key, x, 24, "tpdf"))
    off = np.asarray(dither(key, x, 24, "off"))
    np.testing.assert_array_equal(off, x)
    # amplitude bounds: RPDF ±lsb/2, TPDF ±lsb
    assert np.max(np.abs(rp)) <= lsb / 2 + 1e-12
    assert np.max(np.abs(tp)) <= lsb + 1e-12
    assert np.max(np.abs(tp)) > lsb / 2  # triangular really reaches further
    # determinism: same key → same noise
    rp2 = np.asarray(dither(key, x, 24, "rpdf"))
    np.testing.assert_array_equal(rp, rp2)
    # TPDF variance = 2 × RPDF variance
    assert np.var(tp) == pytest.approx(2 * np.var(rp), rel=0.05)


def test_dither_decorrelated_across_streams():
    key = jax.random.PRNGKey(0)
    x = np.zeros((2, 100000), dtype=np.float32)
    noise = np.asarray(dither(key, x, 24, "tpdf"))
    c = np.corrcoef(noise[0], noise[1])[0, 1]
    assert abs(c) < 0.02


def test_blockwise_agc_close_to_exact(rng):
    from afp.ops.agc import desired_gain, smooth_gain_blockwise

    x = (0.3 * np.sin(2 * np.pi * 3 * np.arange(4096) / 4096)).astype(np.float32) \
        * (0.2 + 0.8 * np.abs(np.sin(2 * np.pi * np.arange(4096) / 4096)))
    params = AGCParams(window_size=512)
    d = desired_gain(moving_rms(x, 512), params.target_level, params.max_gain)
    g_exact = np.asarray(smooth_gain_scan(d, params.a_att, params.a_rel))
    g_fast = np.asarray(smooth_gain_blockwise(d, params.a_att, params.a_rel, chunk=32))
    rel = np.max(np.abs(g_fast - g_exact) / (np.abs(g_exact) + 1e-6))
    assert rel < 0.15  # bounded deviation (τ_release = 51 samples vs chunk 32)


def test_blockwise_agc_exact_on_constant():
    from afp.ops.agc import smooth_gain_blockwise

    d = np.full(1024, 2.5, dtype=np.float32)
    g1 = np.asarray(smooth_gain_scan(d, 0.2, 0.02))
    g2 = np.asarray(smooth_gain_blockwise(d, 0.2, 0.02, chunk=32))
    np.testing.assert_allclose(g1, g2, rtol=1e-5)


def test_engine_agc_fast_mode(rng):
    from afp.engine import Pipeline, PipelineParams, StreamConfig

    cfg = StreamConfig(
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=33,
        batch=2, eq_enabled=False, agc_enabled=True, agc_mode="fast",
        agc_window_size=128, dither_kind="off", downsample_mode="decimate",
        output_clip=0.99,
    )
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = (0.01 * rng.normal(size=(2, 512 * 4))).astype(np.float32)
    _, out = pipe.process_signal(params, pipe.init_state(), sig)
    out = np.asarray(out)
    assert np.all(np.isfinite(out))
    assert np.std(out[:, 1024:]) > np.std(sig) * 2  # AGC boosts quiet input


@pytest.mark.parametrize("w", [512, 511, 64])
def test_engine_mxu_rms_matches_fft_rms(rng, w):
    """The engine's AGC stage (moving RMS, desired gain, recurrence, clips)
    ≡ the `apply_agc` reference on one block, including the even-window
    'same' centering (a 1-sample boxcar shift measured −48 dB once)."""
    import jax.numpy as jnp

    from afp.engine import Pipeline, PipelineParams, StreamConfig
    from afp.ops.agc import AGCParams, apply_agc

    cfg = StreamConfig(
        samplerate=44100, blocksize=1024, upsample_factor=1, numtaps=65,
        batch=2, eq_enabled=False, agc_enabled=True, agc_mode="exact",
        agc_window_size=w, dither_kind="off", downsample_mode="decimate",
        output_clip=0.99,
    ).validate()
    assert cfg.agc_window_size == w
    x = jnp.asarray((rng.normal(size=(2, 1024)) * 0.1).astype(np.float32))
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(p.cfg))
    y_eng, g_eng = p._agc(pp, x, jnp.ones((2,), jnp.float32))
    ref, g_ref = apply_agc(x, AGCParams(window_size=w),
                           carry=jnp.ones((2,), jnp.float32))
    np.testing.assert_allclose(np.asarray(y_eng),
                               np.clip(np.asarray(ref), -0.99, 0.99),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_eng), np.asarray(g_ref),
                               rtol=1e-5)


def test_conv_pair_path_bitexact(rng):
    """The AGC chain's conv consumes the gain-applied block on both conv
    strategies: td_mxu (band-matrix product) and fft agree across carried
    blocks within the ulp-scale bound (≤ −110 dB of the block's peak).
    (The bf16 conv-pair path this once covered is gone.)"""
    import dataclasses

    from afp.engine import Pipeline, PipelineParams, StreamConfig

    cfg = StreamConfig(
        samplerate=44100, blocksize=256, upsample_factor=2, numtaps=33,
        batch=16, eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=64, agc_carry=True, dither_kind="off",
        downsample_mode="decimate", output_clip=0.99, conv_strategy="td_mxu",
    )
    sig = (rng.normal(size=(3, 16, 256)) * 0.1).astype(np.float32)
    outs = {}
    for strategy in ("td_mxu", "fft"):
        p = Pipeline(dataclasses.replace(cfg, conv_strategy=strategy))
        pp = p.device_params(PipelineParams.design(p.cfg))
        st = p.init_state()
        ys = []
        for b in sig:
            st, y = p._step_impl(pp, st, b)
            ys.append(np.asarray(y))
        outs[strategy] = ys
    for a, b in zip(outs["td_mxu"], outs["fft"]):
        assert np.max(np.abs(a - b)) <= np.max(np.abs(b)) * 10 ** (-110 / 20)
