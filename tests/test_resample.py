"""Golden + streaming-equivalence tests for the polyphase resampler.

Oracle: scipy.signal.resample_poly / upfirdn with the published kernel
(SURVEY.md §7 "soxr-equivalence" resolution).
"""
import numpy as np
import pytest
import scipy.signal as sps

from afp.ops import (
    PolyResampler,
    decimate,
    design_resample_kernel,
    resample_poly,
    upfirdn,
)


def err_db(a, b):
    return 20 * np.log10(np.max(np.abs(np.asarray(a) - b)) / (np.max(np.abs(b)) + 1e-300) + 1e-300)


@pytest.mark.parametrize("up,down", [(2, 1), (4, 1), (3, 2), (1, 4), (160, 147)])
def test_kernel_matches_scipy_recipe(up, down):
    h = design_resample_kernel(up, down)
    import math
    g = math.gcd(up, down)
    u, d = up // g, down // g
    max_rate = max(u, d)
    gold = sps.firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0)) * u
    np.testing.assert_allclose(h, gold, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("up,down", [(4, 1), (2, 1), (3, 2), (1, 2)])
def test_upfirdn_matches_scipy(rng, up, down):
    x = rng.normal(size=1000).astype(np.float32)
    h = design_resample_kernel(up, down)
    ours = np.asarray(upfirdn(h, x, up, down))
    gold = sps.upfirdn(h, x.astype(np.float64), up, down)
    assert ours.shape == gold.shape
    assert err_db(ours, gold) < -90


@pytest.mark.parametrize("up,down", [(4, 1), (2, 1), (1, 4), (3, 2), (160, 147)])
def test_resample_poly_matches_scipy(rng, up, down):
    x = rng.normal(size=4096).astype(np.float32)
    ours = np.asarray(resample_poly(x, up, down))
    gold = sps.resample_poly(x.astype(np.float64), up, down)
    assert ours.shape == gold.shape
    assert err_db(ours, gold) < -90


def test_resample_poly_batched(rng):
    x = rng.normal(size=(5, 2048)).astype(np.float32)
    ours = np.asarray(resample_poly(x, 4, 1))
    for i in range(5):
        gold = sps.resample_poly(x[i].astype(np.float64), 4, 1)
        assert err_db(ours[i], gold) < -90


def test_resample_poly_identity():
    x = np.linspace(-1, 1, 100).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(resample_poly(x, 3, 3)), x)


@pytest.mark.parametrize("up,down,L", [(4, 1, 1024), (2, 1, 512), (3, 2, 1024), (1, 4, 1024)])
def test_streaming_equals_oneshot(rng, up, down, L):
    """Blocked PolyResampler output == full-signal upfirdn (causal), which is
    resample_poly's centered output delayed by state.delay_outputs."""
    nblocks = 6
    sig = rng.normal(size=L * nblocks).astype(np.float32)
    state = PolyResampler.init(up, down, block=L)
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)
    assert streamed.shape[-1] == len(sig) * state.up // state.down

    gold_full = sps.upfirdn(np.asarray(state.h), sig.astype(np.float64), state.up, state.down)
    n = len(streamed)
    assert err_db(streamed, gold_full[:n]) < -85

    # cross-check the delay relation vs resample_poly
    centered = sps.resample_poly(sig.astype(np.float64), state.up, state.down,
                                 window=("kaiser", 5.0))
    d = state.delay_outputs
    m = min(len(centered), n - d)
    assert err_db(streamed[d : d + m], centered[:m]) < -85


def test_streaming_block_size_invariance(rng):
    """Output must not depend on the block partitioning."""
    sig = rng.normal(size=4096).astype(np.float32)
    outs = {}
    for L in (512, 1024, 2048):
        state = PolyResampler.init(4, 1, block=L)
        parts = []
        for i in range(0, 4096, L):
            state, y = state.process(sig[i : i + L])
            parts.append(np.asarray(y))
        outs[L] = np.concatenate(parts)
    # different block sizes use different FFT lengths → fp32 rounding differs
    np.testing.assert_allclose(outs[512], outs[1024], atol=1e-5)
    np.testing.assert_allclose(outs[512], outs[2048], atol=1e-5)


def test_decimate_stride():
    x = np.arange(64, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(decimate(x, 4)), x[::4])


# ---------------- quality tiers (reference soxr VHQ/HQ parity,
# `stream_process.py:69-74`, `stream_process_EQ_GUI.py:424`) ----------------


#: tier → (transition fraction of cutoff, required stopband dB, ripple dB)
_TIER_SPECS = {
    "fast": (0.15, -40.0, -40.0),
    "hq": (0.10, -115.0, -115.0),
    "vhq": (0.08, -135.0, -135.0),
}


@pytest.mark.parametrize("quality", ["fast", "hq", "vhq"])
@pytest.mark.parametrize("up", [2, 4])
def test_quality_tier_stopbands(quality, up):
    """Each published tier kernel must meet its documented anti-image
    stopband and passband-ripple class (measured on a 2^17-point grid)."""
    from afp.ops.resample import quality_kernel

    trans, sb_req, pb_req = _TIER_SPECS[quality]
    h = quality_kernel(up, 1, quality)
    w, H = sps.freqz(h, worN=1 << 17)
    Hn = np.abs(H) / up
    cut = np.pi / up
    stop = 20 * np.log10(Hn[w > cut * (1 + trans)].max())
    ripple = 20 * np.log10(np.abs(Hn[w < cut * (1 - trans)] - 1).max() + 1e-300)
    assert stop < sb_req, f"{quality}: stopband {stop:.1f} dB"
    assert ripple < pb_req, f"{quality}: ripple {ripple:.1f} dB"


def test_quality_fast_is_scipy_default():
    """'fast' IS the scipy resample_poly recipe (oracle compatibility)."""
    from afp.ops.resample import quality_kernel

    np.testing.assert_array_equal(quality_kernel(4, 1, "fast"),
                                  design_resample_kernel(4, 1))


def test_quality_unknown_raises():
    from afp.ops.resample import quality_kernel

    with pytest.raises(ValueError, match="unknown resample quality"):
        quality_kernel(4, 1, "ultra")


@pytest.mark.parametrize("quality", ["hq", "vhq"])
def test_quality_streaming_equals_oneshot(rng, quality):
    """Streaming equivalence holds for the longer tier kernels too."""
    L, nblocks = 1024, 5
    sig = rng.normal(size=L * nblocks).astype(np.float32)
    state = PolyResampler.init(4, 1, block=L, quality=quality)
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)
    gold = sps.upfirdn(np.asarray(state.h), sig.astype(np.float64), 4, 1)
    assert err_db(streamed, gold[: len(streamed)]) < -85


@pytest.mark.parametrize("quality", ["hq", "vhq"])
def test_quality_resample_matches_scipy_recipe(rng, quality):
    """resample_poly(quality=t) ≡ scipy resample_poly with the tier's
    published (half_len_mult, β) window — the tier recipes are open."""
    from afp.ops.resample import QUALITY_TIERS

    mult, beta = QUALITY_TIERS[quality]
    x = rng.normal(size=4096).astype(np.float32)
    ours = np.asarray(resample_poly(x, 4, 1, quality=quality))
    max_rate = 4
    gold_h = sps.firwin(2 * mult * max_rate + 1, 1.0 / max_rate,
                        window=("kaiser", beta)) * 4
    gold = sps.resample_poly(x.astype(np.float64), 4, 1, window=gold_h / 4)
    assert ours.shape == gold.shape
    assert err_db(ours, gold) < -90


def test_quality_tier_in_engine(rng):
    """The engine's fused cascade honors resample_quality: vhq output ≡ the
    float64 causal oracle built from the SAME tier kernel, and differs from
    the fast-tier output (the knob is live)."""
    import dataclasses

    from afp.engine import Pipeline, PipelineParams, StreamConfig
    from afp.ops.resample import streaming_kernel

    sig = (rng.normal(size=(1, 2048)) * 0.3).astype(np.float32)
    outs = {}
    for q in ("fast", "vhq"):
        cfg = StreamConfig(
            samplerate=44100, blocksize=512, upsample_factor=4, numtaps=101,
            batch=1, eq_enabled=False, agc_enabled=False,
            downsample_mode="decimate", dither_kind="off", output_clip=None,
            resample_quality=q,
        )
        pipe = Pipeline(cfg)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, out = pipe.process_signal(params, pipe.init_state(), sig)
        outs[q] = np.asarray(out)[0]

        h_up = streaming_kernel(4, 1, quality=q)
        design = PipelineParams.design(pipe.cfg)
        y = sps.upfirdn(h_up, sig[0].astype(np.float64), 4, 1)[: sig.shape[1] * 4]
        y = np.convolve(y, design.main_taps.astype(np.float64))[: len(y)]
        gold = y[::4]
        assert err_db(outs[q], gold) < -90, q
    assert np.max(np.abs(outs["fast"] - outs["vhq"])) > 1e-6

    # static_key must differ (kernel length is shape-affecting)
    a = StreamConfig(resample_quality="fast").static_key()
    b = StreamConfig(resample_quality="vhq").static_key()
    assert a != b
