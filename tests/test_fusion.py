"""Equivalence tests for the single-rate fusion fast path: the fused
pipeline (phase-0 polyphase cascade kernel) must reproduce the literal
multirate chain bit-near for every mode combination."""
import numpy as np
import pytest

from afp.engine import Pipeline, PipelineParams, StreamConfig


def run_pipe(cfg, sig):
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    state = pipe.init_state(seed=0)
    _, out = pipe.process_signal(params, state, sig)
    return np.asarray(out)


@pytest.mark.parametrize("mode", ["decimate", "resample"])
@pytest.mark.parametrize("upf", [2, 4])
@pytest.mark.parametrize("eq", [False, True])
def test_fused_equals_literal_chain(rng, mode, upf, eq):
    base = dict(
        samplerate=44100, blocksize=1024, upsample_factor=upf, numtaps=101,
        batch=2, filter_type="lowpass", cutoff=11000.0, eq_enabled=eq,
        agc_enabled=False, downsample_mode=mode, dither_kind="off",
        output_clip=None,
    )
    sig = (rng.normal(size=(2, 1024 * 5)) * 0.3).astype(np.float32)
    fused = run_pipe(StreamConfig(fuse_rate_conversion=True, **base), sig)
    literal = run_pipe(StreamConfig(fuse_rate_conversion=False, **base), sig)
    assert fused.shape == literal.shape
    scale = np.max(np.abs(literal)) + 1e-12
    err_db = 20 * np.log10(np.max(np.abs(fused - literal)) / scale + 1e-300)
    assert err_db < -90, f"fusion mismatch: {err_db:.1f} dB"


def test_fused_gain_linearity(rng):
    """EQ gains must stay runtime-linear on the fused path: scaling all gains
    by c scales the (EQ-only) output by c."""
    cfg = StreamConfig(
        samplerate=44100, blocksize=1024, upsample_factor=4, numtaps=65,
        batch=1, eq_enabled=True, agc_enabled=False, downsample_mode="decimate",
        dither_kind="off", output_clip=None, fuse_rate_conversion=True,
    )
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    sig = (rng.normal(size=(1, 2048)) * 0.3).astype(np.float32)
    _, o1 = pipe.process_signal(params, pipe.init_state(), sig)
    params2 = params._replace(eq_gains=params.eq_gains * 2.0)
    _, o2 = pipe.process_signal(params2, pipe.init_state(), sig)
    np.testing.assert_allclose(np.asarray(o2), 2.0 * np.asarray(o1), atol=1e-5)
