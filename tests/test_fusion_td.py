"""td_mxu strategy equivalence: the band-matrix product inside the pipeline
must match the FFT strategy block for block."""
import numpy as np
import pytest

from afp.engine import Pipeline, PipelineParams, StreamConfig


def run_pipe(cfg, sig):
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    _, out = pipe.process_signal(params, pipe.init_state(0), sig)
    return np.asarray(out)


@pytest.mark.parametrize("upf,eq", [(1, False), (2, True), (4, True), (4, False)])
def test_td_mxu_matches_fft(rng, upf, eq):
    base = dict(
        samplerate=44100, blocksize=256, upsample_factor=upf, numtaps=65,
        batch=2, cutoff=11000.0, eq_enabled=eq, agc_enabled=False,
        downsample_mode="decimate", dither_kind="off", output_clip=None,
        fuse_rate_conversion=True,
    )
    sig = (rng.normal(size=(2, 256 * 4)) * 0.3).astype(np.float32)
    fft_out = run_pipe(StreamConfig(conv_strategy="fft", **base), sig)
    td_out = run_pipe(StreamConfig(conv_strategy="td_mxu", **base), sig)
    scale = np.max(np.abs(fft_out)) + 1e-12
    err = np.max(np.abs(fft_out - td_out)) / scale
    assert 20 * np.log10(err + 1e-300) < -100


def test_td_mxu_requires_fusion():
    """The band-matrix product needs the fused single-rate cascade; without
    fusion a td_mxu config runs the literal multirate FFT chain."""
    cfg = StreamConfig(conv_strategy="td_mxu", fuse_rate_conversion=False)
    pipe = Pipeline(cfg)
    assert not pipe.fused and not pipe._use_td
    assert Pipeline(StreamConfig(conv_strategy="td_mxu"))._use_td
