"""Golden-waveform integration tests: the fused device pipeline vs a
numpy/scipy oracle replicating the reference chain semantics
(SURVEY.md §4 item 2)."""
import numpy as np
import pytest
import scipy.signal as sps

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.ops.resample import PolyResampler, design_resample_kernel

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



def err_db(a, b):
    return 20 * np.log10(np.max(np.abs(np.asarray(a) - b)) / (np.max(np.abs(b)) + 1e-300) + 1e-300)


def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=1024, upsample_factor=4, numtaps=129,
        batch=2, filter_type="lowpass", cutoff=11000.0, window_type="hamming",
        eq_enabled=True, agc_enabled=False, downsample_mode="decimate",
        dither_kind="off", output_clip=None,
    )
    base.update(kw)
    return StreamConfig(**base)


def oracle_chain(x, cfg, params):
    """Full-signal float64 oracle of the causal streamed pipeline:
    upsample (causal upfirdn) → fused EQ+main conv (zero-primed) → decimate."""
    upf = cfg.upsample_factor
    T = len(x)
    if upf > 1:
        st = PolyResampler.init(upf, 1, block=cfg.blocksize,
                                quality=cfg.resample_quality)
        h_up = np.asarray(st.h, dtype=np.float64)
        y = sps.upfirdn(h_up, x.astype(np.float64), upf, 1)[: T * upf]
    else:
        y = x.astype(np.float64)
    h_eq = np.tensordot(params.eq_gains.astype(np.float64), params.eq_taps.astype(np.float64), 1)
    h_fused = np.convolve(h_eq, params.main_taps.astype(np.float64))
    y = np.convolve(y, h_fused)[: len(y)]
    if upf > 1:
        y = y[::upf]
    return y


@pytest.mark.parametrize("upf", [1, 2, 4])
def test_pipeline_matches_oracle(rng, upf):
    cfg = make_cfg(upsample_factor=upf)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    state = pipe.init_state(seed=0)

    T = cfg.blocksize * 6
    sig = rng.normal(size=(cfg.batch, T)).astype(np.float32) * 0.3
    state, out = pipe.process_signal(params, state, sig)
    out = np.asarray(out)
    assert out.shape == (cfg.batch, T)
    for b in range(cfg.batch):
        gold = oracle_chain(sig[b], pipe.cfg, design)
        assert err_db(out[b], gold) < -90


def test_pipeline_matches_oracle_default_tier(rng):
    """One oracle pass at the SHIPPED default tier — every other suite pins
    'fast' for CPU runtime (the tiers' own stopbands are pinned in
    test_resample and gated in bench.py's chain_imaging_report); this
    keeps the default config covered end-to-end against the float64
    oracle."""
    default_q = StreamConfig().resample_quality
    assert default_q != "fast", "the shipped default must beat −90 dB imaging"
    cfg = make_cfg(upsample_factor=2, resample_quality=default_q)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    sig = rng.normal(size=(cfg.batch, cfg.blocksize * 3)).astype(np.float32) * 0.3
    _, out = pipe.process_signal(params, pipe.init_state(seed=0), sig)
    out = np.asarray(out)
    for b in range(cfg.batch):
        gold = oracle_chain(sig[b], pipe.cfg, design)
        assert err_db(out[b], gold) < -90


def test_pipeline_step_equals_run(rng):
    cfg = make_cfg()
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = rng.normal(size=(cfg.batch, cfg.blocksize * 4)).astype(np.float32)

    st1 = pipe.init_state(seed=0)
    outs = []
    for i in range(4):
        st1, y = pipe.step(params, st1, sig[:, i * cfg.blocksize : (i + 1) * cfg.blocksize])
        outs.append(np.asarray(y))
    stepped = np.concatenate(outs, axis=-1)

    st2 = pipe.init_state(seed=0)
    _, scanned = pipe.process_signal(params, st2, sig)
    np.testing.assert_allclose(stepped, np.asarray(scanned), atol=1e-6)


def test_eq_gain_change_no_recompile(rng):
    """Gain updates are runtime data — the jit cache must not grow."""
    cfg = make_cfg()
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    state = pipe.init_state()
    block = rng.normal(size=(cfg.batch, cfg.blocksize)).astype(np.float32)
    state, _ = pipe.step(params, state, block)
    n0 = pipe._step._cache_size()
    import jax.numpy as jnp

    g = np.linspace(0.5, 2.0, len(cfg.eq_bands)).astype(np.float32)
    params2 = params._replace(eq_gains=jnp.asarray(g))
    state, _ = pipe.step(params2, state, block)
    assert pipe._step._cache_size() == n0


def test_eq_gains_affect_output(rng):
    cfg = make_cfg(upsample_factor=1)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    block = rng.normal(size=(cfg.batch, cfg.blocksize)).astype(np.float32)
    _, y1 = pipe.step(params, pipe.init_state(), block)
    params2 = params._replace(eq_gains=params.eq_gains * 2.0)
    _, y2 = pipe.step(params2, pipe.init_state(), block)
    assert not np.allclose(np.asarray(y1), np.asarray(y2))


def test_agc_pipeline_runs(rng):
    cfg = make_cfg(agc_enabled=True, upsample_factor=2, output_clip=0.99,
                   agc_window_size=256)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    state = pipe.init_state()
    sig = (rng.normal(size=(cfg.batch, cfg.blocksize * 3)) * 0.01).astype(np.float32)
    state, out = pipe.process_signal(params, state, sig)
    out = np.asarray(out)
    assert np.all(np.isfinite(out))
    assert np.max(np.abs(out)) <= 0.99 + 1e-6
    # AGC should have amplified the quiet signal
    assert np.std(out[:, cfg.blocksize :]) > np.std(sig) * 2


def test_dither_pipeline(rng):
    cfg = make_cfg(dither_kind="tpdf", upsample_factor=1, eq_enabled=False)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = np.zeros((cfg.batch, cfg.blocksize * 2), dtype=np.float32)
    _, out = pipe.process_signal(params, pipe.init_state(seed=7), sig)
    out = np.asarray(out)
    lsb = 2 / 2**24
    assert 0 < np.max(np.abs(out)) <= lsb
    # deterministic under the same seed
    _, out2 = pipe.process_signal(params, pipe.init_state(seed=7), sig)
    np.testing.assert_array_equal(out, np.asarray(out2))


def test_asrc_pipeline(rng):
    cfg = make_cfg(source_samplerate=48000, upsample_factor=1,
                   eq_enabled=False, asrc_mode="compat")
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = rng.normal(size=(cfg.batch, cfg.blocksize * 2)).astype(np.float32)
    _, out = pipe.process_signal(params, pipe.init_state(), sig)
    assert np.asarray(out).shape == sig.shape  # pad/trim-to-blocksize compat
    assert np.all(np.isfinite(np.asarray(out)))


def test_upsampled_rate_output(rng):
    """output_rate='upsampled' emits blocksize*upf samples at the high rate,
    equal to the literal chain's pre-decimation stream."""
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=1024, upsample_factor=4, numtaps=101,
        batch=1, cutoff=11000.0, eq_enabled=False, agc_enabled=False,
        dither_kind="off", output_clip=None,
    )
    hi = Pipeline(StreamConfig(output_rate="upsampled",
                               downsample_mode="decimate", **base))
    params = hi.device_params(PipelineParams.design(hi.cfg))
    sig = (rng.normal(size=(1, 1024 * 3)) * 0.3).astype(np.float32)
    _, out_hi = hi.process_signal(params, hi.init_state(), sig)
    out_hi = np.asarray(out_hi)
    assert out_hi.shape == (1, 1024 * 3 * 4)

    # decimating the high-rate output must equal the base-rate literal chain
    lo = Pipeline(StreamConfig(output_rate="base", downsample_mode="decimate",
                               fuse_rate_conversion=False, **base))
    lparams = lo.device_params(PipelineParams.design(lo.cfg))
    _, out_lo = lo.process_signal(lparams, lo.init_state(), sig)
    np.testing.assert_allclose(out_hi[:, ::4], np.asarray(out_lo), atol=1e-6)


def test_fused_output_clip_matches_staged(rng):
    """cfg.output_clip through td_mxu must be bit-exact against clipping
    an unclipped run — no double clip, no skipped clip."""
    import dataclasses

    base = make_cfg(
        blocksize=512, upsample_factor=1, numtaps=129, batch=4,
        eq_enabled=False, conv_strategy="td_mxu", output_clip=0.2,
    )
    sig = (rng.normal(size=(4, 512 * 4)) * 0.6).astype(np.float32)

    def run(cfg):
        pipe = Pipeline(cfg)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, out = pipe.process_signal(params, pipe.init_state(), sig)
        return np.asarray(out)

    clipped = run(base)
    unclipped = run(dataclasses.replace(base, output_clip=None))
    assert np.max(np.abs(unclipped)) > 0.2  # the clip must actually bite
    np.testing.assert_array_equal(clipped, np.clip(unclipped, -0.2, 0.2))

    # and the fft strategy (XLA jnp.clip path) agrees on the same scale
    fft_clipped = run(dataclasses.replace(base, conv_strategy="fft"))
    assert err_db(clipped, fft_clipped) < -84  # clipped-scale denominator


def test_ring_step_matches_step(rng):
    """Pipeline.ring_step must produce the exact per-block outputs of the
    staged step loop — same carried tail, same dither key schedule — while
    leaving the other output-ring slots untouched."""
    import dataclasses

    import jax.numpy as jnp

    base = make_cfg(
        blocksize=512, upsample_factor=2, numtaps=65, batch=4,
        eq_enabled=True, conv_strategy="td_mxu", output_clip=0.5,
    )
    sig = (rng.normal(size=(3, 4, 512)) * 0.4).astype(np.float32)

    p = Pipeline(base)
    assert p.supports_ring_step
    pp = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=3)
    ref = []
    for b in sig:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        ref.append(np.asarray(y))

    ring = jnp.asarray(sig)
    out_ring = jnp.full(sig.shape, 9.0, jnp.float32)
    st2 = p.init_state(seed=3)
    for i in range(sig.shape[0]):
        st2, out_ring = p._ring_step_impl(pp, st2, ring, i, out_ring)
        got = np.asarray(out_ring)
        np.testing.assert_array_equal(got[i], ref[i])
        assert np.all(got[i + 1:] == 9.0)  # later slots hold the sentinel
    np.testing.assert_array_equal(np.asarray(st.conv_tail),
                                  np.asarray(st2.conv_tail))

    # dither on: the ring path reproduces the staged key schedule
    cfgd = dataclasses.replace(base, dither_kind="tpdf", output_clip=None)
    pd = Pipeline(cfgd)
    ppd = pd.device_params(PipelineParams.design(pd.cfg))
    std = pd.init_state(seed=7)
    refd = []
    for b in sig:
        std, y = pd._step_impl(ppd, std, jnp.asarray(b))
        refd.append(np.asarray(y))
    std2 = pd.init_state(seed=7)
    ringd = jnp.zeros(sig.shape, jnp.float32)
    for i in range(sig.shape[0]):
        std2, ringd = pd.ring_step(ppd, std2, ring, i, ringd)
    np.testing.assert_array_equal(np.asarray(ringd), np.stack(refd))


def test_agc_ring_step_matches_step(rng):
    """The AGC chain's serving-ring form must be bit-identical to the staged
    AGC step across carried blocks (the C8 chain)."""
    import jax.numpy as jnp
    cfg = make_cfg(
        blocksize=256, upsample_factor=2, numtaps=33, batch=16,
        eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=64, agc_carry=True, dither_kind="tpdf",
        output_clip=0.99, conv_strategy="td_mxu",
    )
    sig = (rng.normal(size=(3, 16, 256)) * 0.1).astype(np.float32)

    p = Pipeline(cfg)
    assert p.supports_ring_step
    pp = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=9)
    ref = []
    for b in sig:
        st, y = p._step_impl(pp, st, b)
        ref.append(np.asarray(y))

    ring = jnp.asarray(sig)  # [S, B, T] f32 serving ring
    out_ring = jnp.full(sig.shape, 3.0, jnp.float32)
    st2 = p.init_state(seed=9)
    for i in range(sig.shape[0]):
        st2, out_ring = p._ring_step_impl(pp, st2, ring, i, out_ring)
        got = np.asarray(out_ring)
        np.testing.assert_array_equal(got[i], ref[i])
        assert np.all(got[i + 1:] == 3.0)
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))
    np.testing.assert_array_equal(np.asarray(st.conv_tail),
                                  np.asarray(st2.conv_tail))
    np.testing.assert_array_equal(np.asarray(st.key), np.asarray(st2.key))

    # and through the one-dispatch serving scan
    st3 = p.init_state(seed=9)
    ring_out2 = jnp.zeros(sig.shape, jnp.float32)
    st3, ring_out2 = p.run_ring(pp, st3, ring, ring_out2, 3)
    np.testing.assert_array_equal(np.asarray(ring_out2), np.stack(ref))


def test_run_ring_matches_step_loop_with_wraparound(rng):
    """Pipeline.run_ring (one-dispatch serving scan) must equal the
    per-step loop for n_steps > K (ring wraparound), honor a nonzero start
    offset, and leave a state a staged step can resume from."""
    import jax.numpy as jnp

    cfg = make_cfg(
        blocksize=512, upsample_factor=1, numtaps=65, batch=4,
        conv_strategy="td_mxu", dither_kind="off",
    )
    K, n_steps, start = 3, 5, 2
    sig = (rng.normal(size=(K, 4, 512)) * 0.4).astype(np.float32)
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(p.cfg))
    ring = jnp.asarray(sig)

    st = p.init_state(seed=1)
    last = {}
    for i in range(n_steps):
        s = (start + i) % K
        st, y = p._step_impl(pp, st, ring[s])
        last[s] = np.asarray(y)  # out_ring keeps the LAST write per slot

    st2 = p.init_state(seed=1)
    out_ring = jnp.full(sig.shape, 5.0, jnp.float32)
    st2, out_ring = p.run_ring(pp, st2, ring, out_ring, n_steps,
                               start=start)
    got = np.asarray(out_ring)
    for s, y in last.items():
        np.testing.assert_array_equal(got[s], y)
    np.testing.assert_array_equal(np.asarray(st.conv_tail),
                                  np.asarray(st2.conv_tail))
    nxt = (rng.normal(size=(4, 512)) * 0.4).astype(np.float32)
    _, y_gold = p._step_impl(pp, st, jnp.asarray(nxt))
    _, y_ring = p._step_impl(pp, st2, jnp.asarray(nxt))
    np.testing.assert_array_equal(np.asarray(y_ring), np.asarray(y_gold))


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_f32_ring_matches_staged(rng, strategy):
    """The f32 serving ring equals the staged step loop on both conv
    strategies, dither off and on (the shared key walk)."""
    import dataclasses

    import jax.numpy as jnp

    cfg = make_cfg(blocksize=512, upsample_factor=2, numtaps=65, batch=4,
                   conv_strategy=strategy, dither_kind="off",
                   eq_enabled=True, output_clip=0.8)
    K, n_steps, start = 3, 5, 2
    sig = (rng.normal(size=(K, 4, 512)) * 0.4).astype(np.float32)
    ring = jnp.asarray(sig)
    for dither in ("off", "tpdf"):
        p = Pipeline(dataclasses.replace(cfg, dither_kind=dither))
        pp = p.device_params(PipelineParams.design(p.cfg))
        st = p.init_state(seed=4)
        last = {}
        for i in range(n_steps):
            s = (start + i) % K
            st, y = p._step_impl(pp, st, jnp.asarray(sig[s]))
            last[s] = np.asarray(y)
        st2 = p.init_state(seed=4)
        out = jnp.zeros(sig.shape, jnp.float32)
        st2, out = p.run_ring(pp, st2, ring, out, n_steps, start=start)
        for s, y in last.items():
            np.testing.assert_array_equal(np.asarray(out)[s], y)
        np.testing.assert_array_equal(np.asarray(st2.key),
                                      np.asarray(st.key))


def test_pair_ingest_rejected():
    """The bf16 pair ingest is gone: 'pair' is an invalid ingest."""
    import dataclasses

    cfg = make_cfg(conv_strategy="td_mxu", blocksize=512, batch=4)
    with pytest.raises(ValueError, match="invalid ingest"):
        dataclasses.replace(cfg, ingest="pair").validate()


def test_f32_ring_kpad_wider_than_block(rng):
    """Overlap tail wider than the block (n_casc − 1 > T): the carried
    history stitches old-tail and block columns across steps — the ring
    scan must match the staged step loop bit-exactly."""
    import jax.numpy as jnp

    cfg = make_cfg(blocksize=256, upsample_factor=1, numtaps=385, batch=4,
                   conv_strategy="td_mxu", dither_kind="off",
                   eq_enabled=False)
    p = Pipeline(cfg)
    assert p.n_casc - 1 > p.block and p.supports_ring_step
    pp = p.device_params(PipelineParams.design(p.cfg))
    K, n_steps = 3, 5
    sig = (rng.normal(size=(K, 4, 256)) * 0.4).astype(np.float32)

    st = p.init_state(seed=2)
    last = {}
    for i in range(n_steps):
        s = i % K
        st, y = p._step_impl(pp, st, jnp.asarray(sig[s]))
        last[s] = np.asarray(y)

    st1, out1 = p.run_ring(pp, p.init_state(seed=2), jnp.asarray(sig),
                           jnp.zeros(sig.shape, jnp.float32), n_steps)
    for s, y in last.items():
        np.testing.assert_array_equal(np.asarray(out1)[s], y)
    np.testing.assert_array_equal(np.asarray(st1.conv_tail),
                                  np.asarray(st.conv_tail))


def test_run_ring_misuse_raises_descriptive_errors():
    """Ring dtype and capability mismatches raise descriptive ValueErrors."""
    import jax.numpy as jnp

    ring = jnp.zeros((3, 4, 256), jnp.float32)
    out = jnp.zeros((3, 4, 256), jnp.float32)

    cfg = make_cfg(blocksize=256, upsample_factor=1, batch=4,
                   conv_strategy="td_mxu", eq_enabled=False, ingest="pcm16")
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(p.cfg))
    with pytest.raises(ValueError, match="int16"):
        p.run_ring(pp, p.init_state(seed=0), ring, out, 2)

    cfg2 = make_cfg(blocksize=256, upsample_factor=1, batch=4,
                    conv_strategy="fft", eq_enabled=False,
                    waterfall_enabled=True)
    p2 = Pipeline(cfg2)
    pp2 = p2.device_params(PipelineParams.design(p2.cfg))
    with pytest.raises(ValueError, match="ring_step requires"):
        p2.run_ring(pp2, p2.init_state(seed=0), ring, out, 2)
