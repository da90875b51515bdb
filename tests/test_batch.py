"""Per-stream parameter bank tests."""
import numpy as np
import pytest

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.engine.batch import broadcast_gains, with_per_stream_gains


def make(batch, **kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=batch, cutoff=11000.0, eq_enabled=True, agc_enabled=False,
        downsample_mode="decimate", dither_kind="off", output_clip=None,
    )
    base.update(kw)
    cfg = StreamConfig(**base)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    return pipe, params


def test_per_stream_gains_match_individual_runs(rng):
    pipe, params = make(batch=3)
    gains = np.array([
        [1.0] * 9,
        [2.0] * 9,
        np.linspace(0.5, 1.5, 9),
    ], dtype=np.float32)
    sig = (rng.normal(size=(3, 512 * 3)) * 0.3).astype(np.float32)
    psp = with_per_stream_gains(pipe, params, gains)
    _, batched = pipe.process_signal(psp, pipe.init_state(0), sig)
    batched = np.asarray(batched)

    for b in range(3):
        pipe1, params1 = make(batch=1)
        p1 = params1._replace(eq_gains=np.asarray(gains[b]))
        import jax.numpy as jnp

        p1 = params1._replace(eq_gains=jnp.asarray(gains[b]))
        _, single = pipe1.process_signal(p1, pipe1.init_state(0), sig[b : b + 1])
        np.testing.assert_allclose(batched[b], np.asarray(single)[0], atol=1e-6)


def test_broadcast_gains_shapes():
    g = broadcast_gains(1.5, 4, 9)
    assert g.shape == (4, 9)
    g = broadcast_gains([1.0] * 9, 4, 9)
    assert g.shape == (4, 9)
    with pytest.raises(ValueError):
        broadcast_gains([1.0] * 5, 4, 9)
    with pytest.raises(ValueError):
        broadcast_gains(np.ones((3, 9)), 4, 9)


def test_per_stream_on_td_matches_fft(rng):
    """Per-stream gain banks on the MXU strategy ≡ the FFT strategy."""
    gains = np.array([
        [1.0] * 9,
        np.linspace(0.5, 2.0, 9),
    ], dtype=np.float32)
    sig = (rng.normal(size=(2, 256 * 3)) * 0.3).astype(np.float32)
    outs = {}
    for strat in ("fft", "td_mxu"):
        pipe, params = make(batch=2, blocksize=256, conv_strategy=strat)
        psp = with_per_stream_gains(pipe, params, gains)
        _, out = pipe.process_signal(psp, pipe.init_state(0), sig)
        outs[strat] = np.asarray(out)
    scale = np.max(np.abs(outs["fft"])) + 1e-12
    err = np.max(np.abs(outs["fft"] - outs["td_mxu"])) / scale
    assert 20 * np.log10(err + 1e-300) < -100


def test_per_stream_td_b3_meets_contract(rng):
    """Per-stream gain-mixed kernels through the band-matrix product at its
    bf16×3 algorithm stay under −90 dB vs the float64 oracle."""
    import jax.numpy as jnp

    from afp.ops.convolve import band_conv

    N, T, B, K = 65, 256, 4, 3
    kernels = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    gains = rng.uniform(0.5, 2.0, size=(B, K)).astype(np.float32)
    x = (rng.normal(size=(B, T + N - 1)) * 0.5).astype(np.float32)
    gold = np.zeros((B, T))
    out = np.zeros((B, T))
    for b in range(B):
        kb = gains[b] @ kernels
        out[b] = np.asarray(band_conv(jnp.asarray(x[b]), jnp.asarray(kb)))
        for k in range(K):
            gold[b] += gains[b, k] * np.convolve(
                x[b].astype(np.float64), kernels[k].astype(np.float64), "valid")
    err = np.max(np.abs(out - gold)) / np.max(np.abs(gold))
    assert 20 * np.log10(err + 1e-300) < -90


def test_per_stream_filter_banks_match_individual_runs(rng):
    """SURVEY §7 step 5 'each stream can have its own kernel': a [B, F]
    main-filter bank equals B independent single-stream pipelines."""
    variants = [
        dict(cutoff=6000.0),
        dict(cutoff=15000.0, window_type="hann"),
        dict(cutoff=(500.0, 8000.0), filter_type="bandpass"),
    ]
    from afp.engine.batch import with_per_stream_filters

    pipe, _ = make(batch=3, eq_enabled=False)
    bank = with_per_stream_filters(pipe, variants)
    sig = (rng.normal(size=(3, 512 * 3)) * 0.3).astype(np.float32)
    _, batched = pipe.process_signal(bank, pipe.init_state(0), sig)
    batched = np.asarray(batched)
    import dataclasses

    for b, ov in enumerate(variants):
        pipe1, params1 = make(batch=1, eq_enabled=False, **ov)
        _, single = pipe1.process_signal(params1, pipe1.init_state(0),
                                         sig[b : b + 1])
        np.testing.assert_allclose(batched[b], np.asarray(single)[0], atol=1e-6)


def test_per_stream_filter_banks_unfused_path(rng):
    from afp.engine.batch import with_per_stream_filters

    variants = [dict(cutoff=4000.0), dict(cutoff=12000.0)]
    pipe, _ = make(batch=2, eq_enabled=False, fuse_rate_conversion=False)
    bank = with_per_stream_filters(pipe, variants)
    sig = (rng.normal(size=(2, 512 * 2)) * 0.3).astype(np.float32)
    _, out = pipe.process_signal(bank, pipe.init_state(0), sig)
    import dataclasses

    for b, ov in enumerate(variants):
        pipe1, params1 = make(batch=1, eq_enabled=False,
                              fuse_rate_conversion=False, **ov)
        _, single = pipe1.process_signal(params1, pipe1.init_state(0),
                                         sig[b : b + 1])
        np.testing.assert_allclose(np.asarray(out)[b], np.asarray(single)[0],
                                   atol=1e-6)


def test_per_stream_filter_banks_guards():
    from afp.engine.batch import with_per_stream_filters

    pipe, _ = make(batch=2, eq_enabled=False)
    with pytest.raises(ValueError, match="variants"):
        with_per_stream_filters(pipe, [dict(cutoff=5000.0)])
    with pytest.raises(ValueError, match="static"):
        with_per_stream_filters(pipe, [dict(numtaps=33), dict(cutoff=1.0)])
    pipe_eq, _ = make(batch=2, eq_enabled=True)
    with pytest.raises(NotImplementedError, match="eq_enabled"):
        with_per_stream_filters(pipe_eq, [dict(), dict()])
    # td_mxu configs take row-level banks too: the [B, F] response bank
    # (the bank always runs the FFT pass)
    pipe_td, _ = make(batch=2, eq_enabled=False, conv_strategy="td_mxu")
    bank = with_per_stream_filters(pipe_td, [dict(), dict()])
    assert bank.H_main.shape[0] == 2 and bank.per_stream()


def test_per_stream_filter_banks_numtaps_bump_rejected():
    """validate() bumps even numtaps to odd for highpass/bandstop (type-II
    Nyquist zero) — a per-variant bump changes the kernel length, which
    used to crash np.stack (mixed variants) or silently truncate the bank
    (all bumped).  Review fix: rejected with guidance."""
    from afp.engine.batch import with_per_stream_filters

    pipe, _ = make(batch=2, eq_enabled=False, numtaps=64)
    with pytest.raises(ValueError, match="odd base numtaps"):
        with_per_stream_filters(
            pipe, [dict(filter_type="highpass", cutoff=1000.0),
                   dict(cutoff=5000.0)])
    # odd base numtaps: the same variants design fine
    pipe_odd, _ = make(batch=2, eq_enabled=False, numtaps=65)
    params = with_per_stream_filters(
        pipe_odd, [dict(filter_type="highpass", cutoff=1000.0),
                   dict(cutoff=5000.0)])
    assert params.H_main.shape[0] == 2


def test_per_stream_gains_require_eq():
    """with_per_stream_gains on an EQ-disabled pipeline used to silently
    no-op (combined_response statically ignores eq_gains then) — review
    fix: rejected."""
    pipe, params = make(batch=2, eq_enabled=False)
    with pytest.raises(ValueError, match="eq_enabled"):
        with_per_stream_gains(pipe, params, 2.0)


# ------- per-stream filter banks under conv_strategy='td_mxu' --


def _td_cfg(**kw):
    from afp.engine import StreamConfig

    base = dict(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=33,
        batch=16, eq_enabled=False, agc_enabled=False,
        downsample_mode="decimate", dither_kind="off", output_clip=None,
        conv_strategy="td_mxu", resample_quality="fast",
    )
    base.update(kw)
    return StreamConfig(**base)


def test_td_banked_matches_single_design_pipelines(rng):
    """with_per_stream_filters under conv_strategy='td_mxu': every stream
    is convolved with ITS design's cascade — asserted against per-design
    shared-kernel pipelines row-for-row (same seed, same state walk)."""
    import dataclasses

    from afp.engine.batch import with_per_stream_filters

    cfg = _td_cfg()
    pipe = Pipeline(cfg)
    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    bank = with_per_stream_filters(pipe, variants)
    assert bank.H_main.shape[0] == 16  # one response row per stream
    blocks = (rng.normal(size=(3, 16, cfg.blocksize)) * 0.3
              ).astype(np.float32)
    st = pipe.init_state(seed=1)
    out = []
    for b in blocks:
        st, y = pipe.step(bank, st, b)
        out.append(np.asarray(y))
    out = np.stack(out)
    for cut, rows in ((4000.0, slice(0, 8)), (12000.0, slice(8, 16))):
        p2 = Pipeline(dataclasses.replace(cfg, cutoff=cut))
        pp2 = p2.device_params(PipelineParams.design(p2.cfg))
        st2 = p2.init_state(seed=1)
        for i, b in enumerate(blocks):
            st2, g = p2.step(pp2, st2, b)
            np.testing.assert_allclose(out[i][rows], np.asarray(g)[rows],
                                       atol=1e-6)


def test_td_banked_ring_and_mega_match_step(rng):
    """A per-stream filter bank through the serving ring matches the staged
    step bitwise, per-step and in the one-dispatch scan (the ring runs the
    step body on a ring slot; the old megakernel form is gone)."""
    import jax.numpy as jnp

    from afp.engine.batch import with_per_stream_filters

    cfg = _td_cfg()
    pipe = Pipeline(cfg)
    assert pipe.supports_ring_step
    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    bank = with_per_stream_filters(pipe, variants)
    blocks = (rng.normal(size=(2, 16, cfg.blocksize)) * 0.3
              ).astype(np.float32)
    st = pipe.init_state(seed=1)
    ref = []
    for b in blocks:
        st, y = pipe._step_impl(bank, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    ring = jnp.asarray(blocks)
    orng = jnp.zeros(blocks.shape, jnp.float32)
    st2 = pipe.init_state(seed=1)
    for i in range(2):
        st2, orng = pipe._ring_step_impl(bank, st2, ring, i, orng)
        np.testing.assert_array_equal(np.asarray(orng)[i], ref[i])
    om = jnp.zeros(blocks.shape, jnp.float32)
    _, om = pipe.run_ring(bank, pipe.init_state(seed=1), ring, om, 2)
    np.testing.assert_array_equal(np.asarray(om), np.asarray(orng))


def test_td_banked_guards(rng):
    """Row-level banks need no tiling: 16 distinct designs in 16 rows are
    accepted, and the offline fold ('prefer') agrees with the scan."""
    from afp.engine.batch import with_per_stream_filters

    pipe = Pipeline(_td_cfg())
    bank = with_per_stream_filters(
        pipe, [dict(cutoff=1000.0 + 500 * i) for i in range(16)])
    sig = (rng.normal(size=(16, 2 * 512)) * 0.3).astype(np.float32)
    _, y = pipe.process_signal(bank, pipe.init_state(seed=1), sig,
                               fold="prefer")
    st = pipe.init_state(seed=1)
    ref = []
    for i in range(2):
        st, o = pipe.step(bank, st, sig[:, i * 512:(i + 1) * 512])
        ref.append(np.asarray(o))
    np.testing.assert_allclose(np.asarray(y), np.concatenate(ref, axis=-1),
                               atol=1e-6)


def test_td_banked_with_dither_and_clip(rng):
    """A per-stream filter bank with clip and dither: deterministic per
    seed and within the clip bound."""
    from afp.engine.batch import with_per_stream_filters

    cfg = _td_cfg(dither_kind="tpdf", output_clip=0.5)
    pipe = Pipeline(cfg)
    bank = with_per_stream_filters(
        pipe, [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)])
    x = (rng.normal(size=(16, 512)) * 2.0).astype(np.float32)  # drives clip
    _, y1 = pipe.step(bank, pipe.init_state(seed=3), x)
    _, y2 = pipe.step(bank, pipe.init_state(seed=3), x)
    y1 = np.asarray(y1)
    np.testing.assert_array_equal(y1, np.asarray(y2))
    lsb = 2.0 / 2 ** 24
    assert np.max(np.abs(y1)) <= 0.5 + lsb


def test_td_banked_pcm16(rng):
    """pcm16 ingest with a per-stream filter bank: staged steps and the raw
    int16 serving ring both match the f32 pipeline fed n/32768 floats."""
    import jax.numpy as jnp

    from afp.engine.batch import with_per_stream_filters

    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    cfg16 = _td_cfg(ingest="pcm16")
    p16 = Pipeline(cfg16)
    bank16 = with_per_stream_filters(p16, variants)
    pf = Pipeline(_td_cfg())
    bankf = with_per_stream_filters(pf, variants)

    qi = (rng.integers(-32768, 32768, size=(2, 16, cfg16.blocksize))
          .astype(np.int16))
    qf = qi.astype(np.float32) / np.float32(32768.0)
    st16, stf = p16.init_state(seed=2), pf.init_state(seed=2)
    for i in range(2):
        st16, y16 = p16.step(bank16, st16, qi[i])
        stf, yf = pf.step(bankf, stf, qf[i])
        np.testing.assert_allclose(np.asarray(y16), np.asarray(yf),
                                   atol=1e-6)

    # raw int16 serving ring, banked
    assert p16.supports_ring_step
    ring = jnp.asarray(qi)
    orng = jnp.zeros(qi.shape, jnp.float32)
    st3 = p16.init_state(seed=2)
    for i in range(2):
        st3, orng = p16._ring_step_impl(bank16, st3, ring, i, orng)
    st16b = p16.init_state(seed=2)
    for i in range(2):
        st16b, yref = p16.step(bank16, st16b, qi[i])
        np.testing.assert_allclose(np.asarray(orng)[i], np.asarray(yref),
                                   atol=1e-6)


def test_td_banked_with_agc(rng):
    """Per-stream filter banks compose with the AGC stage, staged and on
    the serving ring."""
    import jax.numpy as jnp

    from afp.engine.batch import with_per_stream_filters

    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    cfg = _td_cfg(agc_enabled=True, agc_window_size=128, output_clip=0.99)
    pipe = Pipeline(cfg)
    bank = with_per_stream_filters(pipe, variants)
    x = (rng.normal(size=(16, cfg.blocksize)) * 0.01).astype(np.float32)
    st, y = pipe.step(bank, pipe.init_state(seed=1), x)
    y = np.asarray(y)
    assert np.all(np.isfinite(y)) and np.max(np.abs(y)) <= 0.99 + 1e-6

    # per-design equivalence under AGC (same gain math, own kernel)
    import dataclasses

    for cut, rows in ((4000.0, slice(0, 8)), (12000.0, slice(8, 16))):
        p2 = Pipeline(dataclasses.replace(cfg, cutoff=cut))
        pp2 = p2.device_params(PipelineParams.design(p2.cfg))
        _, g = p2.step(pp2, p2.init_state(seed=1), x)
        np.testing.assert_allclose(y[rows], np.asarray(g)[rows], atol=1e-6)

    # the serving ring takes the combination: ring == staged, bitwise
    ring = jnp.asarray(x[None])
    out = jnp.zeros((1, 16, cfg.blocksize), jnp.float32)
    _, out = pipe._ring_step_impl(bank, pipe.init_state(seed=1), ring, 0,
                                  out)
    np.testing.assert_array_equal(np.asarray(out)[0], y)


# ------- per-stream AGC parameter banks --


def _agc_vec_cfg(mode="exact"):
    from afp.engine import StreamConfig

    return StreamConfig(
        samplerate=44100, blocksize=256, upsample_factor=1, numtaps=33,
        batch=1024, eq_enabled=False, agc_enabled=True, agc_mode=mode,
        agc_window_size=64, agc_carry=True, dither_kind="off",
        output_clip=0.99, conv_strategy="td_mxu", resample_quality="fast")


_AGC_POLICIES = (dict(target=0.1, mg=10.0, att=0.01, rel=0.1),
                 dict(target=0.3, mg=4.0, att=0.05, rel=0.2))


def _agc_vec_params(pipe):
    from afp.engine.batch import with_per_stream_agc

    B = pipe.batch
    h = B // 2

    def halves(key):
        return np.r_[np.full(h, _AGC_POLICIES[0][key]),
                     np.full(h, _AGC_POLICIES[1][key])].astype(np.float32)

    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    return with_per_stream_agc(
        pipe, params, target_level=halves("target"), max_gain=halves("mg"),
        attack=halves("att"), release=halves("rel"))


def _use_agc_kernel(monkeypatch, pipe):
    """Route `pipe`'s AGC recurrence through the Triton kernel in interpret
    mode — the engine path the GPU takes, testable on the CPU."""
    import afp.ops.pallas.agc_scan as agc_scan

    orig = agc_scan.smooth_gain_pallas
    monkeypatch.setattr(agc_scan, "smooth_gain_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    pipe._agc_kernel = True


@pytest.mark.slow
@pytest.mark.parametrize("mode,kernel", [
    ("exact", True), ("fast", True), ("exact", False), ("parallel", False)])
def test_per_stream_agc_matches_scalar_runs(rng, mode, kernel, monkeypatch):
    """[B]-vector AGC policy banks ≡ N scalar-policy runs, row for row —
    through the recurrence kernel (interpret mode) and the plain JAX
    forms, across exact/fast/parallel modes."""
    import dataclasses

    cfg = _agc_vec_cfg(mode)
    pipe = Pipeline(cfg)
    if kernel:
        _use_agc_kernel(monkeypatch, pipe)
    vparams = _agc_vec_params(pipe)
    blocks = (rng.normal(size=(3, cfg.batch, cfg.blocksize)) * 0.1
              ).astype(np.float32)
    st = pipe.init_state(seed=3)
    out = []
    for b in blocks:
        st, y = pipe._step_impl(vparams, st, b)
        out.append(np.asarray(y))

    h = cfg.batch // 2
    for k, pol in enumerate(_AGC_POLICIES):
        rows = slice(0, h) if k == 0 else slice(h, cfg.batch)
        cfg_k = dataclasses.replace(
            cfg, agc_target_level=pol["target"], agc_max_gain=pol["mg"],
            agc_attack=pol["att"], agc_release=pol["rel"]).validate()
        p2 = Pipeline(cfg_k)
        if kernel:
            p2._agc_kernel = True
        pp2 = p2.device_params(PipelineParams.design(p2.cfg))
        st2 = p2.init_state(seed=3)
        for i, b in enumerate(blocks):
            st2, g = p2._step_impl(pp2, st2, b)
            # vector vs scalar operands may change float32 contraction
            np.testing.assert_allclose(out[i][rows], np.asarray(g)[rows],
                                       atol=2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_per_stream_agc_ring_matches_step(rng, mode, monkeypatch):
    """Vector AGC params through the serving ring ≡ the staged step,
    bit-exact (the ring runs the step body on a ring slot)."""
    import jax.numpy as jnp

    cfg = _agc_vec_cfg(mode)
    pipe = Pipeline(cfg)
    assert pipe.supports_ring_step
    vparams = _agc_vec_params(pipe)
    blocks = (rng.normal(size=(3, cfg.batch, cfg.blocksize)) * 0.1
              ).astype(np.float32)
    st = pipe.init_state(seed=4)
    ref = []
    for b in blocks:
        st, y = pipe._step_impl(vparams, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    ring = jnp.asarray(blocks)
    orng = jnp.zeros(blocks.shape, jnp.float32)
    st2 = pipe.init_state(seed=4)
    for i in range(3):
        st2, orng = pipe._ring_step_impl(vparams, st2, ring, i, orng)
        np.testing.assert_array_equal(np.asarray(orng)[i], ref[i])
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))


def test_per_stream_agc_validation():
    from afp.engine.batch import with_per_stream_agc

    pipe = Pipeline(_td_cfg())  # agc disabled
    pp = pipe.device_params(PipelineParams.design(pipe.cfg))
    with pytest.raises(ValueError, match="agc_enabled"):
        with_per_stream_agc(pipe, pp, target_level=0.2)
    p2 = Pipeline(_agc_vec_cfg())
    pp2 = p2.device_params(PipelineParams.design(p2.cfg))
    with pytest.raises(ValueError, match="vector"):
        with_per_stream_agc(p2, pp2, target_level=np.ones(3, np.float32))
    # scalar knobs stay scalars (no silent promotion)
    out = with_per_stream_agc(p2, pp2, target_level=0.25, attack=0.02)
    assert out.agc_target.ndim == 0 and out.agc_a_att.ndim == 0
