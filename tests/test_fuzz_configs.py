"""Seeded config-space fuzz: random StreamConfigs through the pipeline's
core invariants.

The targeted suites pin each feature at a handful of operating points; this
sweep samples the CROSS PRODUCT corners (ingest × emit × strategy × AGC ×
link × dither × rates × shapes) and holds every valid draw to the
invariants that must be true of ANY config:

  1. ``validate()`` either returns a runnable config or raises ValueError /
     clamps — it never lets an unrunnable combination through to a crash;
  2. streaming ``step()`` outputs are finite, shaped [B, L_out], and the
     right dtype for ``emit``;
  3. ``process_signal(fold=False)`` ≡ the per-block ``step()`` loop (the
     scan is the same step body — lax.scan vs the Python loop);
  4. when ``supports_fold`` and dither is off, ``fold='prefer'`` matches
     the scan within the documented batched-product bound
     (tests/test_fold.py:CPU_ATOL).

Seeded (no flakes) and deliberately drawn from VALID vocabulary with a few
invalid values mixed in to exercise the rejection paths.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow


CPU_ATOL = 1e-5  # test_fold.py's interpret-GEMM reassociation bound

N_DRAWS = 24


def _draw(rng: np.random.Generator) -> StreamConfig:
    pick = lambda *xs: xs[rng.integers(len(xs))]
    agc = bool(pick(False, True))
    batch = int(pick(1, 2, 4))
    cfg = dict(
        samplerate=int(pick(22050, 44100, 48000)),
        blocksize=int(pick(256, 512, 1024)),
        upsample_factor=int(pick(1, 2, 3, 4)),
        numtaps=int(pick(33, 65, 129, 257)),
        filter_type=pick("lowpass", "highpass", "bandpass"),
        window_type=pick("hamming", "hann", "blackman", "kaiser"),
        batch=batch,
        eq_enabled=bool(pick(False, True)),
        agc_enabled=agc,
        agc_mode=pick("exact", "fast", "parallel"),
        agc_window_size=int(pick(64, 128, 512)),
        agc_carry=bool(pick(False, True)),
        agc_link_group=int(pick(1, 2)) if agc else 1,
        dither_kind=pick("off", "tpdf", "rpdf"),
        downsample_mode=pick("resample", "decimate"),
        output_rate=pick("base", "base", "base", "upsampled"),
        conv_strategy=pick("fft", "td_mxu"),
        # mostly 'fast' for interpret-mode runtime; 'hq' sampled for coverage
        resample_quality=pick("fast", "fast", "fast", "hq"),
        ingest=pick("f32", "f32", "pcm16", "pair"),  # 'pair' is invalid
        emit=pick("f32", "f32", "pcm16"),
        output_clip=pick(None, 0.99),
    )
    if cfg["filter_type"] == "bandpass":
        ny = cfg["samplerate"] * cfg["upsample_factor"] / 2
        cfg["cutoff"] = (1000.0, min(8000.0, ny * 0.8))
    return StreamConfig(**cfg)


def _blocks(rng, cfg, nb=3):
    shape = (nb, cfg.batch, cfg.blocksize)
    x = (rng.normal(size=shape) * 0.1).astype(np.float32)
    if cfg.agc_link_group == 2 and cfg.batch >= 2:
        x[:, 1::2] = 0.5 * x[:, 0::2]
    if cfg.ingest == "pcm16":
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_fuzz_config_invariants(seed, monkeypatch):
    rng = np.random.default_rng(1000 + seed)
    raw = _draw(rng)
    try:
        cfg = raw.validate()
    except ValueError:
        return  # a loud, typed rejection is a PASS for invalid combos
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = _blocks(rng, cfg)

    def ingest(b):
        return jnp.asarray(b)

    # 2. streaming steps: finite, shaped, typed
    st = pipe.init_state(seed=7)
    outs = []
    for b in sig:
        st, y = pipe.step(params, st, ingest(b))
        y = np.asarray(y)
        outs.append(y)
        assert y.shape[0] == cfg.batch
        assert y.dtype == (np.int16 if cfg.emit == "pcm16" else np.float32)
        if y.dtype == np.float32:
            assert np.all(np.isfinite(y)), raw
    streamed = np.concatenate(outs, axis=-1)

    # 3. process_signal scan ≡ the step loop
    flat = np.concatenate(list(sig), axis=-1)
    _, y_sig = pipe.process_signal(params, pipe.init_state(seed=7), flat,
                                   fold=False)
    y_sig = np.asarray(y_sig)
    if y_sig.dtype == np.int16:
        assert np.max(np.abs(y_sig.astype(np.int64)
                             - streamed.astype(np.int64))) <= 1
    else:
        np.testing.assert_allclose(y_sig, streamed, atol=1e-6)

    # 4. offline fold ≡ scan (dither off: the fold re-keys dither noise)
    if pipe.supports_fold and cfg.dither_kind == "off":
        _, y_fold = pipe.process_signal(params, pipe.init_state(seed=7),
                                        flat, fold="prefer")
        y_fold = np.asarray(y_fold)
        if y_fold.dtype == np.int16:
            assert np.max(np.abs(y_fold.astype(np.int64)
                                 - y_sig.astype(np.int64))) <= 1
        else:
            np.testing.assert_allclose(y_fold, y_sig, atol=CPU_ATOL)


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_fuzz_sharded_matches_unsharded(seed, monkeypatch):
    """The same config draws, re-shaped to a 4-shard batch: stream-DP over
    the virtual mesh must reproduce the single-device pipeline (batched-FFT
    ulps; ±1 LSB for int16 emit).  Dither is forced off — sharded runs use
    per-shard dither keys by design, so only the noiseless outputs are
    comparable across layouts."""
    import jax

    from afp.parallel import ShardedPipeline, make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.default_rng(1000 + seed)  # same draws as the main fuzz
    raw = _draw(rng)
    try:
        cfg = dataclasses.replace(
            raw, batch=4 * raw.agc_link_group,  # whole groups per shard
            dither_kind="off").validate()
    except ValueError:
        return
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = _blocks(rng, cfg)

    def ingest(b):
        return jnp.asarray(b)

    st = pipe.init_state(seed=3)
    ref = []
    for b in sig:
        st, y = pipe.step(params, st, ingest(b))
        ref.append(np.asarray(y))
    ref = np.stack(ref)

    sp = ShardedPipeline(cfg, make_mesh(4))
    spp = sp.device_params(PipelineParams.design(sp.cfg))
    sst = sp.init_state(seed=3)
    got = []
    for b in sig:
        sst, y = sp.step(spp, sst, ingest(b))
        got.append(np.asarray(y))
    got = np.stack(got)
    # the approximate AGC modes branch on attack-vs-release per sample/
    # chunk (`desired > g_prev`); a near-tie can flip when the batch layout
    # shifts XLA's f32 reassociation by an ulp — both branches give nearly
    # identical gains at a tie (the ops' documented behavior), observed as
    # isolated ~1e-6 diffs (seeds 10/14/18: parallel and fast modes).  The
    # exact mode rides the interpret/Pallas kernels whose per-row math is
    # batch-independent, and stays at the strict bound.
    approx_agc = cfg.agc_enabled and cfg.agc_mode != "exact"
    atol = 1e-4 if approx_agc else 1e-6
    if got.dtype == np.int16:
        assert np.max(np.abs(got.astype(np.int64)
                             - ref.astype(np.int64))) <= 1, raw
    else:
        np.testing.assert_allclose(got, ref, atol=atol)
