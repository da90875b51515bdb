"""The GPU port's plain-XLA serving path and its one hand-written kernel.

* ring step == staged step (the ring runs the step body on a ring slot);
* the Triton-route AGC recurrence kernel, in interpret mode, against the
  plain recurrences it replaces;
* backend selection (compiled kernel on the GPU, plain references on the
  CPU, an error elsewhere);
* the band-matrix conv against the float64 oracle at its named algorithm;
* compile-cache placement;
* card-only checks (marker ``gpu``; they skip without a card).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.engine.batch import with_per_stream_filters
from afp.ops.agc import smooth_gain_blockwise, smooth_gain_scan
from afp.ops.convolve import BAND_ALGORITHM, band_conv
from afp.ops.pallas.agc_scan import smooth_gain_pallas


def _cfg(**kw):
    base = dict(samplerate=44100, blocksize=256, upsample_factor=2,
                numtaps=33, batch=8, eq_enabled=True, agc_enabled=False,
                downsample_mode="decimate", dither_kind="tpdf",
                output_clip=0.99, resample_quality="fast")
    base.update(kw)
    return StreamConfig(**base)


def _pallas_calls(closed):
    """Every pallas_call equation in a (nested) jaxpr."""
    found = []

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                found.append(e)
            for v in e.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    walk(sub if hasattr(sub, "eqns") else sub.jaxpr)
                elif hasattr(v, "eqns"):
                    walk(v)

    walk(closed.jaxpr)
    return found


# ------------------------------------------------------------- ring == staged

def _bank_params(pipe):
    return with_per_stream_filters(
        pipe, [dict(cutoff=3000.0 + 1000.0 * i) for i in range(pipe.batch)])


@pytest.mark.parametrize("form", ["f32", "pcm16", "agc", "per_stream"])
def test_ring_step_equals_staged_step(rng, form):
    kw = {"f32": {}, "pcm16": {"ingest": "pcm16", "emit": "pcm16"},
          "agc": {"agc_enabled": True, "agc_window_size": 64},
          "per_stream": {"eq_enabled": False}}[form]
    pipe = Pipeline(_cfg(**kw))
    params = (_bank_params(pipe) if form == "per_stream" else
              pipe.device_params(PipelineParams.design(pipe.cfg)))
    K, n = 3, 5
    if form == "pcm16":
        blocks = rng.integers(-30000, 30000, (K, 8, 256)).astype(np.int16)
    else:
        blocks = (rng.normal(size=(K, 8, 256)) * 0.3).astype(np.float32)
    st = pipe.init_state(seed=7)
    last = {}
    for i in range(n):
        st, y = pipe._step_impl(params, st, jnp.asarray(blocks[i % K]))
        last[i % K] = np.asarray(y)
    out = jnp.zeros(blocks.shape, jnp.int16 if form == "pcm16"
                    else jnp.float32)
    st2, out = pipe.run_ring(params, pipe.init_state(seed=7),
                             jnp.asarray(blocks), out, n)
    for s, y in last.items():
        np.testing.assert_array_equal(np.asarray(out)[s], y)
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------- AGC recurrence kernel

@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("vector_alpha", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_agc_kernel_interpret_matches_plain(rng, mode, vector_alpha, carry):
    """Batch 40 on 16-stream tiles: the wrapper pads to 48 and cuts back."""
    T, B = 128, 40
    d = jnp.asarray(np.abs(np.cumsum(rng.normal(size=(B, T)) * 0.05,
                                     axis=1)) % 3 + 0.2, jnp.float32)
    if vector_alpha:
        a_att = jnp.asarray(rng.uniform(0.05, 0.4, B), jnp.float32)
        a_rel = jnp.asarray(rng.uniform(0.005, 0.05, B), jnp.float32)
    else:
        a_att, a_rel = 0.2, 0.02
    init = (jnp.asarray(rng.uniform(0.5, 2.0, B), jnp.float32) if carry
            else None)
    chunk = 32 if mode == "fast" else 1
    g = smooth_gain_pallas(d.T, a_att, a_rel, init=init, chunk=chunk,
                           block_b=16, interpret=True).T
    if mode == "fast":
        ref = smooth_gain_blockwise(d, a_att, a_rel, chunk=32, init=init)
    else:
        ref = smooth_gain_scan(d, a_att, a_rel, init=init)
    assert g.shape == (B, T)
    # float32 rounding: FMA contraction and the chunk-mean sum order
    tol = 1e-6 * max(1.0, float(jnp.max(jnp.abs(ref))))
    assert float(jnp.max(jnp.abs(g - ref))) <= tol


# -------------------------------------------------------- backend selection

def test_gpu_backend_picks_compiled_kernel(monkeypatch):
    """On a GPU backend the engine's AGC runs the Triton-route kernel,
    compiled (interpret=False); tracing needs no card."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pipe = Pipeline(_cfg(agc_enabled=True, agc_window_size=64))
    assert pipe.platform == "gpu" and pipe._agc_kernel
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    closed = jax.make_jaxpr(pipe._step_impl)(
        params, pipe.init_state(), jnp.zeros((8, 256), jnp.float32))
    calls = _pallas_calls(closed)
    assert len(calls) == 1
    p = calls[0].params
    assert p["interpret"] is False and p["backend"] == "triton"
    # the CPU runs the plain recurrence: no kernel in the step
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    cpu = Pipeline(_cfg(agc_enabled=True, agc_window_size=64))
    assert cpu.platform == "cpu" and not cpu._agc_kernel
    assert not _pallas_calls(jax.make_jaxpr(cpu._step_impl)(
        params, cpu.init_state(), jnp.zeros((8, 256), jnp.float32)))


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_unsupported_backend_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        Pipeline(_cfg())


# ----------------------------------------------------------- band-matrix conv

@pytest.mark.parametrize("algorithm", [
    jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    jax.lax.DotAlgorithmPreset.F32_F32_F32])
def test_band_conv_meets_contract(rng, algorithm):
    for N, T in ((379, 512), (209, 300)):
        x = (rng.normal(size=(4, T + N - 1)) * 0.3).astype(np.float32)
        h = (rng.normal(size=N) / np.sqrt(N)).astype(np.float32)
        y = np.asarray(band_conv(x, h, algorithm=algorithm))
        gold = np.stack([np.convolve(r.astype(np.float64),
                                     h.astype(np.float64), "valid")
                         for r in x])
        err = np.max(np.abs(y - gold)) / np.max(np.abs(gold))
        assert y.shape == (4, T) and 20 * np.log10(err) < -90


def test_band_conv_names_its_algorithm():
    """The conv's dot names BAND_ALGORITHM (never DEFAULT, which the GPU
    may run as TF32)."""
    closed = jax.make_jaxpr(band_conv)(jnp.zeros((2, 300), jnp.float32),
                                       jnp.zeros(45, jnp.float32))
    dots = [e for e in closed.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    assert dots[0].params["precision"] == BAND_ALGORITHM


# ------------------------------------------------------- compile-cache helper

def test_compile_cache_respects_env(monkeypatch, tmp_path):
    from afp.utils import jax_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert jax_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # sets nothing when the variable is set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from afp.utils import jax_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = jax_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


# ----------------------------------------------------------------- card only

@pytest.mark.gpu
def test_agc_kernel_compiled_matches_scan(gpu):
    T, B = 2048, 4096
    d = jnp.abs(jnp.cumsum(jax.random.normal(jax.random.PRNGKey(0), (B, T))
                           * 0.02, axis=-1)) % 4.0 + 0.25
    g = jax.jit(lambda d: smooth_gain_pallas(d.T, 0.18, 0.02).T)(d)
    ref = jax.jit(lambda d: smooth_gain_scan(d, 0.18, 0.02))(d)
    assert float(jnp.max(jnp.abs(g - ref))) <= 1e-6 * float(jnp.max(ref))


@pytest.mark.gpu
def test_c8_ring_equals_staged_on_card(gpu, rng):
    pipe = Pipeline(_cfg(agc_enabled=True, agc_window_size=64, batch=256))
    assert pipe._agc_kernel
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    blocks = jnp.asarray((rng.normal(size=(4, 256, 256)) * 0.1)
                         .astype(np.float32))
    _, ys = pipe.run(params, pipe.init_state(3), blocks)
    out = jnp.zeros(blocks.shape, jnp.float32)
    _, out = pipe.run_ring(params, pipe.init_state(3), blocks, out, 4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ys))
