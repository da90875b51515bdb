"""Linked AGC (``agc_link_group``): group-min desired gain == max-RMS link,
stereo-image preservation through the full pipeline (XLA and fused Pallas
paths, staged and serving-ring), config validation, preset exclusion.

The reference is mono (`reference/stream_process.py:22`) and never
faces the linked case; this is a beyond-reference capability (PARITY.md).
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.ops.agc import (desired_gain, link_desired, moving_rms,

                             smooth_gain_scan)

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def test_link_desired_is_max_rms_link(rng):
    """group-min of clip(target/(rms+eps)) == clip(target/(max_rms+eps)):
    linking the desired gain IS linking by the loudest channel's RMS."""
    x = (rng.normal(size=(6, 400)) * [[0.5], [0.05], [0.2], [0.2], [1.0], [0.01]]).astype(np.float32)
    rms = moving_rms(jnp.asarray(x), 64)
    d = desired_gain(rms, 0.1, 10.0)
    linked = link_desired(d, 2)
    rms_max = jnp.max(rms.reshape(3, 2, -1), axis=1, keepdims=True)
    want = desired_gain(jnp.broadcast_to(rms_max, (3, 2, rms.shape[-1])
                                         ).reshape(6, -1), 0.1, 10.0)
    np.testing.assert_allclose(np.asarray(linked), np.asarray(want),
                               rtol=0, atol=0)
    # identity at group 1; both batch-axis layouts agree; bad group raises
    np.testing.assert_array_equal(np.asarray(link_desired(d, 1)),
                                  np.asarray(d))
    np.testing.assert_array_equal(
        np.asarray(link_desired(d.T, 2, batch_axis=1)).T, np.asarray(linked))
    with pytest.raises(ValueError):
        link_desired(d, 4)


def test_linked_gains_match_f64_oracle(rng):
    """Linked chain vs a float64 replica: per-channel RMS → group max →
    desired → attack/release recurrence; every channel in a group gets the
    same gain."""
    w, target, mg = 64, 0.1, 8.0
    a_att, a_rel = 0.3, 0.05
    x = (rng.normal(size=(4, 512)) * [[0.3], [0.03], [0.02], [0.4]]).astype(np.float32)

    d = link_desired(desired_gain(moving_rms(jnp.asarray(x), w), target, mg), 2)
    g = np.asarray(smooth_gain_scan(d, a_att, a_rel))

    x64 = x.astype(np.float64)
    box = np.ones(w) / w
    rms = np.sqrt(np.maximum(
        np.stack([np.convolve(r * r, box, "same") for r in x64]), 0))
    rms = np.repeat(rms.reshape(2, 2, -1).max(axis=1), 2, axis=0)
    d64 = np.clip(target / (rms + 1e-10), 0, mg)
    g64 = np.empty_like(d64)
    g64[:, 0] = d64[:, 0]
    for t in range(1, d64.shape[1]):
        a = np.where(d64[:, t] > g64[:, t - 1], a_att, a_rel)
        g64[:, t] = a * d64[:, t] + (1 - a) * g64[:, t - 1]
    np.testing.assert_array_equal(g[0], g[1])
    np.testing.assert_array_equal(g[2], g[3])
    np.testing.assert_allclose(g, g64, atol=2e-5)


def _ratio_cfg(**kw):
    base = dict(samplerate=44100, blocksize=512, upsample_factor=1,
                numtaps=33, batch=2, eq_enabled=False, agc_enabled=True,
                agc_mode="exact", agc_window_size=128, agc_carry=True,
                agc_target_level=0.1, agc_max_gain=2.0,
                agc_link_group=2, dither_kind="off", output_clip=0.99,
                # 'fast': tier mechanics tested elsewhere — and the 'hq'
                # default's longer cascade produced DENORMAL-magnitude conv
                # intermediates (≈1e-36) whose ×0.5 is no longer exact
                # (an odd-lsb subnormal halves with rounding), breaking the
                # bitwise ratio check at −700 dB — physically meaningless
                resample_quality="fast")
    base.update(kw)
    return StreamConfig(**base)


def _run_blocks(p, sig, seed=3):
    pp = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=seed)
    out = []
    for b in sig:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        out.append(np.asarray(y))
    return st, np.concatenate(out, axis=-1)


def _stereo_sig(rng, B, nb, block, quiet=0.5, amp=0.05):
    """nb blocks of B channels where each group's second row is exactly
    `quiet`× the first (a power of two: scaling commutes with every f32
    rounding, so a COMMON gain preserves the ratio bitwise — as long as the
    loud row never hits the ±0.99 output clip, a real nonlinearity)."""
    sig = (rng.normal(size=(nb, B, block)) * amp).astype(np.float32)
    sig[:, 1::2] = sig[:, 0::2] * quiet
    return sig


def test_pipeline_linked_preserves_image_xla_path(rng):
    """Full pipeline (XLA AGC path, fft conv): with the link, channel 1 ==
    0.5 × channel 0 bitwise (common gain, linear chain, power-of-two
    ratio); without it, the quiet channel is boosted harder and the
    inter-channel balance moves."""
    sig = _stereo_sig(rng, 2, 4, 512)
    _, y = _run_blocks(Pipeline(_ratio_cfg()), sig)
    np.testing.assert_array_equal(y[1], y[0] * np.float32(0.5))

    _, y_un = _run_blocks(Pipeline(_ratio_cfg(agc_link_group=1)), sig)
    assert np.max(np.abs(y_un[1] - y_un[0] * 0.5)) > 1e-3


def test_pipeline_linked_gain_state_equal_within_groups(rng):
    sig = _stereo_sig(rng, 4, 3, 512)
    st, _ = _run_blocks(Pipeline(_ratio_cfg(batch=4)), sig)
    g = np.asarray(st.agc_gain)
    np.testing.assert_array_equal(g[0], g[1])
    np.testing.assert_array_equal(g[2], g[3])


def test_pipeline_linked_fused_pallas_path(rng, monkeypatch):
    """The AGC recurrence kernel (interpret mode, the path the GPU takes)
    honors the link: ratio trick bitwise."""
    import afp.ops.pallas.agc_scan as agc_scan

    orig = agc_scan.smooth_gain_pallas
    monkeypatch.setattr(agc_scan, "smooth_gain_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    cfg = _ratio_cfg(batch=16, upsample_factor=2, eq_enabled=True,
                     conv_strategy="td_mxu", agc_window_size=256)
    p = Pipeline(cfg)
    p._agc_kernel = True
    # amp 0.02: EQ + AGC×2 headroom keeps the loud rows under the ±0.99
    # output clip (clipping is a real nonlinearity that breaks the ratio)
    sig = _stereo_sig(rng, 16, 3, 512, amp=0.02)
    _, y = _run_blocks(p, sig)
    assert np.max(np.abs(y)) < 0.99
    np.testing.assert_array_equal(y[1::2], y[0::2] * np.float32(0.5))


def test_ring_linked_matches_staged(rng, monkeypatch):
    """Serving-ring AGC chain with the link ≡ the staged step, bit-exact
    (the ring runs the step body; the group-min rides inside it)."""
    cfg = _ratio_cfg(batch=16, upsample_factor=2, eq_enabled=True,
                     conv_strategy="td_mxu", agc_window_size=256,
                     dither_kind="off")
    p = Pipeline(cfg)
    assert p.supports_ring_step
    sig = _stereo_sig(rng, 16, 3, 512, amp=0.02)
    pp = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=9)
    ref = []
    for b in sig:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    ring = jnp.asarray(sig)
    out_ring = jnp.zeros(sig.shape, jnp.float32)
    st2 = p.init_state(seed=9)
    for i in range(len(sig)):
        st2, out_ring = p._ring_step_impl(pp, st2, ring, i, out_ring)
        np.testing.assert_array_equal(np.asarray(out_ring)[i], ref[i])
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))


def test_config_validation_and_preset_exclusion(tmp_path):
    with pytest.raises(ValueError, match="agc_link_group"):
        StreamConfig(batch=3, agc_enabled=True, agc_link_group=2).validate()
    # AGC off: the link is inert, any batch validates
    StreamConfig(batch=3, agc_enabled=False, agc_link_group=2).validate()
    # negative/zero clamps to 1
    assert StreamConfig(agc_link_group=0).validate().agc_link_group == 1

    from afp.engine.presets import PresetStore

    store = PresetStore(str(tmp_path / "p.json"))
    cfg = StreamConfig(batch=2, agc_enabled=True, agc_link_group=2)
    store.save_preset("linked", cfg)
    assert "agc_link_group" not in store.get("linked")["settings"]
    # applying onto a mono deployment keeps its own (unlinked) layout
    out = store.load_preset("linked", StreamConfig(batch=1))
    assert out.agc_link_group == 1


def test_sharded_linked_matches_unsharded(rng):
    """Stream-DP with linked AGC: groups are shard-local (adjacent rows),
    so the sharded run must equal the single-device run bit-exactly."""
    import jax
    from jax.sharding import Mesh

    from afp.parallel.dp import ShardedPipeline

    devs = jax.devices()[:4]
    if len(devs) < 4:
        pytest.skip("needs 4 devices")
    cfg = _ratio_cfg(batch=8)
    sig = _stereo_sig(rng, 8, 3, 512)

    _, y_ref = _run_blocks(Pipeline(cfg), sig, seed=5)

    mesh = Mesh(np.asarray(devs), ("streams",))
    sp = ShardedPipeline(cfg, mesh)
    pp = sp.device_params(PipelineParams.design(sp.cfg))
    st = sp.init_state(seed=5)
    out = []
    for b in sig:
        st, y = sp.step(pp, st, jnp.asarray(b))
        out.append(np.asarray(y))
    y_sh = np.concatenate(out, axis=-1)
    # fft strategy: the batched FFT plan shifts ulps with batch size, the
    # suite-wide sharded-fft tolerance (test_parallel.py)
    np.testing.assert_allclose(y_sh, y_ref, atol=1e-6)
    # the link property itself is exact WITHIN the sharded run
    np.testing.assert_array_equal(y_sh[1::2], y_sh[0::2] * np.float32(0.5))


def test_filter_long_signal_linked_matches_streaming(rng):
    """Time-sharded long-signal mode (parallel/long.py) honors the link:
    the group-min rides between its sharded RMS front half and the
    shard-ordered recurrence, so output ≡ the streaming engine and the
    within-group image survives (an earlier version silently dropped
    the link)."""
    import jax
    from jax.sharding import Mesh

    from afp.parallel.long import filter_long_signal

    devs = jax.devices()[:8]
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    cfg = _ratio_cfg(upsample_factor=2, agc_window_size=256)
    p = Pipeline(cfg)
    params = p.device_params(PipelineParams.design(p.cfg))
    T = 8 * 1024
    sig = (rng.normal(size=(2, T)) * 0.05).astype(np.float32)
    sig[1] = np.float32(0.5) * sig[0]
    _, streamed = p.process_signal(params, p.init_state(), sig)

    tmesh = Mesh(np.asarray(devs), ("time",))
    sharded = np.asarray(filter_long_signal(p, params, sig, tmesh))
    np.testing.assert_allclose(sharded, np.asarray(streamed), atol=2e-5)
    # the link held exactly within the sharded run
    np.testing.assert_array_equal(sharded[1], sharded[0] * np.float32(0.5))
    # and the streaming reference itself is linked (guards the oracle)
    st = np.asarray(streamed)
    np.testing.assert_array_equal(st[1], st[0] * np.float32(0.5))
