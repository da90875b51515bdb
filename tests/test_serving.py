"""RingServer (serving-ring host pump) tests: ordered,
bit-exact equivalence with the classic scan path, tail handling, and
constructor validation."""
import numpy as np
import pytest

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.runtime import RingServer

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
        batch=2, filter_type="lowpass", cutoff=11000.0,
        window_type="hamming", eq_enabled=False, agc_enabled=False,
        downsample_mode="decimate", dither_kind="tpdf", output_clip=None,
        conv_strategy="td_mxu", ingest="f32",
    )
    base.update(kw)
    return StreamConfig(**base)


def test_ring_server_matches_run(rng):
    """Streaming N blocks (N not a multiple of chunk → short final
    dispatch) through RingServer must be bit-identical to Pipeline.run
    over the same blocks — same outputs, same dither key schedule, same
    carried tail."""
    import jax.numpy as jnp

    cfg = make_cfg()
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n = 7  # 2 full chunks of 2 + one 1-block tail at slots=8, chunk=2
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)

    st, gold = pipe.run(params, pipe.init_state(seed=5),
                        jnp.asarray(blocks))

    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=5)
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == n and srv.blocks_served == n
    np.testing.assert_array_equal(np.stack(outs), np.asarray(gold))
    # carried state matches the classic path bit-for-bit
    np.testing.assert_array_equal(np.asarray(st.conv_tail),
                                  np.asarray(srv.state.conv_tail))
    np.testing.assert_array_equal(np.asarray(st.key),
                                  np.asarray(srv.state.key))


def test_ring_server_pair_source_and_serve_metrics(rng):
    """A source of device-resident blocks is accepted (the bf16 pair
    source this once covered is gone); serve() reports block count and a
    finite xRT."""
    import jax.numpy as jnp

    cfg = make_cfg(dither_kind="off")
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n = 4
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    _, gold = pipe.run(params, pipe.init_state(),
                       jnp.asarray(blocks))

    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=1)
    dev_src = (jnp.asarray(b) for b in blocks)
    got = []
    m = srv.serve(dev_src, got.append)
    assert m["blocks"] == n and np.isfinite(m["xrt"]) and m["xrt"] > 0
    np.testing.assert_array_equal(np.stack(got), np.asarray(gold))
    lat = m["latency"]
    assert lat["n"] == n and 0 < lat["p50_ms"] <= lat["max_ms"]
    assert lat["p50_ms"] <= lat["p95_ms"] <= lat["max_ms"]


def test_ring_server_f32_conv_ring_matches_run(rng):
    """RingServer over the f32 ring (no AGC — the reference's f32 input
    contract) must be bit-identical to Pipeline.run."""
    import jax.numpy as jnp

    cfg = make_cfg(ingest="f32", upsample_factor=2, numtaps=65,
                   eq_enabled=True, output_clip=0.9, dither_kind="off")
    pipe = Pipeline(cfg)
    assert pipe.supports_ring_step
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n = 7
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    st, gold = pipe.run(params, pipe.init_state(seed=3),
                        jnp.asarray(blocks))
    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=3)
    assert not srv.pcm16
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == n
    np.testing.assert_array_equal(np.stack(outs), np.asarray(gold))
    np.testing.assert_array_equal(np.asarray(srv.state.conv_tail),
                                  np.asarray(st.conv_tail))


def test_ring_server_agc_chain_matches_run(rng, monkeypatch):
    """RingServer over the AGC chain (f32 ring) must be bit-identical to
    Pipeline.run — the C8 serving mode."""
    import jax.numpy as jnp
    cfg = make_cfg(
        ingest="f32", blocksize=256, upsample_factor=2, numtaps=33,
        batch=16, eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=64, agc_carry=True, dither_kind="tpdf",
        output_clip=0.99,
    )
    pipe = Pipeline(cfg)
    assert pipe.supports_ring_step
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n = 5
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.1
              ).astype(np.float32)
    st, gold = pipe.run(params, pipe.init_state(seed=4),
                        jnp.asarray(blocks))

    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=4)
    outs = list(srv.stream(iter(blocks)))
    np.testing.assert_array_equal(np.stack(outs), np.asarray(gold))
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(srv.state.agc_gain))


def test_ring_server_sharded_pipeline(rng):
    """RingServer drives a ShardedPipeline unchanged (the multi-chip
    serving surface): rings placed with the published ring_sharding,
    outputs and carried tail bit-identical to ShardedPipeline.run —
    including the per-shard dither key folds."""
    import jax.numpy as jnp
    from afp.parallel import ShardedPipeline, make_mesh

    cfg = make_cfg(batch=4)
    sp = ShardedPipeline(cfg, make_mesh(2, axis_names=("streams",)))
    params = sp.device_params(PipelineParams.design(sp.cfg))
    n = 5
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    st, gold = sp.run(params, sp.init_state(seed=5),
                      jnp.asarray(blocks))
    srv = RingServer(sp, params, slots=8, chunk=2, max_inflight=2, seed=5)
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == n
    np.testing.assert_array_equal(np.stack(outs), np.asarray(gold))
    np.testing.assert_array_equal(np.asarray(st.conv_tail),
                                  np.asarray(srv.state.conv_tail))



def test_ring_server_validation():
    cfg = make_cfg()
    pipe = Pipeline(cfg)
    with pytest.raises(ValueError, match="divide"):
        RingServer(pipe, slots=8, chunk=3)
    with pytest.raises(ValueError, match="undrained"):
        RingServer(pipe, slots=8, chunk=4, max_inflight=2)
    wf = Pipeline(make_cfg(dither_kind="off", conv_strategy="fft",
                           waterfall_enabled=True))
    with pytest.raises(ValueError, match="ring-capable"):
        RingServer(wf)


# ---------------------------------------------------------------- live reconfig


def test_swap_params_mid_stream(rng):
    """`swap_params` mid-stream: chunk-boundary atomic
    transition with ZERO dropped or blended blocks — pre-swap blocks
    bit-match a params-A run, post-swap blocks bit-match a params-B
    continuation (the carried conv tail is pure input history, so the
    transition is exact), and the dither key walk is unbroken."""
    import dataclasses

    import jax.numpy as jnp

    cfg = make_cfg()  # tpdf: the key walk is covered too
    pipe = Pipeline(cfg)
    pa = pipe.device_params(PipelineParams.design(pipe.cfg))
    cfg_b = dataclasses.replace(cfg, cutoff=5500.0,
                                window_type="blackman").validate()
    pb = pipe.device_params(PipelineParams.design(cfg_b), cfg=cfg_b)
    n, swap_at = 8, 4  # a chunk boundary at chunk=2
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    st_a, gold_a = pipe.run(pa, pipe.init_state(seed=5),
                            jnp.asarray(blocks[:swap_at]))
    st_b, gold_b = pipe.run(pb, st_a,
                            jnp.asarray(blocks[swap_at:]))
    # the two banks genuinely differ — the transition assertion means something
    _, cont_a = pipe.run(pa, st_a, jnp.asarray(blocks[swap_at:]))
    assert not np.array_equal(np.asarray(gold_b), np.asarray(cont_a))

    srv = RingServer(pipe, pa, slots=8, chunk=2, max_inflight=2, seed=5)

    def src():
        for i, b in enumerate(blocks):
            if i == swap_at:
                srv.swap_params(pb)
            yield b

    outs = list(srv.stream(src()))
    assert len(outs) == n and srv.blocks_served == n
    assert srv._swap_at_block == swap_at
    np.testing.assert_array_equal(np.stack(outs[:swap_at]),
                                  np.asarray(gold_a))
    np.testing.assert_array_equal(np.stack(outs[swap_at:]),
                                  np.asarray(gold_b))
    np.testing.assert_array_equal(np.asarray(st_b.key),
                                  np.asarray(srv.state.key))
    np.testing.assert_array_equal(np.asarray(st_b.conv_tail),
                                  np.asarray(srv.state.conv_tail))


def test_swap_params_mid_chunk_applies_at_chunk_start(rng):
    """A swap issued MID-chunk (while the chunk is still landing) applies to
    the whole enclosing chunk — every block of a dispatch runs one bank
    (the atomicity contract: never mid-chunk, never blended)."""
    import dataclasses

    import jax.numpy as jnp

    cfg = make_cfg()
    pipe = Pipeline(cfg)
    pa = pipe.device_params(PipelineParams.design(pipe.cfg))
    cfg_b = dataclasses.replace(cfg, cutoff=5500.0).validate()
    pb = pipe.device_params(PipelineParams.design(cfg_b), cfg=cfg_b)
    n, swap_at = 8, 5  # mid-chunk: the enclosing chunk starts at block 4
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    st_a, gold_a = pipe.run(pa, pipe.init_state(seed=5),
                            jnp.asarray(blocks[:4]))
    _, gold_b = pipe.run(pb, st_a, jnp.asarray(blocks[4:]))

    srv = RingServer(pipe, pa, slots=8, chunk=2, max_inflight=2, seed=5)

    def src():
        for i, b in enumerate(blocks):
            if i == swap_at:
                srv.swap_params(pb)
            yield b

    outs = list(srv.stream(src()))
    assert srv._swap_at_block == swap_at
    np.testing.assert_array_equal(np.stack(outs[:4]), np.asarray(gold_a))
    np.testing.assert_array_equal(np.stack(outs[4:]), np.asarray(gold_b))


def test_set_eq_gains_mid_stream(rng):
    """Gain-only live update on the serving rings: runtime data, no
    redesign, same chunk-boundary atomicity."""
    import jax.numpy as jnp

    cfg = make_cfg(ingest="f32", eq_enabled=True, dither_kind="off")
    pipe = Pipeline(cfg)
    pa = pipe.device_params(PipelineParams.design(pipe.cfg))
    g1 = np.asarray([1.5, 0.25, 0.8], dtype=np.float32)[
        : pa.eq_gains.shape[0]]
    if g1.shape[0] != pa.eq_gains.shape[0]:
        g1 = np.linspace(0.2, 1.8, pa.eq_gains.shape[0]).astype(np.float32)
    pb = pa._replace(eq_gains=jnp.asarray(g1))
    n, swap_at = 6, 2
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.4
              ).astype(np.float32)
    st_a, gold_a = pipe.run(pa, pipe.init_state(seed=2),
                            jnp.asarray(blocks[:swap_at]))
    _, gold_b = pipe.run(pb, st_a, jnp.asarray(blocks[swap_at:]))

    srv = RingServer(pipe, pa, slots=8, chunk=2, max_inflight=2, seed=2)

    def src():
        for i, b in enumerate(blocks):
            if i == swap_at:
                srv.set_eq_gains(g1)
            yield b

    outs = list(srv.stream(src()))
    np.testing.assert_array_equal(np.stack(outs[:swap_at]),
                                  np.asarray(gold_a))
    np.testing.assert_array_equal(np.stack(outs[swap_at:]),
                                  np.asarray(gold_b))

    with pytest.raises(ValueError, match="band count"):
        srv.set_eq_gains(np.ones(pa.eq_gains.shape[0] + 1, np.float32))


def test_retune_agc_chain_mid_stream(rng, monkeypatch):
    """`retune` on the AGC serving chain: the new AGC policy (and
    filter design) is designed off-thread and takes effect at the next
    chunk — bit-identical to a params-B continuation run."""
    import dataclasses

    import jax.numpy as jnp

    from afp.ops.agc import AGCParams
    cfg = make_cfg(
        ingest="f32", blocksize=256, upsample_factor=2, numtaps=33,
        batch=16, eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=64, agc_carry=True, dither_kind="tpdf",
        output_clip=0.99,
    )
    pipe = Pipeline(cfg)
    assert pipe.supports_ring_step
    pa = pipe.device_params(PipelineParams.design(pipe.cfg))
    cfg_b = dataclasses.replace(cfg, agc_target_level=0.5, cutoff=6000.0,
                                agc_release=0.05).validate()
    agc_b = AGCParams(target_level=cfg_b.agc_target_level,
                      window_size=cfg_b.agc_window_size,
                      max_gain=cfg_b.agc_max_gain,
                      attack=cfg_b.agc_attack, release=cfg_b.agc_release)
    pb = pipe.device_params(PipelineParams.design(cfg_b), cfg=cfg_b,
                            agc=agc_b)
    n, swap_at = 6, 2
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.1
              ).astype(np.float32)
    st_a, gold_a = pipe.run(pa, pipe.init_state(seed=4),
                            jnp.asarray(blocks[:swap_at]))
    _, gold_b = pipe.run(pb, st_a, jnp.asarray(blocks[swap_at:]))

    srv = RingServer(pipe, pa, slots=8, chunk=2, max_inflight=2, seed=4)

    def src():
        for i, b in enumerate(blocks):
            if i == swap_at:
                srv.retune(cfg_b)
            yield b

    outs = list(srv.stream(src()))
    np.testing.assert_array_equal(np.stack(outs[:swap_at]),
                                  np.asarray(gold_a))
    np.testing.assert_array_equal(np.stack(outs[swap_at:]),
                                  np.asarray(gold_b))

    # static (shape) changes are rejected
    with pytest.raises(ValueError, match="static"):
        srv.retune(dataclasses.replace(cfg, blocksize=512))


def test_swap_params_validation():
    """Shape/dtype/structure changes are rejected with guidance — swaps
    must never trigger a recompile."""
    cfg = make_cfg()
    pipe = Pipeline(cfg)
    srv = RingServer(pipe, slots=8, chunk=2)
    other = Pipeline(make_cfg(numtaps=33))
    bad = other.device_params(PipelineParams.design(other.cfg))
    with pytest.raises(ValueError, match="shape"):
        srv.swap_params(bad)

    # a per-stream filter bank turns H_main into a [B, F] bank: a shape
    # change, rejected
    from afp.engine.batch import with_per_stream_filters

    fsrv = RingServer(Pipeline(make_cfg()), slots=8, chunk=2)
    banked = with_per_stream_filters(fsrv.pipe, [{}] * fsrv.pipe.batch)
    with pytest.raises(ValueError, match="shape"):
        fsrv.swap_params(banked)
    # structural change: the fft strategy's params carry no cascade taps
    fft = Pipeline(make_cfg(conv_strategy="fft"))
    with pytest.raises(ValueError, match="presence"):
        fsrv.swap_params(fft.device_params(PipelineParams.design(fft.cfg)))


# ---------------------------------------------------------------- spectrum tap


def test_ring_server_spectrum_tap(rng):
    """`spectrum_every=N`: every Nth drained block lands a
    host-FFT dB spectrum in the server's depth-50 ring (newest-last) and
    the peak readout — while outputs stay bit-identical to an untapped
    server (the tap rides the drain, not the device)."""
    from afp.ops.spectrum import spectrum_db_np

    cfg = make_cfg(ingest="f32", dither_kind="off")
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    n = 6
    blocks = (rng.normal(size=(n, cfg.batch, cfg.blocksize)) * 0.3
              ).astype(np.float32)
    plain = RingServer(pipe, params, slots=8, chunk=2, seed=1)
    gold = list(plain.stream(iter(blocks)))
    srv = RingServer(pipe, params, slots=8, chunk=2, seed=1,
                     spectrum_every=2, spectrum_row=1)
    seen = []
    srv.spectrum_sink = lambda blk: seen.append(blk.copy())
    outs = list(srv.stream(iter(blocks)))
    np.testing.assert_array_equal(np.stack(outs), np.stack(gold))
    # blocks 0, 2, 4 observed; ring newest-last = spectrum of block 4 row 1
    assert len(seen) == 3
    assert srv.waterfall_ring is not None and srv.waterfall_ring.shape[0] == 50
    np.testing.assert_allclose(
        srv.waterfall_ring[-1], spectrum_db_np(np.asarray(outs[4][1])),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(seen[-1], np.asarray(outs[4]))
    f, lvl = srv.spectrum_peak
    assert 0 <= f <= cfg.samplerate / 2 and np.isfinite(lvl)
    assert srv.last_spectrum.shape == (cfg.blocksize // 2 + 1,)


def test_controller_ring_stream_waterfall(rng, tmp_path):
    """GUI hookup: the controller serves through a RingServer while its
    live spectrum overlay + waterfall render from the serving drain."""
    import time

    from afp.ui.controller import EqualizerController
    from afp.engine import StreamEngine

    cfg = make_cfg(ingest="f32", dither_kind="off")
    pipe = Pipeline(cfg)
    srv = RingServer(pipe, slots=8, chunk=2)
    ctrl = EqualizerController(StreamEngine(cfg))
    blocks = [(rng.normal(size=(cfg.batch, cfg.blocksize)) * 0.3
               ).astype(np.float32) for _ in range(6)]
    got = []
    ctrl.start_ring_stream(srv, iter(blocks), sink=got.append,
                           spectrum_every=2)
    assert ctrl.streaming
    for _ in range(200):
        if len(got) == 6:
            break
        time.sleep(0.1)
    ctrl.stop_stream(timeout=30.0)
    assert len(got) == 6 and not ctrl.streaming
    assert ctrl.waterfall_ring is not None
    fig = ctrl.waterfall(save_path=str(tmp_path / "wf.png"))
    assert fig is not None and (tmp_path / "wf.png").exists()
    assert ctrl.spectrum_peak is not None


def test_spectrum_row_out_of_range_rejected():
    pipe = Pipeline(make_cfg(ingest="f32", dither_kind="off"))
    with pytest.raises(ValueError, match="spectrum_row"):
        RingServer(pipe, slots=8, chunk=2, spectrum_every=2,
                   spectrum_row=pipe.batch)
