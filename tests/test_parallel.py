"""Multi-chip-without-a-cluster tests (SURVEY.md §4 item 4): 8 virtual CPU
devices; sharded output must match single-device bit-for-bit (within fp32
scan-order tolerance)."""
import numpy as np
import pytest
import jax

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.parallel import ShardedPipeline, halo_convolve, make_mesh

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow



def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=8, filter_type="lowpass", cutoff=11000.0,
        eq_enabled=True, agc_enabled=False, downsample_mode="decimate",
        dither_kind="off", output_clip=None,
    )
    base.update(kw)
    return StreamConfig(**base)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return make_mesh(8, axis_names=("streams",))


def test_sharded_matches_single_device(rng, mesh):
    cfg = make_cfg(batch=8)
    # single-device reference
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    blocks = rng.normal(size=(8, cfg.blocksize)).astype(np.float32)
    _, gold = pipe.step(params, pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    sparams = sp.device_params(design)
    sstate = sp.init_state()
    sstate, out = sp.step(sparams, sstate, blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_run_multi_block(rng, mesh):
    cfg = make_cfg(batch=16)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    blocks = rng.normal(size=(3, 16, cfg.blocksize)).astype(np.float32)
    st = pipe.init_state()
    _, gold = pipe.run(params, st, blocks)

    sp = ShardedPipeline(cfg, mesh)
    sstate = sp.init_state()
    _, out = sp.run(sp.device_params(design), sstate, blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_td_mxu_matches_single_device(rng, mesh):
    """The HEADLINE execution strategy (td_mxu, interpret mode on CPU)
    sharded over 8 devices == single device."""
    cfg = make_cfg(batch=8, upsample_factor=4, numtaps=101,
                   conv_strategy="td_mxu")
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    blocks = rng.normal(size=(8, cfg.blocksize)).astype(np.float32) * 0.3
    _, gold = pipe.step(params, pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    sstate = sp.init_state()
    sstate, out = sp.step(sp.device_params(design), sstate, blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_td_mxu_pair_state_and_ingest(rng, mesh):
    """td_mxu sharded with pcm16 ingest: the f32 tail state shards
    structurally, and the raw int16 blocks run and agree with the
    single-device pipeline across multiple blocks (state carry included).
    (The bf16 pair ingest this once covered is gone.)"""
    cfg = make_cfg(batch=8, upsample_factor=4, numtaps=101,
                   conv_strategy="td_mxu", ingest="pcm16", eq_enabled=False)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    blocks = rng.integers(-20000, 20000, (3, 8, cfg.blocksize)
                          ).astype(np.int16)
    _, gold = pipe.run(params, pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    assert sp.init_state().conv_tail.dtype == np.float32
    _, out = sp.run(sp.device_params(design), sp.init_state(), blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_run_ring_matches_sharded_run(rng, mesh):
    """The serving loop sharded over 8 devices must match
    ShardedPipeline.run bit-exactly (the ring runs the same step body per
    shard), including the per-shard dither key schedule."""
    import jax.numpy as jnp

    cfg = make_cfg(batch=8, upsample_factor=4, numtaps=101,
                   conv_strategy="td_mxu", eq_enabled=False)
    for dither in ("off", "tpdf"):
        import dataclasses

        sp = ShardedPipeline(dataclasses.replace(cfg, dither_kind=dither),
                             mesh)
        assert sp.pipeline.supports_ring_step
        params = sp.device_params(PipelineParams.design(sp.cfg))
        K = 3
        blocks = jnp.asarray(rng.normal(size=(K, 8, cfg.blocksize))
                             .astype(np.float32) * 0.3)
        _, gold = sp.run(params, sp.init_state(seed=2), blocks)
        out_ring = jnp.zeros((K, 8, cfg.blocksize), jnp.float32)
        _, out_ring = sp.run_ring(params, sp.init_state(seed=2), blocks,
                                  out_ring, K)
        np.testing.assert_array_equal(np.asarray(out_ring), np.asarray(gold))


def test_sharded_f32_ring_matches_sharded_run(rng, mesh):
    """The f32 serving ring sharded over the mesh, with EQ and clip, must
    match ShardedPipeline.run bit-exactly."""
    import jax.numpy as jnp

    cfg = make_cfg(blocksize=256, upsample_factor=2, numtaps=65, batch=16,
                   conv_strategy="td_mxu", dither_kind="off",
                   eq_enabled=True, output_clip=0.9)
    sp = ShardedPipeline(cfg, mesh)
    assert sp.supports_ring_step
    params = sp.device_params(PipelineParams.design(sp.cfg))
    K = 3
    blocks = (rng.normal(size=(K, cfg.batch, cfg.blocksize)) * 0.3
              ).astype(np.float32)
    _, gold = sp.run(params, sp.init_state(seed=5), jnp.asarray(blocks))
    out = jnp.zeros((K, cfg.batch, cfg.blocksize), jnp.float32)
    _, out = sp.run_ring(params, sp.init_state(seed=5), jnp.asarray(blocks),
                         out, K)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(gold))


def test_sharded_agc_ring_matches_sharded_run(rng):
    """The AGC serving ring sharded over the mesh must match
    ShardedPipeline.run — the C8 serving mode multi-device.  Bit-exact:
    ring and staged paths share the step body and the per-shard key
    fold."""
    import jax.numpy as jnp
    cfg = make_cfg(
        blocksize=256, upsample_factor=2, numtaps=33, batch=16,
        eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=64, agc_carry=True, dither_kind="tpdf",
        output_clip=0.99, conv_strategy="td_mxu",
    )
    sp = ShardedPipeline(cfg, make_mesh(2, axis_names=("streams",)))
    assert sp.pipeline.supports_ring_step
    params = sp.device_params(PipelineParams.design(sp.cfg))
    K = 3
    blocks = (rng.normal(size=(K, cfg.batch, cfg.blocksize)) * 0.1
              ).astype(np.float32)
    st, gold = sp.run(params, sp.init_state(seed=5), jnp.asarray(blocks))

    out_ring = jnp.zeros((K, cfg.batch, cfg.blocksize), jnp.float32)
    st2, out_ring = sp.run_ring(params, sp.init_state(seed=5),
                                jnp.asarray(blocks), out_ring, K)
    np.testing.assert_array_equal(np.asarray(out_ring), np.asarray(gold))
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))


def test_sharded_dither_decorrelated(mesh):
    """Dither keys fold in the mesh position: shards must not emit identical
    noise."""
    cfg = make_cfg(batch=8, dither_kind="tpdf", eq_enabled=False,
                   upsample_factor=1)
    sp = ShardedPipeline(cfg, mesh)
    params = sp.device_params(PipelineParams.design(sp.cfg))
    blocks = np.zeros((8, cfg.blocksize), dtype=np.float32)
    _, out = sp.step(params, sp.init_state(), blocks)
    out = np.asarray(out)
    assert not np.allclose(out[0], out[1])


def test_batch_must_divide(mesh):
    with pytest.raises(ValueError):
        ShardedPipeline(make_cfg(batch=9), mesh)


def test_halo_convolve_matches_streaming(rng, mesh):
    """Time-sharded halo-exchange convolution == zero-primed causal conv."""
    tmesh = make_mesh(8, axis_names=("time",))
    N, T = 129, 8 * 1024
    h = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=T).astype(np.float32)
    out = np.asarray(halo_convolve(x, h, tmesh))
    gold = np.convolve(np.concatenate([np.zeros(N - 1), x.astype(np.float64)]),
                       h.astype(np.float64), mode="valid")
    assert out.shape == gold.shape
    assert np.max(np.abs(out - gold)) < 1e-4


def test_halo_convolve_batched(rng):
    tmesh = make_mesh(4, axis_names=("time",))
    h = rng.normal(size=65).astype(np.float32)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    out = np.asarray(halo_convolve(x, h, tmesh))
    for b in range(3):
        gold = np.convolve(np.concatenate([np.zeros(64), x[b].astype(np.float64)]),
                           h.astype(np.float64), mode="valid")
        assert np.max(np.abs(out[b] - gold)) < 1e-4


def test_filter_long_signal_matches_streaming(rng):
    """Time-sharded long-signal filtering == the streaming pipeline output."""
    from afp.parallel.long import filter_long_signal

    cfg = make_cfg(batch=1, upsample_factor=4, blocksize=512,
                   dither_kind="off")
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)

    T = 8 * 1024
    sig = (rng.normal(size=(1, T)) * 0.3).astype(np.float32)
    _, streamed = pipe.process_signal(params, pipe.init_state(), sig)

    tmesh = make_mesh(8, axis_names=("time",))
    sharded = filter_long_signal(pipe, params, sig, tmesh)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(streamed), atol=2e-5
    )


@pytest.mark.parametrize("carry", [True, False])
def test_filter_long_signal_agc_matches_streaming(rng, carry):
    """Long-signal mode now covers the full C8 chain: AGC's
    RMS/desired front half runs sharded, the smoothing recurrence hands the
    boundary gain shard-to-shard in mesh order (or stays block-local when
    agc_carry=False, the reference's per-block restart), and the output
    equals the streaming engine's."""
    from afp.parallel.long import filter_long_signal

    cfg = make_cfg(batch=2, upsample_factor=2, blocksize=512,
                   dither_kind="off", agc_enabled=True, agc_carry=carry,
                   agc_window_size=256)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)

    T = 8 * 1024  # 2 engine blocks per device on the 8-device mesh
    sig = (rng.normal(size=(2, T)) * 0.3).astype(np.float32)
    _, streamed = pipe.process_signal(params, pipe.init_state(), sig)

    tmesh = make_mesh(8, axis_names=("time",))
    sharded = filter_long_signal(pipe, params, sig, tmesh)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(streamed), atol=2e-5
    )


def test_filter_long_signal_agc_gain_clipping_matches_streaming(rng):
    """When the gain HITS the [0.1, max_gain] bounds, long-signal mode must
    still match streaming: the engine clips the smoothed gain per engine
    block and carries the CLIPPED value — an unclipped shard-wide carry
    diverges on the post-loud-passage recovery trajectory."""
    from afp.parallel.long import filter_long_signal

    cfg = make_cfg(batch=1, upsample_factor=2, blocksize=512,
                   dither_kind="off", agc_enabled=True, agc_carry=True,
                   agc_window_size=256, agc_target_level=0.05)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))

    T = 8 * 1024
    sig = (rng.normal(size=(1, T)) * 0.02).astype(np.float32)
    sig[:, T // 4 : T // 2] *= 200.0  # loud passage → desired gain < 0.1
    _, streamed = pipe.process_signal(params, pipe.init_state(), sig)

    tmesh = make_mesh(8, axis_names=("time",))
    sharded = filter_long_signal(pipe, params, sig, tmesh)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(streamed), atol=2e-5
    )


def test_filter_long_signal_agc_chunk_alignment(rng):
    """A per-device chunk that doesn't hold whole engine blocks is rejected
    (the per-block RMS centering is part of the reference semantics)."""
    from afp.parallel.long import filter_long_signal

    cfg = make_cfg(batch=1, blocksize=512, agc_enabled=True,
                   dither_kind="off")
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    tmesh = make_mesh(8, axis_names=("time",))
    sig = rng.normal(size=(1, 8 * 256)).astype(np.float32)  # 256 < blocksize
    with pytest.raises(ValueError, match="multiple of blocksize"):
        filter_long_signal(pipe, params, sig, tmesh)


def test_filter_long_signal_guards():
    from afp.parallel.long import filter_long_signal

    tmesh = make_mesh(4, axis_names=("time",))
    cfg = make_cfg(batch=1)
    import dataclasses

    pipe = Pipeline(dataclasses.replace(cfg, fuse_rate_conversion=False,
                                        upsample_factor=2))
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    with pytest.raises(ValueError):
        filter_long_signal(pipe, params, np.zeros((1, 4096), np.float32), tmesh)


def test_sharded_per_stream_gains(rng, mesh):
    """Per-stream gain banks shard on 'streams' and match the unsharded
    per-stream result."""
    from afp.engine.batch import with_per_stream_gains

    cfg = make_cfg(batch=8)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    gains = np.linspace(0.5, 2.0, 8 * 9).reshape(8, 9).astype(np.float32)
    psp = with_per_stream_gains(pipe, params, gains)
    blocks = rng.normal(size=(8, cfg.blocksize)).astype(np.float32)
    _, gold = pipe.step(psp, pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    # note: per-shard pipeline sees local [1, 9] gain banks automatically
    spp = sp.device_params(design)._replace(eq_gains=psp.eq_gains)
    _, out = sp.step(spp, sp.init_state(), blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_structural_specs_no_shape_coincidence(rng, mesh):
    """sharding specs must be structural, not
    shape-matched.  batch == 2 (the PRNG key's length) and a resampler
    whose kernel length could equal the batch must both still work.
    The mesh has 8 devices, so shard a batch-16 config but check the spec
    tree directly for the hazard cases."""
    from jax.sharding import PartitionSpec as P

    from afp.parallel.dp import _param_spec_tree, _state_spec

    # a pipeline whose state includes a resampler (literal multirate chain)
    cfg = make_cfg(batch=2, fuse_rate_conversion=False)
    pipe = Pipeline(cfg)
    state = pipe.init_state()
    spec = _state_spec(state)
    # the key leaf is the [n_shards] pre-folded per-shard key vector —
    # sharded on 'streams' STRUCTURALLY (one key per shard), never because
    # a key's shape happens to match the batch
    assert spec.key == P("streams")
    assert spec.conv_tail == P("streams", None)
    assert spec.up is not None and spec.up.h == P()  # shared kernel replicates
    assert spec.up.hist == P("streams", None)

    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    pspec = _param_spec_tree(params)
    assert pspec.H_bands == P() and pspec.eq_gains == P()

    # per-stream gain banks ([B, n_bands], structurally 2-D) shard
    import jax.numpy as jnp

    params2 = params._replace(
        eq_gains=jnp.ones((2, params.eq_gains.shape[0]), jnp.float32)
    )
    assert _param_spec_tree(params2).eq_gains == P("streams", None)


def test_sharded_multirate_chain_matches_single_device(rng, mesh):
    """End-to-end sharded equivalence for the literal (unfused) multirate
    chain — exercises the structural resampler specs on all 8 devices."""
    cfg = make_cfg(batch=8, fuse_rate_conversion=False)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    blocks = rng.normal(size=(8, cfg.blocksize)).astype(np.float32)
    _, gold = pipe.step(pipe.device_params(design), pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    sstate = sp.init_state()
    _, out = sp.step(sp.device_params(design), sstate, blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_kernel_parallel_conv_matches_overlap_save(rng):
    """SURVEY §2.4 TP axis: a long FIR sharded over 8
    devices streams exactly like the single-device full-kernel conv."""
    from afp.ops.convolve import OverlapSave
    from afp.parallel.kp import KernelParallelConv

    N, L, B, nblocks = 1000, 512, 3, 6
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=(B, L * nblocks)).astype(np.float32)
    mesh = make_mesh(8, axis_names=("kernel",))

    kp = KernelParallelConv(h, block=L, mesh=mesh, batch=B)
    ref = OverlapSave.init(h, block=L, batch_shape=(B,))
    st = kp.init_state()
    for b in range(nblocks):
        blk = sig[:, b * L : (b + 1) * L]
        st, y = kp.step(st, blk)
        ref, gold = ref.process(blk)
        np.testing.assert_allclose(np.asarray(y), np.asarray(gold),
                                   atol=2e-4, rtol=1e-5)


def test_kernel_parallel_swap_and_ragged_length(rng):
    from afp.parallel.kp import KernelParallelConv
    from afp.ops.convolve import OverlapSave

    mesh = make_mesh(8, axis_names=("kernel",))
    h1 = rng.normal(size=777).astype(np.float32)  # not divisible by 8
    h2 = rng.normal(size=770).astype(np.float32)
    sig = rng.normal(size=(2, 256 * 6)).astype(np.float32)
    kp = KernelParallelConv(h1, block=256, mesh=mesh, batch=2)
    st = kp.init_state()
    st, _ = kp.step(st, sig[:, :256])
    kp2 = kp.with_kernel(h2)  # glitch-free swap (shapes preserved)
    # the delay FIFOs carry old-kernel partials for (D−1)·C samples; once
    # they flush, output equals the h2 convolution of the full input stream
    ref = OverlapSave.init(h2, block=256, batch_shape=(2,))
    ref, _ = ref.process(sig[:, :256])
    # transient spans samples 256..256+686=942 → fully flushed by block 4
    y = gold = None
    for b in range(1, 6):
        st, y = kp2.step(st, sig[:, b * 256 : (b + 1) * 256])
        ref, gold = ref.process(sig[:, b * 256 : (b + 1) * 256])
    np.testing.assert_allclose(np.asarray(y), np.asarray(gold),
                               atol=2e-4, rtol=1e-5)
    with pytest.raises(ValueError):
        kp.with_kernel(np.zeros(5000, np.float32))


def test_sharded_per_stream_filter_banks(rng, mesh):
    """Per-stream KERNEL banks ([B, F] H_main) shard on 'streams' and match
    the unsharded pipeline."""
    from afp.engine.batch import with_per_stream_filters

    cfg = make_cfg(batch=8, eq_enabled=False)
    pipe = Pipeline(cfg)
    variants = [dict(cutoff=2000.0 * (i + 1)) for i in range(8)]
    bank = with_per_stream_filters(pipe, variants)
    blocks = rng.normal(size=(8, cfg.blocksize)).astype(np.float32)
    _, gold = pipe.step(bank, pipe.init_state(), blocks)

    sp = ShardedPipeline(cfg, mesh)
    # the bank is built at GLOBAL batch; the structural spec shards its
    # [B_global, F] H_main over 'streams'
    _, out = sp.step(bank, sp.init_state(), blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_state_spec_pair_tail():
    """_state_spec tags the single f32 overlap tail and per-stream state
    structurally (the bf16 pair tail it once mirrored is gone)."""
    import jax.numpy as jnp

    from jax.sharding import PartitionSpec as P

    from afp.engine.pipeline import StreamState
    from afp.parallel.dp import _state_spec

    st = StreamState(asrc=None, up=None, conv_tail=jnp.zeros((4, 8)),
                     down=None, agc_gain=jnp.ones(4), key=None, wf=None)
    spec = _state_spec(st)
    assert spec.conv_tail == P("streams", None)
    assert spec.agc_gain == P("streams")


def test_filter_long_signal_2d_mesh_matches_streaming(rng):
    """Combined stream-DP × context parallelism: a 2×4 (streams × time)
    mesh shards the batch rows AND the time axis in one pass — output ≡
    the streaming engine, with AGC carry + the stereo link (groups
    shard-local) and per-stream gain banks sharding with their rows."""
    from afp.engine.batch import with_per_stream_gains
    from afp.parallel.long import filter_long_signal

    # max_gain 2 keeps the loud rows under the ±0.99 clips — a biting clip
    # is a real nonlinearity that would break the bitwise ratio check
    cfg = make_cfg(batch=4, upsample_factor=2, blocksize=512,
                   dither_kind="off", agc_enabled=True, agc_carry=True,
                   agc_window_size=256, agc_link_group=2, agc_max_gain=2.0,
                   output_clip=0.99)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    gains = np.ones((4, params.eq_gains.shape[-1]), np.float32)
    gains[2:] *= 0.7
    params = with_per_stream_gains(pipe, params, gains)

    T = 8 * 1024
    sig = (rng.normal(size=(4, T)) * 0.05).astype(np.float32)
    sig[1::2] = np.float32(0.5) * sig[0::2]
    _, streamed = pipe.process_signal(params, pipe.init_state(), sig)

    mesh2d = make_mesh(8, axis_names=("streams", "time"), shape=(2, 4))
    sharded = np.asarray(filter_long_signal(pipe, params, sig, mesh2d))
    np.testing.assert_allclose(sharded, np.asarray(streamed), atol=2e-5)
    # the link held exactly inside the 2-D sharded run
    np.testing.assert_array_equal(sharded[1::2],
                                  sharded[0::2] * np.float32(0.5))

    # shard-straddling link groups are rejected, not silently broken
    bad = make_cfg(batch=2, blocksize=512, agc_enabled=True,
                   agc_link_group=2, dither_kind="off")
    bpipe = Pipeline(bad)
    bparams = bpipe.device_params(PipelineParams.design(bpipe.cfg))
    with pytest.raises(ValueError, match="shard-local"):
        filter_long_signal(bpipe, bparams,
                           (rng.normal(size=(2, T)) * 0.05).astype(np.float32),
                           mesh2d)


def test_halo_convolve_2d_mesh(rng):
    """halo_convolve on the 2-D mesh: rows shard over 'streams', the halo
    ppermute rides the 'time' axis — matches the time-only-mesh result
    bitwise, incl. per-stream [B, N] kernels; indivisible batch rejected."""
    mesh2d = make_mesh(8, axis_names=("streams", "time"), shape=(2, 4))
    tmesh = make_mesh(4, axis_names=("time",))
    x = (rng.normal(size=(4, 4096)) * 0.3).astype(np.float32)
    h = (rng.normal(size=65) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(halo_convolve(x, h, mesh2d)),
        np.asarray(halo_convolve(x, h, tmesh)))
    hb = (rng.normal(size=(4, 65)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(halo_convolve(x, hb, mesh2d)),
        np.asarray(halo_convolve(x, hb, tmesh)))
    with pytest.raises(ValueError, match="divide over"):
        halo_convolve(x[:3], h, mesh2d)


def test_halo_2d_mesh_mono_replicates(rng):
    """A mono ([T] or [1, T]) signal on a 2-D (streams × time) mesh
    replicates the row instead of failing divisibility — the documented
    1-D input keeps working; halo_convolve_sharded pre-places with the
    same spec halo_convolve shard_maps with (no silent reshard)."""
    from afp.parallel import halo_convolve_sharded
    from afp.parallel.long import filter_long_signal

    mesh2d = make_mesh(8, axis_names=("streams", "time"), shape=(2, 4))
    tmesh = make_mesh(4, axis_names=("time",))
    x = (rng.normal(size=4096) * 0.3).astype(np.float32)
    h = (rng.normal(size=65) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(halo_convolve(x, h, mesh2d)),
        np.asarray(halo_convolve(x, h, tmesh)))
    np.testing.assert_array_equal(
        np.asarray(halo_convolve_sharded(x[None], h, mesh2d)),
        np.asarray(halo_convolve(x, h, tmesh))[None])
    # 2-row batch pre-placed sharded: matches the unsharded-entry result
    x2 = (rng.normal(size=(2, 4096)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(halo_convolve_sharded(x2, h, mesh2d)),
        np.asarray(halo_convolve(x2, h, tmesh)))

    cfg = make_cfg(batch=1, upsample_factor=2, blocksize=512,
                   dither_kind="off", agc_enabled=True, agc_carry=True,
                   agc_window_size=256, agc_max_gain=2.0)
    pipe = Pipeline(cfg)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = (rng.normal(size=8 * 1024) * 0.05).astype(np.float32)
    _, streamed = pipe.process_signal(params, pipe.init_state(), sig[None])
    mono = np.asarray(filter_long_signal(pipe, params, sig, mesh2d))
    np.testing.assert_allclose(mono, np.asarray(streamed)[0], atol=2e-5)


# ---------------- multi-slice (DCN) data parallelism, SURVEY §5.8 ----------


_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "all-to-all", "reduce-scatter", "collective-broadcast")


def test_multislice_mesh_shape():
    """The multi-slice mesh builder is gone; stream DP over a 1-D mesh
    of any size is the multi-device shape."""
    import afp.parallel as par

    assert not hasattr(par, "make_multislice_mesh")
    m = make_mesh(8, axis_names=("streams",))
    assert m.axis_names == ("streams",) and m.shape["streams"] == 8


def test_multislice_step_matches_and_zero_collectives(rng):
    """The 8-device stream-DP step (AGC + dither) compiles to ZERO
    collectives and equals the 2-device mesh bitwise on the shared rows'
    math (per-shard key folds differ, so dither is off)."""
    cfg = make_cfg(batch=16, agc_enabled=True, agc_window_size=128,
                   dither_kind="off")
    design = PipelineParams.design(cfg.validate())
    blocks = (rng.normal(size=(16, cfg.blocksize)) * 0.3).astype(np.float32)

    sp1 = ShardedPipeline(cfg, make_mesh(2, axis_names=("streams",)))
    st1, out1 = sp1.step(sp1.device_params(design), sp1.init_state(seed=3),
                         blocks)
    sp2 = ShardedPipeline(cfg, make_mesh(8, axis_names=("streams",)))
    params2 = sp2.device_params(design)
    state2 = sp2.init_state(seed=3)
    step, _ = sp2._get_exec(params2)
    hlo = step.lower(params2, state2, blocks).compile().as_text()
    for op in _COLLECTIVES:
        assert op not in hlo, f"stream-DP step lowered a '{op}'"
    st2, out2 = step(params2, state2, blocks)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out1), atol=1e-6)


def test_multislice_ring_and_signal_zero_collectives(rng):
    """The serving ring and the offline fold under an 8-device stream mesh:
    the compiled serving executable stays collective-free, and the fold
    matches the sharded scan."""
    import jax.numpy as jnp

    cfg = make_cfg(batch=16, eq_enabled=False, conv_strategy="td_mxu",
                   upsample_factor=2, numtaps=33)
    design = PipelineParams.design(cfg.validate())
    blocks = (rng.normal(size=(2, 16, cfg.blocksize)) * 0.3
              ).astype(np.float32)
    ring = jnp.asarray(blocks)
    sp = ShardedPipeline(cfg, make_mesh(8, axis_names=("streams",)))
    p = sp.device_params(design)
    out = jnp.zeros(blocks.shape, jnp.float32)
    _, out = sp.run_ring(p, sp.init_state(seed=1), ring, out, 2)
    exe = sp._exec_cache[[k for k in sp._exec_cache if k[0] == "ring"][0]]
    hlo = exe.lower(p, sp.init_state(seed=1), ring,
                    jnp.zeros(blocks.shape, jnp.float32),
                    jnp.asarray(0, jnp.int32)).compile().as_text()
    for op in _COLLECTIVES:
        assert op not in hlo, f"stream-DP serving ring lowered a '{op}'"
    sig = (rng.normal(size=(16, 3 * cfg.blocksize)) * 0.3).astype(np.float32)
    _, y1 = sp.process_signal(p, sp.init_state(seed=2), sig, fold=False)
    _, y2 = sp.process_signal(p, sp.init_state(seed=2), sig, fold=True)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y1), atol=1e-5)


def test_sharded_td_banked_filter_banks(rng, mesh):
    """Per-stream filter banks on a td_mxu config under stream-DP: the
    [B, F] bank shards with its rows, and the sharded step matches the
    single-device pipeline."""
    from afp.engine.batch import with_per_stream_filters

    cfg = make_cfg(batch=16, eq_enabled=False, conv_strategy="td_mxu",
                   upsample_factor=2, numtaps=33)
    pipe = Pipeline(cfg)
    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    bank = with_per_stream_filters(pipe, variants)
    blocks = (rng.normal(size=(16, cfg.blocksize)) * 0.3).astype(np.float32)
    _, gold = pipe.step(bank, pipe.init_state(seed=1), blocks)

    sp = ShardedPipeline(cfg, make_mesh(2, axis_names=("streams",)))
    _, out = sp.step(bank, sp.init_state(seed=1), blocks)
    np.testing.assert_allclose(np.asarray(out), np.asarray(gold), atol=1e-6)


def test_sharded_td_banked_ring(rng, mesh):
    """Per-stream filter banks through the SHARDED serving ring: the bank
    shards with its rows and the ring matches the sharded staged steps."""
    import jax.numpy as jnp

    from afp.engine.batch import with_per_stream_filters

    cfg = make_cfg(batch=16, eq_enabled=False, conv_strategy="td_mxu",
                   upsample_factor=2, numtaps=33)
    pipe = Pipeline(cfg)
    bank = with_per_stream_filters(
        pipe, [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)])
    blocks = (rng.normal(size=(2, 16, cfg.blocksize)) * 0.3
              ).astype(np.float32)

    sp = ShardedPipeline(cfg, make_mesh(2, axis_names=("streams",)))
    st = sp.init_state(seed=1)
    ref = []
    for b in blocks:
        st, y = sp.step(bank, st, b)
        ref.append(np.asarray(y))

    ring = jnp.asarray(blocks)
    out = jnp.zeros(blocks.shape, jnp.float32)
    st2, out = sp.run_ring(bank, sp.init_state(seed=1), ring, out, 2)
    for i in range(2):
        np.testing.assert_allclose(np.asarray(out)[i], ref[i], atol=1e-6)
