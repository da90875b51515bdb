"""int16 PCM ingest (``StreamConfig.ingest='pcm16'``): raw int16 blocks ride
host rings and the device serving rings; the step converts at device entry
(n/32768, exact — `ops/pcm16.py`).  Outputs must be BIT-IDENTICAL to
feeding the same n/32768 floats through ``ingest='f32'`` — pcm16 changes
the bytes moved, never the math.

The int16 full-scale convention (n → n/32768) matches the reference's WAV
path (`reference/stream_process.py:56-66` reads PCM via soundfile,
which applies the same scaling) and PortAudio's int16 sample format.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.engine.engine import StreamEngine
from afp.ops.pcm16 import PCM16_SCALE


def make_cfg(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=4, filter_type="lowpass", cutoff=11000.0,
        eq_enabled=True, agc_enabled=False, downsample_mode="decimate",
        dither_kind="off", output_clip=0.8, conv_strategy="td_mxu",
        ingest="pcm16",
    )
    base.update(kw)
    return StreamConfig(**base).validate()


def i16_blocks(rng, shape):
    return rng.integers(-32768, 32768, size=shape, dtype=np.int16)


# ---------------------------------------------------------------- config


def test_pcm16_config_validation():
    cfg = make_cfg()
    assert cfg.ingest == "pcm16"
    # both conv strategies and the AGC chain take pcm16 (the step converts
    # at device entry, before any stage)
    dataclasses.replace(cfg, conv_strategy="fft").validate()
    dataclasses.replace(cfg, agc_enabled=True).validate()
    with pytest.raises(ValueError, match="ingest"):
        dataclasses.replace(cfg, ingest="pair").validate()
    with pytest.raises(ValueError, match="asrc"):
        dataclasses.replace(cfg, source_samplerate=48000).validate()


def test_pcm16_preset_excludes_ingest(tmp_path):
    """ingest is a deployment-shape field: a preset saved from a pcm16
    config must not re-apply 'pcm16' onto an f32 host."""
    from afp.engine.presets import PresetStore

    store = PresetStore(str(tmp_path / "p.json"))
    store.save_preset("p16", make_cfg())
    base = make_cfg(ingest="f32", conv_strategy="fft")
    assert store.load_preset("p16", base).ingest == "f32"


# ------------------------------------------------------------- numerics


def test_pcm16_staged_matches_pair_and_f32(rng):
    """Staged pcm16 steps == staged f32-ingest steps fed the same n/32768
    floats, on both conv strategies (bit-identical: the device-entry
    convert is exact and the rest of the step is shared).  The bf16-pair
    ingest this once also compared against is gone; the f32 tail carries
    the input history exactly."""
    for strategy in ("td_mxu", "fft"):
        cfg16 = make_cfg(conv_strategy=strategy)
        cfgf = make_cfg(ingest="f32", conv_strategy=strategy)
        p16, pf = Pipeline(cfg16), Pipeline(cfgf)
        assert p16._i16_ingest and p16.supports_ring_step
        pp16 = p16.device_params(PipelineParams.design(cfg16))
        ppf = pf.device_params(PipelineParams.design(cfgf))
        blocks = i16_blocks(rng, (3, 4, 512))
        blocks_f = blocks.astype(np.float32) * np.float32(PCM16_SCALE)
        st16, stf = p16.init_state(seed=1), pf.init_state(seed=1)
        for i in range(3):
            st16, y16 = p16._step_impl(pp16, st16, jnp.asarray(blocks[i]))
            stf, yf = pf._step_impl(ppf, stf, jnp.asarray(blocks_f[i]))
            np.testing.assert_array_equal(np.asarray(y16), np.asarray(yf))
        assert st16.conv_tail.dtype == jnp.float32
        n = st16.conv_tail.shape[-1]
        np.testing.assert_array_equal(np.asarray(st16.conv_tail),
                                      blocks_f[-1][:, -n:])


def test_pcm16_step_rejects_float_blocks(rng):
    """Floats into a pcm16 pipeline would silently quantize — refuse."""
    p = Pipeline(make_cfg())
    pp = p.device_params(PipelineParams.design(p.cfg))
    with pytest.raises(ValueError, match="int16"):
        p._step_impl(pp, p.init_state(),
                     jnp.zeros((4, 512), jnp.float32))
    with pytest.raises(ValueError, match="int16"):
        p.process_signal(pp, p.init_state(),
                         np.zeros((4, 1024), np.float32))


# ------------------------------------------------------- serving rings


def test_pcm16_ring_matches_staged(rng):
    """The pcm16 serving ring must be bit-identical to the staged pcm16
    step loop: per-step, one-dispatch scan with wraparound, a staged step
    resumed from ring-carried state, and the dithered scan (shared key
    walk)."""
    cfg = make_cfg()
    K, n_steps, start = 3, 5, 2
    sig = i16_blocks(rng, (K, 4, 512))
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(p.cfg))

    st = p.init_state(seed=1)
    last = {}
    for i in range(n_steps):
        s = (start + i) % K
        st, y = p._step_impl(pp, st, jnp.asarray(sig[s]))
        last[s] = np.asarray(y)

    ring = jnp.asarray(sig)
    out_shape = (K, 4, 512)

    # per-step ring form
    st1 = p.init_state(seed=1)
    out1 = jnp.full(out_shape, 5.0, jnp.float32)
    for i in range(n_steps):
        st1, out1 = p._ring_step_impl(pp, st1, ring, (start + i) % K, out1)
    for s, y in last.items():
        np.testing.assert_array_equal(np.asarray(out1)[s], y)
    np.testing.assert_array_equal(np.asarray(st1.conv_tail),
                                  np.asarray(st.conv_tail))

    # one-dispatch serving scan
    st2 = p.init_state(seed=1)
    out2 = jnp.full(out_shape, 5.0, jnp.float32)
    st2, out2 = p.run_ring(pp, st2, ring, out2, n_steps, start=start)
    for s, y in last.items():
        np.testing.assert_array_equal(np.asarray(out2)[s], y)
    np.testing.assert_array_equal(np.asarray(st2.conv_tail),
                                  np.asarray(st.conv_tail))

    # staged step resumed from ring-carried state
    nxt = i16_blocks(rng, (4, 512))
    _, y_gold = p._step_impl(pp, st, jnp.asarray(nxt))
    _, y_ring = p._step_impl(pp, st2, jnp.asarray(nxt))
    np.testing.assert_array_equal(np.asarray(y_ring), np.asarray(y_gold))

    # dithered scan shares the staged key walk → still bit-identical
    dcfg = dataclasses.replace(cfg, dither_kind="tpdf")
    pd = Pipeline(dcfg)
    ppd = pd.device_params(PipelineParams.design(pd.cfg))
    std = pd.init_state(seed=4)
    lastd = {}
    for i in range(n_steps):
        s = (start + i) % K
        std, y = pd._step_impl(ppd, std, jnp.asarray(sig[s]))
        lastd[s] = np.asarray(y)
    std2 = pd.init_state(seed=4)
    outd = jnp.zeros(out_shape, jnp.float32)
    std2, outd = pd.run_ring(ppd, std2, ring, outd, n_steps, start=start)
    for s, y in lastd.items():
        np.testing.assert_array_equal(np.asarray(outd)[s], y)
    np.testing.assert_array_equal(np.asarray(std2.key), np.asarray(std.key))


def test_pcm16_ring_kpad_wider_than_block(rng):
    """Overlap tail wider than the block (n_casc − 1 > T): the carried
    history stitches old-tail and block columns across steps — the ring
    scan must match the staged loop bit-exactly."""
    cfg = make_cfg(blocksize=256, upsample_factor=1, numtaps=385,
                   eq_enabled=False, output_clip=None)
    p = Pipeline(cfg)
    assert p.n_casc - 1 > p.block and p.supports_ring_step
    pp = p.device_params(PipelineParams.design(p.cfg))
    K, n_steps = 3, 5
    sig = i16_blocks(rng, (K, 4, 256))

    st = p.init_state(seed=2)
    last = {}
    for i in range(n_steps):
        s = i % K
        st, y = p._step_impl(pp, st, jnp.asarray(sig[s]))
        last[s] = np.asarray(y)

    ring = jnp.asarray(sig)
    st1 = p.init_state(seed=2)
    out1 = jnp.zeros((K, 4, 256), jnp.float32)
    st1, out1 = p.run_ring(pp, st1, ring, out1, n_steps)
    for s, y in last.items():
        np.testing.assert_array_equal(np.asarray(out1)[s], y)
    np.testing.assert_array_equal(np.asarray(st1.conv_tail),
                                  np.asarray(st.conv_tail))


def test_pcm16_ring_dtype_contract(rng):
    """pcm16 rings must be int16; f32-ingest rings must be f32."""
    p16 = Pipeline(make_cfg())
    pp16 = p16.device_params(PipelineParams.design(p16.cfg))
    ring_f = jnp.zeros((3, 4, 512), jnp.float32)
    out = jnp.zeros((3, 4, 512), jnp.float32)
    with pytest.raises(ValueError, match="int16"):
        p16.run_ring(pp16, p16.init_state(), ring_f, out, 2)

    pf = Pipeline(make_cfg(ingest="f32"))
    ppf = pf.device_params(PipelineParams.design(pf.cfg))
    ring_i = jnp.zeros((3, 4, 512), jnp.int16)
    out = jnp.zeros((3, 4, 512), jnp.float32)
    with pytest.raises(ValueError, match="float32"):
        pf.run_ring(ppf, pf.init_state(), ring_i, out, 2)


def test_ring_server_pcm16(rng):
    """RingServer over a pcm16 pipeline: the input ring is raw int16 (half
    the ingest bytes), outputs equal the staged loop, floats refused."""
    from afp.runtime.serving import RingServer

    cfg = make_cfg()
    p = Pipeline(cfg)
    pp = p.device_params(PipelineParams.design(p.cfg))
    blocks = i16_blocks(rng, (6, 4, 512))

    st = p.init_state(seed=0)
    gold = []
    for b in blocks:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        gold.append(np.asarray(y))

    srv = RingServer(p, params=pp, slots=4, chunk=2, max_inflight=1, seed=0)
    assert srv.pcm16 and srv._ring.dtype == jnp.int16
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == len(gold)
    for got, want in zip(outs, gold):
        np.testing.assert_array_equal(got, want)

    with pytest.raises(ValueError, match="int16"):
        next(iter(srv.stream([np.zeros((4, 512), np.float32)])))


# ------------------------------------------------------------- sharded


def test_sharded_pcm16_ring_matches_staged(rng):
    """pcm16 sharded over the 8-virtual-device mesh: ShardedPipeline.run
    and run_ring over an int16 ring match the single-device staged loop
    (the tail shards structurally like any state leaf)."""
    from afp.parallel import ShardedPipeline, make_mesh

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8, axis_names=("streams",))
    cfg = make_cfg(batch=8, blocksize=256)
    pipe = Pipeline(cfg)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    K = 3
    blocks = i16_blocks(rng, (K, 8, 256))
    st = pipe.init_state(seed=5)
    gold = []
    for b in blocks:
        st, y = pipe._step_impl(params, st, jnp.asarray(b))
        gold.append(np.asarray(y))
    gold = np.stack(gold)

    sp = ShardedPipeline(cfg, mesh)
    assert sp.supports_ring_step
    sparams = sp.device_params(design)
    st_r, out_r = sp.run(sparams, sp.init_state(seed=5), jnp.asarray(blocks))
    # sharded vs single-device: fp32 fusion order may differ per shard
    np.testing.assert_allclose(np.asarray(out_r), gold, atol=1e-6)
    # the tail carry is the input history: exact across shards
    np.testing.assert_array_equal(np.asarray(st_r.conv_tail),
                                  np.asarray(st.conv_tail))

    # the ring runs the same step body as the sharded run: bit-identical
    sgold = np.asarray(out_r)
    ring = jnp.asarray(blocks)
    out = jnp.zeros((K, 8, 256), jnp.float32)
    _, out = sp.run_ring(sparams, sp.init_state(seed=5), ring, out, K)
    np.testing.assert_array_equal(np.asarray(out), sgold)


# ------------------------------------------------------ engine + host


def test_engine_pcm16_process_block(rng):
    eng = StreamEngine(make_cfg(), seed=0)
    p = Pipeline(make_cfg())
    pp = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=0)
    blocks = i16_blocks(rng, (3, 4, 512))
    for b in blocks:
        st, want = p._step_impl(pp, st, jnp.asarray(b))
        got = eng.process_block(b)
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="int16"):
        eng.process_block(np.zeros((4, 512), np.float32))


def test_engine_pcm16_ladder_pad_trim_keeps_int16(rng):
    """A wrong-sized pcm16 block goes through the pad/trim rung in int16
    (no float round trip): output equals the zero-padded int16 block."""
    eng = StreamEngine(make_cfg(), seed=0)
    short = i16_blocks(rng, (4, 300))
    got = eng.process_block(short)

    eng2 = StreamEngine(make_cfg(), seed=0)
    full = np.zeros((4, 512), np.int16)
    full[:, :300] = short
    want = eng2.process_block(full)
    np.testing.assert_array_equal(got, want)


def test_engine_pcm16_process_frames_lossless(rng):
    """Arbitrary-sized int16 chunks through the framer == blocksize-fed
    (the BlockFramer carries raw int16 residuals)."""
    total = 512 * 4
    sig = i16_blocks(rng, (4, total))
    eng_a = StreamEngine(make_cfg(), seed=0)
    out_a = []
    pos = 0
    while pos < total:
        n = int(min(rng.integers(1, 700), total - pos))
        out_a.append(eng_a.process_frames(sig[:, pos:pos + n]))
        pos += n
    out_a = np.concatenate(out_a, axis=-1)

    eng_b = StreamEngine(make_cfg(), seed=0)
    out_b = np.concatenate(
        [eng_b.process_frames(sig[:, i * 512:(i + 1) * 512])
         for i in range(4)], axis=-1)
    assert out_a.shape == out_b.shape
    np.testing.assert_array_equal(out_a, out_b)
    with pytest.raises(ValueError, match="int16"):
        eng_a.process_frames(np.zeros((4, 64), np.float32))


def test_engine_pcm16_checkpoint_roundtrip(rng, tmp_path):
    """Mid-stream checkpoint of a pcm16 engine (f32 conv tail + int16
    framer residuals) restores bit-exactly."""
    from afp.engine.checkpoint import load_checkpoint, save_checkpoint

    sig = i16_blocks(rng, (4, 512 * 3 + 137))
    eng = StreamEngine(make_cfg(), seed=3)
    eng.process_frames(sig[:, :700])  # leaves int16 residuals in the framer
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    eng2 = load_checkpoint(path)
    assert eng2._in_dtype == np.int16
    assert eng2._in_framer._dtype == np.int16
    rest = sig[:, 700:]
    out1 = eng.process_frames(rest)
    out2 = eng2.process_frames(rest)
    np.testing.assert_array_equal(out1, out2)


def test_blockring_int16_roundtrip(rng):
    """int16 blocks ride the native float ring as bit views — pop returns
    the exact pushed values (incl. -32768), floats are refused."""
    from afp.runtime.host import BlockRing

    ring = BlockRing(4, (4, 512), dtype=np.int16)
    blk = i16_blocks(rng, (4, 512))
    blk.flat[0] = -32768
    blk.flat[1] = 32767
    assert ring.push(blk)
    got = ring.pop()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, blk)
    with pytest.raises(ValueError, match="int16"):
        ring.push(blk.astype(np.float32))


def test_dispatcher_pcm16(rng):
    """BlockDispatcher over a pcm16 engine: the input ring carries int16,
    timeout silence is int16 zeros, and the int-dtype corrupt fault
    injects a full-scale click instead of NaN (int PCM cannot carry NaN)."""
    from afp.runtime.dispatcher import BlockDispatcher, FaultInjector

    eng = StreamEngine(make_cfg(), seed=0)
    d = BlockDispatcher(eng, queue_depth=8, prime=2)
    assert d.in_ring.dtype == np.int16
    blocks = i16_blocks(rng, (3, 4, 512))
    try:
        d.start()
        for b in blocks:
            assert d.submit(b)
        outs = [d.fetch_blocking() for _ in range(5)]  # 2 primed + 3 live
    finally:
        d.stop()
    assert all(o.shape == (4, 512) and o.dtype == np.float32 for o in outs)

    fi = FaultInjector(corrupt_every=1)
    bad = fi.apply(blocks[0])
    assert bad.dtype == np.int16 and bad.flat[0] == np.iinfo(np.int16).min
