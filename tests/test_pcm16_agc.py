"""int16 PCM ingest through the AGC (C8) chain: the step converts the raw
int16 block at device entry (``n/32768`` — exact, `ops/pcm16.py`), so every
output stays BIT-IDENTICAL to feeding the same floats through
``ingest='f32'``; the overlap tail is the f32 gain-applied history.

Reference semantics under test: the AGC chain of
`reference/stream_process_AGC.py:43-89` (moving RMS → desired gain →
attack/release smoothing → clip → apply) over 16-bit sources.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig
from afp.ops.pcm16 import PCM16_SCALE

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow


@pytest.fixture
def rng():
    return np.random.default_rng(4242)


def c8_cfg(**kw):
    base = dict(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=33,
        batch=16, eq_enabled=True, agc_enabled=True, agc_mode="exact",
        agc_window_size=256, agc_carry=True, dither_kind="tpdf",
        output_clip=0.99, conv_strategy="td_mxu", ingest="pcm16",
        resample_quality="fast",  # tier mechanics tested elsewhere
    )
    base.update(kw)
    return StreamConfig(**base).validate()


def i16_blocks(rng, shape):
    return rng.integers(-32768, 32768, size=shape, dtype=np.int16)


@pytest.mark.parametrize("mode", ["exact", "fast", "parallel"])
def test_pcm16_agc_staged_matches_f32(rng, mode):
    """pcm16 + AGC staged steps ≡ f32 ingest fed n/32768, bitwise, in every
    AGC mode — outputs, AGC gain carry, and overlap tail."""
    p16 = Pipeline(c8_cfg(agc_mode=mode))
    pf = Pipeline(c8_cfg(agc_mode=mode, ingest="f32"))
    pp16 = p16.device_params(PipelineParams.design(p16.cfg))
    ppf = pf.device_params(PipelineParams.design(pf.cfg))
    blocks = i16_blocks(rng, (3, 16, 512))
    st16, stf = p16.init_state(seed=1), pf.init_state(seed=1)
    for b in blocks:
        st16, y16 = p16._step_impl(pp16, st16, jnp.asarray(b))
        stf, yf = pf._step_impl(
            ppf, stf, jnp.asarray(b.astype(np.float32) * PCM16_SCALE))
        np.testing.assert_array_equal(np.asarray(y16), np.asarray(yf))
    np.testing.assert_array_equal(np.asarray(st16.agc_gain),
                                  np.asarray(stf.agc_gain))
    np.testing.assert_array_equal(np.asarray(st16.conv_tail),
                                  np.asarray(stf.conv_tail))


def test_pcm16_agc_ring_matches_staged(rng):
    """The raw int16 ring through the AGC chain ≡ the staged steps."""
    p = Pipeline(c8_cfg())
    assert p.supports_ring_step
    pp = p.device_params(PipelineParams.design(p.cfg))
    blocks = i16_blocks(rng, (3, 16, 512))
    st = p.init_state(seed=2)
    ref = []
    for b in blocks:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    st2, out = p.run_ring(pp, p.init_state(seed=2), jnp.asarray(blocks),
                          jnp.zeros((3, 16, 512), jnp.float32), 3)
    np.testing.assert_array_equal(np.asarray(out), np.stack(ref))
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))


def test_pcm16_agc_ring_dtype_contract(rng):
    p = Pipeline(c8_cfg())
    pp = p.device_params(PipelineParams.design(p.cfg))
    with pytest.raises(ValueError, match="int16"):
        p.run_ring(pp, p.init_state(), jnp.zeros((2, 16, 512), jnp.float32),
                   jnp.zeros((2, 16, 512), jnp.float32), 2)


def test_ring_server_pcm16_agc(rng):
    """RingServer over the pcm16 AGC chain: raw int16 input ring — outputs
    match the staged step loop."""
    from afp.runtime.serving import RingServer

    p = Pipeline(c8_cfg())
    pp = p.device_params(PipelineParams.design(p.cfg))
    blocks = i16_blocks(rng, (4, 16, 512))
    st, ref = p.init_state(seed=0), []
    for b in blocks:
        st, y = p._step_impl(pp, st, jnp.asarray(b))
        ref.append(np.asarray(y))
    srv = RingServer(p, params=pp, slots=4, chunk=2, max_inflight=1, seed=0)
    assert srv.pcm16 and srv._ring.dtype == jnp.int16
    outs = list(srv.stream(iter(blocks)))
    assert len(outs) == 4
    for i in range(4):
        np.testing.assert_array_equal(outs[i], ref[i])


def test_engine_pcm16_agc_block_and_checkpoint(rng, tmp_path):
    """StreamEngine with pcm16+AGC: int16 blocks through the full ladder,
    conv tail + AGC gain checkpointed and restored bit-exactly."""
    from afp.engine.checkpoint import load_checkpoint, save_checkpoint
    from afp.engine.engine import StreamEngine

    eng = StreamEngine(c8_cfg(), seed=3)
    assert eng._in_dtype == np.int16
    blocks = i16_blocks(rng, (3, 16, 512))
    for b in blocks[:2]:
        eng.process_block(b)
    path = str(tmp_path / "c8_pcm16.npz")
    save_checkpoint(path, eng)
    y_ref = np.asarray(eng.process_block(blocks[2]))
    eng2 = load_checkpoint(path)
    y2 = np.asarray(eng2.process_block(blocks[2]))
    np.testing.assert_array_equal(y_ref, y2)


def test_sharded_pcm16_agc_ring(rng):
    """2-device stream-DP over the int16 ring: the sharded AGC chain serves
    through run_ring bit-exact to the sharded staged run."""
    import jax
    from jax.sharding import Mesh

    from afp.parallel.dp import ShardedPipeline

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("streams",))
    sp = ShardedPipeline(c8_cfg(batch=32), mesh)
    assert sp.supports_ring_step
    params = sp.device_params(PipelineParams.design(sp.cfg))
    K = 3
    blocks = i16_blocks(rng, (K, 32, 512))
    st, gold = sp.run(params, sp.init_state(seed=5), jnp.asarray(blocks))
    st2, out_ring = sp.run_ring(params, sp.init_state(seed=5),
                                jnp.asarray(blocks),
                                jnp.zeros((K, 32, 512), jnp.float32), K)
    np.testing.assert_array_equal(np.asarray(out_ring), np.asarray(gold))
    np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                  np.asarray(st2.agc_gain))


def test_pcm16_agc_linked_rows_share_gain(rng):
    """Linked AGC over pcm16 pairs: the group-min pins equal gains within
    each pair of rows."""
    p = Pipeline(c8_cfg(agc_link_group=2, dither_kind="off"))
    pp = p.device_params(PipelineParams.design(p.cfg))
    b = i16_blocks(rng, (16, 512))
    st, _ = p._step_impl(pp, p.init_state(), jnp.asarray(b))
    g = np.asarray(st.agc_gain)
    np.testing.assert_array_equal(g[0::2], g[1::2])


def test_pcm16_agc_config_variants_validate():
    for kw in (dict(agc_mode="fast"), dict(conv_strategy="fft"),
               dict(emit="pcm16")):
        cfg = c8_cfg(**kw)
        assert Pipeline(cfg).supports_ring_step
    with pytest.raises(ValueError, match="asrc"):
        dataclasses.replace(c8_cfg(), source_samplerate=48000).validate()
