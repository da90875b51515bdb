"""Seeded fuzz of the serving rings — the flagship serving path.

Draws random ring-capable configs (ingest × emit × AGC chain × link × EQ ×
strategy × shapes × dither) and holds every draw to the ring's contract:
the ring runs the staged step body on a ring slot, so

* ring ≡ the SAME pipeline's staged ``step()`` sequence, BIT-exact (same
  step body, same key walk), dither on or off;
* the carried state (overlap tail, AGC gain, key) ≡ the staged loop's;
* the tail is the f32 input history (n/32768 for pcm16 ingest).

Draws the ring does not support fall out via `supports_ring_step` — the
gate refusing is part of the contract.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from afp.engine import Pipeline, PipelineParams, StreamConfig

#: heavy suite — excluded from the fast pass (docs/TESTING.md tiering);
#: run the FULL suite before committing kernel/engine changes
pytestmark = pytest.mark.slow


N_DRAWS = 16


def _draw(rng):
    pick = lambda *xs: xs[rng.integers(len(xs))]
    agc = bool(pick(False, True))
    return StreamConfig(
        samplerate=44100,
        blocksize=int(pick(512, 1024, 2048)),
        upsample_factor=int(pick(1, 2)),
        numtaps=int(pick(65, 129)),
        batch=int(pick(8, 16, 32)),
        eq_enabled=bool(pick(False, True)),
        agc_enabled=agc,
        agc_mode=pick("exact", "fast"),
        agc_window_size=int(pick(128, 256, 512)),
        agc_carry=True,
        agc_link_group=int(pick(1, 2)) if agc else 1,
        resample_quality="fast",  # tier mechanics tested elsewhere
        dither_kind=pick("off", "tpdf"),
        downsample_mode="decimate",
        conv_strategy=pick("td_mxu", "fft"),
        ingest=pick("f32", "pcm16"),
        emit=pick("f32", "f32", "pcm16"),
        output_clip=0.99,
    )


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_fuzz_ring_matches_staged(seed):
    rng = np.random.default_rng(4000 + seed)
    try:
        cfg = _draw(rng).validate()
    except ValueError:
        return  # loud rejection of an invalid combo is a pass
    p = Pipeline(cfg)
    if not p.supports_ring_step:
        return  # the gate refusing unsupported shapes is the contract
    params = p.device_params(PipelineParams.design(p.cfg))

    K, B, T = 3, cfg.batch, cfg.blocksize
    sig = (rng.normal(size=(K, B, T)) * 0.05).astype(np.float32)
    if cfg.agc_link_group == 2:
        sig[:, 1::2] = 0.5 * sig[:, 0::2]
    if cfg.ingest == "pcm16":
        blocks = np.clip(np.round(sig * 32768.0), -32768, 32767
                         ).astype(np.int16)
        floats = blocks.astype(np.float32) / np.float32(32768.0)
    else:
        blocks = floats = sig

    st = p.init_state(seed=5)
    gold = []
    for b in blocks:
        st, y = p.step(params, st, jnp.asarray(b))
        gold.append(np.asarray(y))
    gold = np.stack(gold)

    out = jnp.zeros((K, B, T), jnp.int16 if cfg.emit == "pcm16"
                    else jnp.float32)
    st_r, ring = p.run_ring(params, p.init_state(seed=5),
                            jnp.asarray(blocks), out, K)
    np.testing.assert_array_equal(np.asarray(ring), gold)

    tail = np.asarray(st_r.conv_tail)
    np.testing.assert_array_equal(tail, np.asarray(st.conv_tail))
    if not cfg.agc_enabled:  # the conv consumes x itself: input history
        assert tail.dtype == np.float32
        np.testing.assert_array_equal(tail, floats[-1][:, -tail.shape[-1]:])
    else:
        np.testing.assert_array_equal(np.asarray(st.agc_gain),
                                      np.asarray(st_r.agc_gain))
    np.testing.assert_array_equal(np.asarray(st.key), np.asarray(st_r.key))
