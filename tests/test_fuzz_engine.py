"""Seeded engine-level fuzz: the host runtime's two hardest contracts under
random schedules.

Leg 1 — lossless framing: `StreamEngine.process_frames` must regroup ANY
chunking of a stream into exactly the blocksize-fed output (the reference's
residual-carrying callback made lossless,
`stream_process_GUI_Presets.py:617-686`).  The targeted test pins one
chunking; the fuzz drives random chunk-size schedules (1..3·blocksize,
incl. empty and single-sample chunks) across random configs.

Leg 2 — glitch-free reconfig: random interleavings of `apply_config`
(dynamic-field changes AND static-key rebuilds) with block processing must
never crash, always return finite blocks of the configured shape, and
dynamic-only swaps must preserve stream state (`engine.py:139-178`, the
reference's filter_lock swap `stream_process_EQ_GUI.py:380-385`).
"""
import dataclasses

import numpy as np
import pytest

from afp.engine import StreamConfig, StreamEngine

N_DRAWS = 8


def _cfg(rng):
    pick = lambda *xs: xs[rng.integers(len(xs))]
    while True:  # redraw combinations validate() rejects
        try:
            return StreamConfig(
                samplerate=44100,
                blocksize=int(pick(256, 512)),
                upsample_factor=int(pick(1, 2, 4)),
                numtaps=int(pick(33, 65, 129)),
                batch=int(pick(1, 2)),
                eq_enabled=bool(pick(False, True)),
                agc_enabled=bool(pick(False, True)),
                agc_window_size=128,
                dither_kind="off",  # noise differs per framing latency
                resample_quality="fast",  # tier mechanics tested elsewhere
                downsample_mode=pick("resample", "decimate"),
                output_rate=pick("base", "upsampled"),
                output_clip=0.99,
            ).validate()
        except ValueError:
            continue


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_fuzz_frames_chunking_lossless(seed):
    rng = np.random.default_rng(2000 + seed)
    cfg = _cfg(rng)
    L = cfg.blocksize
    n_total = 6 * L
    sig = (rng.normal(size=(cfg.batch, n_total)) * 0.1).astype(np.float32)

    ref_eng = StreamEngine(cfg)
    ref = np.concatenate(
        [ref_eng.process_frames(sig[:, i:i + L])
         for i in range(0, n_total, L)], axis=-1)

    eng = StreamEngine(cfg)
    outs, i = [], 0
    while i < n_total:
        n = int(rng.choice([0, 1, 7, L // 2, L - 1, L, L + 1, 3 * L]))
        n = min(n, n_total - i)
        outs.append(eng.process_frames(sig[:, i:i + n]))
        i += n
    got = np.concatenate(outs, axis=-1)
    # same total in → same total out (lossless regrouping), bit-identical
    assert got.shape == ref.shape, (cfg, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_fuzz_reconfig_schedule(seed):
    rng = np.random.default_rng(3000 + seed)
    cfg = _cfg(rng)
    eng = StreamEngine(cfg)
    rebuilds = 0
    for step in range(10):
        blk = (rng.normal(size=(eng.cfg.batch, eng.cfg.blocksize))
               * 0.1).astype(np.float32)
        y = eng.process_block(blk)
        assert y.shape == eng._out_shape, (step, y.shape)
        assert np.all(np.isfinite(y)), (step, eng.cfg)
        roll = rng.integers(4)
        if roll == 0:
            # dynamic-only change: cutoff / AGC target — same static key,
            # state must survive the swap
            state_before = eng.state
            new = dataclasses.replace(
                eng.cfg, cutoff=float(rng.integers(4000, 16000)),
                agc_target_level=float(rng.uniform(0.05, 0.2)))
            assert new.static_key() == eng.cfg.static_key()
            assert eng.apply_config(new) is True
            assert eng.state is state_before  # glitch-free: no reset
        elif roll == 1:
            # static-key change: blocksize or taps — engine rebuilds
            new = dataclasses.replace(
                eng.cfg,
                blocksize=int(rng.choice([256, 512])),
                numtaps=int(rng.choice([33, 65, 129])),
            )
            if new.static_key() != eng.cfg.static_key():
                assert eng.apply_config(new) is False
                rebuilds += 1
        # rolls 2-3: keep streaming
    assert eng.metrics.blocks_processed >= 10
    assert eng.metrics.design_fallbacks == 0  # every redesign succeeded
