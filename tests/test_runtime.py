"""Host runtime tests: native ring/pacer, dispatcher semantics, fault
injection, latency behavior (SURVEY.md §4 item 5, §5.3)."""
import numpy as np
import pytest

from afp.engine import StreamConfig, StreamEngine
from afp.runtime import (
    BlockRing,
    FaultInjector,
    Pacer,
    SimulatedStream,
    native_available,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native host library unavailable"
)


def make_engine(**kw):
    base = dict(
        resample_quality="fast",  # tier mechanics tested elsewhere; keep CPU CI fast
        samplerate=44100, blocksize=512, upsample_factor=1, numtaps=33,
        batch=1, cutoff=11000.0, eq_enabled=False, agc_enabled=False,
        downsample_mode="decimate", dither_kind="off", output_clip=None,
    )
    base.update(kw)
    return StreamEngine(StreamConfig(**base))


def test_ring_fifo_and_drop():
    r = BlockRing(capacity=2, block_shape=(4,))
    assert r.push(np.array([1, 1, 1, 1], np.float32))
    assert r.push(np.array([2, 2, 2, 2], np.float32))
    assert not r.push(np.array([3, 3, 3, 3], np.float32))  # full → drop
    assert r.stats["drops"] == 1
    np.testing.assert_array_equal(r.pop(), [1, 1, 1, 1])
    np.testing.assert_array_equal(r.pop(), [2, 2, 2, 2])
    assert r.pop() is None  # empty → underrun
    assert r.stats["underruns"] == 1


def test_ring_blocking_timeout():
    r = BlockRing(capacity=1, block_shape=(4,))
    assert r.pop(timeout=0.05) is None  # times out
    assert r.push(np.zeros(4, np.float32))
    assert not r.push(np.zeros(4, np.float32), timeout=0.05)  # full, times out


def test_ring_rejects_nonpositive_dims():
    """Negative capacity/shape used to wrap through the C ABI's uint64 and
    std::terminate the process from vector::resize (review fix)."""
    for kw in (dict(capacity=-1, block_shape=(4,)),
               dict(capacity=0, block_shape=(4,)),
               dict(capacity=2, block_shape=(-8,))):
        with pytest.raises(ValueError, match="positive"):
            BlockRing(**kw)


def test_pacer_rejects_nonpositive_period():
    """period <= 0 used to reach an integer division by zero inside the
    native wait (UB/SIGFPE); now rejected at create (review fix)."""
    for bad in (0.0, -0.01, 1e-12):  # 1e-12 s truncates to 0 ns
        with pytest.raises(ValueError, match="pacer period"):
            Pacer(bad)


def test_framer_int16_never_coerces_floats():
    """An int16 framer must reject float chunks — np.asarray would
    truncate [-1, 1] floats to all-zero silence (review fix; the same
    contract as BlockRing.push / StreamEngine._coerce_in)."""
    from afp.runtime.framer import BlockFramer

    f = BlockFramer(1, dtype=np.int16)
    with pytest.raises(ValueError, match="framer carries"):
        f.push(np.full((1, 64), 0.5, dtype=np.float32))
    f.push(np.ones((1, 64), dtype=np.int16))  # exact dtype is fine
    # float framers still widen/convert (lossless direction)
    g = BlockFramer(1, dtype=np.float32)
    g.push(np.ones((1, 64), dtype=np.int16))


def test_pacer_rate():
    import time

    p = Pacer(0.02)
    t0 = time.monotonic()
    for _ in range(5):
        p.wait()
    dt = time.monotonic() - t0
    # lower bound is the real contract (the pacer must not run fast); the
    # upper bound only guards against a hang and must tolerate a loaded
    # CI host (observed 0.57 s under full-suite contention)
    assert 0.08 <= dt <= 2.0
    assert p.ticks == 5


def test_simulated_stream_end_to_end(rng):
    eng = make_engine()
    sig = rng.normal(size=(40, 1, 512)).astype(np.float32) * 0.3
    outs = []
    stream = SimulatedStream(
        eng, source=lambda i: sig[i], sink=outs.append, realtime=False
    )
    snap = stream.run(40)
    assert len(outs) == 40
    assert snap["blocks"] >= 1
    # offline mode is LOCKSTEP: no silence priming, no fabricated blocks
    # (review fix: the primed variant led with 15 silence blocks and lost
    # the final 15 real blocks at stop()) — every output carries signal
    assert all(np.max(np.abs(o)) > 0 for o in outs)


def test_simulated_stream_offline_lockstep_exact(rng):
    """Offline SimulatedStream output ≡ the engine's block-by-block output
    (1-in-1-out, no priming offset, no tail loss)."""
    eng = make_engine()
    oracle = make_engine()
    sig = rng.normal(size=(12, 1, 512)).astype(np.float32) * 0.3
    outs = []
    SimulatedStream(eng, source=lambda i: sig[i], sink=outs.append,
                    realtime=False).run(12)
    gold = [oracle.process_block(sig[i]) for i in range(12)]
    assert len(outs) == 12
    for a, b in zip(outs, gold):
        np.testing.assert_array_equal(a, b)


def test_simulated_stream_offline_drop_skips_tick(rng):
    """A fault-dropped input produces NO output block in lockstep mode
    (instead of a phantom primed-silence block)."""
    eng = make_engine()
    sig = rng.normal(size=(10, 1, 512)).astype(np.float32) * 0.3
    outs = []
    faults = FaultInjector(drop_every=5)
    SimulatedStream(eng, source=lambda i: sig[i], sink=outs.append,
                    faults=faults, realtime=False).run(10)
    assert len(outs) == 8  # blocks 5 and 10 dropped


def test_fault_injection_drop_and_corrupt(rng):
    eng = make_engine()
    sig = rng.normal(size=(30, 1, 512)).astype(np.float32) * 0.3
    faults = FaultInjector(drop_every=5, corrupt_every=7)
    stream = SimulatedStream(eng, source=lambda i: sig[i], faults=faults,
                             realtime=False)
    snap = stream.run(30)
    # corrupted blocks must have triggered the engine's replay/silence ladder
    assert snap["fallback_replays"] + snap["fallback_silence"] >= 1
    # and the stream must have survived to the end
    assert snap["blocks"] >= 1


def test_latency_one_block_in_one_block_out(rng):
    """With a fast engine and paced ticks, the dispatcher must neither grow
    its queues unboundedly nor starve (steady one-in/one-out)."""
    eng = make_engine()
    sig = rng.normal(size=(50, 1, 512)).astype(np.float32)
    stream = SimulatedStream(eng, source=lambda i: sig[i], realtime=False)
    import time

    # pre-warm jit so the worker keeps up from the first paced tick
    eng.process_block(sig[0])
    snap = stream.run(50)
    assert len(stream.dispatcher.out_ring) <= stream.dispatcher.out_ring.capacity
    assert snap["in_ring"]["drops"] <= 2


def test_asrc_frontend_exact_streaming(rng):
    """Arbitrary push chunking → block-exact output == one-shot causal
    upfirdn of the whole source signal (no per-block edge artifacts)."""
    import scipy.signal as sps

    from afp.runtime.asrc import AsrcFrontend

    src_rate, eng_rate = 48000, 44100
    fe = AsrcFrontend(src_rate, eng_rate, batch=1)
    T = fe.l_dev * 5
    sig = (0.3 * rng.standard_normal(T)).astype(np.float32)

    # push in ragged chunks
    i, outs = 0, []
    rngs = np.random.default_rng(1)
    while i < T:
        n = int(rngs.integers(100, 3000))
        fe.push(sig[i : i + n])
        i += n
        while (blk := fe.pull(1024)) is not None:
            outs.append(blk)
    outs.append(fe.flush())
    streamed = np.concatenate(outs, axis=1)[0]

    gold = sps.upfirdn(np.asarray(fe._state.h), sig.astype(np.float64),
                       fe.up, fe.down)
    n = min(len(streamed), len(gold))
    assert n > T * fe.up // fe.down - fe.l_dev
    np.testing.assert_allclose(streamed[:n], gold[:n], atol=2e-5)


def test_asrc_frontend_rate_bookkeeping():
    from afp.runtime.asrc import AsrcFrontend

    fe = AsrcFrontend(48000, 44100, batch=2)
    fe.push(np.zeros((2, fe.l_dev * 2), np.float32))
    # 2 super-blocks in → exactly 2·l_dev·up/down out
    assert fe.available() == 2 * fe.l_dev * fe.up // fe.down
    assert fe.pull(10**9) is None  # can't overdraw


def test_asrc_frontend_flush_drains_group_delay(rng):
    """flush() must emit the final `delay_outputs` engine-rate samples of
    real audio — padding only to the super-block boundary left them stuck
    in the filter history (and an exactly-aligned residual got no padding
    at all)."""
    from afp.runtime.asrc import AsrcFrontend

    fe = AsrcFrontend(48000, 44100, batch=1)
    T = fe.l_dev  # EXACTLY one super-block: the old flush pushed nothing
    sig = (0.3 * rng.standard_normal(T)).astype(np.float32)
    fe.push(sig)
    outs = [fe.pull(fe.available())] if fe.available() else []
    outs.append(fe.flush())
    streamed = np.concatenate([o for o in outs if o is not None], axis=1)[0]

    import scipy.signal as sps
    gold = sps.upfirdn(np.asarray(fe._state.h), sig.astype(np.float64),
                       fe.up, fe.down)
    n_real = (T * fe.up) // fe.down  # engine samples covering the input
    assert streamed.shape[0] >= n_real, (streamed.shape, n_real)
    np.testing.assert_allclose(streamed[:n_real], gold[:n_real], atol=2e-5)
