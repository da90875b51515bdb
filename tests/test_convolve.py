"""Golden + streaming-equivalence tests for convolution ops
(SURVEY.md §4 items 1 & 3)."""
import numpy as np
import pytest
import scipy.signal as sps

from afp.ops import OverlapAdd, OverlapSave, fft_convolve


def err_db(a, b):
    return 20 * np.log10(np.max(np.abs(np.asarray(a) - b)) / (np.max(np.abs(b)) + 1e-300) + 1e-300)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("T,N", [(4096, 301), (2048, 129), (1000, 51), (512, 512)])
def test_fft_convolve_matches_oaconvolve(rng, mode, T, N):
    x = rng.normal(size=T).astype(np.float32)
    h = rng.normal(size=N).astype(np.float32)
    ours = np.asarray(fft_convolve(x, h, mode=mode))
    gold = sps.oaconvolve(x.astype(np.float64), h.astype(np.float64), mode=mode)
    assert ours.shape == gold.shape
    assert err_db(ours, gold) < -90


def test_fft_convolve_batched(rng):
    x = rng.normal(size=(8, 2048)).astype(np.float32)
    h = rng.normal(size=301).astype(np.float32)
    ours = np.asarray(fft_convolve(x, h, mode="same"))
    for i in range(8):
        gold = sps.oaconvolve(x[i].astype(np.float64), h.astype(np.float64), mode="same")
        assert err_db(ours[i], gold) < -90


def test_fft_convolve_per_stream_kernels(rng):
    x = rng.normal(size=(4, 1024)).astype(np.float32)
    h = rng.normal(size=(4, 129)).astype(np.float32)
    ours = np.asarray(fft_convolve(x, h, mode="valid"))
    for i in range(4):
        gold = np.convolve(x[i].astype(np.float64), h[i].astype(np.float64), mode="valid")
        assert err_db(ours[i], gold) < -90


def test_overlap_save_streaming_equivalence(rng):
    """Blocked OverlapSave == one-shot valid conv over the zero-primed
    sliding buffer (the reference's stream_process.py:97-106 pattern)."""
    N, L, nblocks = 301, 1024, 8
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=L * nblocks).astype(np.float32)

    state = OverlapSave.init(h, block=L)
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)

    # one-shot: zero-primed signal, valid conv
    padded = np.concatenate([np.zeros(N - 1), sig.astype(np.float64)])
    gold = np.convolve(padded, h.astype(np.float64), mode="valid")
    assert streamed.shape == gold.shape
    assert err_db(streamed, gold) < -90


def test_overlap_save_batched_streaming(rng):
    N, L, B = 129, 512, 6
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=(B, L * 4)).astype(np.float32)
    state = OverlapSave.init(h, block=L, batch_shape=(B,))
    outs = []
    for b in range(4):
        state, y = state.process(sig[:, b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs, axis=1)
    for i in range(B):
        padded = np.concatenate([np.zeros(N - 1), sig[i].astype(np.float64)])
        gold = np.convolve(padded, h.astype(np.float64), mode="valid")
        assert err_db(streamed[i], gold) < -90


def test_overlap_add_matches_reference_ola(rng):
    """OverlapAdd must reproduce the reference OverlapAddFilter numerics
    (`stream_process_GUI_Presets.py:35-123`): block output = first L of the
    block conv + carried N−1 tail ⇒ streamed == full 'same-ish' convolution
    with zero initial state (== first T samples of the full convolution)."""
    N, L, nblocks = 301, 1024, 6
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=L * nblocks).astype(np.float32)
    state = OverlapAdd.init(h, block=L)
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)
    gold = np.convolve(sig.astype(np.float64), h.astype(np.float64), mode="full")[: len(sig)]
    assert err_db(streamed, gold) < -90


@pytest.mark.parametrize(
    "N,L",
    [
        (513, 128),  # N−1 = 4·L: carry spans 4 blocks
        (2048, 256),  # the config-clamp extremes (numtaps 2048, blocksize 256)
        (301, 1024),  # short-filter regime (regression)
        (257, 256),  # N−1 exactly == L (boundary)
        (258, 256),  # N−1 == L+1 (one carried sample)
    ],
)
def test_overlap_add_streaming_equivalence_all_regimes(rng, N, L):
    """Streaming ≡ one-shot for every (N, L) the config clamps allow —
    including numtaps−1 > blocksize, where the reference's own
    OverlapAddFilter is silently wrong (not reproduced here)."""
    nblocks = 8
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=L * nblocks).astype(np.float32)
    state = OverlapAdd.init(h, block=L)
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)
    gold = np.convolve(sig.astype(np.float64), h.astype(np.float64))[: len(sig)]
    assert err_db(streamed, gold) < -90


def test_overlap_add_long_filter_batched(rng):
    N, L, B, nblocks = 513, 128, 3, 10
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=(B, L * nblocks)).astype(np.float32)
    state = OverlapAdd.init(h, block=L, batch_shape=(B,))
    outs = []
    for b in range(nblocks):
        state, y = state.process(sig[:, b * L : (b + 1) * L])
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs, axis=1)
    for i in range(B):
        gold = np.convolve(sig[i].astype(np.float64), h.astype(np.float64))[: L * nblocks]
        assert err_db(streamed[i], gold) < -90


def test_overlap_add_short_filter_identity():
    state = OverlapAdd.init(np.array([], dtype=np.float32), block=256)
    x = np.linspace(-1, 1, 256).astype(np.float32)
    _, y = state.process(x)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-6)


def test_kernel_swap_no_shape_change(rng):
    h1 = rng.normal(size=101).astype(np.float32)
    h2 = rng.normal(size=101).astype(np.float32)
    state = OverlapSave.init(h1, block=512)
    x = rng.normal(size=512).astype(np.float32)
    state, _ = state.process(x)
    state = state.with_kernel(h2)  # glitch-free swap
    state, y = state.process(x)
    assert np.all(np.isfinite(np.asarray(y)))
    with pytest.raises(ValueError):
        state.with_kernel(rng.normal(size=55).astype(np.float32))
