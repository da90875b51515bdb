"""Golden-oracle tests for the windowed-sinc design path, freqz, and the
reference-compatible facade (SURVEY.md §4 item 1).

The oracle is a direct scipy-based replica of the reference's
`filter_methods.py` math (the reference itself can't be imported — it pulls in
sounddevice/tkinter at module scope).
"""
import numpy as np
import pytest
import scipy.signal as sps

from afp.design import create_fir_filter, design_windowed_sinc, freqz


def oracle_design(cutoff, numtaps, window, filter_type, samplerate):
    """scipy replica of reference/filter_methods.py:19-75."""
    n = np.arange(numtaps)
    t = n - (numtaps - 1) / 2
    t[t == 0] = 1e-20
    cutoff = np.asarray(cutoff, dtype=float)
    nyq = samplerate / 2
    cutoff_n = cutoff / nyq
    if window == "kaiser":
        window_vals = sps.get_window(("kaiser", 8.6), numtaps)
    else:
        window_vals = sps.get_window(window, numtaps)
    if filter_type == "lowpass":
        h = cutoff_n * np.sinc(cutoff_n * t)
    elif filter_type == "highpass":
        h = np.sinc(t) - cutoff_n * np.sinc(cutoff_n * t)
    elif filter_type == "bandpass":
        h = cutoff_n[1] * np.sinc(cutoff_n[1] * t) - cutoff_n[0] * np.sinc(cutoff_n[0] * t)
    else:
        h = np.sinc(t) - (
            cutoff_n[1] * np.sinc(cutoff_n[1] * t) - cutoff_n[0] * np.sinc(cutoff_n[0] * t)
        )
    h = h * window_vals
    if filter_type == "lowpass":
        h /= np.sum(h)
    elif filter_type == "highpass":
        h /= np.sum(h * np.cos(2 * np.pi * 0.5 * t))
    elif filter_type == "bandpass":
        w, H = sps.freqz(h, worN=8000, fs=samplerate)
        center = np.sqrt(cutoff[0] * cutoff[1])
        h /= np.abs(H[np.argmin(np.abs(w - center))])
    else:
        w, H = sps.freqz(h, worN=8000, fs=samplerate)
        i1 = np.argmin(np.abs(w - cutoff[0]))
        i2 = np.argmin(np.abs(w - cutoff[1]))
        h /= (np.abs(H[i1]) + np.abs(H[i2])) / 2
    return h


def error_db(a, b):
    num = np.max(np.abs(a - b))
    den = np.max(np.abs(b)) + 1e-300
    return 20 * np.log10(num / den + 1e-300)


WINDOWS = ["hamming", "hann", "blackman", "kaiser", "nuttall", "boxcar", "flattop"]
TAPS = [51, 101, 129, 301, 1001]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("numtaps", TAPS)
def test_lowpass_matches_oracle(window, numtaps):
    args = dict(cutoff=11000, numtaps=numtaps, filter_type="lowpass", samplerate=176400)
    ours = design_windowed_sinc(window=window, **args)
    gold = oracle_design(window=window, **args)
    assert error_db(ours, gold) < -120


@pytest.mark.parametrize("filter_type,cutoff", [
    ("highpass", 2000.0),
    ("bandpass", [500.0, 5000.0]),
    ("bandstop", [500.0, 5000.0]),
])
@pytest.mark.parametrize("numtaps", [101, 301, 1001])
def test_other_types_match_oracle(filter_type, cutoff, numtaps):
    args = dict(cutoff=cutoff, numtaps=numtaps, filter_type=filter_type, samplerate=44100)
    ours = design_windowed_sinc(window="hamming", **args)
    gold = oracle_design(window="hamming", **args)
    assert error_db(ours, gold) < -120


@pytest.mark.parametrize("numtaps", [64, 100, 128])
def test_even_numtaps(numtaps):
    # GUI clamps allow even numtaps in [16, 2048]; design must still work
    args = dict(cutoff=8000.0, numtaps=numtaps, filter_type="lowpass", samplerate=44100)
    ours = design_windowed_sinc(window="hann", **args)
    gold = oracle_design(window="hann", **args)
    assert error_db(ours, gold) < -120


def test_create_fir_filter_facade():
    ours = create_fir_filter(
        method="window", cutoff=11000, numtaps=301,
        window_type="hamming", filter_type="lowpass", samplerate=176400,
    )
    gold = oracle_design(11000, 301, "hamming", "lowpass", 176400)
    assert error_db(ours, gold) < -120


def test_create_fir_filter_rejects_bad_window():
    with pytest.raises(ValueError):
        create_fir_filter(window_type="bogus")


@pytest.mark.parametrize("numtaps", [51, 301, 1001])
def test_freqz_matches_scipy(numtaps):
    h = oracle_design(11000, numtaps, "hamming", "lowpass", 176400)
    w_ours, H_ours = freqz(h, worN=8000, fs=176400)
    w_gold, H_gold = sps.freqz(h, worN=8000, fs=176400)
    np.testing.assert_allclose(w_ours, w_gold, rtol=1e-12)
    np.testing.assert_allclose(H_ours, H_gold, rtol=1e-9, atol=1e-12)


def test_freqz_long_filter_direct_path():
    h = np.random.default_rng(1).normal(size=20000)
    w_ours, H_ours = freqz(h, worN=8000, fs=2.0)
    w_gold, H_gold = sps.freqz(h, worN=8000, fs=2.0)
    np.testing.assert_allclose(H_ours, H_gold, rtol=1e-7, atol=1e-7)


def test_freqz_mulmod_exact_no_overflow():
    """The long-filter phase reduction must compute (k·n) mod M exactly in
    int32 — a plain product wraps at worN >= ~2^15 (the phases then come
    out garbage).  Check the split mulmod against a numpy int64 oracle at
    the largest supported M and random operands."""
    import jax.numpy as jnp

    from afp.design.freqz import _mulmod_i32, _mulmod_tables

    rng = np.random.default_rng(3)
    for M in (16000, 2**17, 2**20):  # small, overflowing, bound
        n = rng.integers(0, 2**28, size=64).astype(np.int64)
        k = rng.integers(0, M, size=37).astype(np.int64)
        n_mod, n_shift, s_bits = _mulmod_tables(n, M)
        got = np.asarray(_mulmod_i32(
            jnp.asarray(k.astype(np.int32))[:, None],
            n_mod[None, :], n_shift[None, :], s_bits, M))
        gold = (k[:, None] * n[None, :]) % M
        np.testing.assert_array_equal(got, gold)


def test_firwin_even_numtaps_highpass_rejected():
    """Even-length symmetric FIRs have a structural Nyquist zero: highpass /
    bandstop must raise (the old normalization divided by a ~1e-14 cos-sum
    and returned ~1e14-scaled garbage)."""
    import pytest as _pytest

    for ftype, cutoff in (("highpass", 1000.0), ("bandstop", [500.0, 2000.0])):
        with _pytest.raises(ValueError, match="odd numtaps"):
            design_windowed_sinc(cutoff, numtaps=100, filter_type=ftype,
                                 window=np.hamming(100), samplerate=44100)
        with _pytest.raises(ValueError):
            create_fir_filter("window", cutoff, numtaps=100,
                              filter_type=ftype, window_type="hamming",
                              samplerate=44100)
    # odd numtaps still fine
    h = design_windowed_sinc(1000.0, numtaps=101, filter_type="highpass",
                             window=np.hamming(101), samplerate=44100)
    assert np.max(np.abs(h)) < 10.0


def test_freqz_jax_matches_numpy():
    h = oracle_design(11000, 129, "hamming", "lowpass", 88200)
    from afp.design import freqz_jax

    w_j, H_j = freqz_jax(np.asarray(h, dtype=np.float32), worN=2000, fs=88200)
    w_n, H_n = freqz(h, worN=2000, fs=88200)
    np.testing.assert_allclose(np.asarray(w_j), w_n, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(H_j), H_n, rtol=2e-3, atol=2e-4)


def test_freqz_jax_long_filter_direct_path():
    """len(h) > 2·worN must take the direct-evaluation branch, like the
    numpy path."""
    from afp.design import freqz_jax

    h = np.random.default_rng(2).normal(size=700).astype(np.float32)
    w_j, H_j = freqz_jax(h, worN=256, fs=2.0)
    w_n, H_n = freqz(h.astype(np.float64), worN=256, fs=2.0)
    np.testing.assert_allclose(np.asarray(w_j), w_n, rtol=1e-6)
    scale = np.max(np.abs(H_n))
    np.testing.assert_allclose(np.asarray(H_j) / scale, H_n / scale, atol=1e-4)


def test_highpass_at_nyquist_rejected():
    """Found by fuzzing: a highpass cutoff at/above Nyquist designs to the
    identically-zero kernel and its cos-sum normalization returned silent
    NaNs — now rejected loudly at the design layer, while the engine's
    validate() clamps strictly inside Nyquist (never-raise contract)."""
    import pytest

    from afp.design import create_fir_filter
    from afp.engine import StreamConfig

    with pytest.raises(ValueError, match="Nyquist"):
        create_fir_filter(method="window", cutoff=11025.0, numtaps=65,
                          window_type="hamming", filter_type="highpass",
                          samplerate=22050)
    # the engine clamp keeps a supra-Nyquist request designable and finite
    cfg = StreamConfig(samplerate=22050, upsample_factor=1, numtaps=65,
                       filter_type="highpass", cutoff=14000.0,
                       eq_enabled=False, agc_enabled=False).validate()
    assert cfg.cutoff < 22050 / 2
    from afp.engine import PipelineParams

    p = PipelineParams.design(cfg)
    assert np.all(np.isfinite(p.main_taps))
