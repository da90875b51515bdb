"""Golden tests: first-party Remez exchange vs scipy.signal.remez."""
import numpy as np
import pytest
import scipy.signal as sps

from afp.design import create_fir_filter, design_fir_filter, remez


def response_error_db(h_ours, h_gold, bands_hz, fs):
    """Max in-band response deviation, in dB relative to unity."""
    w, H1 = sps.freqz(h_ours, worN=8000, fs=fs)
    _, H2 = sps.freqz(h_gold, worN=8000, fs=fs)
    err = 0.0
    for lo, hi in bands_hz:
        m = (w >= lo) & (w <= hi)
        err = max(err, float(np.max(np.abs(np.abs(H1[m]) - np.abs(H2[m])))))
    return 20 * np.log10(err + 1e-300)


CASES = [
    # (numtaps, bands, desired, fs)
    (101, [0, 8000, 9000, 22050], [1, 0], 44100),
    (51, [0, 5000, 6000, 22050], [1, 0], 44100),
    (301, [0, 10000, 10500, 22050], [1, 0], 44100),
    (101, [0, 1000, 2000, 22050], [0, 1], 44100),
    (151, [0, 400, 500, 5000, 5500, 22050], [0, 1, 0], 44100),
    (101, [0, 450, 500, 5000, 5100, 22050], [1, 0, 1], 44100),
]


@pytest.mark.parametrize("numtaps,bands,desired,fs", CASES)
def test_remez_matches_scipy_response(numtaps, bands, desired, fs):
    ours = remez(numtaps, bands, desired, fs=fs)
    gold = sps.remez(numtaps, bands, desired, fs=fs)
    pairs = [(bands[2 * i], bands[2 * i + 1]) for i in range(len(desired))]
    assert response_error_db(ours, gold, pairs, fs) < -60
    # minimax ripple must be within a hair of scipy's
    w, H1 = sps.freqz(ours, worN=8000, fs=fs)
    _, H2 = sps.freqz(gold, worN=8000, fs=fs)
    for (lo, hi), d in zip(pairs, desired):
        m = (w >= lo) & (w <= hi)
        rip_ours = np.max(np.abs(np.abs(H1[m]) - d))
        rip_gold = np.max(np.abs(np.abs(H2[m]) - d))
        assert rip_ours <= rip_gold * 1.05 + 1e-9


@pytest.mark.parametrize("numtaps", [100, 64])
def test_remez_even_numtaps(numtaps):
    bands, desired, fs = [0, 6000, 7000, 22050], [1, 0], 44100
    ours = remez(numtaps, bands, desired, fs=fs)
    gold = sps.remez(numtaps, bands, desired, fs=fs)
    pairs = [(0, 6000), (7000, 22050)]
    assert response_error_db(ours, gold, pairs, fs) < -60


def test_remez_weighting():
    ours = remez(101, [0, 8000, 9000, 22050], [1, 0], weight=[1, 10], fs=44100)
    gold = sps.remez(101, [0, 8000, 9000, 22050], [1, 0], weight=[1, 10], fs=44100)
    assert response_error_db(ours, gold, [(0, 8000), (9000, 22050)], 44100) < -60


def test_design_fir_filter_remez_heuristics():
    """The facade's remez path must actually work (reference's is a latent
    NameError, `filter_methods.py:96`), with the same band heuristics."""
    for ft, cutoff in [
        ("lowpass", 10000), ("highpass", 2000),
        ("bandpass", [1000, 5000]), ("bandstop", [1000, 5000]),
    ]:
        h = design_fir_filter(method="remez", cutoff=cutoff, numtaps=101,
                              filter_type=ft, samplerate=44100)
        assert h.shape == (101,)
        assert np.all(np.isfinite(h))
        h2 = create_fir_filter(method="remez", cutoff=cutoff, numtaps=101,
                               filter_type=ft, samplerate=44100)
        np.testing.assert_allclose(h, h2)


def test_remez_lowpass_heuristic_matches_scipy_bands():
    # replicate the reference's lowpass band table through scipy directly
    fs, cutoff = 44100, 10000
    tw = min(1000, (fs / 2 - cutoff) / 2)
    bands = [0, cutoff, cutoff + tw, fs / 2]
    ours = design_fir_filter(method="remez", cutoff=cutoff, numtaps=151,
                             filter_type="lowpass", samplerate=fs)
    gold = sps.remez(151, bands, [1, 0], fs=fs)
    assert response_error_db(ours, gold, [(0, cutoff), (cutoff + tw, fs / 2)], fs) < -60


@pytest.mark.parametrize("numtaps,bands,desired", [
    # narrow transition
    (201, [0, 9800, 10000, 22050], [1, 0]),
    # multi-band
    (201, [0, 300, 400, 2000, 2100, 6000, 6100, 22050], [0, 1, 0, 1]),
    # tiny filter
    (11, [0, 4000, 8000, 22050], [1, 0]),
    # large filter
    (513, [0, 10000, 10400, 22050], [1, 0]),
])
def test_remez_stress(numtaps, bands, desired):
    h = remez(numtaps, bands, desired, fs=44100)
    assert h.shape == (numtaps,)
    assert np.all(np.isfinite(h))
    gold = sps.remez(numtaps, bands, desired, fs=44100)
    pairs = [(bands[2 * i], bands[2 * i + 1]) for i in range(len(desired))]
    assert response_error_db(h, gold, pairs, 44100) < -40  # same minimax family
    # our converged ripple must not be worse than scipy's by >10%
    w, H1 = sps.freqz(h, worN=8000, fs=44100)
    _, H2 = sps.freqz(gold, worN=8000, fs=44100)
    for (lo, hi), d in zip(pairs, desired):
        m = (w >= lo) & (w <= hi)
        assert np.max(np.abs(np.abs(H1[m]) - d)) <= np.max(np.abs(np.abs(H2[m]) - d)) * 1.1 + 1e-9


def test_remez_raises_on_nonconvergence():
    """Exhausting maxiter must raise RemezError (scipy raises 'failed to
    converge') instead of silently returning a non-minimax filter."""
    import pytest

    from afp.design import RemezError, remez

    with pytest.raises(RemezError, match="converge"):
        remez(65, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], maxiter=0)
