"""Golden tests: minimum-phase conversion vs scipy.signal.minimum_phase."""
import numpy as np
import pytest
import scipy.signal as sps

from afp.design import minimum_phase, to_minimum_phase, is_symmetric
from afp.design.minphase import normalize_peak


def _lp(numtaps):
    return sps.firwin(numtaps, 0.4)


@pytest.mark.parametrize("numtaps", [31, 101, 129, 301])
def test_hilbert_matches_scipy(numtaps):
    """The 'hilbert' method is ill-conditioned by construction (scipy shifts
    the response so min(H)=0, then takes log), so its output depends on FFT
    rounding at the ~1e-4 level even between numpy's and scipy's own pocketfft
    builds.  Compare at that inherent reproducibility limit, plus magnitude
    response equivalence."""
    h = _lp(numtaps)
    ours = minimum_phase(h, method="hilbert")
    gold = sps.minimum_phase(h, method="hilbert")
    assert ours.shape == gold.shape
    np.testing.assert_allclose(ours, gold, atol=2e-3)
    w, Ho = sps.freqz(ours, worN=4096)
    _, Hg = sps.freqz(gold, worN=4096)
    assert np.max(np.abs(np.abs(Ho) - np.abs(Hg))) < 2e-3


@pytest.mark.parametrize("numtaps", [31, 101, 301])
def test_homomorphic_matches_scipy(numtaps):
    h = _lp(numtaps)
    ours = minimum_phase(h, method="homomorphic")
    gold = sps.minimum_phase(h, method="homomorphic")
    assert ours.shape == gold.shape
    np.testing.assert_allclose(ours, gold, rtol=1e-7, atol=1e-10)


def test_minimum_phase_magnitude_preserved():
    # |H_min| ≈ |H| for the hilbert method (tolerances loose: method is approximate)
    h = _lp(101)
    hm = minimum_phase(h, method="hilbert")
    w, H = sps.freqz(h, worN=4096)
    _, Hm = sps.freqz(hm, worN=4096)
    band = w < 0.3 * np.pi  # passband
    np.testing.assert_allclose(np.abs(Hm[band]), np.abs(H[band]), atol=0.02)


def test_to_minimum_phase_gate_and_normalize():
    # symmetric filter converts + peak-normalizes; asymmetric passes through
    h = _lp(101)
    out = to_minimum_phase(h, fs=44100)
    assert out.shape == (51,)
    _, H = sps.freqz(out, worN=8000, fs=44100)
    assert abs(np.max(np.abs(H)) - 1.0) < 1e-6

    h_asym = np.r_[h, 0.5]  # break symmetry
    assert not is_symmetric(h_asym)
    np.testing.assert_array_equal(to_minimum_phase(h_asym, fs=44100), h_asym)


def test_normalize_peak_zero_filter_passthrough():
    z = np.zeros(16)
    np.testing.assert_array_equal(normalize_peak(z, 44100), z)
