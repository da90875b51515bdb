"""Golden-oracle tests: first-party windows vs scipy (SURVEY.md §4 item 1)."""
import numpy as np
import pytest
import scipy.signal as sps

from afp.design import windows as W
from afp.design.api import get_window as ref_get_window

NAMES = [
    "boxcar", "triang", "blackman", "hamming", "hann", "bartlett",
    "flattop", "parzen", "bohman", "blackmanharris", "nuttall", "barthann",
]
LENGTHS = [1, 2, 3, 16, 51, 101, 128, 301, 1001, 2048]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("M", LENGTHS)
def test_window_periodic_matches_scipy(name, M):
    ours = W.get_window(name, M)  # periodic, like scipy get_window default
    theirs = sps.get_window(name, M)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("M", [51, 128, 301])
def test_window_symmetric_matches_scipy(name, M):
    ours = W.get_window(name, M, fftbins=False)
    theirs = sps.get_window(name, M, fftbins=False)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-13)


@pytest.mark.parametrize("beta", [5.0, 8.6, 12.0, 14.0])
@pytest.mark.parametrize("M", [16, 101, 301, 1001])
def test_kaiser_matches_scipy(beta, M):
    ours = W.get_window(("kaiser", beta), M)
    theirs = sps.get_window(("kaiser", beta), M)
    np.testing.assert_allclose(ours, theirs, rtol=1e-13, atol=1e-13)


def test_reference_wrapper_kaiser_default_beta():
    # reference wrapper injects beta=8.6 (`window_types.py:35-42`)
    ours = ref_get_window("kaiser", 101)
    theirs = sps.get_window(("kaiser", 8.6), 101)
    np.testing.assert_allclose(ours, theirs, rtol=1e-13, atol=1e-13)


def test_reference_wrapper_unknown_raises_valueerror():
    with pytest.raises(ValueError):
        ref_get_window("not_a_window", 64)


def test_window_names_cover_gui_list():
    # the GUI-exposed window set must all be designable
    for name in W.WINDOW_NAMES:
        w = ref_get_window(name, 65)
        assert w.shape == (65,)
        assert np.all(np.isfinite(w))
