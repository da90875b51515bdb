"""Hand-written Pallas kernels for the GPU (Triton route), each beside
the plain reference it is tested against."""
from .agc_scan import smooth_gain_pallas

__all__ = ["smooth_gain_pallas"]
