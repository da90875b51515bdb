"""L2 device DSP ops: the kernel surface of SURVEY.md §2.2."""
from .agc import (AGCParams, agc_alphas, apply_agc, link_desired, moving_rms,
                  smooth_gain_parallel, smooth_gain_scan)
from .convolve import (OverlapAdd, OverlapSave, band_conv, band_matrix,
                       fft_convolve, kernel_rfft, next_pow2)
from .dither import dither
from .pcm16 import PCM16_SCALE, pcm16_to_f32, quantize_pcm16
from .resample import (
    PolyResampler,
    decimate,
    design_resample_kernel,
    output_len,
    resample_poly,
    upfirdn,
)
from .spectrum import (
    WATERFALL_DEPTH,
    spectrum_db,
    spectrum_db_np,
    spectrum_freqs,
    spectrum_peak,
    waterfall_init,
    waterfall_push,
)

__all__ = [
    "AGCParams", "agc_alphas", "apply_agc", "link_desired", "moving_rms",
    "smooth_gain_scan", "smooth_gain_parallel",
    "OverlapAdd", "OverlapSave", "band_conv", "band_matrix", "fft_convolve",
    "kernel_rfft", "next_pow2",
    "dither", "PCM16_SCALE", "pcm16_to_f32", "quantize_pcm16",
    "PolyResampler", "decimate", "design_resample_kernel", "output_len",
    "resample_poly", "upfirdn",
    "WATERFALL_DEPTH", "spectrum_db", "spectrum_db_np",
    "spectrum_freqs", "spectrum_peak",
    "waterfall_init", "waterfall_push",
]
