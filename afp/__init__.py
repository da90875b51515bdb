"""afp — an audio DSP framework on JAX for NVIDIA GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
MrEstefano/Audio-Filtering-Pipeline: FIR design (windowed-sinc, Remez,
minimum-phase), and a fused streaming pipeline (polyphase resample → multiband
EQ → FIR → AGC → dither) running over device-resident batches of audio
streams.

Layers (see SURVEY.md §1 and docs/PARITY.md):
  design/    L1 filter design (host float64, scipy-free)
  ops/       L2 device DSP kernels (jnp + Pallas)
  engine/    L3 streaming runtime (scan pipelines, batching, presets)
  parallel/  device-mesh sharding (stream DP, time-axis halo exchange)
  runtime/   host dispatcher (native ring buffers), ASRC frontend, devices
  viz/       response plots, spectra, waterfall
  ui/        headless controller (+ optional tkinter view)
  utils/     WAV I/O, logging

Subpackages that pull in jax are imported lazily so `import afp` stays
cheap for design-only (host) use.
"""

__version__ = "0.1.0"

from . import design  # noqa: F401  (host-only, cheap)

_LAZY = ("engine", "ops", "parallel", "runtime", "viz", "ui", "utils")

__all__ = ["design", "__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
