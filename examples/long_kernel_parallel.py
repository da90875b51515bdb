#!/usr/bin/env python
"""Kernel (tensor) parallelism: one very long FIR sharded across the mesh.

The reference caps at 2048 taps on one core; room-correction / convolution-
reverb kernels run to 10⁵–10⁶ taps.  `KernelParallelConv` splits the TAP axis
over the device mesh — each device convolves the same stream against its chunk
(a D×-shorter FFT) and one psum per block reassembles the exact full-kernel
output (see afp/parallel/kp.py).

Needs `--devices` devices (default 8) and exits with an error when fewer are
present.  On the CPU, provide virtual ones:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/long_kernel_parallel.py [--taps 100000]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from afp.utils.jax_cache import enable_compile_cache as _cache
_cache()
import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--taps", type=int, default=50000)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()

    import jax

    if len(jax.devices()) < args.devices:
        raise SystemExit(f"--devices {args.devices}: only "
                         f"{len(jax.devices())} devices available")

    from afp.ops.convolve import OverlapSave, next_pow2
    from afp.parallel import KernelParallelConv, make_mesh

    rng = np.random.default_rng(0)
    h = (rng.standard_normal(args.taps) / np.sqrt(args.taps)).astype(np.float32)
    mesh = make_mesh(args.devices, axis_names=("kernel",))
    kp = KernelParallelConv(h, block=args.block, mesh=mesh, batch=2)
    full_fft = next_pow2(args.block + args.taps - 1)
    print(f"{args.taps}-tap kernel over {args.devices} devices: per-device "
          f"FFT {kp.nfft} vs single-device {full_fft} "
          f"({full_fft // kp.nfft}× smaller)")

    ref = OverlapSave.init(h, block=args.block, batch_shape=(2,))
    st = kp.init_state()
    worst = 0.0
    for b in range(8):
        blk = (rng.standard_normal((2, args.block)) * 0.3).astype(np.float32)
        st, y = kp.step(st, blk)
        ref, gold = ref.process(blk)
        g = np.asarray(gold)
        worst = max(worst, float(np.abs(np.asarray(y) - g).max()
                                 / (np.abs(g).max() + 1e-30)))
    print(f"sharded vs full-kernel stream: worst rel err "
          f"{20 * np.log10(worst + 1e-300):.1f} dB over 8 blocks")


if __name__ == "__main__":
    main()
