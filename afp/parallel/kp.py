"""Kernel (tensor) parallelism: one very long FIR sharded over the mesh.

The last SURVEY §2.4 axis: the reference has no tensor parallelism; its
analog is a single long main filter (up to 2048 taps; nothing stops a user
from designing 100k-tap kernels for room correction).  A long-kernel
convolution decomposes exactly over the TAP axis:

    h = Σ_d shift(h_d, d·C),   h_d = h[d·C : (d+1)·C]
    ⇒ y[t] = Σ_d z_d[t − d·C],  z_d = x ⊛ h_d

so each device convolves the SAME input stream against its own C-tap chunk
(overlap-save with FFT size next_pow2(L + C − 1) — memory AND compute scale
down by the device count), delays its partial stream by d·C samples through
a carried FIFO, and ONE `psum` across devices per block reassembles the exact
full-kernel output.  Communication: [B, L] floats per block, independent of
kernel length.

This beats bin-sharding the fused spectrum (which would still need every
device to compute the full-length FFT): here the per-device FFT is D× shorter
— real distributed work, not just a distributed multiply.

Streamed output ≡ a zero-primed full-kernel :class:`OverlapSave`
(equivalence-tested on the 8-virtual-device CPU mesh; exercised by
`__graft_entry__.dryrun_multichip`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.convolve import next_pow2

__all__ = ["KernelParallelConv"]


class KPState(NamedTuple):
    tail: jnp.ndarray  # [D, B, C-1] per-device overlap-save input history
    delay: jnp.ndarray  # [D, B, (D-1)*C] per-device output-delay FIFO


class KernelParallelConv:
    """Streaming FIR convolution with the kernel sharded over a mesh axis.

    Usage::

        mesh = make_mesh(8, axis_names=("kernel",))
        kp = KernelParallelConv(h, block=4096, mesh=mesh, batch=16)
        state = kp.init_state()
        state, y = kp.step(state, x_block)     # y == full-kernel conv
    """

    def __init__(self, h: np.ndarray, block: int, mesh: Mesh,
                 axis: str = "kernel", batch: int = 1):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        D = mesh.shape[axis]
        h = np.asarray(h, dtype=np.float64)
        N = len(h)
        C = -(-N // D)
        C = max(C, 2)  # keep per-device tails non-empty
        pad = D * C - N
        chunks = np.concatenate([h, np.zeros(pad)]).reshape(D, C)
        self.mesh = mesh
        self.axis = axis
        self.D = D
        self.C = C
        self.N = N
        self.block = int(block)
        self.batch = int(batch)
        self.nfft = next_pow2(self.block + C - 1)
        self.maxdelay = (D - 1) * C
        self._H = jnp.fft.rfft(jnp.asarray(chunks, jnp.float32), n=self.nfft,
                               axis=-1)  # [D, F]

        axis_ = self.axis
        C_ = self.C
        L = self.block
        nfft = self.nfft
        maxdelay = self.maxdelay

        def local_step(H_l, tail_l, delay_l, x):
            # H_l: [1, F]; tail_l: [1, B, C-1]; delay_l: [1, B, maxdelay];
            # x: [B, L] (replicated)
            ext = jnp.concatenate([tail_l[0], x], axis=-1)  # [B, C-1+L]
            Z = jnp.fft.rfft(ext, n=nfft) * H_l[0]
            z = jnp.fft.irfft(Z, n=nfft)
            z = jax.lax.slice_in_dim(z, C_ - 1, C_ - 1 + L, axis=-1)
            new_tail = jax.lax.slice_in_dim(
                ext, ext.shape[-1] - (C_ - 1), ext.shape[-1], axis=-1
            )
            buf = jnp.concatenate([delay_l[0], z], axis=-1)  # [B, maxdelay+L]
            d = jax.lax.axis_index(axis_)
            start = maxdelay - d * C_
            y_d = jax.lax.dynamic_slice_in_dim(buf, start, L, axis=-1)
            new_delay = jax.lax.slice_in_dim(
                buf, buf.shape[-1] - maxdelay, buf.shape[-1], axis=-1
            )
            y = jax.lax.psum(y_d, axis_)
            return new_tail[None], new_delay[None], y

        shard_spec = P(axis, None, None)
        self._step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(P(axis, None), shard_spec, shard_spec, P()),
                out_specs=(shard_spec, shard_spec, P()),
                check_vma=False,
            )
        )

    def init_state(self) -> KPState:
        return KPState(
            tail=jnp.zeros((self.D, self.batch, self.C - 1), jnp.float32),
            delay=jnp.zeros((self.D, self.batch, self.maxdelay), jnp.float32),
        )

    def step(self, state: KPState, block: jnp.ndarray):
        """[B, L] in → (state, [B, L] out) — the zero-primed valid-mode
        streaming convolution of the FULL kernel."""
        x = jnp.asarray(block, dtype=jnp.float32)
        tail, delay, y = self._step(self._H, state.tail, state.delay, x)
        return KPState(tail=tail, delay=delay), y

    def with_kernel(self, h: np.ndarray) -> "KernelParallelConv":
        """Glitch-free kernel swap (same length class → same shapes)."""
        h = np.asarray(h, dtype=np.float64)
        if -(-len(h) // self.D) > self.C:
            raise ValueError("new kernel is longer than the sharded layout")
        pad = self.D * self.C - len(h)
        chunks = np.concatenate([h, np.zeros(pad)]).reshape(self.D, self.C)
        new = object.__new__(KernelParallelConv)
        new.__dict__ = dict(self.__dict__)
        new._H = jnp.fft.rfft(jnp.asarray(chunks, jnp.float32), n=self.nfft,
                              axis=-1)
        return new
