"""Time-axis context parallelism via halo exchange (SURVEY.md §5.7).

The convolutional analog of ring/blockwise context parallelism: to filter ONE
very long signal across D devices, shard the time axis; each shard needs only
the ``N−1`` samples to its left (the FIR receptive field) — one
``lax.ppermute`` neighbor push between devices per pass, O(N) halo instead of any
full-tensor rotation.  The first shard receives zeros from the edge (ppermute
semantics), which is exactly the zero-primed causal convolution the streaming
engine defines.

This mirrors the reference's carried-state mechanism — the sliding input
buffer (`reference/stream_process.py:97-98`) and the OverlapAddFilter
tail (`stream_process_GUI_Presets.py:67, 115-121`) — turned 90°: state across
*space* (devices) instead of *time* (blocks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["halo_convolve", "halo_convolve_sharded"]


def _local_causal_conv(chunk_ext: jnp.ndarray, h: jnp.ndarray, n_out: int) -> jnp.ndarray:
    """Valid-mode FFT conv of [.., N-1+n_out] against h[N] → [.., n_out]."""
    from ..ops.convolve import next_pow2

    N = h.shape[-1]
    nfft = next_pow2(chunk_ext.shape[-1] + N - 1)
    Y = jnp.fft.rfft(chunk_ext, n=nfft) * jnp.fft.rfft(h, n=nfft)
    y = jnp.fft.irfft(Y, n=nfft)
    return jax.lax.slice_in_dim(y, N - 1, N - 1 + n_out, axis=-1)


def batch_axis_of(mesh: Mesh, time_axis: str):
    """The mesh's stream-DP axis name for 2-D (streams × time) meshes, or
    None on a pure time mesh — batch rows are independent, so sharding
    them alongside the halo exchange composes with zero extra collectives
    (the ppermute stays within each streams row)."""
    return ("streams" if "streams" in mesh.axis_names
            and time_axis != "streams" else None)


def halo_convolve(x: jnp.ndarray, h: jnp.ndarray, mesh: Mesh,
                  axis: str = "time") -> jnp.ndarray:
    """Causal FIR convolution of a long signal sharded over `axis`.

    `x`: [T] or [B, T] with T divisible by the mesh axis size; `h`: [N]
    (shared) or [B, N] (per-stream kernels — gain banks).  Output matches
    ``convolve(zero-primed x, h, 'valid')`` == the streaming engine's
    overlap-save output, but computed as ONE sharded pass with a single
    neighbor ppermute.

    On a 2-D (streams × time) mesh the batch rows additionally shard over
    'streams' — combined stream DP × context parallelism; per-stream
    kernels shard with their rows.
    """
    h = jnp.asarray(h, dtype=jnp.float32)
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    D = mesh.shape[axis]
    B, T = x.shape
    if T % D:
        raise ValueError(f"signal length {T} must divide over {D} devices")
    N = h.shape[-1]
    if T // D < N - 1:
        raise ValueError("per-device chunk shorter than the filter halo")
    bax = batch_axis_of(mesh, axis)
    if bax and B == 1:
        bax = None  # mono signal on a 2-D mesh: replicate the row
    if bax and B % mesh.shape[bax]:
        raise ValueError(
            f"batch {B} must divide over the {mesh.shape[bax]}-way "
            f"'{bax}' axis")

    def local(chunk, h_rep):
        # chunk: [B_local, T/D] local shard
        tail = chunk[:, -(N - 1):] if N > 1 else chunk[:, :0]
        D_ = jax.lax.axis_size(axis)
        # push my tail to my right neighbor; shard 0 receives zeros
        left_halo = jax.lax.ppermute(
            tail, axis, perm=[(i, i + 1) for i in range(D_ - 1)]
        )
        ext = jnp.concatenate([left_halo, chunk], axis=-1)
        return _local_causal_conv(ext, h_rep, chunk.shape[-1])

    hspec = P(bax, None) if h.ndim == 2 else P()
    out = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(bax, axis), hspec),
            out_specs=P(bax, axis),
            check_vma=False,
        )
    )(x, h)
    return out[0] if squeeze else out


def halo_convolve_sharded(x: jnp.ndarray, h: jnp.ndarray, mesh: Mesh,
                          axis: str = "time") -> jnp.ndarray:
    """Like :func:`halo_convolve` but placing the input sharded first (for
    device-resident long signals already distributed across the mesh) — on a
    2-D mesh the placement matches halo_convolve's (streams × time) specs,
    so the dispatch resharding it exists to avoid stays avoided."""
    if x.ndim == 2:
        bax = batch_axis_of(mesh, axis)
        # mirror halo_convolve's row handling: mono replicates; an
        # indivisible batch will raise there, so don't pre-shard it
        if bax and (x.shape[0] == 1 or x.shape[0] % mesh.shape[bax]):
            bax = None
        spec = P(bax, axis)
    else:
        spec = P(axis)
    return halo_convolve(jax.device_put(x, NamedSharding(mesh, spec)),
                         h, mesh, axis)
