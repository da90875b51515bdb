"""Streaming ASRC frontend: block-exact arbitrary-rate conversion
(roadmap #1 — supersedes the reference's per-block stateless conversion).

The reference converts each block independently and pads/trims to blocksize
(`reference/stream_process_AGC.py:126-129`) — block-edge artifacts and
timeline drift.  The in-pipeline compat mode reproduces that; this frontend
does it RIGHT with static device shapes:

* device side: the exact streaming :class:`~afp.ops.resample.PolyResampler`
  at a fixed super-block (`l_dev`, a multiple of the reduced decimation
  factor) — blocked output ≡ the one-shot full-signal transform;
* host side: two small accumulators regroup arbitrary-size source pushes
  into `l_dev` chunks and engine-block pulls — the variable-rate bookkeeping
  lives where variable shapes are free.

Feed `push()` with source-rate audio of ANY chunking; `pull()` engine-rate
blocks for the StreamEngine.  Latency = resampler group delay + up to one
`l_dev` super-block.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import numpy as np

from ..ops.resample import PolyResampler

__all__ = ["AsrcFrontend"]


class AsrcFrontend:
    """Host-buffered exact streaming resampler: source rate → engine rate."""

    def __init__(self, source_rate: int, engine_rate: int, batch: int = 1,
                 l_dev: Optional[int] = None, quality: str = "fast"):
        g = math.gcd(engine_rate, source_rate)
        self.up = engine_rate // g
        self.down = source_rate // g
        self.source_rate = source_rate
        self.engine_rate = engine_rate
        self.batch = batch
        if l_dev is None:
            # a super-block of roughly 4k source samples, divisible by `down`
            l_dev = max(1, round(4096 / self.down)) * self.down
        if l_dev % self.down:
            raise ValueError(f"l_dev must be a multiple of {self.down}")
        self.l_dev = l_dev
        self._state = PolyResampler.init(self.up, self.down, block=l_dev,
                                         batch_shape=(batch,),
                                         quality=quality)
        self._step = jax.jit(lambda st, x: st.process(x))
        self._in = np.zeros((batch, 0), dtype=np.float32)
        self._out = np.zeros((batch, 0), dtype=np.float32)

    @property
    def delay_outputs(self) -> int:
        """Engine-rate samples of group delay vs the zero-phase transform."""
        return self._state.delay_outputs

    def push(self, block: np.ndarray) -> None:
        """Append source-rate samples ([batch, n] or [n]); any n."""
        block = np.asarray(block, dtype=np.float32)
        if block.ndim == 1:
            block = np.broadcast_to(block[None, :], (self.batch, block.shape[-1]))
        if block.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {block.shape[0]}")
        self._in = np.concatenate([self._in, block], axis=1)
        n_chunks = self._in.shape[1] // self.l_dev
        if not n_chunks:
            return
        # ONE output concat per push (a whole-file push used to rebuild the
        # grown output buffer once per super-block — O(n²) memcpy, minutes
        # of pure copy time for long files on a 1-CPU host)
        outs = [self._out]
        for i in range(n_chunks):
            chunk = self._in[:, i * self.l_dev:(i + 1) * self.l_dev]
            self._state, y = self._step(self._state, chunk)
            outs.append(np.asarray(y))
        # .copy(): the residual must not pin the full input buffer via a view
        self._in = self._in[:, n_chunks * self.l_dev:].copy()
        self._out = np.concatenate(outs, axis=1)

    def available(self) -> int:
        return self._out.shape[1]

    def pull(self, n: int) -> Optional[np.ndarray]:
        """Take exactly `n` engine-rate samples, or None if not yet buffered."""
        if self._out.shape[1] < n:
            return None
        out = self._out[:, :n]
        self._out = self._out[:, n:]
        return out

    def get_state(self) -> dict:
        """Snapshot (np arrays) for engine checkpointing."""
        return {
            "asrc_in": self._in.copy(),
            "asrc_out": self._out.copy(),
            "asrc_hist": np.asarray(self._state.hist),
        }

    def set_state(self, state: dict) -> None:
        self._in = np.asarray(state["asrc_in"], dtype=np.float32)
        self._out = np.asarray(state["asrc_out"], dtype=np.float32)
        import jax.numpy as jnp

        self._state = self._state._replace(
            hist=jnp.asarray(state["asrc_hist"], dtype=jnp.float32)
        )

    def flush(self) -> np.ndarray:
        """Drain: pad the input with enough zeros to flush BOTH the residual
        super-block and the resampler's causal group delay, convert, return
        all remaining output (end-of-stream).  Padding only to the
        super-block boundary would leave the final `delay_outputs`
        engine-rate samples of real audio stuck in the filter history."""
        n_in = self._in.shape[1]
        need_src = -(-int(self._state.delay_outputs) * self.down // self.up)
        pad = -(-(n_in + need_src) // self.l_dev) * self.l_dev - n_in
        if pad:
            self.push(np.zeros((self.batch, pad), dtype=np.float32))
        out = self._out
        self._out = np.zeros((self.batch, 0), dtype=np.float32)
        return out
