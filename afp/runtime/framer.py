"""Host-side residual block framing: lossless arbitrary-frames ingest.

Re-creates the reference's most advanced ingest discipline — the
residual-carrying callback of `reference/stream_process_GUI_Presets.py
:617-686` (concatenate the input residual, process only whole blocks, carry
input/output residuals across callbacks) — as a standalone host regrouper:
push chunks of ANY length, pull exact block-sized (or any-sized) slices,
zero samples lost or padded.

This supersedes the engine ladder's pad/trim rung for *size mismatch*: that
rung time-stretches audio (it zero-fills or truncates a wrong-sized block in
place), which is a corruption recovery, not a framing policy.  With the
framer in front, the pad/trim rung fires only on true corruption
(batch-count mismatch), and arbitrary-`frames` sources — PortAudio callbacks
with driver-chosen frame counts, network chunks, file readers — stream
losslessly.

The variable-shape bookkeeping lives on the host (numpy), where dynamic
shapes are free; the device pipeline keeps its static [batch, blocksize]
contract (the same split as :class:`~afp.runtime.asrc.AsrcFrontend`,
which is this pattern plus a resampler).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["BlockFramer"]


class BlockFramer:
    """Residual-carrying regrouper: any-length pushes → exact-length pulls.

    `push` accepts [batch, n] (or [n], broadcast over the batch) for any n;
    `pull(n)` returns exactly [batch, n] samples in stream order, or None
    when fewer than `n` are buffered (the honest Optional — no silent
    padding).  All data is delivered exactly once, in order.
    """

    def __init__(self, batch: int, dtype=np.float32):
        self.batch = int(batch)
        self._dtype = np.dtype(dtype)
        self._buf = np.zeros((self.batch, 0), dtype=self._dtype)

    def push(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk)
        if self._dtype != np.float32 and chunk.dtype != self._dtype:
            # int framers never coerce: an f32→int16 cast would silently
            # quantize [-1, 1] floats to zeros (the same contract as
            # BlockRing.push and StreamEngine._coerce_in)
            raise ValueError(
                f"this framer carries {self._dtype} chunks, got "
                f"{chunk.dtype}")
        chunk = np.asarray(chunk, dtype=self._dtype)
        if chunk.ndim == 1:
            chunk = np.broadcast_to(chunk[None, :],
                                    (self.batch, chunk.shape[-1]))
        if chunk.shape[0] != self.batch:
            raise ValueError(
                f"expected batch {self.batch}, got {chunk.shape[0]}")
        self._buf = np.concatenate([self._buf, chunk], axis=1)

    def pull(self, n: int) -> Optional[np.ndarray]:
        """Exactly `n` samples per stream, or None if not yet buffered."""
        if self._buf.shape[1] < n:
            return None
        out = self._buf[:, :n]
        self._buf = self._buf[:, n:]
        return out

    def available(self) -> int:
        return self._buf.shape[1]

    # --- checkpointing (engine/checkpoint.py) ---

    def get_state(self) -> np.ndarray:
        return self._buf.copy()

    def set_state(self, buf: np.ndarray) -> None:
        buf = np.asarray(buf, dtype=self._dtype)
        if buf.ndim != 2 or buf.shape[0] != self.batch:
            raise ValueError(f"expected [{self.batch}, n] residual state")
        self._buf = buf.copy()
