"""WAV file I/O (stdlib `wave` only — no soundfile/scipy dependency).

The reference streams from a sound card; the batched engine streams from storage
or network.  This module provides the float32 ⇄ PCM conversions (16/24/32-bit
and IEEE float) needed to feed real audio through the engine, with the same
±1.0 float convention as the sounddevice callback buffers.
"""
from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "read_wav_pcm16", "write_wav", "write_wav_pcm16"]


def _parse_riff(path: str):
    """Minimal RIFF/WAVE chunk parser — handles IEEE-float (format 3) and
    WAVE_FORMAT_EXTENSIBLE files the stdlib `wave` module rejects.
    Returns (fmt_tag, n_ch, rate, width_bytes, data_bytes)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = body
            elif cid == b"data":
                data = body
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    tag, n_ch, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == 0xFFFE and len(fmt) >= 40:  # extensible: real tag in the GUID
        tag = struct.unpack("<H", fmt[24:26])[0]
    return tag, n_ch, rate, bits // 8, data


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 array [channels, frames] in ±1.0, rate).

    Supports PCM 8/16/24/32 and IEEE float32/float64 (format 3, which the
    stdlib `wave` module cannot read)."""
    try:
        with wave.open(path, "rb") as w:
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        tag, n_ch, rate, width, raw = _parse_riff(path)
        if tag == 3:  # IEEE float
            dt = "<f4" if width == 4 else "<f8"
            x = np.frombuffer(raw, dtype=dt).astype(np.float32)
            return x.reshape(-1, n_ch).T.copy(), rate
        if tag != 1:
            raise ValueError(f"unsupported WAV format tag {tag}")
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        x = ints.astype(np.float32) / float(1 << 23)
    elif width == 4:
        # could be PCM32 or IEEE float; wave exposes only PCM — assume PCM32.
        # convert via float64 (float32 mantissa can't hold 32-bit samples)
        x = (np.frombuffer(raw, dtype="<i4").astype(np.float64) / float(1 << 31)).astype(np.float32)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return x.reshape(-1, n_ch).T.copy(), rate


def read_wav_pcm16(path: str) -> Tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV file RAW → (int16 array [channels, frames],
    rate) — the zero-conversion source for ``StreamConfig(ingest='pcm16')``
    engines (whose on-device n/32768 conversion reproduces
    :func:`read_wav`'s float values exactly).  Raises on any other sample
    format: silently converting would defeat the raw-ingest contract."""
    try:
        with wave.open(path, "rb") as w:
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
        tag = 1
    except wave.Error:
        tag, n_ch, rate, width, raw = _parse_riff(path)
    if tag != 1 or width != 2:
        raise ValueError(
            f"{path} is not 16-bit PCM (format {tag}, {width * 8}-bit) — "
            "use read_wav() and ingest='f32' for non-16-bit sources")
    x = np.frombuffer(raw, dtype="<i2")
    return x.reshape(-1, n_ch).T.copy(), rate


def write_wav_pcm16(path: str, x: np.ndarray, rate: int) -> None:
    """Write raw int16 PCM samples [channels, frames] (or [frames]) to a
    16-bit WAV VERBATIM — the zero-conversion sink for
    ``StreamConfig(emit='pcm16')`` engines, whose on-device quantizer
    already produced the final samples (``int16(clip(round(y·32768)))``,
    `ops.pcm16.quantize_pcm16`).  Refuses float input: quantizing
    here would silently duplicate the device's quantizer with different
    semantics (write_wav's ×32767 convention)."""
    x = np.asarray(x)
    if x.dtype != np.int16:
        raise ValueError(
            f"write_wav_pcm16 takes raw int16 samples, got {x.dtype} — "
            "use write_wav() for float audio")
    if x.ndim == 1:
        x = x[None, :]
    n_ch = x.shape[0]
    with wave.open(path, "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(x.T.astype("<i2")).tobytes())


def write_wav(path: str, x: np.ndarray, rate: int, width: int = 2,
              float_format: bool = False) -> None:
    """Write float32 [channels, frames] (or [frames]) in ±1.0 to WAV.

    `float_format=True` writes IEEE float32 (format 3, lossless for the
    engine's native dtype); otherwise PCM at `width` bytes."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    n_ch, n = x.shape
    if float_format:
        data = np.ascontiguousarray(x.T, dtype="<f4").tobytes()
        block_align = n_ch * 4
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
            3, n_ch, rate, rate * block_align, block_align, 32,
            b"data", len(data),
        )
        with open(path, "wb") as f:
            f.write(hdr)
            f.write(data)
        return
    clipped = np.clip(x.T, -1.0, 1.0)  # interleave as [frames, channels]
    # round-to-nearest, NOT truncation: astype() truncates toward zero,
    # which silently deletes sub-LSB dither noise (found by driving the CLI
    # with a silent input) and biases quantization by up to 1 LSB
    if width == 2:
        data = np.round(clipped * 32767.0).astype("<i2").tobytes()
    elif width == 3:
        ints = np.round(clipped * float((1 << 23) - 1)).astype(np.int32)
        b = np.empty((ints.size, 3), dtype=np.uint8)
        flat = ints.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        data = b.tobytes()
    elif width == 4:
        data = np.round(
            clipped.astype(np.float64) * float((1 << 31) - 1)
        ).astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported sample width {width}")
    with wave.open(path, "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data)
