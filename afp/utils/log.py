"""Structured logging (SURVEY.md §5.5).

The reference reports through bare ``print()`` calls scattered across the hot
path (`reference/stream_process.py:82-85, 93, 116`,
`stream_process_AGC.py:196-201`).  Here every subsystem logs through one
namespaced logger with rate-limiting for per-block events, so a stressed
engine cannot flood stdout from the block loop.
"""
from __future__ import annotations

import logging
import time
from typing import Dict

__all__ = ["get_logger", "RateLimited"]

_root = logging.getLogger("afp")
if not _root.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    _root.addHandler(_h)
    _root.setLevel(logging.INFO)
    # we own a handler, so stop propagating to the root logger — an
    # embedding app's basicConfig() would otherwise print every message
    # twice (defeating the rate limiter's flood protection)
    _root.propagate = False


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"afp.{name}")


class RateLimited:
    """Per-key rate-limited logging for block-loop events (the reference logs
    overruns 'every ~10 seconds', `stream_process_EQ_GUI.py:107-111`)."""

    def __init__(self, logger: logging.Logger, min_interval: float = 10.0):
        self.logger = logger
        self.min_interval = min_interval
        self._last: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}

    def warn(self, key: str, msg: str, *args) -> None:
        now = time.monotonic()
        last = self._last.get(key, 0.0)
        if now - last >= self.min_interval:
            n = self._suppressed.pop(key, 0)
            suffix = f" (+{n} suppressed)" if n else ""
            self.logger.warning(msg + suffix, *args)
            self._last[key] = now
        else:
            self._suppressed[key] = self._suppressed.get(key, 0) + 1
