"""Per-frame delta-time source and a scope stopwatch.

Counterpart of ``vulkanraytracing_tpu/utils/timing.py``.  ``ScopeTime``
waits for the card at both ends of its scope, so that what it logs is
the work done inside it and not the time to queue that work.
"""

from __future__ import annotations

import time

import torch

from vulkanraytracing_torch.utils.logging import log_t


class Timer:
    """Seconds since the previous call (0 on the first)."""

    def __init__(self) -> None:
        self._last: float | None = None

    def get_delta_seconds(self) -> float:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        return dt


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ScopeTime:
    """Context manager that logs the elapsed wall clock on exit as
    ``[TIME] <label>: <ms> ms`` (``elapsed`` keeps the seconds)."""

    def __init__(self, label: str) -> None:
        self.label = label
        self.elapsed = 0.0

    def __enter__(self) -> "ScopeTime":
        _sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _sync()
        self.elapsed = time.perf_counter() - self._start
        log_t(f"{self.label}: {self.elapsed * 1e3:.3f} ms")
