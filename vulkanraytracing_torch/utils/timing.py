"""Per-frame delta-time source.

Counterpart of ``Timer`` in ``vulkanraytracing_tpu/utils/timing.py``.
"""

from __future__ import annotations

import time


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
