"""The Mrays/s counter the Engine's stats lines show.

Counterpart of ``RayCounter`` in ``vulkanraytracing_tpu/utils/profiling.py``
(its ``trace_scope`` and ``profile_to`` wrap the JAX profiler and are not
ported; ``chip_smoke.py`` traces frames with ``torch.profiler``).
"""

from __future__ import annotations

import time


class RayCounter:
    """Rays per second since creation or the last ``reset``."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._rays = 0.0

    def add(self, rays: float) -> None:
        self._rays += float(rays)

    def mrays_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._rays / dt / 1e6 if dt > 0 else 0.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._rays = 0.0
