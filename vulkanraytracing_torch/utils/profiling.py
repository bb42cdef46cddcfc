"""Tracing and profiling hooks, and the Mrays/s counter.

Counterpart of ``vulkanraytracing_tpu/utils/profiling.py``:

- ``trace_scope``: a named range (``torch.profiler.record_function``) and
  the wall clock in one context manager; the name shows up in profiler
  traces, and with ``log=True`` the milliseconds are logged as a
  ``[TIME]`` line, like the reference's ScopeTime;
- ``profile_to``: a ``torch.profiler`` trace of host and card activity
  (host only where there is no card), written into a directory as a Chrome
  trace (open it in Perfetto or ``chrome://tracing``);
- ``RayCounter``: the Mrays/s counter the Engine's stats lines show.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from vulkanraytracing_torch.utils.logging import log_t


@contextlib.contextmanager
def trace_scope(name: str, log: bool = False):
    """Named region: appears in ``torch.profiler`` traces; optionally logs
    its wall time (host clock; the card is not synchronized)."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if log:
        log_t(f"{name}: {(time.perf_counter() - start) * 1e3:.3f} ms")


@contextlib.contextmanager
def profile_to(log_dir: str | os.PathLike):
    """Profile the block and write its Chrome trace into ``log_dir``
    (created if missing) as ``trace_<pid>_<ns>.json``; yields the
    ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
