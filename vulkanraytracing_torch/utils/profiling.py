"""Tracing hooks: spans, per-frame counters, traces, and the Mrays/s counter.

Counterpart of ``vulkanraytracing_tpu/utils/profiling.py``:

- ``trace_scope``: a named span.  While a ``torch.profiler`` session
  records, it is a ``record_function`` range (``RANGE``), kept in memory
  by the profiler on the same clock as the device's kernels and copies,
  its parent the enclosing range; otherwise it is a shared no-op context
  (no range, no clock read).  ``span`` is the same around a whole
  function.  The port's spans are named ``vrt.<layer>``: every span of a
  frame lies inside that frame's ``vrt.frame``;
- the frame's counters (``host_sync``, ``count_traversal``, ``count``):
  host integers, always on, a few dictionary increments a call; nothing
  is added on the device and nothing is read back.  ``Engine.draw`` opens
  a frame (``begin_frame``) and closes it (``end_frame``), which keeps a
  copy of its counts for ``frame_counts``;
- ``profile_to``: a ``torch.profiler`` trace of host and card activity
  (host only where there is no card), written into a directory as a Chrome
  trace (open it in Perfetto or ``chrome://tracing``);
- ``RayCounter``: the Mrays/s counter the Engine's stats lines show.

``utils.timing.ScopeTime`` is the stopwatch that logs a scope's time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import Counter
from pathlib import Path

import torch

# is a torch.profiler session recording? (one C call)
_recording = torch.autograd._profiler_enabled


class _UserRange:
    """A ``record_function`` range (user scope: the profiler gives its
    kernels the same parents, and the device trace the same annotation)
    entered through the profiler's own binding, without the dispatcher
    call of ``record_function``: about 5 us of host time against 13 on
    the host of an H100 server."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.handle = torch._C._autograd._record_function_with_args_enter(self.name)

    def __exit__(self, *exc) -> None:
        torch._C._autograd._record_function_with_args_exit(self.handle)


# the range a span opens while a session records
RANGE = _UserRange if hasattr(torch._C._autograd, "_record_function_with_args_enter") \
    else torch.profiler.record_function

# the span when nothing records: enters and leaves doing nothing
_NO_SPAN = contextlib.nullcontext()

# the counts of the frame being drawn, and of the last finished frame
_frame: Counter = Counter()
_last: Counter = Counter()


def trace_scope(name: str):
    """The span ``name``: a profiler range while a profiler session
    records, else a shared no-op context."""
    if not _recording():
        return _NO_SPAN
    return RANGE(name)


def span(name: str):
    """Decorator: each call of the function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with RANGE(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def host_sync(site: str):
    """Count a call at ``site`` that makes the host wait for the device (a
    read back to the host, or a copy from pageable host memory, which
    waits for the stream): ``syncs`` and ``syncs.<site>``; returns its
    ``vrt.sync.<site>`` span, to hold around the call."""
    _frame["syncs"] += 1
    _frame["syncs." + site] += 1
    return trace_scope("vrt.sync." + site)


def count_traversal(kind: str, lanes: int) -> None:
    """Count one traversal call of ``lanes`` rays, ``kind`` ``closest``
    or ``any``: ``traversal_calls`` and ``traversal_lanes``, each also
    under ``.<kind>``."""
    f = _frame
    f["traversal_calls"] += 1
    f["traversal_lanes"] += lanes
    f["traversal_calls." + kind] += 1
    f["traversal_lanes." + kind] += lanes


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the frame's count ``name``."""
    _frame[name] += n


def begin_frame() -> None:
    """Start counting a new frame."""
    _frame.clear()


def end_frame() -> None:
    """Keep the frame's counts as the last finished frame's."""
    global _last
    _last = Counter(_frame)


def frame_counts() -> Counter:
    """The last finished frame's counts (a copy; empty before any)."""
    return Counter(_last)


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
