"""What a traced run reads from the program.  Three passes of frames:

- ``profile_device``: ``torch.profiler`` with device activity only, a first
  frame thrown away, then ``frames`` frames: each kernel and copy with its
  name and its start and end (us), and the frames' wall seconds;
- ``profile_ranges``: host and device activity over one frame, a first
  thrown away: every host range (the program's ``vrt.*`` spans among them)
  with its ancestors' names and the device time of the kernels launched
  inside it, and the device intervals;
- ``record_calls``: each call's arguments, tensors cloned, in one frame
  whose device activity is traced too.  It wraps each named function of
  the program where it is bound (the module that defines it and every
  module that imports it by name, so that a call through any of them is
  seen) for that frame only.

The device events are the kernels, copies and sets.  The device-side
copy of a host range that kineto adds (a ``gpu_user_annotation``, named as
the range and spanning the kernels launched inside it) is left out: it is
no work, and it would cover the idle gaps inside its range.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time

import torch

PACKAGE = "vulkanraytracing_torch"


def resolve(path: str):
    module, attr = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)


def bindings(fn) -> list[tuple[object, str]]:
    """Every (module, name) of the program bound to ``fn``."""
    out = []
    for name, module in list(sys.modules.items()):
        if module is None or name.split(".")[0] != PACKAGE:
            continue
        for attr, value in list(vars(module).items()):
            if value is fn:
                out.append((module, attr))
    return out


@contextlib.contextmanager
def wrapped(targets: dict, make):
    """Replace each target (``{name: dotted path}``) by ``make(name, fn)``
    wherever the program binds it, for the duration."""
    saved = []
    try:
        for name, path in targets.items():
            fn = resolve(path)
            wrapper = make(name, fn)
            for module, attr in bindings(fn):
                saved.append((module, attr, fn))
                setattr(module, attr, wrapper)
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of each device event that does not carry
    the name of a host event of the same profile."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA and e.name not in host]


def profile_device(draw, frames: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        draw()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            draw()
        wall = time.perf_counter() - t0
    return {"events": _device_events(prof), "wall_s": wall, "frames": frames}


def profile_ranges(draw) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        draw()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        draw()
        wall = time.perf_counter() - t0
    host = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        ancestors, parent = [], e.cpu_parent
        while parent is not None:
            ancestors.append(parent.name)
            parent = parent.cpu_parent
        device_us = getattr(e, "device_time_total", None)
        if device_us is None:
            device_us = e.cuda_time_total
        host.append({"name": e.name, "start": e.time_range.start, "end": e.time_range.end,
                     "ancestors": ancestors, "device_us": float(device_us)})
    return {"host": host, "device": _device_events(prof), "wall_s": wall, "frames": 1}


def record_calls(draw, targets: dict) -> dict:
    from torch.profiler import ProfilerActivity, profile

    calls = []

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def make(name, fn):
        def inner(*a, **k):
            calls.append((name, tuple(clone(x) for x in a), {n: clone(v) for n, v in k.items()}))
            return fn(*a, **k)
        return inner

    with wrapped(targets, make):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            draw()
    return {"calls": calls, "device": _device_events(prof)}
