"""Device ms of the wavefront sort in one frame: CUDA events around each
call of ``ops/reorder.py::sort_wavefront`` (keys, the stable sort and
every column's gather)."""

TIMERS = {"sort_wavefront": "vulkanraytracing_torch.ops.reorder.sort_wavefront"}


def read(run):
    calls = (run.timers or {}).get("sort_wavefront")
    return sum(calls) if calls else None
