#!/usr/bin/env python3
"""Where a frame leaves the card idle: each gap between the device's
kernels and copies inside a ``vrt.frame``, put down to the innermost
``vrt.*`` span open on the host at the gap's start.

    python3 -m vulkanraytracing_torch.tools.idle_by_span TRACE.json [--skip N]

``TRACE.json`` is a Chrome trace that ``utils.profiling.profile_to``
wrote, for instance through ``render ... --profile DIR``.  ``--skip N``
leaves out the first N frames: the first frame of a session that also
holds the set-up packs the traversal tables, and the first frame of a
session opened before it waits for the session's start.  Prints one JSON
object: the frames read, their mean wall and idle ms, and the idle ms a
frame by span, largest first.  A trace with no device activity (a CPU
run) reads every frame as idle.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

# the Chrome trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no busy interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(busy):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def idle_by_span(events, skip: int = 0) -> dict:
    """The frames' idle time by innermost span, from a Chrome trace's
    ``traceEvents`` (times in us; the result in ms)."""
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append((start, end))
        elif e.get("cat") != "gpu_user_annotation" and str(e.get("name")).startswith("vrt."):
            spans.append((start, end, e["name"]))
    frames = sorted((s, e) for s, e, name in spans if name == "vrt.frame")[skip:]
    by_span = defaultdict(float)
    wall = idle = 0.0
    for fs, fe in frames:
        inside = [(s, e, name) for s, e, name in spans if s >= fs and e <= fe]
        busy = [(max(s, fs), min(e, fe)) for s, e in device if e > fs and s < fe]
        wall += fe - fs
        for gs, ge in _gaps(busy, fs, fe):
            # the innermost open span: the latest to start, then the shortest
            open_ = [(s, -e, name) for s, e, name in inside if s <= gs < e]
            by_span[max(open_)[2] if open_ else "vrt.frame"] += ge - gs
            idle += ge - gs
    n = max(len(frames), 1)
    return {
        "frames": len(frames),
        "wall_ms": wall / n * 1e-3,
        "idle_ms": idle / n * 1e-3,
        "idle_ms_by_span": {name: ms / n * 1e-3 for name, ms in
                            sorted(by_span.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    skip = 0
    if "--skip" in args:
        i = args.index("--skip")
        skip = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 1:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    with open(args[0]) as f:
        trace = json.load(f)
    print(json.dumps(idle_by_span(trace["traceEvents"], skip)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
