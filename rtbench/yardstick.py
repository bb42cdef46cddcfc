"""The benchmark's fixed arithmetic: percentiles, the device's busy time
from a trace, and the least time a ray traversal could take.

The peaks are those of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores.  A traversal's work is the slab and triangle tests that the
benchmark's own per-ray traversal (``reference/bvh.py``) needs over the
benchmark's own tree for the call's rays: a slab test is 6 differences, 6
products, 6 min/max, 3 max for the entry, 3 min for the exit and a compare
(25 operations); a Moller-Trumbore test is 27 products, 17 sums and
differences, the guarded reciprocal (4) and the window (8), 56 in all.
Its bytes are each ray's inputs (origin, direction, t_min, t_max: 32 B)
and result (t, u, v, triangle, back face: 17 B; an any-hit verdict: 1 B)
and each triangle of the tree once (48 B: a vertex, two edges and their
flags and id).
"""

from __future__ import annotations

import math
import statistics

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
BOX_OPS = 25
TRI_OPS = 56
RAY_IN_BYTES = 32
RAY_OUT_BYTES = {"closest": 17, "any": 1}
TRI_BYTES = 48


def percentile(values, pct: int) -> float:
    """The ``pct``-th percentile of ``values`` (Python's ``statistics``,
    the inclusive method: linear between the order statistics)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def traversal_bound_ms(kind: str, n_rays: int, n_tris: int, box_tests: int,
                       tri_tests: int) -> float:
    """The least ms a traversal call could take on the card: the larger of
    its bytes over the memory peak and its operations over float32 peak."""
    n_bytes = n_rays * (RAY_IN_BYTES + RAY_OUT_BYTES[kind]) + n_tris * TRI_BYTES
    ops = box_tests * BOX_OPS + tri_tests * TRI_OPS
    return max(n_bytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3


def outermost(host, names):
    """The host range events named in ``names`` that have no ancestor
    named in ``names``: a call inside another is counted once."""
    names = set(names)
    return [h for h in host if h["name"] in names and not names & set(h["ancestors"])]


def range_device_ms(host, names, inside=()) -> float:
    """Device ms of the kernels launched under the outermost ranges of
    ``names``, only those lying inside a range named in ``inside`` where
    that is given."""
    rows = outermost(host, names)
    if inside:
        rows = [h for h in rows if set(inside) & set(h["ancestors"])]
    return sum(h["device_us"] for h in rows) * 1e-3
