"""The device's idle share of the profiled frames' wall time: 100 x (1 -
the union of its kernel and copy intervals / the frames' wall time).  A moving configuration reads as a static one:
its profiled frames hold the refit."""

from rtbench.yardstick import busy_union


def read(run):
    prof = run.device_profile
    if not prof["events"]:
        return None
    busy_s = busy_union([(s, e) for _, s, e in prof["events"]]) * 1e-6
    return 100.0 * (1.0 - busy_s / prof["wall_s"])
