"""Device ms a frame under the program's ``vrt.sort`` spans (the body of
``ops/reorder.py::sort_wavefront``: keys, the stable sort and every
column's gather), outermost spans only."""

from rtbench.yardstick import outermost, range_device_ms

SPANS = ("vrt.sort",)


def read(run):
    host = run.ranges["host"]
    if not outermost(host, SPANS):
        return None
    return range_device_ms(host, SPANS) / run.ranges["frames"]
