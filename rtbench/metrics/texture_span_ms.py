"""Device ms a frame under the program's ``vrt.texture`` spans (the body
of ``ops/texture.py::sample_pool``), outermost spans only, wherever the
program samples from."""

from rtbench.yardstick import outermost, range_device_ms

SPANS = ("vrt.texture",)


def read(run):
    host = run.ranges["host"]
    if not outermost(host, SPANS):
        return None
    return range_device_ms(host, SPANS) / run.ranges["frames"]
