"""Device ms a frame under the program's ``vrt.nee`` spans (the body of
``pt/integrator.py::sample_point_light``: the point lights' estimates,
their CDF and the pick), outermost spans only.  A moving configuration reads as a static one."""

from rtbench.yardstick import outermost, range_device_ms

SPANS = ("vrt.nee",)


def read(run):
    host = run.ranges["host"]
    if not outermost(host, SPANS):
        return None
    return range_device_ms(host, SPANS) / run.ranges["frames"]
