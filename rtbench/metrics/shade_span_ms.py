"""Device ms a frame under the program's ``vrt.shade`` spans (each
bounce's shading in ``pt/integrator.py::pathtrace``: environment lookup,
surface fetch, material unpack, emission, the lights' contributions, the
BSDF sample, roulette and the next ray), outermost spans only, less the
``vrt.nee`` and ``vrt.texture`` spans inside them, which
``nee_span_ms`` and ``texture_span_ms`` count.  A moving configuration
reads as a static one."""

from rtbench.yardstick import outermost, range_device_ms

SPANS = ("vrt.shade",)
INNER = ("vrt.nee", "vrt.texture")


def read(run):
    host = run.ranges["host"]
    if not outermost(host, SPANS):
        return None
    ms = range_device_ms(host, SPANS) - range_device_ms(host, INNER, inside=SPANS)
    return ms / run.ranges["frames"]
