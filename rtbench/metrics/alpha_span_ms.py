"""Device ms a frame under the program's ``vrt.alpha`` spans (the cutout
subset's closest-passing-cutout phase and the whole-scene alpha re-trace
of ``ops/trace.py``), outermost spans only, less the ``vrt.texture``
spans inside them, which ``texture_span_ms`` counts.  The traversal
kernels, launched through ctypes, are not under host spans and are not
counted here."""

from rtbench.yardstick import outermost, range_device_ms

SPANS = ("vrt.alpha",)
INNER = ("vrt.texture",)


def read(run):
    host = run.ranges["host"]
    if not outermost(host, SPANS):
        return None
    ms = range_device_ms(host, SPANS) - range_device_ms(host, INNER, inside=SPANS)
    return ms / run.ranges["frames"]
