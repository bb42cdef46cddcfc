"""Device ms a frame under the alpha split of ``ops/trace.py``
(``_hit_alpha``, ``_resolve_alpha``, ``_closest_alpha_subset``, outermost
ranges only) less the ``sample_pool`` time inside them, which
``texture_ms_per_frame`` counts.  The traversal kernels, launched through
ctypes, are not under host ranges and are not counted here."""

from rtbench.yardstick import outermost, range_device_ms

_T = "vulkanraytracing_torch.ops.trace."
ALPHA = ("_hit_alpha", "_resolve_alpha", "_closest_alpha_subset")
RANGES = {name: _T + name for name in ALPHA}
RANGES["sample_pool"] = "vulkanraytracing_torch.ops.texture.sample_pool"


def read(run):
    host = run.ranges["host"]
    if not outermost(host, ALPHA):
        return None
    ms = range_device_ms(host, ALPHA) - range_device_ms(host, ["sample_pool"], inside=ALPHA)
    return ms / run.ranges["frames"]
