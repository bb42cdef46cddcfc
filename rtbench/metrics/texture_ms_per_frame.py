"""Device ms a frame under every call of ``ops/texture.py::sample_pool``
(outermost ranges only), wherever the program calls it from."""

from rtbench.yardstick import outermost, range_device_ms

RANGES = {"sample_pool": "vulkanraytracing_torch.ops.texture.sample_pool"}



def read(run):
    host = run.ranges["host"]
    if not outermost(host, RANGES):
        return None
    return range_device_ms(host, RANGES) / run.ranges["frames"]
