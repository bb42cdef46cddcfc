"""Device ms a frame under ``pt/integrator.py::sample_point_light``: the
point lights' estimates, their CDF (``torch.cumsum``) and the pick."""

from rtbench.yardstick import outermost, range_device_ms

RANGES = {"sample_point_light": "vulkanraytracing_torch.pt.integrator.sample_point_light"}



def read(run):
    host = run.ranges["host"]
    if not outermost(host, RANGES):
        return None
    return range_device_ms(host, RANGES) / run.ranges["frames"]
