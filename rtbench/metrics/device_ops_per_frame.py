"""Device operations (kernels and copies) in the profiled frames, a frame.  A
moving configuration reads as a static one: the refit's operations count."""


def read(run):
    prof = run.device_profile
    return len(prof["events"]) / prof["frames"] if prof["events"] else None
