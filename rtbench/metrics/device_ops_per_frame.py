"""Device operations (kernels and copies) in the profiled frames, a frame."""


def read(run):
    prof = run.device_profile
    return len(prof["events"]) / prof["frames"] if prof["events"] else None
