"""Calls that make the host wait for the device in the last frame drawn
(the program's ``syncs`` count, one at each ``vrt.sync.*`` span, read
through ``utils.profiling.frame_counts``).  A program without the count
reads None."""


def read(run):
    from vulkanraytracing_torch.utils import profiling

    frame_counts = getattr(profiling, "frame_counts", None)
    if frame_counts is None:
        return None
    counts = frame_counts()
    return counts["syncs"] if counts else None
