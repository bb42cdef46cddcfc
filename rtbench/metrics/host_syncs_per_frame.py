"""Calls that make the host wait for the device in the last frame drawn
(the program's ``syncs`` count, one at each ``vrt.sync.*`` span, read
through ``utils.profiling.frame_counts``).  A program without the count
reads None.  A moving configuration reads as a static one (a
frame that packs a table after a refit counts its wait)."""


def read(run):
    from vulkanraytracing_torch.utils import profiling

    frame_counts = getattr(profiling, "frame_counts", None)
    if frame_counts is None:
        return None
    counts = frame_counts()
    return counts["syncs"] if counts else None
