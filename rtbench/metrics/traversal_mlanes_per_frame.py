"""Millions of ray lanes handed to the traversal backends in the last
frame drawn (the program's ``traversal_lanes`` count at
``ops/trace.py``'s ``traverse_closest`` and ``traverse_any``, through
which every traversal of a tree goes, read through
``utils.profiling.frame_counts``).  A program without the count reads
None."""


def read(run):
    from vulkanraytracing_torch.utils import profiling

    frame_counts = getattr(profiling, "frame_counts", None)
    if frame_counts is None:
        return None
    counts = frame_counts()
    return counts["traversal_lanes"] / 1e6 if counts else None
