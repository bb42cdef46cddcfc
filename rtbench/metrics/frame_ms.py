"""Frame time: the window's wall time over the frames it completed."""


def read(run):
    return 1e3 * run.window_s / len(run.frame_s)
