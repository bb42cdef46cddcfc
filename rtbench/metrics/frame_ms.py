"""Frame time: the window's wall time over the frames it completed; the
same under motion."""


def read(run):
    return 1e3 * run.window_s / len(run.frame_s)
