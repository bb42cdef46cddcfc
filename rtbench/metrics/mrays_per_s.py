"""Rays the integrator counted over the window's frames (``TraceStats.rays``,
read back by ``Engine.draw``), over the window's wall time.  The count is
the program's own: the check does not hold it to the reference, so this
metric is unverified (a program that miscounts its rays moves it unseen).  A moving configuration reads as a static one."""


def read(run):
    if not run.window_rays:
        return None
    return run.window_rays / run.window_s / 1e6
