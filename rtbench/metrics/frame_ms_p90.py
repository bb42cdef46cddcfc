"""The 90th percentile of the window's frame times (every frame); the
same under motion."""

from rtbench.yardstick import percentile


def read(run):
    return 1e3 * percentile(run.frame_s, 90)
