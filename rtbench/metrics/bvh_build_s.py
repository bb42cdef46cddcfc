"""Seconds of the set-up stage ``bvh_build`` on the host clock, the card
synchronized before and after.  A moving configuration has no such
stage (its tree is built by the Engine, the stage ``tlas_build``) and
reads None."""


def read(run):
    return run.setup_stages.get("bvh_build")
