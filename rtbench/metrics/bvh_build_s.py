"""Seconds of the set-up stage ``bvh_build`` on the host clock, the card
synchronized before and after."""


def read(run):
    return run.setup_stages.get("bvh_build")
