"""Seconds of the set-up stage ``scene_load`` on the host clock, the card
synchronized before and after: the hall and sky files, and a moving
configuration's mesh file."""


def read(run):
    return run.setup_stages.get("scene_load")
