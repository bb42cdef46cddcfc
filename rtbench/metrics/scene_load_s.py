"""Seconds of the set-up stage ``scene_load`` on the host clock, the card
synchronized before and after."""


def read(run):
    return run.setup_stages.get("scene_load")
