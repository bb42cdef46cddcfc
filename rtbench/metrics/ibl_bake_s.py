"""Seconds of the set-up stage ``ibl_bake`` on the host clock, the card
synchronized before and after."""


def read(run):
    return run.setup_stages.get("ibl_bake")
