"""Seconds of the set-up stage ``ibl_bake`` on the host clock, the card
synchronized before and after; the same under motion (a moving
configuration runs path tracing only)."""


def read(run):
    return run.setup_stages.get("ibl_bake")
