"""Set-up: from the program's import to the first measured frame; a
moving configuration's includes the Engine's two-level build."""


def read(run):
    return run.setup_s
