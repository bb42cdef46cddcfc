"""Set-up: from the program's import to the first measured frame."""


def read(run):
    return run.setup_s
