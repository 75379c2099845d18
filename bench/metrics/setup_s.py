"""Set-up: from the start of the process to the window (inputs, the
program's reorder and backend build, kernel loads, the warm-up)."""


def read(run):
    return run.setup_s
