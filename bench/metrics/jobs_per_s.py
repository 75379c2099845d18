"""Jobs completed per second: every job of the window over the window's
length, which ends when the first job to finish past ``--seconds`` does."""


def read(run):
    return len(run.window.jobs) / run.window.seconds
