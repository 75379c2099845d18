"""The 95th percentile (nearest rank) of the job times of the window, in
ms: every job, each timed on the host from its call to the device sync
after it."""
import math


def read(run):
    times = sorted(t for _, t in run.window.jobs)
    return 1000.0 * times[math.ceil(0.95 * len(times)) - 1]
