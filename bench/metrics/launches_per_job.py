"""Device kernels per job: the kernels the trace holds in the traced
window over the jobs of that window."""


def read(run):
    t = run.traced
    if t is None or not t.trace.device_events or not t.jobs:
        return None
    return t.trace.kernels / len(t.jobs)
