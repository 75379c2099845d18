"""Share of the time in which no operation runs on the device, in %, at
the unprofiled pace: one less the union of device activity per job of the
traced window over the measured window's time per job
(``Run.untraced_share``).  The traced window's own idle share, which the
profiler's cost per launch raises, is ``busy_s`` against ``window_s``."""


def read(run):
    t = run.traced
    if t is None or not t.trace.device_events:
        return None
    return 100.0 - run.untraced_share(t.trace.busy_s)
