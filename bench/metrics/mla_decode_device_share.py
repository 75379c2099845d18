"""Share of the time in which the MLA decode kernel
(``kernels/mla_decode``: its slices and their combine) runs on the
device, in %, at the unprofiled pace: its device time per step of the
traced window over the measured window's time per step
(``Run.untraced_share``)."""
from bench.lib.lm_work import MLA_DECODE_KERNELS


def read(run):
    if run.traced is None:
        return None
    seconds = run.traced.trace.seconds_matching(MLA_DECODE_KERNELS)
    return run.untraced_share(seconds) if seconds > 0 else None
