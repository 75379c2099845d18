"""Share of the time in which K5's kernels (the program's fused edge map,
``csrc/edge_map.cu``) run on the device, in %, at the unprofiled pace:
their device time per job of the traced window over the measured window's
time per job (``Run.untraced_share``)."""
from bench.lib.work import K5_KERNELS


def read(run):
    if run.traced is None:
        return None
    k5 = run.traced.trace.seconds_matching(K5_KERNELS)
    return run.untraced_share(k5) if k5 > 0 else None
