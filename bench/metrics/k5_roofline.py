"""K5's share of its roofline in PageRank, in %: the work bytes of every
pull of the traced window (``bench.lib.work.pull_bytes``) at the data
sheet's bandwidth, over K5's device time in that window.  Read only where
every K5 launch of the window is a PageRank pull (a mix of PageRank jobs
alone)."""
from bench.lib.work import K5_KERNELS


def read(run):
    t = run.traced
    if t is None or {app for app, _ in t.jobs} != {"pagerank"}:
        return None
    pulls = t.counters.get("pagerank.pulls", 0)
    k5 = t.trace.seconds_matching(K5_KERNELS)
    if not pulls or k5 <= 0:
        return None
    least = pulls * run.sizes["pull_work_bytes"] / run.peak["hbm_bytes_per_s"]
    return 100.0 * least / k5
