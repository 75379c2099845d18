"""PageRank's share of the roofline over the whole measured window, in %:
the work bytes of every pull of the window at the data sheet's bandwidth,
over the window's length.  Read only in a mix of PageRank jobs alone, and
from the unprofiled window."""


def read(run):
    w = run.window
    pulls = w.counters.get("pagerank.pulls", 0)
    if {app for app, _ in w.jobs} != {"pagerank"} or not pulls:
        return None
    least = pulls * run.sizes["pull_work_bytes"] / run.peak["hbm_bytes_per_s"]
    return 100.0 * least / w.seconds
