"""Device-to-host reads per job: every read the program's app calls made
(``apps.host_reads.<app>``: the loop conditions, the frontier switch, K5's
segment fallback) over its app calls (``apps.jobs.<app>``), over the
whole run (the warm-up and both windows, all drawn from the cell's
mix)."""
from bench.lib.program import total


def read(run):
    reads, jobs = total("apps.host_reads."), total("apps.jobs.")
    return reads / jobs if reads and jobs else None
