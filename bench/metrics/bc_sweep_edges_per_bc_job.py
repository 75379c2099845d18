"""Edges BC's backward sweep walks per BC job: the program's
``engine.out_edge_sum.edges`` (every edge, once per level) over its BC
calls (``apps.jobs.bc``), over the whole run."""
from bench.lib.program import value


def read(run):
    edges, jobs = value("engine.out_edge_sum.edges"), value("apps.jobs.bc")
    return edges / jobs if edges and jobs else None
