"""Seconds of the CSR relabel (``graph.csr.relabel``, on the host) inside
the program's ``reorder_graph``, as the program publishes them
(``reorder.relabel_s``; the span ``reorder.relabel``).  Read where the
process made one reorder."""
from bench.lib.program import phase_seconds


def read(run):
    return phase_seconds("reorder", "relabel")
