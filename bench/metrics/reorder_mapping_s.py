"""Seconds of the ordering's mapping (DBG's grouping, on the host) inside
the program's ``reorder_graph``, as the program publishes them
(``reorder.mapping_s``; the span ``reorder.mapping``).  Read where the
process made one reorder."""
from bench.lib.program import phase_seconds


def read(run):
    return phase_seconds("reorder", "mapping")
