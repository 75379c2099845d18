"""Seconds of the program's ``reorder_graph`` (the mapping and the CSR
relabel, on the host), from the benchmark's span around the call."""


def read(run):
    return run.spans.get("reorder")
