"""Seconds of the backend build's host packing (every numpy array: the ELL
tiles and the flat arrays), as the program publishes them
(``engine.build.pack_s``; the span ``engine.build.pack``).  Read where the
process made one build."""
from bench.lib.program import phase_seconds


def read(run):
    return phase_seconds("engine.build", "pack")
