"""Seconds of the backend build's upload (every host-to-device copy of
the build), as the program publishes them (``engine.build.upload_s``; the
span ``engine.build.upload``).  Read where the process made one build."""
from bench.lib.program import phase_seconds


def read(run):
    return phase_seconds("engine.build", "upload")
