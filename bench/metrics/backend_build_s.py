"""Seconds of the program's backend build, ``apps.to_arrays`` (host
packing and upload), from the benchmark's span around the call, synced."""


def read(run):
    return run.spans.get("build")
