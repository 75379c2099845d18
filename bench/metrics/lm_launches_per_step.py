"""Device kernels per LM decode step: ``launches_per_job`` read in the LM
cells, where a job is one batched decode step."""
from bench.metrics.launches_per_job import read  # noqa: F401
