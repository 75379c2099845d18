# The synthetic Zipf token stream (numpy copy of ``repro.data``).
from .pipeline import DataConfig, ZipfPipeline  # noqa: F401
