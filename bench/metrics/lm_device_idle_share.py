"""Share of the time in which no operation runs on the device, in %, at
the unprofiled pace: ``device_idle_share`` read in the LM cells, where the
host's decode loop holds the card back."""
from bench.metrics.device_idle_share import read  # noqa: F401
