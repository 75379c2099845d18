# Training on one device: the optimizer step and int8 gradient compression.
from . import compress, step  # noqa: F401
