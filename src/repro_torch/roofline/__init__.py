"""Hardware roofline profiles (``HW``) for the port's cost model."""
from .analysis import HW, HW_PROFILES  # noqa: F401

__all__ = ["HW", "HW_PROFILES"]
