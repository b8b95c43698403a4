"""Dataset helpers (numpy), copied from ``slamnet_tpu/io``."""
from . import datasets
from .datasets import drifting_odometry

__all__ = ["datasets", "drifting_odometry"]
