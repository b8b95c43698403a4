"""Host-side I/O (numpy and the standard library): CARMEN logs
(``datasets``), checkpoints, map export, metrics, the HTML replay viewer
(``live``) and PNG rendering (``viz``, matplotlib imported when called);
``interactive`` (the simulator's HTTP app) is imported on its own."""
from . import checkpoint, datasets, export, live, metrics, viz
from .datasets import drifting_odometry

__all__ = ["checkpoint", "datasets", "export", "live", "metrics", "viz",
           "drifting_odometry"]
