from . import field, lidar, trajectory
from .field import Field, default_field, make_field, office_field, ray_cast
from .lidar import (make_cloud, make_segment_scan, revolution_angles,
                    scan_revolution)

__all__ = [
    "field", "lidar", "trajectory", "Field", "default_field", "make_field",
    "office_field", "ray_cast", "make_cloud", "make_segment_scan",
    "revolution_angles", "scan_revolution",
]
