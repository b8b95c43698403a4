from . import config, debug, geometry, scan
from .config import (CoreSlamConfig, HectorConfig, ParticleConfig,
                     PoseGraphConfig, SimConfig, SlamConfig,
                     serving_hector_config)
from .scan import Scan, SegmentScan, polar_scan, segments_to_cloud

__all__ = [
    "config", "debug", "geometry", "scan",
    "CoreSlamConfig", "HectorConfig", "ParticleConfig", "PoseGraphConfig",
    "SimConfig", "SlamConfig", "serving_hector_config", "Scan",
    "SegmentScan", "polar_scan", "segments_to_cloud",
]
