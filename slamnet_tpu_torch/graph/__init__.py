"""Keyframe pose graph and its scan-to-scan frontend (graph-SLAM)."""
