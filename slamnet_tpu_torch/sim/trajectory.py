"""Scripted ground-truth trajectories through the default field (numpy).

Copied from ``slamnet_tpu/sim/trajectory.py`` (importing it would run
``slamnet_tpu/sim/__init__.py``, which imports jax).  The reference's
trajectory generator is the user's mouse (MainWindow.xaml.cs:414-465); for a
deterministic test oracle the robot follows a waypoint path through the free
space of the default field, rate-limited to HectorSLAM's operating envelope
(README.md:35-40).
"""
from __future__ import annotations

import math

import numpy as np

# Waypoints in world meters, inside the free space of default_field(30, (5,5)).
# The field spans [5,35]x[5,35] with an inner obstacle around x in [11,17], y in [14,26].
LOOP_WAYPOINTS = np.array(
    [
        [20.0, 20.0], [26.0, 20.0], [28.0, 14.0], [26.0, 9.0],
        [18.0, 8.0], [10.0, 10.0], [8.5, 18.0], [9.0, 26.0],
        [16.0, 31.0], [24.0, 31.0], [28.0, 26.0], [22.0, 22.0],
        [20.0, 20.0],
    ],
    dtype=np.float32,
)


def waypoint_trajectory(waypoints: np.ndarray, speed: float, scan_rate: float,
                        max_turn_rate: float = math.radians(60.0)) -> np.ndarray:
    """Constant-speed waypoint follower sampled at scan_rate Hz -> poses f32[T, 3].

    Heading turns toward the path direction at <= max_turn_rate rad/s (keeps the
    angular rate inside Hector's ~20 deg/scan envelope at 17 Hz).
    """
    dt = 1.0 / scan_rate
    poses = []
    pos = waypoints[0].astype(np.float64)
    heading = 0.0
    for wp in waypoints[1:]:
        # step cap: a rate-limited follower can orbit a waypoint it cannot
        # curve into — cap the steps per leg and move on (the path cuts that
        # corner) instead of looping forever
        leg = float(np.hypot(*(wp - pos)))
        max_steps = int(4.0 * leg / (speed * dt)) + int(
            2.0 * math.pi / max(max_turn_rate * dt, 1e-6)) + 8
        for _ in range(max_steps):
            delta = wp - pos
            dist = float(np.hypot(*delta))
            if dist < speed * dt:
                break
            target_heading = math.atan2(delta[1], delta[0])
            dh = (target_heading - heading + math.pi) % (2 * math.pi) - math.pi
            max_dh = max_turn_rate * dt
            heading += float(np.clip(dh, -max_dh, max_dh))
            pos = pos + np.array([math.cos(heading), math.sin(heading)]) * speed * dt
            poses.append([pos[0], pos[1], heading])
    return np.asarray(poses, np.float32)


def loop_trajectory(speed: float = 0.3, scan_rate: float = 17.0) -> np.ndarray:
    """The standard test loop: ~170 m around the field at 0.3 m/s (inside envelope)."""
    return waypoint_trajectory(LOOP_WAYPOINTS, speed, scan_rate)
