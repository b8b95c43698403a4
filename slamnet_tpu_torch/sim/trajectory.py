"""Scripted ground-truth trajectories through the default field (numpy).

Copied from ``slamnet_tpu/sim/trajectory.py`` (importing it would run
``slamnet_tpu/sim/__init__.py``, which imports jax).  The reference's
trajectory generator is the user's mouse (MainWindow.xaml.cs:414-465); for a
deterministic test oracle the robot follows a waypoint path through the free
space of the default field, rate-limited to HectorSLAM's operating envelope
(README.md:35-40).  ``office_tour_trajectory`` drives the office's rooms
with straight legs and turns in place (``waypoint_drive_trajectory``);
``straight_trajectory``, ``rect_drive_trajectory`` and ``spin_trajectory``
are the JAX package's short test paths.
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


def rect_revisit_trajectory(num_loops: int = 2, speed: float = 0.95,
                            scan_rate: float = 17.0,
                            rect=((20.0, 20.0), (24.0, 20.0),
                                  (24.0, 23.0), (20.0, 23.0))) -> np.ndarray:
    """Rectangular loop driven forward ``num_loops`` times: the graph-SLAM
    revisit benchmark trajectory.  Four 90-degree turns a loop, spread over
    several scans by the follower's turn-rate limit, and a return to the
    start corner each loop, so loop closures fire under rotation.  The
    rectangle lies in the free space east of the default field's inner
    obstacle (x > 17)."""
    pts = list(rect)
    waypoints = np.asarray(pts * num_loops + [pts[0]], np.float32)
    return waypoint_trajectory(waypoints, speed, scan_rate)


def stationary_trajectory(pose=(20.0, 20.0, 0.0),
                          num_scans: int = 50) -> np.ndarray:
    """The robot standing still at ``pose``: f32[num_scans, 3]."""
    return np.tile(np.asarray(pose, np.float32), (num_scans, 1))


def straight_trajectory(start=(20.0, 20.0, 0.0), speed: float = 0.25,
                        scan_rate: float = 17.0,
                        num_scans: int = 200) -> np.ndarray:
    """Straight line along the start heading."""
    start = np.asarray(start, np.float64)
    t = np.arange(num_scans) / scan_rate
    x = start[0] + speed * t * math.cos(start[2])
    y = start[1] + speed * t * math.sin(start[2])
    return np.stack([x, y, np.full_like(x, start[2])],
                    axis=-1).astype(np.float32)


def rect_drive_trajectory(rect=((20.0, 20.0), (22.0, 20.0),
                                (22.0, 21.2), (20.0, 21.2)),
                          num_loops: int = 1, step: float = 0.3,
                          turn_step: float = math.radians(10.0),
                          closing_leg: int = 1) -> np.ndarray:
    """A compact turning loop: the rectangle driven ``num_loops`` times plus
    ``closing_leg`` extra legs, straight legs at ``step`` m a scan and the
    corners turned in place at ``turn_step`` rad a scan, so the path comes
    back to its start corner in a few dozen scans."""
    n = len(rect)
    legs = num_loops * n + closing_leg
    return waypoint_drive_trajectory(
        [rect[i % n] for i in range(legs + 1)], step=step, turn_step=turn_step)


def waypoint_drive_trajectory(waypoints, step: float = 0.25,
                              turn_step: float = math.radians(10.0)
                              ) -> np.ndarray:
    """Drive an open waypoint path: straight legs at ``step`` m a scan,
    heading changes turned in place at ``turn_step`` rad a scan (each motion
    inside Hector's envelope) -> poses f32[T, 3]."""
    pts = [np.asarray(p, np.float64) for p in waypoints]
    poses = []
    heading = 0.0
    pos = pts[0].copy()
    for target in pts[1:]:
        d = target - pos
        target_heading = math.atan2(d[1], d[0])
        dh = (target_heading - heading + math.pi) % (2 * math.pi) - math.pi
        while abs(dh) > 1e-6:
            turn = float(np.clip(dh, -turn_step, turn_step))
            heading += turn
            poses.append([pos[0], pos[1], heading])
            dh -= turn
        dist = float(np.hypot(*d))
        n_steps = max(1, int(round(dist / step)))
        for s in range(1, n_steps + 1):
            p = pos + d * (s / n_steps)
            poses.append([p[0], p[1], heading])
        pos = target.copy()
    return np.asarray(poses, np.float32)


def office_tour_trajectory(num_loops: int = 2,
                           step: float = 0.25) -> np.ndarray:
    """The office tour: rooms A -> B -> C -> D -> A through the doors'
    centres, ``num_loops`` laps, ending inside room A (679 poses at the
    defaults)."""
    a, b = (9.5, 9.5), (27.5, 9.5)
    c, d = (27.5, 27.5), (9.5, 27.5)
    d_ab, d_bc = (18.5, 9.0), (28.0, 18.5)
    d_cd, d_da = (18.5, 28.0), (9.0, 18.5)
    lap = [d_ab, b, d_bc, c, d_cd, d, d_da, a]
    return waypoint_drive_trajectory([a] + lap * num_loops + [(12.5, 12.5)],
                                     step=step)


def spin_trajectory(pose=(20.0, 20.0, 0.0),
                    turn_rate: float = math.radians(40.0),
                    scan_rate: float = 17.0,
                    num_scans: int = 150) -> np.ndarray:
    """Rotate in place at ``turn_rate`` rad/s (inside the ~20 deg/scan
    envelope)."""
    pose = np.asarray(pose, np.float64)
    t = np.arange(num_scans) / scan_rate
    th = pose[2] + turn_rate * t
    return np.stack([np.full_like(th, pose[0]), np.full_like(th, pose[1]),
                     th], axis=-1).astype(np.float32)
