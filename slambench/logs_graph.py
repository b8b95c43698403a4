"""The simulator's loop driven once round and on into a second lap: the
graph-SLAM cells' log.

``logs.make_log`` stops at one lap of ``logs.LOOP_WAYPOINTS`` (4,740
poses at 0.3 m/s and 17 scans/s, 83.6 m).  Here the waypoint follower runs
over ``LOOP_WAYPOINTS`` then ``LOOP_WAYPOINTS[1:]`` in one call, so the
heading turns on continuously at the wrap, and a log may take any prefix of
those 9,508 poses.  The ray cast and the noise are ``logs.make_log``'s,
drawn the same way from the same seeded generator: the first lap's scans
are that function's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import logs


def loop_trajectory(sensor: dict) -> np.ndarray:
    """The loop twice round, less the second lap's repeated start:
    f32[T, 3]."""
    waypoints = np.concatenate([logs.LOOP_WAYPOINTS, logs.LOOP_WAYPOINTS[1:]])
    return logs.waypoint_trajectory(waypoints, sensor["speed_m_s"],
                                    sensor["scans_per_s"])


def make_log(seed: int, n_scans: int, sensor: dict, device) -> logs.Log:
    """The first ``n_scans`` poses of ``loop_trajectory``, each a revolution
    of ``sensor["beams"]`` rays with ``logs.make_log``'s noise, drawn from a
    generator on ``device`` seeded with ``seed``."""
    traj_np = loop_trajectory(sensor)
    if n_scans > traj_np.shape[0]:
        raise ValueError(f"the two laps have {traj_np.shape[0]} poses, "
                         f"{n_scans} asked for")
    traj = torch.as_tensor(traj_np[:n_scans], device=device)
    angles = torch.as_tensor(logs.revolution_angles(sensor["beams"]),
                             device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    hit, dist = logs.ray_cast(logs.field_edges(device), traj[:, :2],
                              angles + traj[:, 2:3], sensor["max_range_m"])
    steps = torch.randint(-100, 100, dist.shape, generator=gen, device=device)
    noise = steps.to(torch.float32) / 100.0 * sensor["noise_m"]
    radii = torch.where(hit, dist + noise, torch.zeros_like(dist))
    pts = torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)],
                      dim=-1).contiguous()
    return logs.Log(traj, pts, hit)
