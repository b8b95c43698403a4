"""Seeded scan logs: the benchmark's own copy of the port's log generators.

A frozen copy of ``slamnet_tpu_torch/sim`` (the default field, the ray cast,
the 400-beam revolution with the reference's discrete uniform noise, the
loop trajectory) and of ``replay.make_log`` / ``make_fleet_log``, so that a
change to the program cannot change the traffic it is measured on.  The
simulator is slam.net's (``MainWindow.xaml.cs:35-39``, ``Field.cs:43-72``):
400 rays a revolution, 17 scans/s, 40 m range, +-0.02 m noise on a grid of
0.01 steps, the robot following the loop at 0.3 m/s.

Every log is made on the device it is asked for from a ``torch.Generator``
seeded with ``seed``: the same seed and device type give the same log.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

# CreateDefaultField's vertex lists (Field.cs:45-69) in unit coordinates,
# placed at scale 30 and offset (5, 5) (MainWindow.xaml.cs:97)
OUTER_VERTICES = np.array(
    [[0.00, 0.0], [1.00, 0.0], [1.00, 0.2], [0.80, 0.3],
     [0.80, 0.5], [1.00, 0.4], [1.00, 1.0], [0.60, 1.0],
     [0.60, 0.8], [0.50, 0.8], [0.50, 1.0], [0.00, 1.0]], dtype=np.float32)
INNER_VERTICES = np.array(
    [[0.2, 0.3], [0.3, 0.3], [0.4, 0.7], [0.3, 0.7]], dtype=np.float32)
FIELD_SCALE = 30.0
FIELD_OFFSET = (5.0, 5.0)

# the loop through the default field's free space (world meters)
LOOP_WAYPOINTS = np.array(
    [[20.0, 20.0], [26.0, 20.0], [28.0, 14.0], [26.0, 9.0],
     [18.0, 8.0], [10.0, 10.0], [8.5, 18.0], [9.0, 26.0],
     [16.0, 31.0], [24.0, 31.0], [28.0, 26.0], [22.0, 22.0],
     [20.0, 20.0]], dtype=np.float32)


class Log(NamedTuple):
    """Scans on a device; a fleet log has a robot axis B after the time axis."""
    traj: torch.Tensor    # f32[T, (B,) 3] true poses
    points: torch.Tensor  # f32[T, (B,) N, 2] robot-local clouds, 0 where missed
    valid: torch.Tensor   # bool[T, (B,) N]


def waypoint_trajectory(waypoints: np.ndarray, speed: float, scan_rate: float,
                        max_turn_rate: float = math.radians(60.0)) -> np.ndarray:
    """Constant-speed waypoint follower sampled at ``scan_rate`` Hz: poses
    f32[T, 3], the heading turning toward the path at <= ``max_turn_rate``."""
    dt = 1.0 / scan_rate
    poses = []
    pos = waypoints[0].astype(np.float64)
    heading = 0.0
    for wp in waypoints[1:]:
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
            pos = pos + np.array([math.cos(heading),
                                  math.sin(heading)]) * speed * dt
            poses.append([pos[0], pos[1], heading])
    return np.asarray(poses, np.float32)


def revolution_angles(num_beams: int) -> np.ndarray:
    """The reference's beam angles: f32 accumulation until >= 2*pi
    (MainWindow.xaml.cs:391)."""
    step = np.float32(2.0 * math.pi) / np.float32(num_beams)
    out, a, two_pi = [], np.float32(0.0), np.float32(2.0 * math.pi)
    while a < two_pi:
        out.append(a)
        a = np.float32(a + step)
    return np.asarray(out, np.float32)


def field_edges(device) -> tuple:
    """The default field as segments a[i] -> b[i], f32[E, 2] each."""
    off = np.asarray(FIELD_OFFSET, np.float32)
    aa, bb = [], []
    for poly in (OUTER_VERTICES, INNER_VERTICES):
        a = poly * FIELD_SCALE + off
        aa.append(a)
        bb.append(np.roll(a, -1, axis=0))
    return (torch.as_tensor(np.concatenate(aa), device=device),
            torch.as_tensor(np.concatenate(bb), device=device))


def ray_cast(edges, origin: torch.Tensor, angles: torch.Tensor,
             max_dist: float):
    """Closest hit of each ray over every edge (Field.RayTrace,
    Field.cs:162-182): (hit bool[..., R], dist f32[..., R], 0 on a miss)."""
    fa, fb = edges
    d = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    e = fb - fa
    ao = origin[..., None, :] - fa
    dx, dy = d[..., :, None, 0], d[..., :, None, 1]
    ex, ey = e[:, 0], e[:, 1]
    aox, aoy = ao[..., None, :, 0], ao[..., None, :, 1]
    denom = dx * (-ey) - dy * (-ex)
    t_num = (-aox) * (-ey) - (-aoy) * (-ex)
    u_num = dx * (-aoy) - dy * (-aox)
    safe = denom.abs() > 1e-12
    den = torch.where(safe, denom, torch.ones_like(denom))
    inf = torch.full_like(denom, float("inf"))
    t = torch.where(safe, t_num / den, inf)
    u = torch.where(safe, u_num / den, torch.full_like(denom, -1.0))
    ok = safe & (u >= 0.0) & (u <= 1.0) & (t >= 0.0) & (t <= max_dist)
    best = torch.where(ok, t, inf).amin(dim=-1)
    hit = torch.isfinite(best)
    return hit, torch.where(hit, best, torch.zeros_like(best))


def make_log(seed: int, n_scans: int, sensor: dict, device) -> Log:
    """The first ``n_scans`` poses of the loop at ``sensor["speed_m_s"]``,
    each a revolution of ``sensor["beams"]`` rays with the reference's noise
    (``hit += rnd.Next(-100, 100) / 100 * err``, MainWindow.xaml.cs:397)
    drawn from a generator on ``device`` seeded with ``seed``."""
    traj_np = waypoint_trajectory(LOOP_WAYPOINTS, sensor["speed_m_s"],
                                  sensor["scans_per_s"])
    if n_scans > traj_np.shape[0]:
        raise ValueError(f"the loop has {traj_np.shape[0]} poses, "
                         f"{n_scans} asked for")
    traj = torch.as_tensor(traj_np[:n_scans], device=device)
    angles = torch.as_tensor(revolution_angles(sensor["beams"]), device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    hit, dist = ray_cast(field_edges(device), traj[:, :2],
                         angles + traj[:, 2:3], sensor["max_range_m"])
    steps = torch.randint(-100, 100, dist.shape, generator=gen, device=device)
    noise = steps.to(torch.float32) / 100.0 * sensor["noise_m"]
    radii = torch.where(hit, dist + noise, torch.zeros_like(dist))
    pts = torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)],
                      dim=-1).contiguous()
    return Log(traj, pts, hit)


def derived_seeds(seed: int, k: int) -> list:
    """``k`` seeds drawn from ``seed`` (one log each)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 63))
    return [int(s.generate_state(1, np.uint64)[0] >> 1) for s in ss.spawn(k)]


def fleet_starts(total: int, span: int, shifts: int) -> np.ndarray:
    """``replay.make_fleet_log``'s phase shifts: ``shifts`` starts spread
    over the scans a ``span``-scan slice can begin at."""
    return np.linspace(0, total - span, shifts).astype(int)


def make_fleet_log(logs: Sequence[Log], span: int, shifts: int) -> Log:
    """Robots ``i * shifts + j`` replay ``logs[i]`` from its ``j``-th phase
    shift on: ``span`` scans each, stacked on a robot axis."""
    total = logs[0].points.shape[0]
    starts = fleet_starts(total, span, shifts)

    def cut(name):
        return torch.stack([getattr(lg, name)[s:s + span] for lg in logs
                            for s in starts], dim=1).contiguous()
    return Log(cut("traj"), cut("points"), cut("valid"))
