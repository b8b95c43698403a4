"""Standard 2D lidar logs in the CARMEN format (the Radish corpus), and the
simulated logs written in it.

Port of ``slamnet_tpu/io/datasets.py`` (importing it would import jax).
The readers and writers are numpy and give the JAX package's arrays bit for
bit:

  FLASER n r_1..r_n  laser_x laser_y laser_th  odom_x odom_y odom_th  ts host log_ts
  ROBOTLASER1 type start fov res maxr acc rem  n r_1..r_n  m [rem..]
              laser_x laser_y laser_th robot_x robot_y robot_th  tv rv ... ts host log_ts

FLASER beams span a 180-degree field of view, beam i at -pi/2 + i * pi/(n-1)
in the laser frame; ranges at or above 0.99 x the max range (the SICK
default 81.9 m unless a PARAM line names another) are misses.  ROBOTLASER1
carries its own geometry.  Every scan of a log has the same beam count.  A
``# TRUTH x y th`` comment line carries the ground truth of the scan line
after it (simulated logs).

``simulate_carmen_log`` and ``simulate_adversarial_log`` make the checked-in
logs' kind of log with the port's simulator: the ranges come from
``sim.lidar.scan_revolution`` with a ``torch.Generator`` on ``device``
seeded with ``seed``, so they differ from JAX's numbers for the same seed
(the distribution is the same); the odometry is integrated in numpy from
``np.random.default_rng(seed)``, as JAX's is.  ``drifting_odometry`` is the
JAX package's odometry model without slips (``:205-242``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

SICK_MAX_RANGE = 81.9


class LidarLog(NamedTuple):
    """A fixed-shape 2D lidar log: T scans of N beams with odometry poses."""

    ranges: np.ndarray     # f32[T, N] meters
    valid: np.ndarray      # bool[T, N] (False = miss/out-of-range)
    odometry: np.ndarray   # f32[T, 3] laser pose from odometry (x, y, theta)
    angles: np.ndarray     # f32[N] beam angles in the laser frame
    max_range: float
    timestamps: np.ndarray  # f64[T] (0 when the log carries none)
    # ground-truth poses f32[T, 3] when the log carries "# TRUTH x y th"
    # lines (simulated logs); None for real-robot logs
    truth: np.ndarray | None = None


def flaser_angles(n: int, fov: float = math.pi) -> np.ndarray:
    """The beam angles f32[n] of an n-beam FLASER scan over ``fov``."""
    if n == 1:
        return np.zeros(1, np.float32)
    return (-fov / 2.0 + np.arange(n) * (fov / (n - 1))).astype(np.float32)


def read_carmen(path: str, max_range: float | None = None,
                max_scans: int | None = None) -> LidarLog:
    """Parse a CARMEN log's FLASER/ROBOTLASER1 scans into a LidarLog."""
    ranges: List[np.ndarray] = []
    odom: List[Tuple[float, float, float]] = []
    stamps: List[float] = []
    truth: List[Tuple[float, float, float]] = []
    angles: np.ndarray | None = None
    file_maxr = None

    def add(n, a, r, pose, ts):
        nonlocal angles
        if angles is None:
            angles = a
        elif len(angles) != n:
            raise ValueError(
                f"mixed beam counts in {path}: {len(angles)} vs {n}")
        ranges.append(r)
        odom.append(pose)
        stamps.append(ts)

    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0].startswith("#"):
                if len(tok) >= 5 and tok[1] == "TRUTH":
                    truth.append((float(tok[2]), float(tok[3]),
                                  float(tok[4])))
                continue
            if tok[0] == "PARAM" and len(tok) >= 3 and (
                    "maxrange" in tok[1] or tok[1].endswith("laser_max")):
                try:
                    file_maxr = float(tok[2])
                except ValueError:
                    pass
                continue
            if tok[0] == "FLASER":
                n = int(tok[1])
                r = np.asarray(tok[2:2 + n], np.float32)
                pose = (float(tok[2 + n]), float(tok[3 + n]),
                        float(tok[4 + n]))
                ts = float(tok[8 + n]) if len(tok) > 8 + n else 0.0
                add(n, flaser_angles(n) if angles is None else None, r, pose,
                    ts)
            elif tok[0] == "ROBOTLASER1":
                start, res, maxr = float(tok[2]), float(tok[4]), float(tok[5])
                n = int(tok[8])
                r = np.asarray(tok[9:9 + n], np.float32)
                base = 10 + n + int(tok[9 + n])
                pose = (float(tok[base]), float(tok[base + 1]),
                        float(tok[base + 2]))
                ts = float(tok[base + 11]) if len(tok) > base + 11 else 0.0
                file_maxr = maxr
                add(n, (start + np.arange(n) * res).astype(np.float32), r,
                    pose, ts)
            if max_scans is not None and len(ranges) >= max_scans:
                break

    if not ranges:
        raise ValueError(f"no FLASER/ROBOTLASER1 lines in {path}")
    if max_range is None:
        max_range = file_maxr if file_maxr is not None else SICK_MAX_RANGE
    rr = np.stack(ranges)
    return LidarLog(ranges=rr, valid=(rr > 0.0) & (rr < 0.99 * max_range),
                    odometry=np.asarray(odom, np.float32),
                    angles=angles, max_range=float(max_range),
                    timestamps=np.asarray(stamps, np.float64),
                    truth=(np.asarray(truth, np.float32)
                           if len(truth) == len(ranges) else None))


def write_carmen(path: str, log: LidarLog, host: str = "slamnet") -> None:
    """Write a LidarLog as CARMEN FLASER lines (invalid beams at the max
    range), each after its ``# TRUTH`` line when the log has truth."""
    with open(path, "w") as f:
        f.write("# CARMEN log written by slamnet_tpu_torch.io.datasets\n")
        f.write("# robot: simulated (slamnet_tpu_torch.sim)\n")
        f.write(f"PARAM robot_frontlaser_maxrange {log.max_range:.6f}\n")
        for t in range(log.ranges.shape[0]):
            r = np.where(log.valid[t], log.ranges[t], log.max_range)
            vals = " ".join(f"{v:.3f}" for v in r)
            x, y, th = log.odometry[t]
            ts = log.timestamps[t] if log.timestamps.size else 0.0
            if log.truth is not None:
                tx, ty, tth = log.truth[t]
                f.write(f"# TRUTH {tx:.6f} {ty:.6f} {tth:.6f}\n")
            f.write(f"FLASER {log.ranges.shape[1]} {vals} "
                    f"{x:.6f} {y:.6f} {th:.6f} {x:.6f} {y:.6f} {th:.6f} "
                    f"{ts:.6f} {host} {ts:.6f}\n")


def log_points(log: LidarLog) -> np.ndarray:
    """Cartesian points f32[T, N, 2] in the laser frame (mask with log.valid)."""
    c = np.cos(log.angles)[None, :]
    s = np.sin(log.angles)[None, :]
    return np.stack([log.ranges * c, log.ranges * s], -1).astype(np.float32)


def _simulate(traj: np.ndarray, num_beams: int, seed: int, device,
              dropout_prob: float = 0.0, range_error_std: float = 0.0):
    """FLASER-convention scans (180-degree FoV) along ``traj`` in the default
    field, on ``device``, drawn from a generator seeded with ``seed``:
    (angles, ranges f32[T, N], valid bool[T, N]) as numpy."""
    from ..core.config import SimConfig
    from ..sim import default_field
    from ..sim.lidar import scan_revolution

    sim = SimConfig()
    angles = flaser_angles(num_beams)
    fld = default_field(sim.field_scale, sim.field_offset, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    radii, valid = scan_revolution(
        fld, torch.as_tensor(traj, dtype=torch.float32, device=device),
        torch.as_tensor(angles, device=device), sim.max_scan_dist,
        sim.measure_error, gen, range_error_std=range_error_std,
        dropout_prob=dropout_prob)
    return angles, radii.cpu().numpy(), valid.cpu().numpy()


def simulate_carmen_log(n_scans: int = 120, num_beams: int = 180,
                        speed: float = 0.25, odom_noise: float = 0.01,
                        seed: int = 0,
                        device: torch.device | str = "cuda") -> LidarLog:
    """A CARMEN-convention log from the simulator: ``num_beams``-beam
    front-facing scans along the loop over the default 40 x 40 m field, with
    odometry drifting by a cumulative Gaussian walk (``sim_loop.clf``'s kind
    of log, ``slamnet_tpu/io/datasets.py:147-179``)."""
    from ..core.config import SimConfig
    from ..sim.trajectory import loop_trajectory

    sim = SimConfig()
    traj = np.asarray(loop_trajectory(speed=speed)[:n_scans])
    angles, radii, valid = _simulate(traj, num_beams, seed, device)
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.normal(0, odom_noise, (n_scans, 3)), axis=0)
    drift[:, 2] *= 0.3
    odo = traj + drift.astype(np.float32)
    return LidarLog(ranges=radii, valid=valid,
                    odometry=odo.astype(np.float32), angles=angles,
                    max_range=sim.max_scan_dist,
                    timestamps=(np.arange(n_scans) / sim.scans_per_second))


def drifting_odometry(traj, scale_bias: float = 1.02,
                      heading_bias: float = 0.0002,
                      step_noise: float = 0.003,
                      lat_noise: float | None = None,
                      heading_noise: float = 0.001,
                      seed: int = 7) -> np.ndarray:
    """Integrate wheel-odometry-style drift along a true trajectory: a
    translation scale bias, a heading bias a step and Gaussian step noise,
    integrated in the accumulated odometry frame.  No slip events.

    Returns odo f32[T, 3] with odo[0] == traj[0].
    """
    traj = np.asarray(traj, np.float64)
    if lat_noise is None:
        lat_noise = 0.4 * step_noise
    rng = np.random.default_rng(seed)
    odo = np.zeros_like(traj)
    odo[0] = traj[0]
    for t in range(1, traj.shape[0]):
        d_world = traj[t] - traj[t - 1]
        c, s = math.cos(traj[t - 1, 2]), math.sin(traj[t - 1, 2])
        fwd = c * d_world[0] + s * d_world[1]
        lat = -s * d_world[0] + c * d_world[1]
        dth = math.remainder(d_world[2], 2.0 * math.pi)
        fwd = fwd * scale_bias + rng.normal(0, step_noise)
        lat = lat * scale_bias + rng.normal(0, lat_noise)
        dth = dth + heading_bias + rng.normal(0, heading_noise)
        co, so = math.cos(odo[t - 1, 2]), math.sin(odo[t - 1, 2])
        odo[t, 0] = odo[t - 1, 0] + co * fwd - so * lat
        odo[t, 1] = odo[t - 1, 1] + so * fwd + co * lat
        odo[t, 2] = odo[t - 1, 2] + dth
    return odo.astype(np.float32)


def simulate_adversarial_log(n_scans: int = 360, num_beams: int = 181,
                             speed: float = 0.3, dropout_prob: float = 0.2,
                             range_error_std: float = 0.03,
                             odom_scale_bias: float = 1.03,
                             odom_heading_bias: float = 0.0008,
                             odom_step_noise: float = 0.004,
                             num_slips: int = 3,
                             seed: int = 11,
                             trajectory=None,
                             device: torch.device | str = "cuda") -> LidarLog:
    """A log with the failure modes of real sensor logs
    (``adversarial_180.clf``'s kind, ``slamnet_tpu/io/datasets.py:245-337``):
    a 180-degree front-facing FoV, ``dropout_prob`` beam dropouts, Gaussian
    range error, and odometry integrated in the robot frame with a scale
    bias, a heading bias, step noise and ``num_slips`` slip events (0.15-0.4
    m and 3-8 degree kicks).  The truth rides in the log (``truth``)."""
    from ..core.config import SimConfig
    from ..sim.trajectory import loop_trajectory

    sim = SimConfig()
    if trajectory is None:
        trajectory = loop_trajectory(speed=speed)
    traj = np.asarray(trajectory[:n_scans], np.float64)
    if traj.shape[0] < n_scans:
        raise ValueError(f"trajectory too short: {traj.shape[0]} < {n_scans}")
    angles, radii, valid = _simulate(traj.astype(np.float32), num_beams, seed,
                                     device, dropout_prob, range_error_std)

    rng = np.random.default_rng(seed)
    first_slip = min(10, max(1, n_scans - 1))
    n_slips = min(num_slips, max(0, n_scans - first_slip))
    slip_steps = rng.choice(np.arange(first_slip, n_scans), size=n_slips,
                            replace=False)
    odo = np.zeros_like(traj)
    odo[0] = traj[0]
    for t in range(1, n_scans):
        # the true step in the previous true robot frame, measured with
        # bias, noise and slips, integrated in the odometry frame
        d_world = traj[t] - traj[t - 1]
        c, s = math.cos(traj[t - 1, 2]), math.sin(traj[t - 1, 2])
        fwd = c * d_world[0] + s * d_world[1]
        lat = -s * d_world[0] + c * d_world[1]
        dth = math.remainder(d_world[2], 2.0 * math.pi)
        fwd = fwd * odom_scale_bias + rng.normal(0, odom_step_noise)
        lat = lat * odom_scale_bias + rng.normal(0, odom_step_noise * 0.3)
        dth = dth + odom_heading_bias + rng.normal(0, odom_step_noise * 0.5)
        if t in slip_steps:
            fwd += rng.uniform(0.15, 0.4) * rng.choice([-1.0, 1.0])
            dth += math.radians(rng.uniform(3.0, 8.0)) * rng.choice([-1.0, 1.0])
        co, so = math.cos(odo[t - 1, 2]), math.sin(odo[t - 1, 2])
        odo[t, 0] = odo[t - 1, 0] + co * fwd - so * lat
        odo[t, 1] = odo[t - 1, 1] + so * fwd + co * lat
        odo[t, 2] = odo[t - 1, 2] + dth

    return LidarLog(ranges=radii, valid=valid,
                    odometry=odo.astype(np.float32), angles=angles,
                    max_range=sim.max_scan_dist,
                    timestamps=(np.arange(n_scans) / sim.scans_per_second),
                    truth=traj.astype(np.float32))
