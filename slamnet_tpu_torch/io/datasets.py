"""Odometry models for simulated logs (numpy).

Copied from ``slamnet_tpu/io/datasets.py::drifting_odometry`` (:205-242):
importing that module would import jax.  Pure numpy with
``np.random.default_rng(seed)``, so it gives the JAX package's numbers bit
for bit.
"""
from __future__ import annotations

import math

import numpy as np


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
