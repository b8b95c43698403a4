"""Headless simulated field: polygon world + broadcast ray casting.

Port of ``slamnet_tpu/sim/field.py``: the world is a set of line segments; a
ray trace is the closed-form ray/segment intersection over (rays x edges),
replacing Box2D's World.RayCast (Field.cs:162-182).  The default field is
CreateDefaultField's exact vertex lists (Field.cs:43-72) at scale 30, offset
(5, 5), as MainWindow.xaml.cs:97 instantiates it.  ``office_field`` is the
loop-closure world: four ~18 m rooms joined by 3 m doorways.

``make_field``, ``default_field`` and ``office_field`` put the edges on the
card unless the caller names another device (``device="cpu"`` for the CPU),
as the JAX package's land on its default device.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

# CreateDefaultField vertex lists (Simulation/Field.cs:45-69), unit square scaled.
OUTER_VERTICES = np.array(
    [
        [0.00, 0.0], [1.00, 0.0], [1.00, 0.2], [0.80, 0.3],
        [0.80, 0.5], [1.00, 0.4], [1.00, 1.0], [0.60, 1.0],
        [0.60, 0.8], [0.50, 0.8], [0.50, 1.0], [0.00, 1.0],
    ],
    dtype=np.float32,
)
INNER_VERTICES = np.array(
    [[0.2, 0.3], [0.3, 0.3], [0.4, 0.7], [0.3, 0.7]], dtype=np.float32
)


class Field(NamedTuple):
    """Edge soup: segments from a[i] to b[i], both f32[E, 2] (meters)."""

    a: torch.Tensor
    b: torch.Tensor

    @property
    def num_edges(self) -> int:
        return self.a.shape[0]


def make_field(polygons: Sequence[np.ndarray], scale: float = 1.0,
               offset: Tuple[float, float] = (0.0, 0.0),
               device: torch.device | str = "cuda") -> Field:
    """Build a field from closed polygons (each f32[V, 2] in unit coords);
    each polygon closes its loop (AddEdges(closeLoop=True), Field.cs:79-116)."""
    off = np.asarray(offset, np.float32)
    aa, bb = [], []
    for poly in polygons:
        a = np.asarray(poly, np.float32) * scale + off
        aa.append(a)
        bb.append(np.roll(a, -1, axis=0))
    return Field(torch.as_tensor(np.concatenate(aa), device=device),
                 torch.as_tensor(np.concatenate(bb), device=device))


def default_field(scale: float = 30.0, offset: Tuple[float, float] = (5.0, 5.0),
                  device: torch.device | str = "cuda") -> Field:
    """The reference's default field (Field.cs:43-72 @ MainWindow.xaml.cs:97)."""
    return make_field([OUTER_VERTICES, INNER_VERTICES], scale, offset, device)


def _slab(x0: float, x1: float, y0: float, y1: float) -> np.ndarray:
    """An axis-aligned wall slab as a closed polygon."""
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


# The office's walls (meters).  Room A = [W0, C1] x [W0, C1] lies inside a
# 20 m Hector map ([0, 20] at map_size=200, resolution 0.1) with more than
# 1 m to spare; rooms B, C and D lie outside it: the world outruns the map.
OFFICE_OUTER = (0.5, 36.5)       # the outer wall's span
OFFICE_CROSS = (18.3, 18.7)      # the cross walls' faces (0.4 m thick)
OFFICE_DOORS = (7.5, 10.5, 26.5, 29.5)   # two 3 m doors in each cross wall


def office_field(device: torch.device | str = "cuda") -> Field:
    """Four ~18 m rooms joined by 3 m doorways: the loop-closure world of
    ``slamnet_tpu/sim/field.py:83-103``.  A tour of the rooms leaves the
    20 m benchmark map for most of each lap, so only the pose graph's loop
    closures against stored keyframe scans can correct the odometry's
    drift there."""
    w0, w1 = OFFICE_OUTER
    c0, c1 = OFFICE_CROSS
    d0a, d0b, d1a, d1b = OFFICE_DOORS
    return make_field([
        np.array([[w0, w0], [w1, w0], [w1, w1], [w0, w1]], np.float32),
        _slab(w0, d0a, c0, c1), _slab(d0b, d1a, c0, c1),
        _slab(d1b, w1, c0, c1),
        _slab(c0, c1, w0, d0a), _slab(c0, c1, d0b, d1a),
        _slab(c0, c1, d1b, w1),
    ], 1.0, (0.0, 0.0), device)


def ray_cast(field: Field, origin: torch.Tensor, angles: torch.Tensor,
             max_dist: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cast rays from ``origin`` f32[..., 2] at ``angles`` f32[..., R]; return
    (hit bool[..., R], dist f32[..., R]).  Leading dims broadcast, so one call
    casts a whole trajectory's scans.

    Closest-hit semantics of Field.RayTrace (Field.cs:162-182): the minimum
    hit distance over all edges; no hit -> dist 0.
    """
    d = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # [..., R, 2]
    e = field.b - field.a                                  # [E, 2]
    ao = origin[..., None, :] - field.a                    # [..., E, 2]
    dx, dy = d[..., :, None, 0], d[..., :, None, 1]        # [..., R, 1]
    ex, ey = e[:, 0], e[:, 1]                              # [E]
    aox, aoy = ao[..., None, :, 0], ao[..., None, :, 1]    # [..., 1, E]

    # origin + t*d = a + u*e:  t = cross(a - o, -e) / cross(d, -e),
    # u = cross(d, a - o) / cross(d, -e)
    denom = dx * (-ey) - dy * (-ex)                        # [..., R, E]
    t_num = (-aox) * (-ey) - (-aoy) * (-ex)
    u_num = dx * (-aoy) - dy * (-aox)

    safe = denom.abs() > 1e-12
    den = torch.where(safe, denom, torch.ones_like(denom))
    inf = torch.full_like(denom, float("inf"))
    t = torch.where(safe, t_num / den, inf)
    u = torch.where(safe, u_num / den, torch.full_like(denom, -1.0))

    # t is in meters because d is unit length; accept t in [0, max_dist]
    valid = safe & (u >= 0.0) & (u <= 1.0) & (t >= 0.0) & (t <= max_dist)
    best = torch.where(valid, t, inf).amin(dim=-1)          # [..., R]
    hit = torch.isfinite(best)
    return hit, torch.where(hit, best, torch.zeros_like(best))
