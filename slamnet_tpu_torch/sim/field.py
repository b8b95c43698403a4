"""Headless simulated field: polygon world + broadcast ray casting.

Port of ``slamnet_tpu/sim/field.py``: the world is a set of line segments; a
ray trace is the closed-form ray/segment intersection over (rays x edges),
replacing Box2D's World.RayCast (Field.cs:162-182).  The default field is
CreateDefaultField's exact vertex lists (Field.cs:43-72) at scale 30, offset
(5, 5), as MainWindow.xaml.cs:97 instantiates it.
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
               device: torch.device | str = "cpu") -> Field:
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
                  device: torch.device | str = "cpu") -> Field:
    """The reference's default field (Field.cs:43-72 @ MainWindow.xaml.cs:97)."""
    return make_field([OUTER_VERTICES, INNER_VERTICES], scale, offset, device)


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
