"""Gauss-Newton scan-matching pieces in PyTorch: the math of K1's plain version.

Port of ``slamnet_tpu/ops/gn.py`` ``hessian_derivs`` (:25-55),
``solve_gn_step`` (:58-73), ``_gn_coords`` (:142-151), ``_gn_tail``
(:154-183) and ``_solve_scalar`` (:76-117) — ScanMatcher.GetCompleteHessianDerivs
+ EstimateTransformationLogLh (ScanMatcher.cs:93-204).  The 3x3 symmetric
system is solved by the adjugate with the reference's guards: H00 != 0 &&
H11 != 0 (ScanMatcher.cs:97), a non-invertible H skips the step (:99-103), and
the rotation step is clamped (:107-117).

Every function takes an optional leading instance axis: a pose f32[3] with
beams f32[N], or poses f32[B, 3] with beams f32[B, N] (the fleet); each
instance's numbers are the same either way.
"""
from __future__ import annotations

import torch

from .bilinear import interp_value_and_gradients


def hessian_derivs(logodds_flat: torch.Tensor, width: int,
                   points: torch.Tensor, valid: torch.Tensor,
                   pose_px: torch.Tensor, scale_to_map: float):
    """(H f32[3, 3], dTr f32[3]) at the map-pixel pose ``pose_px`` (x_px,
    y_px, theta) from the beams ``points`` f32[N, 2] (robot-local meters,
    ``valid`` bool[N]): p_map = R(theta) p * scale + (x_px, y_px), the
    rotation derivative from the raw point with sin/cos pre-scaled
    (ScanMatcher.cs:139-196)."""
    sin_r = torch.sin(pose_px[2]) * scale_to_map
    cos_r = torch.cos(pose_px[2]) * scale_to_map
    X, Y = points[:, 0], points[:, 1]
    mx = cos_r * X - sin_r * Y + pose_px[0]
    my = sin_r * X + cos_r * Y + pose_px[1]
    value, gx, gy = interp_value_and_gradients(
        logodds_flat, width, torch.stack([mx, my], dim=1), valid)
    fun = 1.0 - value
    rot = (-sin_r * X - cos_r * Y) * gx + (cos_r * X - sin_r * Y) * gy
    dtr = torch.stack([(gx * fun).sum(), (gy * fun).sum(), (rot * fun).sum()])
    h00, h11, h22 = (gx * gx).sum(), (gy * gy).sum(), (rot * rot).sum()
    h01, h02, h12 = (gx * gy).sum(), (gx * rot).sum(), (gy * rot).sum()
    H = torch.stack([torch.stack([h00, h01, h02]), torch.stack([h01, h11, h12]),
                     torch.stack([h02, h12, h22])])
    return H, dtr


def solve_gn_step(H: torch.Tensor, dtr: torch.Tensor,
                  deriv_clamp: float = 0.2) -> torch.Tensor:
    """The guarded symmetric 3x3 solve of (H, dTr), the rotation step
    clamped; a zero step when the guards fail (``_solve_scalar``'s math)."""
    s0, s1, s2, _ = _solve_scalar(H[0, 0], H[0, 1], H[0, 2], H[1, 1], H[1, 2],
                                  H[2, 2], dtr[0], dtr[1], dtr[2], deriv_clamp)
    return torch.stack([s0, s1, s2])


def _solve_scalar(H00, H01, H02, H11, H12, H22, d0, d1, d2, clamp: float,
                  xy_clamp: float = 0.0, damping: float = 0.0):
    """Guarded adjugate solve, elementwise on 0-dim or [B] tensors; returns
    (s0, s1, s2, ok).

    ``damping`` > 0 scales H's diagonal by (1 + damping) (a Levenberg-style
    extension, not in the reference); ``xy_clamp`` > 0 bounds the translation
    step.  When ``ok`` is False the step is zero.
    """
    if damping > 0.0:
        H00 = H00 * (1.0 + damping)
        H11 = H11 * (1.0 + damping)
        H22 = H22 * (1.0 + damping)
    a0 = H11 * H22 - H12 * H12            # adjugate upper triangle
    a1 = H02 * H12 - H01 * H22
    a2 = H01 * H12 - H02 * H11
    det = H00 * a0 + H01 * a1 + H02 * a2
    b1 = H00 * H22 - H02 * H02
    b2 = H01 * H02 - H00 * H12
    c2 = H00 * H11 - H01 * H01
    ok = (H00 != 0.0) & (H11 != 0.0) & (det != 0.0) & torch.isfinite(det)
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv = torch.where(ok, 1.0 / safe, torch.zeros_like(det))
    s0 = (a0 * d0 + a1 * d1 + a2 * d2) * inv
    s1 = (a1 * d0 + b1 * d1 + b2 * d2) * inv
    if xy_clamp > 0.0:
        s0 = s0.clamp(-xy_clamp, xy_clamp)
        s1 = s1.clamp(-xy_clamp, xy_clamp)
    s2 = ((a2 * d0 + b2 * d1 + c2 * d2) * inv).clamp(-clamp, clamp)
    return s0, s1, s2, ok


def _gn_coords(width: int, scale: float, pose_px: torch.Tensor,
               X: torch.Tensor, Y: torch.Tensor, valid: torch.Tensor):
    """Beams -> map pixels at ``pose_px`` (x_px, y_px, theta): the rotated
    coordinates, the in-bounds mask and the truncated, clipped cell."""
    sr = torch.sin(pose_px[..., 2:3]) * scale
    cr = torch.cos(pose_px[..., 2:3]) * scale
    mx = cr * X - sr * Y + pose_px[..., 0:1]
    my = sr * X + cr * Y + pose_px[..., 1:2]
    ok = valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0) & (my <= width - 2)
    xi = mx.to(torch.int32).clamp(0, width - 2)
    yi = my.to(torch.int32).clamp(0, width - 2)
    return sr, cr, mx, my, ok, xi, yi


def _gn_tail(v: torch.Tensor, mx, my, xi, yi, ok, X, Y, sr, cr,
             pose_px: torch.Tensor, deriv_clamp: float, xy_clamp: float,
             damping: float):
    """From the 4 neighbour probabilities v f32[4, ..., N] to the solved step.

    Returns (new_pose_px f32[..., 3], solve_ok bool[...], resid_sum f32[...]
    = sum of (1 - M(p))^2 over in-bounds valid beams, n_in f32[...] = that
    beam count)."""
    fx = mx - xi
    fy = my - yi
    xf = 1.0 - fx
    yf = 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
    gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
    z = torch.zeros_like(gx)
    gx = torch.where(ok, gx, z)
    gy = torch.where(ok, gy, z)
    fun = torch.where(ok, 1.0 - val, z)
    rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy
    red = torch.stack([gx * fun, gy * fun, rot * fun,
                       gx * gx, gx * gy, gx * rot,
                       gy * gy, gy * rot, rot * rot,
                       fun * fun, ok.to(torch.float32)], dim=-2).sum(dim=-1)
    d0, d1, d2, H00, H01, H02, H11, H12, H22 = red[..., :9].unbind(-1)
    s0, s1, s2, solve_ok = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                         d0, d1, d2, deriv_clamp, xy_clamp,
                                         damping)
    new_pose = torch.stack([pose_px[..., 0] + s0, pose_px[..., 1] + s1,
                            pose_px[..., 2] + s2], dim=-1)
    return new_pose, solve_ok, red[..., 9], red[..., 10]
