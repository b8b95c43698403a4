"""K1: the coarse-to-fine Hector match as one CUDA kernel (``csrc/match.cu``).

Replaces ``slamnet_tpu/ops/pallas_onehot.py::make_pallas_match`` (the
``matcher_mode="pallas"`` path of ``models/hector.py:167-192``).  ``match``
takes the concatenated f32 pyramid and the scan as they are and returns
f32[6] = (x, y, theta, solve_failures, resid_sum, n_in) of the finest level's
last iteration, as the TPU kernel's lanes 0-5 do.

Semantics are the TPU kernel's: every level's table is read through bf16
rounding (the one-hot bf16 selection of ``prepare_tables``), fixed per-level
iteration counts, theta clamp, optional xy clamp and damping, heading wrapped
between levels, the hint returned for a scan with no valid beam.

``match_plain`` is the same loop in PyTorch on the bf16-rounded table (the
ported ``ops/gn.py`` math).  ``match`` runs it for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import HectorConfig
from ..core.geometry import normalize_angle
from . import _build
from .gn import _gn_coords, _gn_tail

MAX_LEVELS = 4
MAX_BEAMS = 4096      # 1024 threads x 4 beams each (csrc/match.cu)


class _MatchParams(ctypes.Structure):
    """``struct MatchParams`` of csrc/match.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("stride", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("iters", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("deriv_clamp", ctypes.c_float), ("xy_clamp", ctypes.c_float),
                ("damping", ctypes.c_float)]


def _check_cfg(cfg: HectorConfig) -> None:
    if tuple(cfg.offset) != (0.0, 0.0):
        raise ValueError(f"K1 needs cfg.offset == (0, 0), got {cfg.offset}")
    if not 1 <= cfg.num_levels <= MAX_LEVELS:
        raise ValueError(f"K1 takes 1..{MAX_LEVELS} levels, got {cfg.num_levels}")
    if cfg.early_exit_tol > 0.0:
        raise ValueError("K1 runs fixed per-level iterations; early_exit_tol "
                         "is unsupported")


@functools.cache
def _params(cfg: HectorConfig, n: int) -> _MatchParams:
    nl = cfg.num_levels
    pad = [0] * (MAX_LEVELS - nl)
    return _MatchParams(
        nl, n, cfg.match_subsample,
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_sizes, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_offsets, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.estimate_iterations[:nl], *pad),
        (ctypes.c_float * MAX_LEVELS)(
            *[1.0 / r for r in cfg.level_resolutions], *pad),
        cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping)


@functools.cache
def _launcher():
    lib = _build.library()[0]
    fn = lib.slamnet_match
    fn.argtypes = [ctypes.c_void_p] * 5 + [_MatchParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def match(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
          hint: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """Coarse-to-fine match of ``points`` f32[N, 2] / ``valid`` bool[N] in the
    pyramid ``maps`` f32[total_cells], from ``hint`` f32[3] (world).  Uses
    every ``cfg.match_subsample``-th beam.  Returns f32[6] on the device of
    ``maps``; launches nothing the host waits for."""
    _check_cfg(cfg)
    if maps.device.type == "cpu":
        return match_plain(maps, points, valid, hint, cfg)
    _build.check_tensors("K1", maps.device, (
        ("maps", maps, torch.float32, (cfg.total_cells,)),
        ("points", points, torch.float32, (points.shape[0], 2)),
        ("valid", valid, torch.bool, (points.shape[0],)),
        ("hint", hint, torch.float32, (3,))))
    n = -(-points.shape[0] // cfg.match_subsample)
    if not 1 <= n <= MAX_BEAMS:
        raise ValueError(f"K1 takes 1..{MAX_BEAMS} matcher beams, got {n}")
    out = torch.empty(6, dtype=torch.float32, device=maps.device)
    code = _launcher()(maps.data_ptr(), points.data_ptr(), valid.data_ptr(),
                       hint.data_ptr(), out.data_ptr(), _params(cfg, n),
                       _build.stream_handle(maps.device))
    _build.raise_on_error(code, "K1 match")
    match.launches += 1
    return out


match.launches = 0


def match_plain(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                hint: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """K1's plain PyTorch version: same inputs, same f32[6] output."""
    _check_cfg(cfg)
    sub = cfg.match_subsample
    X, Y, V = points[::sub, 0], points[::sub, 1], valid[::sub]
    table = maps.to(torch.bfloat16).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=maps.device)
    fails, resid, n_in = zero, zero, zero
    pose = hint
    for level in range(cfg.num_levels - 1, -1, -1):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        scale = 1.0 / cfg.level_resolutions[level]
        tab = table[off:off + w * w]
        est = torch.stack([pose[0] * scale, pose[1] * scale, pose[2]])
        for _ in range(cfg.estimate_iterations[level]):
            sr, cr, mx, my, ok, xi, yi = _gn_coords(w, scale, est, X, Y, V)
            base = (yi * w + xi).long()
            v = torch.sigmoid(tab[torch.stack([base, base + 1, base + w,
                                               base + w + 1])])
            est, solve_ok, resid, n_in = _gn_tail(
                v, mx, my, xi, yi, ok, X, Y, sr, cr, est, cfg.deriv_clamp,
                cfg.xy_step_clamp_px, cfg.gn_damping)
            fails = fails + (~solve_ok).to(torch.float32)
        pose = torch.stack([est[0] / scale, est[1] / scale,
                            normalize_angle(est[2])])
    # empty scan returns the hint (ScanMatcher.cs:82-83)
    pose = torch.where(V.any(), pose, hint)
    return torch.cat([pose, torch.stack([fails, resid, n_in])])
