"""K1, K3, K5 and K6: the coarse-to-fine Hector match as one CUDA kernel
(``csrc/match.cu``), for one robot or a fleet.

Replaces ``slamnet_tpu/ops/pallas_onehot.py``'s ``make_pallas_match`` (K1,
the ``matcher_mode="pallas"`` path of ``models/hector.py:167-192``),
``make_pallas_match_batch`` (K5, the fleet's matcher, ``models/fleet.py:82-116``)
and ``make_pallas_match_packed`` (K6, K5 with G instances a program), and
``slamnet_tpu/ops/pallas_gn.py::match_pallas`` (K3, the f32 table: the
reference-exact ``matcher_mode="gather"`` of ``models/hector.py:194-259``
and ``models/fleet.py:118-187``).  ``match`` takes one robot's concatenated
f32 pyramid and scan and returns f32[7] = (x, y, theta, solve_failures,
resid_sum, n_in, iterations): the TPU kernel's lanes 0-5 (the stats of the
finest level's last iteration) and the GN iterations run over all levels;
``match_batch`` (K5, or the batched K3) and ``match_packed`` (K6) take a
fleet's flat f32[B*C] maps, points f32[B, N, 2], valid bool[B, N] and hints
f32[B, 3] and return f32[B, 7].

``cfg.matcher_mode`` picks the table's precision.  ``"pallas"`` and
``"onehot_bf16"`` read every level through bf16 rounding (the one-hot bf16
selection of ``prepare_tables``): K1, K5, K6.  ``"gather"`` and
``"onehot_highest"`` (bit-identical to ``"gather"`` in JAX) read the f32
maps as they are: K3 and the batched K3.  Then fixed per-level iteration
counts, theta clamp, optional xy clamp and damping, heading wrapped between
levels.  ``early_exit_tol > 0`` stops a level early under K3's table and
K1's ``"onehot_bf16"`` one; ``"pallas"`` refuses it, as JAX does
(``hector.py:172-176``, ``fleet.py:89-92``).  One robot (``match``) stops a
level once an iteration moved its pixel-frame pose by no more than the
tolerance (``slamnet_tpu/models/hector.py:227-244``).  A fleet
(``match_batch``) stops a level only after an iteration in which NO
instance moved by more than the tolerance, and every instance then runs
that shared count (``slamnet_tpu/models/fleet.py:154-172``); at B = 1 the
two rules are one.  K6 refuses the exit when ``g_pack > 1``.  An instance
returns its hint when it has no valid beam, as JAX decides it: the single
robot tests the whole scan in the XLA modes (``hector.py:195,254``) and
the matcher's subsampled beams under ``"pallas"``
(``pallas_onehot.py:197``); the fleet tests the subsampled beams in every
mode (``fleet.py:67-71`` subsamples ``valid`` before
``:119``).  Every launch runs one kernel body, so K5 equals B separate K1
calls (the batched K3, B K3 calls) and K6 equals K5, bit for bit, wherever
a robot has a valid matcher beam.

``match_batch_plain`` is the same loop in PyTorch on the same table (the
ported ``ops/gn.py`` math), batched over the instance axis; it is the plain
version of K5, K6 and the batched K3, and ``match_plain`` (K1's and K3's) is
its one-robot case.  Each wrapper checks its inputs on any device, runs the
plain version for CPU tensors only, and for CUDA tensors launches the kernel
or raises.  Launch counts: ``match.launches`` (K1), ``match.launches_f32``
(K3), ``match_batch.launches`` (K5), ``match_batch.launches_f32`` (the
batched K3), ``match_packed.launches`` (K6); a fleet match with the exit
(one launch a level and a finishing one, ``csrc/match.cu``) counts once
there, and also in ``match_batch.exit_launches``.
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
# matcher modes by table precision: the bf16 table (K1/K5/K6) and the f32
# table (K3); JAX's "onehot_highest" equals "gather" bit for bit
# (slamnet_tpu/core/config.py:153)
BF16_MATCHERS = ("pallas", "onehot_bf16")
F32_MATCHERS = ("gather", "onehot_highest")
# the modes whose match takes early_exit_tol > 0, one robot or a fleet (JAX's
# XLA matchers; its "pallas" kernel refuses the exit)
EXIT_MATCHERS = F32_MATCHERS + ("onehot_bf16",)
OUT = 7               # floats a match returns (csrc/match.cu kOut)
MAX_BEAMS = 4096      # one match: 1024 threads x 4 beams each (csrc/match.cu)
MAX_THREADS = 1024    # a block's threads: g_pack matches of whole warps each
EXIT_MAX_ITERS = 16   # a level's iterations the fleet's exit holds (match.cu)
G_PACKS = (1, 2, 4, 8)


class _MatchParams(ctypes.Structure):
    """``struct MatchParams`` of csrc/match.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("stride", ctypes.c_int), ("n_points", ctypes.c_int),
                ("cells", ctypes.c_int), ("g_pack", ctypes.c_int),
                ("batch", ctypes.c_int), ("table_f32", ctypes.c_int),
                ("empty_full_scan", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("iters", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("deriv_clamp", ctypes.c_float), ("xy_clamp", ctypes.c_float),
                ("damping", ctypes.c_float), ("tol2", ctypes.c_float)]


def table_f32(cfg: HectorConfig) -> bool:
    """True when ``cfg.matcher_mode`` reads the f32 table (K3), False for the
    bf16 table (K1/K5/K6); raises ValueError for any other mode."""
    if cfg.matcher_mode in F32_MATCHERS:
        return True
    if cfg.matcher_mode in BF16_MATCHERS:
        return False
    raise ValueError(f"no match kernel for matcher_mode={cfg.matcher_mode!r}; "
                     f"known: {BF16_MATCHERS + F32_MATCHERS}")


def _check_cfg(cfg: HectorConfig) -> None:
    kernel = "K3" if table_f32(cfg) else "K1"
    if tuple(cfg.offset) != (0.0, 0.0):
        raise ValueError(f"{kernel} needs cfg.offset == (0, 0), got {cfg.offset}")
    if not 1 <= cfg.num_levels <= MAX_LEVELS:
        raise ValueError(f"{kernel} takes 1..{MAX_LEVELS} levels, got "
                         f"{cfg.num_levels}")
    if cfg.early_exit_tol > 0.0 and cfg.matcher_mode not in EXIT_MATCHERS:
        raise ValueError(f"{kernel} under matcher_mode={cfg.matcher_mode!r} "
                         "runs fixed per-level iterations, as JAX's does; "
                         "early_exit_tol is unsupported")


def full_scan_empty(cfg: HectorConfig) -> bool:
    """The single robot's rule for 'no valid beam' (returns the hint): the
    whole scan in the XLA modes, the matcher's beams for K1's ``"pallas"``.
    The fleet's rule is the matcher's beams in every mode."""
    return cfg.matcher_mode != "pallas"


def _threads(n: int) -> int:
    """Threads of one match: one a beam, whole warps, at most a block."""
    return min(max(-(-n // 32) * 32, 32), MAX_THREADS)


@functools.cache
def _params(cfg: HectorConfig, n_points: int, batch: int, g_pack: int,
            full_scan: bool) -> _MatchParams:
    nl = cfg.num_levels
    pad = [0] * (MAX_LEVELS - nl)
    return _MatchParams(
        nl, -(-n_points // cfg.match_subsample), cfg.match_subsample,
        n_points, cfg.total_cells, g_pack, batch, int(table_f32(cfg)),
        int(full_scan),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_sizes, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_offsets, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.estimate_iterations[:nl], *pad),
        (ctypes.c_float * MAX_LEVELS)(
            *[1.0 / r for r in cfg.level_resolutions], *pad),
        cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping,
        _tol2(cfg))


def _tol2(cfg: HectorConfig) -> float:
    """early_exit_tol squared, as JAX compares it: the Python square
    rounded to f32 (0: fixed iterations)."""
    return float(torch.tensor(cfg.early_exit_tol ** 2, dtype=torch.float32))


@functools.cache
def _launcher():
    lib = _build.library()[0]
    fn = lib.slamnet_match
    fn.argtypes = [ctypes.c_void_p] * 5 + [_MatchParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _exit_launcher():
    """(the fleet exit's launcher, its workspace size in floats)."""
    lib = _build.library()[0]
    fn = lib.slamnet_match_batch_exit
    fn.argtypes = [ctypes.c_void_p] * 6 + [_MatchParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    work = lib.slamnet_match_exit_work
    work.argtypes = [_MatchParams]
    work.restype = ctypes.c_longlong
    return fn, work


def _launch(what: str, maps, points, valid, hints, cfg: HectorConfig,
            batch: int, g_pack: int, full_scan: bool = False) -> torch.Tensor:
    out = torch.empty((batch, OUT), dtype=torch.float32, device=maps.device)
    code = _launcher()(maps.data_ptr(), points.data_ptr(), valid.data_ptr(),
                       hints.data_ptr(), out.data_ptr(),
                       _params(cfg, points.shape[-2], batch, g_pack,
                               full_scan),
                       _build.stream_handle(maps.device))
    _build.raise_on_error(code, what)
    return out


def _launch_exit(what: str, maps, points, valid, hints, cfg: HectorConfig,
                 batch: int) -> torch.Tensor:
    """The fleet's batch-wide exit: one launch a level and a finishing one
    over a workspace of the per-level, per-instance iteration states."""
    fn, work_floats = _exit_launcher()
    p = _params(cfg, points.shape[-2], batch, 1, False)
    out = torch.empty((batch, OUT), dtype=torch.float32, device=maps.device)
    work = torch.empty(work_floats(p), dtype=torch.float32, device=maps.device)
    code = fn(maps.data_ptr(), points.data_ptr(), valid.data_ptr(),
              hints.data_ptr(), out.data_ptr(), work.data_ptr(), p,
              _build.stream_handle(maps.device))
    _build.raise_on_error(code, what)
    return out


def match(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
          hint: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """K1 (bf16 table) or K3 (f32 table), by ``cfg.matcher_mode``:
    coarse-to-fine match of ``points`` f32[N, 2] / ``valid`` bool[N] in the
    pyramid ``maps`` f32[total_cells], from ``hint`` f32[3] (world).  Uses
    every ``cfg.match_subsample``-th beam.  Returns f32[7] on the device of
    ``maps``; launches nothing the host waits for."""
    _check_cfg(cfg)
    kernel = "K3" if table_f32(cfg) else "K1"
    if points.dim() != 2:
        raise ValueError(f"{kernel} points: want [N, 2], got "
                         f"{tuple(points.shape)}")
    _build.check_tensors(kernel, maps.device, (
        ("maps", maps, torch.float32, (cfg.total_cells,)),
        ("points", points, torch.float32, (points.shape[0], 2)),
        ("valid", valid, torch.bool, (points.shape[0],)),
        ("hint", hint, torch.float32, (3,))))
    n = -(-points.shape[0] // cfg.match_subsample)
    if not 1 <= n <= MAX_BEAMS:
        raise ValueError(f"{kernel} takes 1..{MAX_BEAMS} matcher beams, got {n}")
    if maps.device.type == "cpu":
        return match_plain(maps, points, valid, hint, cfg)
    out = _launch(f"{kernel} match", maps, points, valid, hint, cfg, 1, 1,
                  full_scan_empty(cfg))
    if kernel == "K3":
        match.launches_f32 += 1
    else:
        match.launches += 1
    return out.view(OUT)


match.launches = 0
match.launches_f32 = 0


def _check_batch(kernel: str, maps: torch.Tensor, points: torch.Tensor,
                valid: torch.Tensor, hints: torch.Tensor, cfg: HectorConfig,
                g_pack: int = 1) -> int:
    """Raise ValueError unless the fleet inputs fit K5 or the batched K3
    (``g_pack`` 1) or K6:
    contiguous maps f32[B*C], points f32[B, N, 2], valid bool[B, N], hints
    f32[B, 3] on one device, ``g_pack`` in G_PACKS dividing B, and g_pack
    matches of whole warps in one block; with the early exit, ``g_pack`` 1
    and at most EXIT_MAX_ITERS iterations a level.  Returns B."""
    _check_cfg(cfg)
    if cfg.early_exit_tol > 0.0:
        if g_pack != 1:
            raise ValueError(f"{kernel}: the fleet's batch-wide early exit "
                             f"runs one instance a block; g_pack={g_pack} "
                             "takes early_exit_tol=0 only")
        if max(cfg.estimate_iterations[:cfg.num_levels]) > EXIT_MAX_ITERS:
            raise ValueError(f"{kernel}: the fleet's early exit takes at most "
                             f"{EXIT_MAX_ITERS} iterations a level, got "
                             f"{cfg.estimate_iterations}")
    if points.dim() != 3:
        raise ValueError(f"{kernel} points: want [B, N, 2], got "
                         f"{tuple(points.shape)}")
    b, n_pts = points.shape[:2]
    _build.check_tensors(kernel, maps.device, (
        ("maps", maps, torch.float32, (b * cfg.total_cells,)),
        ("points", points, torch.float32, (b, n_pts, 2)),
        ("valid", valid, torch.bool, (b, n_pts)),
        ("hints", hints, torch.float32, (b, 3))))
    n = -(-n_pts // cfg.match_subsample)
    if not 1 <= n <= MAX_BEAMS:
        raise ValueError(f"{kernel} takes 1..{MAX_BEAMS} matcher beams, got {n}")
    if g_pack not in G_PACKS or b % g_pack:
        raise ValueError(f"{kernel} g_pack must be one of {G_PACKS} and divide "
                         f"B={b}, got {g_pack}")
    if g_pack * _threads(n) > MAX_THREADS:
        raise ValueError(f"{kernel}: {g_pack} matches of {_threads(n)} threads "
                         f"exceed a block's {MAX_THREADS}")
    return b


def match_batch(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                hints: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """K5 (bf16 table) or the batched K3 (f32 table), by
    ``cfg.matcher_mode``: every instance's match in one launch, one block an
    instance.  ``maps`` f32[B*C] (C = cfg.total_cells), ``points``
    f32[B, N, 2], ``valid`` bool[B, N], ``hints`` f32[B, 3] (world).
    Returns f32[B, 7] (``match``'s seven numbers per instance) on the device
    of ``maps``.  With ``early_exit_tol > 0``, the batch-wide exit: a launch
    a level and a finishing one, counted as one call."""
    f32 = table_f32(cfg)
    kernel = "K3 batch" if f32 else "K5"
    b = _check_batch(kernel, maps, points, valid, hints, cfg)
    if maps.device.type == "cpu":
        return match_batch_plain(maps, points, valid, hints, cfg)
    if cfg.early_exit_tol > 0.0:
        out = _launch_exit(f"{kernel} match_batch (exit)", maps, points,
                           valid, hints, cfg, b)
        match_batch.exit_launches += 1
    else:
        out = _launch(f"{kernel} match_batch", maps, points, valid, hints,
                      cfg, b, 1)
    if f32:
        match_batch.launches_f32 += 1
    else:
        match_batch.launches += 1
    return out


match_batch.launches = 0
match_batch.launches_f32 = 0
match_batch.exit_launches = 0


def match_packed(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                 hints: torch.Tensor, cfg: HectorConfig,
                 g_pack: int = 4) -> torch.Tensor:
    """K6: ``match_batch`` with ``g_pack`` instances sharing a block, each on
    its own warps.  Computes the same function as ``match_batch``, bit for
    bit, in either table precision; its plain version is
    ``match_batch_plain``.  The early exit takes ``g_pack`` 1 only (and then
    runs K5's launches)."""
    b = _check_batch("K6", maps, points, valid, hints, cfg, g_pack)
    if maps.device.type == "cpu":
        return match_batch_plain(maps, points, valid, hints, cfg)
    if cfg.early_exit_tol > 0.0:
        out = _launch_exit("K6 match_packed (exit)", maps, points, valid,
                           hints, cfg, b)
    else:
        out = _launch("K6 match_packed", maps, points, valid, hints, cfg, b,
                      g_pack)
    match_packed.launches += 1
    return out


match_packed.launches = 0


def match_plain(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                hint: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """K1's and K3's plain version: same inputs, same f32[7] output (the
    one-robot case of ``match_batch_plain``, with the single robot's rule for
    an empty scan; at one robot the batch-wide exit is the single robot's)."""
    return match_batch_plain(maps, points[None], valid[None], hint[None],
                             cfg, full_scan_empty(cfg))[0]


def match_batch_plain(maps: torch.Tensor, points: torch.Tensor,
                      valid: torch.Tensor, hints: torch.Tensor,
                      cfg: HectorConfig, full_scan: bool = False
                      ) -> torch.Tensor:
    """The plain version of K5, K6 and the batched K3
    (``fleet._match_batch``'s semantics, ``slamnet_tpu/models/fleet.py:61-187``):
    one batched loop over the instance axis, each instance gathering at
    ``b*C + offset_l + yi*w + xi`` of the flat table, bf16-rounded or f32 by
    ``cfg.matcher_mode``.  An instance with no valid matcher beam (with
    ``full_scan``, no valid beam in its whole scan) returns its hint.

    With ``early_exit_tol > 0`` a level stops after the first iteration in
    which no instance moved its pixel-frame pose by more than the tolerance
    (``fleet.py:154-172``: ``max_b moved2_b <= tol2``, a NaN stopping it as
    ``jnp.max`` propagates it); every instance runs that shared count.  The
    loop runs every iteration and freezes the whole batch once the level
    has stopped (one device flag for all instances), which gives JAX's while
    loop without a host read.  Returns f32[B, 7]."""
    _check_cfg(cfg)
    b = points.shape[0]
    dev = maps.device
    sub = cfg.match_subsample
    X, Y, V = points[:, ::sub, 0], points[:, ::sub, 1], valid[:, ::sub]
    table = maps if table_f32(cfg) else maps.to(torch.bfloat16).to(torch.float32)
    inst = torch.arange(b, device=dev)[:, None] * cfg.total_cells
    zero = torch.zeros(b, dtype=torch.float32, device=dev)
    fails, resid, n_in, iters = zero, zero, zero, zero
    tol2 = _tol2(cfg)
    pose = hints
    for level in range(cfg.num_levels - 1, -1, -1):
        w = cfg.level_sizes[level]
        scale = 1.0 / cfg.level_resolutions[level]
        row0 = inst + cfg.level_offsets[level]
        est = torch.stack([pose[:, 0] * scale, pose[:, 1] * scale, pose[:, 2]],
                          dim=1)
        live = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(cfg.estimate_iterations[level]):
            sr, cr, mx, my, ok, xi, yi = _gn_coords(w, scale, est, X, Y, V)
            base = row0 + (yi * w + xi).long()
            v = torch.sigmoid(table[torch.stack([base, base + 1, base + w,
                                                 base + w + 1])])
            new, solve_ok, r_new, n_new = _gn_tail(
                v, mx, my, xi, yi, ok, X, Y, sr, cr, est, cfg.deriv_clamp,
                cfg.xy_step_clamp_px, cfg.gn_damping)
            d = new - est
            moved2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            est = torch.where(live, new, est)
            fails = fails + (~solve_ok & live).to(torch.float32)
            resid = torch.where(live, r_new, resid)
            n_in = torch.where(live, n_new, n_in)
            iters = iters + live.to(torch.float32)
            if tol2 > 0.0:
                live = live & (moved2.max() > tol2)
        pose = torch.stack([est[:, 0] / scale, est[:, 1] / scale,
                            normalize_angle(est[:, 2])], dim=1)
    # an instance with no valid beam returns its hint (ScanMatcher.cs:82-83)
    any_valid = (valid if full_scan else V).any(dim=1, keepdim=True)
    pose = torch.where(any_valid, pose, hints)
    return torch.cat([pose, torch.stack([fails, resid, n_in, iters], dim=1)],
                     dim=1)
