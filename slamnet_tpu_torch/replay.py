"""The slices end to end: make the loop log, bootstrap, replay, score.

Port of the headline flow of ``bench.py:103-198`` for the ``fixed`` and
``pallas_dense`` configurations:

  * ``make_log``: the port's simulator on the CPU (numpy out) — the loop
    trajectory at 0.3 m/s, 400-beam revolutions with the reference's
    discrete uniform noise drawn from a seeded ``torch.Generator``;
  * ``bootstrap``: the first ``bootstrap`` scans as forced map updates at the
    true poses, in the ``fixed`` config whatever the mode, as the bench does
    (``bench.py:147-172``);
  * ``replay``: every later scan matched with the previous ``match_pose`` as
    its hint, maps updated behind the motion gate;
  * ``ate_of``: RMS and max position error against the truth.

``JAX_FIXED_REF_ATE_M`` and ``JAX_REF_ATE_M`` are the JAX package's ATEs on
this same log and flow (``fixed``; ``matcher_mode="onehot_bf16"`` + dense
fill, the selection K1 makes), written by ``scripts/torch_port_ref_ate.py``;
``JAX_EXIT_REF_ATE_M`` is JAX's ``onehot_bf16_dense`` with its early exit
(``bench.py:214-217``), the port's ``onehot_bf16_dense_config``.

The fleet flow of ``bench.py:435-493`` for ``sub4_pallas_dense`` and
``sub1``:

  * ``make_fleet_log``: B phase-shifted slices of that log, one a robot;
  * ``fleet_bootstrap``: each robot's first ``bootstrap`` scans as forced
    updates with ``match_pose`` set to the true poses, in the mode's own
    config (``bench.py:462-475``);
  * ``models.fleet.replay_fleet``: the remaining batch-scans, each hinted
    with the previous match pose;
  * ``fleet_ate_of``: RMS over all instance-scans, max, and the median of
    the per-instance ATEs (``bench.py:489-493``).

``FLEET_JAX_REF_*`` and ``FLEET_SUB1_JAX_REF_*`` are the JAX package's
fleet on the same slices and flow (``sub4_onehot_dense``, K5's selection in
XLA; ``sub1``), from ``scripts/torch_port_ref_ate.py --fleet [--mode sub1]``.

The graph-SLAM flow of ``bench.py:556-647`` for ``gather`` and
``pallas_full``:

  * ``make_graph_log``: GRAPH_BOOTSTRAP still scans at (20, 20, 0), then the
    turning revisit (``rect_revisit_trajectory(num_loops=2)``), N_SCANS in
    all, simulated as ``make_log`` does;
  * ``graph_replay``: ``models.graph_slam.update`` over every scan, the first
    GRAPH_BOOTSTRAP forced in the mode's own config (``bench.py:613,
    624-626``; not in ``fixed``, unlike the single robot);
  * ``graph_ate_of``: RMS and max position error of the live match pose over
    the scans after the bootstrap (``bench.py:639-641``), beside the
    keyframes and the accepted loop closures.

``GRAPH_JAX_REF_*`` (``gather``) and ``GRAPH_ONEHOT_JAX_REF_*`` (JAX's
``onehot_full``, ``bench.py:669-674``, which stands in for ``pallas_full``:
JAX's ``pallas`` kernels run only interpreted on the CPU) are the JAX
package on the same log and flow, from ``scripts/torch_port_ref_ate.py
--graph --mode {gather,onehot_full}``.  A mode passes the bench's relative
gate (``graph_gate``, ``bench.py:689-701``) against its reference.

The office loop of ``bench.py:303-431``, graph-SLAM against Hector alone
under drifting odometry on a 200-px map that the tour outruns:

  * ``make_office_log``: OFFICE_BOOTSTRAP still scans at the tour's start,
    then two laps of the office's rooms (689 scans), 400 beams to 10 m with
    the uniform grid noise and Gaussian range error;
  * ``office_odometry``: ``drifting_odometry`` along the truth and its
    deltas, the heading's wrapped;
  * ``office_replay``: Hector alone or graph-SLAM, each scan hinted with the
    match pose plus the odometry delta; the first OFFICE_BOOTSTRAP scans
    forced, and a forced scan's pose then set to the odometry;
  * ``office_metrics`` / ``office_gate``: the bench's ``office_*`` numbers
    and its graph gate against ``OFFICE_JAX_REF_*`` (``scripts/
    torch_port_ref_ate.py --office``).

CoreSLAM's flow of ``bench.py:825-875``: ``coreslam_replay`` runs
``models.coreslam.update_cloud`` over every scan of ``make_log(0)``, the
state's own pose as the odometry, in ``coreslam_parity_config`` (Monte-Carlo
with 4096 candidates, line updates) or ``coreslam_production_config``
(correlative search, dense fills); its ATE is over every scan.
``CORESLAM_JAX_REF_ATE_M`` (production, from the true start),
``CORESLAM_JAX_REF_ATES_M`` (production, from starts nudged by
``CORESLAM_NUDGES`` ulps) and ``CORESLAM_PARITY_JAX_REF_ATES_M`` (parity
under ``PRNGKey(1..9)``) come from ``scripts/torch_port_ref_ate.py
--coreslam``; ``coreslam_gate`` holds the port's medians to them.

The particle layer's flow (``bench.py:714-822``): ``particle_replay`` and
``particle_gate`` against ``PARTICLE_*JAX_REF_ATES_M``.

The dataset flow of ``examples/replay_dataset.py:64-143`` over a CARMEN log
(the checked-in ``SIM_LOOP_LOG`` and ``ADVERSARIAL_LOG``):

  * ``load_carmen``: the log read by ``hostio.read_carmen_native`` (the
    Python reader for a log without FLASER lines), recentred so its first
    odometry pose sits at the map's centre, its clouds on a device;
  * ``dataset_config``: Hector at 3 levels (7/4/4, 40 m / 400 px, gather +
    line updates: K3 + K4; with ``robust`` the xy clamp 10 px, max jump 1 m,
    damping 0.1) and CoreSLAM correlative with the dense fills;
  * ``carmen_replay``: both pipelines over every scan, Hector hinted with
    its match pose plus the odometry delta (on the device: no host read in
    the loop), the first DATASET_FORCED scans forced and set to the
    odometry; CoreSLAM with the odometry pose;
  * ``dataset_metrics`` / ``dataset_gate``: the ATEs against the truth and
    the gates against ``SIM_LOOP_JAX_REF_*`` / ``ADVERSARIAL_JAX_REF_*``
    (``scripts/torch_port_ref_ate.py --dataset {sim_loop,adversarial}``).

``COMPAT_JAX_REF_*`` is JAX's ``compat.HectorSLAMProcessor`` at the
simulator's constructor (0.1 m, 400 px, 4 levels, 7/4/4/4) over
``make_log(0)`` (``... --compat``).

The multi-device flows of ``__graft_entry__.dryrun_multichip`` (sections
1, 1b and 2), each called by every rank of a mesh (``parallel.launch``
starts the ranks): ``sharded_replay`` runs ``models.hector_sharded`` over
the first SHARDED_N scans of a log, the bootstrap forced at the true poses,
then every scan matched from the previous pose; ``sharded_coreslam_replay``
runs ``models.coreslam_sharded`` as ``coreslam_replay`` runs the dense one.
``multichip_meshes(n)`` names ``dryrun_multichip(n)``'s meshes (2x4 and
4x2 at 8 devices, 2x2 and 4x1 at 4).  ``SHARDED_JAX_REF_*`` are JAX's
``hector_sharded`` over the first SHARDED_N scans of ``make_log(0)`` on
each of those meshes (8 and 4 virtual CPU devices),
``SHARDED_CORESLAM_JAX_REF_ATE(S)_M`` its production CoreSLAM on the first
mesh (``scripts/torch_port_ref_ate.py --sharded [--devices 4]``).

``dryrun_multichip``'s section 3, distributed graph-SLAM: ``make_sharded_
graph_log`` (6 still scans, then the turning rectangle), ``sharded_graph_
config`` (the onehot_bf16 pyramid, a onehot_bf16 + dense-fill frontend,
the section's pose graph and 8 separator slots), ``sharded_graph_replay``
(``models.graph_slam_sharded`` over the log, the first scans forced),
``sharded_graph_metrics`` and ``sharded_graph_gate`` against
``SHARDED_GRAPH_JAX_REF_*`` (JAX's ``graph_slam_sharded`` on the 2x4 mesh
and on the 2x2 mesh of 4 devices, the same numbers;
``scripts/torch_port_ref_ate.py --sharded-graph [--devices 4]``).
"""
from __future__ import annotations

import functools
import json
import math
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core.config import (CoreSlamConfig, HectorConfig, ParticleConfig,
                          PoseGraphConfig, SimConfig)
from .core.geometry import pose_between, pose_compose
from .core.scan import Scan
from .graph import posegraph
from .graph.frontend import ScanMatchConfig
from .io.datasets import LidarLog, drifting_odometry, log_points, read_carmen
from .models import (coreslam, coreslam_sharded, fleet, graph_slam,
                     graph_slam_sharded, hector, hector_sharded, particle)
from .sim import default_field, office_field, revolution_angles, scan_revolution
from .sim.trajectory import (loop_trajectory, office_tour_trajectory,
                             rect_drive_trajectory, rect_revisit_trajectory)

N_SCANS = 512
BOOTSTRAP = 10
NUM_BEAMS = 400

# JAX package on make_log(seed=0), 10-scan fixed-mode bootstrap + 512
# replayed scans, JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py`
# printed "fixed": {"ate_m": 0.002116798423230648, "max_err_m":
# 0.008902426809072495, "map_updates": 28, "solve_failures": 0} (gather
# matcher + line updates) and "onehot_bf16_dense": {"ate_m":
# 0.002063475549221039, "max_err_m": 0.008838655427098274, "map_updates": 28,
# "solve_failures": 0} (onehot_bf16 + dense fill, fixed 7/4/4 iterations).
JAX_FIXED_REF_ATE_M = 0.002116798423230648
JAX_REF_ATE_M = 0.002063475549221039
# JAX package onehot_bf16_dense with early_exit_tol=1e-3 (bench.py:214-217)
# on the same log and flow, JAX 0.9.0 on the CPU: `python
# scripts/torch_port_ref_ate.py --exit` printed "onehot_bf16_dense_exit":
# {"ate_m": 0.0020575514063239098, "max_err_m": 0.008838655427098274,
# "map_updates": 28, "solve_failures": 0}.
JAX_EXIT_REF_ATE_M = 0.0020575514063239098

FLEET_B = 64
FLEET_T = 64
# JAX package fleet (sub4_onehot_dense) on make_fleet_log(make_log(seed=0)),
# 64 robots, 10 forced + 64 tracked batch-scans, JAX 0.9.0 on the CPU:
# `python scripts/torch_port_ref_ate.py --fleet` printed
# "fleet_sub4_onehot_dense": {"ate_m": 0.006292261648923159, "max_err_m":
# 0.03412262722849846, "ate_median_m": 0.005386218428611755, "map_updates":
# 183, "solve_failures": 0}; `... --fleet --mode sub4_onehot_dense` (the
# port's row of that name) printed the same numbers and "gn_iterations": 960.
FLEET_JAX_REF_ATE_M = 0.006292261648923159
FLEET_JAX_REF_MAX_M = 0.03412262722849846
FLEET_JAX_REF_MEDIAN_M = 0.005386218428611755
# JAX package fleet sub1 (gather matcher + line updates) on the same slices
# and flow, JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py
# --fleet --mode sub1` printed "fleet_sub1": {"ate_m": 0.003720715409144759,
# "max_err_m": 0.02590116672217846, "ate_median_m": 0.003108435543254018,
# "map_updates": 183, "solve_failures": 0}.
FLEET_SUB1_JAX_REF_ATE_M = 0.003720715409144759
FLEET_SUB1_JAX_REF_MAX_M = 0.02590116672217846
FLEET_SUB1_JAX_REF_MEDIAN_M = 0.003108435543254018
# JAX package fleet rows on the same slices and flow, JAX 0.9.0 on the CPU,
# `python scripts/torch_port_ref_ate.py --fleet --mode M` for M below
# printed (RMS, max, median instance ATE, GN iterations over the 64 tracked
# batch-scans, each the batch's shared count; 183 map updates and 0 solve
# failures unless noted):
#   sub4: {"ate_m": 0.005417789798229933, "max_err_m": 0.03639687970280647,
#     "ate_median_m": 0.004541186615824699, "gn_iterations": 960};
#   sub4_onehot: {"ate_m": 0.0054117715917527676, "max_err_m":
#     0.0364249050617218, "ate_median_m": 0.004560044500976801,
#     "gn_iterations": 960};
#   sub4_onehot_cap8: {"ate_m": 0.08049791306257248, "max_err_m":
#     0.3422115445137024, "ate_median_m": 0.07400892674922943,
#     "map_updates": 228, "solve_failures": 3360, "gn_iterations": 960};
#   sub4_onehot_cap32: {"ate_m": 0.03142016381025314, "max_err_m":
#     0.133873850107193, "ate_median_m": 0.012603780254721642,
#     "map_updates": 214, "solve_failures": 480, "gn_iterations": 960};
#   sub1_exit: {"ate_m": 0.0037118743639439344, "max_err_m":
#     0.02590116672217846, "ate_median_m": 0.003108435543254018,
#     "gn_iterations": 960} (the batch never stops a level at 1e-3: some
#     robot always moves more; the ATE differs from sub1's by JAX's own
#     while-loop rounding);
#   sub4_onehot_exit: sub4_onehot's numbers exactly, "gn_iterations": 960.
FLEET_SUB4_JAX_REF_ATE_M = 0.005417789798229933
FLEET_SUB4_JAX_REF_MAX_M = 0.03639687970280647
FLEET_SUB4_JAX_REF_MEDIAN_M = 0.004541186615824699
FLEET_SUB4_ONEHOT_JAX_REF_ATE_M = 0.0054117715917527676
FLEET_SUB4_ONEHOT_JAX_REF_MAX_M = 0.0364249050617218
FLEET_SUB4_ONEHOT_JAX_REF_MEDIAN_M = 0.004560044500976801
FLEET_CAP8_JAX_REF_ATE_M = 0.08049791306257248
FLEET_CAP8_JAX_REF_MAX_M = 0.3422115445137024
FLEET_CAP8_JAX_REF_MEDIAN_M = 0.07400892674922943
FLEET_CAP32_JAX_REF_ATE_M = 0.03142016381025314
FLEET_CAP32_JAX_REF_MAX_M = 0.133873850107193
FLEET_CAP32_JAX_REF_MEDIAN_M = 0.012603780254721642
FLEET_SUB1_EXIT_JAX_REF_ATE_M = 0.0037118743639439344
FLEET_SUB1_EXIT_JAX_REF_MAX_M = 0.02590116672217846
FLEET_SUB1_EXIT_JAX_REF_MEDIAN_M = 0.003108435543254018
FLEET_SUB1_EXIT_JAX_REF_GN_ITERATIONS = 960
FLEET_SUB4_ONEHOT_EXIT_JAX_REF_GN_ITERATIONS = 960


def fixed_config(**overrides) -> HectorConfig:
    """bench.py's reference-exact mode (``bench.py:109``): 3-level 400x400
    pyramid, 7/4/4 GN iterations, every other field at its default — the
    gather matcher (K3) and the Bresenham line update (K4)."""
    return HectorConfig(num_levels=3,
                        estimate_iterations=(7, 4, 4)).overlay(overrides)


def pallas_dense_config(**overrides) -> HectorConfig:
    """bench.py's headline mode (``bench.py:222-224``): 3-level 400x400
    pyramid, 7/4/4 GN iterations, K1 matcher, dense fill."""
    return HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        matcher_mode="pallas", dense_free_fill=True).overlay(
                            overrides)


def onehot_bf16_dense_config(**overrides) -> HectorConfig:
    """bench.py's default headline candidate ``onehot_bf16_dense``
    (``bench.py:214-217``): the fixed pyramid with ``early_exit_tol=1e-3``,
    ``matcher_mode="onehot_bf16"`` (K1's table) and the dense fill (K2)."""
    return HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        early_exit_tol=1e-3, matcher_mode="onehot_bf16",
                        dense_free_fill=True).overlay(overrides)


def sub1_config(**overrides) -> HectorConfig:
    """bench.py's fleet accuracy anchor ``sub1`` (``bench.py:453-454``,
    ``:499``): the fleet base (xy clamp 10 px, max jump 1 m) with the gather
    matcher on every beam (the batched K3) and line updates (the batched
    K4)."""
    return HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        xy_step_clamp_px=10.0,
                        max_match_jump=1.0).overlay(overrides)


def sub1_exit_config(**overrides) -> HectorConfig:
    """``sub1`` with ``early_exit_tol=1e-3`` (bench.py's single-robot
    tolerance, ``bench.py:215``): the batched K3 with JAX's batch-wide exit
    (``slamnet_tpu/models/fleet.py:154-172``) and the batched K4."""
    return sub1_config(early_exit_tol=1e-3).overlay(overrides)


def sub4_config(**overrides) -> HectorConfig:
    """bench.py's fleet mode ``sub4`` (``bench.py:506``): the fleet base with
    the gather matcher on every 4th beam (the batched K3) and line updates
    on all beams (the batched K4)."""
    return sub1_config(match_subsample=4).overlay(overrides)


def sub4_onehot_config(**overrides) -> HectorConfig:
    """bench.py's fleet mode ``sub4_onehot`` (``bench.py:511-512``): ``sub4``
    with ``matcher_mode="onehot_bf16"`` (K5's table) and line updates (the
    batched K4)."""
    return sub4_config(matcher_mode="onehot_bf16").overlay(overrides)


def sub4_onehot_exit_config(**overrides) -> HectorConfig:
    """``sub4_onehot`` with ``early_exit_tol=1e-3``: K5 with JAX's
    batch-wide exit and the batched K4 (not a bench row; ``sub1_exit``'s
    twin on K1's table)."""
    return sub4_onehot_config(early_exit_tol=1e-3).overlay(overrides)


def sub4_onehot_cap_config(capacity: int, **overrides) -> HectorConfig:
    """bench.py's ``sub4_onehot_cap8`` / ``sub4_onehot_cap32``
    (``bench.py:517-523``): ``sub4_onehot`` with at most ``capacity`` map
    updates a batch-scan (the rest defer, ``fleet.py:219-228``)."""
    return sub4_onehot_config(fleet_update_capacity=capacity).overlay(
        overrides)


def sub4_onehot_dense_config(**overrides) -> HectorConfig:
    """bench.py's fleet headline ``sub4_onehot_dense`` (``bench.py:500-502``):
    ``sub4_onehot`` with the dense fill, K5 (K1's table) and the batched
    K2."""
    return sub4_onehot_config(dense_free_fill=True).overlay(overrides)


def sub4_pallas_dense_config(**overrides) -> HectorConfig:
    """bench.py's fleet base (``bench.py:453-454``) with the K5 matcher and
    the dense fill: bench's fleet headline ``sub4_onehot_dense``
    (``bench.py:500-502``) with ``onehot_bf16`` swapped for ``pallas``, the
    same selection."""
    return HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        xy_step_clamp_px=10.0, max_match_jump=1.0,
                        match_subsample=4, matcher_mode="pallas",
                        dense_free_fill=True).overlay(overrides)


class ScanLog(NamedTuple):
    """A scan log; a fleet log (``make_fleet_log``) has a robot axis B after
    the time axis: traj f32[T, B, 3], radii f32[T, B, N], valid bool[T, B, N]."""
    traj: np.ndarray     # f32[T, 3] true poses
    angles: np.ndarray   # f32[N] beam angles (robot frame)
    radii: np.ndarray    # f32[T, N] noisy ranges, 0 where missed
    valid: np.ndarray    # bool[T, N]
    bootstrap: int       # leading scans mapped at the true pose


class DeviceLog(NamedTuple):
    """A ScanLog's clouds on a device (fleet: points f32[T, B, N, 2])."""
    points: torch.Tensor  # f32[T, N, 2] robot-local clouds
    valid: torch.Tensor   # bool[T, N]
    traj: torch.Tensor    # f32[T, 3]


def make_log(seed: int = 0) -> ScanLog:
    """The bench's loop log (``bench.py:109-135``: BOOTSTRAP + N_SCANS poses
    of the loop at 0.3 m/s, NUM_BEAMS-beam revolutions, SimConfig's range
    and noise), simulated on the CPU from ``seed``."""
    sim = SimConfig()
    traj = loop_trajectory(speed=0.3)[:N_SCANS + BOOTSTRAP]
    angles = revolution_angles(NUM_BEAMS)
    fld = default_field(sim.field_scale, sim.field_offset, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    radii, valid = scan_revolution(fld, torch.from_numpy(traj),
                                   torch.from_numpy(angles),
                                   sim.max_scan_dist, sim.measure_error, gen)
    return ScanLog(traj, angles, radii.numpy(), valid.numpy(), BOOTSTRAP)


def make_fleet_log(log: ScanLog, b: int = FLEET_B, t: int = FLEET_T) -> ScanLog:
    """``b`` phase-shifted slices of ``log``, ``log.bootstrap + t`` scans each
    (``bench.py:452-459``): robot i replays scans ``starts[i]`` onward, with
    ``starts = linspace(0, total - (t + bootstrap), b)``, so the motion gates
    of the robots fire out of step."""
    span = t + log.bootstrap
    starts = np.linspace(0, log.radii.shape[0] - span, b).astype(int)

    def cut(a):
        return np.stack([a[s:s + span] for s in starts], axis=1)
    return ScanLog(cut(log.traj), log.angles, cut(log.radii), cut(log.valid),
                   log.bootstrap)


def to_device(log: ScanLog, device: torch.device | str) -> DeviceLog:
    """Every scan's cloud on ``device``, made once (MainWindow.xaml.cs:167-177)."""
    r = torch.as_tensor(log.radii, device=device)
    a = torch.as_tensor(log.angles, device=device)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1).contiguous()
    return DeviceLog(pts, torch.as_tensor(log.valid, device=device),
                     torch.as_tensor(log.traj, device=device))


def fixed_of(cfg: HectorConfig) -> HectorConfig:
    """``cfg``'s ``fixed`` twin: the same pyramid with the gather matcher,
    the line update and fixed iterations (``bench.py``'s mode configs are
    its ``fixed`` config with these three fields replaced)."""
    return cfg.overlay({"matcher_mode": "gather", "dense_free_fill": False,
                        "early_exit_tol": 0.0})


def bootstrap(state: hector.HectorState, dlog: DeviceLog, n: int,
              cfg: HectorConfig, plain: bool = False) -> hector.HectorState:
    """Forced map updates at the true poses for scans 0..n-1 (in place), in
    ``fixed_of(cfg)`` whatever ``cfg``'s mode (``bench.py:147-172``)."""
    zero = torch.zeros(3, dtype=torch.float32, device=dlog.points.device)
    boot_cfg = fixed_of(cfg)
    for t in range(n):
        state, _ = hector.update(state, Scan(dlog.points[t], dlog.valid[t], zero),
                                 dlog.traj[t], boot_cfg, True, plain)
    return state


class ReplayOut(NamedTuple):
    poses: torch.Tensor           # f32[S, 3] match pose after each scan
    map_updated: torch.Tensor     # bool[S]
    residual: torch.Tensor        # f32[S]
    solve_failures: torch.Tensor  # i32[S]
    gn_iterations: torch.Tensor   # i32[S] GN iterations run (all levels)


def replay(state: hector.HectorState, dlog: DeviceLog, start: int,
           cfg: HectorConfig, plain: bool = False
           ) -> Tuple[hector.HectorState, ReplayOut]:
    """Track scans start..T-1, each hinted with the previous match pose.  Runs
    on a copy of ``state``'s maps, so the caller's state can be replayed
    again; returns the final state and per-scan outputs on the device (the
    host waits for nothing)."""
    dev = dlog.points.device
    state = state._replace(maps=state.maps.clone())
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    poses, upd, resid, fails, iters = [], [], [], [], []
    for t in range(start, dlog.points.shape[0]):
        state, info = hector.update(state, Scan(dlog.points[t], dlog.valid[t], zero),
                                    state.match_pose, cfg, False, plain)
        poses.append(state.match_pose)
        upd.append(info.map_updated)
        resid.append(info.residual)
        fails.append(info.solve_failures)
        iters.append(info.gn_iterations)
    return state, ReplayOut(torch.stack(poses), torch.stack(upd),
                            torch.stack(resid), torch.stack(fails),
                            torch.stack(iters))


def ate_of(poses: np.ndarray, truth: np.ndarray) -> Tuple[float, float]:
    """(RMS, max) position error in meters (``bench.py:195-198``)."""
    pe = np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(truth)[:, :2],
                        axis=1)
    return float(np.sqrt((pe ** 2).mean())), float(pe.max())


def fleet_bootstrap(states: hector.HectorState, dlog: DeviceLog, n: int,
                    cfg: HectorConfig, plain: bool = False
                    ) -> hector.HectorState:
    """Forced map updates for batch-scans 0..n-1 with every robot's
    ``match_pose`` set to its true pose first (``bench.py:466-475``);
    ``states.maps`` is updated in place."""
    for t in range(n):
        states = states._replace(match_pose=dlog.traj[t].clone())
        states, _ = fleet.update_fleet(states, dlog.points[t], dlog.valid[t],
                                       cfg, True, plain)
    return states


def fleet_ate_of(poses: np.ndarray, truth: np.ndarray
                 ) -> Tuple[float, float, float]:
    """(RMS over all instance-scans, max, median per-instance ATE) in meters
    for poses and truth f32[T, B, 3] (``bench.py:489-493``)."""
    pe = np.linalg.norm(np.asarray(poses)[..., :2] - np.asarray(truth)[..., :2],
                        axis=-1)
    inst = np.sqrt((pe ** 2).mean(axis=0))
    return (float(np.sqrt((pe ** 2).mean())), float(pe.max()),
            float(np.median(inst)))


# bench.py's fleet modes (bench.py:496-523) as the port runs them, and the
# batch-wide exit's rows sub1_exit and sub4_onehot_exit; sub4_pallas_dense
# is the bench's sub4_onehot_dense under the name "pallas" (the same bf16
# selection through K5, and the same kernels)
FLEET_MODES = {"sub1": sub1_config, "sub4": sub4_config,
               "sub4_onehot": sub4_onehot_config,
               "sub4_onehot_cap8": functools.partial(sub4_onehot_cap_config, 8),
               "sub4_onehot_cap32": functools.partial(sub4_onehot_cap_config,
                                                      32),
               "sub4_pallas_dense": sub4_pallas_dense_config,
               "sub4_onehot_dense": sub4_onehot_dense_config,
               "sub1_exit": sub1_exit_config,
               "sub4_onehot_exit": sub4_onehot_exit_config}


# each fleet row's JAX reference: (RMS, max, median instance ATE, GN
# iterations or None); sub4_onehot_exit's ATEs are sub4_onehot's, and
# sub4_pallas_dense's are JAX's sub4_onehot_dense (FLEET_JAX_REF_*)
FLEET_ROW_JAX_REFS = {
    "sub1": (FLEET_SUB1_JAX_REF_ATE_M, FLEET_SUB1_JAX_REF_MAX_M,
             FLEET_SUB1_JAX_REF_MEDIAN_M, None),
    "sub4_pallas_dense": (FLEET_JAX_REF_ATE_M, FLEET_JAX_REF_MAX_M,
                          FLEET_JAX_REF_MEDIAN_M, None),
    "sub4_onehot_dense": (FLEET_JAX_REF_ATE_M, FLEET_JAX_REF_MAX_M,
                          FLEET_JAX_REF_MEDIAN_M, None),
    "sub4": (FLEET_SUB4_JAX_REF_ATE_M, FLEET_SUB4_JAX_REF_MAX_M,
             FLEET_SUB4_JAX_REF_MEDIAN_M, None),
    "sub4_onehot": (FLEET_SUB4_ONEHOT_JAX_REF_ATE_M,
                    FLEET_SUB4_ONEHOT_JAX_REF_MAX_M,
                    FLEET_SUB4_ONEHOT_JAX_REF_MEDIAN_M, None),
    "sub4_onehot_cap8": (FLEET_CAP8_JAX_REF_ATE_M, FLEET_CAP8_JAX_REF_MAX_M,
                         FLEET_CAP8_JAX_REF_MEDIAN_M, None),
    "sub4_onehot_cap32": (FLEET_CAP32_JAX_REF_ATE_M,
                          FLEET_CAP32_JAX_REF_MAX_M,
                          FLEET_CAP32_JAX_REF_MEDIAN_M, None),
    "sub1_exit": (FLEET_SUB1_EXIT_JAX_REF_ATE_M, FLEET_SUB1_EXIT_JAX_REF_MAX_M,
                  FLEET_SUB1_EXIT_JAX_REF_MEDIAN_M,
                  FLEET_SUB1_EXIT_JAX_REF_GN_ITERATIONS),
    "sub4_onehot_exit": (FLEET_SUB4_ONEHOT_JAX_REF_ATE_M,
                         FLEET_SUB4_ONEHOT_JAX_REF_MAX_M,
                         FLEET_SUB4_ONEHOT_JAX_REF_MEDIAN_M,
                         FLEET_SUB4_ONEHOT_EXIT_JAX_REF_GN_ITERATIONS),
}


# The capped rows defer updates, so robots 32-63 (cap 32) or 8-63 (cap 8)
# start tracking on maps of one scan, where a match is ill-conditioned: an
# ulp of difference in a sum grows to centimetres.  JAX's own runs of the
# same row move with XLA's fusion (torch_port_ref_ate.py --fleet --mode
# sub4_onehot_cap32 [--eager] [--matcher gather]: RMS 0.031117-0.032005,
# max 0.1325-0.1577, median 0.0097-0.0145; PERF.md section 6, PR 8), so
# these rows are held to the bench's relative gate for a schedule-dependent
# ATE (bench.py:689-701): RMS and median within 1.15 x JAX's, the max
# reported.
FLEET_CAPPED_ROWS = ("sub4_onehot_cap8", "sub4_onehot_cap32")


def fleet_row_gate(mode: str, got) -> list:
    """A fleet row's gate against ``FLEET_ROW_JAX_REFS[mode]``, ``got`` =
    (RMS, max, median instance ATE, GN iterations over the tracked
    batch-scans): the fleet's tolerances +5e-4 / 0.01 / 2e-4 m (the capped
    rows: RMS and median within 1.15 x JAX's), and the iterations equal to
    JAX's where it has them.  Returns the failed conditions."""
    ref = FLEET_ROW_JAX_REFS[mode]
    names = ("RMS ATE", "max error", "median instance ATE")
    if mode in FLEET_CAPPED_ROWS:
        fails = [f"{name} {g} > 1.15 x {r}" for name, g, r in zip(
            names, got, ref) if name != "max error" and not g <= 1.15 * r]
    else:
        fails = [f"{name} {g} > {r} + {tol}" for name, g, r, tol in zip(
            names, got, ref, (5e-4, 0.01, 2e-4)) if not g <= r + tol]
    if ref[3] is not None and got[3] != ref[3]:
        fails.append(f"GN iterations {got[3]} != {ref[3]}")
    return fails


def fleet_headline(rows: dict) -> Tuple[str, float]:
    """bench.py's headline rule (``bench.py:540-543``) over ``rows`` {mode:
    (instance-scans/s, RMS ATE m)}, which must hold ``sub1``: the fastest
    mode whose RMS ATE is at most 2 x sub1's.  Returns (mode, bound)."""
    bound = 2.0 * rows["sub1"][1]
    return max((r[0], name) for name, r in rows.items()
               if r[1] <= bound)[1], bound


GRAPH_SEED = 7
GRAPH_BOOTSTRAP = 12
# JAX package graph_slam on make_graph_log(seed=7), 12 forced + 500 tracked
# scans, JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py --graph
# --mode gather` printed "graph_gather": {"ate_m": 0.007088010199368,
# "max_err_m": 0.05081481114029884, "keyframes": 63, "loop_closures": 29}
# and `... --mode onehot_full` printed "graph_onehot_full": {"ate_m":
# 0.006714003160595894, "max_err_m": 0.04634556174278259, "keyframes": 63,
# "loop_closures": 31}.
GRAPH_JAX_REF_ATE_M = 0.007088010199368
GRAPH_JAX_REF_MAX_M = 0.05081481114029884
GRAPH_JAX_REF_KEYFRAMES = 63
GRAPH_JAX_REF_CLOSURES = 29
GRAPH_ONEHOT_JAX_REF_ATE_M = 0.006714003160595894
GRAPH_ONEHOT_JAX_REF_MAX_M = 0.04634556174278259
GRAPH_ONEHOT_JAX_REF_KEYFRAMES = 63
GRAPH_ONEHOT_JAX_REF_CLOSURES = 31


def graph_gather_config(**overrides) -> Tuple[HectorConfig, ScanMatchConfig]:
    """bench.py's graph ``gather`` mode (``bench.py:577,653``): the fixed
    Hector pyramid (K3 + K4) and the default frontend (K3 + K4 at one
    128-px level)."""
    return fixed_config(**overrides), ScanMatchConfig()


def graph_pallas_full_config(**overrides
                             ) -> Tuple[HectorConfig, ScanMatchConfig]:
    """bench.py's graph ``pallas_full`` mode (``bench.py:680-686``): K1 and
    the dense fill at a 0.5 px margin on the Hector pyramid, K1 and K2 on
    the frontend's grid."""
    return (pallas_dense_config(dense_free_margin_px=0.5).overlay(overrides),
            ScanMatchConfig(matcher_mode="pallas", dense_fill=True))


def make_graph_log(seed: int = GRAPH_SEED) -> ScanLog:
    """The bench's graph log (``bench.py:580-607``): GRAPH_BOOTSTRAP still
    poses at (20, 20, 0), then the turning revisit of two laps, N_SCANS
    poses in all, NUM_BEAMS-beam revolutions simulated on the CPU from
    ``seed``."""
    sim = SimConfig()
    take = N_SCANS - GRAPH_BOOTSTRAP
    drive = rect_revisit_trajectory(num_loops=2)
    if drive.shape[0] < take:
        raise ValueError(f"the revisit has {drive.shape[0]} poses, need {take}")
    still = np.tile(np.asarray(sim.start_pose, np.float32),
                    (GRAPH_BOOTSTRAP, 1))
    traj = np.concatenate([still, drive[:take]])
    angles = revolution_angles(NUM_BEAMS)
    fld = default_field(sim.field_scale, sim.field_offset, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    radii, valid = scan_revolution(fld, torch.from_numpy(traj),
                                   torch.from_numpy(angles),
                                   sim.max_scan_dist, sim.measure_error, gen)
    return ScanLog(traj, angles, radii.numpy(), valid.numpy(), GRAPH_BOOTSTRAP)


class GraphOut(NamedTuple):
    poses: torch.Tensor           # f32[T, 3] live match pose after each scan
    keyframe_added: torch.Tensor  # bool[T]


def graph_replay(dlog: DeviceLog, hcfg: HectorConfig, mcfg: ScanMatchConfig,
                 gcfg: PoseGraphConfig = PoseGraphConfig(),
                 bootstrap: int = GRAPH_BOOTSTRAP, plain: bool = False
                 ) -> Tuple[graph_slam.GraphSlamState, GraphOut]:
    """``graph_slam.update`` over every scan of ``dlog`` from a fresh state
    at its first true pose, the first ``bootstrap`` scans forced (mapped at
    the hint) in ``hcfg`` itself (``bench.py:613-628``).  Returns the final
    state and the per-scan outputs on the device; the host reads one flag a
    scan (``graph_slam.update``)."""
    dev = dlog.points.device
    state = graph_slam.init(hcfg, gcfg, dlog.traj[0], dlog.points.shape[1],
                            dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    poses, kf = [], []
    for t in range(dlog.points.shape[0]):
        state, info = graph_slam.update(
            state, Scan(dlog.points[t], dlog.valid[t], zero), hcfg, gcfg,
            mcfg, t < bootstrap, plain)
        poses.append(state.hector.match_pose)
        kf.append(info.keyframe_added)
    return state, GraphOut(torch.stack(poses), torch.stack(kf))


def graph_ate_of(state: graph_slam.GraphSlamState, poses: np.ndarray,
                 truth: np.ndarray, bootstrap: int = GRAPH_BOOTSTRAP) -> dict:
    """The bench's graph numbers (``bench.py:639-647``): RMS and max error
    of the poses after the bootstrap, keyframes and accepted closures."""
    ate, mx = ate_of(np.asarray(poses)[bootstrap:],
                     np.asarray(truth)[bootstrap:])
    return {"ate_m": ate, "max_err_m": mx,
            "keyframes": int(state.graph.num_nodes),
            "loop_closures": int(state.loop_count)}


def graph_reference(onehot: bool = False) -> dict:
    """``GRAPH_JAX_REF_*`` (or ``GRAPH_ONEHOT_JAX_REF_*``) as
    ``graph_ate_of``'s dict."""
    if onehot:
        return {"ate_m": GRAPH_ONEHOT_JAX_REF_ATE_M,
                "max_err_m": GRAPH_ONEHOT_JAX_REF_MAX_M,
                "keyframes": GRAPH_ONEHOT_JAX_REF_KEYFRAMES,
                "loop_closures": GRAPH_ONEHOT_JAX_REF_CLOSURES}
    return {"ate_m": GRAPH_JAX_REF_ATE_M, "max_err_m": GRAPH_JAX_REF_MAX_M,
            "keyframes": GRAPH_JAX_REF_KEYFRAMES,
            "loop_closures": GRAPH_JAX_REF_CLOSURES}


def graph_gate(got: dict, ref: dict) -> list:
    """The bench's graph gate (``bench.py:689-701``) of ``got`` against
    ``ref`` (both as ``graph_ate_of`` gives them): the same keyframes, at
    most 2 closures fewer, ATE within 15%, and the max error within 0.01 m.
    Returns the failed conditions (empty when it holds)."""
    fails = []
    if got["keyframes"] != ref["keyframes"]:
        fails.append(f"keyframes {got['keyframes']} != {ref['keyframes']}")
    if got["loop_closures"] < ref["loop_closures"] - 2:
        fails.append(f"closures {got['loop_closures']} < "
                     f"{ref['loop_closures']} - 2")
    if not got["ate_m"] <= 1.15 * ref["ate_m"]:
        fails.append(f"ATE {got['ate_m']} > 1.15 x {ref['ate_m']}")
    if not got["max_err_m"] <= ref["max_err_m"] + 0.01:
        fails.append(f"max error {got['max_err_m']} > {ref['max_err_m']} "
                     "+ 0.01")
    return fails


OFFICE_SEED = 3
OFFICE_ODOM_SEED = 7
OFFICE_BOOTSTRAP = 10
OFFICE_MAX_RANGE = 10.0
OFFICE_RANGE_ERROR_STD = 0.03
# JAX package office loop (bench.py:318-431's flow) on make_office_log(3),
# JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py --office`
# printed "office": {"scans": 689, "keyframes": 163, "loop_closures": 90,
# "hector_only_ate_m": 0.7140489655678758, "graph_online_ate_m":
# 0.3533984469755533, "kf_hector_ate_m": 0.7134320150461234,
# "kf_optimized_ate_m": 0.328027918503473, "closure_margin":
# 2.1749124839767866, "seconds": 180.4}.
OFFICE_JAX_REF_KEYFRAMES = 163
OFFICE_JAX_REF_CLOSURES = 90
OFFICE_JAX_REF_HECTOR_ONLY_ATE_M = 0.7140489655678758
OFFICE_JAX_REF_GRAPH_ONLINE_ATE_M = 0.3533984469755533
OFFICE_JAX_REF_KF_HECTOR_ATE_M = 0.7134320150461234
OFFICE_JAX_REF_KF_OPTIMIZED_ATE_M = 0.328027918503473
OFFICE_JAX_REF_CLOSURE_MARGIN = 2.1749124839767866


def make_office_log(seed: int = OFFICE_SEED) -> ScanLog:
    """The bench's office log (``bench.py:318-352``): OFFICE_BOOTSTRAP still
    poses at the tour's start, then ``office_tour_trajectory(2, 0.25)``
    (679 poses), NUM_BEAMS-beam revolutions to 10 m with the 0.02 m grid
    noise and 0.03 m Gaussian range error, simulated on the CPU from
    ``seed``."""
    drive = office_tour_trajectory(num_loops=2, step=0.25)
    traj = np.concatenate([np.tile(drive[0], (OFFICE_BOOTSTRAP, 1)),
                           drive]).astype(np.float32)
    angles = revolution_angles(NUM_BEAMS)
    gen = torch.Generator().manual_seed(seed)
    radii, valid = scan_revolution(
        office_field(device="cpu"), torch.from_numpy(traj),
        torch.from_numpy(angles),
        OFFICE_MAX_RANGE, SimConfig().measure_error, gen,
        range_error_std=OFFICE_RANGE_ERROR_STD)
    return ScanLog(traj, angles, radii.numpy(), valid.numpy(),
                   OFFICE_BOOTSTRAP)


def office_odometry(traj: np.ndarray, seed: int = OFFICE_ODOM_SEED
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(odo, deltas) f32[T, 3] (``bench.py:353-357``): the drifting wheel
    odometry along ``traj`` (scale 1.02, heading bias 2e-4 a scan, step
    noise 3 mm, heading noise 1e-3) and its per-scan deltas, the heading
    wrapped to [-pi, pi)."""
    odo = drifting_odometry(traj, scale_bias=1.02, heading_bias=0.0002,
                            step_noise=0.003, heading_noise=0.001, seed=seed)
    deltas = np.zeros_like(odo)
    deltas[1:] = odo[1:] - odo[:-1]
    deltas[:, 2] = (deltas[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return odo, deltas


def office_config(**overrides) -> Tuple[HectorConfig, PoseGraphConfig,
                                        ScanMatchConfig]:
    """The office's configuration (``bench.py:359-366``): a 3-level 200-px
    pyramid at 0.1 m, 7/4/4 iterations, the xy clamp 10 px, max jump 1 m,
    GN damping 0.1 and the in-map guard at 0.7 (K3 + K4); keyframes every
    1 m, closures within 4 m; K1's table and K2 at the frontend."""
    hcfg = HectorConfig(num_levels=3, map_size=200,
                        estimate_iterations=(7, 4, 4), xy_step_clamp_px=10.0,
                        max_match_jump=1.0, gn_damping=0.1,
                        min_match_in_map_frac=0.7).overlay(overrides)
    return (hcfg, PoseGraphConfig(keyframe_dist=1.0, loop_closure_radius=4.0),
            ScanMatchConfig(matcher_mode="onehot_bf16", dense_fill=True))


class OfficeOut(NamedTuple):
    poses: torch.Tensor           # f32[T, 3] match pose after each scan
    keyframe_added: torch.Tensor  # bool[T] (all False for Hector alone)


def office_replay(dlog: DeviceLog, odo: torch.Tensor, deltas: torch.Tensor,
                  hcfg: HectorConfig, gcfg: PoseGraphConfig | None = None,
                  mcfg: ScanMatchConfig | None = None,
                  bootstrap: int = OFFICE_BOOTSTRAP, plain: bool = False):
    """The bench's office replays (``bench.py:369-396``) over ``dlog`` with
    the odometry ``odo`` and its ``deltas`` (f32[T, 3] on the log's device):
    Hector alone when ``gcfg`` is None, else graph-SLAM.  Each scan's hint
    is the match pose plus the scan's delta; the first ``bootstrap`` scans
    are forced, and a forced scan's match pose is then set to the odometry.
    Returns the final state (``HectorState`` or ``GraphSlamState``) and the
    per-scan outputs on the device; ``graph_replay`` is unchanged."""
    dev = dlog.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    n = dlog.points.shape[0]
    if gcfg is None:
        st = hector.init(hcfg, dlog.traj[0], dev)
    else:
        st = graph_slam.init(hcfg, gcfg, dlog.traj[0], dlog.points.shape[1],
                             dev)
    poses, kf = [], []
    for t in range(n):
        scan = Scan(dlog.points[t], dlog.valid[t], zero)
        forced = t < bootstrap
        if gcfg is None:
            st, _ = hector.update(st, scan, st.match_pose + deltas[t], hcfg,
                                  forced, plain)
            if forced:
                st = st._replace(match_pose=odo[t])
            poses.append(st.match_pose)
            continue
        st = st._replace(hector=st.hector._replace(
            match_pose=st.hector.match_pose + deltas[t]))
        st, info = graph_slam.update(st, scan, hcfg, gcfg, mcfg, forced,
                                     plain)
        if forced:
            st = st._replace(hector=st.hector._replace(match_pose=odo[t]))
        poses.append(st.hector.match_pose)
        kf.append(info.keyframe_added)
    keyframes = (torch.stack(kf) if kf else
                 torch.zeros(n, dtype=torch.bool, device=dev))
    return st, OfficeOut(torch.stack(poses), keyframes)


def office_metrics(traj: np.ndarray, hector_poses: np.ndarray,
                   graph: graph_slam.GraphSlamState, graph_poses: np.ndarray,
                   keyframe_added: np.ndarray) -> dict:
    """The bench's office numbers (``bench.py:408-431``, unrounded, without
    the rate): keyframes and accepted closures; the RMS position error over
    every scan of Hector alone and of the graph's live pose; over the
    keyframes' scans, Hector's error and the optimised keyframe poses'; and
    the closure margin, Hector's keyframe ATE over the optimised one."""
    traj = np.asarray(traj, np.float64)
    he = np.linalg.norm(np.asarray(hector_poses)[:, :2] - traj[:, :2], axis=1)
    ge = np.linalg.norm(np.asarray(graph_poses)[:, :2] - traj[:, :2], axis=1)
    n = graph.nodes
    kf_scans = np.concatenate([[0], np.where(np.asarray(keyframe_added))[0]])
    kf_scans = kf_scans[:n]
    opt = graph.graph.poses[:n].cpu().numpy()
    ate_opt = float(np.sqrt((np.linalg.norm(
        opt[:, :2] - traj[kf_scans][:, :2], axis=1) ** 2).mean()))
    ate_hec = float(np.sqrt((he[kf_scans] ** 2).mean()))
    return {"scans": int(traj.shape[0]), "keyframes": int(n),
            "loop_closures": int(graph.loop_count),
            "hector_only_ate_m": float(np.sqrt((he ** 2).mean())),
            "graph_online_ate_m": float(np.sqrt((ge ** 2).mean())),
            "kf_hector_ate_m": ate_hec, "kf_optimized_ate_m": ate_opt,
            "closure_margin": ate_hec / max(ate_opt, 1e-9)}


def office_reference() -> dict:
    """``OFFICE_JAX_REF_*`` as ``office_metrics``' dict."""
    return {"keyframes": OFFICE_JAX_REF_KEYFRAMES,
            "loop_closures": OFFICE_JAX_REF_CLOSURES,
            "hector_only_ate_m": OFFICE_JAX_REF_HECTOR_ONLY_ATE_M,
            "graph_online_ate_m": OFFICE_JAX_REF_GRAPH_ONLINE_ATE_M,
            "kf_hector_ate_m": OFFICE_JAX_REF_KF_HECTOR_ATE_M,
            "kf_optimized_ate_m": OFFICE_JAX_REF_KF_OPTIMIZED_ATE_M,
            "closure_margin": OFFICE_JAX_REF_CLOSURE_MARGIN}


def office_gate(got: dict, ref: dict) -> list:
    """The bench's graph gate on the office (both dicts as
    ``office_metrics`` gives them): the same keyframes, at most 2 closures
    fewer, the optimised keyframe ATE and Hector's ATE within 15%, the
    closure margin at least 85% of the reference's.  Returns the failed
    conditions (empty when it holds)."""
    fails = []
    if got["keyframes"] != ref["keyframes"]:
        fails.append(f"keyframes {got['keyframes']} != {ref['keyframes']}")
    if got["loop_closures"] < ref["loop_closures"] - 2:
        fails.append(f"closures {got['loop_closures']} < "
                     f"{ref['loop_closures']} - 2")
    for k in ("kf_optimized_ate_m", "hector_only_ate_m"):
        if not got[k] <= 1.15 * ref[k]:
            fails.append(f"{k} {got[k]} > 1.15 x {ref[k]}")
    if not got["closure_margin"] >= 0.85 * ref["closure_margin"]:
        fails.append(f"closure margin {got['closure_margin']} < 0.85 x "
                     f"{ref['closure_margin']}")
    return fails


# CoreSLAM's ATE over a replay depends on its run's roundings: in both
# modes a single hole-map cell that an ulp moves early in a replay changes
# the track for good, and the ATE lands in one of a few basins (production:
# ~0.052-0.060 m, and 0.137 m on the CPU from the true start; parity:
# ~0.135, ~0.29, ~0.36 or ~0.44 m, by seed; PERF.md section 6, PR 7).  So
# a replay is gated by the median over starts moved by a few f32 ulps
# (production) or over generator seeds (parity), not by one run.
CORESLAM_NUDGES = (0, 1, -1, 2, -2, 3, -3)
CORESLAM_SEEDS = tuple(range(1, 10))
# JAX package CoreSLAM (bench.py:825-875's flow) on make_log(0), all 522
# scans, JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py
# --coreslam --mode production [--nudge k]` printed "ate_m"
# 0.05689924955368042 from the true start (32.0 s) and, for k = 1, -1, 2,
# -2, 3, -3, 0.05785324424505234, 0.05399879068136215, 0.051571134477853775,
# 0.05465003475546837, 0.05420586094260216, 0.06039797142148018; `...
# --mode parity --seed k` for k = 1..9 printed the ATEs below (5-7 s each),
# 517 scans searched in every run.
CORESLAM_JAX_REF_ATE_M = 0.05689924955368042
CORESLAM_JAX_REF_ATES_M = (0.05689924955368042, 0.05785324424505234,
                           0.05399879068136215, 0.051571134477853775,
                           0.05465003475546837, 0.05420586094260216,
                           0.06039797142148018)
CORESLAM_PARITY_JAX_REF_ATES_M = (
    0.2857106924057007, 0.2884749174118042, 0.28854435682296753,
    0.13695046305656433, 0.13520154356956482, 0.2909611463546753,
    0.2872900068759918, 0.43696630001068115, 0.28796830773353577)


def coreslam_parity_config(**overrides) -> CoreSlamConfig:
    """bench.py's CoreSLAM parity mode (``bench.py:869``): Monte-Carlo
    search over 4096 candidates, line hole and obstacle updates."""
    return CoreSlamConfig(num_candidates=4096).overlay(overrides)


def coreslam_production_config(**overrides) -> CoreSlamConfig:
    """bench.py's CoreSLAM production mode (``bench.py:866-867``): the
    correlative search (32 headings x 8 x 8 pixel shifts), dense hole and
    obstacle fills."""
    return CoreSlamConfig(search_mode="correlative", dense_hole_fill=True,
                          dense_obstacle_fill=True).overlay(overrides)


class CoreSlamOut(NamedTuple):
    poses: torch.Tensor      # f32[T, 3] pose after each scan
    searched: torch.Tensor   # bool[T]
    best_sum: torch.Tensor   # i32[T]


def nudged_start(pose: torch.Tensor, ulps: int) -> torch.Tensor:
    """``pose`` (f32[3]) with its x moved by ``ulps`` float32 ulps, on its
    device (no host read)."""
    toward = torch.full((), math.inf if ulps > 0 else -math.inf,
                        dtype=torch.float32, device=pose.device)
    x = pose[0]
    for _ in range(abs(ulps)):
        x = torch.nextafter(x, toward)
    return torch.cat([x[None], pose[1:]])


def coreslam_replay(dlog: DeviceLog, cfg: CoreSlamConfig, seed: int = 1,
                    nudge: int = 0
                    ) -> Tuple[coreslam.CoreSlamState, CoreSlamOut]:
    """``coreslam.update_cloud`` over every scan of ``dlog`` from a fresh
    state at its first true pose (its x moved by ``nudge`` f32 ulps), the
    state's own pose as the odometry (``bench.py:839-846``), the
    Monte-Carlo draws from a generator seeded with ``seed``.  No host read;
    the outputs stay on the device."""
    dev = dlog.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    st = coreslam.init(cfg, nudged_start(dlog.traj[0], nudge), seed=seed,
                       device=dev)
    poses, searched, sums = [], [], []
    for t in range(dlog.points.shape[0]):
        st, info = coreslam.update_cloud(
            st, Scan(dlog.points[t], dlog.valid[t], zero), st.pose, cfg)
        poses.append(st.pose)
        searched.append(info.searched)
        sums.append(info.best_sum)
    return st, CoreSlamOut(torch.stack(poses), torch.stack(searched),
                           torch.stack(sums))


def coreslam_gate(production_ates, parity_ates, parity_searched,
                  production_searched, n_scans: int, warmup: int) -> list:
    """CoreSLAM's gate: the median production ATE over CORESLAM_NUDGES
    starts at most CORESLAM_JAX_REF_ATE_M + 2e-3; the median parity ATE
    over CORESLAM_SEEDS at most the largest of JAX's over its nine keys;
    every replay searched on all scans but the warm-up's.  Returns the
    failed conditions."""
    fails = []
    med = float(np.median(production_ates))
    if not med <= CORESLAM_JAX_REF_ATE_M + 2e-3:
        fails.append(f"production median ATE {med} > "
                     f"{CORESLAM_JAX_REF_ATE_M} + 2e-3")
    med = float(np.median(parity_ates))
    if not med <= max(CORESLAM_PARITY_JAX_REF_ATES_M):
        fails.append(f"parity median ATE {med} > "
                     f"{max(CORESLAM_PARITY_JAX_REF_ATES_M)}")
    for name, counts in (("production", production_searched),
                         ("parity", parity_searched)):
        if any(c != n_scans - warmup for c in counts):
            fails.append(f"{name}: scans searched {counts}, want "
                         f"{n_scans - warmup} each")
    return fails


# The particle layer's flow (bench.py:714-822): every scan of make_log(0),
# the state's own pose as the odometry, from the first true pose.  Its ATE
# is a draw: JAX's and the port's generators give other numbers, and a
# replay lands in one of a few basins by its draws, so the gate takes the
# median over nine seeds, as coreslam_gate does.
PARTICLE_SEEDS = tuple(range(1, 10))
_PARTICLE_BASE = ParticleConfig()                 # 8192 particles, top 64
# bench.py's particle modes (bench.py:772-788)
PARTICLE_MODES = {
    "exact": (CoreSlamConfig(), _PARTICLE_BASE),
    "sub4": (CoreSlamConfig(), _PARTICLE_BASE.overlay(
        {"score_subsample": 4, "refine_subsample": 4})),
    "grid": (CoreSlamConfig(), _PARTICLE_BASE.overlay(
        {"scorer": "grid", "refine_subsample": 4})),
    "grid_small": (CoreSlamConfig(), _PARTICLE_BASE.overlay(
        {"scorer": "grid", "top_k": 16, "refine_candidates": 32,
         "refine_subsample": 4})),
    "grid_dense": (CoreSlamConfig(dense_hole_fill=True,
                                  dense_obstacle_fill=True),
                   _PARTICLE_BASE.overlay(
                       {"scorer": "grid", "top_k": 16,
                        "refine_candidates": 32, "refine_subsample": 4})),
}
# JAX package particle layer (bench.py:738-767's flow, jitted as the bench
# runs it) on make_log(0), all 522 scans, JAX 0.9.0 on the CPU: `python
# scripts/torch_port_ref_ate.py --particle --mode exact --seed k` for k =
# 1..9 printed the "ate_m" below (7-16 s each; 521 resamples in every run;
# the max errors in PERF.md section 6, PR 8), and `... --mode grid_dense
# --seed k` the second tuple (23-38 s each, 521 resamples).
PARTICLE_JAX_REF_ATES_M = (
    0.5065030455589294, 0.2872616648674011, 0.2854345738887787,
    0.6753385663032532, 0.3738340437412262, 0.43961870670318604,
    0.43617960810661316, 0.436214417219162, 0.4381381571292877)
PARTICLE_GRID_DENSE_JAX_REF_ATES_M = (
    0.114629827439785, 0.12366237491369247, 0.12436912208795547,
    0.12473449110984802, 0.12354665249586105, 0.15312232077121735,
    0.13161049783229828, 0.12059541791677475, 0.19838257133960724)


class ParticleOut(NamedTuple):
    poses: torch.Tensor        # f32[T, 3] estimate after each scan
    resampled: torch.Tensor    # bool[T]
    best_sum: torch.Tensor     # i32[T]
    ess: torch.Tensor          # f32[T]


def particle_replay(dlog: DeviceLog, ccfg: CoreSlamConfig,
                    pcfg: ParticleConfig, seed: int = 1
                    ) -> Tuple[particle.ParticleState, ParticleOut]:
    """``particle.update`` over every scan of ``dlog`` from a fresh state at
    its first true pose, the state's own pose as the odometry
    (``bench.py:738-749``), the draws from a generator seeded with
    ``seed``.  No host read; the outputs stay on the device."""
    dev = dlog.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    st = particle.init(ccfg, pcfg, dlog.traj[0], seed=seed, device=dev)
    out = []
    for t in range(dlog.points.shape[0]):
        st, info = particle.update(
            st, Scan(dlog.points[t], dlog.valid[t], zero), st.pose, ccfg, pcfg)
        out.append((st.pose, info.resampled, info.best_sum, info.ess))
    return st, ParticleOut(*(torch.stack(x) for x in zip(*out)))


def particle_metrics(out: ParticleOut, truth: np.ndarray) -> dict:
    """The bench's particle numbers of one replay (``bench.py:760-763``,
    unrounded, without the rate): RMS and max position error over every
    scan, and the scans that resampled."""
    ate, mx = ate_of(out.poses.cpu().numpy(), truth)
    return {"ate_m": ate, "max_err_m": mx,
            "resamples": int(out.resampled.sum())}


def particle_gate(exact_ates, grid_dense_ates) -> list:
    """The particle layer's gate over PARTICLE_SEEDS: each mode's median ATE
    at most the largest of JAX's nine (``PARTICLE_JAX_REF_ATES_M``,
    ``PARTICLE_GRID_DENSE_JAX_REF_ATES_M``), and the bench's own rule
    (``bench.py:810``): grid_dense's median at most exact's + 0.02 m.
    Returns the failed conditions."""
    fails = []
    med_e = float(np.median(exact_ates))
    med_g = float(np.median(grid_dense_ates))
    for name, med, ref in (("exact", med_e, PARTICLE_JAX_REF_ATES_M),
                           ("grid_dense", med_g,
                            PARTICLE_GRID_DENSE_JAX_REF_ATES_M)):
        if not med <= max(ref):
            fails.append(f"{name} median ATE {med} > {max(ref)}")
    if not med_g <= med_e + 0.02:
        fails.append(f"grid_dense median ATE {med_g} > exact's {med_e} + "
                     "0.02")
    return fails


DATA_DIR = Path(__file__).resolve().parents[1] / "examples" / "data"
SIM_LOOP_LOG = DATA_DIR / "sim_loop.clf"
ADVERSARIAL_LOG = DATA_DIR / "adversarial_180.clf"
# JAX's Hector track over sim_loop.clf, one pose a scan (``--dataset
# sim_loop --out``)
DATASET_REF_TRACKS = Path(__file__).resolve().parent / "dataset_ref_tracks.json"
DATASET_MAP_SIZE_M = 40.0
DATASET_FORCED = 10
SIM_LOOP_SPEED = 0.25        # sim_loop.clf's generator's loop speed
# JAX package (JAX 0.9.0 on the CPU) over the checked-in logs in this flow:
# `python scripts/torch_port_ref_ate.py --dataset sim_loop` printed
# "dataset_sim_loop": {"scans": 120, "beams": 180, "robust": false,
# "hector_ate_m": 0.019746121019124985, "hector_max_err_m":
# 0.03905916213989258, "odometry_ate_m": 0.08883528411388397,
# "odometry_max_err_m": 0.14367449283599854, "coreslam_ate_m":
# 0.22466006875038147 from each of the 7 CORESLAM_NUDGES starts,
# "coreslam_max_err_m": 0.3985465466976166 from each} (29.3 s), and `...
# --dataset adversarial` printed "dataset_adversarial": {"scans": 360,
# "beams": 181, "robust": true, "hector_ate_m": 0.03407921642065048,
# "hector_max_err_m": 0.23363980650901794, "odometry_ate_m":
# 0.5055422782897949, "odometry_max_err_m": 1.0422847270965576,
# "coreslam_ate_m": 0.43099716305732727 from each start,
# "coreslam_max_err_m": 0.6831338405609131 from each} (73.9 s).
SIM_LOOP_JAX_REF_HECTOR_ATE_M = 0.019746121019124985
SIM_LOOP_JAX_REF_HECTOR_MAX_M = 0.03905916213989258
SIM_LOOP_JAX_REF_ODOMETRY_ATE_M = 0.08883528411388397
SIM_LOOP_JAX_REF_CORESLAM_ATES_M = (0.22466006875038147,) * 7
ADVERSARIAL_JAX_REF_HECTOR_ATE_M = 0.03407921642065048
ADVERSARIAL_JAX_REF_HECTOR_MAX_M = 0.23363980650901794
ADVERSARIAL_JAX_REF_ODOMETRY_ATE_M = 0.5055422782897949
ADVERSARIAL_JAX_REF_CORESLAM_ATES_M = (0.43099716305732727,) * 7
DATASET_JAX_REFS = {
    "sim_loop": {"hector_ate_m": SIM_LOOP_JAX_REF_HECTOR_ATE_M,
                 "hector_max_err_m": SIM_LOOP_JAX_REF_HECTOR_MAX_M,
                 "odometry_ate_m": SIM_LOOP_JAX_REF_ODOMETRY_ATE_M,
                 "coreslam_ate_m": SIM_LOOP_JAX_REF_CORESLAM_ATES_M},
    "adversarial": {"hector_ate_m": ADVERSARIAL_JAX_REF_HECTOR_ATE_M,
                    "hector_max_err_m": ADVERSARIAL_JAX_REF_HECTOR_MAX_M,
                    "odometry_ate_m": ADVERSARIAL_JAX_REF_ODOMETRY_ATE_M,
                    "coreslam_ate_m": ADVERSARIAL_JAX_REF_CORESLAM_ATES_M}}
# JAX's compat.HectorSLAMProcessor(0.1, 400, (20, 20, 0), 4, 4,
# estimate_iterations=(7, 4, 4, 4)) over make_log(0), 10 forced + 512
# tracked scans, JAX 0.9.0 on the CPU: `python scripts/torch_port_ref_ate.py
# --compat` printed "compat": {"ate_m": 0.0020391789730638266, "max_err_m":
# 0.008902426809072495, "map_updates": 34} (9.3 s).
COMPAT_JAX_REF_ATE_M = 0.0020391789730638266
COMPAT_JAX_REF_MAX_M = 0.008902426809072495


class CarmenData(NamedTuple):
    """A CARMEN log ready to replay: recentred odometry and truth on the
    host, the clouds and the odometry on a device."""
    log: LidarLog              # as read
    offset: np.ndarray         # f32[2] subtracted from every x, y
    odo: np.ndarray            # f32[T, 3] recentred odometry
    deltas: np.ndarray         # f32[T, 3] odometry steps, heading wrapped
    truth: Optional[np.ndarray]  # f32[T, 3] recentred, or None
    points: torch.Tensor       # f32[T, N, 2] laser-frame clouds
    valid: torch.Tensor        # bool[T, N]
    odo_t: torch.Tensor        # f32[T, 3] ``odo`` on the device
    deltas_t: torch.Tensor     # f32[T, 3] ``deltas`` on the device


def sim_loop_truth(n: int) -> np.ndarray:
    """sim_loop.clf's truth: the path its generator drove
    (``loop_trajectory(speed=0.25)[:n]``,
    ``slamnet_tpu/io/datasets.py:164-176``)."""
    return loop_trajectory(speed=SIM_LOOP_SPEED)[:n].copy()


def load_carmen(path, device: torch.device | str = "cuda",
                max_scans: int | None = None,
                truth: np.ndarray | None = None,
                map_size_m: float = DATASET_MAP_SIZE_M) -> CarmenData:
    """Read a CARMEN log with the native parser and recentre it as
    ``examples/replay_dataset.py:82-110`` does: the first odometry pose
    moves to the centre of a ``map_size_m`` map, and the truth (the log's
    ``# TRUTH`` lines, else ``truth``) moves with it.  The odometry steps
    are computed on the host in f32 as the example computes them (heading by
    ``math.remainder``)."""
    from . import hostio

    log = hostio.read_carmen_native(str(path), max_scans=max_scans)
    if log is None:                  # no FLASER line: ROBOTLASER1's reader
        log = read_carmen(str(path), max_scans=max_scans)
    t_n = log.ranges.shape[0]
    offset = log.odometry[0, :2] - map_size_m / 2.0
    odo = log.odometry.copy()
    odo[:, :2] -= offset[None, :]
    tr = log.truth if log.truth is not None else truth
    if tr is not None:
        tr = np.asarray(tr, np.float32)[:t_n].copy()
        tr[:, :2] -= offset[None, :]
    deltas = np.zeros_like(odo)
    for t in range(1, t_n):
        d = odo[t] - odo[t - 1]
        d[2] = math.remainder(d[2], 2.0 * math.pi)
        deltas[t] = d
    return CarmenData(
        log, offset, odo, deltas, tr,
        torch.as_tensor(log_points(log), device=device),
        torch.as_tensor(log.valid, device=device),
        torch.as_tensor(odo, device=device),
        torch.as_tensor(deltas, device=device))


def dataset_config(robust: bool = False,
                   map_size_m: float = DATASET_MAP_SIZE_M
                   ) -> Tuple[HectorConfig, CoreSlamConfig]:
    """``examples/replay_dataset.py:88-101``'s configurations: Hector at 3
    levels, 7/4/4, ``map_size_m`` (40 m) over 400 px (gather + line
    updates), with ``robust`` the xy clamp 10 px, max jump 1 m and damping
    0.1; CoreSLAM correlative with the dense hole and obstacle fills over
    ``map_size_m``."""
    hcfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        map_resolution=map_size_m / 400.0)
    if robust:
        hcfg = hcfg.overlay({"xy_step_clamp_px": 10.0, "max_match_jump": 1.0,
                             "gn_damping": 0.1})
    return hcfg, CoreSlamConfig(physical_map_size=map_size_m,
                                search_mode="correlative",
                                dense_hole_fill=True, dense_obstacle_fill=True)


class DatasetOut(NamedTuple):
    hector: Optional[torch.Tensor]     # f32[T, 3] match pose after each scan
    coreslam: Optional[torch.Tensor]   # f32[T, 3] pose after each scan


def carmen_replay(data: CarmenData, hcfg: HectorConfig | None,
                  ccfg: CoreSlamConfig | None, nudge: int = 0):
    """``examples/replay_dataset.py:112-140`` over every scan of ``data``:
    Hector (unless ``hcfg`` is None) from the first odometry pose, each scan
    hinted with the match pose plus the odometry step, the first
    DATASET_FORCED scans mapped without matching and their pose then set to
    the odometry;
    CoreSLAM (unless ``ccfg`` is None) from the first odometry pose with its
    x moved by ``nudge`` f32 ulps, each scan with its odometry pose.  No
    host read in the loop.  Returns (Hector state, CoreSLAM state,
    DatasetOut) on the log's device; a pipeline not run gives None."""
    dev = data.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    hst = (hector.init(hcfg, data.odo_t[0], dev) if hcfg is not None
           else None)
    cst = (coreslam.init(ccfg, nudged_start(data.odo_t[0], nudge), device=dev)
           if ccfg is not None else None)
    hposes, cposes = [], []
    for t in range(data.points.shape[0]):
        scan = Scan(data.points[t], data.valid[t], zero)
        if hst is not None:
            forced = t < DATASET_FORCED
            hst, _ = hector.update(hst, scan,
                                   hst.match_pose + data.deltas_t[t], hcfg,
                                   forced)
            if forced:
                hst = hst._replace(match_pose=data.odo_t[t])
            hposes.append(hst.match_pose)
        if cst is not None:
            cst, _ = coreslam.update_cloud(cst, scan, data.odo_t[t], ccfg)
            cposes.append(cst.pose)
    return hst, cst, DatasetOut(torch.stack(hposes) if hposes else None,
                                torch.stack(cposes) if cposes else None)


def dataset_metrics(data: CarmenData, out: DatasetOut) -> dict:
    """RMS and max position errors against ``data.truth`` of Hector's and
    CoreSLAM's tracks (those run) and of the odometry alone."""
    if data.truth is None:
        raise ValueError("the log carries no truth")
    res = {}
    for name, poses in (("hector", out.hector), ("coreslam", out.coreslam),
                        ("odometry", data.odo)):
        if poses is not None:
            p = poses.cpu().numpy() if isinstance(poses, torch.Tensor) \
                else poses
            res[f"{name}_ate_m"], res[f"{name}_max_err_m"] = ate_of(
                p, data.truth)
    return res


def dataset_reference_track(name: str) -> np.ndarray:
    """JAX's Hector track f32[T, 3] over the dataset ``name``
    (``DATASET_REF_TRACKS``)."""
    with open(DATASET_REF_TRACKS) as f:
        return np.asarray(json.load(f)[name]["hector_track"], np.float32)


def dataset_gate(name: str, got: dict, hector_poses: np.ndarray | None = None,
                 coreslam_ates=None) -> list:
    """The dataset gates (both logs: ``got`` as ``dataset_metrics`` gives
    it, ``coreslam_ates`` the CoreSLAM ATEs over CORESLAM_NUDGES starts):

    * sim_loop: Hector's track within 1e-3 m of JAX's at every scan;
    * adversarial: Hector's RMS ATE <= 1.15 x JAX's, its max error <= JAX's
      + 0.05 m, and JAX's own absolute bounds
      (``tests/test_datasets.py:163-168``): RMS < 0.15 m, max < 0.6 m, RMS
      < 0.5 x the odometry's;
    * both: CoreSLAM's median ATE over the starts <= JAX's (from the first
      odometry pose) + 2e-3 m, as ``coreslam_gate``.

    Returns the failed conditions."""
    ref = DATASET_JAX_REFS[name]
    fails = []
    if name == "sim_loop" and hector_poses is not None:
        want = dataset_reference_track(name)
        err = float(np.abs(np.asarray(hector_poses)[:, :2]
                           - want[:, :2]).max())
        if not err <= 1e-3:
            fails.append(f"Hector track {err} m from JAX's (> 1e-3)")
    if name == "adversarial" and "hector_ate_m" in got:
        h, hm, o = (got["hector_ate_m"], got["hector_max_err_m"],
                    got["odometry_ate_m"])
        for cond, msg in (
                (h <= 1.15 * ref["hector_ate_m"],
                 f"RMS ATE {h} > 1.15 x JAX's {ref['hector_ate_m']}"),
                (hm <= ref["hector_max_err_m"] + 0.05,
                 f"max error {hm} > JAX's {ref['hector_max_err_m']} + 0.05"),
                (h < 0.15, f"RMS ATE {h} >= 0.15"),
                (hm < 0.6, f"max error {hm} >= 0.6"),
                (h < 0.5 * o, f"RMS ATE {h} >= 0.5 x odometry's {o}")):
            if not cond:
                fails.append(f"Hector {msg}")
    if coreslam_ates is not None:
        med = float(np.median(coreslam_ates))
        if not med <= ref["coreslam_ate_m"][0] + 2e-3:
            fails.append(f"CoreSLAM median ATE {med} > JAX's "
                         f"{ref['coreslam_ate_m'][0]} + 2e-3")
    return fails


# The multi-device flows: every rank of a mesh calls them (the bench's loop
# log, JAX's dryrun_multichip meshes: tile x search over 8 devices).
SHARDED_N = 64                  # 10 forced + 54 matched scans
SHARDED_MESHES = {"2x4": {"tile": 2, "search": 4},
                  "4x2": {"tile": 4, "search": 2}}


def multichip_meshes(n_devices: int) -> dict:
    """``dryrun_multichip(n)``'s meshes by name (``__graft_entry__.py:
    87-116``): ``{"tile": 2, "search": n/2}``, and ``{"tile": 4, "search":
    n/4}`` when 4 divides n.  n must be even and at least 2."""
    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"dryrun_multichip needs an even device count >= 2, "
                         f"got {n_devices}")
    out = {f"2x{n_devices // 2}": {"tile": 2, "search": n_devices // 2}}
    if n_devices % 4 == 0:
        out[f"4x{n_devices // 4}"] = {"tile": 4, "search": n_devices // 4}
    return out


SHARDED_CORESLAM_N = 24
# JAX package hector_sharded (fixed: gather + line updates) on the first 64
# scans of make_log(seed=0), 10 forced + 54 matched, on 8 virtual CPU
# devices, JAX 0.9.0: `python scripts/torch_port_ref_ate.py --sharded`
# printed "hector_2x4": {"ate_m": 0.004128592554479837, "max_err_m":
# 0.008902426809072495, "map_updates": 12}, "hector_4x2": {"ate_m":
# 0.004128592554479837, "max_err_m": 0.008902426809072495, "map_updates":
# 12} and, for coreslam_sharded production on 2x4 over the first 24 scans
# from PRNGKey(1), "coreslam_production_2x4": {"ate_m": 0.04702622815966606,
# "max_err_m": 0.07058906555175781}.  (At a depth of 128 scans:
# 0.0034172534942626953 m on 2x4, 0.003417252330109477 on 4x2, 15 map
# updates.)  On 4 virtual CPU devices (dryrun_multichip(4)'s meshes),
# `python scripts/torch_port_ref_ate.py --sharded --devices 4` printed
# "hector_2x2": {"ate_m": 0.004128592554479837, "max_err_m":
# 0.008902426809072495, "map_updates": 12}, "hector_4x1": {"ate_m":
# 0.004128592554479837, "max_err_m": 0.008902426809072495, "map_updates":
# 12}, "coreslam_production_2x2": {"ate_m": 0.04702622815966606,
# "max_err_m": 0.07058906555175781}: the 8-device numbers to the last bit;
# so did `... --sharded --devices 2` ("hector_2x1", "coreslam_production_
# 2x1").
SHARDED_JAX_REF_ATE_M = {"2x4": 0.004128592554479837,
                         "4x2": 0.004128592554479837,
                         "2x2": 0.004128592554479837,
                         "4x1": 0.004128592554479837,
                         "2x1": 0.004128592554479837}
SHARDED_JAX_REF_MAP_UPDATES = {"2x4": 12, "4x2": 12, "2x2": 12, "4x1": 12,
                               "2x1": 12}
SHARDED_CORESLAM_JAX_REF_ATE_M = 0.04702622815966606
# the production CoreSLAM's ATE by the mesh it ran on
SHARDED_CORESLAM_JAX_REF_ATES_M = {"2x4": 0.04702622815966606,
                                   "2x2": 0.04702622815966606,
                                   "2x1": 0.04702622815966606}


def head(dlog: DeviceLog, n: int) -> DeviceLog:
    """The first ``n`` scans of ``dlog``."""
    return DeviceLog(dlog.points[:n], dlog.valid[:n], dlog.traj[:n])


class ShardedOut(NamedTuple):
    poses: torch.Tensor           # f32[T, 3] match pose after each scan
    map_updated: torch.Tensor     # bool[T]
    gn_iterations: torch.Tensor   # i32[T]


def sharded_replay(mesh, dlog: DeviceLog, cfg: HectorConfig,
                   bootstrap: int = BOOTSTRAP,
                   state: Optional[hector_sharded.ShardedHectorState] = None,
                   start: int = 0
                   ) -> Tuple[hector_sharded.ShardedHectorState, ShardedOut]:
    """``hector_sharded`` over scans ``start``.. of ``dlog`` on ``mesh``
    (every rank calls it with the whole log and keeps its beam chunk), from
    ``state`` (default a fresh one at the first true pose): scans below
    ``bootstrap`` forced with the match pose set to the truth first
    (``__graft_entry__.py:95-99``), the rest matched from the previous
    pose.  The outputs stay on the device; the ranks' host copies are
    gloo's own."""
    if state is None:
        state = hector_sharded.init(mesh, cfg, dlog.traj[0])
    step = hector_sharded.make_step(mesh, cfg, dlog.points.shape[1])
    poses, upd, iters = [], [], []
    for t in range(start, dlog.points.shape[0]):
        if t < bootstrap:
            state = state._replace(match_pose=dlog.traj[t].clone())
        state, info = step(state, dlog.points[t], dlog.valid[t],
                           t < bootstrap)
        poses.append(state.match_pose)
        upd.append(info.map_updated)
        iters.append(info.gn_iterations)
    return state, ShardedOut(torch.stack(poses), torch.stack(upd),
                             torch.stack(iters))


def sharded_coreslam_replay(mesh, dlog: DeviceLog, cfg: CoreSlamConfig,
                            seed: int = 1,
                            state: Optional[
                                coreslam_sharded.ShardedCoreSlamState] = None,
                            start: int = 0):
    """``coreslam_sharded`` over scans ``start``.. of ``dlog`` on ``mesh``,
    as ``coreslam_replay`` runs the dense pipeline (from a fresh state at the
    first true pose with the generator seeded ``seed``, unless ``state``;
    the state's own pose as the odometry).  Returns (state, CoreSlamOut)."""
    if state is None:
        state = coreslam_sharded.init(mesh, cfg, dlog.traj[0], seed=seed)
    step = coreslam_sharded.make_step(mesh, cfg)
    poses, searched, sums = [], [], []
    for t in range(start, dlog.points.shape[0]):
        state, info = step(state, dlog.points[t], dlog.valid[t], state.pose)
        poses.append(state.pose)
        searched.append(info.searched)
        sums.append(info.best_sum)
    return state, CoreSlamOut(torch.stack(poses), torch.stack(searched),
                              torch.stack(sums))


# dryrun_multichip's section 3 (__graft_entry__.py:152-199): distributed
# graph-SLAM on the 2x4 mesh.
SHARDED_GRAPH_SEED = 3
SHARDED_GRAPH_STILL = 6          # still scans at the start pose
SHARDED_GRAPH_FORCED = 5         # scans mapped unmatched
SHARDED_GRAPH_MESH = "2x4"
SHARDED_GRAPH_SEP_CAPACITY = 8
# JAX package graph_slam_sharded on make_sharded_graph_log(3) (6 still + 65
# drive scans, the first 5 forced) on the 2x4 mesh of 8 virtual CPU
# devices, JAX 0.9.0: `python scripts/torch_port_ref_ate.py --sharded-graph`
# printed "sharded_graph_onehot_bf16": {"keyframes": 22, "loop_closures": 8,
# "final_err_m": 0.0028054032009094954, "ate_m": 0.01934298314154148,
# "max_err_m": 0.10565228760242462, "max_overflow": 0} and `... --mode
# gather` (the default frontend) "sharded_graph_gather": {"keyframes": 22,
# "loop_closures": 8, "final_err_m": 0.0028054032009094954, "ate_m":
# 0.019257059320807457, "max_err_m": 0.1056840792298317, "max_overflow": 0}.
# On the 2x2 mesh of 4 virtual CPU devices (32 keyframe slots), `...
# --sharded-graph --devices 4 [--mode gather]` printed the same numbers to
# the last bit (onehot_bf16: 22 keyframes, 8 closures, final error
# 0.0028054032009094954, ATE 0.01934298314154148, max 0.10565228760242462,
# overflow 0; gather: 22, 8, 0.0028054032009094954, 0.019257059320807457,
# 0.1056840792298317, 0), keyframes at the same scans (7, 9, 11, ..., 69)
# and closures at 29, 33, 36, 38, 40, 65, 67 and 69.
SHARDED_GRAPH_JAX_REF_MESHES = ("2x4", "2x2")
# On the 2x1 mesh of 2 devices (16 keyframe slots for the 22 keyframes of
# a larger mesh) every slot fills: `... --sharded-graph --devices 2 [--mode
# gather]` printed 16 keyframes, 5 closures, final error 2.090765953063965
# / 2.090764284133911 m (dryrun_multichip(2) fails its own < 0.5 m check
# there), ATE 0.505652904510498 / 0.5056396722793579, max = the final
# error, no overflow.
SHARDED_GRAPH_JAX_REF_2X1 = {
    mode: {"ate_m": ate, "max_err_m": fin, "final_err_m": fin,
           "keyframes": 16, "loop_closures": 5, "max_overflow": 0}
    for mode, ate, fin in (
        ("onehot_bf16", 0.505652904510498, 2.090765953063965),
        ("gather", 0.5056396722793579, 2.090764284133911))}
SHARDED_GRAPH_JAX_REF_KEYFRAMES = {"onehot_bf16": 22, "gather": 22}
SHARDED_GRAPH_JAX_REF_CLOSURES = {"onehot_bf16": 8, "gather": 8}
SHARDED_GRAPH_JAX_REF_FINAL_ERR_M = {"onehot_bf16": 0.0028054032009094954,
                                     "gather": 0.0028054032009094954}
SHARDED_GRAPH_JAX_REF_ATE_M = {"onehot_bf16": 0.01934298314154148,
                               "gather": 0.019257059320807457}
SHARDED_GRAPH_JAX_REF_MAX_M = {"onehot_bf16": 0.10565228760242462,
                               "gather": 0.1056840792298317}
SHARDED_GRAPH_JAX_REF_MAX_OVERFLOW = {"onehot_bf16": 0, "gather": 0}


def circle_graph(dev, n: int = 24, max_nodes: int = 32, max_edges: int = 64):
    """tests/test_posegraph.py's circle: noisy odometry edges (numpy seed 0)
    and two exact closures, nodes at the drifted odometry poses."""
    rng = np.random.default_rng(0)
    ths = np.linspace(0, 2 * math.pi, n, endpoint=False)
    truth = torch.tensor(np.stack([5.0 * np.cos(ths), 5.0 * np.sin(ths),
                                   ths + math.pi / 2], -1), dtype=torch.float32)
    g = posegraph.init(max_nodes, max_edges, dev)
    est = truth[0]
    g, _ = posegraph.add_node(g, est.to(dev))
    for t in range(1, n):
        noisy = pose_between(truth[t - 1], truth[t]) + torch.tensor(
            rng.normal(0, 0.03, 3), dtype=torch.float32)
        est = pose_compose(est, noisy)
        g, _ = posegraph.add_node(g, est.to(dev))
        g = posegraph.add_edge(g, t - 1, t, noisy.to(dev), (10.0, 10.0, 40.0))
    for i, j in ((0, n // 2), (n - 1, 0)):
        g = posegraph.add_edge(g, i, j,
                               pose_between(truth[i], truth[j]).to(dev),
                               (100.0, 100.0, 400.0))
    return g


def make_sharded_graph_log(seed: int = SHARDED_GRAPH_SEED) -> ScanLog:
    """Section 3's log: SHARDED_GRAPH_STILL still scans at (20, 20, 0), then
    one lap of ``rect_drive_trajectory()`` (straight legs at 0.3 m a scan,
    90-degree turns in place at 10 degrees a scan), 71 scans of NUM_BEAMS
    beams simulated on the CPU from ``seed``."""
    sim = SimConfig()
    still = np.tile(np.asarray(sim.start_pose, np.float32),
                    (SHARDED_GRAPH_STILL, 1))
    traj = np.concatenate([still, rect_drive_trajectory()])
    angles = revolution_angles(NUM_BEAMS)
    fld = default_field(sim.field_scale, sim.field_offset, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    radii, valid = scan_revolution(fld, torch.from_numpy(traj),
                                   torch.from_numpy(angles),
                                   sim.max_scan_dist, sim.measure_error, gen)
    return ScanLog(traj, angles, radii.numpy(), valid.numpy(),
                   SHARDED_GRAPH_FORCED)


def sharded_graph_config(frontend_mode: str = "onehot_bf16",
                         n_search: Optional[int] = None
                         ) -> Tuple[HectorConfig, PoseGraphConfig,
                                    ScanMatchConfig, int]:
    """Section 3's configuration: the 3-level 400-px 7/4/4 pyramid in
    ``onehot_bf16``; the frontend in ``frontend_mode`` with the dense fill
    (``"gather"``: the default frontend, K3 + K4); 16 keyframe slots a
    search shard of the mesh in use (``n_search``, default
    SHARDED_GRAPH_MESH's; ``__graft_entry__.py:163``); 8 separator slots.
    Returns (hcfg, gcfg, mcfg, sep_capacity)."""
    if n_search is None:
        n_search = SHARDED_MESHES[SHARDED_GRAPH_MESH]["search"]
    hcfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        matcher_mode="onehot_bf16")
    gcfg = PoseGraphConfig(max_keyframes=16 * n_search, max_edges=64,
                           keyframe_dist=0.5, keyframe_angle=0.6,
                           loop_closure_radius=1.5)
    mcfg = (ScanMatchConfig() if frontend_mode == "gather"
            else ScanMatchConfig(matcher_mode=frontend_mode, dense_fill=True))
    return hcfg, gcfg, mcfg, SHARDED_GRAPH_SEP_CAPACITY


class ShardedGraphOut(NamedTuple):
    poses: torch.Tensor            # f32[T, 3] live match pose after each scan
    keyframe_added: torch.Tensor   # bool[T]
    loop_closed: torch.Tensor      # bool[T]
    sep_overflow: torch.Tensor     # i32[T]
    flags: np.ndarray              # bool[T, 3]: due, has_cand, looped


def sharded_graph_replay(mesh, dlog: DeviceLog, hcfg: HectorConfig,
                         gcfg: PoseGraphConfig, mcfg: ScanMatchConfig,
                         sep_capacity: int = SHARDED_GRAPH_SEP_CAPACITY,
                         state: Optional[
                             graph_slam_sharded.ShardedGraphSlamState] = None,
                         start: int = 0, step=None
                         ) -> Tuple[graph_slam_sharded.ShardedGraphSlamState,
                                    ShardedGraphOut]:
    """``graph_slam_sharded`` over scans ``start``.. of ``dlog`` on ``mesh``
    (every rank calls it with the whole log), from ``state`` (default a
    fresh one at the first true pose), scans below SHARDED_GRAPH_FORCED
    mapped at the live pose unmatched (``__graft_entry__.py:190-192``).  ``step`` is a
    ``graph_slam_sharded.Step`` to run (default a new one).  The outputs
    stay on the device but the flags, which the step reads."""
    if state is None:
        state = graph_slam_sharded.init(mesh, hcfg, gcfg, dlog.traj[0],
                                        dlog.points.shape[1])
    if step is None:
        step = graph_slam_sharded.make_step(mesh, hcfg, gcfg,
                                            dlog.points.shape[1], mcfg,
                                            sep_capacity=sep_capacity)
    first = len(step.flags)
    poses, kf, loop, over = [], [], [], []
    for t in range(start, dlog.points.shape[0]):
        state, info = step(state, dlog.points[t], dlog.valid[t],
                           t < SHARDED_GRAPH_FORCED)
        poses.append(state.match_pose)
        kf.append(info.keyframe_added)
        loop.append(info.loop_closed)
        over.append(info.sep_overflow)
    return state, ShardedGraphOut(
        torch.stack(poses), torch.stack(kf), torch.stack(loop),
        torch.stack(over), np.asarray(step.flags[first:], bool))


def sharded_graph_metrics(state: graph_slam_sharded.ShardedGraphSlamState,
                          out: ShardedGraphOut, truth: np.ndarray) -> dict:
    """Section 3's numbers: RMS and max error of the poses after the forced
    scans, the final pose's error (JAX's own check), keyframes, accepted
    closures, the largest separator overflow."""
    poses = out.poses.cpu().numpy()
    f = SHARDED_GRAPH_FORCED
    ate, mx = ate_of(poses[f:], np.asarray(truth)[f:])
    return {"ate_m": ate, "max_err_m": mx,
            "final_err_m": float(np.linalg.norm(poses[-1, :2]
                                                - np.asarray(truth)[-1, :2])),
            "keyframes": int(state.graph.num_nodes),
            "loop_closures": int(state.loop_count),
            "max_overflow": int(out.sep_overflow.max())}


def sharded_graph_reference(frontend_mode: str = "onehot_bf16",
                            mesh: str = SHARDED_GRAPH_MESH) -> dict:
    """``SHARDED_GRAPH_JAX_REF_*`` of a frontend as
    ``sharded_graph_metrics``' dict, for a mesh JAX was run on
    (``SHARDED_GRAPH_JAX_REF_MESHES`` and 2x1; KeyError for another)."""
    if mesh == "2x1":
        return dict(SHARDED_GRAPH_JAX_REF_2X1[frontend_mode])
    if mesh not in SHARDED_GRAPH_JAX_REF_MESHES:
        raise KeyError(f"no JAX reference of section 3 on the {mesh} mesh")
    return {"ate_m": SHARDED_GRAPH_JAX_REF_ATE_M[frontend_mode],
            "max_err_m": SHARDED_GRAPH_JAX_REF_MAX_M[frontend_mode],
            "final_err_m": SHARDED_GRAPH_JAX_REF_FINAL_ERR_M[frontend_mode],
            "keyframes": SHARDED_GRAPH_JAX_REF_KEYFRAMES[frontend_mode],
            "loop_closures": SHARDED_GRAPH_JAX_REF_CLOSURES[frontend_mode],
            "max_overflow":
                SHARDED_GRAPH_JAX_REF_MAX_OVERFLOW[frontend_mode]}


def sharded_graph_gate(got: dict, ref: dict) -> list:
    """The graph gate (``graph_gate``: the same keyframes, at most 2
    closures fewer, ATE within 15%, max error within 0.01 m) and JAX's own
    checks of section 3 (no separator overflow, at least one closure, the
    final error under 0.5 m).  Returns the failed conditions."""
    fails = graph_gate(got, ref)
    if got["max_overflow"] != 0:
        fails.append(f"separator overflow {got['max_overflow']}")
    if got["loop_closures"] < 1:
        fails.append("no loop closure")
    if not got["final_err_m"] < 0.5:
        fails.append(f"final error {got['final_err_m']} >= 0.5")
    return fails
