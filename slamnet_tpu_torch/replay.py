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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .core.config import HectorConfig, PoseGraphConfig, SimConfig
from .core.scan import Scan
from .graph.frontend import ScanMatchConfig
from .models import fleet, graph_slam, hector
from .sim import default_field, revolution_angles, scan_revolution
from .sim.trajectory import loop_trajectory, rect_revisit_trajectory

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
# 183, "solve_failures": 0}.
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
    fld = default_field(sim.field_scale, sim.field_offset)
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
    fld = default_field(sim.field_scale, sim.field_offset)
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
