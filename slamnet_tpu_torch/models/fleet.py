"""Fleet serving: B independent Hector instances batched on one card.

Port of ``slamnet_tpu/models/fleet.py`` (``init_fleet``, ``fleet_cells``,
``_match_batch``, ``update_fleet``, ``replay_fleet``), with
``models/hector.py``'s modes: the bench's fleet base with the K5 matcher and
the dense fill (``sub4_pallas_dense``), with the gather matcher and line
updates (``sub1``, the fleet's accuracy anchor, and ``sub4`` on every 4th
beam), or with K1's table and line updates (``sub4_onehot`` and its
update-budget twins).  ``early_exit_tol > 0`` runs JAX's batch-wide exit
(``slamnet_tpu/models/fleet.py:154-172``: a level stops only when every
instance has converged, and every instance runs the shared count, which
``HectorInfo.gn_iterations`` reports) under ``gather``,
``onehot_highest`` and ``onehot_bf16``; ``"pallas"`` refuses it, as JAX's
does (``fleet.py:89-92``).  The state is a
``hector.HectorState`` with an instance axis: ``maps`` is ONE flat f32[B*C]
table (C = ``fleet_cells(cfg)``, each instance's pyramid finest level first,
as in JAX), and the poses f32[B, 3].

One batch-scan costs one match launch for all B robots (K5, or the batched
K3 for ``gather`` / ``onehot_highest``; ``ops/match.py``), a few small
PyTorch operators for the guards, the motion gates and the update budget,
and one batched map-update call (K2, ``ops/fill.py``, or with
``dense_free_fill=False`` K4, ``ops/line.py``) that reads a per-instance
device flag ``fire`` bool[B]: only the firing instances (about 1 in 18 at
the reference's gate statistics) touch their maps.  The JAX version's
scan-over-instances ``lax.cond`` was a TPU workaround; here the flag does its
work on the device, and nothing in ``update_fleet`` waits for the device or
branches on a device value.  ``update_fleet`` changes ``states.maps`` IN
PLACE (JAX returns a new array).

Semantics are per-instance ``models/hector.update``'s: a 1-robot fleet equals
it (``tests/test_torch_fleet.py``).

The fleet over a mesh (``make_fleet_step`` / ``make_fleet_replay``, JAX's
``fleet.py:293-358``): robots are independent, so the robot axis shards
over one mesh axis with no collective at all.  Each rank of the axis runs
this single-card fleet (its kernels) on its B / S robots and its slice of
the flat map table (``shard_fleet``), replicated over the mesh's other axes.
As in JAX, the update budget (``fleet_update_capacity``) applies per shard.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, rad_diff
from ..ops import fill, line, match as match_op
from ..parallel.mesh import Mesh, shard_range
from .hector import FLOAT_MIN, HectorInfo, HectorState, _check_cfg


def fleet_cells(cfg: HectorConfig) -> int:
    """Cells in one instance's concatenated pyramid table."""
    return cfg.total_cells


def init_fleet(cfg: HectorConfig, start_poses,
               device: torch.device | str = "cuda") -> HectorState:
    """Zeroed maps f32[B*C], match poses at ``start_poses``
    f32[B, 3], last-update poses at float.MinValue (hector.init per
    instance), on the card unless ``device`` names another."""
    _check_cfg(cfg)
    poses = torch.as_tensor(start_poses, dtype=torch.float32,
                            device=device).clone()
    if poses.dim() != 2 or poses.shape[1] != 3:
        raise ValueError(f"start_poses must be [B, 3], got {tuple(poses.shape)}")
    n = poses.shape[0] * fleet_cells(cfg)
    return HectorState(
        maps=torch.zeros(n, dtype=torch.float32, device=device),
        match_pose=poses,
        last_update_pose=torch.full_like(poses, FLOAT_MIN))


def _force(map_without_matching, b: int, device) -> torch.Tensor:
    if isinstance(map_without_matching, torch.Tensor):
        return map_without_matching.to(device=device,
                                       dtype=torch.bool).expand(b)
    # a fill on the device: no host-to-device copy, no wait
    return torch.full((b,), bool(map_without_matching), dtype=torch.bool,
                      device=device)


def update_fleet(states: HectorState, points: torch.Tensor,
                 valid: torch.Tensor, cfg: HectorConfig,
                 map_without_matching: bool | torch.Tensor = False,
                 plain: bool = False) -> Tuple[HectorState, HectorInfo]:
    """One scan step for every instance: ``points`` f32[B, N, 2], ``valid``
    bool[B, N], each instance hinted with its ``match_pose``.
    ``map_without_matching`` (a bool, or a bool tensor of shape () or [B])
    forces the maps to update at the hint.  ``plain=True`` runs the kernels'
    plain versions whatever the device.  ``states.maps`` is updated in place; ``HectorInfo`` fields are
    [B]-shaped."""
    _check_cfg(cfg)
    b = points.shape[0]
    dev = states.maps.device
    hint = states.match_pose
    force = _force(map_without_matching, b, dev)

    # ---- phase 1: every match in one launch (K5 or the batched K3) ----------
    if plain:
        out = match_op.match_batch_plain(states.maps, points, valid, hint, cfg)
    else:
        out = match_op.match_batch(states.maps, points, valid, hint, cfg)
    matched = out[:, :3]
    if cfg.min_match_in_map_frac > 0.0:
        # reject matches resting on too few in-map beams (see hector.update)
        n_valid = valid[:, ::cfg.match_subsample].sum(dim=1,
                                                      dtype=torch.float32)
        in_map_frac = out[:, 5] / n_valid.clamp(min=1.0)
        matched = torch.where((in_map_frac >= cfg.min_match_in_map_frac)[:, None],
                              matched, hint)
    if cfg.max_match_jump > 0.0:
        # reject physically impossible per-scan jumps (degenerate-view solves)
        jump2 = ((matched[:, :2] - hint[:, :2]) ** 2).sum(dim=1)
        matched = torch.where((jump2 <= cfg.max_match_jump ** 2)[:, None],
                              matched, hint)
    match_pose = torch.where(force[:, None], hint, matched)

    # ---- phase 2: the motion gates (HectorSLAMProcessor.cs:107-109) ---------
    last = states.last_update_pose
    dist2 = ((match_pose[:, :2] - last[:, :2]) ** 2).sum(dim=1)
    if cfg.angle_gate_compat:
        ang_gate = deg_diff(match_pose[:, 2], last[:, 2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = rad_diff(match_pose[:, 2], last[:, 2]).abs() \
            > cfg.min_angle_diff_for_map_update
    do_update = (dist2 > cfg.min_distance_diff_for_map_update ** 2) \
        | ang_gate | force

    # ---- phase 3: the update budget, then one batched update (K2 or K4) ----
    # JAX's argsort(~do_update, stable)[:cap] picks the firing instances of
    # lowest index; an instance beyond the budget defers (its gate stays
    # armed because its last-update pose does not move).
    cap = min(b, cfg.fleet_update_capacity)
    if cap < b:
        rank = torch.cumsum(do_update.to(torch.int32), dim=0) - 1
        fire = do_update & (rank < cap)
    else:
        fire = do_update
    zero = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    if plain:
        plain_fn = (fill.update_maps_batch_plain if cfg.dense_free_fill
                    else line.update_maps_line_batch_plain)
        maps = states.maps.copy_(plain_fn(states.maps, points, valid,
                                          match_pose, zero, fire, cfg))
    else:
        fn = (fill.update_maps_batch if cfg.dense_free_fill
              else line.update_maps_line_batch)
        maps = fn(states.maps, points, valid, match_pose, zero, fire, cfg)
    new_last = torch.where(fire[:, None], match_pose, last)
    info = HectorInfo(map_updated=fire,
                      residual=out[:, 4] / out[:, 5].clamp(min=1.0),
                      gn_iterations=out[:, 6].to(torch.int32),
                      solve_failures=out[:, 3].to(torch.int32))
    return HectorState(maps, match_pose, new_last), info


def replay_fleet(states: HectorState, points: torch.Tensor,
                 valid: torch.Tensor, cfg: HectorConfig, plain: bool = False
                 ) -> Tuple[HectorState, torch.Tensor]:
    """Track T batch-scans, ``points`` f32[T, B, N, 2] and ``valid``
    bool[T, B, N] on the device, each hinted with the previous match pose.
    Runs on a copy of ``states``' maps, so the caller's state can be replayed
    again.  Returns the final states and the match poses f32[T, B, 3] (on the
    device; the host waits for nothing)."""
    states = states._replace(maps=states.maps.clone())
    poses = []
    for t in range(points.shape[0]):
        states, _ = update_fleet(states, points[t], valid[t], cfg, False,
                                 plain)
        poses.append(states.match_pose)
    return states, torch.stack(poses)


# --------------------------- fleet over the mesh -----------------------------

def shard_fleet(mesh: Mesh, states: HectorState, cfg: HectorConfig,
                axis: str = "search") -> HectorState:
    """This rank's robots of a whole fleet's state (B divisible by the axis
    size): its poses and its rows of the flat map table, on the mesh's
    device."""
    lo, hi = shard_range(states.match_pose.shape[0], mesh, axis)
    c = fleet_cells(cfg)
    return HectorState(
        states.maps[lo * c:hi * c].to(mesh.device).clone(),
        states.match_pose[lo:hi].to(mesh.device).clone(),
        states.last_update_pose[lo:hi].to(mesh.device).clone())


def gather_fleet(mesh: Mesh, states: HectorState,
                 axis: str = "search") -> HectorState:
    """The whole fleet's state from every rank's robots along ``axis`` (one
    all_gather a field; a collective every rank of the axis calls)."""
    return HectorState(*(mesh.all_gather(t, axis, tiled=True)
                         for t in states))


def _check_shard(states: HectorState, robots: int) -> None:
    if states.match_pose.shape[0] != robots:
        raise ValueError(f"{states.match_pose.shape[0]} robots in the state, "
                         f"scans of {robots}")


def make_fleet_step(mesh: Mesh, cfg: HectorConfig, axis: str = "search"):
    """The sharded fleet step: ``step(states, points f32[b, N, 2], valid
    bool[b, N], force=False)`` on this rank's b = B / S robots of the
    ``axis`` (``shard_fleet``): ``update_fleet``'s contract, no
    collective."""
    _check_cfg(cfg)

    def step(states: HectorState, points: torch.Tensor, valid: torch.Tensor,
             force: bool | torch.Tensor = False):
        _check_shard(states, points.shape[0])
        return update_fleet(states, points, valid, cfg, force)

    return step


def make_fleet_replay(mesh: Mesh, cfg: HectorConfig, axis: str = "search"):
    """The sharded fleet replay: ``replay(states, points f32[T, b, N, 2],
    valid bool[T, b, N])`` on this rank's robots of the ``axis``:
    ``replay_fleet``'s contract (the final states and the poses
    f32[T, b, 3]), no collective."""
    _check_cfg(cfg)

    def replay(states: HectorState, points: torch.Tensor,
               valid: torch.Tensor):
        _check_shard(states, points.shape[1])
        return replay_fleet(states, points, valid, cfg)

    return replay
