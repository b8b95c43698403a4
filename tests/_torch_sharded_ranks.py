"""Rank functions of the port's multi-device tests (not a test module).

Each function runs on every rank of a world that ``slamnet_tpu_torch.
parallel.launch`` starts on the CPU with gloo (8 ranks unless a test says
otherwise), reads its inputs from the npz ``data``, builds the meshes every
rank builds (2x2 over ranks 0-3, 4x2 over all eight), runs the port's
sharded functions and has rank 0 write what the test compares to ``out``
(an npz).  Imports the port only: the test process holds JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from slamnet_tpu_torch.core.config import CoreSlamConfig, HectorConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.parallel import hessian, make_mesh, search, tiles
from slamnet_tpu_torch.parallel.mesh import shard_range

MESHES = (("2x2", {"tile": 2, "search": 2}), ("4x2", {"tile": 4, "search": 2}))


def _meshes(device="cpu"):
    torch.set_num_threads(1)
    return [(name, make_mesh(axes, device)) for name, axes in MESHES]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def scan_log(n: int, beams: int, stride: int, seed: int = 0):
    """``n`` scans of the loop at 0.3 m/s taken every ``stride``-th pose,
    ``beams`` beams, the port's sim on the CPU from ``seed``: (traj
    f32[n, 3], points f32[n, beams, 2], valid bool[n, beams]) as numpy."""
    from slamnet_tpu_torch.core.config import SimConfig
    from slamnet_tpu_torch.sim import (default_field, revolution_angles,
                                       scan_revolution)
    from slamnet_tpu_torch.sim.trajectory import loop_trajectory
    sim = SimConfig()
    traj = loop_trajectory(speed=0.3)[::stride][:n].astype(np.float32)
    angles = revolution_angles(beams)
    fld = default_field(sim.field_scale, sim.field_offset, device="cpu")
    r, v = scan_revolution(fld, torch.from_numpy(traj),
                           torch.from_numpy(angles), sim.max_scan_dist,
                           sim.measure_error,
                           torch.Generator().manual_seed(seed))
    a = torch.from_numpy(angles)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], -1)
    return traj, pts.numpy().astype(np.float32), v.numpy()


def _tuples(cfg: dict) -> dict:
    """A config's fields from JSON (lists back to tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def _save(mesh, out, res):
    if mesh.rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


# ------------------------------------------------------------ collectives

def collectives(out: str) -> dict:
    """Every collective on each axis and on both, of every rank's value
    ``rank + 10 * i`` (i = 0..3), gathered to rank 0 by an all_gather over
    the mesh (the world group)."""
    res = {}
    for name, m in _meshes():
        if not m.member:
            continue
        x = torch.arange(4, dtype=torch.float32) * 10 + m.rank
        got = {}
        for axes in ("tile", "search", ("tile", "search")):
            key = axes if isinstance(axes, str) else "both"
            got[f"psum_{key}"] = m.psum(x, axes)
            got[f"pmax_{key}"] = m.pmax(x, axes)
            got[f"pmin_{key}"] = m.pmin(-x, axes)
        for axis in ("tile", "search"):
            got[f"gather_{axis}"] = m.all_gather(x, axis).reshape(-1)
            got[f"tiled_{axis}"] = m.all_gather(x, axis, tiled=True)
            n = m.axis_size(axis)
            got[f"perm_{axis}"] = m.ppermute(
                x, axis, [(i, i - 1) for i in range(1, n)])
            got[f"ring_{axis}"] = m.ppermute(
                x, axis, [(i, (i + 1) % n) for i in range(n)])
        names = sorted(got)
        table = m.all_gather(torch.cat([got[k] for k in names]),
                             ("tile", "search"))
        sizes = [got[k].numel() for k in names]
        for r in range(m.size):
            for k, piece in zip(names, table[r].split(sizes)):
                res[f"{name}_{k}_{r}"] = piece.numpy()
        res[f"{name}_counts"] = np.asarray([m.counts["collectives"],
                                            m.counts["host_copies"]])
    _save(make_mesh({"all": torch.distributed.get_world_size()}, "cpu"), out,
          res)
    return {"ok": True}


# ------------------------------------------------------- parallel/ blocks

def parallel_ops(data: str, out: str) -> dict:
    """hessian, tiles and search on 1-axis meshes of 4 and 8 ranks."""
    torch.set_num_threads(1)
    d = np.load(data)
    meshes = [(n, make_mesh({"x": n}, "cpu")) for n in (4, 8)]
    res = {}
    for n, m in meshes:
        if not m.member:
            continue
        # beam-sharded (H, dTr)
        lo, hi = shard_range(d["h_pts"].shape[0], m, "x")
        H, dtr = hessian.sharded_hessian_derivs(
            m, _t(d["h_map"]), int(d["h_width"]), _t(d["h_pts"])[lo:hi],
            _t(d["h_valid"])[lo:hi], _t(d["h_pose"]), 10.0, "x")
        res[f"{n}_H"], res[f"{n}_dtr"] = H.numpy(), dtr.numpy()
        res[f"{n}_gn_pose"] = hessian.sharded_gn_iteration(
            m, _t(d["h_map"]), int(d["h_width"]), _t(d["h_pts"])[lo:hi],
            _t(d["h_valid"])[lo:hi], _t(d["h_pose"]), 10.0, 0.2, "x").numpy()
        # row tiles: (H, dTr), the line update and the halos
        grid = _t(d["t_grid"])
        w = grid.shape[1]
        rows = w // n
        local = tiles.local_tile(m, grid, "x")
        H, dtr = tiles.tiled_hessian_derivs_local(
            m, local, w, rows, _t(d["t_pts"]), _t(d["t_valid"]),
            _t(d["t_pose"]), 10.0, "x")
        res[f"{n}_tH"], res[f"{n}_tdtr"] = H.numpy(), dtr.numpy()
        res[f"{n}_tgn_pose"] = tiles.tiled_gn_iteration_local(
            m, local, w, rows, _t(d["t_pts"]), _t(d["t_valid"]),
            _t(d["t_pose"]), 10.0, "x").numpy()
        upd = tiles.tiled_occupancy_update_local(
            m, tiles.local_tile(m, _t(d["u_grid"]), "x"), w, rows,
            _t(d["u_pts"]), _t(d["u_valid"]), _t(d["u_pose"]), 1.6,
            float(d["lof"]), float(d["loo"]), "x")
        res[f"{n}_upd_tiles"] = m.all_gather(upd, "x").numpy()
        res[f"{n}_upd_grid"] = tiles.gather_grid(m, upd, "x").numpy()
        res[f"{n}_roundtrip"] = tiles.gather_grid(
            m, tiles.local_tile(m, _t(d["r_grid"]), "x"), "x").numpy()
        # candidate-sharded Monte-Carlo search, two seeds
        for seed in (3, 11):
            best, gmin = search.sharded_monte_carlo_search(
                m, _t(d["s_hole"]), 64, 1.6, _t(d["s_pts"]),
                _t(d[f"s_valid{seed}"]), _t(d["s_pose"]), 0.1, 0.1, 1024,
                seed, "x")
            res[f"{n}_best{seed}"], res[f"{n}_gmin{seed}"] = (best.numpy(),
                                                              gmin.numpy())
        last = m
    _save(last, out, res)
    return {"ok": True}


# ----------------------------------------------------------- Hector sharded

def _hector_replay(m, cfg, d, boot, num_beams):
    from slamnet_tpu_torch.models import hector_sharded as hs
    traj, pts, valid = _t(d["traj"]), _t(d["pts"]), _t(d["valid"])
    st = hs.init(m, cfg, traj[0])
    step = hs.make_step(m, cfg, num_beams)
    poses, upd, iters = [], [], []
    for t in range(traj.shape[0]):
        if t < boot:
            st = st._replace(match_pose=traj[t].clone())
        st, info = step(st, pts[t], valid[t], t < boot)
        poses.append(st.match_pose)
        upd.append(info.map_updated)
        iters.append(info.gn_iterations)
        if t == boot - 1:
            boot_maps = hs.unshard_maps(m, st, cfg)
    return (st, torch.stack(poses), torch.stack(upd), boot_maps,
            torch.stack(iters))


def hector(data: str, out: str, cfg: dict, boot: int, exit_tol: float,
           serving: dict, serving_cleared: dict) -> dict:
    """The cases of ``tests/test_torch_hector_sharded.py`` on both meshes
    (``serving``: a config's fields over ``cfg``, replayed on the 2x2 mesh
    as it is and with ``serving_cleared`` over it)."""
    import dataclasses

    from slamnet_tpu_torch import convert
    from slamnet_tpu_torch.models import hector as dense_hector
    from slamnet_tpu_torch.models import hector_sharded as hs
    d = np.load(data)
    base = HectorConfig().overlay(_tuples(cfg))
    nb = d["pts"].shape[1]
    res = {}
    for name, m in _meshes():
        if not m.member:
            continue
        # the tiles of a random pyramid, and back
        dense = dense_hector.init(base, (20.0, 20.0, 0.0), "cpu")
        dense = dense._replace(maps=_t(d["rand_maps"]))
        sh = hs.shard_state(m, dense, base)
        res[f"{name}_tiles"] = hs.gather_tiles(m, sh).numpy()
        res[f"{name}_roundtrip"] = hs.unshard_maps(m, sh, base).numpy()
        # JAX's sharded arrays (every tile's table) in and out
        cst = convert.sharded_hector_state_from_numpy(
            d[f"jax_tiles_{name}"], d["traj"][0], d["traj"][0], m)
        res[f"{name}_convert_tile"] = cst.local_maps.numpy()
        res[f"{name}_convert_back"] = convert.sharded_hector_state_to_numpy(
            cst, m)["local_maps"]
        # forced updates from zero maps: the replay's first `boot` scans
        for mode in ("gather", "onehot_highest", "onehot_bf16", "exit"):
            if name == "4x2" and mode != "gather":
                continue
            c = (base.overlay({"early_exit_tol": exit_tol}) if mode == "exit"
                 else dataclasses.replace(base, matcher_mode=mode))
            st, poses, upd, boot_maps, iters = _hector_replay(m, c, d, boot,
                                                              nb)
            res[f"{name}_{mode}_iters"] = iters.numpy()
            res[f"{name}_{mode}_boot_maps"] = boot_maps.numpy()
            res[f"{name}_{mode}_poses"] = poses.numpy()
            res[f"{name}_{mode}_updates"] = upd.numpy()
            res[f"{name}_{mode}_maps"] = hs.unshard_maps(m, st, c).numpy()
        # one matched step from a warmed map, and the in-map guard's case
        for case in ("warm", "frac"):
            c = base if case == "warm" else dataclasses.replace(
                base, min_match_in_map_frac=float(d["frac_guard"]))
            warm = dense_hector.HectorState(
                _t(d["warm_maps"]), _t(d[f"{case}_hint"]),
                _t(d["warm_last"]))
            st, info = hs.make_step(m, c, nb)(hs.shard_state(m, warm, c),
                                             _t(d["q_pts"]), _t(d["q_valid"]),
                                             False)
            res[f"{name}_{case}_pose"] = st.match_pose.numpy()
            res[f"{name}_{case}_info"] = np.asarray(
                [float(info.map_updated), float(info.residual),
                 float(info.gn_iterations), float(info.solve_failures)])
        res[f"{name}_collectives"] = np.asarray(m.counts["collectives"])
        # serving_hector_config()'s knobs, which the sharded step ignores as
        # JAX's does: the replay with them, and with the three cleared
        if name == "2x2":
            for case, c in (("serving", base.overlay(serving)),
                            ("serving_cleared", base.overlay(
                                {**serving, **serving_cleared}))):
                st, poses, upd, _, iters = _hector_replay(m, c, d, boot, nb)
                res[f"{name}_{case}_poses"] = poses.numpy()
                res[f"{name}_{case}_updates"] = upd.numpy()
                res[f"{name}_{case}_iters"] = iters.numpy()
                res[f"{name}_{case}_maps"] = hs.unshard_maps(m, st, c).numpy()
        last = m
    _save(last, out, res)
    return {"ok": True}


# --------------------------------------------------------- CoreSLAM sharded

CORESLAM_CONFIGS = {
    "mc": dict(num_candidates=1024),
    "production": dict(search_mode="correlative", dense_hole_fill=True,
                       dense_obstacle_fill=True)}
CORESLAM_SEED = 7


def coreslam(data: str, out: str) -> dict:
    """The cases of ``tests/test_torch_coreslam_sharded.py`` on both
    meshes: both modes' replays, the roundtrip, the correlative grid."""
    from slamnet_tpu_torch.models import coreslam as dense_coreslam
    from slamnet_tpu_torch.models import coreslam_sharded as cs
    d = np.load(data)
    traj, pts, valid = _t(d["traj"]), _t(d["pts"]), _t(d["valid"])
    res = {}
    for name, m in _meshes():
        if not m.member:
            continue
        for mode, over in CORESLAM_CONFIGS.items():
            cfg = CoreSlamConfig().overlay(over)
            st = cs.init(m, cfg, traj[0], seed=CORESLAM_SEED)
            step = cs.make_step(m, cfg)
            poses, sums = [], []
            for t in range(traj.shape[0]):
                st, info = step(st, pts[t], valid[t], st.pose)
                poses.append(st.pose)
                sums.append(info.best_sum)
            dense = cs.to_dense(m, st)
            res[f"{name}_{mode}_poses"] = torch.stack(poses).numpy()
            res[f"{name}_{mode}_sums"] = torch.stack(sums).numpy()
            res[f"{name}_{mode}_hole"] = dense.hole_map.numpy()
            res[f"{name}_{mode}_obst"] = dense.obstacle_map.numpy()
            res[f"{name}_{mode}_count"] = np.asarray(
                [int(dense.scan_count), dense.scans])
        cfg = CoreSlamConfig()
        dense = dense_coreslam.init(cfg, (20.0, 20.0, 0.0), device="cpu")
        sh = cs.shard_state(m, dense._replace(hole_map=_t(d["rand_hole"])),
                            cfg)
        res[f"{name}_roundtrip"] = cs.to_dense(m, sh).hole_map.numpy()
        # JAX's local_hole i32[T, rows * S] in and out
        from slamnet_tpu_torch import convert
        cst = convert.sharded_coreslam_state_from_numpy(
            d["rand_hole"].reshape(m.axis_size("tile"), -1),
            dense.obstacle_map.numpy(), d["traj"][0], np.zeros(3, np.float32),
            np.int32(5), m)
        res[f"{name}_convert_tile"] = cst.local_hole.numpy()
        back = convert.sharded_coreslam_state_to_numpy(cst, m)
        res[f"{name}_convert_back"] = back["local_hole"]
        res[f"{name}_convert_count"] = np.asarray([back["scan_count"],
                                                   cst.scans])
        rows = cfg.hole_map_size // m.axis_size("tile")
        t0 = m.axis_index("tile") * rows * cfg.hole_map_size
        res[f"{name}_eff"] = cs.correlative_eff(
            m, _t(d["c_hole"])[t0:t0 + rows * cfg.hole_map_size],
            cfg.hole_map_size, rows, cfg.hole_scale, _t(d["c_pts"]),
            _t(d["c_valid"]), _t(d["c_pose"]), _t(d["c_thetas"]),
            cfg.corr_window).numpy()
        last = m
    _save(last, out, res)
    return {"ok": True}


# ----------------------------- the fleet, the pose graph, the checkpoints

FLEET_MESHES = (("2x2", {"tile": 2, "search": 2}),
                ("2x4", {"tile": 2, "search": 4}))
FLEET_MODES = ("sub1", "sub4_pallas_dense")


def _fleet_run(m, cfg, d, boot):
    from slamnet_tpu_torch.models import fleet
    full = fleet.init_fleet(cfg, _t(d["f_traj"][0]), "cpu")
    st = fleet.shard_fleet(m, full, cfg)
    lo, hi = shard_range(full.match_pose.shape[0], m, "search")
    traj, pts = _t(d["f_traj"])[:, lo:hi], _t(d["f_pts"])[:, lo:hi]
    valid = _t(d["f_valid"])[:, lo:hi]
    step = fleet.make_fleet_step(m, cfg)
    for t in range(boot):
        st = st._replace(match_pose=traj[t].clone())
        st, _ = step(st, pts[t], valid[t], True)
    st, poses = fleet.make_fleet_replay(m, cfg)(st, pts[boot:], valid[boot:])
    whole = fleet.gather_fleet(m, st)
    return whole, m.all_gather(poses.transpose(0, 1).contiguous(), "search",
                               tiled=True)


def mesh_fleet(data: str, out: str, small: dict, boot: int,
               ckpt_dir: str) -> dict:
    """The fleet over two meshes, the edge-sharded pose graph, and the
    sharded checkpoints of ``tests/test_torch_mesh_fleet.py``."""
    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.graph import distributed, posegraph
    from slamnet_tpu_torch.io import checkpoint
    from slamnet_tpu_torch.models import coreslam, coreslam_sharded
    from slamnet_tpu_torch.models import hector, hector_sharded as hs
    torch.set_num_threads(1)
    d = np.load(data)
    small = _tuples(small)
    res = {}
    world = torch.distributed.get_world_size()
    # ---- the fleet: B robots over the 'search' axis -----------------------
    meshes = [(n, make_mesh(a, "cpu")) for n, a in FLEET_MESHES]
    for name, m in meshes:
        if not m.member:
            continue
        for mode in FLEET_MODES:
            cfg = getattr(replay, f"{mode}_config")(**small)
            whole, poses = _fleet_run(m, cfg, d, boot)
            res[f"fleet_{name}_{mode}_maps"] = whole.maps.numpy()
            res[f"fleet_{name}_{mode}_poses"] = poses.transpose(0, 1).numpy()
    # ---- the pose graph: edges over 1-axis meshes of 4 and 8 ranks --------
    g = posegraph.PoseGraph(**{k: _t(d[f"g_{k}"])
                               for k in posegraph.PoseGraph._fields})
    for n in (4, world):
        m = make_mesh({"edge": n}, "cpu")
        if m.member:
            res[f"graph_{n}_step"] = distributed.sharded_gn_step(
                m, g).poses.numpy()
            res[f"graph_{n}_opt"] = distributed.sharded_optimize(
                m, g, 3).poses.numpy()
    # ---- sharded checkpoints: save at 2x2, restore at 2x2 and at 4x2 ------
    hcfg = HectorConfig().overlay(_tuples(dict(map_size=100, map_resolution=0.3,
                                                num_levels=2,
                                                estimate_iterations=(3, 2))))
    ccfg = CoreSlamConfig().overlay(CORESLAM_CONFIGS["production"])
    traj, pts, valid = _t(d["traj"]), _t(d["pts"]), _t(d["valid"])
    cut, n_scans = int(d["cut"]), traj.shape[0]
    m22, m42 = (make_mesh(a, "cpu") for _, a in MESHES)

    def hector_from(m, st, t0):
        step = hs.make_step(m, hcfg, pts.shape[1])
        for t in range(t0, n_scans):
            if t < boot:
                st = st._replace(match_pose=traj[t].clone())
            st, _ = step(st, pts[t], valid[t], t < boot)
        return st

    def coreslam_from(m, st, t0):
        step = coreslam_sharded.make_step(m, ccfg)
        for t in range(t0, n_scans):
            st, _ = step(st, pts[t], valid[t], st.pose)
        return st

    hpath, cpath = f"{ckpt_dir}/hector", f"{ckpt_dir}/coreslam"
    if m22.member:
        # the uninterrupted replays, and the checkpoints at the cut
        h = hs.init(m22, hcfg, traj[0])
        step = hs.make_step(m22, hcfg, pts.shape[1])
        for t in range(cut):
            if t < boot:
                h = h._replace(match_pose=traj[t].clone())
            h, _ = step(h, pts[t], valid[t], t < boot)
        checkpoint.save_sharded(hpath, h, hcfg, m22, {"scan": cut})
        h = hector_from(m22, h, cut)
        res["ck_hector_full_maps"] = hs.unshard_maps(m22, h, hcfg).numpy()
        res["ck_hector_full_pose"] = h.match_pose.numpy()
        c = coreslam_sharded.init(m22, ccfg, traj[0], seed=CORESLAM_SEED)
        cstep = coreslam_sharded.make_step(m22, ccfg)
        for t in range(cut):
            c, _ = cstep(c, pts[t], valid[t], c.pose)
        checkpoint.save_sharded(cpath, c, ccfg, m22, {"scan": cut})
        c = coreslam_from(m22, c, cut)
        cd = coreslam_sharded.to_dense(m22, c)
        res["ck_coreslam_full_hole"] = cd.hole_map.numpy()
        res["ck_coreslam_full_pose"] = cd.pose.numpy()
    torch.distributed.barrier()
    like_h = hector.init(hcfg, (0.0, 0.0, 0.0), "cpu")
    like_c = coreslam.init(ccfg, (0.0, 0.0, 0.0), device="cpu")
    for name, m in (("2x2", m22), ("4x2", m42)):
        if not m.member:
            continue
        h = hector_from(m, checkpoint.restore_sharded(hpath, m, hcfg, like_h),
                        cut)
        res[f"ck_hector_{name}_maps"] = hs.unshard_maps(m, h, hcfg).numpy()
        res[f"ck_hector_{name}_pose"] = h.match_pose.numpy()
        c = coreslam_from(m, checkpoint.restore_sharded(cpath, m, ccfg,
                                                        like_c), cut)
        cd = coreslam_sharded.to_dense(m, c)
        res[f"ck_coreslam_{name}_hole"] = cd.hole_map.numpy()
        res[f"ck_coreslam_{name}_pose"] = cd.pose.numpy()
    _save(m42, out, res)
    return {"ok": True}


def bringup(out: str) -> dict:
    """The counterpart of ``tests/_multiproc_worker.py``: a world brought up
    by ``initialize_multihost`` from torchrun's environment; every rank
    simulates the scans and keeps only its own beam chunk; hector_sharded
    steps over a 2x2 mesh against the dense pipeline run on this rank."""
    from slamnet_tpu_torch.models import hector, hector_sharded as hs
    from slamnet_tpu_torch.parallel import (host_local_scans_to_global,
                                            initialize_multihost)
    from slamnet_tpu_torch.sim import (default_field, revolution_angles,
                                       scan_revolution)
    from slamnet_tpu_torch.core.config import SimConfig
    initialize_multihost(backend="gloo")
    torch.set_num_threads(1)
    m = make_mesh({"tile": 2, "search": 2}, "cpu")
    cfg = HectorConfig(map_resolution=40.0 / 128, map_size=128, num_levels=2,
                       estimate_iterations=(3, 2))
    sim, nb = SimConfig(), 256
    traj = np.stack([np.array([20.0 + 0.05 * t, 20.0, 0.0], np.float32)
                     for t in range(6)])
    angles = revolution_angles(nb)
    r, v = scan_revolution(default_field(device="cpu"),
                           torch.from_numpy(traj), torch.from_numpy(angles),
                           sim.max_scan_dist, sim.measure_error,
                           torch.Generator().manual_seed(9))
    a = torch.from_numpy(angles)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], -1)
    # ---- the dense pipeline on this rank, the same scans ------------------
    dense = hector.init(cfg, traj[0], "cpu")
    dense_poses, dense_boot = [], None
    for t in range(6):
        force = t < 4
        hint = torch.from_numpy(traj[t]) if force else dense.match_pose
        dense, _ = hector.update(dense, Scan(pts[t], v[t], torch.zeros(3)),
                                 hint, cfg, force)
        dense_poses.append(dense.match_pose.clone())
        if t == 3:
            dense_boot = dense.maps.clone()
    # ---- the sharded run: each rank feeds only its own beam chunk ---------
    lo, hi = hs.beam_range(m, nb)
    state = hs.init(m, cfg, traj[0])
    step = hs.make_step(m, cfg, nb)
    for t in range(6):
        force = t < 4
        if force:
            state = state._replace(match_pose=torch.from_numpy(traj[t]))
        X = host_local_scans_to_global(m, pts[t, lo:hi, 0], "search")
        Y = host_local_scans_to_global(m, pts[t, lo:hi, 1], "search")
        V = host_local_scans_to_global(m, v[t, lo:hi], "search")
        state, _ = step.local(state, X, Y, V, force)
        pose = state.match_pose
        if not bool(torch.isfinite(pose).all()):
            raise AssertionError(f"scan {t}: pose {pose}")
        if not force and not torch.allclose(pose, dense_poses[t], rtol=0,
                                            atol=1e-4):
            raise AssertionError(f"scan {t}: {pose} vs dense "
                                 f"{dense_poses[t]}")
        if t == 3:
            # after the forced updates: this rank's tile is the dense
            # pyramid's, bit for bit
            want = hs.shard_tiles_host(dense_boot, cfg, 2)[
                m.axis_index("tile")]
            if not torch.equal(state.local_maps, want):
                raise AssertionError("tile differs from the dense pyramid's")
    res = {"rank": m.rank, "beams": [lo, hi],
           "pose": state.match_pose.tolist(),
           "dense_pose": dense_poses[-1].tolist()}
    _save(m, out, {k: np.asarray(v) for k, v in res.items()})
    return res


# ----------------------------------------------------------- the launcher

def fail(bad_rank: int) -> dict:
    """Rank ``bad_rank`` raises; the others return."""
    if torch.distributed.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return {"ok": True}


def deadlock() -> dict:
    """Rank 0 waits in a collective that no other rank joins."""
    import time
    if torch.distributed.get_rank() == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        time.sleep(3600)
    return {"ok": True}


# ------------------------------------------------------------ Schur GN

def schur(data: str, out: str, cases: list) -> dict:
    """The cases of ``tests/test_torch_schur.py``: ``graph.schur`` over a
    'node' axis of all the world's ranks.  Each case (name, graph prefix in
    ``data``, sep_capacity, huber_delta, steps) writes the poses after each
    step, the overflow of each, and the collectives a step."""
    from slamnet_tpu_torch.graph import posegraph, schur as sch
    torch.set_num_threads(1)
    d = np.load(data)
    m = make_mesh({"node": torch.distributed.get_world_size()}, "cpu")
    res = {}
    for name, prefix, cap, huber, steps in cases:
        g = posegraph.PoseGraph(**{k: _t(d[f"{prefix}_{k}"])
                                   for k in posegraph.PoseGraph._fields})
        c0 = m.counts["collectives"]
        for i in range(steps):
            g, of = sch.schur_gn_step(m, g, sep_capacity=cap,
                                      huber_delta=huber)
            res[f"{name}_step{i + 1}"] = g.poses.numpy()
            res[f"{name}_overflow{i + 1}"] = of.numpy()
        res[f"{name}_collectives"] = np.asarray(
            (m.counts["collectives"] - c0) / steps)
    g = posegraph.PoseGraph(**{k: _t(d[f"{cases[0][1]}_{k}"])
                               for k in posegraph.PoseGraph._fields})
    og, worst = sch.schur_optimize(m, g, 3, sep_capacity=cases[0][2])
    res["optimize"], res["optimize_overflow"] = og.poses.numpy(), \
        worst.numpy()
    # every rank's poses are the same bits
    mine = torch.from_numpy(res[f"{cases[0][0]}_step1"]).reshape(-1)
    every = m.all_gather(mine, "node")
    res["ranks_equal"] = np.asarray(bool((every == every[0]).all()))
    _save(m, out, res)
    return {"ok": True}


# ------------------------------------------------------ sharded graph-SLAM

GRAPH_MESHES = (("2x4", {"tile": 2, "search": 4}),
                ("4x2", {"tile": 4, "search": 2}))


def graph_slam_sharded(data: str, out: str, hcfg: dict, gcfg: dict,
                       forced: int, cut: int, ckpt_dir: str) -> dict:
    """The cases of ``tests/test_torch_graph_slam_sharded.py``: the replay
    on 2x4 with a checkpoint at scan ``cut``, every rank's flags, the
    rebuild on 4x2 (from the replay's state and from JAX's), the JAX state
    carried in and stepped once, the checkpoint restored on 4x2."""
    from slamnet_tpu_torch import convert
    from slamnet_tpu_torch.core.config import PoseGraphConfig
    from slamnet_tpu_torch.io import checkpoint
    from slamnet_tpu_torch.models import graph_slam
    from slamnet_tpu_torch.models import graph_slam_sharded as gss
    from slamnet_tpu_torch.models import hector_sharded as hs
    torch.set_num_threads(1)
    d = np.load(data)
    hc = HectorConfig().overlay(_tuples(hcfg))
    gc = PoseGraphConfig().overlay(_tuples(gcfg))
    meshes = dict((n, make_mesh(a, "cpu")) for n, a in GRAPH_MESHES)
    world = make_mesh({"all": torch.distributed.get_world_size()}, "cpu")
    m24, m42 = meshes["2x4"], meshes["4x2"]
    traj, pts, valid = _t(d["traj"]), _t(d["pts"]), _t(d["valid"])
    nb = pts.shape[1]
    res = {}

    def gathered(m, st):
        return gss.to_dense(m, st, hc)

    # ---- the replay on 2x4, a checkpoint at `cut` ------------------------
    st = gss.init(m24, hc, gc, traj[0], nb)
    step = gss.make_step(m24, hc, gc, nb)
    poses, kf, loop, over = [], [], [], []
    c0 = dict(m24.counts)
    for t in range(traj.shape[0]):
        if t == cut:
            checkpoint.save_sharded(f"{ckpt_dir}/graph", st, hc, m24,
                                    {"scan": cut})
            res["cut_nodes"] = np.asarray(st.nodes)
            cut_dense = gathered(m24, st)
            res["cut_kf_points"] = cut_dense.kf_points.numpy()
            res["cut_poses"] = cut_dense.graph.poses.numpy()
            res["cut_maps"] = cut_dense.hector.maps.numpy()
        st, info = step(st, pts[t], valid[t], t < forced)
        poses.append(st.match_pose)
        kf.append(info.keyframe_added)
        loop.append(info.loop_closed)
        over.append(info.sep_overflow)
    res["poses"] = torch.stack(poses).numpy()
    res["kf"], res["loop"] = torch.stack(kf).numpy(), torch.stack(loop).numpy()
    res["overflow"] = torch.stack(over).numpy()
    res["syncs_searches"] = np.asarray([step.syncs, step.searches])
    res["replay_collectives"] = np.asarray(m24.counts["collectives"]
                                           - c0["collectives"])
    flags = torch.tensor(step.flags, dtype=torch.uint8).reshape(-1)
    res["flags_all"] = world.all_gather(flags, "all").numpy()
    dense = gathered(m24, st)
    res["nodes"] = np.asarray(st.nodes)
    res["kf_points"] = dense.kf_points.numpy()
    res["kf_valid"] = dense.kf_valid.numpy()
    for k in convert.GRAPH_FIELDS:
        res[f"graph_{k}"] = getattr(dense.graph, k).numpy()
    res["loop_count"] = dense.loop_count.numpy()
    res["maps"] = dense.hector.maps.numpy()
    # ---- the rebuild on 4x2, from this replay and from JAX's state --------
    for name, state in (
            ("own", dense),
            ("jax", convert.graph_state_from_numpy(
                {"hector": {"maps": d["jax_maps"],
                            "match_pose": d["jax_match_pose"],
                            "last_update_pose": d["jax_match_pose"]},
                 "graph": {k: d[f"jax_graph_{k}"]
                           for k in convert.GRAPH_FIELDS},
                 "kf_points": d["jax_kf_points"],
                 "kf_valid": d["jax_kf_valid"],
                 "last_kf_pose": d["jax_match_pose"],
                 "loop_count": d["jax_loop_count"]}, "cpu"))):
        loc = graph_slam.rebuild_maps_sharded(m42, gss.shard_dense(
            m42, state, hc), hc)
        res[f"rebuild_{name}"] = hs.unshard_tiles_host(
            m42.all_gather(loc, "tile"), hc).numpy()
        res[f"rebuild_{name}_tiles"] = m42.all_gather(loc, "tile").numpy()
    # ---- JAX's sharded state carried in, one step -------------------------
    arrays = {k: d[f"conv_{k}"] for k in ("local_maps", "match_pose",
                                          "last_update_pose", "kf_points",
                                          "kf_valid", "last_kf_pose",
                                          "loop_count")}
    arrays["graph"] = {k: d[f"conv_graph_{k}"] for k in convert.GRAPH_FIELDS}
    cst = convert.sharded_graph_state_from_numpy(arrays, m24)
    back = convert.sharded_graph_state_to_numpy(cst, m24)
    res["conv_back_ok"] = np.asarray(all(
        np.array_equal(back[k], arrays[k]) for k in arrays if k != "graph")
        and all(np.array_equal(back["graph"][k], arrays["graph"][k])
                for k in convert.GRAPH_FIELDS))
    q = int(d["conv_scan"])
    cst2, cinfo = gss.make_step(m24, hc, gc, nb)(cst, pts[q], valid[q],
                                                 q < forced)
    res["conv_pose"] = cst2.match_pose.numpy()
    res["conv_nodes"] = np.asarray([cst.nodes, cst2.nodes,
                                    int(cst2.graph.num_nodes)])
    res["conv_graph_poses"] = cst2.graph.poses.numpy()
    # ---- the checkpoint restored on 4x2 ----------------------------------
    like = graph_slam.init(hc, gc, (0.0, 0.0, 0.0), nb, "cpu")
    rst = checkpoint.restore_sharded(f"{ckpt_dir}/graph", m42, hc, like)
    rd = gathered(m42, rst)
    res["restored_kf_points"] = rd.kf_points.numpy()
    res["restored_poses"] = rd.graph.poses.numpy()
    res["restored_maps"] = rd.hector.maps.numpy()
    res["restored_nodes"] = np.asarray(rst.nodes)
    res["restored_shard"] = np.asarray(list(rst.kf_points.shape))
    _save(world, out, res)
    return {"ok": True}
