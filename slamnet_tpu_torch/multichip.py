"""``dryrun_multichip(n)`` on n cards: the port of ``__graft_entry__.py:74-200``.

    python -m slamnet_tpu_torch.multichip [--cards N] [--backend nccl|gloo]
        [--device cuda|cpu]

The defaults are ``--cards 4 --backend nccl --device cuda``: one rank a
card, rank r on ``cuda:r`` (gloo ranks beyond the cards share them
round-robin).  ``--backend gloo --device cpu`` runs the same
ranks on the CPU (the tests' rehearsal).  N is even and at least 2, as
JAX's.  The parent process computes the dense references on its own
device, then starts N ranks with ``parallel.launch(..., rendezvous="env")``
so that each brings its world up with ``initialize_multihost``, as under
``torchrun``.  Every rank runs, at JAX's shapes for N devices
(``replay.multichip_meshes(N)``: 2x(N/2), and 4x(N/4) when 4 divides N):

1. ``hector``: the sharded Hector (the ``fixed`` config, 400x400x3, 7/4/4)
   over the first ``replay.SHARDED_N`` scans of ``make_log(0)`` (10 forced,
   the rest matched) on each mesh: the forced maps equal the dense
   ``hector.update``'s bit for bit, the poses stay within 5e-3 m of the
   dense replay at every scan, the maps within 1e-2, the same map updates,
   ATE <= JAX's at N devices + 1e-4 (``SHARDED_JAX_REF_ATE_M``), 17
   collectives a scan.  The first mesh saves a checkpoint at scan 40, and
   replays ``SHORT_SCANS`` matched scans in ``onehot_bf16`` (within 5e-3 m
   of its gather run) and with the exit at ``EXIT_TOL_FIRES`` px (within
   5e-3 m of the dense exit replay, and the exit fires).  No K launch.
2. ``coreslam``: the production CoreSLAM (dense fills, no K launch) and
   the parity one (Monte-Carlo 4096, line updates: one K7 obstacle launch
   a scan) on the first mesh over ``SHARDED_CORESLAM_N`` scans, each bit
   for bit the dense pipeline's.
3. ``graph``: section 3 on the first mesh (``sharded_graph_config`` with
   16 keyframe slots a search shard), with the ``onehot_bf16`` + dense-fill
   frontend (K1 + K2 on every rank) and the ``gather`` one (K3 + K4):
   ``sharded_graph_gate`` against JAX at N devices, one K launch of each
   kind a loop search, every rank reading the same flags; the
   ``onehot_bf16`` run's state rebuilt on the last mesh
   (``rebuild_maps_sharded``) equals the serial ``rebuild_maps`` bit for
   bit.
4. ``fleet``: 64 robots over the search axis of ``{"search": N}``, rows
   ``sub4_pallas_dense`` (K5 + batched K2) and ``sub1`` (batched K3 + K4),
   every rank's robots bit for bit the single-process fleet's.
5. ``collectives``: every ``Mesh`` collective of both meshes against its
   definition, and the barrier; ``posegraph``: the edge-sharded GN against
   ``posegraph.optimize`` and the node-sharded Schur step against
   ``posegraph.gn_step``, and a loop-closure cluster's separator overflow
   at ``SEP_SMALL`` slots reported by the step and the host check;
   ``checkpoint``: section 1's checkpoint resumed on
   the first mesh bit for bit and on the second within section 1's
   tolerances, and section 3's (the ``onehot_bf16`` run at scan
   ``GRAPH_CUT``) resumed on the first mesh bit for bit and restored on the
   last equal to the saved state.
6. ``kernels``: K1-K5 on this rank's card against their plain versions at
   the graph frontend's 128-px grid and at a rank's 64/N fleet robots.

On a host of several cards the parent first replays ``pallas_dense`` (K1
+ K2) and ``fixed`` (K3 + K4) on the last card with ``cuda:0`` current,
bit for bit the same replays on ``cuda:0`` (a caller's ``device="cuda:1"``).
On the card rank 0 also traces one scan of section 1 and one keyframe
event of section 3 (``io.metrics.device_trace``): the NCCL kernels' count
and device time, the kernels, the busy time and the wall of each.  The run
fails unless rank r ran on ``cuda:r``, every check held and, under NCCL,
no collective staged a tensor through the host and each rank launched
K1-K5 as its sections call them.  Its lines go to stdout; the last but one
is the results as JSON, the last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType

from . import replay
from .core.geometry import pose_between
from .core.scan import Scan
from .graph import distributed, frontend, posegraph, schur
from .io import checkpoint, metrics
from .models import coreslam_sharded, fleet, graph_slam, hector
from .models import graph_slam_sharded as gss
from .models import hector_sharded as hs
from .ops import _build, fill, line, match
from .parallel import initialize_multihost, launch, make_mesh, mesh
from .parallel import shard_range
from .parallel.mesh import local_rank

SECTIONS = ("collectives", "hector", "coreslam", "graph", "fleet",
            "posegraph", "checkpoint", "kernels")
POSE_TOL = 5e-3           # JAX's sharded-vs-dense tolerances
MAP_TOL = 1e-2            # (tests/test_hector_sharded.py:215-219)
ATE_SLACK = 1e-4          # above JAX's ATE at the same device count
GRAPH_TOL = 1e-4          # tests/test_posegraph.py:155's rtol and atol
SCHUR_NODES = 128         # the circle graph of tests/test_posegraph.py
SCHUR_CAP = 8             # separator slots a rank
SCHUR_TOLS = (2e-4, 5e-4)  # after one and two steps (test_posegraph.py:113-122)
SEP_SMALL = 2             # slots the loop-closure cluster overflows
HECTOR_CUT = 40           # the checkpoint: after this many scans (half way
                          # through the matched scans of a shorter run)
SHORT_SCANS = 10          # matched scans of the onehot_bf16 and exit runs
EXIT_TOL_FIRES = 0.3      # px: a tolerance at which every match exits early
GRAPH_CUT = 36            # section 3's checkpoint (half way, if shorter)
K1_POSE_TOL = 2e-3        # K1's bf16 table against its plain version
K3_POSE_TOL = 1e-5        # K3's f32 table: the order of the beam sums
FILL_DIFF_SHARE = 1e-3    # K2: cells that may differ, each by |log_odds_free|
FLEET_MODES = {"sub4_pallas_dense": ("K5", "K2_batch"),
               "sub1": ("K3_batch", "K4_batch")}
FRONTEND_MODES = {"onehot_bf16": ("K1", "K2"), "gather": ("K3", "K4")}
REPS = 20
TIMEOUT_S = 900.0


class CheckFailed(RuntimeError):
    """A check of the dry run did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def check_launches(what: str, dev, want: dict) -> dict:
    """Raise unless this process launched exactly ``want`` (kernel key:
    count, ``ops/_build.KERNELS``) on the card and nothing else; the plain
    versions on the CPU launch nothing.  Returns the counts launched."""
    got = _build.kernel_launches()
    expect = dict.fromkeys(got, 0)
    if dev.type == "cuda":
        expect.update(want)
    check(got == expect, f"{what}: launches {got}, want {expect}")
    return {k: v for k, v in got.items() if v}


def busy_us(kernels) -> float:
    """The union of the kernel events' intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def traced(fn, sync, log_dir: str) -> dict:
    """``fn()`` once under ``io.metrics.device_trace``: the wall (host clock
    to the card's end), the kernels, their busy time, and the NCCL kernels'
    count, device time and names."""
    with metrics.device_trace(log_dir) as tr:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    # ProcessGroupNCCL's "nccl:<op>" ranges lie on the card's timeline too,
    # each around its kernel: annotations, not kernels
    kernels = [e for e in tr.prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("nccl:")]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    by_name = {}
    for e in nccl:
        name = e.name.split("(")[0]
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e.time_range.elapsed_us())
    return {"wall_ms": wall * 1e3, "kernels": len(kernels),
            "busy_us": busy_us(kernels), "nccl_kernels": len(nccl),
            "nccl_us": sum(e.time_range.elapsed_us() for e in nccl),
            "nccl_by_name": by_name}


# ------------------------------------------------------------ the ranks
def rank_main(ref: str, work: str, backend: str, device: str | None,
              hector_scans: int, coreslam_scans: int, graph_scans: int,
              sections: list, timeout_s: float) -> dict:
    """One rank of the dry run (``parallel.launch`` starts N of them with
    the env rendezvous): bring the world up, build every mesh, run the
    sections; any failed check raises, which fails the launch.  Returns
    this rank's device and counts, and on rank 0 the numbers."""
    if device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(backend, timeout_s)
    n_ranks = dist.get_world_size()
    meshes = {name: make_mesh(axes, device)
              for name, axes in replay.multichip_meshes(n_ranks).items()}
    names = list(meshes)
    m1 = meshes[names[0]]
    searchm = make_mesh({"search": n_ranks}, device)
    edge = make_mesh({"edge": n_ranks}, device)
    node = make_mesh({"node": n_ranks}, device)
    every = (*meshes.values(), searchm, edge, node)
    dev, rank = m1.device, m1.rank
    if dev.type == "cuda":
        check(dev == torch.device("cuda", local_rank()
                                  % torch.cuda.device_count())
              and torch.cuda.current_device() == dev.index,
              f"rank {rank} computes on {dev}, current device "
              f"{torch.cuda.current_device()}, LOCAL_RANK {local_rank()}")
    R = dict(np.load(f"{ref}/ref.npz"))
    res = {"rank": rank, "device": str(dev), "backend": m1.backend,
           "launches": {}, "kernel_errors": {}}
    num = {}                                    # rank 0's numbers

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def all_ranks(x: float) -> list:
        return edge.all_gather(torch.tensor([float(x)], device=dev), "edge",
                               tiled=True).tolist()

    def timed(fn, reps: int = REPS) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps

    # ---- every collective against its definition, and the barrier -------
    if "collectives" in sections:
        coll = {}
        for name, m in meshes.items():
            T, S = m.shape["tile"], m.shape["search"]
            t, s = m.coords["tile"], m.coords["search"]
            x = torch.arange(4, dtype=torch.float32, device=dev) * 10 + rank

            def xs(ranks):
                return torch.stack([torch.arange(4, dtype=torch.float32) * 10
                                    + q for q in ranks])
            lines = {"tile": [u * S + s for u in range(T)],
                     "search": [t * S + v for v in range(S)],
                     "both": list(range(m.size))}
            ops = {}
            for key, ranks in lines.items():
                axes = ("tile", "search") if key == "both" else key
                v = xs(ranks)
                ops[f"psum {key}"] = (lambda m=m, a=axes: m.psum(x, a),
                                      v.sum(0))
                ops[f"pmax {key}"] = (lambda m=m, a=axes: m.pmax(x, a),
                                      v.max(0).values)
                ops[f"pmin {key}"] = (lambda m=m, a=axes: m.pmin(-x, a),
                                      (-v).min(0).values)
            for axis in ("tile", "search"):
                ranks = lines[axis]
                i, k = ranks.index(rank), len(ranks)
                ops[f"all_gather {axis}"] = (
                    lambda m=m, a=axis: m.all_gather(x, a, tiled=True),
                    xs(ranks).reshape(-1))
                ops[f"ppermute {axis}"] = (
                    lambda m=m, a=axis, k=k: m.ppermute(
                        x, a, [(j, j - 1) for j in range(1, k)]),
                    xs([ranks[i + 1]])[0] if i + 1 < k else torch.zeros(4))
            for op, (fn, want) in ops.items():
                got = fn().cpu()
                check(torch.equal(got, want), f"{name} {op} on rank {rank}: "
                      f"{got.tolist()}, want {want.tolist()}")
                coll[f"{name} {op}"] = timed(fn) * 1e6
            m.barrier()
        num["collective_us"] = coll

    # ---- 1, 1b. sharded Hector on both meshes; the checkpoint -----------
    log = replay.make_log(0)
    boot = log.bootstrap
    cfg = replay.fixed_config()
    n = hector_scans
    cut = HECTOR_CUT if n > HECTOR_CUT else (boot + n) // 2
    dlog = replay.head(replay.to_device(log, dev), n)
    final = {}
    if "hector" in sections:
        per_scan = sum(cfg.estimate_iterations) + 2
        ref_poses = torch.from_numpy(R["h_poses"]).to(dev)
        ref_maps = torch.from_numpy(R["h_maps"]).to(dev)
        boot_maps = torch.from_numpy(R["h_boot_maps"]).to(dev)
        hec = {}
        _build.reset_launches()
        for name, m in meshes.items():
            st, _ = replay.sharded_replay(m, replay.head(dlog, boot), cfg)
            check(torch.equal(hs.unshard_maps(m, st, cfg), boot_maps),
                  f"{name}: the forced updates' maps differ from "
                  "hector.update's")
            c0 = dict(m.counts)
            save_s, saved = 0.0, dict.fromkeys(c0, 0)
            sync()
            t0 = time.perf_counter()
            if m is m1 and boot < cut < n:
                st, o1 = replay.sharded_replay(
                    m, replay.head(dlog, cut), cfg, state=st, start=boot)
                sync()
                t_cut, c_cut = time.perf_counter(), dict(m.counts)
                checkpoint.save_sharded(f"{work}/hector", st, cfg, m,
                                        {"scan": cut})
                save_s = time.perf_counter() - t_cut
                saved = {k: m.counts[k] - c_cut[k] for k in c_cut}
                st, o2 = replay.sharded_replay(m, dlog, cfg, state=st,
                                               start=cut)
                poses = torch.cat([o1.poses, o2.poses])
                upd = torch.cat([o1.map_updated, o2.map_updated])
                iters = torch.cat([o1.gn_iterations, o2.gn_iterations])
            else:
                st, o = replay.sharded_replay(m, dlog, cfg, state=st,
                                              start=boot)
                poses, upd, iters = o.poses, o.map_updated, o.gn_iterations
            sync()
            wall = time.perf_counter() - t0 - save_s
            scans = n - boot
            per = {k: (m.counts[k] - c0[k] - saved[k]) / scans for k in c0}
            maps = hs.unshard_maps(m, st, cfg)
            final[name] = (st, maps, poses)
            perr = float((poses - ref_poses).abs().max())
            merr = float((maps - ref_maps).abs().max())
            nupd = int(upd.sum())
            ate, mx = replay.ate_of(poses.cpu().numpy(), log.traj[boot:n])
            ref_ate = (replay.SHARDED_JAX_REF_ATE_M.get(name)
                       if n == replay.SHARDED_N else None)
            check(perr <= POSE_TOL, f"{name}: poses {perr} m from the dense "
                  f"replay's (tol {POSE_TOL})")
            check(merr <= MAP_TOL, f"{name}: maps {merr} from the dense "
                  f"replay's (tol {MAP_TOL})")
            check(nupd == int(R["h_updates"]), f"{name}: {nupd} map updates,"
                  f" dense {int(R['h_updates'])}")
            check(ref_ate is None or ate <= ref_ate + ATE_SLACK,
                  f"{name}: ATE {ate} above JAX's {ref_ate} + {ATE_SLACK}")
            check(per["collectives"] == per_scan, f"{name}: "
                  f"{per['collectives']} collectives a scan, want {per_scan}")
            check(int(iters.sum()) == scans * sum(cfg.estimate_iterations),
                  f"{name}: GN iterations {int(iters.sum())}")
            hec[name] = {"ate_m": ate, "max_err_m": mx, "pose_err_m": perr,
                         "map_err": merr, "map_updates": nupd,
                         "jax_ref_ate_m": ref_ate, "scans": scans,
                         "scans_per_s": scans / wall,
                         "wall_ms_per_scan": wall / scans * 1e3,
                         "rank_scans_per_s": all_ranks(scans / wall),
                         "collectives_per_scan": per["collectives"],
                         "host_copies_per_scan": per["host_copies"],
                         "checkpoint_s": save_s,
                         "poses": poses.cpu().tolist()}
        # the first mesh in onehot_bf16 and with the exit at EXIT_TOL_FIRES
        # px, each from its own forced scans
        short = min(SHORT_SCANS, n - boot)
        modes = {}
        for mode, c, want in (
                ("onehot_bf16", cfg.overlay({"matcher_mode": "onehot_bf16"}),
                 final[names[0]][2][:short]),
                ("exit", cfg.overlay({"early_exit_tol": EXIT_TOL_FIRES}),
                 torch.from_numpy(R["x_poses"]).to(dev))):
            st, _ = replay.sharded_replay(m1, replay.head(dlog, boot), c)
            check(torch.equal(hs.unshard_maps(m1, st, c), boot_maps),
                  f"{mode}: the forced updates' maps differ")
            st, o = replay.sharded_replay(m1, replay.head(dlog, boot + short),
                                          c, state=st, start=boot)
            err = float((o.poses - want).abs().max())
            check(err <= POSE_TOL, f"{mode}: poses {err} m off (tol "
                  f"{POSE_TOL})")
            its = int(o.gn_iterations.sum())
            check(mode != "exit" or its < short * sum(cfg.estimate_iterations),
                  f"the exit at {EXIT_TOL_FIRES} px never fired ({its})")
            modes[mode] = {"scans": short, "pose_err_m": err,
                           "gn_iterations": its}
        modes["exit"]["dense_gn_iterations"] = int(R["x_iters"])
        hec[names[0]]["modes"] = modes
        # the sharded step runs its own tile-local GN: no K kernel
        res["launches"]["hector"] = check_launches("sharded Hector", dev, {})
        num["hector"] = hec

    # ---- 2. sharded CoreSLAM, production and parity, = the dense ---------
    if "coreslam" in sections:
        s_ax = m1.shape["search"]
        cl = replay.head(dlog, coreslam_scans)
        core = {}
        for mode, c, kernels in (
                ("production", replay.coreslam_production_config(), {}),
                ("parity", replay.coreslam_parity_config(),
                 {"K7_obstacle": coreslam_scans})):
            check(c.search_mode != "correlative"
                  or c.corr_num_theta % s_ax == 0, f"corr_num_theta "
                  f"{c.corr_num_theta} does not divide over {s_ax} search "
                  "shards")
            _build.reset_launches()
            sync()
            t0 = time.perf_counter()
            st, o = replay.sharded_coreslam_replay(m1, cl, c, seed=1)
            sync()
            wall = time.perf_counter() - t0
            # the line hole update runs sharded in PyTorch; the obstacle
            # map's line update is K7's obstacle launch, one a scan
            res["launches"][f"coreslam_{mode}"] = check_launches(
                f"CoreSLAM {mode} rank {rank}", dev, kernels)
            dense = coreslam_sharded.to_dense(m1, st)
            for key, got in (("poses", o.poses), ("sums", o.best_sum),
                             ("hole", dense.hole_map),
                             ("obst", dense.obstacle_map)):
                check(torch.equal(got.cpu(),
                                  torch.from_numpy(R[f"c_{mode}_{key}"])),
                      f"CoreSLAM {mode}: the {key} differ from the dense "
                      "pipeline's")
            core[mode] = {"ate_m": replay.ate_of(o.poses.cpu().numpy(),
                                                 log.traj[:coreslam_scans])[0],
                          "scans": coreslam_scans,
                          "scans_per_s": coreslam_scans / wall}
        core["production"]["jax_ref_ate_m"] = (
            replay.SHARDED_CORESLAM_JAX_REF_ATES_M.get(names[0])
            if coreslam_scans == replay.SHARDED_CORESLAM_N else None)
        num["coreslam"] = core

    # ---- 3. the sharded graph on the first mesh, both frontends; the ----
    # rebuild on the last mesh; the onehot_bf16 run's checkpoint
    glog = replay.make_sharded_graph_log()
    gdlog = replay.head(replay.to_device(glog, dev), graph_scans)
    nb = gdlog.points.shape[1]
    gcut = GRAPH_CUT if graph_scans > GRAPH_CUT else graph_scans // 2
    gsave = ("checkpoint" in sections
             and replay.SHARDED_GRAPH_FORCED < gcut < graph_scans)
    gfinal = {}
    if "graph" in sections:
        runs = {}
        for mode, kernels in FRONTEND_MODES.items():
            hcfg, gcfg, mcfg, cap = replay.sharded_graph_config(
                mode, m1.shape["search"])
            step = gss.make_step(m1, hcfg, gcfg, nb, mcfg, sep_capacity=cap)
            _build.reset_launches()
            c0 = dict(m1.counts)
            save_s, saved = 0.0, dict.fromkeys(c0, 0)
            sync()
            t0 = time.perf_counter()
            if mode == "onehot_bf16" and gsave:
                st, o1 = replay.sharded_graph_replay(
                    m1, replay.head(gdlog, gcut), hcfg, gcfg, mcfg, cap,
                    step=step)
                sync()
                t_cut, c_cut = time.perf_counter(), dict(m1.counts)
                checkpoint.save_sharded(f"{work}/graph", st, hcfg, m1,
                                        {"scan": gcut})
                save_s = time.perf_counter() - t_cut
                saved = {k: m1.counts[k] - c_cut[k] for k in c_cut}
                st, o2 = replay.sharded_graph_replay(
                    m1, gdlog, hcfg, gcfg, mcfg, cap, state=st, start=gcut,
                    step=step)
                out = type(o1)(*(np.concatenate([a, b])
                                 if isinstance(a, np.ndarray)
                                 else torch.cat([a, b])
                                 for a, b in zip(o1, o2)))
            else:
                st, out = replay.sharded_graph_replay(
                    m1, gdlog, hcfg, gcfg, mcfg, cap, step=step)
            sync()
            wall = time.perf_counter() - t0 - save_s
            res["launches"][f"graph_{mode}"] = check_launches(
                f"{mode} frontend rank {rank}", dev,
                dict.fromkeys(kernels, step.searches))
            got = replay.sharded_graph_metrics(st, out,
                                               glog.traj[:graph_scans])
            if graph_scans == glog.traj.shape[0]:
                check(not graph_fails(got, mode, names[0]),
                      f"sharded graph ({mode} frontend) on {names[0]}: "
                      f"{graph_fails(got, mode, names[0])}")
            check(got["max_overflow"] == 0,
                  f"{mode}: separator overflow {got['max_overflow']}")
            flags = torch.from_numpy(out.flags.astype(np.uint8)).reshape(-1)
            seen = edge.all_gather(flags.to(dev), "edge").cpu()
            check(bool((seen == seen[:1]).all()), f"{mode}: the ranks read "
                  "different due / has_cand / looped flags")
            events = int(out.flags[:, 0].sum())
            per_scan = sum(hcfg.estimate_iterations) + 2
            coll = (m1.counts["collectives"] - c0["collectives"]
                    - saved["collectives"])
            per_event = (coll - graph_scans * per_scan) / max(events, 1)
            # an event adds the cloud's psum and 3 Schur steps x 3; one that
            # finds every keyframe slot full only the Schur steps (node 0
            # is the initial keyframe, no event's)
            room = got["keyframes"] - 1
            check(coll - graph_scans * per_scan
                  == 10 * room + 9 * (events - room), f"{mode}: "
                  f"{per_event} collectives a keyframe event ({events} "
                  f"events, {room} with a free slot)")
            runs[mode] = {**got, "scans": graph_scans, "mesh": names[0],
                          "jax_fails_own_check":
                              jax_fails_own_check(mode, names[0]),
                          "scans_per_s": graph_scans / wall,
                          "rank_scans_per_s": all_ranks(graph_scans / wall),
                          "keyframe_events": events,
                          "searches": step.searches,
                          "host_reads": step.syncs,
                          "collectives_per_keyframe_event": per_event,
                          "host_copies_per_scan":
                              (m1.counts["host_copies"] - c0["host_copies"]
                               - saved["host_copies"]) / graph_scans,
                          "flags": out.flags.tolist(),
                          "poses": out.poses.cpu().tolist()}
            gfinal[mode] = (st, out)
        # the onehot_bf16 run's state rebuilt on the last mesh = the serial
        # rebuild_maps, halos included (one K4 a keyframe slot, each rank)
        hcfg = replay.sharded_graph_config("onehot_bf16",
                                           m1.shape["search"])[0]
        mr = meshes[names[-1]]
        dense = gss.to_dense(m1, gfinal["onehot_bf16"][0], hcfg)
        _build.reset_launches()
        tiles_ = mr.all_gather(graph_slam.rebuild_maps_sharded(
            mr, gss.shard_dense(mr, dense, hcfg), hcfg), "tile")
        serial = graph_slam.rebuild_maps(dense, hcfg)
        sync()
        res["launches"]["graph_rebuild"] = check_launches(
            f"the serial rebuild rank {rank}", dev,
            {"K4": dense.kf_points.shape[0]})
        check(torch.equal(hs.unshard_tiles_host(tiles_, hcfg), serial)
              and torch.equal(tiles_, hs.shard_tiles_host(
                  serial, hcfg, mr.shape["tile"])),
              f"rebuild_maps_sharded on {names[-1]} differs from rebuild_maps")
        runs["onehot_bf16"]["rebuild"] = {"mesh": names[-1],
                                          "nodes": dense.nodes}
        num["graph"] = runs

    # ---- 4. the fleet over the search axis: K5/K2, K3/K4 a rank ---------
    flog = replay.make_fleet_log(log)
    fb, fn_ = flog.radii.shape[1], flog.radii.shape[0]
    lo, hi = shard_range(fb, searchm, "search")
    if "fleet" in sections:
        fdlog = replay.to_device(flog, dev)
        pts, val = fdlog.points[:, lo:hi], fdlog.valid[:, lo:hi]
        truth = fdlog.traj[:, lo:hi]
        fl = {}
        for mode, kernels in FLEET_MODES.items():
            c = replay.FLEET_MODES[mode]()
            st = fleet.shard_fleet(searchm,
                                   fleet.init_fleet(c, flog.traj[0], dev), c)
            step = fleet.make_fleet_step(searchm, c)
            rep = fleet.make_fleet_replay(searchm, c)
            _build.reset_launches()
            sync()
            t0 = time.perf_counter()
            for t in range(boot):
                st = st._replace(match_pose=truth[t].clone())
                st, _ = step(st, pts[t], val[t], True)
            stf, poses = rep(st, pts[boot:], val[boot:])
            sync()
            wall = time.perf_counter() - t0
            res["launches"][f"fleet_{mode}"] = check_launches(
                f"{mode} rank {rank}", dev, dict.fromkeys(kernels, fn_))
            cells = c.total_cells
            rposes = np.load(f"{ref}/fleet_{mode}_poses.npy")[:, lo:hi]
            rmaps = np.load(f"{ref}/fleet_{mode}_maps.npy",
                            mmap_mode="r")[lo * cells:hi * cells]
            check(np.array_equal(poses.cpu().numpy(), rposes)
                  and np.array_equal(stf.maps.cpu().numpy(), rmaps),
                  f"{mode} rank {rank}: robots {lo}-{hi} differ from the "
                  "single-process fleet's")
            fl[mode] = {"robots_a_rank": hi - lo, "batch_scans": fn_,
                        "rank_instance_scans_per_s":
                            all_ranks((hi - lo) * fn_ / wall)}
        num["fleet"] = fl

    # ---- 5. the edge-sharded GN and the node-sharded Schur step ---------
    if "posegraph" in sections:
        g = replay.circle_graph(dev)
        dense_g = posegraph.optimize(g, 3, num_nodes=24)
        sync()
        t0 = time.perf_counter()
        shard_g = distributed.sharded_optimize(edge, g, 3)
        sync()
        gwall = time.perf_counter() - t0
        diff = (shard_g.poses - dense_g.poses).abs()
        check(bool((diff <= GRAPH_TOL + GRAPH_TOL
                    * dense_g.poses.abs()).all()),
              f"sharded_optimize {float(diff.max())} from posegraph.optimize "
              f"(rtol/atol {GRAPH_TOL})")
        gs = replay.circle_graph(dev, SCHUR_NODES, SCHUR_NODES, 256)
        c0 = node.counts["collectives"]
        g1, of1 = schur.schur_gn_step(node, gs, sep_capacity=SCHUR_CAP)
        g2, of2 = schur.schur_gn_step(node, g1, sep_capacity=SCHUR_CAP)
        per_step = (node.counts["collectives"] - c0) / 2
        d1 = posegraph.gn_step(gs, num_nodes=SCHUR_NODES)
        d2 = posegraph.gn_step(d1, num_nodes=SCHUR_NODES)
        errs = []
        for got, want, tol in ((g1, d1, SCHUR_TOLS[0]),
                               (g2, d2, SCHUR_TOLS[1])):
            e = (got.poses - want.poses).abs()
            errs.append(float(e.max()))
            check(bool((e <= tol + tol * want.poses.abs()).all()),
                  f"schur_gn_step {errs[-1]} from posegraph.gn_step "
                  f"(rtol/atol {tol})")
        check(int(of1) == int(of2) == 0, f"Schur overflow {int(of1)}, "
              f"{int(of2)} at {SCHUR_CAP} slots")
        check(per_step == 3, f"{per_step} collectives a Schur step, want 3")
        # too many separators for SEP_SMALL slots: the step reports the
        # overflow, as the host check says; with a rank's nodes as slots none
        cg = cluster_graph(dev, n_ranks)
        big = max(16, cg.poses.shape[0] // n_ranks)
        fits = schur.check_separator_capacity(cg, n_ranks, SEP_SMALL)
        _, of_small = schur.schur_gn_step(node, cg, sep_capacity=SEP_SMALL)
        _, of_big = schur.schur_gn_step(node, cg, sep_capacity=big)
        check(not fits and int(of_small) > 0 and int(of_big) == 0
              and schur.check_separator_capacity(cg, n_ranks, big),
              f"the cluster graph's overflow at {SEP_SMALL} slots is "
              f"{int(of_small)} (the host check: fits {fits}), at {big} "
              f"{int(of_big)}")
        step_s = timed(lambda: schur.schur_gn_step(node, gs,
                                                   sep_capacity=SCHUR_CAP),
                       10)
        num["posegraph"] = {"edge_max_abs_err": float(diff.max()),
                            "edge_ms_per_step": gwall / 3 * 1e3,
                            "schur_err_step1": errs[0],
                            "schur_err_step2": errs[1],
                            "schur_collectives_per_step": per_step,
                            "cluster_overflow_small": int(of_small),
                            "cluster_slots_big": big,
                            "schur_ms_per_step": step_s * 1e3,
                            "rank_schur_ms_per_step": all_ranks(step_s * 1e3)}

    # ---- 5. the checkpoint: resumed on both meshes ----------------------
    if "checkpoint" in sections and "hector" in sections and boot < cut < n:
        like = hector.init(cfg, (0.0, 0.0, 0.0), dev)
        ref_poses = torch.from_numpy(R["h_poses"]).to(dev)
        ref_maps = torch.from_numpy(R["h_maps"]).to(dev)
        k = cut - boot
        ck = {}
        for name, m in meshes.items():
            st = checkpoint.restore_sharded(f"{work}/hector", m, cfg, like)
            st, o = replay.sharded_replay(m, dlog, cfg, state=st, start=cut)
            maps = hs.unshard_maps(m, st, cfg)
            same = (torch.equal(maps, final[name][1])
                    and torch.equal(o.poses, final[name][2][k:]))
            if m is m1:
                check(same, f"the resume at {name} differs from the "
                      "uninterrupted replay")
            perr = float((o.poses - ref_poses[k:]).abs().max())
            merr = float((maps - ref_maps).abs().max())
            check(perr <= POSE_TOL and merr <= MAP_TOL,
                  f"the resume at {name}: poses {perr}, maps {merr} from the"
                  " dense replay's")
            ck[name] = {"pose_err_m": perr, "map_err": merr,
                        "bit_for_bit": same}
        num["checkpoint"] = {"cut": cut, "saved_on": names[0], **ck}

    # ---- 5. section 3's checkpoint: resumed on the first mesh, restored --
    # on the last
    if "graph" in sections and gsave:
        hcfg, gcfg, mcfg, cap = replay.sharded_graph_config(
            "onehot_bf16", m1.shape["search"])
        st_b, out_b = gfinal["onehot_bf16"]
        like = graph_slam.init(hcfg, gcfg, (0.0, 0.0, 0.0), nb, dev)
        st_r, out_r = replay.sharded_graph_replay(
            m1, gdlog, hcfg, gcfg, mcfg, cap, state=checkpoint.restore_sharded(
                f"{work}/graph", m1, hcfg, like), start=gcut)
        check(torch.equal(out_r.poses, out_b.poses[gcut:])
              and torch.equal(st_r.local_maps, st_b.local_maps)
              and torch.equal(st_r.graph.poses, st_b.graph.poses)
              and torch.equal(st_r.kf_points, st_b.kf_points)
              and st_r.nodes == st_b.nodes, f"section 3's resume at "
              f"{names[0]} differs from the uninterrupted replay")
        saved_st = checkpoint.restore(f"{work}/graph", like)
        mr = meshes[names[-1]]
        back = gss.to_dense(mr, checkpoint.restore_sharded(
            f"{work}/graph", mr, hcfg, like), hcfg)
        check(torch.equal(back.hector.maps, saved_st.hector.maps)
              and torch.equal(back.kf_points, saved_st.kf_points)
              and torch.equal(back.kf_valid, saved_st.kf_valid)
              and torch.equal(back.graph.poses, saved_st.graph.poses)
              and back.nodes == saved_st.nodes, f"section 3's checkpoint "
              f"restored on {names[-1]} differs from the saved state")
        num.setdefault("checkpoint", {})["graph"] = {
            "cut": gcut, "saved_on": names[0], "restored_on": names[-1],
            "nodes_at_cut": saved_st.nodes}

    # ---- 4 (the trace). one scan of 1 and one keyframe event of 3 -------
    if dev.type == "cuda" and "hector" in sections and "graph" in sections:
        tr = {}
        st = final[names[0]][0]
        hstep = hs.make_step(m1, cfg, dlog.points.shape[1])
        q = n - 1

        def one_scan():
            hstep(st, dlog.points[q], dlog.valid[q], False)
        one_scan()                              # warm
        sync()
        tr["hector_scan"] = (traced(one_scan, sync, f"{work}/trace_h")
                             if rank == 0 else one_scan() or {})
        # the first keyframe event with a loop search (every rank read the
        # same flags), replayed to from a fresh state
        flags = np.asarray(num["graph"]["onehot_bf16"]["flags"])
        e = int(np.flatnonzero(flags[:, 1])[0])
        hcfg, gcfg, mcfg, cap = replay.sharded_graph_config(
            "onehot_bf16", m1.shape["search"])
        gstep = gss.make_step(m1, hcfg, gcfg, nb, mcfg, sep_capacity=cap)
        gst, _ = replay.sharded_graph_replay(
            m1, replay.head(gdlog, e), hcfg, gcfg, mcfg, cap, step=gstep)
        sync()
        box = {}

        def one_event():
            box["st"], box["info"] = gstep(
                gst, gdlog.points[e], gdlog.valid[e],
                e < replay.SHARDED_GRAPH_FORCED)
        tr["graph_event"] = (traced(one_event, sync, f"{work}/trace_g")
                             if rank == 0 else one_event() or {})
        check(bool(gstep.flags[-1][0]) and bool(gstep.flags[-1][1]),
              f"the traced scan {e} was no keyframe event with a search")
        if rank == 0:
            tr["graph_event"]["scan"] = int(e)
            num["trace"] = tr

    # ---- 6. K1-K5 on this rank's card against their plain versions ------
    if "kernels" in sections and dev.type == "cuda":
        _build.reset_launches()
        res["kernel_errors"] = kernel_checks(dev, glog, flog, lo, hi, boot)
        res["launches"]["kernels"] = {
            k: v for k, v in _build.kernel_launches().items() if v}

    res["counts"] = {m_name: dict(m.counts) for m_name, m in
                     zip((*names, "search", "edge", "node"), every)}
    if rank == 0:
        res["numbers"] = num
    return res


def cluster_graph(dev, n_ranks: int, n: int = 64):
    """tests/test_posegraph.py's loop-closure cluster: the ``n``-node circle
    with every node of the first rank's block tied to its twin half a turn
    on (every node of the block a separator)."""
    g = replay.circle_graph(dev, n, n, 256)
    ths = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = torch.tensor(np.stack([5.0 * np.cos(ths), 5.0 * np.sin(ths),
                                   ths + np.pi / 2], -1), dtype=torch.float32)
    for t in range(n // n_ranks):
        g = posegraph.add_edge(g, t, t + n // 2, pose_between(
            truth[t], truth[t + n // 2]).to(dev), (10.0, 10.0, 40.0))
    return g


def jax_fails_own_check(mode: str, mesh: str) -> bool:
    """Whether JAX's section 3 on ``mesh`` misses its own final-error check
    (``__graft_entry__.py:193-198``): on 2x1 its 16 keyframe slots fill up,
    so ``dryrun_multichip(2)`` fails there."""
    try:
        return replay.sharded_graph_reference(mode, mesh)["final_err_m"] >= 0.5
    except KeyError:
        return False


def graph_fails(got: dict, mode: str, mesh: str) -> list:
    """Section 3's gate on ``mesh``: ``replay.sharded_graph_gate`` against
    JAX's numbers on that mesh; where JAX's own run fails its final-error
    check (``jax_fails_own_check``) only ``replay.graph_gate`` against
    them, parity with a failing reference (the report says so); where JAX
    has no numbers, JAX's own checks (``__graft_entry__.py:193-198``)."""
    try:
        ref = replay.sharded_graph_reference(mode, mesh)
    except KeyError:
        return [] if got["loop_closures"] >= 1 and got["final_err_m"] < 0.5 \
            and got["max_overflow"] == 0 else [got]
    if not jax_fails_own_check(mode, mesh):
        return replay.sharded_graph_gate(got, ref)
    return replay.graph_gate(got, ref)


def kernel_checks(dev, glog, flog, lo: int, hi: int, boot: int) -> dict:
    """K1-K4 at the graph frontend's 128-px grid (scan 7 of section 3's log
    rasterized, scan 8 matched from a hint off its true relative pose) and
    K5, batched K2, K3 and K4 at this rank's fleet robots (bootstrapped on
    this card), each against its plain version on the same inputs.  Any
    disagreement raises.  Returns each kernel's largest error."""
    out = {}
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    gd = replay.to_device(glog, dev)
    ref_scan = Scan(gd.points[7].contiguous(), gd.valid[7].contiguous(), zero3)
    q_scan = Scan(gd.points[8].contiguous(), gd.valid[8].contiguous(), zero3)
    rel = pose_between(gd.traj[7], gd.traj[8])
    for name, mcfg, tol in (
            ("K3", frontend.ScanMatchConfig(), K3_POSE_TOL),
            ("K1", frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                            dense_fill=True), K1_POSE_TOL)):
        hc = frontend.grid_config(mcfg)
        grid = frontend.rasterize_scan(ref_scan, mcfg)
        plain = frontend.rasterize_scan(ref_scan, mcfg, plain=True)
        if mcfg.dense_fill:               # K2: a few cells off by |lof|
            diff = grid != plain
            gap = (grid[diff] - plain[diff]).abs()
            share = float(diff.float().mean())
            check(share <= FILL_DIFF_SHARE and bool(
                ((gap - abs(hc.log_odds_free)).abs() <= 1e-4).all()),
                f"K2 at 128 px: {share:.3%} of cells differ")
            out["K2"] = float((grid - plain).abs().max())
        else:                              # K4: bit for bit
            check(torch.equal(grid, plain), "K4 at 128 px: "
                  f"{int((grid != plain).sum())} cells differ")
            out["K4"] = 0.0
        hint = (rel + torch.tensor((0.06, -0.04, 0.02), device=dev)
                + frontend._center(mcfg, dev)).contiguous()
        got = match.match(grid, q_scan.points, q_scan.valid, hint, hc)
        want = match.match_plain(grid, q_scan.points, q_scan.valid, hint, hc)
        err = float((got[:3] - want[:3]).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol
              and bool(got[3] == want[3]) and bool(got[6] == want[6]),
              f"{name} at 128 px: {got.tolist()} vs plain {want.tolist()} "
              f"(pose tol {tol})")
        out[name] = err
    # the fleet's rank shape: this rank's robots bootstrapped here
    sub = replay.ScanLog(flog.traj[:, lo:hi], flog.angles,
                         flog.radii[:, lo:hi], flog.valid[:, lo:hi],
                         flog.bootstrap)
    fd = replay.to_device(sub, dev)
    pts, val = fd.points[boot].contiguous(), fd.valid[boot].contiguous()
    hints = (fd.traj[boot] + torch.tensor((0.05, -0.03, 0.02), device=dev)
             ).contiguous()
    b = hi - lo
    zero = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    fire = torch.ones(b, dtype=torch.bool, device=dev)
    for mode, (mname, uname, tol) in (
            ("sub4_pallas_dense", ("K5", "K2 batched", K1_POSE_TOL)),
            ("sub1", ("K3 batched", "K4 batched", K3_POSE_TOL))):
        c = replay.FLEET_MODES[mode]()
        st = replay.fleet_bootstrap(fleet.init_fleet(c, sub.traj[0], dev),
                                    fd, boot, c)
        maps = st.maps
        got = match.match_batch(maps, pts, val, hints, c)
        want = match.match_batch_plain(maps, pts, val, hints, c)
        err = float((got[:, :3] - want[:, :3]).abs().max())
        check(err <= tol and torch.equal(got[:, 3], want[:, 3]),
              f"{mname} at B={b}: pose {err} from plain (tol {tol})")
        out[mname] = err
        mk, mp = maps.clone(), maps.clone()
        if c.dense_free_fill:
            fill.update_maps_batch(mk, pts, val, hints, zero, fire, c)
            mp = fill.update_maps_batch_plain(mp, pts, val, hints, zero, fire,
                                              c)
            diff = mk != mp
            gap = (mk[diff] - mp[diff]).abs()
            check(float(diff.float().mean()) <= FILL_DIFF_SHARE and bool(
                ((gap - abs(c.log_odds_free)).abs() <= 1e-4).all()),
                f"{uname} at B={b}: {int(diff.sum())} cells differ")
        else:
            line.update_maps_line_batch(mk, pts, val, hints, zero, fire, c)
            mp = line.update_maps_line_batch_plain(mp, pts, val, hints, zero,
                                                   fire, c)
            check(torch.equal(mk, mp), f"{uname} at B={b}: "
                  f"{int((mk != mp).sum())} cells differ from plain")
        out[uname] = float((mk - mp).abs().max())
    torch.cuda.synchronize(dev)
    return out


# ------------------------------------------------------------ the parent
SINGLE_SCANS = 30         # the single-card check: 10 forced + 20 matched


def single_card_check(card: int) -> dict:
    """A single-process replay with its tensors on ``cuda:card`` while
    ``cuda:0`` stays current (as a caller passing ``device="cuda:1"`` to an
    entry point has it): the ``pallas_dense`` (K1 + K2) and ``fixed`` (K3 +
    K4) replays of SINGLE_SCANS scans equal the same replays on cuda:0 bit
    for bit, one launch of each kernel a scan on each card (the bootstrap's
    forced scans in the fixed config: K3 + K4).  Returns the launches."""
    log = replay.make_log(0)
    boot = log.bootstrap
    out = {}
    for mode, cfg, kernels in (
            ("pallas_dense", replay.pallas_dense_config(), ("K1", "K2")),
            ("fixed", replay.fixed_config(), ("K3", "K4"))):
        got = {}
        for dev in (torch.device("cuda", card), torch.device("cuda", 0)):
            dlog = replay.head(replay.to_device(log, dev), SINGLE_SCANS)
            _build.reset_launches()
            st = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog,
                                  boot, cfg)
            st, o = replay.replay(st, dlog, boot, cfg)
            torch.cuda.synchronize(dev)
            check(torch.cuda.current_device() == 0, "the current device "
                  f"moved to {torch.cuda.current_device()}")
            check(st.maps.device == dev, f"{mode}: maps on {st.maps.device}")
            want = dict.fromkeys(("K3", "K4"), boot)
            for k in kernels:
                want[k] = want.get(k, 0) + SINGLE_SCANS - boot
            out[f"{mode} {dev}"] = check_launches(f"{mode} on {dev}", dev,
                                                  want)
            got[dev.index] = (o.poses.cpu(), st.maps.cpu())
        check(all(torch.equal(a, b) for a, b in zip(got[card], got[0])),
              f"{mode}: the replay on cuda:{card} differs from cuda:0's")
    return out


def references(tmp: str, dev, hector_scans: int, coreslam_scans: int,
               sections) -> None:
    """The dense references on this process's device, into ``tmp``: the
    fixed replay (forced maps, poses, maps, map updates) and its exit run,
    the production and parity CoreSLAM, the single-process fleet of each
    row."""
    log = replay.make_log(0)
    dlog = replay.to_device(log, dev)
    boot = log.bootstrap
    R = {}
    if "hector" in sections:
        cfg = replay.fixed_config()
        h = replay.head(dlog, hector_scans)
        st = replay.bootstrap(hector.init(cfg, log.traj[0], dev), h, boot,
                              cfg)
        R["h_boot_maps"] = st.maps.cpu().numpy()
        stf, out = replay.replay(st, h, boot, cfg)
        R["h_poses"] = out.poses.cpu().numpy()
        R["h_maps"] = stf.maps.cpu().numpy()
        R["h_updates"] = int(out.map_updated.sum())
        xcfg = cfg.overlay({"early_exit_tol": EXIT_TOL_FIRES})
        hx = replay.head(dlog, boot + min(SHORT_SCANS, hector_scans - boot))
        _, xo = replay.replay(replay.bootstrap(hector.init(
            xcfg, log.traj[0], dev), hx, boot, xcfg), hx, boot, xcfg)
        R["x_poses"] = xo.poses.cpu().numpy()
        R["x_iters"] = int(xo.gn_iterations.sum())
    if "coreslam" in sections:
        for mode, c in (("production", replay.coreslam_production_config()),
                        ("parity", replay.coreslam_parity_config())):
            cst, co = replay.coreslam_replay(
                replay.head(dlog, coreslam_scans), c, seed=1)
            R[f"c_{mode}_poses"] = co.poses.cpu().numpy()
            R[f"c_{mode}_sums"] = co.best_sum.cpu().numpy()
            R[f"c_{mode}_hole"] = cst.hole_map.cpu().numpy()
            R[f"c_{mode}_obst"] = cst.obstacle_map.cpu().numpy()
    if "fleet" in sections:
        flog = replay.make_fleet_log(log)
        fdlog = replay.to_device(flog, dev)
        for mode in FLEET_MODES:
            c = replay.FLEET_MODES[mode]()
            fst = replay.fleet_bootstrap(fleet.init_fleet(c, flog.traj[0],
                                                          dev), fdlog, boot, c)
            fstf, fo = fleet.replay_fleet(fst, fdlog.points[boot:],
                                          fdlog.valid[boot:], c)
            np.save(f"{tmp}/fleet_{mode}_poses.npy", fo.cpu().numpy())
            np.save(f"{tmp}/fleet_{mode}_maps.npy", fstf.maps.cpu().numpy())
    np.savez(f"{tmp}/ref.npz", **R)


def run(cards: int = 4, backend: str = "nccl", device: str = "cuda",
        hector_scans: int | None = None, coreslam_scans: int | None = None,
        graph_scans: int | None = None, sections=SECTIONS,
        timeout_s: float = TIMEOUT_S) -> dict:
    """The dry run: references, then ``cards`` ranks (see the module
    docstring).  Raises on any failed check (``CheckFailed``) or failed
    rank (``parallel.launch.RankError``).  Returns {"ranks": each rank's
    result, "seconds": {...}}."""
    replay.multichip_meshes(cards)              # even and >= 2, or raise
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multichip: no CUDA device")
    mesh.check_backend(backend, cards)
    sections = tuple(sections)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}")
    hector_scans = hector_scans or replay.SHARDED_N
    coreslam_scans = coreslam_scans or replay.SHARDED_CORESLAM_N
    graph_scans = graph_scans or replay.make_sharded_graph_log().traj.shape[0]
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    t0 = time.perf_counter()
    single = (single_card_check(torch.cuda.device_count() - 1)
              if device == "cuda" and torch.cuda.device_count() > 1 else None)
    ts = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="slamnet_multichip_")
    try:
        references(tmp, dev, hector_scans, coreslam_scans, sections)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        ranks = launch.launch(
            "slamnet_tpu_torch.multichip:rank_main", cards,
            {"ref": tmp, "work": tmp, "backend": backend,
             "device": None if device == "cuda" else "cpu",
             "hector_scans": hector_scans, "coreslam_scans": coreslam_scans,
             "graph_scans": graph_scans, "sections": list(sections),
             "timeout_s": timeout_s},
            backend=backend, timeout_s=timeout_s, rendezvous="env")
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cards_here = torch.cuda.device_count() if device == "cuda" else 1
    for r, got in enumerate(ranks):
        # rank r on cuda:r (gloo ranks beyond the cards share them)
        want = f"cuda:{r % cards_here}" if device == "cuda" else "cpu"
        check(got["rank"] == r and got["device"] == want,
              f"rank {r} ran on {got['device']}, want {want}")
        if backend == "nccl":
            copies = {k: c["host_copies"] for k, c in got["counts"].items()}
            check(not any(copies.values()), f"rank {r}: host copies under "
                  f"NCCL {copies}")
    return {"ranks": ranks, "single_card": single,
            "seconds": {"single_card": ts - t0, "references": t1 - ts,
                                        "ranks": t2 - t1,
                                        "all": time.perf_counter() - t0}}


def report(out: dict, cards: int, backend: str) -> list:
    """The dry run's lines, one a section, from ``run``'s result."""
    ranks = out["ranks"]
    num = ranks[0]["numbers"]
    where = (f"{cards} {backend} ranks, rank r on "
             + ", ".join(r["device"] for r in ranks))
    lines = [f"[multichip] {where}; host copies a rank "
             + str([sum(c["host_copies"] for c in r["counts"].values())
                    for r in ranks])]
    if out.get("single_card"):
        lines.append("[multichip] one process, cuda:0 current, tensors on "
                     "another card: the pallas_dense and fixed replays of "
                     f"{SINGLE_SCANS} scans = cuda:0's bit for bit; launches "
                     + str(out["single_card"]))
    if "collective_us" in num:
        lines.append("[multichip] every collective of both meshes = its "
                     "definition on every rank; us a call (rank 0, host "
                     "clock to the card's end): " + ", ".join(
                         f"{k} {v:.1f}" for k, v in num["collective_us"].items()))
    for name, o in num.get("hector", {}).items():
        lines.append(
            f"[multichip] 1. sharded Hector {name}, fixed 400x400x3, "
            f"{o['scans']} matched scans: ATE {o['ate_m']:.9f} m (JAX "
            f"{o['jax_ref_ate_m']}), max {o['max_err_m']:.6f}; poses within "
            f"{o['pose_err_m']:.3g} m of the dense replay (tol {POSE_TOL}), "
            f"maps {o['map_err']:.3g} (tol {MAP_TOL}), {o['map_updates']} "
            f"map updates; {o['scans_per_s']:.2f} scans/s, "
            f"{o['wall_ms_per_scan']:.2f} ms a scan (rank 0; ranks "
            f"{min(o['rank_scans_per_s']):.2f}-"
            f"{max(o['rank_scans_per_s']):.2f} scans/s); "
            f"{o['collectives_per_scan']:.0f} collectives and "
            f"{o['host_copies_per_scan']:.0f} host copies a scan")
        if "modes" in o:
            b, x = o["modes"]["onehot_bf16"], o["modes"]["exit"]
            lines.append(
                f"[multichip] 1. sharded Hector {name}, {b['scans']} matched "
                f"scans: onehot_bf16 within {b['pose_err_m']:.3g} m of "
                f"gather's; the exit at {EXIT_TOL_FIRES} px within "
                f"{x['pose_err_m']:.3g} m of the dense exit replay, "
                f"{x['gn_iterations']} GN iterations (dense "
                f"{x['dense_gn_iterations']}); forced maps bit for bit")
    for mode, o in num.get("coreslam", {}).items():
        lines.append(f"[multichip] 2. sharded CoreSLAM {mode}, {o['scans']} "
                     "scans: = the dense pipeline bit for bit; ATE "
                     f"{o['ate_m']:.9f} m"
                     + (f" (JAX {o['jax_ref_ate_m']})" if mode == "production"
                        else "") + f"; {o['scans_per_s']:.2f} scans/s")
    for mode, o in num.get("graph", {}).items():
        lines.append(
            f"[multichip] 3. sharded graph, {mode} frontend, {o['scans']} "
            f"scans: {o['keyframes']} keyframes, {o['loop_closures']} "
            f"closures, ATE {o['ate_m']:.6f}, max {o['max_err_m']:.4f}, final"
            f" {o['final_err_m']:.4f} m, overflow {o['max_overflow']}; "
            f"{o['searches']} loop searches; {o['scans_per_s']:.2f} scans/s "
            f"(ranks {min(o['rank_scans_per_s']):.2f}-"
            f"{max(o['rank_scans_per_s']):.2f}); "
            f"{o['collectives_per_keyframe_event']:.0f} collectives a "
            f"keyframe event, {o['host_copies_per_scan']:.2f} host copies a "
            "scan")
        if "rebuild" in o:
            rb = o["rebuild"]
            lines.append(
                f"[multichip] 3. its state rebuilt on {rb['mesh']} "
                f"(rebuild_maps_sharded, {rb['nodes']} nodes) = the serial "
                "rebuild_maps bit for bit, halos included")
        if o["jax_fails_own_check"]:
            lines.append(
                f"[multichip] 3. note: on {o['mesh']} JAX's own "
                f"dryrun_multichip({cards}) fails its final-error check "
                "(< 0.5 m; its keyframe slots fill up), so this section "
                "held the port only to JAX's numbers there (replay."
                "graph_gate), not to that check: an ok here is not a "
                "passing reference dry run")
    for mode, o in num.get("fleet", {}).items():
        rates = o["rank_instance_scans_per_s"]
        lines.append(f"[multichip] 4. the mesh fleet {mode}, "
                     f"{o['robots_a_rank']} robots a rank, {o['batch_scans']}"
                     " batch-scans: every rank's robots = the single-process "
                     f"fleet bit for bit; {sum(rates):.1f} instance-scans/s "
                     f"over the ranks ({min(rates):.1f}-{max(rates):.1f})")
    if "posegraph" in num:
        o = num["posegraph"]
        lines.append(
            f"[multichip] 5. edge-sharded GN within {o['edge_max_abs_err']:.3g}"
            f" of the dense ({o['edge_ms_per_step']:.2f} ms a step); Schur "
            f"step within {o['schur_err_step1']:.3g} / "
            f"{o['schur_err_step2']:.3g} of the dense after 1 / 2 steps, "
            f"{o['schur_collectives_per_step']:.0f} collectives, "
            f"{o['schur_ms_per_step']:.2f} ms a step (rank 0; ranks "
            f"{min(o['rank_schur_ms_per_step']):.2f}-"
            f"{max(o['rank_schur_ms_per_step']):.2f}); the loop-closure "
            f"cluster overflows {SEP_SMALL} slots by "
            f"{o['cluster_overflow_small']} (the host check agrees), none at "
            f"{o['cluster_slots_big']}")
    o = num.get("checkpoint", {})
    if "cut" in o:
        lines.append("[multichip] 5. checkpoint saved on "
                     f"{o['saved_on']} at scan {o['cut']}: " + "; ".join(
                         f"{k} bit for bit {v['bit_for_bit']}, poses "
                         f"{v['pose_err_m']:.3g} m, maps {v['map_err']:.3g} "
                         "from the dense" for k, v in o.items()
                         if isinstance(v, dict) and k != "graph"))
    if "graph" in o:
        g = o["graph"]
        lines.append(f"[multichip] 5. section 3's checkpoint saved on "
                     f"{g['saved_on']} at scan {g['cut']} "
                     f"({g['nodes_at_cut']} nodes): resumed there = the "
                     "uninterrupted replay bit for bit; restored on "
                     f"{g['restored_on']} = the saved state")
    for key, o in num.get("trace", {}).items():
        lines.append(f"[multichip] trace of one {key} on rank 0: wall "
                     f"{o['wall_ms']:.2f} ms, {o['kernels']} kernels, busy "
                     f"{o['busy_us']:.1f} us, NCCL kernels "
                     f"{o['nccl_kernels']} taking {o['nccl_us']:.1f} us ("
                     + ", ".join(f"{k} {n} x, {us:.1f} us" for k, (n, us)
                                 in o["nccl_by_name"].items()) + ")")
    if any(r["kernel_errors"] for r in ranks):
        lines.append("[multichip] 6. K1-K5 vs their plain versions on every "
                     "rank's card: " + "; ".join(
                         f"rank {r['rank']} " + ", ".join(
                             f"{k} {v:.3g}" for k, v in
                             r["kernel_errors"].items()) for r in ranks))
    lines.append("[multichip] launches a rank: " + "; ".join(
        f"rank {r['rank']} " + ", ".join(
            f"{sec} {dict((k, v) for k, v in c.items() if v)}"
            for sec, c in r["launches"].items()) for r in ranks))
    s = out["seconds"]
    lines.append(f"[multichip] seconds: single card {s['single_card']:.1f}, "
                 f"references {s['references']:.1f}, "
                 f"ranks {s['ranks']:.1f}, all {s['all']:.1f}")
    return lines


def strip_tracks(o):
    """``o`` without the per-scan tracks (for the JSON line)."""
    if isinstance(o, dict):
        return {k: strip_tracks(v) for k, v in o.items()
                if k not in ("poses", "flags")}
    if isinstance(o, list):
        return [strip_tracks(v) for v in o]
    return o


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=4,
                    help="ranks, one a card under NCCL (even, >= 2)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multichip: no CUDA device (torch.cuda.is_available() is "
              "False); --device cpu runs the ranks on the CPU",
              file=sys.stderr)
        return 2
    out = run(args.cards, args.backend, args.device)
    for text in report(out, args.cards, args.backend):
        print(text, flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"[multichip] nvidia-smi: {smi}", flush=True)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": args.cards}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": args.cards}
    print(json.dumps(strip_tracks(out)), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
