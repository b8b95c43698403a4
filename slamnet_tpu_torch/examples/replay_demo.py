"""Trajectory-replay demo: simulator -> SLAM pipelines -> ATE report.

Port of ``examples/replay_demo.py``, the headless counterpart of the
reference's Simulation app (MainWindow.xaml.cs): a scripted trajectory
through the default field (or the office), noisy lidar revolutions, the
pipelines over them, and each pipeline's pose error against the truth, the
divergence oracle of MainWindow.xaml.cs:182-196 as a CLI.

    python -m slamnet_tpu_torch.examples.replay_demo --scans 200 --pipeline all

The revolutions are simulated once, on the device, from one generator seeded
with ``--seed`` (the JAX script draws a key a scan and a pipeline), and every
pipeline replays the same log: CoreSLAM (``--candidates`` Monte-Carlo
candidates) and the particle layer (2048 particles) as
``replay.coreslam_replay`` / ``replay.particle_replay`` run them;
graph-SLAM and Hector at ``HectorConfig()`` (4 levels, K3 + K4), the first
BOOTSTRAP scans mapped at the true pose.  Hector's loop reads its pose, flag
and residual every scan for the per-scan records (``--metrics``), the
divergence monitor and the HTML replay (``--html``).  ``--render`` draws
PNGs with matplotlib.  The exit code is 1 when a pipeline diverged (max
error >= 1 m or heading error >= 10 degrees).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .. import replay
from ..core.config import (CoreSlamConfig, HectorConfig, ParticleConfig,
                           PoseGraphConfig, SimConfig)
from ..core.scan import Scan
from ..io.metrics import DivergenceMonitor, EmaTimer, RingLog, ScanMetrics
from ..models import graph_slam, hector
from ..sim import default_field, office_field, revolution_angles
from ..sim import scan_revolution
from ..sim import trajectory as trj
from . import device_or_exit

BOOTSTRAP = 10          # scans mapped at the true pose (Hector, graph)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, no fallback) or cpu")
    ap.add_argument("--pipeline", default="coreslam",
                    choices=["coreslam", "hector", "particle", "graph",
                             "both", "all"])
    ap.add_argument("--trajectory", default="loop",
                    choices=["loop", "stationary", "spin", "office"],
                    help="'office' drives the multi-room office world "
                         "(sim/field.office_field), the loop-closure "
                         "scenario")
    ap.add_argument("--speed", type=float, default=0.3)
    ap.add_argument("--candidates", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-ray dropout probability (fault injection)")
    ap.add_argument("--render", metavar="DIR", default=None,
                    help="save final map/pose PNGs to DIR (matplotlib)")
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write per-scan ScanMetrics JSONL (hector pipeline)")
    ap.add_argument("--html", metavar="FILE", default=None,
                    help="write a self-contained HTML live replay (hector "
                         "pipeline: map levels + pose overlays)")
    return ap.parse_args(argv)


def simulate(args, dev: torch.device):
    """(field, truth f32[T, 3], DeviceLog) of the chosen trajectory."""
    sim = SimConfig()
    if args.trajectory == "office":
        fld = office_field(device=dev)
    else:
        fld = default_field(sim.field_scale, sim.field_offset, device=dev)
    traj = {
        "loop": lambda: trj.loop_trajectory(speed=args.speed),
        "stationary": lambda: trj.stationary_trajectory(num_scans=args.scans),
        "spin": lambda: trj.spin_trajectory(num_scans=args.scans),
        "office": lambda: trj.office_tour_trajectory(num_loops=1),
    }[args.trajectory]()[:args.scans]
    angles = torch.as_tensor(revolution_angles(sim.num_scan_points),
                             device=dev)
    truth = torch.as_tensor(traj, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    radii, valid = scan_revolution(fld, truth, angles, sim.max_scan_dist,
                                   sim.measure_error, gen,
                                   dropout_prob=args.dropout)
    pts = torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)],
                      dim=-1).contiguous()
    return fld, traj, replay.DeviceLog(pts, valid, truth)


def scores(track: np.ndarray, traj: np.ndarray, seconds: float) -> dict:
    """ATE, max position error, max heading error (wrapped) and the rate."""
    ate, max_err = replay.ate_of(track, traj)
    ang = (track[:, 2] - traj[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return {"ate": ate, "max_err": max_err,
            "max_ang_deg": float(np.degrees(np.abs(ang)).max()),
            "scans_per_sec": traj.shape[0] / seconds}


def timed(dev: torch.device, fn):
    """``fn()`` and its seconds, to a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run_graph(dlog, hcfg: HectorConfig, gcfg: PoseGraphConfig):
    """Graph-SLAM over every scan, the first BOOTSTRAP mapped at the true
    pose; the final state and the live match poses f32[T, 3]."""
    dev = dlog.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    st = graph_slam.init(hcfg, gcfg, dlog.traj[0], dlog.points.shape[1], dev)
    poses = []
    for t in range(dlog.points.shape[0]):
        boot = t < BOOTSTRAP
        if boot:
            st = st._replace(hector=st.hector._replace(match_pose=dlog.traj[t]))
        st, _ = graph_slam.update(st, Scan(dlog.points[t], dlog.valid[t], zero),
                                  hcfg, gcfg, None, boot)
        poses.append(st.hector.match_pose)
    return st, torch.stack(poses)


def run_hector(dlog, traj: np.ndarray, hcfg: HectorConfig, recorder=None):
    """Hector over every scan with the per-scan records: the final state,
    the ScanMetrics, the divergence monitor and the match EMA."""
    dev = dlog.points.device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    st = hector.init(hcfg, dlog.traj[0], dev)
    ring = RingLog()
    monitor = DivergenceMonitor(log=ring)
    ema = EmaTimer()
    records = []
    for t in range(dlog.points.shape[0]):
        boot = t < BOOTSTRAP
        with ema.time():
            # the bootstrap maps at the true pose (the bench's pattern): a
            # moving robot would otherwise map its first scans at a frozen
            # pose (fatal for the office tour's 0.25 m/scan start)
            st, info = hector.update(
                st, Scan(dlog.points[t], dlog.valid[t], zero),
                dlog.traj[t] if boot else st.match_pose, hcfg, boot)
            pose = st.match_pose.cpu().numpy()
        resid = float(info.residual)
        records.append(ScanMetrics(
            scan_index=t, pose=tuple(float(v) for v in pose),
            match_ms=ema.ms, map_updated=bool(info.map_updated),
            gn_residual=resid))
        ring.log(f"scan {t}: resid {resid:.4f} fails "
                 f"{int(info.solve_failures)}")
        if monitor.check(t, pose, traj[t]):
            print("\n".join(monitor.report), file=sys.stderr)
        if recorder is not None:
            recorder.add(t, st.maps, st.match_pose, traj[t])
    return st, records, monitor, ema


def render(args, fld, traj, results, states) -> None:
    """The final maps and poses as PNGs under ``args.render``."""
    from ..io import viz
    os.makedirs(args.render, exist_ok=True)
    edges = (fld.a.cpu().numpy(), fld.b.cpu().numpy())
    if "coreslam" in results:
        cst, ccfg = states["coreslam"]
        viz.render_frame(
            os.path.join(args.render, "coreslam.png"), hole_map=cst.hole_map,
            hole_size=ccfg.hole_map_size, physical_size=ccfg.physical_map_size,
            field_edges=edges, real_pose=traj[-1],
            estimates={"coreslam": (cst.pose, "blue")}, trajectory=traj,
            title="(final)")
    if "hector" in results or "graph" in results:
        hs, hcfg = states["hector" if "hector" in results else "graph"]
        viz.render_frame(
            os.path.join(args.render, "hector.png"),
            logodds=hector.level_view(hs.maps, hcfg, 0).reshape(-1),
            occ_size=hcfg.map_size,
            physical_size=hcfg.map_size * hcfg.map_resolution,
            field_edges=edges, real_pose=traj[-1],
            estimates={"hector": (hs.match_pose, "green")}, trajectory=traj,
            title="(level 0, final)")
    print(f"rendered PNGs to {args.render}")


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_or_exit(args.device, "replay_demo")
    fld, traj, dlog = simulate(args, dev)
    n = traj.shape[0]
    print(f"trajectory: {args.trajectory}, {n} scans @ "
          f"{SimConfig().scans_per_second} Hz on {dev}")
    results, states = {}, {}

    if args.pipeline in ("coreslam", "both", "all"):
        cfg = CoreSlamConfig(num_candidates=args.candidates)
        (st, out), secs = timed(dev, lambda: replay.coreslam_replay(
            dlog, cfg, seed=args.seed + 1))
        results["coreslam"] = scores(out.poses.cpu().numpy(), traj, secs)
        states["coreslam"] = (st, cfg)

    if args.pipeline in ("particle", "all"):
        ccfg = CoreSlamConfig()
        pcfg = ParticleConfig(num_particles=2048, top_k=32,
                              refine_candidates=32)
        (_, out), secs = timed(dev, lambda: replay.particle_replay(
            dlog, ccfg, pcfg, seed=args.seed + 2))
        results["particle"] = scores(out.poses.cpu().numpy(), traj, secs)

    if args.pipeline in ("graph", "all"):
        hcfg = HectorConfig()
        gcfg = PoseGraphConfig(max_keyframes=64, max_edges=256,
                               keyframe_dist=1.0, keyframe_angle=0.6)
        (gst, poses), secs = timed(dev, lambda: run_graph(dlog, hcfg, gcfg))
        results["graph"] = scores(poses.cpu().numpy(), traj, secs)
        states["graph"] = (gst.hector, hcfg)
        print(f"graph: {gst.nodes} keyframes, {int(gst.graph.num_edges)} "
              f"edges, {int(gst.loop_count)} loop closures")

    if args.pipeline in ("hector", "both", "all"):
        hcfg = HectorConfig()
        recorder = None
        if args.html:
            from ..io.live import ReplayRecorder
            recorder = ReplayRecorder(hcfg, every=max(1, n // 100))
        (hst, records, monitor, ema), secs = timed(
            dev, lambda: run_hector(dlog, traj, hcfg, recorder))
        track = np.asarray([r.pose for r in records], np.float32)
        results["hector"] = scores(track, traj, secs)
        states["hector"] = (hst, hcfg)
        print(f"hector: {sum(r.map_updated for r in records)} map updates, "
              f"match EMA {ema.ms:.2f} ms, final residual "
              f"{records[-1].gn_residual:.4f}"
              + (f", DIVERGED at {monitor.diverged_at}"
                 if monitor.diverged_at is not None else ""))
        if args.metrics:
            with open(args.metrics, "w") as f:
                for r in records:
                    f.write(json.dumps(dataclasses.asdict(r)) + "\n")
            print(f"wrote {len(records)} ScanMetrics records to "
                  f"{args.metrics}")
        if recorder is not None:
            recorder.write(args.html,
                           title=f"HectorSLAM replay - {args.trajectory}")
            print(f"wrote HTML replay ({len(recorder.frames)} frames) to "
                  f"{args.html}")

    if args.render:
        render(args, fld, traj, results, states)

    ok = True
    for name, r in results.items():
        good = r["max_err"] < 1.0 and r["max_ang_deg"] < 10.0
        ok &= good
        print(f"{name}: ATE={r['ate']:.6f} m  max_err={r['max_err']:.3f} m  "
              f"max_ang={r['max_ang_deg']:.2f} deg  "
              f"rate={r['scans_per_sec']:.1f} scans/s  "
              f"[{'OK' if good else 'DIVERGED'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
