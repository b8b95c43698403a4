"""Closed-loop replay jobs: one robot (``hector.update``) or a fleet
(``fleet.update_fleet``) replaying its logs as fast as the program goes.

Set-up makes the logs from the seed, maps the bootstrap scans at their true
poses, and warms every shape the window uses.  The window then runs jobs
back to back: each starts from a copy of the bootstrapped state (the copy
is timed) and tracks the job's scans, each hinted with the robot's previous
match pose.  The host's clock is read after every step; once ``seconds``
have passed the window closes after that step and waits for the card.
``scans_per_s`` is every robot-scan enqueued over the window's seconds up
to the card's end, job restarts included.

The answers judged are every pose of every job (a partial last job
included) and the maps of one job drawn from the seed, of the last job,
and of the bootstrap, against the plain reference replaying the same scans
from its own bootstrap.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness as H
from .. import logs, program, reference


def make_log(traffic: dict, sensor: dict, seed: int, device) -> logs.Log:
    """The traffic's robots: ``logs`` loop logs from seeds drawn from
    ``seed`` (the seed itself when there is one), each cut into ``shifts``
    phase-shifted slices of ``bootstrap + tracked`` scans: f32[T, B, ...]."""
    k = traffic["logs"]
    seeds = [seed] if k == 1 else logs.derived_seeds(seed, k)
    span = traffic["bootstrap"] + traffic["tracked"]
    n = max(span, traffic.get("log_scans", span))
    return logs.make_fleet_log([logs.make_log(s, n, sensor, device)
                                for s in seeds], span, traffic["shifts"])


def bootstrap(prog: program.Robots, log: logs.Log, n: int, boot_cfg):
    state = prog.init(log.traj[0])
    for t in range(n):
        state = prog.set_pose(state, log.traj[t])
        state, _, _ = prog.step(state, log.points[t], log.valid[t], True,
                                boot_cfg)
    return state


def reference_replay(cfg: dict, log: logs.Log, boot: int, robots: int,
                     snapshots, cdt=torch.float32):
    """The reference's own bootstrap and replay of the tracked scans:
    (its bootstrapped maps, poses f32[T, B, 3], fired, {k: maps})."""
    rcfg = reference.RefConfig(cfg["hector"])
    rboot = reference.bootstrap(log.traj, log.points, log.valid, boot,
                                rcfg.overlay(cfg["bootstrap_overrides"]))
    full_scan = robots == 1 and rcfg.matcher_mode != "pallas"
    poses, fired, snaps = reference.replay(
        rboot, log.points[boot:], log.valid[boot:], rcfg, full_scan,
        snapshots, cdt)
    return rboot.maps, poses, fired, snaps


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    """One run of the cell: (result without ``checks``, checks)."""
    dev = torch.device(device)
    robots = traffic["logs"] * traffic["shifts"]
    boot, tracked = traffic["bootstrap"], traffic["tracked"]
    log = make_log(traffic, cfg["sensor"], seed, dev)
    prog = program.Robots(cfg["hector"], robots, dev)
    boot_cfg = program.hector_config({**cfg["hector"],
                                      **cfg["bootstrap_overrides"]})
    boot_state = bootstrap(prog, log, boot, boot_cfg)
    P, V = log.points[boot:], log.valid[boot:]
    # warm-up: every shape the window uses, the map update firing and not
    st = prog.clone(boot_state)
    for t in range(min(traffic["warmup_steps"], tracked)):
        st, p, f = prog.step(st, P[t], V[t], False)
    del st
    if trace:
        H.start_profiler()
    H.sync(dev)

    trace_at = seconds / 2 if trace else math.inf
    tracer, traced, attempts = None, None, 0
    jobs, lens, job_ends = [], [], []
    sample = H.Reservoir(seed)
    last_maps = None
    steps = 0
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = False
    while not done:
        st = prog.clone(boot_state)
        poses = []
        for t in range(tracked):
            if t == 0 and traced is None and \
                    time.perf_counter() - t0 >= trace_at:
                tracer = H.Trace(dev).__enter__()
                traced = {"first": len(poses), "job": len(jobs), "fired": []}
            st, p, f = prog.step(st, P[t], V[t], False)
            poses.append(p)
            steps += 1
            if tracer is not None:
                traced["fired"].append(f)
                if len(traced["fired"]) == traffic["trace_steps"]:
                    tracer.__exit__(None, None, None)
                    attempts += 1
                    if tracer.recorded:
                        traced["tracer"] = tracer
                    elif attempts < H.TRACE_ATTEMPTS:
                        traced = None          # trace the next job instead
                    tracer = None
            if time.perf_counter() >= deadline and tracer is None and \
                    (traced is not None or not trace):
                done = True
                break
        jobs.append(torch.stack(poses))
        lens.append(len(poses))
        job_ends.append(time.perf_counter())
        if len(poses) == tracked:
            sample.offer((len(jobs) - 1, st.maps))
        last_maps = st.maps
    H.sync(dev)
    elapsed = time.perf_counter() - t0
    if trace:
        if "tracer" not in traced:
            raise H.no_trace()
        traced["summary"] = traced.pop("tracer").summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = steps * robots
    finite = torch.stack([torch.isfinite(j).all(dim=-1).sum() for j in jobs])
    failed = attempted - int(finite.sum())
    del st

    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        ctx = layer_context(traced, jobs, log, boot, cfg, robots, dev)
        result["metrics"] = read_layers(per_layer, ctx)
        result["breakdown"] = H.breakdown(traced["summary"])
        busy = H.busy_us(traced["summary"]["device_ops"]) * 1e-6
        dev_extra = {"busy_s": busy, "window_s": traced["summary"]["window_s"]}
    else:
        result["metrics"] = {"scans_per_s": attempted / elapsed,
                             "setup_s": setup_s}
        dev_extra = {}
    result["device"] = {**H.device_info(dev, 1, peak), **dev_extra}
    H.say(f"{name}: {len(jobs)} jobs, {attempted} robot-scans in "
          f"{elapsed:.3f} s; set-up {setup_s:.3f} s")
    result["host_pace"] = H.host_pace(dev)
    H.say(f"host pace at the close: {result['host_pace']}")
    if len(jobs) > 2:     # the host's pace through the window, job by job
        js = np.diff([t0] + job_ends)[:-1] * 1e3
        fifths = [round(float(np.median(c)), 2)
                  for c in np.array_split(js, min(5, len(js)))]
        H.say(f"job enqueue ms: min {js.min():.2f}, median "
              f"{np.median(js):.2f}, max {js.max():.2f}; by fifths of the "
              f"window {fifths}")

    # ---- the reference, once the window has closed -----------------------
    kept = sample.item
    snaps = {lens[-1], tracked}
    rmaps0, rposes, _, rsnaps = reference_replay(cfg, log, boot, robots,
                                                 snaps)
    xy, th = np.max([H.pose_gaps(j, rposes[:n]) for j, n in zip(jobs, lens)],
                    axis=0).tolist()
    H.say_robot_gaps(jobs, lens, rposes)
    cells = max(H.cells_differing(boot_state.maps, rmaps0),
                H.cells_differing(last_maps, rsnaps[lens[-1]]),
                H.cells_differing(kept[1], rsnaps[tracked])
                if kept is not None else 0)
    checks = H.checks_of(cfg["limits"], xy, th, cells, failed)
    result["correct"] = H.judge(checks)
    return result, checks


def layer_context(traced: dict, jobs: list, log: logs.Log, boot: int,
                  cfg: dict, robots: int, dev) -> dict:
    """What the per-layer readers read: the traced stretch, its steps, and
    the map updates that fired in it with the cells they mark."""
    fired = torch.stack(traced["fired"])                   # [S, B]
    s = fired.shape[0]
    i0 = traced["first"]
    poses = jobs[traced["job"]][i0:i0 + s]                  # [S, B, 3]
    t_idx, b_idx = fired.nonzero(as_tuple=True)
    pts = log.points[boot + i0:boot + i0 + s][t_idx, b_idx]
    val = log.valid[boot + i0:boot + i0 + s][t_idx, b_idx]
    rcfg = reference.RefConfig(cfg["hector"])
    cells = int(reference.changed_cells(pts, val, poses[t_idx, b_idx],
                                        rcfg).sum()) if t_idx.numel() else 0
    return {"summary": traced["summary"], "steps": s, "robots": robots,
            "beams": log.points.shape[-2], "hector": cfg["hector"],
            "map_updates": int(t_idx.numel()), "cells_changed": cells,
            "peaks": H.load_json(H.HERE / "peaks.json")}


def read_layers(per_layer: list, ctx: dict) -> dict:
    out = {}
    for m in per_layer:
        v = H.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = v
    return out
