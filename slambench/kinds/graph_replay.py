"""Closed-loop graph-SLAM replay jobs: ``models/graph_slam.update`` over
every scan of the simulator's loop driven once round and on into a second
lap, as fast as the program goes.

Set-up makes the log from the seed (``logs_graph.make_log``) and runs one
whole job.  The window then runs jobs back to back.  Each starts from a
fresh graph-SLAM state at the log's first true pose (a new map from
nothing; timed), maps the first ``bootstrap`` scans at their true poses,
and tracks the rest, each scan hinted with the state's live pose.  The
host reads the keyframe gate every scan (the program's own read).  The
host's clock is read after every scan; once ``seconds`` have passed the
window closes after that scan and waits for the card.  ``scans_per_s`` is
every scan enqueued over the window's seconds up to the card's end, job
starts included.  A traced run traces scans ``trace_from`` to the end of a
job that starts after half the window.

The answers judged, against the plain reference (``reference_graph``)
replaying one job on the same card once the window has closed: every live
pose of every job (a partial last job included), every job's keyframes and
accepted closures, and of the last job and of one whole job drawn from the
seed the optimized keyframe poses and Hector's maps.  These pass through
the pose graph's float32 solve, whose rounding differs between the two
(H's condition number is ~1e7 and more), so on a sound run a few
re-anchored poses part by up to several cm while the rest agree to ~1e-5
m: the widest gaps are held loosely, against divergence, and the 99th
percentile of the live poses' gaps tightly.  The frontend is judged where
the solve does not reach: each loop match of the window's first job is
made again by the reference's frontend from the same two scans and the
same start.
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from .. import harness as H
from .. import logs_graph, program_graph
from .. import reference_graph as R

SPANS = ("graph.update", "hector.update", "graph.keyframe",
         "graph.loop_match", "graph.optimize")


def program_job(prog, log, boot: int, n: int):
    """One job through the program: (live poses f32[n, 3], the scans that
    added a keyframe, the scans that accepted a closure (read from the
    program's counter; empty without it), the final state)."""
    st = prog.init(log.traj[0])
    poses, kf_at, loop_at = [], [], []
    for t in range(n):
        nodes, loops = st.nodes, program_graph.counters()["closures"]
        st, p = prog.step(st, log.points[t], log.valid[t],
                          log.traj[t] if t < boot else None)
        poses.append(p)
        if st.nodes != nodes:
            kf_at.append(t)
        if loops is not None and program_graph.counters()["closures"] != \
                loops:
            loop_at.append(t)
    return torch.stack(poses), kf_at, loop_at, st


def frontend_gap(cfg: dict, searches: list) -> float:
    """The widest xy gap (m) between the program's loop matches
    (``GraphSlam.recorded_searches``) and the reference frontend's from the
    same scans and start; NaN where one is not finite."""
    rc = R.RefGraphConfig(cfg)
    gap = 0.0
    for ref_pts, ref_val, pts, val, init_rel, rel in searches:
        want, _ = R.match_scans(ref_pts, ref_val, pts, val, init_rel, rc)
        gap = max(gap, H.pose_gaps(rel, want)[0])
    return gap


def compare(limits: dict, jobs: list, counts: list, last: dict, kept,
            ref: tuple, front: float, failed: int) -> dict:
    """Every number compared, with its limit.  ``jobs`` are the program's
    live poses, ``counts`` each job's (keyframes, closures) at its end,
    ``last`` the last job's ``program_graph.outcome`` and ``kept`` a whole
    job's (or None); ``ref`` is ``reference_graph.replay``'s (poses,
    keyframe scans, closure scans, snapshots), with a snapshot at the last
    job's length and at the whole job's; ``front`` is ``frontend_gap``."""
    rposes, rkf, rloop, snaps = ref
    rk = torch.cumsum(rkf.to(torch.int64), 0).tolist()
    rc = torch.cumsum(rloop.to(torch.int64), 0).tolist()
    xy, th = np.max([H.pose_gaps(p, rposes[:len(p)]) for p in jobs],
                    axis=0).tolist()
    gaps = torch.cat([torch.hypot(*(p[:, :2].double()
                                   - rposes[:len(p), :2].double()).T)
                      for p in jobs]).cpu().numpy()
    p99 = H.percentile(gaps, 99) if np.isfinite(gaps).all() else math.nan
    # node 0 is the start, no keyframe event's; the reference's counts
    # after as many scans as the job had
    kfs = max(abs(k - 1 - rk[len(p) - 1]) for p, (k, _) in zip(jobs, counts))
    loops = max(abs(c - rc[len(p) - 1]) for p, (_, c) in zip(jobs, counts))
    pairs = [(last, snaps[len(jobs[-1])])]
    if kept is not None:
        pairs.append((kept, snaps[len(rposes)]))
    kf_gap, cells = 0.0, 0
    for e, s in pairs:
        k = min(e["keyframes"], s.keyframes)
        g, _ = H.pose_gaps(e["kf_poses"][:k], s.kf_poses[:k])
        kf_gap = max(kf_gap, g)
        cells = max(cells, H.cells_differing(e["maps"], s.maps))
    return {"pose_gap_m": (xy, limits["pose_gap_m"]),
            "heading_gap_rad": (th, limits["heading_gap_rad"]),
            "pose_gap_p99_m": (p99, limits["pose_gap_p99_m"]),
            "keyframes_differing": (kfs, limits["keyframes_differing"]),
            "closures_differing": (loops, limits["closures_differing"]),
            "keyframe_pose_gap_m": (kf_gap, limits["keyframe_pose_gap_m"]),
            "frontend_gap_m": (front, limits["frontend_gap_m"]),
            "map_cells_differing": (cells, limits["map_cells_differing"]),
            "failed_scans": (failed, 0)}


def time_split(summary: dict, scans: int) -> dict:
    """A traced scan's host time by span (us): each span's total over the
    stretch a scan, and the medians of the update span on scans with and
    without a keyframe event."""
    host = summary["host_ops"]
    out = {}
    for sp in SPANS:
        d = [e - s for name, s, e in host if name == f"slamnet.{sp}"]
        out[sp] = (sum(d) / scans, len(d))
    kf = [(s, e) for name, s, e in host if name == "slamnet.graph.keyframe"]
    plain, event = [], []
    for name, s, e in host:
        if name == "slamnet.graph.update":
            (event if any(s <= a and b <= e for a, b in kf)
             else plain).append(e - s)
    out["median_plain_scan"] = statistics.median(plain) if plain else None
    out["median_event_scan"] = statistics.median(event) if event else None
    return out


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    """One run of the cell: (result without ``checks``, checks)."""
    dev = torch.device(device)
    n, boot = traffic["scans"], traffic["bootstrap"]
    prog = program_graph.GraphSlam(cfg, cfg["sensor"]["beams"], dev)
    log = logs_graph.make_log(seed, n, cfg["sensor"], dev)
    warm, warm_kf, warm_loop, st = program_job(prog, log, boot, n)  # warm-up
    H.say(f"a job: {len(warm_kf)} keyframe events, {int(st.loop_count)} "
          f"closures")
    del st
    if trace:
        H.start_profiler()
    H.sync(dev)
    count0 = program_graph.counters()

    trace_at = seconds / 2 if trace else math.inf
    tracer, traced, attempts = None, None, 0
    jobs, counts, job_ends = [], [], []
    sample = H.Reservoir(seed)
    last = None
    steps = 0
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = False
    recording = prog.recorded_searches()   # the first job's loop matches
    searches = recording.__enter__()
    while not done:
        st = prog.init(log.traj[0])
        poses = []
        for t in range(n):
            if t == traffic["trace_from"] and traced is None and \
                    time.perf_counter() - t0 >= trace_at:
                tracer = H.Trace(dev).__enter__()
                traced = {"steps": 0, "count0": program_graph.counters()}
            st, p = prog.step(st, log.points[t], log.valid[t],
                              log.traj[t] if t < boot else None)
            poses.append(p)
            steps += 1
            if tracer is not None:
                traced["steps"] += 1
                if traced["steps"] == traffic["trace_steps"]:
                    tracer.__exit__(None, None, None)
                    traced["count1"] = program_graph.counters()
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
        if recording is not None:
            recording.__exit__(None, None, None)
            recording = None
        jobs.append(torch.stack(poses))
        last = program_graph.outcome(st)
        counts.append((last["keyframes"], last["closures"]))
        job_ends.append(time.perf_counter())
        if len(poses) == n:
            sample.offer((len(jobs) - 1, last))
        del st
    H.sync(dev)
    elapsed = time.perf_counter() - t0
    count1 = program_graph.counters()
    if trace:
        if "tracer" not in traced:
            raise H.no_trace()
        summary = traced.pop("tracer").summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = torch.stack([torch.isfinite(j).all(dim=-1).sum() for j in jobs])
    failed = steps - int(finite.sum())

    result = {"correct": False, "attempted": steps, "failed": failed}
    if trace:
        s = traced["steps"]
        c0, c1 = traced["count0"], traced["count1"]
        tcounts = None if c0["syncs"] is None else \
            {k: c1[k] - c0[k] for k in program_graph.COUNTERS[:-1]}
        ctx = {"summary": summary, "steps": s, "counters": tcounts}
        result["metrics"] = {}
        for m in per_layer:
            v = H.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = v
        result["breakdown"] = H.breakdown(summary)
        busy = H.busy_us(summary["device_ops"]) * 1e-6
        result["device"] = {**H.device_info(dev, 1, peak), "busy_s": busy,
                            "window_s": summary["window_s"]}
        kernels = sum(1 for k, _, _ in summary["device_ops"]
                      if H.is_kernel(k))
        H.say(f"traced {s} scans: {kernels / s:.1f} kernels, "
              f"{len(summary['device_ops']) / s:.1f} device operations and "
              f"{busy * 1e6 / s:.2f} us busy a scan; idle "
              f"{100 * (1 - busy / summary['window_s']):.2f}% of "
              f"{summary['window_s'] * 1e6 / s:.1f} us a scan")
        H.say(f"traced counters: {tcounts}")
        H.say(f"host us a traced scan by span (total a scan, spans): "
              f"{time_split(summary, s)}")
    else:
        result["metrics"] = {"scans_per_s": steps / elapsed,
                             "setup_s": setup_s}
        result["device"] = H.device_info(dev, 1, peak)
    H.say(f"{name}: {len(jobs)} jobs, {steps} scans in {elapsed:.3f} s; "
          f"set-up {setup_s:.3f} s")
    if count0["syncs"] is not None:
        H.say("program counters in the window: " + ", ".join(
            f"{k} {count1[k] - count0[k]}"
            for k in program_graph.COUNTERS[:-1])
            + f"; the largest solve {count1['solve_unknowns']} unknowns")
    else:
        H.say("program counters: none in this program")
    same = all(torch.equal(j, jobs[0][:len(j)]) for j in jobs[1:])
    H.say(f"every job's live poses the first job's bit for bit: {same}")
    result["host_pace"] = H.host_pace(dev)
    H.say(f"host pace at the close: {result['host_pace']}")
    if len(jobs) > 2:     # the host's pace through the window, job by job
        js = np.diff([t0] + job_ends)[:-1] * 1e3
        H.say(f"job ms: min {js.min():.1f}, median {np.median(js):.1f}, "
              f"max {js.max():.1f}")

    # ---- the reference, once the window has closed ----------------------
    kept = sample.item
    t_ref = time.perf_counter()
    ref = R.replay(cfg, log.traj, log.points, log.valid, boot, n,
                   {len(jobs[-1]), n})
    rkf = ref[1].nonzero().flatten().tolist()
    rloop = ref[2].nonzero().flatten().tolist()
    gaps = (warm[:, :2].double() - ref[0][:, :2].double()).norm(dim=1)
    H.say(f"reference: {time.perf_counter() - t_ref:.1f} s for a job; "
          f"{len(rkf)} keyframe events, {len(rloop)} closures; of the "
          f"warm-up job's against the reference's, keyframe events at scans "
          f"of one side only {sorted(set(rkf) ^ set(warm_kf))[:12]}, "
          f"closures {sorted(set(rloop) ^ set(warm_loop))[:12]}; its pose "
          f"gaps: widest {float(gaps.max()):.3e} m at scan "
          f"{int(gaps.argmax())}, 99th percentile "
          f"{float(gaps.quantile(0.99)):.3e}, median "
          f"{float(gaps.median()):.3e}")
    front = frontend_gap(cfg, searches)
    H.say(f"frontend: {len(searches)} loop matches of the first job made "
          f"again by the reference, widest gap {front:.3e} m")
    checks = compare(cfg["limits"], jobs, counts, last,
                     kept[1] if kept is not None else None, ref, front,
                     failed)
    result["correct"] = H.judge(checks)
    return result, checks
