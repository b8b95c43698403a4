"""Closed-loop CoreSLAM replay jobs: ``models/coreslam.update`` over every
scan of the simulator's loop log, as fast as the program goes.

Set-up makes the log from the seed (``logs.make_log``) with the rays its
points come from (angles and ranges), and runs one whole job.  The window
then runs jobs back to back.  Each starts from a fresh CoreSLAM at the
log's first true pose (slam.net's Reset; timed), its search's generator
seeded with one job seed drawn from the seed, the same for every job, and
steps it through every scan: one segment of the revolution's rays, tagged
with CoreSLAM's own pose; the first ``position_search_beginning`` scans
are trusted, the rest searched over ``num_candidates`` poses.  The host's
clock is read after every scan; once ``seconds`` have passed the window
closes after that scan and waits for the card.  ``scans_per_s`` is every
scan enqueued over the window's seconds up to the card's end, job starts
included.

The answers judged, against the plain reference (``reference_coreslam``)
replaying one job on the same card once the window has closed: every pose
and every best sum of every job (a partial last job included), and the
hole and obstacle maps of the last job and of one whole job drawn from the
seed.  The reference also blends the hole map in slam.net's order, and a
line on standard error says how far that order would move the map.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import harness as H
from .. import logs, program_coreslam
from .. import reference_coreslam as R


class Rays(NamedTuple):
    traj: torch.Tensor     # f32[T, 3] true poses
    angles: torch.Tensor   # f32[N] the revolution's beam angles
    radii: torch.Tensor    # f32[T, N] ranges, 0 where a beam missed
    valid: torch.Tensor    # bool[T, N]


def make_rays(seed: int, n: int, sensor: dict, device) -> Rays:
    """The first ``n`` scans of ``logs.make_log(seed)`` as the rays its
    points come from: the same ray cast and the same noise draws."""
    log = logs.make_log(seed, n, sensor, device)
    angles = torch.as_tensor(logs.revolution_angles(sensor["beams"]),
                             device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    hit, dist = logs.ray_cast(logs.field_edges(device), log.traj[:, :2],
                              angles + log.traj[:, 2:3],
                              sensor["max_range_m"])
    steps = torch.randint(-100, 100, dist.shape, generator=gen,
                          device=device)
    noise = steps.to(torch.float32) / 100.0 * sensor["noise_m"]
    radii = torch.where(hit, dist + noise, torch.zeros_like(dist))
    pts = torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)],
                      dim=-1)
    if not (torch.equal(pts, log.points) and torch.equal(hit, log.valid)):
        raise RuntimeError("the rays do not give the log's points")
    return Rays(log.traj, angles, radii, log.valid)


def job_seed(seed: int) -> int:
    """The search's generator seed of every job, drawn from ``seed``."""
    return logs.derived_seeds(seed, 1)[0]


def program_job(prog, rays: Rays, start: torch.Tensor, seed: int, n: int):
    """One job through the program: (poses f32[n, 3], best sums i32[n],
    the final state)."""
    st = prog.init(start, seed)
    poses, sums = [], []
    for t in range(n):
        st, p, s = prog.step(st, rays.angles, rays.radii[t], rays.valid[t])
        poses.append(p)
        sums.append(s)
    return torch.stack(poses), torch.stack(sums), st


def maps_of(state) -> tuple:
    """(hole map, obstacle map) of a program's or the reference's state."""
    return state[0], state[1]


def compare(limits: dict, jobs: list, sums: list, last_maps: tuple,
            kept_maps, ref_poses, ref_sums, snaps: dict, n: int,
            failed: int) -> dict:
    """Every number compared, with its limit: the widest pose gaps over
    every job (a job of ``len(p)`` scans against the reference's first
    ``len(p)``), the scans whose best sum differs, and the map cells that
    differ, of the last job (against ``snaps[len(jobs[-1])]``) and of the
    kept whole job (against ``snaps[n]``)."""
    xy, th = np.max([H.pose_gaps(p, ref_poses[:len(p)]) for p in jobs],
                    axis=0).tolist()
    sums_off = sum(int((s.to(torch.int64) != ref_sums[:len(s)]).sum())
                   for s in sums)
    pairs = [(last_maps, snaps[len(jobs[-1])])]
    if kept_maps is not None:
        pairs.append((kept_maps, snaps[n]))
    hole = max(int((a[0] != b[0]).sum()) for a, b in pairs)
    obst = max(int((a[1] != b[1]).sum()) for a, b in pairs)
    return {"pose_gap_m": (xy, limits["pose_gap_m"]),
            "heading_gap_rad": (th, limits["heading_gap_rad"]),
            "best_sum_scans_differing": (sums_off,
                                         limits["best_sum_scans_differing"]),
            "hole_pixels_differing": (hole, limits["hole_pixels_differing"]),
            "obstacle_cells_differing": (obst,
                                         limits["obstacle_cells_differing"]),
            "failed_scans": (failed, 0)}


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    """One run of the cell: (result without ``checks``, checks)."""
    dev = torch.device(device)
    n = traffic["scans"]
    rays = make_rays(seed, n, cfg["sensor"], dev)
    prog = program_coreslam.CoreSlam(cfg["coreslam"], dev)
    jseed = job_seed(seed)
    start = rays.traj[0]
    program_job(prog, rays, start, jseed, n)          # warm-up: one job
    if trace:
        H.start_profiler()
    H.sync(dev)
    count0 = program_coreslam.counters()

    trace_at = seconds / 2 if trace else math.inf
    tracer, traced, attempts = None, None, 0
    jobs, sums, job_ends = [], [], []
    sample = H.Reservoir(seed)
    last_maps = None
    steps = 0
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = False
    while not done:
        st = prog.init(start, jseed)
        poses, bests = [], []
        for t in range(n):
            if t == 0 and traced is None and \
                    time.perf_counter() - t0 >= trace_at:
                tracer = H.Trace(dev).__enter__()
                traced = {"steps": 0}
            st, p, s = prog.step(st, rays.angles, rays.radii[t],
                                 rays.valid[t])
            poses.append(p)
            bests.append(s)
            steps += 1
            if tracer is not None:
                traced["steps"] += 1
                if traced["steps"] == traffic["trace_steps"]:
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
        sums.append(torch.stack(bests))
        job_ends.append(time.perf_counter())
        if len(poses) == n:
            sample.offer((len(jobs) - 1, maps_of(st)))
        last_maps = maps_of(st)
    H.sync(dev)
    elapsed = time.perf_counter() - t0
    count1 = program_coreslam.counters()
    if trace:
        if "tracer" not in traced:
            raise H.no_trace()
        summary = traced.pop("tracer").summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = torch.stack([torch.isfinite(j).all(dim=-1).sum() for j in jobs])
    failed = steps - int(finite.sum())
    del st

    result = {"correct": False, "attempted": steps, "failed": failed}
    if trace:
        result["metrics"] = {}
        for m in per_layer:
            v = H.reader(m["name"])({"summary": summary})
            if v is not None:
                result["metrics"][m["name"]] = v
        result["breakdown"] = H.breakdown(summary)
        busy = H.busy_us(summary["device_ops"]) * 1e-6
        result["device"] = {**H.device_info(dev, 1, peak), "busy_s": busy,
                            "window_s": summary["window_s"]}
        s = traced["steps"]
        kernels = sum(1 for k, _, _ in summary["device_ops"]
                      if H.is_kernel(k))
        H.say(f"traced {s} scans: {kernels / s:.1f} kernels, "
              f"{len(summary['device_ops']) / s:.1f} device operations and "
              f"{busy * 1e6 / s:.2f} us busy a scan; idle "
              f"{100 * (1 - busy / summary['window_s']):.2f}% of "
              f"{summary['window_s'] * 1e6 / s:.1f} us a scan")
    else:
        result["metrics"] = {"scans_per_s": steps / elapsed,
                             "setup_s": setup_s}
        result["device"] = H.device_info(dev, 1, peak)
    H.say(f"{name}: {len(jobs)} jobs, {steps} scans in {elapsed:.3f} s; "
          f"set-up {setup_s:.3f} s")
    if count0["searches"] is not None:
        H.say(f"program counters: {count1['searches']} searches, "
              f"{count1['candidates']} candidates in all; in the window "
              f"{count1['searches'] - count0['searches']} searches, "
              f"{count1['candidates'] - count0['candidates']} candidates")
    else:
        H.say("program counters: none in this program")
    result["host_pace"] = H.host_pace(dev)
    H.say(f"host pace at the close: {result['host_pace']}")
    if len(jobs) > 2:     # the host's pace through the window, job by job
        js = np.diff([t0] + job_ends)[:-1] * 1e3
        fifths = [round(float(np.median(c)), 1)
                  for c in np.array_split(js, min(5, len(js)))]
        H.say(f"job ms: min {js.min():.1f}, median {np.median(js):.1f}, "
              f"max {js.max():.1f}; by fifths of the window {fifths}")

    # ---- the reference, once the window has closed ----------------------
    kept = sample.item
    rcfg = R.RefConfig(cfg["coreslam"])
    rposes, rsums, snaps, rst = R.replay(
        rcfg, rays.angles, rays.radii, rays.valid, start, jseed, n,
        {len(jobs[-1]), n}, sequential=True)
    gap = np.abs(rst.seq_hole - rst.hole.cpu().numpy().astype(np.int64))
    H.say(f"slam.net's blend in beam order, at the reference's poses, would "
          f"change {int((gap > 0).sum())} of {gap.size} hole-map pixels of "
          f"the job's final map, by at most {int(gap.max())}")
    checks = compare(cfg["limits"], jobs, sums, last_maps,
                     kept[1] if kept is not None else None, rposes, rsums,
                     snaps, n, failed)
    result["correct"] = H.judge(checks)
    return result, checks
