"""Closed-loop particle-layer replay jobs: ``models/particle.update`` over
every scan of the simulator's loop log, as fast as the program goes.

Set-up makes the log from the seed (``logs.make_log``) and runs one whole
job.  The window then runs jobs back to back.  Each starts from a fresh
particle layer at the log's first true pose (timed), its draws' generator
seeded with one job seed drawn from the seed, the same for every job, and
steps it through every scan: the log's cloud, with the layer's own
estimate as the odometry; the first ``position_search_beginning`` scans
trust it, the rest run the whole step.  The host's clock is read after
every scan; once ``seconds`` have passed the window closes after that scan
and waits for the card.  ``scans_per_s`` is every scan enqueued over the
window's seconds up to the card's end, job starts included.  A traced run
traces ``trace_steps`` scans of a job from its scan ``trace_from`` on.

The answers judged, against the plain reference (``reference_particle``)
replaying one job on the same card once the window has closed: every
estimate, best sum, resample flag and effective sample size of every job
(a partial last job included), and the population, the hole map and the
obstacle map of the last job and of one whole job drawn from the seed.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness as H
from .. import logs, program_particle
from .. import reference_coreslam as C
from .. import reference_particle as R


def job_seed(seed: int) -> int:
    """The draws' generator seed of every job, drawn from ``seed``."""
    return logs.derived_seeds(seed, 1)[0]


def program_job(prog, log: logs.Log, start: torch.Tensor, seed: int,
                n: int):
    """One job through the program: (estimates f32[n, 3], best sums
    i32[n], ESS f32[n], resampled bool[n], the final state)."""
    st = prog.init(start, seed)
    outs = []
    for t in range(n):
        st, out = prog.step(st, log.points[t], log.valid[t])
        outs.append(out)
    return (*stack(outs), st)


def stack(outs: list) -> tuple:
    """A job's per-scan outputs as (estimates, best sums, ESS, flags)."""
    return tuple(torch.stack(x) for x in zip(*outs))


def pop_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Particles f32[P, 3] that differ from the reference's, NaN
    counted."""
    return int((~(a == b).all(dim=-1)).sum())


def compare(limits: dict, jobs: list, finals: list, ref: tuple, snaps: dict,
            n: int, failed: int) -> dict:
    """Every number compared, with its limit: over every job (a job of
    ``len`` scans against the reference's first ``len``), the widest
    estimate gaps, the scans whose best sum or resample flag differs and
    the widest relative ESS gap; of the last job (against
    ``snaps[len(jobs[-1][0])]``) and of the kept whole job (``finals[1]``,
    against ``snaps[n]``), the particles and map cells that differ."""
    rposes, rsums, ress, rflags = ref
    xy, th = np.max([H.pose_gaps(j[0], rposes[:len(j[0])]) for j in jobs],
                    axis=0).tolist()
    sums_off = sum(int((j[1].to(torch.int64) != rsums[:len(j[1])]).sum())
                   for j in jobs)
    flags_off = sum(int((j[3] != rflags[:len(j[3])]).sum()) for j in jobs)
    ess_gap = max(float(((j[2].double() - ress[:len(j[2])].double()).abs()
                         / ress[:len(j[2])].double()).nan_to_num(math.inf)
                        .max()) for j in jobs)
    pairs = [(finals[0], snaps[len(jobs[-1][0])])]
    if finals[1] is not None:
        pairs.append((finals[1], snaps[n]))
    parts = max(pop_gap(a[0], b[0]) for a, b in pairs)
    hole = max(int((a[1] != b[1]).sum()) for a, b in pairs)
    obst = max(int((a[2] != b[2]).sum()) for a, b in pairs)
    return {"pose_gap_m": (xy, limits["pose_gap_m"]),
            "heading_gap_rad": (th, limits["heading_gap_rad"]),
            "best_sum_scans_differing": (sums_off,
                                         limits["best_sum_scans_differing"]),
            "resample_flags_differing": (flags_off,
                                         limits["resample_flags_differing"]),
            "ess_rel_gap": (ess_gap, limits["ess_rel_gap"]),
            "particles_differing": (parts, limits["particles_differing"]),
            "hole_pixels_differing": (hole, limits["hole_pixels_differing"]),
            "obstacle_cells_differing": (obst,
                                         limits["obstacle_cells_differing"]),
            "failed_scans": (failed, 0)}


def work_of(cfg: dict, beams: int, valid_counts: list) -> dict:
    """The traced scans' scoring work as the roofline reader counts it."""
    p = cfg["particle"]
    return {"batches": [p["num_particles"],
                        p["top_k"] * p["refine_candidates"]],
            "valid_beams": valid_counts, "beams": beams,
            "map_pixels": cfg["coreslam"]["hole_map_size"] ** 2}


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    """One run of the cell: (result without ``checks``, checks)."""
    dev = torch.device(device)
    n = traffic["scans"]
    log = logs.make_log(seed, n, cfg["sensor"], dev)
    valid_counts = log.valid.sum(dim=1).tolist()
    prog = program_particle.Particles(cfg, dev)
    jseed = job_seed(seed)
    start = log.traj[0]
    program_job(prog, log, start, jseed, n)          # warm-up: one job
    if trace:
        H.start_profiler()
    H.sync(dev)
    count0 = program_particle.counters()

    trace_at = seconds / 2 if trace else math.inf
    trace_from = traffic["trace_from"]
    tracer, traced, attempts = None, None, 0
    jobs, job_ends = [], []
    sample = H.Reservoir(seed)
    last = None
    steps = 0
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = False
    while not done:
        st = prog.init(start, jseed)
        outs = []
        for t in range(n):
            if t == trace_from and traced is None and \
                    time.perf_counter() - t0 >= trace_at:
                tracer = H.Trace(dev).__enter__()
                traced = {"steps": 0, "from": t,
                          "count0": program_particle.counters()}
            st, out = prog.step(st, log.points[t], log.valid[t])
            outs.append(out)
            steps += 1
            if tracer is not None:
                traced["steps"] += 1
                if traced["steps"] == traffic["trace_steps"]:
                    tracer.__exit__(None, None, None)
                    traced["count1"] = program_particle.counters()
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
        jobs.append(stack(outs))
        job_ends.append(time.perf_counter())
        last = prog.final(st)
        if len(outs) == n:
            sample.offer((len(jobs) - 1, last))
        del st
    H.sync(dev)
    elapsed = time.perf_counter() - t0
    count1 = program_particle.counters()
    if trace:
        if "tracer" not in traced:
            raise H.no_trace()
        summary = traced.pop("tracer").summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = torch.stack([torch.isfinite(j[0]).all(dim=-1).sum()
                          for j in jobs])
    failed = steps - int(finite.sum())

    result = {"correct": False, "attempted": steps, "failed": failed}
    if trace:
        s, f = traced["steps"], traced["from"]
        c0, c1 = traced["count0"], traced["count1"]
        tcounts = None if c0["steps"] is None else \
            {k: c1[k] - c0[k] for k in program_particle.COUNTERS}
        ctx = {"summary": summary, "steps": s, "counters": tcounts,
               "work": work_of(cfg, log.valid.shape[1],
                               valid_counts[f:f + s]),
               "peaks": H.load_json(H.HERE / "peaks.json")}
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
        H.say(f"traced {s} scans from scan {f}: {kernels / s:.1f} kernels, "
              f"{len(summary['device_ops']) / s:.1f} device operations and "
              f"{busy * 1e6 / s:.2f} us busy a scan; idle "
              f"{100 * (1 - busy / summary['window_s']):.2f}% of "
              f"{summary['window_s'] * 1e6 / s:.1f} us a scan")
        H.say(f"traced counters: {tcounts}")
    else:
        result["metrics"] = {"scans_per_s": steps / elapsed,
                             "setup_s": setup_s}
        result["device"] = H.device_info(dev, 1, peak)
    H.say(f"{name}: {len(jobs)} jobs, {steps} scans in {elapsed:.3f} s; "
          f"set-up {setup_s:.3f} s")
    if count0["steps"] is not None:
        H.say("program counters in the window: " + ", ".join(
            f"{k} {count1[k] - count0[k]}"
            for k in program_particle.COUNTERS))
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
    t_ref = time.perf_counter()
    *ref, snaps, _ = R.replay(
        C.RefConfig(cfg["coreslam"]), R.PConfig(cfg["particle"]),
        log.points, log.valid, start, jseed, n, {len(jobs[-1][0]), n})
    H.say(f"reference: {time.perf_counter() - t_ref:.1f} s for a job; "
          f"{int(ref[3].sum())} of {n} scans resampled")
    checks = compare(cfg["limits"], jobs,
                     [last, kept[1] if kept is not None else None],
                     tuple(ref), snaps, n, failed)
    result["correct"] = H.judge(checks)
    return result, checks
