"""An open-loop live robot: scans due at the sensor's rate, each pose read
back to the host as a robot that navigates on it must.

Set-up makes one loop log of ``bootstrap + ceil(seconds * rate_hz)``
scans, maps the bootstrap scans at their true poses and warms the step on
a copy.  Scan k is due at t0 + k / rate_hz whether or not scan k-1 is done;
the generator sleeps, then spins the last ``SPIN_S``, until it is due.  A
scan's latency runs from its due time to its pose on the host, so a stall
delays the scans queued behind it too.  A scan is in time when its pose is
on the host before the next scan is due; ``scans_in_time_pct`` is over
every scan of the window.  The latency's percentiles are per-layer
metrics, read in a traced run over the scans before the traced stretch (the
trace's set-up and the profiler delay the scans from there on); every run
prints them over all scans on standard error.  How late the generator
issued each scan is reported beside them.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness as H
from .. import logs, program
from .replay import (bootstrap, layer_context, read_layers,
                     reference_replay)

# The generator sleeps until SPIN_S before a scan is due, then spins: under
# the host's load a sleep woke up to ~18 ms late, and a late issue counts
# in the scan's latency.
SPIN_S = 0.02


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    dev = torch.device(device)
    rate = traffic["rate_hz"]
    boot = traffic["bootstrap"]
    n = math.ceil(seconds * rate)
    lg = logs.make_log(seed, boot + n, cfg["sensor"], dev)
    log = logs.Log(lg.traj[:, None], lg.points[:, None], lg.valid[:, None])
    prog = program.Robots(cfg["hector"], 1, dev)
    boot_cfg = program.hector_config({**cfg["hector"],
                                      **cfg["bootstrap_overrides"]})
    boot_state = bootstrap(prog, log, boot, boot_cfg)
    P, V = log.points[boot:], log.valid[boot:]
    st = prog.clone(boot_state)
    for t in range(min(traffic["warmup_steps"], n)):
        st, p, _ = prog.step(st, P[t], V[t], False)
        p.cpu()
    st = prog.clone(boot_state)
    if trace:
        H.start_profiler()
    H.sync(dev)

    trace_from = n // 2 if trace else n
    tracer, fired, done_tracer, attempts = None, [], None, 0
    poses = np.zeros((n, 3), np.float32)
    latency = np.zeros(n)
    lateness = np.zeros(n)
    setup_s = time.time() - t_start
    t0 = time.perf_counter() + 0.01
    for k in range(n):
        due = t0 + k / rate
        wait = due - time.perf_counter()
        if wait > SPIN_S:
            time.sleep(wait - SPIN_S)
        while time.perf_counter() < due:
            pass
        if k == trace_from:
            tracer = H.Trace(dev).__enter__()
        lateness[k] = time.perf_counter() - due
        st, p, f = prog.step(st, P[k], V[k], False)
        poses[k] = p[0].cpu().numpy()
        latency[k] = time.perf_counter() - due
        if tracer is not None:
            fired.append(f)
            if len(fired) == traffic["trace_steps"]:
                tracer.__exit__(None, None, None)
                attempts += 1
                if tracer.recorded:
                    done_tracer = tracer
                elif attempts < H.TRACE_ATTEMPTS:
                    trace_from, fired = k + 1, []   # trace the next scans
                tracer = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        done_tracer = tracer if tracer.recorded else None
    if trace:
        if done_tracer is None:
            raise H.no_trace()
        summary = done_tracer.summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~np.isfinite(poses).all(axis=1)).sum())
    result = {"correct": False, "attempted": n, "failed": failed}
    if trace:
        traced = {"fired": fired, "first": trace_from, "job": 0,
                  "summary": summary}
        ctx = layer_context(traced, [torch.from_numpy(poses)[:, None].to(dev)],
                            log, boot, cfg, 1, dev)
        ctx["latency_s"] = latency[:n // 2]    # the scans before the trace
        result["metrics"] = read_layers(per_layer, ctx)
        result["breakdown"] = H.breakdown(summary)
        dev_extra = {"busy_s": H.busy_us(summary["device_ops"]) * 1e-6,
                     "window_s": summary["window_s"]}
    else:
        result["metrics"] = {
            "scans_in_time_pct": 100.0 * float((latency < 1.0 / rate).mean()),
            "setup_s": setup_s}
        dev_extra = {}
    result["device"] = {**H.device_info(dev, 1, peak), **dev_extra}
    late = {"max_ms": float(lateness.max() * 1e3),
            "p95_ms": H.percentile(lateness, 95) * 1e3,
            "mean_ms": float(lateness.mean() * 1e3)}
    result["generator_lateness"] = late
    result["latency_ms"] = {"p50": H.percentile(latency, 50) * 1e3,
                            "p95": H.percentile(latency, 95) * 1e3,
                            "max": float(latency.max() * 1e3)}
    result["host_pace"] = H.host_pace(dev)
    H.say(f"host pace at the close: {result['host_pace']}")
    H.say(f"{name}: {n} scans at {rate} Hz; generator late by at most "
          f"{late['max_ms']:.4f} ms (p95 {late['p95_ms']:.4f}); set-up "
          f"{setup_s:.3f} s")
    H.say(f"latency ms over all scans: p50 {result['latency_ms']['p50']:.4f},"
          f" p95 {result['latency_ms']['p95']:.4f}, max "
          f"{result['latency_ms']['max']:.4f}; in time (before the next "
          f"scan is due) {int((latency < 1.0 / rate).sum())} of {n}")

    # ---- the reference, once the window has closed -----------------------
    final_maps = st.maps
    del st
    rmaps0, rposes, _, rsnaps = reference_replay(cfg, log, boot, 1, {n})
    xy, th = H.pose_gaps(torch.from_numpy(poses).to(dev), rposes[:, 0])
    cells = max(H.cells_differing(boot_state.maps, rmaps0),
                H.cells_differing(final_maps, rsnaps[n]))
    checks = H.checks_of(cfg["limits"], xy, th, cells, failed)
    result["correct"] = H.judge(checks)
    return result, checks
