"""Sharded replay jobs: one robot's map row-tiled and its scan beam-sharded
over a mesh of ranks, one card a rank (``hector_sharded.make_step``'s
``Step``), closed loop.

The parent process starts the ranks through the program's own launcher
(``parallel/launch.py``, NCCL on the card, gloo on the CPU) and touches no
card until they have exited: one process a card.  Every rank makes the log
from the seed and takes rank 0's copy (one broadcast), bootstraps the
sharded state at the true poses, and warms the step.  Rank 0's window then
runs jobs back to back from a copy of the bootstrapped state; every
``stop_every`` scans rank 0 tells the others over a host-side (gloo) group
whether its window has closed, so every rank stops after the same scan.
``scans_per_s`` is rank 0's scans over its window up to its card's end.

Afterwards the tiles are gathered into dense maps, rank 0 writes the log and
every answer to a file in a temporary directory, and the parent, alone on
the cards by then, runs the dense plain reference over the same scans on
the first card and compares every pose, the bootstrapped maps, the last
job's maps and those of a completed job drawn from the seed.
"""
from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import harness as H
from .. import logs, program
from .replay import reference_replay


def run(name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, per_layer: list) -> tuple:
    from slamnet_tpu_torch.parallel import launch
    ranks = math.prod(traffic["mesh"].values())
    cpu = torch.device(device).type == "cpu"
    with tempfile.TemporaryDirectory(prefix="slambench_") as work:
        res = launch.launch(
            "slambench.kinds.sharded:rank_main", ranks,
            {"cfg": cfg, "traffic": traffic, "seed": seed,
             "seconds": seconds, "trace": trace, "t_start": t_start,
             "out": work, "per_layer": [m["name"] for m in per_layer],
             "device": "cpu" if cpu else None},
            backend="gloo" if cpu else "nccl", timeout_s=seconds + 300.0)
        out = dict(np.load(Path(work) / "rank0.npz"))
    bad = sorted({m for r in res for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded modules of JAX or the JAX "
                           f"package: {bad}")
    r0 = res[0]
    dev = torch.device("cpu" if cpu else "cuda:0")
    attempted = r0["steps"]
    poses = torch.from_numpy(out["poses"]).to(dev)
    failed = int((~torch.isfinite(poses).all(dim=-1)).sum())
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": r0["metrics"]}
    if trace:
        result["breakdown"] = r0["breakdown"]
    if not trace:
        result["metrics"] = {"scans_per_s": attempted / r0["elapsed"],
                             "setup_s": r0["setup_s"]}
    result["device"] = {
        **H.device_info(dev, ranks, max(r["peak"] for r in res)),
        **({"busy_s": r0["busy_s"], "window_s": r0["window_s"]}
           if trace else {})}
    H.say(f"{name}: {ranks} ranks on {[r['device'] for r in res]}, "
          f"{r0['jobs']} jobs, {attempted} scans in {r0['elapsed']:.3f} s; "
          f"set-up {r0['setup_s']:.3f} s")

    # ---- the dense reference, alone on the cards -------------------------
    boot, tracked = traffic["bootstrap"], traffic["tracked"]
    log = logs.Log(*(torch.from_numpy(out[k]).to(dev)[:, None]
                     for k in ("traj", "points", "valid")))
    log = log._replace(valid=log.valid.bool())
    lens = out["lens"].tolist()
    rmaps0, rposes, _, snaps = reference_replay(cfg, log, boot, 1,
                                                {lens[-1], tracked})
    gaps = [H.pose_gaps(j, rposes[:n, 0])
            for j, n in zip(torch.split(poses, lens), lens)]
    xy, th = np.max(gaps, axis=0).tolist()
    maps = {k: torch.from_numpy(out[k]).to(dev) for k in
            ("boot_maps", "last_maps", "kept_maps") if k in out}
    cells = max(H.cells_differing(maps["boot_maps"], rmaps0),
                H.cells_differing(maps["last_maps"], snaps[lens[-1]]),
                H.cells_differing(maps["kept_maps"], snaps[tracked])
                if "kept_maps" in maps else 0)
    checks = H.checks_of(cfg["limits"], xy, th, cells, failed)
    result["correct"] = H.judge(checks)
    return result, checks


def rank_main(cfg: dict, traffic: dict, seed: int, seconds: float,
              trace: bool, t_start: float, out: str, per_layer: list,
              device: str | None) -> dict:
    """One rank of the cell (``parallel/rank.py`` has brought the world up
    on this rank's card).  Returns its counts; rank 0 also its window's
    numbers and writes the answers to ``out/rank0.npz``."""
    import torch.distributed as dist
    from slamnet_tpu_torch.models import hector_sharded as hs
    from slamnet_tpu_torch.parallel.mesh import make_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(traffic["mesh"], device)
    ctl = dist.new_group(backend="gloo")       # the window's stop flag
    dev, rank = mesh.device, mesh.rank
    hcfg = program.hector_config(cfg["hector"])
    boot, tracked = traffic["bootstrap"], traffic["tracked"]

    lg = logs.make_log(seed, traffic["log_scans"], cfg["sensor"], dev)
    valid = lg.valid.to(torch.uint8)
    for t in (lg.traj, lg.points, valid):
        dist.broadcast(t, 0)
    lg = lg._replace(valid=valid.bool())
    step = hs.make_step(mesh, hcfg, lg.points.shape[1])
    state = hs.init(mesh, hcfg, lg.traj[0])
    for t in range(boot):
        state = state._replace(match_pose=lg.traj[t].clone())
        state, _ = step(state, lg.points[t], lg.valid[t], True)
    boot_state = state
    P, V = lg.points[boot:], lg.valid[boot:]

    def clone(s):
        return type(s)(*(x.clone() for x in s))
    st = clone(boot_state)
    for t in range(min(traffic["warmup_steps"], tracked)):
        st, _ = step(st, P[t], V[t], False)
    del st
    if trace and rank == 0:
        H.start_profiler()
    H.sync(dev)
    dist.barrier(group=ctl)

    stop = torch.zeros(1, dtype=torch.int32)
    sample = H.Reservoir(seed)
    jobs, lens = [], []
    tracer, traced, summary, attempts = None, 0, None, 0
    steps = 0
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    done = False
    while not done:
        st = clone(boot_state)
        poses = []
        for t in range(tracked):
            if trace and rank == 0 and summary is None and tracer is None \
                    and time.perf_counter() - t0 >= seconds / 2:
                tracer = H.Trace(dev).__enter__()
            st, _ = step(st, P[t], V[t], False)
            poses.append(st.match_pose)
            steps += 1
            if tracer is not None:
                traced += 1
                if traced == traffic["trace_steps"]:
                    tracer.__exit__(None, None, None)
                    attempts += 1
                    if tracer.recorded:
                        summary = tracer
                    elif attempts < H.TRACE_ATTEMPTS:
                        traced = 0             # trace the next scans
                    else:
                        summary = False
                    tracer = None
            if steps % traffic["stop_every"] == 0:
                stop[0] = int(time.perf_counter() - t0 >= seconds
                              and tracer is None
                              and not (trace and summary is None))
                dist.broadcast(stop, 0, group=ctl)
                if stop[0]:
                    done = True
                    break
        jobs.append(torch.stack(poses))
        lens.append(len(poses))
        if len(poses) == tracked:
            sample.offer(st.local_maps)
        last = st.local_maps
    H.sync(dev)
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
        summary = tracer if tracer.recorded else False
    if trace and rank == 0 and not summary:
        raise H.no_trace()
    if summary:
        summary = summary.summary()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    def dense(local):
        return hs.unshard_maps(mesh, st._replace(local_maps=local), hcfg)
    maps = {"boot_maps": dense(boot_state.local_maps),
            "last_maps": dense(last)}
    if sample.item is not None:
        maps["kept_maps"] = dense(sample.item)
    res = {"rank": rank, "device": str(dev), "peak": int(peak),
           "forbidden": H.forbidden_modules(), "steps": steps}
    if rank == 0:
        res.update(elapsed=elapsed, setup_s=setup_s, jobs=len(jobs),
                   metrics={})
        if trace and summary:
            ctx = {"summary": summary, "steps": traced,
                   "robots": 1, "beams": lg.points.shape[1],
                   "hector": cfg["hector"]}
            for name in per_layer:
                v = H.reader(name)(ctx)
                if v is not None:
                    res["metrics"][name] = v
            res.update(breakdown=H.breakdown(summary),
                       busy_s=H.busy_us(summary["device_ops"]) * 1e-6,
                       window_s=summary["window_s"])
        np.savez(Path(out) / "rank0.npz",
                 traj=lg.traj.cpu().numpy(), points=lg.points.cpu().numpy(),
                 valid=lg.valid.cpu().numpy(),
                 poses=torch.cat(jobs).cpu().numpy(), lens=np.array(lens),
                 **{k: v.cpu().numpy() for k, v in maps.items()})
    return res
