#!/usr/bin/env python3
"""Where the time of slamnet_tpu_torch's replays goes, on one GPU.

Makes the loop log, bootstraps, runs one warm-up replay, times one more replay
without the profiler, then traces one replay with ``torch.profiler`` (CPU +
CUDA).  Prints one JSON object: wall time per step, the device's busy share of
the traced replay (the union of its kernels' intervals over the replay's span),
and the device kernels by total time, each with its calls and its mean,
median, least and largest time a call.  A step is a scan of the single-robot
replay (512 scans after a 10-scan fixed-mode bootstrap; ``--mode``
``pallas_dense``, the default, ``fixed`` or ``onehot_bf16_dense``), with
``--fleet`` a batch-scan of the 64-robot fleet (64 batch-scans after a
10-batch-scan bootstrap; ``--mode`` ``sub4_pallas_dense``, the default,
or any other of ``replay.FLEET_MODES``: ``sub1``, ``sub4``,
``sub4_onehot``, ``sub4_onehot_dense``, ``sub4_onehot_cap8``, ``sub4_onehot_cap32``,
``sub1_exit``, ``sub4_onehot_exit``), or with ``--graph`` a scan of the graph-SLAM replay (the 512
scans of the turning revisit, the first 12 forced; ``--mode`` ``gather``,
the default, or ``pallas_full``), with ``--office`` a scan of the office
loop's graph-SLAM replay (689 scans, the first 10 forced; ``--mode graph``,
the default, or ``hector`` for Hector alone), or with ``--coreslam`` a scan
of CoreSLAM's replay of the 522 loop scans (``--mode production``, the
default, or ``parity``), or with ``--particle`` a scan of the particle
layer's replay of the 522 loop scans at 8192 particles (``--mode exact``,
the default, or another of ``replay.PARTICLE_MODES``: ``sub4``, ``grid``,
``grid_small``, ``grid_dense``; generator seed 1), or with ``--dataset`` a
scan of the dataset replay of a checked-in CARMEN log (Hector's K3 + K4 and
CoreSLAM correlative, ``replay.carmen_replay``; ``--mode adversarial``, the
default, the 360 scans of ``adversarial_180.clf`` with the robust guards, or
``sim_loop``, the 120 scans of ``sim_loop.clf``), or with ``--sharded`` a
scan of ``models/hector_sharded`` (the fixed config at full width over the
loop log, 10 forced and 10 warm-up scans first, then ``SHARDED_STEPS``
timed and traced) on gloo ranks sharing the card: ``--mode 2x4``, the
default, or ``4x2`` (8 ranks), or ``1x1`` (one rank, no other process on
the card).  Rank 0 is traced; beside its kernels the JSON gives its
collectives and host copies a scan.  With ``--sharded-graph`` the whole of
``dryrun_multichip``'s section 3 (``replay.sharded_graph_replay``: 71 scans
of ``models/graph_slam_sharded`` on the 2x4 mesh, the onehot_bf16 pyramid)
is run once, then timed and traced on rank 0: ``--mode onehot_bf16``, the
default (the frontend's K1 + K2), or ``gather`` (K3 + K4); beside rank 0's
kernels a scan and busy time, the JSON gives the collectives a scan and a
keyframe event.

    python3 scripts/torch_port_profile.py [--fleet | --graph | --office |
        --coreslam | --particle | --dataset | --sharded | --sharded-graph]
        [--mode M] [--out DIR]
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from slamnet_tpu_torch import replay  # noqa: E402
from slamnet_tpu_torch.models import fleet, hector  # noqa: E402


SINGLE = {"pallas_dense": replay.pallas_dense_config,
          "fixed": replay.fixed_config,
          "onehot_bf16_dense": replay.onehot_bf16_dense_config}
FLEET = {"sub4_pallas_dense": replay.sub4_pallas_dense_config,
         **replay.FLEET_MODES}
GRAPH = {"gather": replay.graph_gather_config,
         "pallas_full": replay.graph_pallas_full_config}
OFFICE = {"graph": lambda: replay.office_config(),
          "hector": lambda: replay.office_config()[:1]}
CORESLAM = {"production": replay.coreslam_production_config,
            "parity": replay.coreslam_parity_config}
PARTICLE = {name: (lambda cfgs=cfgs: cfgs)
            for name, cfgs in replay.PARTICLE_MODES.items()}
DATASET = {"adversarial": lambda: (replay.ADVERSARIAL_LOG, True),
           "sim_loop": lambda: (replay.SIM_LOOP_LOG, False)}
SHARDED = {"2x4": 8, "4x2": 8, "1x1": 1}       # mesh -> ranks
SHARDED_STEPS = 40
SHARDED_GRAPH = {"onehot_bf16": 8, "gather": 8}   # frontend -> ranks


def _single(dev, cfg):
    log = replay.make_log(seed=0)
    dlog = replay.to_device(log, dev)
    st0 = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog,
                           log.bootstrap, cfg)
    return (dlog.points.shape[0] - log.bootstrap,
            lambda: replay.replay(st0, dlog, log.bootstrap, cfg))


def _fleet(dev, cfg):
    flog = replay.make_fleet_log(replay.make_log(seed=0))
    dlog = replay.to_device(flog, dev)
    b = flog.bootstrap
    st0 = replay.fleet_bootstrap(fleet.init_fleet(cfg, flog.traj[0], dev),
                                 dlog, b, cfg)
    return (dlog.points.shape[0] - b,
            lambda: fleet.replay_fleet(st0, dlog.points[b:], dlog.valid[b:],
                                       cfg))


def _graph(dev, cfgs):
    dlog = replay.to_device(replay.make_graph_log(), dev)
    return (dlog.points.shape[0],
            lambda: replay.graph_replay(dlog, *cfgs))


def _office(dev, cfgs):
    log = replay.make_office_log()
    dlog = replay.to_device(log, dev)
    odo, deltas = (torch.from_numpy(a).to(dev)
                   for a in replay.office_odometry(log.traj))
    return (dlog.points.shape[0],
            lambda: replay.office_replay(dlog, odo, deltas, *cfgs))


def _coreslam(dev, cfg):
    dlog = replay.to_device(replay.make_log(seed=0), dev)
    return dlog.points.shape[0], lambda: replay.coreslam_replay(dlog, cfg)


def _particle(dev, cfgs):
    dlog = replay.to_device(replay.make_log(seed=0), dev)
    return dlog.points.shape[0], lambda: replay.particle_replay(dlog, *cfgs)


def _dataset(dev, spec):
    path, robust = spec
    data = replay.load_carmen(path, dev, truth=replay.sim_loop_truth(120))
    cfgs = replay.dataset_config(robust)
    return data.points.shape[0], lambda: replay.carmen_replay(data, *cfgs)


def _busy_us(kernels) -> tuple:
    """The union of the kernels' intervals (us) and the span they cover."""
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
    return busy, (spans[-1][1] - spans[0][0]) if spans else 0.0


def sharded_rank(mesh_name: str) -> dict:
    """One rank of ``--sharded``: the replay timed, then traced on rank 0."""
    from slamnet_tpu_torch.parallel import make_mesh
    axes = {"1x1": {"tile": 1, "search": 1}, **replay.SHARDED_MESHES}
    m = make_mesh(axes[mesh_name])
    cfg = replay.fixed_config()
    log = replay.make_log(seed=0)
    start = log.bootstrap + 10
    dlog = replay.head(replay.to_device(log, m.device), start + SHARDED_STEPS)
    st, _ = replay.sharded_replay(m, replay.head(dlog, start), cfg)

    def run():
        replay.sharded_replay(m, dlog, cfg, state=st, start=start)
        torch.cuda.synchronize(m.device)

    c0 = dict(m.counts)
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    per = {k: (m.counts[k] - c0[k]) / SHARDED_STEPS for k in c0}
    if m.rank != 0:
        run()                                   # the traced run's partners
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, window = _busy_us(kernels)
    return {"device": torch.cuda.get_device_name(0), "path": "sharded",
            "mode": mesh_name, "ranks": m.size, "backend": m.backend,
            "steps": SHARDED_STEPS,
            "wall_us_per_step": wall / SHARDED_STEPS * 1e6,
            "traced_wall_us_per_step": traced / SHARDED_STEPS * 1e6,
            "rank0_kernels_per_step": len(kernels) / SHARDED_STEPS,
            "rank0_device_busy_us_per_step": busy / SHARDED_STEPS,
            "rank0_busy_share_of_traced_wall": busy / (traced * 1e6),
            "collectives_per_step": per["collectives"],
            "host_copies_per_step": per["host_copies"]}


def sharded_graph_rank(frontend_mode: str) -> dict:
    """One rank of ``--sharded-graph``: section 3 once (the warm-up), then
    timed, then traced on rank 0."""
    from slamnet_tpu_torch.models import graph_slam_sharded as gss
    from slamnet_tpu_torch.parallel import make_mesh
    m = make_mesh(replay.SHARDED_MESHES[replay.SHARDED_GRAPH_MESH])
    hcfg, gcfg, mcfg, cap = replay.sharded_graph_config(frontend_mode)
    log = replay.make_sharded_graph_log()
    dlog = replay.to_device(log, m.device)
    n = dlog.points.shape[0]
    step = gss.make_step(m, hcfg, gcfg, dlog.points.shape[1], mcfg,
                         sep_capacity=cap)

    def run():
        replay.sharded_graph_replay(m, dlog, hcfg, gcfg, mcfg, cap,
                                    step=step)
        torch.cuda.synchronize(m.device)

    run()
    c0, flags0 = dict(m.counts), len(step.flags)
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    per = {k: (m.counts[k] - c0[k]) / n for k in c0}
    events = sum(f[0] for f in step.flags[flags0:])
    hector_coll = sum(hcfg.estimate_iterations) + 2
    if m.rank != 0:
        run()                                   # the traced run's partners
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, window = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return {"device": torch.cuda.get_device_name(0), "path": "sharded_graph",
            "mode": frontend_mode, "ranks": m.size, "backend": m.backend,
            "steps": n, "keyframe_events": events,
            "wall_us_per_step": wall / n * 1e6,
            "traced_wall_us_per_step": traced / n * 1e6,
            "rank0_kernels_per_step": len(kernels) / n,
            "rank0_device_busy_us_per_step": busy / n,
            "rank0_busy_share_of_traced_wall": busy / (traced * 1e6),
            "collectives_per_step": per["collectives"],
            "collectives_per_keyframe_event":
                (per["collectives"] - hector_coll) * n / max(events, 1),
            "host_copies_per_step": per["host_copies"],
            "rank0_kernels_by_total_us": [
                {"name": k[:90], "calls": len(d), "total_us": sum(d)}
                for k, d in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the Chrome trace")
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--fleet", action="store_true",
                      help="the 64-robot fleet instead of the single robot")
    path.add_argument("--graph", action="store_true",
                      help="graph-SLAM instead of the single robot")
    path.add_argument("--office", action="store_true",
                      help="the office loop instead of the single robot")
    path.add_argument("--coreslam", action="store_true",
                      help="CoreSLAM instead of the single robot")
    path.add_argument("--particle", action="store_true",
                      help="the particle layer instead of the single robot")
    path.add_argument("--dataset", action="store_true",
                      help="the dataset replay of a checked-in CARMEN log")
    path.add_argument("--sharded", action="store_true",
                      help="hector_sharded on gloo ranks sharing the card")
    path.add_argument("--sharded-graph", action="store_true",
                      help="graph_slam_sharded on gloo ranks sharing the "
                           "card")
    ap.add_argument("--mode", choices=sorted({*SINGLE, *FLEET, *GRAPH,
                                              *OFFICE, *CORESLAM, *PARTICLE,
                                              *DATASET, *SHARDED,
                                              *SHARDED_GRAPH}),
                    help="the configuration (default pallas_dense, "
                         "sub4_pallas_dense with --fleet, gather with "
                         "--graph, graph with --office, production with "
                         "--coreslam, exact with --particle, adversarial "
                         "with --dataset, 2x4 with --sharded, "
                         "onehot_bf16 with --sharded-graph)")
    args = ap.parse_args()
    kind = ("fleet" if args.fleet else "graph" if args.graph else "office"
            if args.office else "coreslam" if args.coreslam else "particle"
            if args.particle else "dataset" if args.dataset else "sharded"
            if args.sharded else "sharded_graph" if args.sharded_graph
            else "single")
    modes = {"fleet": FLEET, "graph": GRAPH, "office": OFFICE,
             "coreslam": CORESLAM, "particle": PARTICLE, "dataset": DATASET,
             "sharded": SHARDED, "sharded_graph": SHARDED_GRAPH,
             "single": SINGLE}[kind]
    mode = args.mode or next(iter(modes))
    if mode not in modes:
        ap.error(f"--mode {mode} is not a {kind} mode: {sorted(modes)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if kind in ("sharded", "sharded_graph"):
        from slamnet_tpu_torch.parallel import launch
        target, kwargs = (("sharded_rank", {"mesh_name": mode})
                          if kind == "sharded" else
                          ("sharded_graph_rank", {"frontend_mode": mode}))
        out = launch.launch(f"torch_port_profile:{target}", modes[mode],
                            kwargs, backend="gloo",
                            timeout_s=900, pythonpath=[os.path.dirname(
                                os.path.abspath(__file__))])
        print(json.dumps(out[0]))
        return 0
    dev = torch.device("cuda", 0)
    make = {"fleet": _fleet, "graph": _graph, "office": _office,
            "coreslam": _coreslam, "particle": _particle,
            "dataset": _dataset, "single": _single}[kind]
    n, run = make(dev, modes[mode]())
    run()                                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, window = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"trace_{mode}.json"))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": kind, "mode": mode, "steps": n,
        "wall_us_per_step": wall / n * 1e6,
        "traced_wall_us_per_step": traced / n * 1e6,
        "device_kernels": len(kernels),
        "kernels_per_step": len(kernels) / n,
        "device_busy_us_per_step": busy / n,
        "device_busy_share_of_kernel_window": busy / window if window else 0.0,
        "device_busy_share_of_traced_wall": busy / (traced * 1e6),
        "kernels_by_total_us": [
            {"name": k[:90], "calls": len(d), "total_us": sum(d),
             "avg_us": sum(d) / len(d), "median_us": statistics.median(d),
             "min_us": min(d), "max_us": max(d)}
            for k, d in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
