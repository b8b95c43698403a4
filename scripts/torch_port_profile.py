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
``sub4_onehot``, ``sub4_onehot_cap8``, ``sub4_onehot_cap32``,
``sub1_exit``, ``sub4_onehot_exit``), or with ``--graph`` a scan of the graph-SLAM replay (the 512
scans of the turning revisit, the first 12 forced; ``--mode`` ``gather``,
the default, or ``pallas_full``), with ``--office`` a scan of the office
loop's graph-SLAM replay (689 scans, the first 10 forced; ``--mode graph``,
the default, or ``hector`` for Hector alone), or with ``--coreslam`` a scan
of CoreSLAM's replay of the 522 loop scans (``--mode production``, the
default, or ``parity``), or with ``--particle`` a scan of the particle
layer's replay of the 522 loop scans at 8192 particles (``--mode exact``,
the default, or another of ``replay.PARTICLE_MODES``: ``sub4``, ``grid``,
``grid_small``, ``grid_dense``; generator seed 1).

    python3 scripts/torch_port_profile.py [--fleet | --graph | --office |
        --coreslam | --particle] [--mode M] [--out DIR]
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
    ap.add_argument("--mode", choices=sorted({*SINGLE, *FLEET, *GRAPH,
                                              *OFFICE, *CORESLAM, *PARTICLE}),
                    help="the configuration (default pallas_dense, "
                         "sub4_pallas_dense with --fleet, gather with "
                         "--graph, graph with --office, production with "
                         "--coreslam, exact with --particle)")
    args = ap.parse_args()
    kind = ("fleet" if args.fleet else "graph" if args.graph else "office"
            if args.office else "coreslam" if args.coreslam else "particle"
            if args.particle else "single")
    modes = {"fleet": FLEET, "graph": GRAPH, "office": OFFICE,
             "coreslam": CORESLAM, "particle": PARTICLE,
             "single": SINGLE}[kind]
    mode = args.mode or next(iter(modes))
    if mode not in modes:
        ap.error(f"--mode {mode} is not a {kind} mode: {sorted(modes)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    make = {"fleet": _fleet, "graph": _graph, "office": _office,
            "coreslam": _coreslam, "particle": _particle,
            "single": _single}[kind]
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                       # union of kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
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
