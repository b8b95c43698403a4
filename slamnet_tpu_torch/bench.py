"""The port's bench: bench.py's six sections on one card, as one JSON line.

    python -m slamnet_tpu_torch.bench [--all] [--budget-s S] [--device cuda|cpu]

The harness of ``bench.py`` (``bench.py:37-82``) and its sections (hector
``:85-273``, coreslam ``:825-870``, graph ``:556-712``, fleet ``:435-553``,
particle ``:714-823``, office ``:303-432``) over the flows and the gates of
``replay.py``:

  * one JSON line on stdout, printed once: bench.py's keys letter for
    letter, each rate the median of R timed replays (``--repeats``, 5) with
    its ``[min, max]`` beside it (``spread`` for ``value``, ``<key>_spread``
    for the others, ``spread`` in a mode's row); ``sections`` holds each
    section's ``correct``, its failed gate conditions (``fails``), its
    warm-up seconds (``setup_s``) and R (``n``); a mode's row holds its
    kernels' launches a step (``launches_per_step``);
  * a wall-clock budget, ``SLAMNET_BENCH_BUDGET_S`` (default 1050 s, as
    bench.py's) or ``--budget-s``: a section, or a mode past a section's
    anchor, that would start with too little of it left is listed under
    ``skipped``; ``SLAMNET_BENCH_ALL=1`` or ``--all`` runs the full mode
    tables;
  * SIGTERM and SIGINT print the partial line and exit;
  * unlike bench.py, a section that raises is recorded under ``errors`` (its
    traceback on stderr), and an error, a skip, a signal or a failed gate
    makes the exit code non-zero, after the line.

Timing (``timed``), the same in every section: one warm-up replay, its
seconds the mode's ``setup_s`` (the allocator's warm-up; the kernels are
built before the first section, ``build_s``), with the launch counts
(``ops/_build``) zeroed before it; then R replays, each timed by the host clock from its
first launch to a ``torch.cuda.synchronize()``.  No profiler runs, and no
host read happens inside a timed replay but the graph's and the office's
flag a scan (their keyframe branch, ``graph_slam.update``).  bench.py
reports the best of 3-5 runs; this bench reports the median and the spread.
The gates' extra replays (CoreSLAM's nudged starts and seeds, the particle
layer's seeds) run after the timed ones, untimed; the timed key's replay
(nudge 0, seed 1) is their first key, since a replay repeats bit for bit.

The device is the card, with no fallback: without one the bench exits
non-zero at once.  ``--device cpu`` runs the kernels' plain versions, for
the tests, where nothing counts a launch; the section functions take
their depth (and the fleet's robots, the particle count and the gates'
keys) as arguments for the same reason, and the CLI always runs the bench's
sizes.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import replay
from .graph.frontend import ScanMatchConfig
from .models import fleet, hector
from .ops import _build, match

METRIC = "hector_3level_400x400_scans_per_sec_per_chip"
BASELINE_SCANS_PER_S = 17.0       # the reference's real-time rate, bench.py:8
DEFAULT_BUDGET_S = 1050.0
REPEATS = 5
HECTOR_ATE_SLACK_M = 1e-4         # bench.py:256
PARTICLE_ATE_SLACK_M = 0.02       # bench.py:810
# the budget a section or a mode needs left to start (bench.py:278-297 and
# :249 give a TPU's; these are a few times the card's walls, PERF.md s.5)
SECTION_MIN_S = {"hector": 60, "coreslam": 120, "graph": 60, "fleet": 30,
                 "particle": 150, "office": 60}
MODE_MIN_S = 20

def kernels_of(cfg, batched: bool = False) -> set:
    """The kernels a step in ``cfg`` launches (a HectorConfig, or the graph
    frontend's ScanMatchConfig): its match and its map update."""
    f32 = match.table_f32(cfg)
    dense = (cfg.dense_fill if isinstance(cfg, ScanMatchConfig)
             else cfg.dense_free_fill)
    if not batched:
        return {"K3" if f32 else "K1", "K2" if dense else "K4"}
    kernel = "K3_batch" if f32 else "K5"
    if cfg.early_exit_tol > 0.0:
        kernel += "_exit"
    return {kernel, "K2_batch" if dense else "K4_batch"}


def coreslam_kernels(cfg) -> set:
    """The kernels a CoreSLAM step in ``cfg`` launches: K7's line updates
    (the search and the dense fills are PyTorch operators)."""
    return ((set() if cfg.dense_hole_fill
             else {"K7_hole_walk", "K7_hole_blend"})
            | (set() if cfg.dense_obstacle_fill else {"K7_obstacle"}))


class Run:
    """One bench run: its device, settings and budget, and the partial line
    that ``emit`` prints (the signal handler's too)."""

    def __init__(self, device, repeats: int = REPEATS, all_modes: bool = False,
                 budget_s: float = DEFAULT_BUDGET_S):
        self.dev = torch.device(device)
        self.repeats = repeats
        self.all_modes = all_modes
        self.budget_s = budget_s
        self.t0 = time.monotonic()
        self.out = {"metric": METRIC, "value": 0.0, "unit": "scans/s",
                    "vs_baseline": 0.0}
        self.sections: dict = {}
        self.skipped: list = []
        self.errors: dict = {}
        self._emitted = False

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def section(self, name: str, fn, **kwargs) -> None:
        """Run one section under the budget; record its keys, or its skip,
        or its error."""
        if self.remaining() < SECTION_MIN_S[name]:
            self.skipped.append(name)
            return
        say(f"{name} ...")
        t = time.monotonic()
        try:
            keys, record = fn(self, **kwargs)
        except Exception as e:     # a broken section must not lose the line
            traceback.print_exc(file=sys.stderr)
            self.errors[name] = f"{type(e).__name__}: {e}"
            return
        record["seconds"] = time.monotonic() - t
        self.out.update(keys)
        self.sections[name] = record
        say(f"{name}: correct {record['correct']}"
            + (f", fails {record['fails']}" if record["fails"] else "")
            + f", {record['seconds']:.1f} s")

    def ok(self) -> bool:
        return (not self.skipped and not self.errors
                and all(s["correct"] for s in self.sections.values()))

    def emit(self) -> None:
        """Print the one JSON line (once)."""
        if self._emitted:
            return
        self._emitted = True
        out = dict(self.out, sections=self.sections, correct=self.ok())
        if self.skipped:
            out["skipped"] = list(self.skipped)
        if self.errors:
            out["errors"] = dict(self.errors)
        out["bench_seconds"] = time.monotonic() - self.t0
        print(json.dumps(out), flush=True)


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def timed(run: Run, replay_once, work: int, steps: int,
          key: str = "scans_per_sec"):
    """One warm-up call of ``replay_once`` with the launch counts zeroed
    before it, then ``run.repeats`` timed calls.  Returns the last call's
    result and the mode's row: the median of ``work`` / seconds under
    ``key``, its ``spread`` [min, max], ``n``, ``setup_s`` and each kernel's
    launches in the warm-up over its ``steps``."""
    _build.reset_launches()
    run.sync()
    t = time.perf_counter()
    out = replay_once()
    run.sync()
    setup_s = time.perf_counter() - t
    launched = {k: v / steps for k, v in _build.kernel_launches().items()
                if v}
    rates = []
    for _ in range(run.repeats):
        t = time.perf_counter()
        out = replay_once()
        run.sync()
        rates.append(work / (time.perf_counter() - t))
    return out, {key: statistics.median(rates),
                 "spread": [min(rates), max(rates)], "n": len(rates),
                 "setup_s": setup_s, "launches_per_step": launched}


def launch_fails(run: Run, rows: dict, want: dict) -> list:
    """On the card: each mode's launched kernels must be ``want[mode]``
    (on the CPU nothing counts a launch)."""
    if run.dev.type != "cuda":
        return []
    return [f"{m}: launched {sorted(rows[m]['launches_per_step'])}, want "
            f"{sorted(k)}" for m, k in want.items()
            if m in rows and set(rows[m]["launches_per_step"]) != k]


def spread_keys(key: str, row: dict, rate: str) -> dict:
    """``key`` and ``key_spread`` from a mode's row."""
    return {key: row[rate], f"{key}_spread": row["spread"]}


def hector_pick(rows: dict, ates: dict) -> str:
    """bench.py's headline rule (``bench.py:245-258``): in table order from
    ``fixed``, a mode replaces the pick when its ATE is at most fixed's +
    1e-4 and its rate beats the pick's."""
    pick = "fixed"
    for name, row in rows.items():
        if (ates[name] <= ates["fixed"] + HECTOR_ATE_SLACK_M
                and row["scans_per_sec"] > rows[pick]["scans_per_sec"]):
            pick = name
    return pick


def hector_modes(all_modes: bool) -> dict:
    """bench.py's single-robot table (``bench.py:200-243``): ``fixed``, the
    two default candidates and, with ``all_modes``, the ladder before them,
    as the port's configs."""
    fixed = replay.fixed_config()
    modes = {"fixed": fixed}
    if all_modes:
        modes.update({
            "early_exit": fixed.overlay({"early_exit_tol": 1e-3}),
            "early_exit_dense": fixed.overlay({"early_exit_tol": 1e-3,
                                               "dense_free_fill": True}),
            "early_exit_sub2": fixed.overlay({"early_exit_tol": 1e-3,
                                              "match_subsample": 2}),
            "onehot": fixed.overlay({"early_exit_tol": 1e-3,
                                     "matcher_mode": "onehot_highest"}),
            "onehot_bf16": fixed.overlay({"early_exit_tol": 1e-3,
                                          "matcher_mode": "onehot_bf16"}),
            "pallas": fixed.overlay({"matcher_mode": "pallas"})})
    modes["onehot_bf16_dense"] = replay.onehot_bf16_dense_config()
    modes["pallas_dense"] = replay.pallas_dense_config()
    return modes


def hector_section(run: Run, n_scans: int = replay.N_SCANS):
    """The single robot over ``make_log(0)``: ``BOOTSTRAP`` forced scans in
    ``fixed``, then ``n_scans`` replayed in each mode from that state."""
    log = replay.make_log(0)
    boot = log.bootstrap
    dlog = replay.head(replay.to_device(log, run.dev), boot + n_scans)
    truth = log.traj[boot:boot + n_scans]
    fixed = replay.fixed_config()
    state = replay.bootstrap(hector.init(fixed, log.traj[0], run.dev), dlog,
                             boot, fixed)
    rows, ates, outs, want = {}, {}, {}, {}
    for name, cfg in hector_modes(run.all_modes).items():
        if name != "fixed" and run.remaining() < MODE_MIN_S:
            run.skipped.append(f"hector:{name}")
            continue
        (_, out), row = timed(
            run, lambda cfg=cfg: replay.replay(state, dlog, boot, cfg),
            n_scans, n_scans)
        outs[name] = out
        ates[name], row["max_err_m"] = replay.ate_of(out.poses.cpu().numpy(),
                                                     truth)
        row["ate_m"] = ates[name]
        row["gn_iterations"] = int(out.gn_iterations.sum())
        rows[name] = row
        want[name] = kernels_of(cfg)
    fails = []
    for name, ref, slack in (("fixed", replay.JAX_FIXED_REF_ATE_M, 1e-4),
                             ("pallas_dense", replay.JAX_REF_ATE_M, 2e-4),
                             ("onehot_bf16_dense", replay.JAX_EXIT_REF_ATE_M,
                              2e-4)):
        if name in rows and not ates[name] <= ref + slack:
            fails.append(f"{name} ATE {ates[name]} > JAX's {ref} + {slack}")
        if name in rows and not rows[name]["max_err_m"] <= 0.05:
            fails.append(f"{name} max error {rows[name]['max_err_m']} > 0.05")
    if "onehot_bf16_dense" in rows:
        e = rows["onehot_bf16_dense"]
        if not e["ate_m"] <= ates["fixed"] + HECTOR_ATE_SLACK_M:
            fails.append(f"onehot_bf16_dense ATE {e['ate_m']} > fixed's + "
                         f"{HECTOR_ATE_SLACK_M}")
        if not e["gn_iterations"] < 15 * n_scans:
            fails.append(f"onehot_bf16_dense GN iterations "
                         f"{e['gn_iterations']} >= 15 x {n_scans}")
    fails += launch_fails(run, rows, want)
    pick = hector_pick(rows, ates)
    best, out = rows[pick], outs[pick]
    keys = {"value": best["scans_per_sec"], "spread": best["spread"],
            "n": best["n"],
            "vs_baseline": best["scans_per_sec"] / BASELINE_SCANS_PER_S,
            **spread_keys("fixed_iter_scans_per_sec", rows["fixed"],
                          "scans_per_sec"),
            "hector_mode": pick, "ate_m": best["ate_m"],
            "max_err_m": best["max_err_m"],
            "map_updates": int(out.map_updated.sum()),
            "gn_residual_mean": float(out.residual.mean()),
            "solve_failures": int(out.solve_failures.sum()),
            "hector_modes": rows, "n_scans": n_scans}
    return keys, record(run, rows, fails)


def record(run: Run, rows: dict, fails: list) -> dict:
    """A section's entry under ``sections``."""
    return {"correct": not fails, "fails": fails, "n": run.repeats,
            "setup_s": sum(r["setup_s"] for r in rows.values())}


def fleet_modes(all_modes: bool) -> tuple:
    """bench.py's fleet rows (``bench.py:498-523``), in its order."""
    if all_modes:
        return ("sub1", "sub4", "sub4_onehot", "sub4_onehot_dense",
                "sub4_onehot_cap8", "sub4_onehot_cap32")
    return ("sub1", "sub4_onehot_dense")


def fleet_section(run: Run, robots: int = replay.FLEET_B,
                  batch_scans: int = replay.FLEET_T):
    """``robots`` phase-shifted slices of ``make_log(0)``, each
    ``BOOTSTRAP`` forced batch-scans in the row's own config, then
    ``batch_scans`` tracked ones (``bench.py:452-493``)."""
    flog = replay.make_fleet_log(replay.make_log(0), robots, batch_scans)
    fdl = replay.to_device(flog, run.dev)
    boot = flog.bootstrap
    truth = flog.traj[boot:]
    rows, raw, want, fails = {}, {}, {}, []
    for name in fleet_modes(run.all_modes):
        if name != "sub1" and run.remaining() < MODE_MIN_S:
            run.skipped.append(f"fleet:{name}")
            continue
        cfg = replay.FLEET_MODES[name]()
        states = replay.fleet_bootstrap(
            fleet.init_fleet(cfg, flog.traj[0], run.dev), fdl, boot, cfg)
        (_, poses), row = timed(
            run, lambda cfg=cfg, st=states: fleet.replay_fleet(
                st, fdl.points[boot:], fdl.valid[boot:], cfg),
            batch_scans * robots, batch_scans, "instance_scans_per_sec")
        got = replay.fleet_ate_of(poses.cpu().numpy(), truth)
        row.update(ate_m=got[0], max_err_m=got[1], ate_median_m=got[2])
        rows[name], raw[name] = row, (row["instance_scans_per_sec"], got[0])
        want[name] = kernels_of(cfg, batched=True)
        fails += [f"{name}: {f}" for f in replay.fleet_row_gate(name, got)]
    fails += launch_fails(run, rows, want)
    pick, bound = replay.fleet_headline(raw)
    best = rows[pick]
    single = run.out.get("value") or None
    return {"fleet_batch": robots, "fleet_mode": pick,
            **spread_keys("fleet_instance_scans_per_sec", best,
                          "instance_scans_per_sec"),
            "fleet_vs_single_instance": (
                best["instance_scans_per_sec"] / single if single else None),
            "fleet_ate_m": best["ate_m"],
            "fleet_ate_median_m": best["ate_median_m"],
            "fleet_max_err_m": best["max_err_m"], "fleet_ate_bound_m": bound,
            "fleet_modes": rows}, record(run, rows, fails)


def graph_modes(all_modes: bool) -> dict:
    """bench.py's graph modes (``bench.py:653-688``) as (HectorConfig,
    ScanMatchConfig, the reference's name for ``replay.graph_reference``)."""
    modes = {"gather": (*replay.graph_gather_config(), False)}
    if all_modes:
        modes["onehot_bf16"] = (replay.fixed_config(
            matcher_mode="onehot_bf16"), ScanMatchConfig(), None)
    modes["onehot_full"] = (
        replay.fixed_config(matcher_mode="onehot_bf16", dense_free_fill=True,
                            dense_free_margin_px=0.5),
        ScanMatchConfig(matcher_mode="onehot_bf16", dense_fill=True), True)
    modes["pallas_full"] = (*replay.graph_pallas_full_config(), True)
    return modes


def graph_pick(rows: dict) -> str:
    """bench.py's graph rule (``bench.py:697-701``): the fastest mode (the
    first in table order among equals) with gather's keyframes, at most 2
    closures fewer and an ATE at most 1.15 x gather's."""
    base = rows["gather"]
    eligible = [n for n, m in rows.items()
                if m["ate_m"] <= base["ate_m"] * 1.15
                and m["keyframes"] == base["keyframes"]
                and m["loop_closures"] >= base["loop_closures"] - 2]
    return max(eligible, key=lambda n: rows[n]["scans_per_sec"])


def graph_section(run: Run, n_scans: int = replay.N_SCANS):
    """Graph-SLAM over ``make_graph_log()``'s first ``n_scans`` scans, the
    first ``GRAPH_BOOTSTRAP`` forced (``bench.py:613-647``)."""
    log = replay.make_graph_log()
    dlog = replay.head(replay.to_device(log, run.dev), n_scans)
    truth = log.traj[:n_scans]
    rows, want, fails = {}, {}, []
    for name, (hcfg, mcfg, onehot_ref) in graph_modes(run.all_modes).items():
        if name != "gather" and run.remaining() < MODE_MIN_S:
            run.skipped.append(f"graph:{name}")
            continue
        (state, out), row = timed(
            run, lambda h=hcfg, m=mcfg: replay.graph_replay(dlog, h, m),
            n_scans, n_scans)
        got = replay.graph_ate_of(state, out.poses.cpu().numpy(), truth)
        row.update(got)
        rows[name] = row
        want[name] = kernels_of(hcfg) | kernels_of(mcfg)
        if onehot_ref is not None:
            fails += [f"{name}: {f}" for f in replay.graph_gate(
                got, replay.graph_reference(onehot_ref))]
    fails += launch_fails(run, rows, want)
    mode = graph_pick(rows)
    pick = rows[mode]
    return {**spread_keys("graph_scans_per_sec", pick, "scans_per_sec"),
            "graph_mode": mode, "graph_ate_m": pick["ate_m"],
            "graph_max_err_m": pick["max_err_m"],
            "graph_keyframes": pick["keyframes"],
            "graph_loop_closures": pick["loop_closures"],
            "graph_modes": rows}, record(run, rows, fails)


def office_section(run: Run, n_scans: int | None = None):
    """The office loop over ``make_office_log()`` (its first ``n_scans``):
    Hector alone once, graph-SLAM timed (``bench.py:398-431``)."""
    log = replay.make_office_log()
    n = n_scans or log.traj.shape[0]
    dlog = replay.head(replay.to_device(log, run.dev), n)
    odo, deltas = (torch.as_tensor(a[:n], device=run.dev)
                   for a in replay.office_odometry(log.traj))
    hcfg, gcfg, mcfg = replay.office_config()
    _, h_out = replay.office_replay(dlog, odo, deltas, hcfg)
    (g_state, g_out), row = timed(
        run, lambda: replay.office_replay(dlog, odo, deltas, hcfg, gcfg, mcfg),
        n, n)
    got = replay.office_metrics(log.traj[:n], h_out.poses.cpu().numpy(),
                                g_state, g_out.poses.cpu().numpy(),
                                g_out.keyframe_added.cpu().numpy())
    row.update(got)
    rows = {"graph": row}
    fails = replay.office_gate(got, replay.office_reference())
    fails += launch_fails(run, rows,
                          {"graph": kernels_of(hcfg) | kernels_of(mcfg)})
    keys = {f"office_{k}": v for k, v in got.items()}
    keys.update(spread_keys("office_graph_scans_per_sec", row,
                            "scans_per_sec"))
    keys["office_modes"] = rows
    return keys, record(run, rows, fails)


def coreslam_section(run: Run, n_scans: int | None = None,
                     nudges=replay.CORESLAM_NUDGES,
                     seeds=replay.CORESLAM_SEEDS):
    """CoreSLAM over ``make_log(0)`` (its first ``n_scans``): production
    timed from the true start (``nudges[0]``), parity under ``seeds[0]``;
    then, untimed, the other starts and seeds for ``replay.coreslam_gate``
    (``bench.py:836-870``)."""
    log = replay.make_log(0)
    n = n_scans or log.traj.shape[0]
    dlog = replay.head(replay.to_device(log, run.dev), n)
    truth = log.traj[:n]
    rows, ates, searched, want = {}, {}, {}, {}
    for name, cfg, kw, keys in (
            ("production", replay.coreslam_production_config(), "nudge",
             nudges),
            ("parity", replay.coreslam_parity_config(), "seed", seeds)):
        outs = []
        (_, out), row = timed(
            run, lambda cfg=cfg, kw=kw, k=keys[0]: replay.coreslam_replay(
                dlog, cfg, **{kw: k}), n, n)
        outs.append(out)
        for k in keys[1:]:
            outs.append(replay.coreslam_replay(dlog, cfg, **{kw: k})[1])
        ates[name] = [replay.ate_of(o.poses.cpu().numpy(), truth)[0]
                      for o in outs]
        searched[name] = [int(o.searched.sum()) for o in outs]
        row.update(ate_m=ates[name][0], **{f"{kw}s": list(keys)},
                   ates_m=ates[name], ate_median_m=float(np.median(ates[name])),
                   searched=searched[name])
        rows[name] = row
        want[name] = coreslam_kernels(cfg)
    fails = replay.coreslam_gate(
        ates["production"], ates["parity"], searched["parity"],
        searched["production"], n,
        replay.coreslam_production_config().position_search_beginning)
    fails += launch_fails(run, rows, want)
    return {**spread_keys("coreslam_scans_per_sec", rows["production"],
                          "scans_per_sec"),
            "coreslam_ate_m": ates["production"][0],
            **spread_keys("coreslam_parity_scans_per_sec", rows["parity"],
                          "scans_per_sec"),
            "coreslam_parity_ate_m": ates["parity"][0],
            "coreslam_modes": rows}, record(run, rows, fails)


def particle_pick(rows: dict) -> tuple:
    """bench.py's particle rule (``bench.py:810-812``): the fastest mode
    (the first in table order among equals) whose ATE is at most exact's +
    0.02 m.  A mode's ATE is its median over the gate's seeds where it has
    them, else its one seed's.  Returns (mode, bound)."""
    def ate(r):
        return r.get("ate_median_m", r["ate_m"])
    bound = ate(rows["exact"]) + PARTICLE_ATE_SLACK_M
    eligible = [n for n, r in rows.items() if ate(r) <= bound]
    return max(eligible, key=lambda n: rows[n]["scans_per_sec"]), bound


def particle_section(run: Run, n_scans: int | None = None,
                     particles: int | None = None,
                     seeds=replay.PARTICLE_SEEDS):
    """The particle layer over ``make_log(0)`` (its first ``n_scans``) at
    8192 particles (or ``particles``): each mode timed under ``seeds[0]``;
    ``exact`` and ``grid_dense`` then, untimed, under the other seeds for
    ``replay.particle_gate``; with ``all_modes`` also ``sub4``, ``grid`` and
    ``grid_small``, one seed each (``bench.py:772-803``)."""
    log = replay.make_log(0)
    n = n_scans or log.traj.shape[0]
    dlog = replay.head(replay.to_device(log, run.dev), n)
    truth = log.traj[:n]
    names = (("exact", "sub4", "grid", "grid_small", "grid_dense")
             if run.all_modes else ("exact", "grid_dense"))
    rows, ates, want = {}, {}, {}
    for name in names:
        if name != "exact" and run.remaining() < MODE_MIN_S:
            run.skipped.append(f"particle:{name}")
            continue
        ccfg, pcfg = replay.PARTICLE_MODES[name]
        if particles is not None:
            pcfg = pcfg.overlay({"num_particles": particles})
        (_, out), row = timed(
            run, lambda c=ccfg, p=pcfg: replay.particle_replay(
                dlog, c, p, seed=seeds[0]), n, n)
        row.update(replay.particle_metrics(out, truth))
        if name in ("exact", "grid_dense"):
            ates[name] = [row["ate_m"]] + [replay.particle_metrics(
                replay.particle_replay(dlog, ccfg, pcfg, seed=k)[1],
                truth)["ate_m"] for k in seeds[1:]]
            row.update(seeds=list(seeds), ates_m=ates[name],
                       ate_median_m=float(np.median(ates[name])))
        rows[name] = row
        want[name] = coreslam_kernels(ccfg)
    fails = (replay.particle_gate(ates["exact"], ates["grid_dense"])
             if len(ates) == 2 else [])
    fails += launch_fails(run, rows, want)
    pick, bound = particle_pick(rows)
    best = rows[pick]
    return {"particle_count": (particles or
                               replay.PARTICLE_MODES["exact"][1].num_particles),
            "particle_mode": pick, "particle_ate_bound_m": bound,
            **spread_keys("particle_scans_per_sec", best, "scans_per_sec"),
            "particle_ate_m": best["ate_m"],
            "particle_max_err_m": best["max_err_m"],
            "particle_modes": rows}, record(run, rows, fails)


# bench.py's order (bench.py:200-297)
SECTIONS = {"hector": hector_section, "coreslam": coreslam_section,
            "graph": graph_section, "fleet": fleet_section,
            "particle": particle_section, "office": office_section}


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    device count; on the CPU, its platform alone."""
    if dev.type != "cuda":
        return {"platform": "cpu", "name": None, "power_limit_w": None,
                "count": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name, limit = smi.rsplit(",", 1)
    return {"platform": "gpu", "name": name.strip(),
            "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--all", action="store_true",
                    default=os.environ.get("SLAMNET_BENCH_ALL") == "1",
                    help="the full mode tables (SLAMNET_BENCH_ALL=1)")
    ap.add_argument("--budget-s", type=float,
                    default=float(os.environ.get("SLAMNET_BENCH_BUDGET_S",
                                                 DEFAULT_BUDGET_S)),
                    help="wall-clock budget (SLAMNET_BENCH_BUDGET_S, 1050)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default); cpu runs the plain versions")
    ap.add_argument("--repeats", type=int, default=REPEATS,
                    help="timed replays a mode (R)")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated sections to run, in bench order")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    names = [s for s in SECTIONS if s in args.sections.split(",")]
    if args.device == "cuda" and not torch.cuda.is_available():
        print("slamnet_tpu_torch.bench: no CUDA device (torch.cuda."
              "is_available() is False); --device cpu runs the plain "
              "versions", file=sys.stderr)
        return 2
    run = Run(args.device, args.repeats, args.all, args.budget_s)

    def on_signal(signum, frame):
        run.skipped.append(f"signal:{signal.Signals(signum).name}")
        run.emit()
        os._exit(1)

    old = {s: signal.signal(s, on_signal)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        run.out["device"] = device_info(run.dev)
        if run.dev.type == "cuda":
            try:
                run.out["build_s"] = _build.library()[1]
            except RuntimeError as e:     # nvcc failed: no section can run
                run.errors["build"] = f"{type(e).__name__}: {e}"
                names = []
        for name in names:
            run.section(name, SECTIONS[name])
        run.emit()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    return 0 if run.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
