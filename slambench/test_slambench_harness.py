"""CPU tests of the benchmark harness: its files found by name, its rate and
latency arithmetic, the roofline counts, the reference against the
program's CPU path, the log generators against the program's, and the
imports.  Run: ``python -m pytest slambench -q``; nothing here needs a
card."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import harness as H
from slambench import logs, program, reference
from slambench.run import run_cell

HERE = Path(__file__).resolve().parent
WORKLOADS = [w["name"] for w in H.benchmark()["workloads"]]


# A fleet of the single robot's configuration (2 logs x 3 phase shifts) and
# the sharded kind on a 2x2 gloo mesh: the harness's kinds that no cell of
# BENCHMARK.json uses yet, tested at the CPU's size.
FLEET = dict(logs=2, shifts=3, log_scans=30)
SHARDED = {"kind": "sharded", "mesh": {"tile": 2, "search": 2},
           "log_scans": 16, "bootstrap": 4, "tracked": 12, "warmup_steps": 2,
           "trace_steps": 4, "stop_every": 2}


def tiny(name: str, **traffic):
    """The cell's files at a size the CPU runs in a second: a 2-level
    64-px pyramid over the same 40 m, 64 beams."""
    _, cfg, tr = H.cell(name)
    cfg = json.loads(json.dumps(cfg))
    cfg["hector"].update(map_size=64, map_resolution=0.625, num_levels=2,
                         estimate_iterations=[3, 2])
    cfg["sensor"]["beams"] = 64
    small = {"replay": dict(tracked=16, bootstrap=4, warmup_steps=4,
                            log_scans=24),
             "live": dict(bootstrap=4, warmup_steps=4, rate_hz=40.0)}
    return cfg, {**tr, **small[tr["kind"]], **traffic}


def tiny_sharded():
    """The single robot's configuration in the sharded step's fixed mode
    (gather match, line update) and the sharded kind's traffic."""
    cfg, _ = tiny("robot_replay")
    cfg["hector"].update(matcher_mode="gather", dense_free_fill=False)
    cfg["bootstrap_overrides"] = {}
    return cfg, dict(SHARDED)


# ------------------------------------------------------------ by name
@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_found_by_name(name):
    work, cfg, traffic = H.cell(name)
    assert cfg["name"] == work["config"]
    assert (HERE / "kinds" / f"{traffic['kind']}.py").is_file()
    assert set(reference.RefConfig.FIELDS) == set(cfg["hector"])
    program.hector_config(cfg["hector"])
    reference.RefConfig(cfg["hector"]).overlay(cfg["bootstrap_overrides"])
    e2e = [m["name"] for m in H.metrics_of(name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert H.metrics_of(name, "per_layer")


def test_every_metric_has_a_reader_and_every_config_its_file():
    bench = H.benchmark()
    for m in bench["per_layer"]:
        assert callable(H.reader(m["name"]))
    for c in bench["configs"]:
        path = H.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("slambench/")
        assert H.load_json(path)["name"] == c["name"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


# ------------------------------------------------------- the arithmetic
def stalled_step(monkeypatch, at: int, seconds: float):
    """Make the ``at``-th step of the window sleep ``seconds``."""
    real = program.Robots.step
    calls = {"n": 0}

    def step(self, state, points, valid, force, cfg=None):
        if not force:
            calls["n"] += 1
            if calls["n"] == at:
                time.sleep(seconds)
        return real(self, state, points, valid, force, cfg)
    monkeypatch.setattr(program.Robots, "step", step)


def test_rate_counts_a_stall_in_the_window(monkeypatch):
    cfg, tr = tiny("robot_replay")
    plain, _ = run_cell("robot_replay", 5, 1.0, False, "cpu", time.time(),
                        cfg, tr)
    stalled_step(monkeypatch, at=10, seconds=0.5)
    slow, _ = run_cell("robot_replay", 5, 1.0, False, "cpu", time.time(),
                       cfg, tr)
    a = plain["metrics"]["scans_per_s"]["value"]
    b = slow["metrics"]["scans_per_s"]["value"]
    assert b < 0.8 * a, (a, b)


def test_latency_median_counts_a_stall(monkeypatch):
    cfg, tr = tiny("robot_live17")
    plain, _ = run_cell("robot_live17", 5, 1.0, False, "cpu", time.time(),
                        cfg, tr)
    # 40 scans at 40 Hz: a 0.8 s stall at scan 10 delays it and the ~30
    # scans due behind it, so the median too
    stalled_step(monkeypatch, at=10 + tr["warmup_steps"], seconds=0.8)
    slow, _ = run_cell("robot_live17", 5, 1.0, False, "cpu", time.time(),
                       cfg, tr)
    assert slow["latency_ms"]["p50"] > 100.0 > plain["latency_ms"]["p50"]
    # ... and past the next scan's due time (25 ms), so out of time
    in_time = [r["metrics"]["scans_in_time_pct"]["value"]
               for r in (plain, slow)]
    assert in_time[1] < 40.0 < in_time[0], in_time
    assert slow["attempted"] == plain["attempted"] == 40


def test_live_latency_readers_take_the_scans_before_the_trace():
    lat = np.array([1e-3, 2e-3, 3e-3, 4e-3])
    assert H.reader("live_latency_p50_ms")({"latency_s": lat}) == \
        pytest.approx(2.5)
    assert H.reader("live_latency_p95_ms")({"latency_s": lat}) == \
        pytest.approx(3.85)
    assert H.reader("live_latency_p50_ms")({"latency_s": lat[:0]}) is None


def test_percentile_is_over_all_samples():
    xs = np.arange(1, 101, dtype=np.float64)
    assert H.percentile(xs, 50) == pytest.approx(50.5)
    assert H.percentile(xs, 95) == pytest.approx(95.05)


# ------------------------------------------------------ the per-layer reads
def ctx_of(ops, window_s=1e-3, steps=2, robots=1, beams=8, updates=1,
           cells=10):
    hector = {"match_subsample": 2, "num_levels": 2,
              "estimate_iterations": [3, 2]}
    return {"summary": {"device_ops": ops, "host_ops": [],
                        "window_s": window_s},
            "steps": steps, "robots": robots, "beams": beams,
            "hector": hector, "map_updates": updates, "cells_changed": cells,
            "peaks": H.load_json(HERE / "peaks.json")}


def test_roofline_counts_at_a_tiny_shape():
    match = H.reader("match_roofline_pct").__globals__
    ops, nbytes = match["work"]({"match_subsample": 2, "num_levels": 2,
                                 "estimate_iterations": [3, 2]}, 3, 8)
    # 3 robots x 4 matcher beams x 5 iterations x 80 operations; bytes:
    # 4 x (8 + 1) beams, 12 + 28, 4 neighbours x 4 B x 4 beams x 2 levels
    assert ops == 3 * 4 * 5 * 80
    assert nbytes == 3 * (4 * 9 + 40 + 4 * 4 * 4 * 2)
    peaks = H.load_json(HERE / "peaks.json")
    ops1, b1 = match["work"]({"match_subsample": 2, "num_levels": 2,
                              "estimate_iterations": [3, 2]}, 1, 8)
    least = max(ops1 / peaks["fp32_flops_per_s"],
                b1 / peaks["hbm_bytes_per_s"])
    ops_list = [("void (anonymous namespace)::match_kernel<false, 0, 512>(x)",
                 0.0, 10.0), ("fill_kernel(y)", 10.0, 14.0),
                ("Memcpy DtoD", 20.0, 21.0)]
    got = H.reader("match_roofline_pct")(ctx_of(ops_list))
    assert got == pytest.approx(100.0 * least * 2 / 10e-6)
    fill = H.reader("fill_roofline_pct")(ctx_of(ops_list))
    nb = 1 * (8 * 9 + 12) + 10 * 8 + 2 * 1
    assert fill == pytest.approx(100.0 * nb / peaks["hbm_bytes_per_s"]
                                 / 4e-6)
    assert H.reader("kernels_per_step")(ctx_of(ops_list)) == 1.0
    assert H.reader("kernels_per_step.live")(ctx_of(ops_list)) == 1.0
    assert H.reader("device_idle_pct")(ctx_of(ops_list)) == pytest.approx(
        100.0 * (1 - 15e-6 / 1e-3))
    assert H.reader("device_us_per_scan.live")(ctx_of(ops_list)) == 7.5
    assert H.reader("nccl_us_per_scan")(ctx_of(ops_list)) is None
    nccl = ops_list + [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(z)",
                        30.0, 36.0)]
    assert H.reader("nccl_us_per_scan")(ctx_of(nccl)) == 3.0
    mfu = H.reader("step_mfu")(ctx_of(ops_list))
    assert mfu == pytest.approx(100.0 * (least * 2 + nb / peaks[
        "hbm_bytes_per_s"]) / 1e-3)
    assert H.reader("match_roofline_pct")(ctx_of(ops_list[1:])) is None


def test_busy_union_and_breakdown():
    ops = [("a(x)", 0.0, 10.0), ("b(x)", 5.0, 12.0), ("a(x)", 20.0, 25.0)]
    assert H.busy_us(ops) == 17.0
    host = [("aten::add", 13.0, 19.0), ("aten::add > inner", 14.0, 15.0)]
    bd = H.breakdown({"device_ops": ops, "host_ops": host})
    assert bd["device_ops"][0] == ["a", pytest.approx(15e-6)]
    assert bd["idle_gaps"][0][1] == pytest.approx(8e-6)
    assert "aten::add" in bd["idle_gaps"][0][0]


# ------------------------------------------- the reference and the program
@pytest.mark.parametrize("mode,dense", [("pallas", True), ("gather", False),
                                        ("onehot_bf16", True)])
@pytest.mark.parametrize("robots", [1, 3])
def test_reference_equals_the_programs_cpu_path(mode, dense, robots):
    """The frozen reference and the program's plain versions (its CPU path)
    give the same poses and maps, bit for bit, over a few scans."""
    cfg, tr = tiny("robot_replay", tracked=8, logs=1, shifts=robots)
    cfg["hector"].update(matcher_mode=mode, dense_free_fill=dense)
    from slambench.kinds import replay
    log = replay.make_log(tr, cfg["sensor"], 9, "cpu")
    boot = tr["bootstrap"]
    prog = program.Robots(cfg["hector"], robots, "cpu")
    boot_cfg = program.hector_config({**cfg["hector"],
                                      **cfg["bootstrap_overrides"]})
    st = replay.bootstrap(prog, log, boot, boot_cfg)
    poses = []
    for t in range(boot, log.points.shape[0]):
        st, p, _ = prog.step(st, log.points[t], log.valid[t], False)
        poses.append(p)
    rmaps0, rposes, _, snaps = replay.reference_replay(
        cfg, log, boot, robots, {8})
    assert torch.equal(torch.stack(poses), rposes)
    assert torch.equal(st.maps, snaps[8])


def test_logs_equal_the_programs_generators():
    from slamnet_tpu_torch import replay as R
    sensor = H.load_json(HERE / "configs" / "hector_sim400.json")["sensor"]
    port = R.to_device(R.make_log(3), "cpu")
    ours = logs.make_log(3, R.N_SCANS + R.BOOTSTRAP, sensor, "cpu")
    assert torch.equal(ours.traj, port.traj)
    assert torch.equal(ours.points, port.points)
    assert torch.equal(ours.valid, port.valid)
    fl = R.to_device(R.make_fleet_log(R.make_log(3), 5, 20), "cpu")
    ofl = logs.make_fleet_log([ours], 30, 5)
    assert torch.equal(ofl.points, fl.points)
    assert torch.equal(ofl.traj, fl.traj)


# ------------------------------------------------------------ the imports
def imported_top_names(path: Path) -> set:
    """Top-level names of the absolute imports, and every name a relative
    import takes (``from . import program`` gives ``program``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                names |= {node.module or ""} | {a.name for a in node.names}
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = imported_top_names(path) & set(H.FORBIDDEN)
        assert not bad, (path, bad)
    for name in ("reference.py", "logs.py"):
        names = imported_top_names(HERE / name)
        assert not names & {"slamnet_tpu_torch", "program", "slambench"}, \
            (name, names)


def test_no_jax_in_the_harness_or_a_ranks_process():
    code = ("import sys, slambench.run, slambench.control, "
            "slambench.kinds.replay, slambench.kinds.live, "
            "slambench.kinds.sharded, slamnet_tpu_torch.parallel.rank; "
            "from slambench import harness as H; "
            "[H.reader(m['name']) for m in H.benchmark()['per_layer']]; "
            "print(H.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "slamnet_tpu_torch_extra", sys)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "slamnet_tpu.core", sys)
    assert H.forbidden_modules() == ["slamnet_tpu"]


def test_no_card_exits_2_without_a_result():
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "robot_replay",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=H.ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == "", out.stderr


class LosingTrace:
    """A stand-in for ``harness.Trace`` whose first stretch records nothing
    (as CUPTI sometimes does) and whose second records a match, a fill and
    a copy."""
    exits = 0

    def __init__(self, device):
        self.recorded = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        LosingTrace.exits += 1
        self.recorded = LosingTrace.exits > 1
        return False

    def summary(self):
        ops = [("match_kernel<false, 0, 512>", 0.0, 20.0),
               ("fill_kernel", 20.0, 23.0), ("Memcpy DtoH", 30.0, 31.0)]
        return {"device_ops": ops, "host_ops": [], "window_s": 1e-3}


@pytest.mark.parametrize("name,fleet", [("robot_replay", {}),
                                        ("robot_replay", FLEET),
                                        ("robot_live17", {})])
def test_a_trace_that_lost_the_card_is_taken_again(name, fleet,
                                                   monkeypatch):
    monkeypatch.setattr(H, "Trace", LosingTrace)
    monkeypatch.setattr(H, "start_profiler", lambda: None)
    monkeypatch.setattr(LosingTrace, "exits", 0)
    cfg, tr = tiny(name, trace_steps=4, **fleet)
    result, checks = run_cell(name, 3, 1.0, True, "cpu", time.time(), cfg,
                              tr)
    want = {m["name"] for m in H.metrics_of(name, "per_layer")}
    assert set(result["metrics"]) == want and result["correct"], checks
    assert LosingTrace.exits == 2
    assert result["breakdown"]["device_ops"][0][0] == "match_kernel<false, 0, 512>"
