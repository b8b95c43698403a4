"""The port's bench (``slamnet_tpu_torch/bench.py``) on the CPU.

Each section at a small depth on ``--device cpu`` (the plain versions; no
wrapper counts a launch there) with the keys ``bench.py`` prints for it,
and its numbers those of the ``replay.py`` flow it wraps; the headline
rules against ``bench.py``'s own expressions on fixed tables; the exit
codes of the harness; SIGTERM's partial line in a subprocess; no card and
no ``--device cpu``.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from slamnet_tpu_torch import bench, replay
from slamnet_tpu_torch.models import fleet, hector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and oversubscribed threads slow these small full-width replays ~10x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# each section's small depth, and the keys bench.py prints for it
SECTION_CASES = {
    "hector": ({"n_scans": 4}, (
        "metric", "value", "unit", "vs_baseline", "fixed_iter_scans_per_sec",
        "ate_m", "max_err_m", "map_updates", "gn_residual_mean",
        "solve_failures", "hector_modes", "n_scans")),
    "fleet": ({"robots": 4, "batch_scans": 3}, (
        "fleet_batch", "fleet_mode", "fleet_instance_scans_per_sec",
        "fleet_vs_single_instance", "fleet_ate_m", "fleet_ate_median_m",
        "fleet_max_err_m", "fleet_ate_bound_m", "fleet_modes")),
    "graph": ({"n_scans": 14}, (
        "graph_scans_per_sec", "graph_ate_m", "graph_max_err_m",
        "graph_keyframes", "graph_loop_closures", "graph_modes")),
    "office": ({"n_scans": 14}, (
        "office_scans", "office_keyframes", "office_loop_closures",
        "office_hector_only_ate_m", "office_graph_online_ate_m",
        "office_kf_hector_ate_m", "office_kf_optimized_ate_m",
        "office_closure_margin", "office_graph_scans_per_sec")),
    "coreslam": ({"n_scans": 8, "nudges": (0, 1), "seeds": (1, 2)}, (
        "coreslam_scans_per_sec", "coreslam_ate_m",
        "coreslam_parity_scans_per_sec", "coreslam_parity_ate_m")),
    "particle": ({"n_scans": 7, "particles": 256, "seeds": (1, 2)}, (
        "particle_count", "particle_mode", "particle_ate_bound_m",
        "particle_scans_per_sec", "particle_ate_m", "particle_max_err_m",
        "particle_modes")),
}
MODES = {"hector": ("fixed", "onehot_bf16_dense", "pallas_dense"),
         "fleet": ("sub1", "sub4_onehot_dense"),
         "graph": ("gather", "onehot_full", "pallas_full"),
         "office": ("graph",), "coreslam": ("production", "parity"),
         "particle": ("exact", "grid_dense")}


@pytest.mark.parametrize("name", list(SECTION_CASES))
def test_section_at_small_depth(name):
    kwargs, keys = SECTION_CASES[name]
    run = bench.Run("cpu", repeats=1)
    run.section(name, bench.SECTIONS[name], **kwargs)
    assert not run.errors and not run.skipped, (run.errors, run.skipped)
    out, rec = run.out, run.sections[name]
    assert set(keys) <= set(out), set(keys) - set(out)
    assert isinstance(rec["correct"], bool) and rec["n"] == 1
    assert rec["correct"] == (not rec["fails"]) and rec["setup_s"] > 0
    rows = out[f"{name}_modes"]
    assert tuple(rows) == MODES[name]
    for row in rows.values():
        rate = next(k for k in row if k.endswith("scans_per_sec"))
        assert row[rate] > 0 and row["spread"] == [row[rate]] * 2
        assert row["n"] == 1
        assert row["launches_per_step"] == {}      # the CPU counts none
    for k, v in out.items():
        if k.endswith("_per_sec"):
            assert out[f"{k}_spread"][0] <= v <= out[f"{k}_spread"][1]
    json.dumps(out)


def test_hector_section_is_the_replay_flow():
    run = bench.Run("cpu", repeats=1)
    keys, _ = bench.hector_section(run, n_scans=5)
    log = replay.make_log(0)
    dlog = replay.head(replay.to_device(log, "cpu"), log.bootstrap + 5)
    for name, cfg in (("fixed", replay.fixed_config()),
                      ("pallas_dense", replay.pallas_dense_config())):
        st = replay.bootstrap(hector.init(cfg, log.traj[0], "cpu"), dlog,
                              log.bootstrap, cfg)
        _, out = replay.replay(st, dlog, log.bootstrap, cfg)
        ate, mx = replay.ate_of(out.poses.numpy(),
                                log.traj[log.bootstrap:log.bootstrap + 5])
        row = keys["hector_modes"][name]
        assert (row["ate_m"], row["max_err_m"]) == (ate, mx)
        assert row["gn_iterations"] == int(out.gn_iterations.sum())


def test_fleet_section_is_the_replay_flow():
    run = bench.Run("cpu", repeats=1)
    keys, _ = bench.fleet_section(run, robots=3, batch_scans=2)
    flog = replay.make_fleet_log(replay.make_log(0), 3, 2)
    fdl = replay.to_device(flog, "cpu")
    cfg = replay.sub4_onehot_dense_config()
    st = replay.fleet_bootstrap(fleet.init_fleet(cfg, flog.traj[0], "cpu"),
                                fdl, flog.bootstrap, cfg)
    _, poses = fleet.replay_fleet(st, fdl.points[flog.bootstrap:],
                                  fdl.valid[flog.bootstrap:], cfg)
    got = replay.fleet_ate_of(poses.numpy(), flog.traj[flog.bootstrap:])
    row = keys["fleet_modes"]["sub4_onehot_dense"]
    assert (row["ate_m"], row["max_err_m"], row["ate_median_m"]) == got


def test_sub4_onehot_dense_is_sub4_pallas_dense():
    # bench.py's fleet headline row runs K5 on K1's table, as the port's
    # sub4_pallas_dense does; both stand on JAX's sub4_onehot_dense
    a = replay.sub4_onehot_dense_config()
    b = replay.sub4_pallas_dense_config()
    assert a.overlay({"matcher_mode": "pallas"}) == b
    assert bench.kernels_of(a, True) == bench.kernels_of(b, True) == \
        {"K5", "K2_batch"}
    assert replay.FLEET_ROW_JAX_REFS["sub4_onehot_dense"] == \
        replay.FLEET_ROW_JAX_REFS["sub4_pallas_dense"]


def test_coreslam_section_is_the_replay_flow():
    run = bench.Run("cpu", repeats=1)
    keys, _ = bench.coreslam_section(run, n_scans=9, nudges=(0, 2),
                                     seeds=(1, 3))
    log = replay.make_log(0)
    dlog = replay.head(replay.to_device(log, "cpu"), 9)
    for mode, cfg, kw in (
            ("production", replay.coreslam_production_config(), "nudge"),
            ("parity", replay.coreslam_parity_config(), "seed")):
        row = keys["coreslam_modes"][mode]
        want = [replay.ate_of(replay.coreslam_replay(
            dlog, cfg, **{kw: k})[1].poses.numpy(), log.traj[:9])[0]
            for k in row[f"{kw}s"]]
        assert row["ates_m"] == want and row["searched"] == [4, 4]


# bench.py's own rules, as its code computes them (bench.py:245-258,
# :539-543, :697-701, :810-812), against the port's on fixed tables
def bench_py_hector(rows):
    t_fixed, ate_fixed = 512 / rows["fixed"][0], rows["fixed"][1]
    best, pick = t_fixed, "fixed"
    for name, (rate, ate_c) in rows.items():
        t_c = 512 / rate
        if name != "fixed" and ate_c <= ate_fixed + 1e-4 and t_c < best:
            best, pick = t_c, name
    return pick


def bench_py_fleet(raw):
    bound = 2.0 * raw["sub1"][1]
    return max((r[0], name) for name, r in raw.items() if r[1] <= bound)[1]


def bench_py_graph(modes):
    base = modes["gather"]
    pick = max((m for m in modes.values()
                if (m["_ate_raw"] <= base["_ate_raw"] * 1.15
                    and m["keyframes"] == base["keyframes"]
                    and m["loop_closures"] >= base["loop_closures"] - 2)),
               key=lambda m: m["scans_per_sec"])
    return next(n for n, m in modes.items() if m is pick)


def bench_py_particle(results):
    bound = results["exact"][1] + 0.02
    eligible = {n: r for n, r in results.items() if r[1] <= bound}
    return max(eligible, key=lambda n: eligible[n][0])


HECTOR_TABLES = [
    # (scans/s, ATE) in bench.py's table order, fixed first
    ({"fixed": (2100.0, 0.00212), "onehot_bf16_dense": (2080.0, 0.00206),
      "pallas_dense": (2600.0, 0.00206)}, "pallas_dense"),
    ({"fixed": (2100.0, 0.00212), "onehot_bf16_dense": (2300.0, 0.00220),
      "pallas_dense": (2600.0, 0.00250)}, "onehot_bf16_dense"),
    ({"fixed": (2100.0, 0.00212), "onehot_bf16_dense": (2600.0, 0.00210),
      "pallas_dense": (2600.0, 0.00206)}, "onehot_bf16_dense"),
    ({"fixed": (2100.0, 0.00212), "onehot_bf16_dense": (2100.0, 0.00200),
      "pallas_dense": (1900.0, 0.00200)}, "fixed"),
]


@pytest.mark.parametrize("table,want", HECTOR_TABLES)
def test_hector_headline_rule(table, want):
    rows = {n: {"scans_per_sec": r} for n, (r, _) in table.items()}
    ates = {n: a for n, (_, a) in table.items()}
    assert bench.hector_pick(rows, ates) == bench_py_hector(table) == want


FLEET_TABLES = [
    ({"sub1": (130e3, 0.0037), "sub4_onehot_dense": (190e3, 0.0063)},
     "sub4_onehot_dense"),
    ({"sub1": (130e3, 0.0030), "sub4_onehot_dense": (190e3, 0.0063)},
     "sub1"),
    ({"sub1": (130e3, 0.0037), "sub4": (150e3, 0.0054),
      "sub4_onehot": (170e3, 0.0054), "sub4_onehot_dense": (190e3, 0.0063),
      "sub4_onehot_cap8": (250e3, 0.0805), "sub4_onehot_cap32": (230e3,
                                                                 0.0314)},
     "sub4_onehot_dense"),
    ({"sub1": (190e3, 0.0037), "sub4_onehot_dense": (190e3, 0.0063)},
     "sub4_onehot_dense"),
]


@pytest.mark.parametrize("table,want", FLEET_TABLES)
def test_fleet_headline_rule(table, want):
    pick, bound = replay.fleet_headline(table)
    assert pick == bench_py_fleet(table) == want
    assert bound == 2.0 * table["sub1"][1]


GRAPH_TABLES = [
    # (scans/s, ATE, keyframes, closures)
    ({"gather": (510.0, 0.00709, 63, 29), "onehot_full": (520.0, 0.00671, 63,
                                                          31),
      "pallas_full": (515.0, 0.00671, 63, 31)}, "onehot_full"),
    ({"gather": (510.0, 0.00709, 63, 29), "onehot_full": (520.0, 0.0090, 63,
                                                          31),
      "pallas_full": (515.0, 0.00671, 62, 31)}, "gather"),
    ({"gather": (510.0, 0.00709, 63, 29), "onehot_full": (520.0, 0.0070, 63,
                                                          26),
      "pallas_full": (530.0, 0.0080, 63, 27)}, "pallas_full"),
    ({"gather": (530.0, 0.00709, 63, 29), "onehot_full": (530.0, 0.0070, 63,
                                                          29),
      "pallas_full": (500.0, 0.0070, 63, 29)}, "gather"),
]


@pytest.mark.parametrize("table,want", GRAPH_TABLES)
def test_graph_pick_rule(table, want):
    rows = {n: {"scans_per_sec": r, "ate_m": a, "keyframes": k,
                "loop_closures": c} for n, (r, a, k, c) in table.items()}
    modes = {n: {"scans_per_sec": r, "_ate_raw": a, "keyframes": k,
                 "loop_closures": c} for n, (r, a, k, c) in table.items()}
    assert bench.graph_pick(rows) == bench_py_graph(modes) == want


PARTICLE_TABLES = [
    ({"exact": (136.0, 0.291), "grid_dense": (132.0, 0.121)}, "exact"),
    ({"exact": (130.0, 0.291), "grid_dense": (132.0, 0.121)}, "grid_dense"),
    ({"exact": (130.0, 0.100), "grid_dense": (132.0, 0.125)}, "exact"),
    ({"exact": (130.0, 0.291), "sub4": (160.0, 0.40), "grid": (150.0, 0.30),
      "grid_small": (150.0, 0.20), "grid_dense": (140.0, 0.121)}, "grid"),
]


@pytest.mark.parametrize("table,want", PARTICLE_TABLES)
def test_particle_headline_rule(table, want):
    rows = {n: {"scans_per_sec": r, "ate_m": 9.0, "ate_median_m": a}
            for n, (r, a) in table.items()}
    pick, bound = bench.particle_pick(rows)
    assert pick == bench_py_particle(table) == want
    assert bound == table["exact"][1] + 0.02


def _stub(correct=True, raises=False):
    def section(run):
        if raises:
            raise RuntimeError("boom")
        row = {"scans_per_sec": 1.0, "spread": [1.0, 1.0], "n": run.repeats,
               "setup_s": 0.1, "launches_per_step": {}}
        fails = [] if correct else ["ATE 1.0 > 0.5"]
        return {"stub_modes": {"m": row}}, bench.record(run, {"m": row}, fails)
    return section


@pytest.mark.parametrize("case,argv,rc", [
    ("all hold", [], 0),
    ("a section raises", [], 1),
    ("a gate fails", [], 1),
    ("the budget skips", ["--budget-s", "0"], 1),
])
def test_exit_codes(monkeypatch, capsys, case, argv, rc):
    for name in bench.SECTIONS:
        monkeypatch.setitem(bench.SECTIONS, name, _stub(
            correct=not (case == "a gate fails" and name == "graph"),
            raises=case == "a section raises" and name == "fleet"))
    assert bench.main(["--device", "cpu", *argv]) == rc
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"] == (rc == 0)
    assert out["device"]["platform"] == "cpu"
    if case == "a section raises":
        assert out["errors"] == {"fleet": "RuntimeError: boom"}
        assert "fleet" not in out["sections"]
    if case == "a gate fails":
        assert out["sections"]["graph"]["fails"] == ["ATE 1.0 > 0.5"]
    if case == "the budget skips":
        assert out["skipped"] == list(bench.SECTIONS) and not out["sections"]
    else:
        assert "skipped" not in out


def test_sigterm_prints_the_partial_line():
    proc = subprocess.Popen(
        [sys.executable, "-m", "slamnet_tpu_torch.bench", "--device", "cpu",
         "--sections", "hector"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:              # the section has started
            if line.startswith("[bench] hector ..."):
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    lines = out.splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert line["skipped"] == ["signal:SIGTERM"] and not line["correct"]
    assert line["metric"] == bench.METRIC and proc.returncode != 0


def test_no_card_exits_at_once(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err


def test_budget_and_all_from_the_environment(monkeypatch):
    monkeypatch.setenv("SLAMNET_BENCH_BUDGET_S", "12.5")
    monkeypatch.setenv("SLAMNET_BENCH_ALL", "1")
    args = bench.parse_args([])
    assert (args.budget_s, args.all, args.device, args.repeats) == \
        (12.5, True, "cuda", 5)
    assert bench.parse_args(["--budget-s", "3"]).budget_s == 3.0
    assert tuple(bench.hector_modes(True))[-2:] == ("onehot_bf16_dense",
                                                    "pallas_dense")
    assert len(bench.hector_modes(True)) == 9
    assert bench.fleet_modes(True)[0] == "sub1"
    assert np.isclose(bench.BASELINE_SCANS_PER_S, 17.0)
