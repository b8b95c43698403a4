"""The particle layer in the benchmark: the plain reference (``slambench/
reference_particle.py``) against the program's ``particle.update``, the
control and the planted faults judged by the cell's own comparison, the
configuration's file, and the program's particle spans and counters with
their readers.

Everything runs on the CPU at a small size, on one thread: 256 particles,
the top 8 refined 8 times each, a 128-px hole map and a 32-px obstacle map
on the cell's 40 m, 30 chained scans of the loop log (5 trusted).
"""
import json
import statistics
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slambench import control_particle, logs, program_particle
from slambench import harness as H
from slambench import reference_coreslam as C
from slambench import reference_particle as R
from slambench.kinds import particle_replay as K
from slambench.run import run_cell
from slamnet_tpu_torch.core.config import CoreSlamConfig, ParticleConfig
from slamnet_tpu_torch.models import particle

CELL = "particle8192_replay"
SCANS = 30
SEEDS = (2 ** 31 + 5, 3_300_000_017)
PHASES = ("slamnet.particle.score", "slamnet.particle.refine",
          "slamnet.particle.resample", "slamnet.particle.map_update")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small():
    """The cell's configuration at the CPU's size."""
    _, cfg, _ = H.cell(CELL)
    cfg = json.loads(json.dumps(cfg))
    cfg["coreslam"].update(hole_map_size=128, obstacle_map_size=32)
    cfg["particle"].update(num_particles=256, top_k=8, refine_candidates=8)
    return cfg


def reference_job(cfg, log, seed, n, snapshots):
    return R.replay(C.RefConfig(cfg["coreslam"]), R.PConfig(cfg["particle"]),
                    log.points, log.valid, log.traj[0], seed, n, snapshots)


@pytest.fixture(scope="module", params=SEEDS)
def job(request):
    """One job through the program and through the reference."""
    torch.set_num_threads(1)
    cfg = small()
    log = logs.make_log(request.param, SCANS, cfg["sensor"], "cpu")
    seed = K.job_seed(request.param)
    prog = program_particle.Particles(cfg, "cpu")
    out = K.program_job(prog, log, log.traj[0], seed, SCANS)
    ref = reference_job(cfg, log, seed, SCANS, {11, SCANS})
    return cfg, log, seed, out, ref


def test_the_reference_equals_the_program_at_a_small_size(job):
    cfg, log, _, (poses, sums, ess, flags, st), ref = job
    rposes, rsums, ress, rflags, snaps, rst = ref
    assert torch.equal(poses, rposes)
    assert torch.equal(sums.to(torch.int64), rsums)
    assert torch.equal(ess, ress) and torch.equal(flags, rflags)
    assert torch.equal(st.particles, rst.particles)
    assert torch.equal(st.scores.to(torch.int64), rst.sums)
    assert torch.equal(st.hole_map, rst.hole)
    assert torch.equal(st.obstacle_map, rst.obstacle)
    assert torch.equal(snaps[SCANS][0], rst.particles)
    # the job is no trivial one: refined, resampled, mapped, moved
    warm = cfg["coreslam"]["position_search_beginning"]
    assert bool((rsums[warm:] > 0).all())
    assert int(rflags[warm:].sum()) > SCANS // 2
    assert int((rst.hole != C.HOLE_INIT).sum()) > 500
    assert len(set(map(tuple, rst.particles.tolist()))) > 16
    assert float((rposes[-1, :2] - rposes[0, :2]).norm()) > 0.2


def test_the_comparison_reads_zero_on_a_sound_job(job):
    """A whole job and a partial last one of 11 scans."""
    cfg, log, seed, out, (*ref, snaps, _) = job
    prog = program_particle.Particles(cfg, "cpu")
    *o11, st11 = K.program_job(prog, log, log.traj[0], seed, 11)
    checks = K.compare(cfg["limits"], [out[:4], tuple(o11)],
                       [prog.final(st11), prog.final(out[4])], tuple(ref),
                       snaps, SCANS, 0)
    assert all(v == 0 for v, _ in checks.values()), checks
    assert H.judge(checks)


@pytest.mark.parametrize("plant", control_particle.PLANTS)
def test_the_control_and_the_faults_are_not_correct(job, plant):
    """Each plant's job, judged by the cell's comparison against the
    reference's job."""
    cfg, log, seed, _, (*ref, snaps, _) = job
    with control_particle.planted(plant):
        prog = program_particle.Particles(cfg, "cpu")
        *out, st = K.program_job(prog, log, log.traj[0], seed, SCANS)
    final = prog.final(st)
    checks = K.compare(cfg["limits"], [tuple(out)], [final, final],
                       tuple(ref), snaps, SCANS, 0)
    assert not H.judge(checks), checks


def _cpu_trace():
    class CpuTrace(H.Trace):
        """The harness's trace on the CPU: the host's events only, and one
        stand-in device operation."""

        def __enter__(self):
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.__enter__()
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.window_s = time.perf_counter() - self._t0
            self.prof.__exit__(*exc)
            self._summary = self._read()
            self._summary["device_ops"] = [("kernel", 0.0, 1.0)]
            self.recorded = True
            return False
    return CpuTrace


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_of_the_cell_is_correct(trace, monkeypatch):
    """The kind as ``run.py`` drives it, traced with the host's events
    only."""
    monkeypatch.setattr(H, "Trace", _cpu_trace())
    monkeypatch.setattr(H, "start_profiler", lambda: None)
    _, _, tr = H.cell(CELL)
    tr = {**tr, "scans": 12, "trace_steps": 4}
    result, checks = run_cell(CELL, 2 ** 31 + 77, 0.3, trace, "cpu",
                              time.time(), small(), tr)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] > 0
    want = {m["name"] for m in H.metrics_of(
        CELL, "per_layer" if trace else "end_to_end")}
    assert set(result["metrics"]) == want
    if trace:
        assert result["metrics"]["kernels_per_step.particle"]["value"] == \
            0.25


def test_the_reference_imports_nothing_of_the_program_or_jax():
    """In a fresh process: the reference alone loads neither the program
    nor JAX, sets TF32 off, and a run of the cell loads no JAX."""
    code = (
        "import sys, time, torch\n"
        "from slambench import reference_particle as R\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'slamnet_tpu', 'slamnet_tpu_torch'}))\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "from slambench import harness as H\n"
        "from slambench.run import run_cell\n"
        f"cfg, tr = {small()!r}, {H.cell(CELL)[2]!r}\n"
        "R.init(R.C.RefConfig(cfg['coreslam']), R.PConfig(cfg['particle']),"
        " torch.zeros(3), 1, 'cpu')\n"
        "print(torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n"
        "torch.set_num_threads(1)\n"
        f"r, _ = run_cell({CELL!r}, 5, 0.05, False, 'cpu', time.time(), "
        "cfg, {**tr, 'scans': 8})\n"
        "print(r['correct'], H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split("\n")[:3] == ["[]", "False False", "True []"]


def test_the_configuration_is_config_4_on_slam_nets_maps():
    _, cfg, tr = H.cell(CELL)
    core = H.load_json(H.ROOT / "slambench/configs/coreslam_sim256.json")
    assert cfg["coreslam"] == core["coreslam"]
    assert cfg["sensor"] == core["sensor"]
    assert cfg["reduced"] == [] and cfg["entry"] == "particle"
    assert len(cfg["source"]) <= 200 and "BASELINE.json" in cfg["source"]
    assert len(cfg["assumed"]) >= 4
    assert set(cfg["limits_why"]) == set(cfg["limits"])
    p = ParticleConfig(**cfg["particle"])
    assert (p.num_particles, p.top_k, p.refine_candidates) == (8192, 64, 64)
    assert p.resample_ess_frac == 0.5 and p.scorer == "exact"
    assert p.score_subsample == p.refine_subsample == 1
    assert p == ParticleConfig(num_particles=8192)     # the defaults
    assert isinstance(program_particle.Particles(cfg, "cpu").ccfg,
                      CoreSlamConfig)
    assert tr["kind"] == "particle_replay" and tr["scans"] == 522
    assert tr["trace_from"] == core["coreslam"]["position_search_beginning"]
    R.PConfig(cfg["particle"])
    C.RefConfig(cfg["coreslam"])


# ------------------------------------------------------- spans, counters
WARM, STEPPED = 5, 3


@pytest.fixture(scope="module")
def traced():
    torch.set_num_threads(1)
    cfg = small()
    log = logs.make_log(3, WARM + STEPPED, cfg["sensor"], "cpu")
    prog = program_particle.Particles(cfg, "cpu")
    plain = K.program_job(prog, log, log.traj[0], 99, WARM + STEPPED)
    before = program_particle.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = K.program_job(prog, log, log.traj[0], 99, WARM + STEPPED)
    after = program_particle.counters()
    return cfg, log, plain, out, prof, before, after


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("slamnet.")]


def test_each_scan_is_one_update_span_holding_its_phases(traced):
    prof = traced[4]
    spans = _spans(prof)
    steps = sorted((e for e in spans if e.name == "slamnet.particle.update"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == WARM + STEPPED
    assert not any(e.is_user_annotation for e in spans)
    for step in steps:
        assert step.cpu_parent is None or \
            not step.cpu_parent.name.startswith("slamnet.")
        kids = sorted((e for e in spans if e.cpu_parent is step),
                      key=lambda e: e.time_range.start)
        assert tuple(e.name for e in kids) == PHASES
        for a, b in zip(kids, kids[1:]):
            assert a.time_range.end <= b.time_range.start
    assert len(spans) == 5 * (WARM + STEPPED)


def test_the_scans_are_the_same_bits_under_the_profiler(traced):
    _, _, plain, out, _, _, _ = traced
    for a, b in zip(plain[:4], out[:4]):
        assert torch.equal(a, b)
    for name in ("particles", "scores", "hole_map", "obstacle_map", "pose",
                 "last_odometry", "scan_count"):
        assert torch.equal(getattr(plain[4], name), getattr(out[4], name))
    assert plain[4].scans == out[4].scans


def test_the_counters_count_scans_warm_scans_and_poses(traced):
    cfg, _, _, _, _, before, after = traced
    p = cfg["particle"]
    assert after["steps"] - before["steps"] == WARM + STEPPED
    assert after["warm_steps"] - before["warm_steps"] == STEPPED
    assert after["poses_scored"] - before["poses_scored"] == \
        (WARM + STEPPED) * (p["num_particles"]
                            + p["top_k"] * p["refine_candidates"])


def test_the_counters_read_none_in_a_program_without_them(monkeypatch):
    for k in program_particle.COUNTERS:
        monkeypatch.delattr(particle.update, k)
    assert program_particle.counters() == dict.fromkeys(
        program_particle.COUNTERS)


def _summary(prof) -> dict:
    tr = H.Trace("cpu")
    tr.prof, tr.window_s = prof, 1e-3
    return tr._read()


def test_the_step_reader_takes_the_update_spans_median(traced):
    prof = traced[4]
    d = [e.time_range.end - e.time_range.start for e in _spans(prof)
         if e.name == "slamnet.particle.update"]
    got = H.reader("particle_step_host_us")({"summary": _summary(prof)})
    assert got == pytest.approx(statistics.median(d), rel=1e-9) and got > 0


def test_the_step_reader_returns_none_without_a_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(2).add_(1.0)
    summary = _summary(prof)
    assert summary["host_ops"]
    assert H.reader("particle_step_host_us")({"summary": summary}) is None


def test_the_roofline_counts_the_scoring_work():
    """Two scans of 400 and 390 valid beams at the cell's sizes: the
    operations bound each, over 2 ms of busy time."""
    _, cfg, _ = H.cell(CELL)
    peaks = H.load_json(H.HERE / "peaks.json")
    w = K.work_of(cfg, 400, [400, 390])
    ops = 8 * (8192 + 64 * 64) * (400 + 390)
    ctx = {"work": w, "peaks": peaks,
           "summary": {"device_ops": [("a", 0.0, 1500.0),
                                      ("b", 1000.0, 2000.0)]}}
    got = H.reader("particle_score_roofline_pct")(ctx)
    assert got == pytest.approx(100 * ops / peaks["fp32_flops_per_s"]
                                / 2e-3, rel=1e-12)
    assert 0 < got < 100
    nbytes = 2 * (256 * 256 * 4 + 400 * 9) + (8192 + 4096) * 12
    assert nbytes / peaks["hbm_bytes_per_s"] < \
        8 * 12288 * 390 / peaks["fp32_flops_per_s"]
    ctx["summary"]["device_ops"] = []
    assert H.reader("particle_score_roofline_pct")(ctx) is None
