"""CoreSLAM in the benchmark: the plain reference (``slambench/
reference_coreslam.py``) against the program's ``coreslam.update``, the
control and the planted faults judged by the cell's own comparison, the
configuration's file, and the program's CoreSLAM spans and counters with
their readers.

Everything runs on the CPU at a small size: a 64-px hole map on 10 m, a
16-px obstacle map, 40 beams and 64 candidates, 30 scans of the loop log
(5 trusted), the job started at the log's first pose less (15 m, 15 m) so
that the robot lies in the small map and most rays leave it.
"""
import json
import statistics
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slambench import control_coreslam, program_coreslam
from slambench import harness as H
from slambench import reference_coreslam as R
from slambench.kinds import coreslam_replay as K
from slambench.run import run_cell
from slamnet_tpu_torch.core.config import CoreSlamConfig
from slamnet_tpu_torch.models import coreslam

SCANS = 30
SEEDS = (2 ** 31 + 5, 7, 3_300_000_017)
SHIFT = torch.tensor([15.0, 15.0, 0.0])
SPANS = ("coreslam_step_host_us", "slamnet.coreslam.update"), \
    ("coreslam_search_host_us", "slamnet.coreslam.search"), \
    ("coreslam_map_host_us", "slamnet.coreslam.map_update")


def small(physical=10.0):
    """The cell's configuration at the CPU's size."""
    _, cfg, _ = H.cell("coreslam_replay")
    cfg = json.loads(json.dumps(cfg))
    cfg["coreslam"].update(physical_map_size=physical, hole_map_size=64,
                           obstacle_map_size=16, num_candidates=64)
    cfg["sensor"]["beams"] = 40
    return cfg


@pytest.fixture(scope="module", params=SEEDS)
def job(request):
    """One job through the program and through the reference."""
    cfg = small()
    rays = K.make_rays(request.param, SCANS, cfg["sensor"], "cpu")
    start = rays.traj[0] - SHIFT
    seed = K.job_seed(request.param)
    prog = program_coreslam.CoreSlam(cfg["coreslam"], "cpu")
    poses, sums, st = K.program_job(prog, rays, start, seed, SCANS)
    ref = R.replay(R.RefConfig(cfg["coreslam"]), rays.angles, rays.radii,
                   rays.valid, start, seed, SCANS, {11, SCANS})
    return cfg, rays, start, seed, (poses, sums, st), ref


def test_the_reference_equals_the_program_at_a_small_size(job):
    cfg, _, _, _, (poses, sums, st), (rposes, rsums, snaps, rst) = job
    assert torch.equal(poses, rposes)
    assert torch.equal(sums.to(torch.int64), rsums)
    assert torch.equal(st.hole_map, rst.hole)
    assert torch.equal(st.obstacle_map, rst.obstacle)
    assert torch.equal(snaps[SCANS][0], rst.hole)
    # the job is no trivial one: searched, the maps marked, the robot moved
    warm = cfg["coreslam"]["position_search_beginning"]
    assert bool((rsums[:warm] == 0).all()) and bool((rsums[warm:] > 0).all())
    assert int((rst.hole != R.HOLE_INIT).sum()) > 500
    assert int((rst.obstacle != -5).sum()) > 20
    assert float((rposes[-1, :2] - rposes[0, :2]).norm()) > 0.2


def test_the_comparison_reads_zero_on_a_sound_job(job):
    """A whole job and a partial last one of 11 scans."""
    cfg, rays, start, seed, (poses, sums, st), (rposes, rsums, snaps, _) = job
    prog = program_coreslam.CoreSlam(cfg["coreslam"], "cpu")
    p11, s11, st11 = K.program_job(prog, rays, start, seed, 11)
    checks = K.compare(cfg["limits"], [poses, p11], [sums, s11],
                       K.maps_of(st11), K.maps_of(st), rposes, rsums, snaps,
                       SCANS, 0)
    assert all(v == 0 for v, _ in checks.values()), checks
    assert H.judge(checks)


@pytest.mark.parametrize("plant", control_coreslam.PLANTS)
def test_the_control_and_the_faults_are_not_correct(job, plant):
    """Each plant's job, judged by the cell's comparison against the
    reference's job."""
    cfg, rays, start, seed, _, (rposes, rsums, snaps, _) = job
    with control_coreslam.planted(plant):
        prog = program_coreslam.CoreSlam(cfg["coreslam"], "cpu")
        poses, sums, st = K.program_job(prog, rays, start, seed, SCANS)
    maps = K.maps_of(st)
    checks = K.compare(cfg["limits"], [poses], [sums], maps, maps, rposes,
                       rsums, snaps, SCANS, 0)
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
    """The kind as ``run.py`` drives it, on a 40-m map of 64 px (the loop's
    start lies in it), traced with the host's events only."""
    monkeypatch.setattr(H, "Trace", _cpu_trace())
    monkeypatch.setattr(H, "start_profiler", lambda: None)
    _, _, tr = H.cell("coreslam_replay")
    tr = {**tr, "scans": 12, "trace_steps": 8}
    result, checks = run_cell("coreslam_replay", 2 ** 31 + 77, 0.4, trace,
                              "cpu", time.time(), small(40.0), tr)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] > 0
    want = {m["name"] for m in H.metrics_of(
        "coreslam_replay", "per_layer" if trace else "end_to_end")}
    assert set(result["metrics"]) == want


def test_the_rays_are_the_logs():
    from slambench import logs
    cfg = small()
    rays = K.make_rays(11, 6, cfg["sensor"], "cpu")
    log = logs.make_log(11, 6, cfg["sensor"], "cpu")
    assert torch.equal(rays.traj, log.traj)
    assert rays.radii.shape == (6, 40) and bool(rays.valid.all())


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, slambench.reference_coreslam; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'slamnet_tpu', 'slamnet_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_configuration_is_slam_nets():
    _, cfg, tr = H.cell("coreslam_replay")
    c = program_coreslam.coreslam_config(cfg["coreslam"])
    assert isinstance(c, CoreSlamConfig)
    assert (c.physical_map_size, c.hole_map_size, c.obstacle_map_size) == \
        (40.0, 256, 64)
    assert c.sigma_xy == 0.1 and c.sigma_theta == pytest.approx(
        3.141592653589793 / 18, rel=1e-15)
    assert c.num_candidates == 4001 and c.quality == 50
    assert c.hole_width == 2.0 and c.position_search_beginning == 5
    assert (c.unmapped_obstacle_hits, c.max_obstacle_hits) == (-5, 10)
    assert c.search_mode == "mc"
    assert not c.dense_hole_fill and not c.dense_obstacle_fill
    assert cfg["reduced"] == [] and cfg["sensor"]["beams"] == 400
    assert tr["scans"] == 522
    R.RefConfig(cfg["coreslam"])


# ------------------------------------------------------- spans, counters
WARM, SEARCHED = 5, 3


def _updates(cfg, rays, start):
    prog = program_coreslam.CoreSlam(cfg["coreslam"], "cpu")
    return K.program_job(prog, rays, start, 99, WARM + SEARCHED)


@pytest.fixture(scope="module")
def traced():
    cfg = small()
    rays = K.make_rays(3, WARM + SEARCHED, cfg["sensor"], "cpu")
    start = rays.traj[0] - SHIFT
    plain = _updates(cfg, rays, start)
    before = program_coreslam.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _updates(cfg, rays, start)
    after = program_coreslam.counters()
    return cfg, plain, out, prof, before, after


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("slamnet.")]


def test_each_scan_is_one_update_span_holding_its_phases(traced):
    _, _, _, prof, _, _ = traced
    spans = _spans(prof)
    steps = sorted((e for e in spans if e.name == "slamnet.coreslam.update"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == WARM + SEARCHED
    assert not any(e.is_user_annotation for e in spans)
    for i, step in enumerate(steps):
        assert step.cpu_parent is None or \
            not step.cpu_parent.name.startswith("slamnet.")
        kids = sorted((e for e in spans if e.cpu_parent is step),
                      key=lambda e: e.time_range.start)
        want = ("slamnet.coreslam.map_update",) if i < WARM else \
            ("slamnet.coreslam.search", "slamnet.coreslam.map_update")
        assert tuple(e.name for e in kids) == want
        for a, b in zip(kids, kids[1:]):
            assert a.time_range.end <= b.time_range.start
    assert len(spans) == 2 * (WARM + SEARCHED) + SEARCHED


def test_the_scans_are_the_same_bits_under_the_profiler(traced):
    _, (p0, s0, st0), (p1, s1, st1), _, _, _ = traced
    assert torch.equal(p0, p1) and torch.equal(s0, s1)
    assert torch.equal(st0.hole_map, st1.hole_map)
    assert torch.equal(st0.obstacle_map, st1.obstacle_map)


def test_the_counters_count_the_searches_and_candidates(traced):
    cfg, _, _, _, before, after = traced
    assert after["searches"] - before["searches"] == SEARCHED
    assert after["candidates"] - before["candidates"] == \
        SEARCHED * cfg["coreslam"]["num_candidates"]


def test_update_cloud_called_directly_is_one_update_span():
    from slamnet_tpu_torch.core.scan import Scan
    cfg = CoreSlamConfig(physical_map_size=10.0, hole_map_size=32,
                         obstacle_map_size=8, num_candidates=16)
    st = coreslam.init(cfg, torch.tensor([5.0, 5.0, 0.0]), device="cpu")
    cloud = Scan.from_points(torch.tensor([[1.0, 0.0], [0.0, 2.0]]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coreslam.update_cloud(st, cloud, st.pose, cfg)
    names = [e.name for e in _spans(prof)]
    assert names.count("slamnet.coreslam.update") == 1
    assert names.count("slamnet.coreslam.map_update") == 1


def _summary(prof) -> dict:
    tr = H.Trace("cpu")
    tr.prof, tr.window_s = prof, 1e-3
    return tr._read()


@pytest.mark.parametrize("metric,span", SPANS)
def test_readers_take_the_spans_median(traced, metric, span):
    _, _, _, prof, _, _ = traced
    d = [e.time_range.end - e.time_range.start for e in _spans(prof)
         if e.name == span]
    assert len(d) == (SEARCHED if "search" in span else WARM + SEARCHED)
    got = H.reader(metric)({"summary": _summary(prof)})
    assert got == pytest.approx(statistics.median(d), rel=1e-9) and got > 0


@pytest.mark.parametrize("metric", [m for m, _ in SPANS])
def test_readers_return_none_without_a_span(metric):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(2).add_(1.0)
    summary = _summary(prof)
    assert summary["host_ops"]
    assert H.reader(metric)({"summary": summary}) is None
