"""Graph-SLAM in the benchmark: the plain reference (``slambench/
reference_graph.py``) against the program's ``graph_slam.update``, the
control and the planted faults judged by the cell's own comparison, the
configuration's file, the log of two laps, the program's graph spans and
counters with their readers, and the loop-candidate gap.

Everything runs on the CPU at a small size: a 2-level 128-px Hector on 40
m, 64 keyframe slots, on a small revisit (a 5 m x 4 m rectangle driven
once and on along its first side at 1.3 m/s: 328 scans, 46 keyframe
events, about 12 closures), with the cell's 400 beams, frontend, gates and
gap.
"""
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slambench import control_graph, logs, logs_graph, program_graph
from slambench import harness as H
from slambench import reference_graph as R
from slambench.kinds import graph_replay as K
from slambench.run import run_cell
from slamnet_tpu_torch.core.config import PoseGraphConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.graph import frontend, posegraph
from slamnet_tpu_torch.models import graph_slam

SEED = 2 ** 31 + 5
BOOT = 10
# the two laps, kept before the module's fixture stands the revisit in
_real_loop = logs_graph.loop_trajectory
REVISIT = np.array([[20, 20], [25, 20], [25, 24], [20, 24], [20, 20],
                    [25, 20]], np.float32)
SPANS = ("graph_step_host_us", "slamnet.graph.update"), \
    ("graph_keyframe_host_us", "slamnet.graph.keyframe"), \
    ("graph_loop_match_host_us", "slamnet.graph.loop_match"), \
    ("graph_optimize_host_us", "slamnet.graph.optimize")


def revisit(sensor):
    return logs.waypoint_trajectory(REVISIT, sensor["speed_m_s"],
                                    sensor["scans_per_s"])


@pytest.fixture(scope="module", autouse=True)
def small_log():
    """The cell's log generator on the small revisit, and one intra-op
    thread: the suite's workers share the machine's cores, and
    oversubscribed threads slow these small replays ~10x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with mock.patch.object(logs_graph, "loop_trajectory", revisit):
        yield
    torch.set_num_threads(n)


def small():
    """The cell's configuration and traffic at the CPU's size."""
    _, cfg, tr = H.cell("graph_loop_replay")
    cfg = json.loads(json.dumps(cfg))
    cfg["hector"].update(map_size=128, map_resolution=0.3125, num_levels=2,
                         estimate_iterations=[4, 2])
    cfg["graph"].update(max_keyframes=64, max_edges=256)
    cfg["sensor"].update(speed_m_s=1.3)
    n = len(revisit(cfg["sensor"]))
    return cfg, {**tr, "scans": n, "trace_from": n - 8, "trace_steps": 8}


def _job(cfg, log, n):
    """One job through the program as the cell runs it (under whatever
    plant is in place): (live poses, keyframe scans, closure scans,
    outcome, the frontend gap of its loop matches)."""
    prog = program_graph.GraphSlam(cfg, cfg["sensor"]["beams"], "cpu")
    with prog.recorded_searches() as found:
        poses, kf_at, loop_at, st = K.program_job(prog, log, BOOT, n)
    return poses, kf_at, loop_at, program_graph.outcome(st), \
        K.frontend_gap(cfg, found)


@pytest.fixture(scope="module")
def job():
    """One job through the program and through the reference."""
    cfg, tr = small()
    n = tr["scans"]
    log = logs_graph.make_log(SEED, n, cfg["sensor"], "cpu")
    ref = R.replay(cfg, log.traj, log.points, log.valid, BOOT, n, {40, n})
    return cfg, log, _job(cfg, log, n), ref


def test_the_reference_equals_the_program_at_a_small_size(job):
    """The same keyframe and closure scans, and bit for bit up to the first
    closure.  After it the solves round differently (the program solves a
    bucket of 32 nodes, the reference exactly the nodes there are; H's
    condition number is ~1e7 in float32), which moves a re-anchored
    keyframe pose: other scans stay within 1e-4 m, Hector's match pulling
    the live pose back onto its map, and every gap within the cell's
    limits."""
    cfg, log, (poses, kf_at, loop_at, out, front), \
        (rposes, rkf, rloop, snaps) = job
    n = len(rposes)
    assert front == 0.0
    assert kf_at == rkf.nonzero().flatten().tolist()
    assert loop_at == rloop.nonzero().flatten().tolist()
    assert len(kf_at) >= 40 and len(loop_at) >= 5
    first = loop_at[0]
    assert torch.equal(poses[:first], rposes[:first])
    gaps = (poses - rposes)[:, :2].norm(dim=1)
    far = (gaps > 1e-4).nonzero().flatten().tolist()
    assert set(far) <= {t for t in kf_at if t >= first}
    lim = cfg["limits"]
    xy, th = H.pose_gaps(poses, rposes)
    assert xy <= lim["pose_gap_m"] and th <= lim["heading_gap_rad"]
    assert out["keyframes"] == snaps[n].keyframes == len(kf_at) + 1
    assert out["closures"] == snaps[n].closures == len(loop_at)
    kf_gap, _ = H.pose_gaps(out["kf_poses"], snaps[n].kf_poses)
    assert kf_gap <= lim["keyframe_pose_gap_m"]
    assert H.cells_differing(out["maps"], snaps[n].maps) == 0
    # the job is no trivial one: the robot went round
    assert float((rposes[-1, :2] - rposes[0, :2]).norm()) > 4.0


def test_a_sound_job_reads_within_the_limits(job):
    """A whole job and a partial last one of 40 scans, judged by the
    cell's comparison: every number within its limit, the counts 0."""
    cfg, log, (poses, kf_at, _, out, front), ref = job
    p40, _, _, o40, _ = _job(cfg, log, 40)
    counts = [(out["keyframes"], out["closures"]),
              (o40["keyframes"], o40["closures"])]
    checks = K.compare(cfg["limits"], [poses, p40], counts, o40, out, ref,
                       front, 0)
    assert H.judge(checks), checks
    for k in ("keyframes_differing", "closures_differing", "frontend_gap_m",
              "map_cells_differing", "failed_scans"):
        assert checks[k][0] == 0, checks


@pytest.mark.parametrize("plant", control_graph.PLANTS)
def test_the_control_and_the_faults_are_not_correct(job, plant):
    """Each plant's job, judged by the cell's comparison against the
    reference's job."""
    cfg, log, _, ref = job
    with control_graph.planted(plant, cfg):
        poses, _, _, out, front = _job(cfg, log, len(ref[0]))
    checks = K.compare(cfg["limits"], [poses],
                       [(out["keyframes"], out["closures"])], out, out, ref,
                       front, 0)
    assert not H.judge(checks), checks
    if plant == "control":      # the frontend's own check catches it
        assert checks["frontend_gap_m"][0] > cfg["limits"]["frontend_gap_m"]


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
    """The kind as ``run.py`` drives it on the small job's first 100
    scans, traced with the host's events only (the traced stretch: scans
    96-99, which hold the first corner's first search)."""
    monkeypatch.setattr(H, "Trace", _cpu_trace())
    monkeypatch.setattr(H, "start_profiler", lambda: None)
    cfg, tr = small()
    tr = {**tr, "scans": 100, "trace_from": 96, "trace_steps": 4}
    result, checks = run_cell("graph_loop_replay", 2 ** 31 + 77, 0.4, trace,
                              "cpu", time.time(), cfg, tr)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] > 0
    want = {m["name"] for m in H.metrics_of(
        "graph_loop_replay", "per_layer" if trace else "end_to_end")}
    assert set(result["metrics"]) == want


def test_the_log_is_the_loop_twice_round():
    sensor = {"beams": 40, "scans_per_s": 17.0, "max_range_m": 40.0,
              "noise_m": 0.02, "speed_m_s": 0.3}
    lap = logs.waypoint_trajectory(logs.LOOP_WAYPOINTS, 0.3, 17.0)
    two = _real_loop(sensor)
    assert lap.shape[0] == 4740 and two.shape[0] >= 5340
    np.testing.assert_array_equal(two[:4740], lap)
    # the heading runs on at the wrap: no step larger than the turn cap
    dth = np.diff(np.unwrap(two[4700:4800, 2].astype(np.float64)))
    assert np.abs(dth).max() <= np.radians(60.0) / 17.0 + 1e-6
    a = logs.make_log(11, 6, sensor, "cpu")
    with mock.patch.object(logs_graph, "loop_trajectory", _real_loop):
        b = logs_graph.make_log(11, 6, sensor, "cpu")
        with pytest.raises(ValueError, match="two laps"):
            logs_graph.make_log(11, two.shape[0] + 1, sensor, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_the_configuration_carries_the_sources_values():
    """slam_toolbox's gates, hector_sim400's Hector unchanged, the
    frontend's and the pose graph's defaults, the traffic's shape."""
    _, cfg, tr = H.cell("graph_loop_replay")
    _, hcfg, _ = H.cell("robot_replay")
    assert cfg["hector"] == hcfg["hector"]
    assert cfg["bootstrap_overrides"] == hcfg["bootstrap_overrides"]
    assert cfg["sensor"] == hcfg["sensor"] and cfg["reduced"] == []
    g = program_graph.graph_config(cfg["graph"])
    # minimum_travel_distance, minimum_travel_heading,
    # loop_search_maximum_distance
    assert (g.keyframe_dist, g.keyframe_angle, g.loop_closure_radius) == \
        (0.5, 0.5, 3.0)
    # a candidate at least 7 keyframes older: index < new - 6
    assert g.loop_min_index_gap == 6
    d = PoseGraphConfig()
    for k in ("max_keyframes", "max_edges", "optimize_iterations",
              "optimize_iterations_loop", "damping", "loop_max_translation",
              "loop_min_inlier_frac", "odom_edge_weights",
              "loop_edge_weights", "huber_delta"):
        assert getattr(g, k) == getattr(d, k), k
    assert program_graph.GraphSlam(cfg, 400, "cpu").mcfg == \
        frontend.ScanMatchConfig()
    assert "slam_toolbox" in cfg["source"] and "slam.net" in cfg["source"]
    assert (tr["scans"], tr["bootstrap"], tr["trace_from"],
            tr["trace_steps"]) == (5340, 10, 4300, 1040)
    assert tr["trace_from"] + tr["trace_steps"] == tr["scans"]
    R.RefGraphConfig(cfg)


def test_the_references_tracker_is_its_hector_step(job):
    """``reference_graph.Tracker`` (the tracked scan on fixed buffers, a
    CUDA graph on a card) gives ``reference.step``'s answers bit for bit."""
    cfg, log, _, _ = job
    rc = R.RefGraphConfig(cfg)
    a = R.reference.init(rc.hector, log.traj[:1].clone())
    for t in range(BOOT):
        a = a._replace(match_pose=log.traj[t][None].clone())
        a, _ = R.reference.step(a, log.points[t][None], log.valid[t][None],
                                rc.boot, True, False)
    b = a._replace(maps=a.maps.clone())
    tracker = R.Tracker(rc.hector, b, log.points.shape[1], False)
    for t in range(BOOT, BOOT + 40):
        a, _ = R.reference.step(a, log.points[t][None], log.valid[t][None],
                                rc.hector, False, False)
        b = tracker.step(b, log.points[t], log.valid[t])
        assert torch.equal(a.match_pose, b.match_pose)
        assert torch.equal(a.last_pose, b.last_pose)
    assert torch.equal(a.maps, b.maps)


def test_the_references_local_grid_is_the_frontends():
    """The reference's one-level grid settings are the ones the program's
    frontend hands its kernels."""
    _, cfg, _ = H.cell("graph_loop_replay")
    ref = R.RefGraphConfig(cfg).grid
    prog = frontend.grid_config(frontend.ScanMatchConfig(**cfg["frontend"]))
    for k in R.reference.RefConfig.FIELDS:
        want = getattr(prog, k)
        got = getattr(ref, k)
        assert (list(got) == list(want) if isinstance(want, (tuple, list))
                else got == want), k


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, slambench.reference_graph, slambench.logs_graph; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'slamnet_tpu', 'slamnet_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------- spans, counters
def _scans(prog, log, st, lo: int, hi: int):
    """Scans ``lo`` to ``hi`` of a job from ``st``: (state, live poses,
    keyframe scans, closure scans)."""
    poses, kf_at, loop_at = [], [], []
    for t in range(lo, hi):
        nodes, loops = st.nodes, graph_slam.update.closures
        st, p = prog.step(st, log.points[t], log.valid[t],
                          log.traj[t] if t < BOOT else None)
        poses.append(p)
        if st.nodes != nodes:
            kf_at.append(t)
        if graph_slam.update.closures != loops:
            loop_at.append(t)
    return st, torch.stack(poses), kf_at, loop_at


@pytest.fixture(scope="module")
def traced(job):
    """The small job to two scans past its first closure, the last 16
    scans profiled, and the same scans unprofiled."""
    cfg, log, (_, _, loop_at, _, _), _ = job
    hi = loop_at[0] + 2
    lo = hi - 16
    prog = program_graph.GraphSlam(cfg, cfg["sensor"]["beams"], "cpu")
    plain = _scans(prog, log, prog.init(log.traj[0]), 0, hi)
    st = _scans(prog, log, prog.init(log.traj[0]), 0, lo)[0]
    before = program_graph.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _scans(prog, log, st, lo, hi)
    after = program_graph.counters()
    return cfg, lo, plain, out, prof, before, after


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("slamnet.")]


def test_the_spans_nest_as_stated(traced):
    _, lo, _, (_, poses, kf_at, loop_at), prof, before, after = traced
    spans = _spans(prof)
    assert not any(e.is_user_annotation for e in spans)
    kids = {}
    for e in spans:
        kids.setdefault(id(e.cpu_parent), []).append(e)
    steps = sorted((e for e in spans if e.name == "slamnet.graph.update"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == len(poses)
    searched = 0
    for t, step in enumerate(steps, lo):
        assert step.cpu_parent is None or \
            not step.cpu_parent.name.startswith("slamnet.")
        inner = sorted(kids.get(id(step), []),
                       key=lambda e: e.time_range.start)
        want = ("slamnet.hector.update", "slamnet.graph.keyframe") \
            if t in kf_at else ("slamnet.hector.update",)
        assert tuple(e.name for e in inner) == want
        if t in kf_at:
            event = [e.name for e in sorted(
                kids.get(id(inner[1]), []), key=lambda e: e.time_range.start)]
            assert event in (["slamnet.graph.optimize"],
                             ["slamnet.graph.loop_match",
                              "slamnet.graph.optimize"])
            searched += len(event) == 2
    assert searched == after["searches"] - before["searches"] >= 1
    assert len(kf_at) >= 2 and len(loop_at) >= 1


def test_the_scans_are_the_same_bits_under_the_profiler(traced):
    _, lo, (st0, p0, k0, l0), (st1, p1, k1, l1), _, _, _ = traced
    assert torch.equal(p0[lo:], p1)
    assert [t for t in k0 if t >= lo] == k1
    assert [t for t in l0 if t >= lo] == l1
    assert torch.equal(st0.hector.maps, st1.hector.maps)
    assert torch.equal(st0.graph.poses, st1.graph.poses)


def test_the_counters_count_the_events(traced):
    cfg, _, _, (st, _, kf_at, loop_at), _, before, after = traced
    d = {k: after[k] - before[k] for k in program_graph.COUNTERS}
    g = program_graph.graph_config(cfg["graph"])
    assert d["keyframes"] == len(kf_at) and d["closures"] == len(loop_at)
    assert d["solves"] == len(kf_at) * g.optimize_iterations + len(
        loop_at) * (g.optimize_iterations_loop - g.optimize_iterations)
    assert d["syncs"] == 16 + len(kf_at) + d["searches"]
    assert after["solve_unknowns"] >= 3 * posegraph.bucket(
        g.max_keyframes, st.nodes)


def _summary(prof) -> dict:
    tr = H.Trace("cpu")
    tr.prof, tr.window_s = prof, 1e-3
    return tr._read()


@pytest.mark.parametrize("metric,span", SPANS)
def test_readers_take_the_spans_median(traced, metric, span):
    prof = traced[4]
    d = [e.time_range.end - e.time_range.start for e in _spans(prof)
         if e.name == span]
    assert d
    got = H.reader(metric)({"summary": _summary(prof)})
    assert got == pytest.approx(statistics.median(d), rel=1e-9) and got > 0


@pytest.mark.parametrize("metric", [m for m, _ in SPANS])
def test_readers_return_none_without_a_span(metric):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(2).add_(1.0)
    summary = _summary(prof)
    assert summary["host_ops"]
    assert H.reader(metric)({"summary": summary}) is None


def test_the_host_reads_reader_takes_the_counter():
    read = H.reader("graph_host_reads_per_scan")
    assert read({"counters": {"syncs": 30}, "steps": 24}) == 1.25
    assert read({"counters": None, "steps": 24}) is None
    assert read({"counters": {"syncs": None}, "steps": 24}) is None
    assert read({"steps": 24}) is None


# ------------------------------------------------------ the candidate gap
def _chain(gap: int):
    """A graph of 9 nodes 0.3 m apart on a line (all within the loop
    radius), then one keyframe event at the end of the line: the node
    whose cloud the frontend matches, or None without a search."""
    cfg, _ = small()
    h = program_graph.hector_config(cfg["hector"])
    g = PoseGraphConfig(max_keyframes=16, max_edges=64, keyframe_dist=0.2,
                        loop_closure_radius=3.0, loop_min_index_gap=gap)
    st = graph_slam.init(h, g, torch.tensor([20.0, 20.0, 0.0]), 8, "cpu")
    for i in range(1, 9):
        st.graph.poses[i] = torch.tensor([20.0 + 0.3 * i, 20.0, 0.0])
        st.graph.node_valid[i] = True
    st = st._replace(graph=st.graph._replace(
        num_nodes=torch.tensor(9, dtype=torch.int32)), nodes=9,
        last_kf_pose=torch.tensor([0.0, 0.0, 0.0]))
    st = st._replace(hector=st.hector._replace(
        match_pose=torch.tensor([22.7, 20.0, 0.0])))
    seen = []
    real = frontend.match_scans

    def match_scans(ref, qry, init_rel, *args, **kwargs):
        seen.append(round(22.7 - float(init_rel[0]), 4))
        return real(ref, qry, init_rel, *args, **kwargs)
    pts = torch.tensor([[1.0, 0.0]] * 8)
    with mock.patch.object(frontend, "match_scans", match_scans):
        graph_slam.update(st, Scan.from_points(pts), h, g,
                          map_without_matching=True)
    if not seen:
        return None
    return round((seen[0] - 20.0) / 0.3)


@pytest.mark.parametrize("gap,cand", [(5, 3), (6, 2), (7, 1), (8, 0),
                                      (9, None)])
def test_the_gap_admits_candidates_gap_plus_one_back(gap, cand):
    """The new node is 9: the nearest admitted candidate is node
    9 - gap - 1, so the cell's 6 drops node 4 (5 back) that the default 5
    admits, and 7 drops node 3 (6 back) too."""
    assert _chain(gap) == cand


def test_the_default_gap_is_the_old_constant(job):
    """``loop_min_index_gap`` 5 (the default) gives ``graph_slam.update``
    the answers it gave with the constant 5 in place of the knob, bit for
    bit, on the small job with the default's candidates."""
    cfg, log, _, _ = job
    cfg = json.loads(json.dumps(cfg))
    del cfg["graph"]["loop_min_index_gap"]
    assert program_graph.graph_config(cfg["graph"]).loop_min_index_gap == 5
    n = 160
    prog = program_graph.GraphSlam(cfg, cfg["sensor"]["beams"], "cpu")
    new = K.program_job(prog, log, BOOT, n)
    real = frontend.loop_candidates

    def constant(poses, valid, cur, radius, _gap):
        return real(poses, valid, cur, radius, 5)
    with mock.patch.object(frontend, "loop_candidates", constant):
        old = K.program_job(prog, log, BOOT, n)
    assert torch.equal(new[0], old[0]) and new[1:3] == old[1:3]
    assert torch.equal(new[3].graph.poses, old[3].graph.poses)
    assert len(new[2]) >= 1
