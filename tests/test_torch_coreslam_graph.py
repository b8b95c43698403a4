"""``coreslam.update``'s CUDA graph policy (``models/coreslam.StepGraphs``)
on the CPU, with a stand-in for the capture: the stand-in records the
step's body and runs it on each replay, so the cache, the key, the static
inputs, the packed results, the generator's hand-over and the counts are
the real ones.  The CUDA capture itself runs only on the card
(``chip_smoke.py``, phase 40).

A small CoreSLAM: a 128-px hole map, a 32-px obstacle map, 64 beams, 257
Monte-Carlo candidates, 12 scans of the loop (5 trusted, 7 searched).
"""
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slambench import harness as H
from slamnet_tpu_torch.core.config import CoreSlamConfig
from slamnet_tpu_torch.core.scan import Scan, SegmentScan, segments_to_cloud
from slamnet_tpu_torch.models import coreslam
from slamnet_tpu_torch.ops import _build, holemap, score
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

CFG = CoreSlamConfig(hole_map_size=128, obstacle_map_size=32,
                     num_candidates=257)
SCANS = 12
WARM = CFG.position_search_beginning
CPU = torch.device("cpu")


class Recorded:
    """A stand-in for a captured CUDA graph: ``replay`` runs the recorded
    body on the CPU and then sets back the host counts its Python moved (a
    graph's replay runs no Python)."""

    def __init__(self, body, device, generators):
        self.body, self.device, self.generators = body, device, generators
        self.resets = 0

    def replay(self):
        f = coreslam.update_cloud
        counts = f.searches, f.candidates
        self.body()
        f.searches, f.candidates = counts

    def reset(self):
        self.resets += 1


class Recorder:
    """``StepGraphs``' ``record``: keeps every stand-in it made, and counts
    ``n`` launches under each of ``kernels`` (``ops/_build``'s keys) as a
    capture's Python does on the card."""

    def __init__(self, n: int = 0, kernels=("K7_hole_walk", "K8_search")):
        self.made, self.counted = [], tuple((k, n) for k in kernels)

    def __call__(self, body, device, generators=()):
        _build.add_launches(self.counted)
        self.made.append(Recorded(body, device, generators))
        return self.made[-1]


@pytest.fixture(scope="module")
def rays():
    """SCANS scans of the loop, 0.3 m apart: (true poses, beam angles,
    ranges, flags) on the CPU."""
    traj = torch.from_numpy(loop_trajectory(0.3)[::16][:SCANS]).float()
    angles = torch.from_numpy(revolution_angles(64)).float()
    r, v = scan_revolution(default_field(device="cpu"), traj, angles, 40.0,
                           0.02, torch.Generator().manual_seed(5))
    return traj, angles, r.float(), v


def _inputs(entry, st, rays, t, beams=None):
    """Scan ``t``'s inputs to ``StepGraphs.step``: the segment tagged with
    the state's pose (the benchmark's program), or its de-skewed cloud and
    that pose as the odometry."""
    _, angles, r, v = rays
    seg = SegmentScan(angles[None, :beams], r[t][None, :beams],
                      v[t][None, :beams], st.pose[None])
    if entry == "update":
        return tuple(seg)
    return (*segments_to_cloud(seg), st.pose.clone())


def _init(rays, seed=3):
    return coreslam.init(CFG, rays[0][0], seed=seed, device="cpu")


def _job(step, entry, st, rays, lo=0, hi=SCANS):
    """Scans lo..hi through ``step(entry, state, inputs, cfg)``: (state,
    [(state, info)] a scan)."""
    out = []
    for t in range(lo, hi):
        st, info = step(entry, st, _inputs(entry, st, rays, t), CFG)
        out.append((st, info))
    return st, out


def _eager(entry, st, inputs, cfg):
    return coreslam._step(entry, st, inputs, cfg)


def _counts():
    return (coreslam.update.graph_captures, coreslam.update.graph_replays)


def _same(a, b):
    """Two (state, info) lists equal bit for bit, dtypes and shapes too."""
    for (sa, ia), (sb, ib) in zip(a, b):
        assert sa.scans == sb.scans
        for x, y in zip((*sa[:5], *ia), (*sb[:5], *ib)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
    assert len(a) == len(b)


@pytest.mark.parametrize("entry", ["update", "update_cloud"])
def test_first_sight_eager_second_captures_then_replays_bit_for_bit(
        rays, entry):
    rec = Recorder()
    graphs = coreslam.StepGraphs(record=rec)
    want_st, want = _job(_eager, entry, _init(rays), rays)
    seen, c0 = [], _counts()

    def step(*args):
        out = graphs.step(*args)
        seen.append((len(rec.made), _counts()[0] - c0[0],
                     _counts()[1] - c0[1]))
        return out

    got_st, got = _job(step, entry, _init(rays), rays)
    # trusted scans 0-4: eager, captured at 1, replayed from 2; searched
    # scans 5-11: eager, captured at 6, replayed from 7
    assert seen == [(0, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3),
                    (1, 1, 3), (2, 2, 3)] + [(2, 2, k) for k in range(4, 9)]
    _same(got, want)
    assert torch.equal(got_st.generator.get_state(),
                       want_st.generator.get_state())
    trusted, searched = graphs.graphs[CPU].values()
    assert trusted.generator is None
    assert [r.generators for r in rec.made] == [(), (searched.generator,)]
    assert [int(i.searched) for _, i in got] == [0] * WARM + [1] * (
        SCANS - WARM)


def test_the_generator_stands_where_the_eager_draws_leave_it(rays):
    graphs = coreslam.StepGraphs(record=Recorder())
    for seed in (11, 2 ** 40 + 7):          # two jobs, fresh generators
        want_st, want = _job(_eager, "update", _init(rays, seed), rays)
        got_st, got = _job(graphs.step, "update", _init(rays, seed), rays)
        _same(got, want)
        assert torch.equal(got_st.generator.get_state(),
                           want_st.generator.get_state())
        # the next draw, outside the step, is the eager run's
        assert torch.equal(
            torch.randn(5, generator=got_st.generator),
            torch.randn(5, generator=want_st.generator))
    assert coreslam.update.graph_captures and len(graphs.graphs[CPU]) == 2


def test_a_returned_state_shares_no_storage_with_a_later_replay(rays):
    graphs = coreslam.StepGraphs(record=Recorder())
    st, out = _job(graphs.step, "update", _init(rays), rays, 0, 8)
    kept = out[-1][0]                       # a replayed scan's state
    copies = [t.clone() for t in kept[:5]]
    _, later = _job(graphs.step, "update", st, rays, 8, SCANS)
    for g in graphs.graphs[CPU].values():
        buffers = {t.untyped_storage().data_ptr() for t in (
            *g.inputs, *g.outputs["maps"], g.outputs["packed"])}
        for s, _ in out[7:] + later:        # every replayed scan's state
            assert not {t.untyped_storage().data_ptr()
                        for t in s[:5]} & buffers
    assert all(torch.equal(a, b) for a, b in zip(kept[:5], copies))
    assert kept.hole_map.data_ptr() != later[-1][0].hole_map.data_ptr()


def test_the_key_holds_entry_config_warmth_and_shapes_not_addresses(rays):
    graphs = coreslam.StepGraphs(record=Recorder())
    a, b = _init(rays), _init(rays, seed=9)
    ins = _inputs("update", a, rays, 0)
    base = graphs.key("update", a, ins, CFG)
    assert base[:4] == ("update", CPU, CFG, False)
    assert a.hole_map.data_ptr() != b.hole_map.data_ptr()
    assert graphs.key("update", b, _inputs("update", b, rays, 0),
                      CFG) == base            # another job's maps
    others = {
        "entry": graphs.key("update_cloud", a,
                            _inputs("update_cloud", a, rays, 0), CFG),
        "config": graphs.key("update", a, ins,
                             CFG.overlay({"sigma_xy": 0.2})),
        "warm": graphs.key("update", a._replace(scans=WARM), ins, CFG),
        "beams": graphs.key("update", a,
                            _inputs("update", a, rays, 0, beams=48), CFG)}
    assert all(k != base for k in others.values())
    assert len(set(others.values())) == len(others)
    # one job captures; another job's fresh init replays at once
    _job(graphs.step, "update", a, rays, 0, 3)
    c0 = _counts()
    _job(graphs.step, "update", b, rays, 0, 1)
    assert _counts() == (c0[0], c0[1] + 1)


def test_the_cache_keeps_its_bound_least_recently_used_out(rays):
    rec = Recorder()
    graphs = coreslam.StepGraphs(record=rec)
    bound = coreslam.GRAPHS_PER_DEVICE
    cfgs = [CFG.overlay({"sigma_xy": 0.1 + 0.01 * i})
            for i in range(bound + 1)]
    st = _init(rays)
    ins = _inputs("update", st, rays, 0)

    def capture(cfg):
        for _ in range(2):
            graphs.step("update", st, ins, cfg)

    for cfg in cfgs[:bound]:
        capture(cfg)
    graphs.step("update", st, ins, cfgs[0])      # replayed: most recent
    capture(cfgs[bound])                         # evicts cfgs[1]'s
    cache = graphs.graphs[CPU]
    assert [k[2] for k in cache] == cfgs[2:bound] + [cfgs[0], cfgs[bound]]
    assert [g.resets for g in rec.made] == [0, 1] + [0] * (bound - 1)


def _fake(dev="cuda:0"):
    """A state and a scan whose tensors only say they live on ``dev``."""
    d = torch.device(dev)
    t = SimpleNamespace(device=d)
    count = torch.zeros((), dtype=torch.int32)
    return (coreslam.CoreSlamState(t, t, t, t, count,
                                   SimpleNamespace(device=d), 0), (t, t, t))


def test_the_cpu_other_configs_wrappers_and_capturing_callers_stay_eager(
        rays, monkeypatch):
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    st, scan = _fake()
    assert coreslam.graphable(st, CFG, scan)
    assert coreslam.graphable(st._replace(generator=SimpleNamespace(
        device=torch.device("cuda"))), CFG, scan)
    for cfg in (CFG.overlay({"search_mode": "correlative"}),
                CFG.overlay({"dense_hole_fill": True}),
                CFG.overlay({"dense_obstacle_fill": True})):
        assert not coreslam.graphable(st, cfg, scan)
    assert not coreslam.graphable(st, CFG, (scan[0], SimpleNamespace(
        device=CPU)))
    for count in (torch.zeros((), dtype=torch.int64),
                  torch.zeros(1, dtype=torch.int32)):
        assert not coreslam.graphable(st._replace(scan_count=count), CFG,
                                      scan)
    for other in ("cpu", "cuda:1"):
        assert not coreslam.graphable(st._replace(generator=SimpleNamespace(
            device=torch.device(other))), CFG, scan)
    with monkeypatch.context() as m:
        m.setattr(score, "best_of", lambda *a: score.best_of_plain(*a))
        assert not coreslam.graphable(st, CFG, scan)
        m.setattr(score, "best_of", score.best_of)
        m.setattr(holemap, "update_hole_map",
                  lambda *a: holemap.update_hole_map_plain(*a))
        assert not coreslam.graphable(st, CFG, scan)
    assert coreslam.graphable(st, CFG, scan)
    capturing[0] = True
    assert not coreslam.graphable(st, CFG, scan)
    capturing[0] = False
    a = _init(rays)
    assert not coreslam.graphable(a, CFG, _inputs("update", a, rays, 0))

    def never(body, device, generators=()):
        raise AssertionError("captured")

    monkeypatch.setattr(coreslam, "STEP_GRAPHS",
                        coreslam.StepGraphs(record=never))
    c0 = _counts()
    for t in range(3):
        a, _ = coreslam.update(a, SegmentScan(*_inputs("update", a, rays, t)),
                               CFG)
        a, _ = coreslam.update_cloud(
            a, Scan(*_inputs("update_cloud", a, rays, t)[:3]), a.pose, CFG)
    assert _counts() == c0 and not coreslam.STEP_GRAPHS.graphs


def _captured_launches_replayed(rays, kernels):
    """The counts restored after a stand-in capture and the captured ones
    added on each replay, the searches and candidates too; the process's
    counts are set back afterwards."""
    before = _build.kernel_launches()
    searches = coreslam.update_cloud.searches, coreslam.update_cloud.candidates
    try:
        graphs = coreslam.StepGraphs(record=Recorder(1, kernels))
        st = _init(rays)._replace(scans=WARM)
        ins = _inputs("update", st, rays, WARM)
        for _ in range(2):                  # eager (CPU: counts 0), capture
            graphs.step("update", st, ins, CFG)
        assert _build.kernel_launches() == before
        assert coreslam.update_cloud.searches == searches[0] + 2
        g, = graphs.graphs[CPU].values()
        assert g.launched == tuple((k, 1) for k in kernels)
        for n in range(1, 4):
            graphs.step("update", st, ins, CFG)
            assert _build.kernel_launches() == {
                k: v + n * (k in kernels) for k, v in before.items()}
            assert (coreslam.update_cloud.searches,
                    coreslam.update_cloud.candidates) == (
                searches[0] + 2 + n,
                searches[1] + (2 + n) * CFG.num_candidates)
    finally:
        _build.reset_launches(before)


@pytest.mark.parametrize("kernels", [
    ("K7_hole_walk", "K7_hole_blend", "K7_obstacle", "K8_search"),
    ("K4",)])
def test_a_replay_adds_the_captured_launches_and_a_capture_none(
        rays, kernels):
    _captured_launches_replayed(rays, kernels)


def test_the_counters_and_the_replay_span_under_a_profiler(rays,
                                                           monkeypatch):
    graphs = coreslam.StepGraphs(record=Recorder())
    monkeypatch.setattr(coreslam, "STEP_GRAPHS", graphs)
    monkeypatch.setattr(coreslam, "graphable", lambda *a: True)
    want_st, want = _job(_eager, "update", _init(rays), rays)
    st, c0 = _init(rays), _counts()
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(SCANS):
            st, info = coreslam.update(
                st, SegmentScan(*_inputs("update", st, rays, t)), CFG)
            got.append((st, info))
    _same(got, want)
    assert _counts() == (c0[0] + 2, c0[1] + SCANS - 4)
    spans = sorted((e for e in prof.events()
                    if e.name.startswith("slamnet.coreslam.")),
                   key=lambda e: e.time_range.start)
    steps = [e for e in spans if e.name == "slamnet.coreslam.update"]
    assert len(steps) == SCANS
    held = [[k.name for k in spans if k.cpu_parent is s] for s in steps]
    replayed = {0: False, 1: False, 5: False, 6: False}
    for i, kids in enumerate(held):
        if replayed.get(i, True):
            assert kids == ["slamnet.coreslam.graph_replay"]
        else:
            assert "slamnet.coreslam.graph_replay" not in kids
            assert "slamnet.coreslam.map_update" in kids
    tr = H.Trace("cpu")
    tr.prof, tr.window_s = prof, 1e-3
    pct = H.reader("coreslam_graph_replay_pct")({"summary": tr._read()})
    assert pct == pytest.approx(100.0 * (SCANS - 4) / SCANS)
