"""The program's spans (``io/metrics.span``) in ``hector.update``, and the
benchmark's readers of them.

Three ``pallas_dense`` steps run on CPU tensors under ``torch.profiler``
(the kernels' plain versions): each step is one ``slamnet.hector.update``
span holding its ``match``, ``guards`` and ``map_update`` spans in order,
no span is a user annotation (a user annotation is mirrored onto the card's
timeline, where a reader of the device trace would count it), and the steps
give the same bits as without a profiler.  ``step_host_us`` and
``guards_host_us`` read the spans' median from a summary made by the
harness's own ``Trace._read``.
"""
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slambench import harness as H
from slamnet_tpu_torch import replay
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.io import metrics
from slamnet_tpu_torch.models import hector
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

SMALL = dict(map_size=64, map_resolution=0.625, num_levels=2,
             estimate_iterations=(3, 2))
BOOT, STEPS = 2, 3
PHASES = ("slamnet.hector.match", "slamnet.hector.guards",
          "slamnet.hector.map_update")
# pallas_dense as the benchmark runs it (guards off), and with both guards on
CONFIGS = {"pallas_dense": {},
           "guarded": dict(min_match_in_map_frac=0.5, max_match_jump=1.0)}


@pytest.fixture(scope="module")
def scans():
    """BOOT + STEPS scans of the loop, 0.3 m apart, 64 beams, on the CPU."""
    traj = torch.from_numpy(loop_trajectory(0.3)[::16][:BOOT + STEPS])
    angles = torch.from_numpy(revolution_angles(64))
    r, v = scan_revolution(default_field(device="cpu"), traj, angles, 40.0,
                           0.02, torch.Generator().manual_seed(5))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return traj.float(), pts.float(), v


def _boot(scans):
    """The state after BOOT forced scans at the true poses."""
    traj, pts, valid = scans
    cfg = replay.fixed_config(**SMALL)
    st = hector.init(cfg, traj[0], "cpu")
    zero = torch.zeros(3)
    for t in range(BOOT):
        st, _ = hector.update(st._replace(match_pose=traj[t].clone()),
                              Scan(pts[t], valid[t], zero), traj[t], cfg,
                              True)
    return st


def _steps(st, scans, cfg):
    """STEPS tracked scans from a copy of ``st``: (poses, map_updated,
    maps)."""
    _, pts, valid = scans
    st = hector.HectorState(*(t.clone() for t in st))
    zero = torch.zeros(3)
    poses, fired = [], []
    for t in range(BOOT, BOOT + STEPS):
        st, info = hector.update(st, Scan(pts[t], valid[t], zero),
                                 st.match_pose, cfg)
        poses.append(st.match_pose)
        fired.append(info.map_updated)
    return torch.stack(poses), torch.stack(fired), st.maps


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def traced(request, scans):
    """The steps with no profiler, then under one (CPU activity): (plain
    outputs, traced outputs, the profiler, the config's name)."""
    cfg = replay.pallas_dense_config(**SMALL, **CONFIGS[request.param])
    boot = _boot(scans)
    plain = _steps(boot, scans, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _steps(boot, scans, cfg)
    return plain, out, prof, request.param


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("slamnet.")]


def test_each_step_is_one_span_holding_its_three_phases_in_order(traced):
    _, _, prof, _ = traced
    spans = _spans(prof)
    steps = [e for e in spans if e.name == "slamnet.hector.update"]
    assert len(steps) == STEPS
    assert len({e.thread for e in spans}) == 1
    for step in steps:
        kids = sorted((e for e in spans if e.cpu_parent is step),
                      key=lambda e: e.time_range.start)
        assert tuple(e.name for e in kids) == PHASES
        for a, b in zip(kids, kids[1:]):
            assert a.time_range.end <= b.time_range.start
        assert step.time_range.start <= kids[0].time_range.start
        assert kids[-1].time_range.end <= step.time_range.end
    assert len(spans) == 4 * STEPS


def test_no_span_is_a_user_annotation_or_a_kernels_name(traced):
    _, _, prof, _ = traced
    spans = _spans(prof)
    assert spans and not any(e.is_user_annotation for e in spans)
    kernels = ("match_kernel", "fill_kernel", "line_kernel",
               "exit_finish_kernel", "nccl")
    assert not any(k in e.name for e in spans for k in kernels)


def test_the_steps_are_the_same_bits_under_the_profiler(traced):
    plain, out, _, _ = traced
    for a, b in zip(plain, out):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_with_no_profiler_a_span_is_the_shared_no_op():
    assert metrics.span("hector.update") is metrics.NO_SPAN
    with metrics.span("hector.match") as s:
        assert s is metrics.NO_SPAN


def test_a_torch_without_the_primitive_records_no_span(monkeypatch):
    monkeypatch.setattr(metrics, "_RecordFunctionFast", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.span("hector.update") is metrics.NO_SPAN
        torch.zeros(2).add_(1.0)
    assert not _spans(prof)


def _summary(prof) -> dict:
    """The stretch's summary as the harness makes it from its profiler."""
    tr = H.Trace("cpu")
    tr.prof, tr.window_s = prof, 1e-3
    return tr._read()


@pytest.mark.parametrize("metric,span", [
    ("step_host_us", "slamnet.hector.update"),
    ("step_host_us.live", "slamnet.hector.update"),
    ("guards_host_us", "slamnet.hector.guards")])
def test_readers_take_the_spans_median(traced, metric, span):
    _, _, prof, _ = traced
    d = [e.time_range.end - e.time_range.start for e in _spans(prof)
         if e.name == span]
    assert len(d) == STEPS
    got = H.reader(metric)({"summary": _summary(prof)})
    assert got == pytest.approx(statistics.median(d), rel=1e-9) and got > 0


@pytest.mark.parametrize("metric", ["step_host_us", "step_host_us.live",
                                    "guards_host_us"])
def test_readers_return_none_without_a_span(metric):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(2).add_(1.0)
    summary = _summary(prof)
    assert summary["host_ops"]
    assert H.reader(metric)({"summary": summary}) is None
