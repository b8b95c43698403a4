"""``hector.update``'s CUDA graph policy (``models/hector.StepGraphs``) on
the CPU, with a stand-in for the capture: the stand-in records the step's
body and runs it on each replay, so the cache, the key, the static buffers,
the packed results and the launch counts are the real ones.  The CUDA
capture itself runs only on the card (``chip_smoke.py``, phase 37).
"""
from types import SimpleNamespace

import pytest
import torch

from slamnet_tpu_torch import replay
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import hector
from slamnet_tpu_torch.ops import _build
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

SMALL = dict(map_size=64, map_resolution=0.625, num_levels=2,
             estimate_iterations=(3, 2))
BOOT, STEPS = 2, 5


class Recorded:
    """A stand-in for a captured CUDA graph: ``replay`` runs the recorded
    body on the CPU."""

    def __init__(self, body, device):
        self.body, self.device, self.resets = body, device, 0

    def replay(self):
        self.body()

    def reset(self):
        self.resets += 1


class Recorder:
    """``StepGraphs``' ``record``: keeps every stand-in it made, and counts
    ``n`` launches under each of ``kernels`` (``ops/_build``'s keys) as a
    capture's Python does on the card."""

    def __init__(self, n: int = 0, kernels=("K1", "K2")):
        self.made, self.counted = [], tuple((k, n) for k in kernels)

    def __call__(self, body, device):
        _build.add_launches(self.counted)
        self.made.append(Recorded(body, device))
        return self.made[-1]


@pytest.fixture(scope="module")
def scans():
    """BOOT + STEPS scans of the loop, 0.3 m apart, on the CPU."""
    traj = torch.from_numpy(loop_trajectory(0.3)[::16][:BOOT + STEPS])
    angles = torch.from_numpy(revolution_angles(64))
    r, v = scan_revolution(default_field(device="cpu"), traj, angles, 40.0,
                           0.02, torch.Generator().manual_seed(5))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return traj.float(), pts.float(), v


@pytest.fixture(scope="module")
def cfg():
    return replay.pallas_dense_config(**SMALL)


@pytest.fixture(scope="module")
def boot(scans, cfg):
    """The state after BOOT forced scans at the true poses."""
    traj, pts, valid = scans
    st = hector.init(cfg, traj[0], "cpu")
    for t in range(BOOT):
        st, _ = hector.update(st._replace(match_pose=traj[t].clone()),
                              Scan(pts[t], valid[t], torch.zeros(3)),
                              traj[t], cfg, True)
    return st


def _clone(st):
    return hector.HectorState(*(t.clone() for t in st))


def _scan(scans, t, beams=None):
    _, pts, valid = scans
    return Scan(pts[t, :beams], valid[t, :beams], torch.zeros(3))


def _run(step, st, scans, cfg, force=False):
    """STEPS tracked scans through ``step``: (state, [(pose, info)])."""
    out = []
    for t in range(BOOT, BOOT + STEPS):
        st, info = step(st, _scan(scans, t), st.match_pose, cfg, force)
        out.append((st.match_pose, info))
    return st, out


def _counts():
    return (hector.update.graph_captures, hector.update.graph_replays)


def test_first_sight_eager_second_captures_then_replays_bit_for_bit(
        scans, cfg, boot):
    rec = Recorder()
    graphs = hector.StepGraphs(record=rec)
    c0 = _counts()
    want_st, want = _run(hector._update_eager, _clone(boot), scans, cfg)
    seen = []

    def step(*args):
        out = graphs.step(*args)
        seen.append((len(rec.made), _counts()[0] - c0[0],
                     _counts()[1] - c0[1]))
        return out

    got_st, got = _run(step, _clone(boot), scans, cfg)
    assert seen == [(0, 0, 0), (1, 1, 0)] + [
        (1, 1, k) for k in range(1, STEPS - 1)]
    assert torch.equal(got_st.maps, want_st.maps)
    assert torch.equal(got_st.last_update_pose, want_st.last_update_pose)
    for (p, info), (wp, winfo) in zip(got, want):
        assert torch.equal(p, wp)
        for a, b in zip(info, winfo):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("change", ["map", "config", "beams", "force_true",
                                    "force_tensor"])
def test_the_key_holds_the_map_config_beams_and_force_kind(
        scans, cfg, boot, change):
    rec = Recorder()
    graphs = hector.StepGraphs(record=rec)
    st = _clone(boot)
    scan, other, force = _scan(scans, BOOT), _scan(scans, BOOT), False
    other_cfg, other_st = cfg, st
    if change == "map":
        other_st = _clone(st)
    elif change == "config":
        other_cfg = cfg.overlay({"min_distance_diff_for_map_update": 0.5})
    elif change == "beams":
        other = _scan(scans, BOOT, beams=48)
    else:
        force = True if change == "force_true" else torch.tensor(False)
    base = graphs.key(st.maps, scan, cfg, False)
    assert base[:2] == (st.maps.data_ptr(), st.maps.device)
    assert base[2] == cfg and base[3] == tuple(scan.points.shape)
    assert base[-1] is False
    assert graphs.key(other_st.maps, other, other_cfg, force) != base
    for _ in range(2):                      # captured under the base key
        graphs.step(st, scan, st.match_pose, cfg, False)
    c0 = _counts()
    graphs.step(other_st, other, other_st.match_pose, other_cfg, force)
    assert _counts() == c0 and len(rec.made) == 1      # a first sight
    graphs.step(other_st, other, other_st.match_pose, other_cfg, force)
    assert len(rec.made) == 2                          # the second: captured
    graphs.step(st, scan, st.match_pose, cfg, False)
    assert _counts()[1] == c0[1] + 1                   # the base key replays


def test_the_cache_keeps_its_bound_least_recently_used_out(scans, cfg, boot):
    rec = Recorder()
    graphs = hector.StepGraphs(record=rec)
    bound = hector.GRAPHS_PER_DEVICE
    maps = [_clone(boot) for _ in range(bound + 1)]
    scan = _scan(scans, BOOT)

    def capture(st):
        for _ in range(2):
            graphs.step(st, scan, st.match_pose, cfg, False)

    for st in maps[:bound]:
        capture(st)
    graphs.step(maps[0], scan, maps[0].match_pose, cfg, False)  # replayed
    capture(maps[bound])                    # evicts the least recent, [1]
    cache = graphs.graphs[torch.device("cpu")]
    assert len(cache) == bound
    assert [k[0] for k in cache] == [st.maps.data_ptr() for st in
                                     maps[2:bound] + [maps[0], maps[bound]]]
    assert [g.resets for g in rec.made] == [0, 1] + [0] * (bound - 1)


def test_cpu_plain_and_a_capturing_caller_never_capture(
        scans, cfg, boot, monkeypatch):
    card = SimpleNamespace(is_cuda=True)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    assert hector.graphable(card, False)
    assert not hector.graphable(card, True)
    capturing[0] = True
    assert not hector.graphable(card, False)
    assert not hector.graphable(boot.maps, False)

    def never(body, device):
        raise AssertionError("captured")

    monkeypatch.setattr(hector, "STEP_GRAPHS", hector.StepGraphs(record=never))
    c0 = _counts()
    for plain in (False, True):
        _run(lambda *a: hector.update(*a, plain=plain), _clone(boot), scans,
             cfg)
    assert _counts() == c0 and not hector.STEP_GRAPHS.graphs


def test_replayed_results_share_no_storage(scans, cfg, boot):
    graphs = hector.StepGraphs(record=Recorder())
    _, out = _run(graphs.step, _clone(boot), scans, cfg)
    g, = graphs.graphs[torch.device("cpu")].values()
    buffers = {t.untyped_storage().data_ptr() for t in (*g.inputs, g.packed)}
    firsts = []
    for pose, info in out[2:]:              # the replayed steps
        ptrs = {t.untyped_storage().data_ptr() for t in (pose, *info)}
        assert len(ptrs) == 1               # one clone a step
        assert not ptrs & buffers
        firsts.append(ptrs.pop())
    assert len(set(firsts)) == len(firsts)


def _captured_launches_replayed(scans, cfg, boot, kernels):
    """The counts restored after a stand-in capture and the captured ones
    added on each replay; the process's counts are set back afterwards."""
    before = _build.kernel_launches()
    try:
        graphs = hector.StepGraphs(record=Recorder(1, kernels))
        st, scan = _clone(boot), _scan(scans, BOOT)
        for _ in range(2):                  # eager (CPU: counts 0), capture
            graphs.step(st, scan, st.match_pose, cfg, False)
        assert _build.kernel_launches() == before
        g, = graphs.graphs[torch.device("cpu")].values()
        assert g.launched == tuple((k, 1) for k in kernels)
        for n in range(1, 4):
            graphs.step(st, scan, st.match_pose, cfg, False)
            assert _build.kernel_launches() == {
                k: v + n * (k in kernels) for k, v in before.items()}
    finally:
        _build.reset_launches(before)


def test_a_replay_adds_the_captured_launches_and_a_capture_none(
        scans, cfg, boot):
    _captured_launches_replayed(scans, cfg, boot, ("K1", "K2"))


def test_a_capture_of_any_kernel_is_restored_and_replayed(scans, cfg, boot):
    # a key no list of the step's kernels names: K7's obstacle launch
    _captured_launches_replayed(scans, cfg, boot, ("K7_obstacle",))
