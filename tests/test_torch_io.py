"""Host-side I/O of slamnet_tpu_torch against the JAX package's: export,
metrics, live, viz, core.debug and checkpoints.

* ``io.export`` and ``io.live``'s PNG and HTML: the JAX package's bytes for
  the same maps, given as numpy arrays or tensors.
* ``io.metrics``: ``EmaTimer``, ``RingLog``, ``DivergenceMonitor`` step for
  step as JAX's; ``device_trace`` writes a Chrome trace of the ops run.
* ``core.debug``: ``all_finite`` / ``checked`` on finite and NaN states.
* ``io.checkpoint``: a JAX-written ``HectorState`` restores in the port and
  steps to JAX's next pose (within 1e-5); the port's Hector checkpoint
  restores in JAX; a JAX CoreSLAM checkpoint restores through ``convert``;
  the port's save -> restore -> resume repeats the uninterrupted replay bit
  for bit, the Monte-Carlo generator's state included.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import CoreSlamConfig as JCoreSlamConfig
from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.io import checkpoint as jckpt
from slamnet_tpu.io import export as jexport
from slamnet_tpu.io import live as jlive
from slamnet_tpu.io import metrics as jmetrics
from slamnet_tpu.models import coreslam as jcs
from slamnet_tpu.models import hector as jhector
from slamnet_tpu_torch import replay
from slamnet_tpu_torch.core import debug
from slamnet_tpu_torch.core.config import HectorConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.io import checkpoint, export, live, metrics, viz
from slamnet_tpu_torch.models import coreslam, hector

SMALL = dict(map_size=160, map_resolution=0.25, num_levels=4,
             estimate_iterations=(7, 4, 4, 4))


@pytest.fixture(scope="module")
def log():
    lg = replay.make_log(0)
    return lg, replay.to_device(lg, "cpu")


def test_export_equals_jax():
    rng = np.random.default_rng(0)
    hole = rng.integers(0, 65536, 64 * 64).astype(np.int32)
    lo = rng.normal(0, 2, 50 * 50).astype(np.float32)
    lo[::7] = 0.0
    obst = rng.integers(-1, 12, (16, 16)).astype(np.int8)
    pose = np.float32([1.25, -3.5, 0.75])
    for x in (hole, torch.from_numpy(hole)):
        np.testing.assert_array_equal(export.packed_hole_pixels(x),
                                      jexport.packed_hole_pixels(hole))
        np.testing.assert_array_equal(export.hole_map_u16(x, 64),
                                      jexport.hole_map_u16(hole, 64))
    packed = jexport.packed_hole_pixels(hole)
    np.testing.assert_array_equal(export.unpack_hole_pixels(packed),
                                  jexport.unpack_hole_pixels(packed))
    np.testing.assert_array_equal(
        export.occupancy_bitmap(torch.from_numpy(lo), 50),
        jexport.occupancy_bitmap(lo, 50))
    np.testing.assert_array_equal(export.obstacle_bitmap(torch.from_numpy(obst)),
                                  jexport.obstacle_bitmap(obst))
    assert export.pose_to_bytes(torch.from_numpy(pose)) == \
        jexport.pose_to_bytes(pose)
    raw = jexport.pose_to_bytes(pose)
    np.testing.assert_array_equal(export.pose_from_bytes(raw), pose)
    assert export.vec2_to_bytes(pose[:2]) == jexport.vec2_to_bytes(pose[:2])
    np.testing.assert_array_equal(
        export.vec2_from_bytes(jexport.vec2_to_bytes(pose[:2])), pose[:2])
    assert export.pose_string(torch.from_numpy(pose)) == \
        jexport.pose_string(pose)


def test_live_png_and_html_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (13, 21)).astype(np.uint8)
    assert live._png_bytes(gray) == jlive._png_bytes(gray)
    cfg = HectorConfig(**SMALL)
    jcfg = JHectorConfig(**SMALL)
    ours, theirs = live.ReplayRecorder(cfg, 2), jlive.ReplayRecorder(jcfg, 2)
    for i in range(5):
        maps = rng.normal(0, 1, cfg.total_cells).astype(np.float32)
        pose = rng.normal(20, 1, 3).astype(np.float32)
        ours.add(i, torch.from_numpy(maps), torch.from_numpy(pose), pose)
        theirs.add(i, maps, pose, pose)
    assert ours.frames == theirs.frames and len(ours.frames) == 3
    ours.write(str(tmp_path / "a.html"), title="t")
    theirs.write(str(tmp_path / "b.html"), title="t")
    assert (tmp_path / "a.html").read_text() == (tmp_path / "b.html").read_text()


def test_viz_render_frame(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "f.png")
    viz.render_frame(path, hole_map=torch.full((64 * 64,), 32750),
                     hole_size=64, logodds=torch.zeros(50 * 50), occ_size=50,
                     real_pose=torch.tensor([20.0, 20.0, 0.3]),
                     estimates={"hector": (np.float32([20.1, 20, 0.3]), "g")},
                     trajectory=torch.zeros(5, 3), title="t")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_metrics_equal_jax(tmp_path):
    a, b = metrics.EmaTimer(), jmetrics.EmaTimer()
    for dt in (0.01, 0.5, 0.002, 0.3):
        assert a.update(dt) == b.update(dt)
    with a.time():
        pass
    assert a.ms > 0.0
    ra, rb = metrics.RingLog(high_water=5, drop=3), jmetrics.RingLog(5, 3)
    for i in range(12):
        ra.log(f"m{i}", level="Debug" if i % 2 else "Information")
        rb.log(f"m{i}", level="Debug" if i % 2 else "Information")
    assert ra.items == rb.items and ra.tail(4) == rb.tail(4)
    da = metrics.DivergenceMonitor(log=ra)
    db = jmetrics.DivergenceMonitor(log=rb)
    truth = np.float32([20.0, 20.0, 0.0])
    for i, est in enumerate(([20.1, 20.0, 0.05], [20.5, 20.6, 0.1],
                             [21.2, 20.0, 0.0], [23.0, 20.0, 0.0])):
        e = torch.tensor(est)
        assert da.check(i, e, truth) == db.check(i, np.float32(est), truth)
    assert da.diverged_at == db.diverged_at == 2 and da.report == db.report
    m = metrics.ScanMetrics(3, (1.0, 2.0, 0.0), match_ms=1.5)
    assert m.map_updated is False and m.scan_index == 3
    with metrics.device_trace(str(tmp_path / "tr")) as tr:
        torch.ones(8).cumsum(0)
    with open(tr.path) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])


def test_debug_all_finite_and_checked():
    st = hector.init(HectorConfig(**SMALL), (20.0, 20.0, 0.0), "cpu")
    ok = debug.all_finite(st)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    bad = st._replace(match_pose=torch.tensor([float("nan"), 0.0, 0.0]))
    assert not bool(debug.all_finite(bad))
    assert bool(debug.all_finite({"n": torch.arange(3)}))   # no float leaf
    cs = coreslam.init(replay.coreslam_parity_config(hole_map_size=32,
                                                     obstacle_map_size=8),
                       (1.0, 1.0, 0.0), device="cpu")
    assert bool(debug.all_finite(cs))                       # generator leaf

    def step(x):
        return {"pose": x * 2.0, "n": torch.arange(2)}
    f = debug.checked(step)
    assert torch.equal(f(torch.ones(3))["pose"], torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match="pose"):
        f(torch.tensor([1.0, float("inf")]))
    with pytest.raises(FloatingPointError, match="match_pose"):
        debug.checked(lambda: bad)()


def test_jax_hector_checkpoint_restores_and_steps(log, tmp_path):
    lg, dl = log
    jcfg, cfg = JHectorConfig(**SMALL), HectorConfig(**SMALL)
    pts, val = dl.points.numpy(), dl.valid.numpy()
    js = jhector.init(jcfg, lg.traj[0])
    step = jax.jit(lambda st, p, v, h, force: jhector.update(
        st, JScan(p, v, jnp.zeros(3, jnp.float32)), h, jcfg,
        map_without_matching=force))
    for t in range(4):
        js, _ = step(js, pts[t], val[t], lg.traj[t], jnp.asarray(True))
    jckpt.save(str(tmp_path / "jax"), js, {"scan": 4})
    like = hector.init(cfg, (0.0, 0.0, 0.0), "cpu")
    ts = checkpoint.restore(str(tmp_path / "jax"), like)
    assert checkpoint.load_metadata(str(tmp_path / "jax"))["scan"] == 4
    np.testing.assert_array_equal(ts.maps.numpy(), np.asarray(js.maps))
    js2, _ = step(js, pts[4], val[4], js.match_pose, jnp.asarray(False))
    ts2, _ = hector.update(ts, Scan(dl.points[4], dl.valid[4], torch.zeros(3)),
                           ts.match_pose, cfg)
    np.testing.assert_allclose(ts2.match_pose.numpy(),
                               np.asarray(js2.match_pose), atol=1e-5, rtol=0)
    # the port's checkpoint restores in JAX: the same layout
    checkpoint.save(str(tmp_path / "port"), ts2, {"scan": 5})
    back = jckpt.restore(str(tmp_path / "port"), js2)
    np.testing.assert_array_equal(np.asarray(back.maps), ts2.maps.numpy())
    np.testing.assert_array_equal(np.asarray(back.match_pose),
                                  ts2.match_pose.numpy())
    with np.load(str(tmp_path / "port" / "state.npz")) as z:
        assert all(z[k].dtype != object for k in z.files)


def test_jax_coreslam_checkpoint_restores_through_convert(tmp_path):
    jcfg = JCoreSlamConfig(hole_map_size=32, obstacle_map_size=8)
    js = jcs.init(jcfg, np.float32([3.0, 4.0, 0.5]), key=jax.random.PRNGKey(3))
    js = js._replace(hole_map=js.hole_map.at[5].set(7),
                     scan_count=jnp.asarray(2, jnp.int32))
    jckpt.save(str(tmp_path / "c"), js)
    cfg = replay.coreslam_parity_config(hole_map_size=32, obstacle_map_size=8)
    like = coreslam.init(cfg, (0.0, 0.0, 0.0), device="cpu")
    ts = checkpoint.restore(str(tmp_path / "c"), like, seed=9)
    np.testing.assert_array_equal(ts.hole_map.numpy(), np.asarray(js.hole_map))
    np.testing.assert_array_equal(ts.pose.numpy(), np.asarray(js.pose))
    assert ts.scans == 2 and int(ts.scan_count) == 2
    assert torch.equal(ts.generator.get_state(),
                       torch.Generator().manual_seed(9).get_state())


def test_save_restore_resume_bit_for_bit(log, tmp_path):
    """CoreSLAM's Monte-Carlo parity mode draws from the state's generator:
    a replay saved at scan 8 and resumed in a fresh state gives the
    uninterrupted replay's poses and maps bit for bit."""
    lg, dl = log
    cfg = replay.coreslam_parity_config(num_candidates=256)
    zero = torch.zeros(3)

    def run(st, lo, hi):
        poses = []
        for t in range(lo, hi):
            st, _ = coreslam.update_cloud(
                st, Scan(dl.points[t], dl.valid[t], zero), st.pose, cfg)
            poses.append(st.pose)
        return st, torch.stack(poses)

    st0 = coreslam.init(cfg, lg.traj[0], seed=4, device="cpu")
    full, pfull = run(st0, 0, 14)
    mid, _ = run(coreslam.init(cfg, lg.traj[0], seed=4, device="cpu"), 0, 8)
    checkpoint.save(str(tmp_path / "mid"), mid, {"scan": 8})
    meta = checkpoint.load_metadata(str(tmp_path / "mid"))
    assert meta["format"] == checkpoint.FORMAT and meta["generators"] == ["cpu"]
    like = coreslam.init(cfg, (0.0, 0.0, 0.0), seed=99, device="cpu")
    back = checkpoint.restore(str(tmp_path / "mid"), like)
    assert back.scans == mid.scans and back.generator is not mid.generator
    end, pres = run(back, 8, 14)
    assert torch.equal(pres, pfull[8:])
    assert torch.equal(end.hole_map, full.hole_map)
    assert torch.equal(end.obstacle_map, full.obstacle_map)
    # a Hector state: maps, poses and the gate's last pose
    hcfg = HectorConfig(**SMALL)
    hs = hector.init(hcfg, lg.traj[0], "cpu")
    for t in range(3):
        hs, _ = hector.update(hs, Scan(dl.points[t], dl.valid[t], zero),
                              dl.traj[t], hcfg, True)
    checkpoint.save(str(tmp_path / "h"), hs)
    hb = checkpoint.restore(str(tmp_path / "h"), hector.init(
        hcfg, (0.0, 0.0, 0.0), "cpu"))
    for a, b in zip(hb, hs):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert sorted(os.listdir(tmp_path / "h")) == ["meta.json", "state.npz"]
