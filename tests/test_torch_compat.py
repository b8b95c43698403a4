"""The reference-API processors: slamnet_tpu_torch.compat against
slamnet_tpu.compat, fed the same scans.

* ``HectorSLAMProcessor`` at a small 4-level pyramid (160 px at 0.25 m,
  7/4/4/4): forced updates at the true poses, then tracked ones; the match
  pose within 1e-5 m and the same map-updated flags scan by scan, the
  per-level maps and bitmaps as JAX's (the line updates are integer walks),
  the logger's messages alike, property writes rebuilding the config; and
  each ``Update`` equal bit for bit to one ``hector.update`` call.
* ``CoreSLAMProcessor`` over single-segment scans during the odometry
  warm-up (``PositionSearchBeginning`` raised through its property, so no
  Monte-Carlo draw is compared): poses and maps exact; ``Reset`` restores
  the initial maps.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu import compat as jcompat
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.core.scan import SegmentScan as JSegmentScan
from slamnet_tpu.io.metrics import RingLog
from slamnet_tpu_torch import compat, replay
from slamnet_tpu_torch.core.scan import Scan, SegmentScan
from slamnet_tpu_torch.models import coreslam, hector

ARGS = (0.25, 160, (20.0, 20.0, 0.0), 4, 4)
ITERS = (7, 4, 4, 4)
BOOT, TRACK = 4, 12


@pytest.fixture(scope="module")
def log():
    """Every 8th pose of the loop (0.14 m apart, so the gate fires) and the
    clouds of its scans."""
    lg = replay.make_log(0)
    dl = replay.to_device(lg, "cpu")
    idx = np.arange(0, 8 * (BOOT + TRACK), 8)
    return (lg.traj[idx], dl.points[idx], dl.valid[idx], lg.angles,
            lg.radii[idx], lg.valid[idx])


def test_hector_processor_matches_jax(log):
    traj, pts, val = log[:3]
    jlog, tlog = RingLog(), RingLog()
    jp = jcompat.HectorSLAMProcessor(*ARGS, logger=jlog,
                                     estimate_iterations=ITERS)
    tp = compat.HectorSLAMProcessor(*ARGS, logger=tlog,
                                    estimate_iterations=ITERS, device="cpu")
    assert tp.cfg.level_sizes == (160, 80, 40, 20) and tp.cfg.num_levels == 4
    for t in range(BOOT + TRACK):
        jscan = JScan(jnp.asarray(pts[t].numpy()), jnp.asarray(val[t].numpy()),
                      jnp.zeros(3, jnp.float32))
        scan = Scan(pts[t], val[t], torch.zeros(3))
        if t < BOOT:
            ju = jp.Update(jscan, traj[t], map_without_matching=True)
            tu = tp.Update(scan, traj[t], map_without_matching=True)
        else:
            ju, tu = jp.Update(jscan), tp.Update(scan)
        assert ju == tu, t
        np.testing.assert_allclose(tp.MatchPose, jp.MatchPose, atol=1e-5,
                                   rtol=0)
    assert tp.MatchTiming.ms > 0.0 and tp.UpdateTiming.ms > 0.0
    assert len(tlog.items) == len(jlog.items) > BOOT
    for level, (a, b) in enumerate(zip(tp.MapRep, jp.MapRep)):
        assert a.shape == b.shape == (160 >> level,) * 2
        assert (a != b).mean() <= 1e-3, level
        bmp = tp.GetBitmapData(level)
        assert set(np.unique(bmp)) <= {0, 127, 254}
        assert (bmp != jp.GetBitmapData(level)).mean() <= 1e-3
    tp.SetUpdateFactorFree(0.45)
    tp.SetUpdateFactorOccupied(0.8)
    jp.SetUpdateFactorFree(0.45)
    jp.SetUpdateFactorOccupied(0.8)
    assert tp.cfg.log_odds_free == jp.cfg.log_odds_free
    assert tp.cfg.log_odds_occupied == jp.cfg.log_odds_occupied
    tp.Reset()
    assert not bool(tp.state.maps.any())
    np.testing.assert_array_equal(tp.MatchPose, [20.0, 20.0, 0.0])
    tp.Dispose()
    assert tp.state is None


def test_hector_update_is_one_model_step(log):
    traj, pts, val = log[:3]
    tp = compat.HectorSLAMProcessor(*ARGS, estimate_iterations=ITERS,
                                    device="cpu")
    st = hector.init(tp.cfg, ARGS[2], "cpu")
    for t in range(BOOT + TRACK):
        scan = Scan(pts[t], val[t], torch.zeros(3))
        force = t < BOOT
        hint = torch.from_numpy(traj[t]) if force else st.match_pose
        st, _ = hector.update(st, scan, hint, tp.cfg, force)
        tp.Update(scan, traj[t] if force else None, map_without_matching=force)
        assert torch.equal(tp.state.match_pose, st.match_pose)
    assert torch.equal(tp.state.maps, st.maps)


def test_coreslam_processor_warmup_matches_jax(log):
    traj, _, _, angles, radii, valid = log
    n = 8
    args = (40.0, 64, 16, traj[0], 0.1, 0.1, 32, 2)
    jp = jcompat.CoreSLAMProcessor(*args, seed=3)
    tp = compat.CoreSLAMProcessor(*args, seed=3, device="cpu")
    assert tp.cfg.num_candidates == jp.cfg.num_candidates == 64
    tp.PositionSearchBeginning = n
    jp.PositionSearchBeginning = n
    tp.Quality = 40
    jp.Quality = 40
    assert tp.cfg == type(tp.cfg)(**{f: getattr(jp.cfg, f) for f in
                                     tp.cfg.__dataclass_fields__})
    for t in range(n):
        parts = (angles[None], radii[t][None], valid[t][None], traj[t][None])
        jp.Update(JSegmentScan(*(jnp.asarray(x) for x in parts)))
        tp.Update(SegmentScan(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in parts)))
        np.testing.assert_array_equal(tp.Pose, jp.Pose)
    np.testing.assert_array_equal(tp.HoleMap, jp.HoleMap)
    np.testing.assert_array_equal(tp.ObstacleMap, jp.ObstacleMap)
    assert tp.HoleMap.shape == (64, 64) and tp.HoleMap.dtype == np.uint16
    assert (tp.HoleMap != coreslam.HOLE_INIT).any()
    tp.Reset()
    assert (tp.HoleMap == coreslam.HOLE_INIT).all()
    np.testing.assert_array_equal(tp.Pose, traj[0])


def test_processors_default_to_the_card():
    for cls in (compat.CoreSLAMProcessor, compat.HectorSLAMProcessor):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            compat.HectorSLAMProcessor(*ARGS)
