"""Graph-SLAM: slamnet_tpu_torch's frontend and model against the JAX
package's, on the same scans (the port's simulator, numpy in between).

* ``rasterize_scan``: the line grid (K4's plain version) cell for cell; the
  dense grid (K2's) with at most 0.1% of cells differing (as K2's own tests).
* ``match_scans``: ``"gather"`` (K3's plain version) against JAX's loop of 20
  fused GN iterations, and ``"pallas"`` (K1's) against JAX's Pallas frontend
  in interpret mode: the same 11 sums in another order, so ``rel`` agrees to
  1e-4 m / 1e-4 rad and ``inlier_frac`` to one beam in 400.
* ``graph_slam.update`` over ``tests/test_graph_slam.py``'s out-and-back log
  (12 still scans, 3 m out and back; 72 scans, 64 keyframe slots) on a
  2-level 200-px pyramid at 0.2 m: the same keyframes and closures as JAX,
  keyframe poses within 1e-3 m.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core import PoseGraphConfig as JPoseGraphConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.graph import frontend as jfront
from slamnet_tpu.models import graph_slam as jgs
from slamnet_tpu.ops import bilinear as jbil
from slamnet_tpu.sim import trajectory as jtraj
from slamnet_tpu_torch import convert
from slamnet_tpu_torch.core.config import HectorConfig, PoseGraphConfig
from slamnet_tpu_torch.core.geometry import pose_between
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.graph import frontend
from slamnet_tpu_torch.models import graph_slam
from slamnet_tpu_torch.ops import bilinear
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import rect_revisit_trajectory

HCFG = dict(map_size=200, map_resolution=0.2, num_levels=2,
            estimate_iterations=(7, 4))
GCFG = dict(max_keyframes=64, max_edges=256, keyframe_dist=0.8,
            keyframe_angle=0.6, loop_closure_radius=1.5)
FORCED = 10


@pytest.fixture(scope="module")
def log():
    """tests/test_graph_slam.py:252-263's out-and-back trajectory and its
    400-beam scans, as numpy."""
    fwd = np.stack([np.linspace(20, 23.5, 30), np.full(30, 20.0),
                    np.zeros(30)], -1).astype(np.float32)
    still = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (12, 1))
    traj = np.concatenate([still, fwd, fwd[::-1].copy()])
    angles = torch.from_numpy(revolution_angles(400))
    r, v = scan_revolution(default_field(), torch.from_numpy(traj), angles,
                           40.0, 0.02, torch.Generator().manual_seed(11))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return traj, pts.numpy(), v.numpy()


def _scans(log, t):
    _, pts, v = log
    return (JScan(jnp.asarray(pts[t]), jnp.asarray(v[t]),
                  jnp.zeros(3, jnp.float32)),
            Scan.from_points(pts[t], v[t]))


def test_rasterize_line_grid_is_jax_cell_for_cell(log):
    js, ts = _scans(log, 20)
    want = np.asarray(jfront.rasterize_scan(js, jfront.ScanMatchConfig()))
    got = frontend.rasterize_scan(ts, frontend.ScanMatchConfig()).numpy()
    assert got.shape == (128 * 128,)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 100 and (got < 0).sum() > 1000


def test_rasterize_dense_grid_matches_jax(log):
    js, ts = _scans(log, 20)
    want = np.asarray(jfront.rasterize_scan(
        js, jfront.ScanMatchConfig(dense_fill=True)))
    got = frontend.rasterize_scan(
        ts, frontend.ScanMatchConfig(dense_fill=True)).numpy()
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    np.testing.assert_array_equal(got > 0, want > 0)     # the same walls
    # the plain path of the wrapper is the plain version
    plain = frontend.rasterize_scan(
        ts, frontend.ScanMatchConfig(dense_fill=True), plain=True)
    np.testing.assert_array_equal(plain.numpy(), got)


def test_grid_config_is_the_frontend_grid():
    hcfg = frontend.grid_config(frontend.ScanMatchConfig(matcher_mode="pallas",
                                                        dense_fill=True))
    assert (hcfg.level_sizes, hcfg.level_resolutions) == ((128,), (0.25,))
    assert hcfg.estimate_iterations == (20,) and hcfg.matcher_mode == "pallas"
    assert hcfg.dense_free_fill and hcfg.dense_free_margin_px == 0.5
    mcfg = frontend.ScanMatchConfig()
    for got, want in ((hcfg.log_odds_free, mcfg.log_odds_free),
                      (hcfg.log_odds_occupied, mcfg.log_odds_occupied)):
        assert np.float32(got) == np.float32(want)


MATCH_CASES = [(20, 24, (0.05, -0.04, 0.02)), (30, 26, (-0.08, 0.05, -0.03)),
               (45, 60, (0.1, 0.06, 0.04))]


def _match_case(log, ref, qry, off):
    traj = log[0]
    init = pose_between(torch.from_numpy(traj[ref]),
                        torch.from_numpy(traj[qry])) + torch.tensor(off)
    return _scans(log, ref), _scans(log, qry), init


@pytest.mark.parametrize("mode", ["gather", "pallas"])
@pytest.mark.parametrize("case", range(len(MATCH_CASES)))
def test_match_scans_matches_jax(log, mode, case):
    (jr, tr), (jq, tq), init = _match_case(log, *MATCH_CASES[case])
    jcfg = jfront.ScanMatchConfig(matcher_mode=mode)
    rel_j, q_j = jfront.match_scans(jr, jq, jnp.asarray(init.numpy()), jcfg)
    rel_t, q_t = frontend.match_scans(tr, tq, init,
                                      frontend.ScanMatchConfig(matcher_mode=mode))
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), atol=1e-4)
    assert abs(float(q_t.inlier_frac) - float(q_j.inlier_frac)) <= 1 / 400
    np.testing.assert_allclose(float(q_t.residual), float(q_j.residual),
                               atol=1e-3)
    assert float(q_t.inlier_frac) > 0.4         # a real match, accepted


@pytest.mark.parametrize("mode", ["gather", "pallas"])
def test_match_scans_empty_query_returns_init(log, mode):
    # no valid query beam: JAX's gather loop solves a zero H 20 times and
    # never steps, its pallas kernel returns the hint; the port's kernels
    # return the hint: both give init_rel (its heading wrapped), no inliers
    (jr, tr), _, _ = _match_case(log, *MATCH_CASES[0])
    pts = np.asarray(tr.points)
    none = np.zeros(len(pts), bool)
    init = torch.tensor([0.3, -0.2, 3.5])
    jcfg = jfront.ScanMatchConfig(matcher_mode=mode)
    rel_j, q_j = jfront.match_scans(
        jr, JScan(jnp.asarray(pts), jnp.asarray(none),
                  jnp.zeros(3, jnp.float32)), jnp.asarray(init.numpy()), jcfg)
    rel_t, q_t = frontend.match_scans(
        tr, Scan.from_points(pts, none), init,
        frontend.ScanMatchConfig(matcher_mode=mode))
    np.testing.assert_array_equal(rel_t.numpy(), np.asarray(rel_j))
    np.testing.assert_allclose(rel_t.numpy(),
                               [0.3, -0.2, 3.5 - 2 * np.pi], atol=1e-5)
    assert float(q_t.inlier_frac) == float(q_j.inlier_frac) == 0.0


def test_keyframe_due_and_loop_candidates_match_jax():
    rng = np.random.default_rng(8)
    last = np.asarray([20.0, 20.0, 3.0], np.float32)
    for _ in range(40):
        pose = (last + rng.uniform([-1, -1, -0.8], [1, 1, 0.8])).astype(
            np.float32)
        want = bool(jfront.keyframe_due(jnp.asarray(last), jnp.asarray(pose),
                                        0.5, 0.35))
        got = frontend.keyframe_due(torch.from_numpy(last),
                                    torch.from_numpy(pose), 0.5, 0.35)
        assert got.dtype == torch.bool and bool(got) == want
    poses = rng.uniform([18, 18, -3], [22, 22, 3], (64, 3)).astype(np.float32)
    valid = np.arange(64) < 50
    for cur in (3, 20, 49):
        want = np.asarray(jfront.loop_candidates(
            jnp.asarray(poses), jnp.asarray(valid), cur, 2.0, 5))
        got = frontend.loop_candidates(torch.from_numpy(poses),
                                       torch.from_numpy(valid), cur, 2.0, 5)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want[cur - 5:].any()


def test_bilinear_matches_jax(log):
    js, ts = _scans(log, 20)
    grid = np.array(jfront.rasterize_scan(js, jfront.ScanMatchConfig()))
    rng = np.random.default_rng(9)
    coords = rng.uniform(-3.0, 130.0, (2000, 2)).astype(np.float32)
    coords[:4] = [[np.nan, 5.0], [5.0, np.inf], [126.0, 126.0], [0.0, 0.0]]
    valid = rng.random(2000) < 0.9
    want = jbil.interp_value_and_gradients(jnp.asarray(grid), 128,
                                           jnp.asarray(coords),
                                           jnp.asarray(valid))
    got = bilinear.interp_value_and_gradients(
        torch.from_numpy(grid), 128, torch.from_numpy(coords),
        torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert got[0][:2].eq(0).all() and (got[0] > 0.6).sum() > 10


def test_rect_revisit_trajectory_is_jax():
    np.testing.assert_array_equal(rect_revisit_trajectory(num_loops=2),
                                  jtraj.rect_revisit_trajectory(num_loops=2))


@pytest.fixture(scope="module")
def jax_graph(log):
    """JAX's graph-SLAM over the log (tests/test_graph_slam.py's flow: the
    first 10 scans forced); its keyframe and loop flags a scan."""
    traj, pts, v = log
    hcfg, gcfg = JHectorConfig(**HCFG), JPoseGraphConfig(**GCFG)
    step = jax.jit(functools.partial(jgs.update, hcfg=hcfg, gcfg=gcfg))
    state = jgs.init(hcfg, gcfg, traj[0], pts.shape[1])
    kf, loop = [], []
    for t in range(len(traj)):
        state, info = step(state, JScan(jnp.asarray(pts[t]),
                                        jnp.asarray(v[t]),
                                        jnp.zeros(3, jnp.float32)),
                           map_without_matching=jnp.asarray(t < FORCED))
        kf.append(bool(info.keyframe_added))
        loop.append(bool(info.loop_closed))
    return state, np.asarray(kf), np.asarray(loop)


@pytest.fixture(scope="module")
def port_graph(log):
    traj, pts, v = log
    hcfg, gcfg = HectorConfig(**HCFG), PoseGraphConfig(**GCFG)
    state = graph_slam.init(hcfg, gcfg, traj[0], pts.shape[1], device="cpu")
    kf, loop = [], []
    syncs, searches = graph_slam.update.syncs, graph_slam.update.searches
    for t in range(len(traj)):
        state, info = graph_slam.update(state, Scan.from_points(pts[t], v[t]),
                                        hcfg, gcfg,
                                        map_without_matching=t < FORCED)
        kf.append(bool(info.keyframe_added))
        loop.append(bool(info.loop_closed))
    # a read a scan (due), one more a keyframe event (has_cand) and one more
    # a loop search (looped)
    searches = graph_slam.update.searches - searches
    assert sum(loop) <= searches <= sum(kf)
    assert graph_slam.update.syncs - syncs == len(traj) + sum(kf) + searches
    return state, np.asarray(kf), np.asarray(loop)


def test_graph_slam_update_matches_jax(jax_graph, port_graph):
    jst, jkf, jloop = jax_graph
    tst, tkf, tloop = port_graph
    nkf = int(jst.graph.num_nodes)
    assert int(tst.graph.num_nodes) == tst.nodes == nkf >= 6
    np.testing.assert_array_equal(tkf, jkf)
    assert int(tst.loop_count) == int(jst.loop_count) >= 1
    np.testing.assert_array_equal(tloop, jloop)
    np.testing.assert_allclose(tst.graph.poses[:nkf, :2].numpy(),
                               np.asarray(jst.graph.poses[:nkf, :2]),
                               atol=1e-3)
    assert int(tst.graph.num_edges) == int(jst.graph.num_edges)
    np.testing.assert_array_equal(tst.graph.edge_j.numpy(),
                                  np.asarray(jst.graph.edge_j))
    np.testing.assert_allclose(tst.hector.match_pose.numpy(),
                               np.asarray(jst.hector.match_pose), atol=1e-3)


def test_rebuild_maps_matches_jax(log, jax_graph, port_graph):
    # from the JAX state carried across: K4's plain version replays the
    # keyframe slots as JAX's line update does (a 1-ulp cos/sin difference
    # may move a beam's rounded endpoint: at most 1e-3 of the cells)
    jst = jax_graph[0]
    hcfg = HectorConfig(**HCFG)
    want = np.asarray(jgs.rebuild_maps(jst, JHectorConfig(**HCFG)))
    st = convert.graph_state_from_numpy(_jax_arrays(jst), device="cpu")
    got = graph_slam.rebuild_maps(st, hcfg).numpy()
    assert (got != want).mean() <= 1e-3
    l0 = got[:hcfg.map_size ** 2]
    assert (l0 > 0).sum() > 300 and (l0 < 0).sum() > 5000
    # the port's own state rebuilds as cleanly
    own = graph_slam.rebuild_maps(port_graph[0], hcfg).numpy()
    assert (own != want).mean() <= 1e-2


def _jax_arrays(jst) -> dict:
    return {"hector": {k: np.asarray(getattr(jst.hector, k))
                       for k in convert.FIELDS},
            "graph": {k: np.asarray(getattr(jst.graph, k))
                      for k in convert.GRAPH_FIELDS},
            **{k: np.asarray(getattr(jst, k)) for k in
               ("kf_points", "kf_valid", "last_kf_pose", "loop_count")}}


def test_graph_convert_round_trip(log, jax_graph):
    # JAX's state into the port and back, unchanged; one more scan from it
    # in both packages keeps the keyframe count and the pose
    traj, pts, v = log
    jst = jax_graph[0]
    arrays = _jax_arrays(jst)
    st = convert.graph_state_from_numpy(arrays, device="cpu")
    assert st.nodes == int(jst.graph.num_nodes)
    assert st.graph.edge_i.dtype == torch.int32
    back = convert.graph_state_to_numpy(st)
    for k in ("kf_points", "kf_valid", "last_kf_pose", "loop_count"):
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    for k in convert.GRAPH_FIELDS:
        np.testing.assert_array_equal(back["graph"][k], arrays["graph"][k],
                                      err_msg=k)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back["hector"][k], arrays["hector"][k])
    rebuilt = jgs.GraphSlamState(
        hector=jst.hector._replace(**{k: jnp.asarray(a) for k, a in
                                      back["hector"].items()}),
        graph=jst.graph._replace(**{k: jnp.asarray(a) for k, a in
                                    back["graph"].items()}),
        **{k: jnp.asarray(back[k]) for k in
           ("kf_points", "kf_valid", "last_kf_pose", "loop_count")})
    hcfg, gcfg = JHectorConfig(**HCFG), JPoseGraphConfig(**GCFG)
    t = len(traj) - 1
    jst2, _ = jgs.update(rebuilt, JScan(jnp.asarray(pts[t]), jnp.asarray(v[t]),
                                        jnp.zeros(3, jnp.float32)), hcfg, gcfg)
    st2, _ = graph_slam.update(st, Scan.from_points(pts[t], v[t]),
                               HectorConfig(**HCFG), PoseGraphConfig(**GCFG))
    assert st2.nodes == int(jst2.graph.num_nodes)
    np.testing.assert_allclose(st2.hector.match_pose.numpy(),
                               np.asarray(jst2.hector.match_pose), atol=1e-3)
    with pytest.raises(ValueError, match="lack"):
        convert.graph_state_from_numpy({"hector": arrays["hector"]},
                                       device="cpu")


def test_keyframe_event_launch_plan(log):
    # on the CPU no kernel launches; a keyframe event with no old keyframe
    # near reads due and has_cand, and runs no frontend match
    traj, pts, v = log
    hcfg, gcfg = HectorConfig(**HCFG), PoseGraphConfig(**GCFG)
    st = graph_slam.init(hcfg, gcfg, traj[0], pts.shape[1], device="cpu")
    assert st.nodes == 1 and int(st.graph.num_nodes) == 1
    moved = Scan.from_points(pts[20], v[20])
    st = st._replace(last_kf_pose=torch.tensor([10.0, 10.0, 0.0]))
    syncs, searches = graph_slam.update.syncs, graph_slam.update.searches
    st2, info = graph_slam.update(st, moved, hcfg, gcfg,
                                  map_without_matching=True)
    assert bool(info.keyframe_added) and not bool(info.loop_closed)
    assert graph_slam.update.syncs - syncs == 2
    assert graph_slam.update.searches == searches
    assert st2.nodes == 2 and int(st2.graph.num_edges) == 1
    torch.testing.assert_close(st2.last_kf_pose, st2.hector.match_pose)
