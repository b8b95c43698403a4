"""Distributed graph-SLAM: slamnet_tpu_torch.models.graph_slam_sharded on 8
gloo ranks against JAX's graph_slam_sharded on the 8-device CPU mesh.

The log is ``tests/test_torch_graph.py``'s out-and-back (12 still scans, 3 m
out and back; 72 scans of 400 beams, the port's sim from seed 11), on a
2-level 200-px pyramid at 0.2 m with 64 keyframe slots, the first 10 scans
forced: ``tests/test_graph_slam.py:194``'s test at a smaller pyramid.  The
port runs on 8 gloo ranks on the CPU (ONE launch for the file): the 2x4
(tile x search) mesh for the replay, the carried JAX state and the
checkpoint, the 4x2 for the rebuild and the restore, built in the same order
on every rank.  JAX runs the same replay on ``make_mesh({"tile": 2,
"search": 4})`` and its rebuild on 4x2, on the same numpy scans.

Tolerances are JAX's own (``tests/test_graph_slam.py:242-249``): the same
keyframes, edges and closures, keyframe and match poses within 2e-2 m of
JAX's sharded step and of the port's dense ``graph_slam.update``, the
keyframe clouds exact; the rebuild equal to the serial one bit for bit
(``:70``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core import PoseGraphConfig as JPoseGraphConfig
from slamnet_tpu.models import graph_slam as jgs
from slamnet_tpu.models import graph_slam_sharded as jgss
from slamnet_tpu.models import hector_sharded as jhs
from slamnet_tpu.parallel import make_mesh as jmake_mesh
from slamnet_tpu_torch import convert
from slamnet_tpu_torch.core.config import HectorConfig, PoseGraphConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import graph_slam
from slamnet_tpu_torch.parallel import launch
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution

HCFG = dict(map_size=200, map_resolution=0.2, num_levels=2,
            estimate_iterations=(7, 4))
GCFG = dict(max_keyframes=64, max_edges=256, keyframe_dist=0.8,
            keyframe_angle=0.6, loop_closure_radius=1.5)
FORCED = 10
CUT = 40           # the checkpoint's scan
CONVERT_AT = 55    # JAX's state before this scan goes into the port
POSE_TOL = 2e-2
LAUNCH_TIMEOUT_S = 900   # a deadlock guard: ~30 s alone, ~270 s in a busy -n 6 run
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
STATE_ARRAYS = ("match_pose", "last_update_pose", "kf_points", "kf_valid",
                "last_kf_pose", "loop_count")


def _log():
    """tests/test_torch_graph.py's out-and-back log, as numpy."""
    fwd = np.stack([np.linspace(20, 23.5, 30), np.full(30, 20.0),
                    np.zeros(30)], -1).astype(np.float32)
    still = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (12, 1))
    traj = np.concatenate([still, fwd, fwd[::-1].copy()])
    angles = torch.from_numpy(revolution_angles(400))
    r, v = scan_revolution(default_field(device="cpu"),
                           torch.from_numpy(traj), angles, 40.0, 0.02,
                           torch.Generator().manual_seed(11))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return traj, pts.numpy().astype(np.float32), v.numpy()


def _jax_replay(traj, pts, valid):
    """JAX's sharded replay on 2x4; its state's arrays before CONVERT_AT
    and its pose after that scan."""
    hcfg, gcfg = JHectorConfig(**HCFG), JPoseGraphConfig(**GCFG)
    mesh = jmake_mesh({"tile": 2, "search": 4})
    st = jgss.init(mesh, hcfg, gcfg, traj[0], pts.shape[1])
    step = jgss.make_step(mesh, hcfg, gcfg, pts.shape[1])
    poses, kf, loop, conv = [], [], [], {}
    for t in range(len(traj)):
        if t == CONVERT_AT:
            conv = {f"conv_{k}": np.asarray(getattr(st, k))
                    for k in ("local_maps",) + STATE_ARRAYS}
            conv.update({f"conv_graph_{k}": np.asarray(getattr(st.graph, k))
                         for k in convert.GRAPH_FIELDS})
        st, info = step(st, pts[t], valid[t], jnp.asarray(t < FORCED))
        poses.append(np.asarray(st.match_pose))
        kf.append(bool(info.keyframe_added))
        loop.append(bool(info.loop_closed))
        if t == CONVERT_AT:
            conv_next = (np.asarray(st.match_pose),
                         int(st.graph.num_nodes))
        assert int(info.sep_overflow) == 0
    return st, np.asarray(poses), np.asarray(kf), np.asarray(loop), conv, \
        conv_next


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_slam_sharded")
    traj, pts, valid = _log()
    hcfg = JHectorConfig(**HCFG)
    jst, jposes, jkf, jloop, conv, conv_next = _jax_replay(traj, pts, valid)
    jdense = jgss.to_dense(jst, hcfg)
    mesh42 = jmake_mesh({"tile": 4, "search": 2})
    jrebuild = np.asarray(jhs.unshard_maps(jhs.ShardedHectorState(
        jgs.rebuild_maps_sharded(mesh42, jdense, hcfg), jnp.zeros(3),
        jnp.zeros(3)), hcfg))
    data = dict(traj=traj, pts=pts, valid=valid, conv_scan=CONVERT_AT,
                jax_maps=np.asarray(jdense.hector.maps),
                jax_match_pose=np.asarray(jdense.hector.match_pose),
                jax_kf_points=np.asarray(jdense.kf_points),
                jax_kf_valid=np.asarray(jdense.kf_valid),
                jax_loop_count=np.asarray(jdense.loop_count),
                **{f"jax_graph_{k}": np.asarray(getattr(jdense.graph, k))
                   for k in convert.GRAPH_FIELDS}, **conv)
    np.savez(tmp / "in.npz", **data)
    launch.launch("_torch_sharded_ranks:graph_slam_sharded", 8,
                  {"data": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                   "hcfg": HCFG, "gcfg": GCFG, "forced": FORCED, "cut": CUT,
                   "ckpt_dir": str(tmp)},
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S,
                  pythonpath=[TESTS_DIR])
    port = dict(np.load(tmp / "out.npz"))
    return dict(data=data, port=port, jst=jst, jdense=jdense, jposes=jposes,
                jkf=jkf, jloop=jloop, jrebuild=jrebuild, conv_next=conv_next)


@pytest.fixture(scope="module")
def dense(run):
    """The port's dense graph_slam.update over the same log (plain)."""
    d = run["data"]
    hcfg, gcfg = HectorConfig(**HCFG), PoseGraphConfig(**GCFG)
    st = graph_slam.init(hcfg, gcfg, d["traj"][0], d["pts"].shape[1], "cpu")
    poses = []
    for t in range(len(d["traj"])):
        st, _ = graph_slam.update(st, Scan.from_points(d["pts"][t],
                                                       d["valid"][t]),
                                  hcfg, gcfg, map_without_matching=t < FORCED)
        poses.append(st.hector.match_pose.clone())
    return st, torch.stack(poses).numpy()


def test_keyframes_edges_and_closures_equal_jax(run):
    p, jst = run["port"], run["jst"]
    nkf = int(jst.graph.num_nodes)
    assert int(p["nodes"]) == int(p["graph_num_nodes"]) == nkf >= 6
    np.testing.assert_array_equal(p["kf"], run["jkf"])
    np.testing.assert_array_equal(p["loop"], run["jloop"])
    assert int(p["loop_count"]) == int(jst.loop_count) >= 1
    ne = int(jst.graph.num_edges)
    assert int(p["graph_num_edges"]) == ne
    for k in ("edge_i", "edge_j", "edge_valid"):
        np.testing.assert_array_equal(p[f"graph_{k}"][:ne],
                                      np.asarray(getattr(jst.graph, k))[:ne])
    assert not p["overflow"].any()


def test_poses_within_jax_and_dense(run, dense):
    # the keyframe poses and the live match pose at every scan within 2e-2
    # m of JAX's sharded replay and of the port's dense graph_slam.update
    p, jst = run["port"], run["jst"]
    dst, dposes = dense
    nkf = int(jst.graph.num_nodes)
    assert dst.nodes == nkf and int(dst.loop_count) == int(p["loop_count"])
    for want in (np.asarray(jst.graph.poses[:nkf]),
                 dst.graph.poses[:nkf].numpy()):
        np.testing.assert_allclose(p["graph_poses"][:nkf], want, rtol=0,
                                   atol=POSE_TOL)
    np.testing.assert_allclose(p["poses"], run["jposes"], rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(p["poses"], dposes, rtol=0, atol=POSE_TOL)


def test_keyframe_clouds_exact(run, dense):
    # the clouds, gathered from the search shards: JAX's and the dense
    # model's, bit for bit
    p = run["port"]
    np.testing.assert_array_equal(p["kf_points"],
                                  np.asarray(run["jst"].kf_points))
    np.testing.assert_array_equal(p["kf_valid"],
                                  np.asarray(run["jst"].kf_valid))
    np.testing.assert_array_equal(p["kf_points"],
                                  dense[0].kf_points.numpy())


def test_every_rank_read_the_same_flags(run):
    # due / has_cand / looped, read on the host by every rank at every scan
    p = run["port"]
    flags = p["flags_all"].reshape(8, len(run["data"]["traj"]), 3)
    assert (flags == flags[:1]).all()
    due, has_cand, looped = flags[0].T.astype(bool)
    np.testing.assert_array_equal(due, p["kf"])
    np.testing.assert_array_equal(looped, p["loop"])
    assert (has_cand >= looped).all() and has_cand.sum() > looped.sum() - 1
    syncs, searches = p["syncs_searches"]
    assert searches == has_cand.sum()
    assert syncs == len(due) + due.sum() + searches


def test_collectives_a_scan(run):
    # a scan: sum(estimate_iterations) + 2 for Hector; a keyframe event
    # with room: the cloud's psum + 3 Schur steps x 3
    p = run["port"]
    scans = len(run["data"]["traj"])
    events = int(p["kf"].sum())
    want = scans * (sum(HCFG["estimate_iterations"]) + 2) + events * (1 + 9)
    # the checkpoint at CUT gathers the tiles, the clouds and a barrier, and
    # the cut's own to_dense two more
    want += 3 + 2
    assert int(p["replay_collectives"]) == want


def test_rebuild_sharded_equals_serial(run, dense):
    # on 4x2 from the replay's state: the port's serial rebuild_maps of the
    # same dense state, bit for bit
    p = run["port"]
    hcfg = HectorConfig(**HCFG)
    st = convert.graph_state_from_numpy({
        "hector": {"maps": p["maps"], "match_pose": p["poses"][-1],
                   "last_update_pose": p["poses"][-1]},
        "graph": {k: p[f"graph_{k}"] for k in convert.GRAPH_FIELDS},
        "kf_points": p["kf_points"], "kf_valid": p["kf_valid"],
        "last_kf_pose": p["poses"][-1], "loop_count": p["loop_count"]},
        device="cpu")
    serial = graph_slam.rebuild_maps(st, hcfg).numpy()
    np.testing.assert_array_equal(p["rebuild_own"], serial)
    l0 = serial[:hcfg.map_size ** 2]
    assert (l0 > 0).sum() > 300 and (l0 < 0).sum() > 5000


def test_rebuild_sharded_equals_jax(run):
    # on 4x2 from JAX's state: JAX's rebuild_maps_sharded and the port's
    # serial rebuild_maps, bit for bit; every tile's halo row refreshed
    p = run["port"]
    hcfg = HectorConfig(**HCFG)
    np.testing.assert_array_equal(p["rebuild_jax"], run["jrebuild"])
    jd = run["jdense"]
    st = convert.graph_state_from_numpy({
        "hector": {k: np.asarray(getattr(jd.hector, k))
                   for k in convert.FIELDS},
        "graph": {k: np.asarray(getattr(jd.graph, k))
                  for k in convert.GRAPH_FIELDS},
        **{k: np.asarray(getattr(jd, k)) for k in
           ("kf_points", "kf_valid", "last_kf_pose", "loop_count")}},
        device="cpu")
    np.testing.assert_array_equal(p["rebuild_jax"],
                                  graph_slam.rebuild_maps(st, hcfg).numpy())
    from slamnet_tpu_torch.models import hector_sharded
    want = hector_sharded.shard_tiles_host(torch.tensor(run["jrebuild"]),
                                           hcfg, 4).numpy()
    np.testing.assert_array_equal(p["rebuild_jax_tiles"], want)


def test_jax_state_carried_in_steps_as_jax(run):
    # JAX's sharded state before CONVERT_AT into the port (and back,
    # unchanged), stepped once: within 2e-2 m of JAX's next pose
    p = run["port"]
    assert bool(p["conv_back_ok"])
    jpose, jnodes = run["conv_next"]
    np.testing.assert_allclose(p["conv_pose"], jpose, rtol=0, atol=POSE_TOL)
    assert int(p["conv_nodes"][1]) == int(p["conv_nodes"][2]) == jnodes
    assert int(p["conv_nodes"][0]) == int(run["data"]["conv_graph_num_nodes"])


def test_checkpoint_saved_on_2x4_restores_on_4x2(run):
    # the checkpoint at CUT restored on 4x2: its dense state is the saved
    # one, each rank holding 32 of the 64 clouds
    p = run["port"]
    for k in ("kf_points", "poses", "maps"):
        np.testing.assert_array_equal(p[f"restored_{k}"], p[f"cut_{k}"])
    assert int(p["restored_nodes"]) == int(p["cut_nodes"]) >= 2
    assert list(p["restored_shard"]) == [32, 400, 2]


def test_convert_refuses_missing_arrays():
    with pytest.raises(ValueError, match="lack"):
        convert.sharded_graph_state_from_numpy({"local_maps": None}, None)
