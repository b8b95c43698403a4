"""The fleet over a mesh, the edge-sharded pose graph, sharded checkpoints
and the multi-process bring-up, on gloo ranks against the JAX package.

* The fleet (``models/fleet.make_fleet_step`` / ``make_fleet_replay``): 8
  robots on their own straight paths (2-level 128-px pyramid, 200 beams, 3
  forced + 6 tracked batch-scans) sharded over the 'search' axis of a 2x2
  and a 2x4 mesh, in ``sub1`` and ``sub4_pallas_dense`` (the plain versions
  of the batched K3 + K4 and of K5 + batched K2 on the CPU): bit for bit the
  single-process fleet, and ``sub1`` against JAX's ``make_fleet_step`` on
  the same mesh at ``tests/test_torch_fleet.py``'s tolerance (poses 1e-4).
* The pose graph (``graph/distributed``): JAX's circle graph, its 64 edges
  over 4 and 8 ranks, one step and three, within JAX's own tolerance (rtol
  1e-4, atol 1e-4) of JAX's ``sharded_gn_step`` and ``posegraph.gn_step``.
* Sharded checkpoints (``io/checkpoint.save_sharded`` / ``restore_sharded``):
  Hector and CoreSLAM (production) saved at a 2x2 mesh mid-replay; resumed
  at 2x2 they are the uninterrupted replays bit for bit, resumed at 4x2
  CoreSLAM still is and Hector within the sharded tolerances (5e-3 m, maps
  1e-2); JAX's ``checkpoint.restore`` reads the files.
* The bring-up (``tests/test_multiprocess.py``'s counterpart): 4 ranks
  brought up by ``initialize_multihost`` from torchrun's environment, each
  feeding only its own beam chunk to hector_sharded steps; each rank checks
  its poses against the dense pipeline (1e-4) and its tile against the
  dense pyramid's after the forced updates (bit for bit).
"""
import dataclasses
import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.graph import distributed as jdistributed
from slamnet_tpu.graph import posegraph as jposegraph
from slamnet_tpu.io import checkpoint as jcheckpoint
from slamnet_tpu.models import fleet as jfleet
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.parallel import make_mesh as jmake_mesh
from slamnet_tpu_torch import replay
from slamnet_tpu_torch.io import checkpoint
from slamnet_tpu_torch.models import fleet
from slamnet_tpu_torch.parallel import launch
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim.field import ray_cast

import _torch_sharded_ranks as ranks
from test_posegraph import _circle_graph

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SMALL = dict(num_levels=2, map_size=128, map_resolution=0.3125,
             estimate_iterations=(5, 4))
B, N, T, BOOT = 8, 200, 9, 3
N_SCANS, CUT = 10, 6
LAUNCH_TIMEOUT_S = 300
# JAX's pose-graph steps compiled once (op by op each primitive compiles)
gn_step = jax.jit(jposegraph.gn_step)
optimize3 = jax.jit(lambda g: jposegraph.optimize(g, 3))


def _fleet_log():
    """T batch-scans of B robots on straight paths: true poses f32[T, B, 3],
    clouds f32[T, B, N, 2], valid bool[T, B, N] (numpy seed 0)."""
    rng = np.random.default_rng(0)
    starts = np.concatenate([rng.uniform(13, 27, (B, 2)),
                             rng.uniform(-math.pi, math.pi, (B, 1))], 1)
    vel = np.concatenate([rng.uniform(-0.12, 0.12, (B, 2)),
                          rng.uniform(-0.05, 0.05, (B, 1))], 1)
    traj = (starts[None] + np.arange(T)[:, None, None] * vel[None]).astype(
        np.float32)
    angles = revolution_angles(N)
    hit, dist = ray_cast(default_field(device="cpu"),
                         torch.from_numpy(traj[..., :2]),
                         torch.from_numpy(angles + traj[..., 2:3]), 40.0)
    hit = hit.numpy()
    r = np.where(hit, dist.numpy()
                 + rng.integers(-100, 100, hit.shape) / 100.0 * 0.02, 0.0)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1)
    return traj, pts.astype(np.float32), hit


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fleet")
    f_traj, f_pts, f_valid = _fleet_log()
    g, _, _ = _circle_graph(max_edges=64)
    traj, pts, valid = ranks.scan_log(N_SCANS, 300, 12)
    d = dict(f_traj=f_traj, f_pts=f_pts, f_valid=f_valid, traj=traj, pts=pts,
             valid=valid, cut=np.int32(CUT),
             **{f"g_{k}": np.asarray(getattr(g, k)) for k in g._fields})
    np.savez(tmp / "in.npz", **d)
    launch.launch("_torch_sharded_ranks:mesh_fleet", 8,
                  {"data": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                   "small": SMALL, "boot": BOOT, "ckpt_dir": str(tmp)},
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S,
                  pythonpath=[TESTS_DIR])
    return d, dict(np.load(tmp / "out.npz")), g, tmp


def _single_fleet(cfg, d):
    st = fleet.init_fleet(cfg, d["f_traj"][0], "cpu")
    for t in range(BOOT):
        st = st._replace(match_pose=torch.from_numpy(d["f_traj"][t]))
        st, _ = fleet.update_fleet(st, torch.from_numpy(d["f_pts"][t]),
                                   torch.from_numpy(d["f_valid"][t]), cfg,
                                   True)
    st, poses = fleet.replay_fleet(st, torch.from_numpy(d["f_pts"][BOOT:]),
                                   torch.from_numpy(d["f_valid"][BOOT:]), cfg)
    return st, poses.numpy()


@pytest.mark.parametrize("mesh", [n for n, _ in ranks.FLEET_MESHES])
@pytest.mark.parametrize("mode", ranks.FLEET_MODES)
def test_mesh_fleet_equals_single_process_fleet(run, mesh, mode):
    # independent robots: each rank's fleet on its B / S robots is the
    # single-process fleet's rows, bit for bit
    d, p = run[:2]
    st, poses = _single_fleet(getattr(replay, f"{mode}_config")(**SMALL), d)
    np.testing.assert_array_equal(p[f"fleet_{mesh}_{mode}_poses"], poses)
    np.testing.assert_array_equal(p[f"fleet_{mesh}_{mode}_maps"],
                                  st.maps.numpy())
    err = np.linalg.norm(poses[-1, :, :2] - d["f_traj"][-1, :, :2], axis=1)
    assert err.max() < 0.1, err


@pytest.mark.parametrize("mesh", [n for n, _ in ranks.FLEET_MESHES])
def test_sub1_mesh_fleet_matches_jax(run, mesh):
    d, p = run[:2]
    cfg = replay.sub1_config(**SMALL)
    jcfg = JHectorConfig(**{**dataclasses.asdict(cfg),
                            "matcher_mode": "gather"})
    jmesh = jmake_mesh(dict(ranks.FLEET_MESHES)[mesh])
    step = jfleet.make_fleet_step(jmesh, jcfg)
    st = jfleet.init_fleet(jcfg, jnp.asarray(d["f_traj"][0]))
    poses = []
    for t in range(T):
        if t < BOOT:
            st = st._replace(match_pose=jnp.asarray(d["f_traj"][t]))
        st, info = step(st, jnp.asarray(d["f_pts"][t]),
                        jnp.asarray(d["f_valid"][t]), t < BOOT)
        poses.append(np.asarray(st.match_pose))
    np.testing.assert_allclose(p[f"fleet_{mesh}_sub1_poses"],
                               np.asarray(poses[BOOT:]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_gn_equals_dense(run, n):
    _, p, g, _ = run
    want = np.asarray(gn_step(g).poses)
    jmesh = jmake_mesh({"edge": 8})
    shard = np.asarray(jax.jit(lambda g: jdistributed.sharded_gn_step(
        jmesh, g))(g).poses)
    for w in (want, shard):
        np.testing.assert_allclose(p[f"graph_{n}_step"], w, rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(
        p[f"graph_{n}_opt"], np.asarray(optimize3(g).poses),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["hector", "coreslam"])
def test_sharded_checkpoint_resumes(run, kind):
    _, p, _, tmp = run
    field = "maps" if kind == "hector" else "hole"
    full_maps, full_pose = p[f"ck_{kind}_full_{field}"], \
        p[f"ck_{kind}_full_pose"]
    # the same mesh: the uninterrupted replay, bit for bit
    np.testing.assert_array_equal(p[f"ck_{kind}_2x2_{field}"], full_maps)
    np.testing.assert_array_equal(p[f"ck_{kind}_2x2_pose"], full_pose)
    if kind == "coreslam":
        # integer sums: bit for bit on any mesh
        np.testing.assert_array_equal(p["ck_coreslam_4x2_hole"], full_maps)
        np.testing.assert_array_equal(p["ck_coreslam_4x2_pose"], full_pose)
    else:
        np.testing.assert_allclose(p["ck_hector_4x2_pose"], full_pose,
                                   rtol=0, atol=5e-3)
        assert np.abs(p["ck_hector_4x2_maps"] - full_maps).max() < 1e-2
    meta = jcheckpoint.load_metadata(str(tmp / kind))
    assert meta["sharded_kind"] == ("ShardedHectorState" if kind == "hector"
                                    else "ShardedCoreSlamState")
    assert meta["scan"] == CUT


def test_jax_reads_a_sharded_hector_checkpoint(run):
    # JAX's npz layout: JAX's restore reads the port's densified state, and
    # JAX's restore_sharded puts it on a JAX mesh
    _, p, _, tmp = run
    cfg = JHectorConfig(map_size=100, map_resolution=0.3, num_levels=2,
                        estimate_iterations=(3, 2))
    like = jhector.init(cfg, (0.0, 0.0, 0.0))
    dense = jcheckpoint.restore(str(tmp / "hector"), like)
    back = jcheckpoint.restore_sharded(str(tmp / "hector"),
                                       jmake_mesh({"tile": 2, "search": 2}),
                                       cfg, like)
    from slamnet_tpu.models import hector_sharded as jhs
    np.testing.assert_array_equal(np.asarray(jhs.unshard_maps(back, cfg)),
                                  np.asarray(dense.maps))
    assert np.isfinite(np.asarray(dense.maps)).all()
    assert np.abs(np.asarray(dense.maps)).max() > 0


def test_save_sharded_densifies_the_graph_kind_and_refuses_others(
        monkeypatch):
    # the graph kind is densified by graph_slam_sharded.to_dense
    # (tests/test_torch_graph_slam_sharded.py saves and restores one), and a
    # state of no sharded kind is refused
    from slamnet_tpu_torch.models import graph_slam_sharded

    class ShardedGraphSlamState(NamedTuple):
        hector: int

    class Other(NamedTuple):
        hector: int

    seen = []

    def to_dense(mesh, state, cfg, tile_axis, search_axis):
        seen.append((state, tile_axis, search_axis))
        raise RuntimeError("densified")

    monkeypatch.setattr(graph_slam_sharded, "to_dense", to_dense)
    with pytest.raises(RuntimeError, match="densified"):
        checkpoint.save_sharded("unused", ShardedGraphSlamState(0), None,
                                None)
    assert seen == [(ShardedGraphSlamState(0), "tile", "search")]
    with pytest.raises(TypeError, match="not a sharded state"):
        checkpoint.save_sharded("unused", Other(0), None, None)


def test_bringup_from_the_environment(tmp_path):
    # torchrun's variables, no launcher rendezvous: initialize_multihost
    # brings the world up; each rank asserts its own poses and tile
    out = launch.launch("_torch_sharded_ranks:bringup", 4,
                        {"out": str(tmp_path / "out.npz")}, backend="gloo",
                        timeout_s=LAUNCH_TIMEOUT_S, rendezvous="env",
                        pythonpath=[TESTS_DIR])
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    # the search axis splits the 256 beams in two chunks
    assert [r["beams"] for r in out] == [[0, 128], [128, 256]] * 2
    poses = np.asarray([r["pose"] for r in out])
    np.testing.assert_array_equal(poses, poses[:1].repeat(4, 0))
    np.testing.assert_allclose(poses[0], out[0]["dense_pose"], rtol=0,
                               atol=1e-4)
