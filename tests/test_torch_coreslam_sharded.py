"""The sharded CoreSLAM pipeline: slamnet_tpu_torch.models.coreslam_sharded
on gloo ranks, bit for bit against the port's dense CoreSLAM.

The counterparts of ``tests/test_coreslam_sharded.py``: every sharded
CoreSLAM reduction is an integer sum or a lexicographic argmin, so the
whole pipeline (track, best sums, hole map, obstacle map, warm-up count)
must equal the dense ``models/coreslam`` exactly, in the Monte-Carlo parity
mode (1024 candidates, line updates) and the correlative production mode
(dense fills).  The first 12 scans of the loop, 400 beams, generator
seed 7; the port on 8 gloo ranks (one launch): a 2x2 mesh over ranks 0-3,
a 4x2 over all eight.  The Monte-Carlo draws are the port's (a
``torch.Generator``, not ``jax.random``), so the JAX side holds the ops:
the sharded correlative score grid equals JAX's dense
``ops/correlate.correlative_scores`` bit for bit (run outside jit, as
``tests/test_torch_coreslam_ops.py`` runs it).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.ops import correlate as jcorr
from slamnet_tpu.ops import score as jscore
from slamnet_tpu_torch.core.config import CoreSlamConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import coreslam
from slamnet_tpu_torch.parallel import launch

import _torch_sharded_ranks as ranks

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
MESHES = ("2x2", "4x2")
N_SCANS = 12
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coreslam_sharded")
    traj, pts, valid = ranks.scan_log(N_SCANS, 400, 1)
    cfg = CoreSlamConfig()
    rng = np.random.default_rng(0)
    # the correlative grid's case: a map built by a few dense steps, a
    # search pose off the truth, JAX's headings
    st = coreslam.init(cfg, traj[0], device="cpu")
    for t in range(6):
        st, _ = coreslam.update_cloud(st, Scan(torch.from_numpy(pts[t]),
                                               torch.from_numpy(valid[t]),
                                               torch.zeros(3)),
                                      torch.from_numpy(traj[t]), cfg)
    c_pose = (traj[6] + np.float32([0.05, -0.04, 0.03])).astype(np.float32)
    span = 3.0 * cfg.sigma_theta
    thetas = np.asarray(jnp.asarray(c_pose[2]) + jnp.linspace(
        -span, span, cfg.corr_num_theta))
    d = dict(traj=traj, pts=pts, valid=valid,
             rand_hole=rng.integers(0, 65500, cfg.hole_map_size ** 2).astype(
                 np.int32),
             c_hole=st.hole_map.numpy(), c_pts=pts[6], c_valid=valid[6],
             c_pose=c_pose, c_thetas=thetas)
    np.savez(tmp / "in.npz", **d)
    launch.launch("_torch_sharded_ranks:coreslam", 8,
                  {"data": str(tmp / "in.npz"), "out": str(tmp / "out.npz")},
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S,
                  pythonpath=[TESTS_DIR])
    return d, dict(np.load(tmp / "out.npz"))


def _dense(mode, d):
    cfg = CoreSlamConfig().overlay(ranks.CORESLAM_CONFIGS[mode])
    st = coreslam.init(cfg, torch.from_numpy(d["traj"][0]),
                       seed=ranks.CORESLAM_SEED, device="cpu")
    poses, sums = [], []
    for t in range(N_SCANS):
        st, info = coreslam.update_cloud(
            st, Scan(torch.from_numpy(d["pts"][t]),
                     torch.from_numpy(d["valid"][t]), torch.zeros(3)),
            st.pose, cfg)
        poses.append(st.pose)
        sums.append(info.best_sum)
    return st, torch.stack(poses).numpy(), torch.stack(sums).numpy()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", list(ranks.CORESLAM_CONFIGS))
def test_sharded_pipeline_bit_exact_vs_dense(run, mesh, mode):
    d, p = run
    st, poses, sums = _dense(mode, d)
    np.testing.assert_array_equal(p[f"{mesh}_{mode}_poses"], poses)
    np.testing.assert_array_equal(p[f"{mesh}_{mode}_sums"], sums)
    np.testing.assert_array_equal(p[f"{mesh}_{mode}_hole"],
                                  st.hole_map.numpy())
    np.testing.assert_array_equal(p[f"{mesh}_{mode}_obst"],
                                  st.obstacle_map.numpy())
    np.testing.assert_array_equal(p[f"{mesh}_{mode}_count"],
                                  [int(st.scan_count), st.scans])
    # the search ran after the warm-up, and it tracked the trajectory
    assert (sums[5:] > 0).all() and st.scans == 5
    err = np.linalg.norm(poses[-1, :2] - d["traj"][-1, :2])
    assert err < 0.5, err


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_roundtrip(run, mesh):
    d, p = run
    np.testing.assert_array_equal(p[f"{mesh}_roundtrip"], d["rand_hole"])


@pytest.mark.parametrize("mesh", MESHES)
def test_convert_sharded_state(run, mesh):
    # JAX's local_hole i32[T, rows * S]: a rank keeps its tile's row, the
    # gathered rows are JAX's array again, the warm-up count rides along
    d, p = run
    tiles = d["rand_hole"].reshape(int(mesh[0]), -1)
    np.testing.assert_array_equal(p[f"{mesh}_convert_back"], tiles)
    np.testing.assert_array_equal(p[f"{mesh}_convert_tile"], tiles[0])
    np.testing.assert_array_equal(p[f"{mesh}_convert_count"], [5, 5])


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_correlative_grid_equals_jax_dense(run, mesh):
    # headings over 'search', rows over 'tile': the psum'd integer sums and
    # the all_gathered grid equal JAX's dense one-hot matmul form
    d, p = run
    cfg = CoreSlamConfig()
    js, jn = jcorr.correlative_scores(
        jnp.asarray(d["c_hole"]), cfg.hole_map_size, cfg.hole_scale,
        jnp.asarray(d["c_pts"]), jnp.asarray(d["c_valid"]),
        jnp.asarray(d["c_pose"]), jnp.asarray(d["c_thetas"]),
        cfg.corr_window)
    want = np.where(np.asarray(jn) > 0, np.asarray(js), jscore.INT32_MAX)
    np.testing.assert_array_equal(p[f"{mesh}_eff"], want)
    assert (want < jscore.INT32_MAX).sum() > 100
