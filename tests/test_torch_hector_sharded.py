"""The sharded Hector pipeline: slamnet_tpu_torch.models.hector_sharded on
gloo ranks against JAX's hector_sharded on the 8-device CPU mesh.

The counterparts of ``tests/test_hector_sharded.py`` at a small size: a
2-level 100/50-px pyramid at 0.3 m (30 m: beams past it leave the map), 3/2
GN iterations, 300 beams (padded to 384, so each of the 2 search shards
holds real beams), 12 scans of the loop taken every 12th pose (~0.21 m a
scan, so the motion gate fires), the first 4 forced at the true poses.  The
port runs on 8 gloo ranks on the CPU (``parallel/launch.py``, ONE launch for
the whole file): a 2x2 mesh over ranks 0-3 and a 4x2 mesh over all eight
(interior tiles with two halo neighbours; the 50-px level's 13-row tiles
end in padding rows).  JAX runs the same meshes over ``jax.devices()[:4]``
and ``[:8]``, on the same numpy inputs.

Tolerances are JAX's own sharded-vs-dense ones: forced (line) updates bit
for bit, a matched step's pose 2e-4 m, a replay's poses 5e-3 m and maps
1e-2, equal update counts and GN iterations.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.models import hector_sharded as jhs
from slamnet_tpu.parallel import make_mesh as jmake_mesh
from slamnet_tpu_torch.core.config import HectorConfig, SimConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import hector, hector_sharded
from slamnet_tpu_torch.parallel import launch
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

SMALL = dict(map_size=100, map_resolution=0.3, num_levels=2,
             estimate_iterations=(3, 2))
CFG = HectorConfig().overlay(SMALL)
JCFG = JHectorConfig(**dataclasses.asdict(CFG))
N_SCANS, BOOT, BEAMS = 12, 4, 300
EXIT_TOL = 0.02     # px: some levels stop early, some run their iterations
MESHES = {"2x2": {"tile": 2, "search": 2}, "4x2": {"tile": 4, "search": 2}}
LAUNCH_TIMEOUT_S = 300
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ZERO3 = np.zeros(3, np.float32)
# serving_hector_config()'s matcher and knobs at this pyramid, and the three
# knobs the sharded step does not read, cleared
SERVING = dict(matcher_mode="onehot_bf16", match_subsample=4, gn_damping=0.1,
               dense_free_fill=True, xy_step_clamp_px=10.0,
               max_match_jump=1.0)
SERVING_CLEARED = dict(match_subsample=1, gn_damping=0.0,
                       dense_free_fill=False)


def _log():
    """12 scans of the loop every 12th pose, 300 beams, the port's sim on
    the CPU from seed 0 (numpy out)."""
    sim = SimConfig()
    traj = loop_trajectory(speed=0.3)[::12][:N_SCANS].astype(np.float32)
    angles = revolution_angles(BEAMS)
    fld = default_field(sim.field_scale, sim.field_offset, device="cpu")
    gen = torch.Generator().manual_seed(0)
    r, v = scan_revolution(fld, torch.from_numpy(traj),
                           torch.from_numpy(angles), sim.max_scan_dist,
                           sim.measure_error, gen)
    a = torch.from_numpy(angles)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], -1)
    return traj, pts.numpy().astype(np.float32), v.numpy()


def _jax_dense_forced(traj, pts, valid, n):
    st = jhector.init(JCFG, traj[0])
    for t in range(n):
        st, _ = jhector.update(st, JScan(jnp.asarray(pts[t]),
                                         jnp.asarray(valid[t]), ZERO3),
                               jnp.asarray(traj[t]), JCFG,
                               map_without_matching=jnp.asarray(True))
    return st


def _jax_replay(mesh, cfg, traj, pts, valid):
    """JAX's sharded replay, the port's flow: the first BOOT scans forced
    with match_pose set to the truth."""
    sh = jhs.init(mesh, cfg, traj[0])
    step = jhs.make_step(mesh, cfg, BEAMS)
    poses, upd, iters, boot_maps = [], [], [], None
    for t in range(N_SCANS):
        if t < BOOT:
            sh = sh._replace(match_pose=jnp.asarray(traj[t]))
        sh, info = step(sh, pts[t], valid[t], jnp.asarray(t < BOOT))
        poses.append(np.asarray(sh.match_pose))
        upd.append(bool(info.map_updated))
        iters.append(int(info.gn_iterations))
        if t == BOOT - 1:
            boot_maps = np.asarray(jhs.unshard_maps(sh, cfg))
    return (np.asarray(poses), np.asarray(upd), boot_maps,
            np.asarray(jhs.unshard_maps(sh, cfg)), np.asarray(iters))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the port's ranks' outputs (one launch) and JAX's."""
    tmp = tmp_path_factory.mktemp("hector_sharded")
    traj, pts, valid = _log()
    rng = np.random.default_rng(0)
    warm = _jax_dense_forced(traj, pts, valid, N_SCANS - 1)
    q = N_SCANS - 1
    # the in-map guard's case: the hint 0.3 m off the truth; the guard set
    # above the scan's in-map fraction, so the dense step keeps the hint
    frac_hint = (traj[q] + np.asarray([0.3, -0.2, 0.0], np.float32))
    _, stats = hector.match_with_stats(
        torch.from_numpy(np.array(warm.maps)),
        Scan(torch.from_numpy(pts[q]), torch.from_numpy(valid[q]),
             torch.zeros(3)), torch.from_numpy(frac_hint), CFG)
    frac = float(stats.in_map_frac)
    data = dict(traj=traj, pts=pts, valid=valid,
                rand_maps=rng.normal(0, 1, CFG.total_cells).astype(np.float32),
                warm_maps=np.array(warm.maps),
                warm_last=np.array(warm.last_update_pose),
                warm_hint=np.array(warm.match_pose),
                frac_hint=frac_hint, frac_guard=np.float32(min(frac + 0.05,
                                                               1.0)),
                q_pts=pts[q], q_valid=valid[q],
                **{f"jax_tiles_{name}": np.asarray(jhs.shard_tiles_host(
                    warm.maps, JCFG, axes["tile"]))
                   for name, axes in MESHES.items()})
    np.savez(tmp / "in.npz", **data)
    launch.launch("_torch_sharded_ranks:hector", 8,
                  {"data": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                   "cfg": SMALL, "boot": BOOT, "exit_tol": EXIT_TOL,
                   "serving": SERVING, "serving_cleared": SERVING_CLEARED},
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S,
                  pythonpath=[TESTS_DIR])
    port = dict(np.load(tmp / "out.npz"))
    jax_out = {}
    for name, axes in MESHES.items():
        mesh = jmake_mesh(axes)
        modes = ("gather", "onehot_highest", "onehot_bf16", "exit") \
            if name == "2x2" else ("gather",)
        for mode in modes:
            c = (dataclasses.replace(JCFG, early_exit_tol=EXIT_TOL)
                 if mode == "exit"
                 else dataclasses.replace(JCFG, matcher_mode=mode))
            jax_out[(name, mode)] = _jax_replay(mesh, c, traj, pts, valid)
        if name == "2x2":
            jax_out[(name, "serving")] = _jax_replay(
                mesh, dataclasses.replace(JCFG, **SERVING), traj, pts, valid)
        for case in ("warm", "frac"):
            c = JCFG if case == "warm" else dataclasses.replace(
                JCFG, min_match_in_map_frac=float(data["frac_guard"]))
            sh = jhs.shard_state(mesh, warm._replace(
                match_pose=jnp.asarray(data[f"{case}_hint"])), c)
            sh2, info = jhs.make_step(mesh, c, BEAMS)(
                sh, pts[q], valid[q], jnp.asarray(False))
            jax_out[(name, case)] = (np.asarray(sh2.match_pose), info)
    return dict(data=data, port=port, jax=jax_out, frac=frac)


def _dense_replay(traj, pts, valid, cfg):
    """The port's dense Hector over the same flow (plain versions)."""
    st = hector.init(cfg, traj[0], "cpu")
    poses, upd = [], []
    for t in range(N_SCANS):
        hint = torch.from_numpy(traj[t]) if t < BOOT else st.match_pose
        st, info = hector.update(st, Scan(torch.from_numpy(pts[t]),
                                          torch.from_numpy(valid[t]),
                                          torch.zeros(3)), hint, cfg, t < BOOT)
        poses.append(st.match_pose.clone())
        upd.append(bool(info.map_updated))
    return torch.stack(poses).numpy(), np.asarray(upd), st.maps.numpy()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_roundtrip_identity(run, mesh):
    d, p = run["data"], run["port"]
    np.testing.assert_array_equal(p[f"{mesh}_roundtrip"], d["rand_maps"])
    # every tile's table is JAX's tile, bit for bit
    want = np.asarray(jhs.shard_tiles_host(d["rand_maps"], JCFG,
                                           MESHES[mesh]["tile"]))
    np.testing.assert_array_equal(p[f"{mesh}_tiles"], want)
    np.testing.assert_array_equal(
        hector_sharded.shard_tiles_host(torch.from_numpy(d["rand_maps"]), CFG,
                                        MESHES[mesh]["tile"]).numpy(), want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forced_update_bitwise_equal(run, mesh):
    # the forced scans: the pose is the truth on every path, so the line
    # updates are bit for bit JAX's sharded and dense ones and the port's
    # dense one (the marks are unions over beam shards)
    d, p = run["data"], run["port"]
    jax_boot = run["jax"][(mesh, "gather")][2]
    np.testing.assert_array_equal(p[f"{mesh}_gather_boot_maps"], jax_boot)
    dense = np.asarray(_jax_dense_forced(d["traj"], d["pts"], d["valid"],
                                         BOOT).maps)
    np.testing.assert_array_equal(p[f"{mesh}_gather_boot_maps"], dense)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_match_equals_jax_to_float_tolerance(run, mesh):
    # one matched step from JAX's warmed dense map: the port's sharded step
    # against JAX's sharded step and the port's dense step
    d, p = run["data"], run["port"]
    jpose, jinfo = run["jax"][(mesh, "warm")]
    np.testing.assert_allclose(p[f"{mesh}_warm_pose"], jpose, rtol=0,
                               atol=2e-4)
    info = p[f"{mesh}_warm_info"]
    assert bool(info[0]) == bool(jinfo.map_updated)
    assert int(info[2]) == int(jinfo.gn_iterations) == sum(
        CFG.estimate_iterations)
    assert int(info[3]) == int(jinfo.solve_failures)
    np.testing.assert_allclose(info[1], float(jinfo.residual), rtol=1e-3,
                               atol=1e-5)
    dense = hector.HectorState(torch.from_numpy(d["warm_maps"]),
                               torch.from_numpy(d["warm_hint"]),
                               torch.from_numpy(d["warm_last"]))
    dst, _ = hector.update(dense, Scan(torch.from_numpy(d["q_pts"]),
                                       torch.from_numpy(d["q_valid"]),
                                       torch.zeros(3)), dense.match_pose, CFG)
    np.testing.assert_allclose(p[f"{mesh}_warm_pose"], dst.match_pose.numpy(),
                               rtol=0, atol=2e-4)


def test_in_map_guard_is_not_applied_as_in_jax(run):
    # JAX's sharded step applies max_match_jump but not min_match_in_map_frac
    # (hector_sharded.py:367-372): with the guard above this scan's in-map
    # fraction the dense step keeps its hint, the sharded steps (JAX's and
    # the port's) move, and agree
    d, p = run["data"], run["port"]
    assert run["frac"] < 1.0, run["frac"]
    cfg = CFG.overlay({"min_match_in_map_frac": float(d["frac_guard"])})
    dense = hector.HectorState(torch.from_numpy(d["warm_maps"]),
                               torch.from_numpy(d["frac_hint"]),
                               torch.from_numpy(d["warm_last"]))
    dst, _ = hector.update(dense, Scan(torch.from_numpy(d["q_pts"]),
                                       torch.from_numpy(d["q_valid"]),
                                       torch.zeros(3)), dense.match_pose, cfg)
    np.testing.assert_array_equal(dst.match_pose.numpy(), d["frac_hint"])
    jdst, _ = jhector.update(
        jhector.HectorState(jnp.asarray(d["warm_maps"]),
                            jnp.asarray(d["frac_hint"]),
                            jnp.asarray(d["warm_last"])),
        JScan(jnp.asarray(d["q_pts"]), jnp.asarray(d["q_valid"]), ZERO3),
        jnp.asarray(d["frac_hint"]),
        dataclasses.replace(JCFG, min_match_in_map_frac=float(
            d["frac_guard"])))
    np.testing.assert_array_equal(np.asarray(jdst.match_pose), d["frac_hint"])
    for mesh in MESHES:
        jpose = run["jax"][(mesh, "frac")][0]
        assert np.abs(jpose[:2] - d["frac_hint"][:2]).max() > 0.05, jpose
        np.testing.assert_allclose(p[f"{mesh}_frac_pose"], jpose, rtol=0,
                                   atol=2e-4)


def test_onehot_matcher_modes(run):
    # onehot_highest selects the table's entries exactly: the replay equals
    # the gather one bit for bit (as in JAX); onehot_bf16 matches on the
    # bf16-rounded table, within the match tolerance of gather and of JAX's
    # onehot_bf16
    p = run["port"]
    for key in ("poses", "maps"):
        np.testing.assert_array_equal(p[f"2x2_onehot_highest_{key}"],
                                      p[f"2x2_gather_{key}"])
    np.testing.assert_allclose(p["2x2_onehot_bf16_poses"],
                               p["2x2_gather_poses"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(p["2x2_onehot_bf16_poses"],
                               run["jax"][("2x2", "onehot_bf16")][0], rtol=0,
                               atol=5e-3)


def test_early_exit_matches_jax(run):
    # JAX's early-exit while_loop, computed and masked here: the same GN
    # iterations a scan as JAX's sharded step (fewer than the fixed count on
    # some scans, all of them on others) and poses within 5e-3 m
    p = run["port"]
    jposes, _, _, _, jiters = run["jax"][("2x2", "exit")]
    fixed = sum(CFG.estimate_iterations)
    matched = p["2x2_exit_iters"][BOOT:]
    assert (matched < fixed).any() and (matched == fixed).any(), matched
    np.testing.assert_array_equal(p["2x2_exit_iters"], jiters)
    np.testing.assert_allclose(p["2x2_exit_poses"], jposes, rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_convert_sharded_state(run, mesh):
    # JAX's local_maps f32[T, C]: a rank keeps its tile's row, and the
    # gathered rows are JAX's array again
    d, p = run["data"], run["port"]
    tiles = d[f"jax_tiles_{mesh}"]
    assert p[f"{mesh}_convert_back"].shape == tiles.shape
    np.testing.assert_array_equal(p[f"{mesh}_convert_back"], tiles)
    np.testing.assert_array_equal(p[f"{mesh}_convert_tile"], tiles[0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replay_tracks_jax_and_dense(run, mesh):
    # the replay: poses within 5e-3 m of JAX's sharded replay and of the
    # port's dense one at every scan, the same map updates, maps within 1e-2
    d, p = run["data"], run["port"]
    jposes, jupd, _, jmaps, _ = run["jax"][(mesh, "gather")]
    dposes, dupd, dmaps = _dense_replay(d["traj"], d["pts"], d["valid"], CFG)
    poses, upd = p[f"{mesh}_gather_poses"], p[f"{mesh}_gather_updates"]
    assert upd.sum() > BOOT, upd              # the gate fired after the boot
    np.testing.assert_array_equal(upd, jupd)
    np.testing.assert_array_equal(upd, dupd)
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=5e-3)
    np.testing.assert_allclose(poses, dposes, rtol=0, atol=5e-3)
    assert np.abs(p[f"{mesh}_gather_maps"] - jmaps).max() < 1e-2
    assert np.abs(p[f"{mesh}_gather_maps"] - dmaps).max() < 1e-2
    # and it tracks: within a cell of the finest level of the truth
    err = np.linalg.norm(poses[:, :2] - d["traj"][:, :2], axis=1).max()
    assert err < CFG.map_resolution, err


def test_collectives_a_scan(run):
    # a scan runs sum(estimate_iterations) GN psums + the marks' pmax + the
    # halos' ppermute, also under the early exit (its iterations are
    # masked, not skipped); the 2x2 ranks ran 4 replays of 12 scans (and two
    # gathers each), 2 single steps, the roundtrip's 2 gathers and the
    # conversion's one
    per_scan = sum(CFG.estimate_iterations) + 2
    want = 4 * (N_SCANS * per_scan + 2) + 2 * per_scan + 3
    assert int(run["port"]["2x2_collectives"]) == want


def test_serving_knobs_are_ignored_as_in_jax(run):
    # serving_hector_config()'s knobs (onehot_bf16, match_subsample 4,
    # gn_damping 0.1, dense_free_fill, xy clamp 10 px, jump 1 m): JAX's
    # sharded step reads none of match_subsample, gn_damping and
    # dense_free_fill, and neither does the port's: the replay equals the
    # one with the three cleared bit for bit, and tracks JAX's sharded
    # replay under the same config within the file's tolerances
    p = run["port"]
    for key in ("poses", "updates", "iters", "maps"):
        np.testing.assert_array_equal(p[f"2x2_serving_{key}"],
                                      p[f"2x2_serving_cleared_{key}"],
                                      err_msg=key)
    jposes, jupd, _, jmaps, jiters = run["jax"][("2x2", "serving")]
    np.testing.assert_array_equal(p["2x2_serving_updates"], jupd)
    np.testing.assert_array_equal(p["2x2_serving_iters"], jiters)
    np.testing.assert_allclose(p["2x2_serving_poses"], jposes, rtol=0,
                               atol=5e-3)
    assert np.abs(p["2x2_serving_maps"] - jmaps).max() < 1e-2
    # the config is accepted where it used to be refused
    hector_sharded._check_cfg(CFG.overlay(SERVING))
