"""CoreSLAM's ops: slamnet_tpu_torch against the JAX package on the same
numpy inputs.

A 128-px hole map (the bench's 40 m at 3.2 px/m; 256 px at 6.4 in the
bench) and a 32-px obstacle map built from the loop log's scans, every
third beam (134), 256 Monte-Carlo candidates, a K = 8 x 8 x 8 correlative
grid.  JAX runs op by op (outside jit, as its own op tests do), so both
sides round each f32 operation once.  What may still differ is an ulp of
``cos`` / ``sin`` / ``atan2`` (the port rounds them once from float64, XLA
has its own approximations), which can move a pixel snap across a cell
edge.  Where a snap can flip, the test counts the flipped snaps, holds them
to at most 1 in 10^4 and holds everything else bit for bit: the integer
geometry (``rosetta_line_cells``, ``hole_ray_cells``), the correlative sums
and counts on JAX's headings, ``best_of`` on JAX's own Monte-Carlo
candidates, the sequential blend and the planted ties are exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core.geometry import csharp_trunc as jtrunc
from slamnet_tpu.ops import correlate as jcorr
from slamnet_tpu.ops import holemap as jhole
from slamnet_tpu.ops import obstacle as jobst
from slamnet_tpu.ops import rasterize as jras
from slamnet_tpu.ops import score as jscore
from slamnet_tpu_torch import replay
from slamnet_tpu_torch.ops import correlate, holemap, obstacle, rasterize, score

SIZE, OSIZE = 128, 32
SCALE, OSCALE = SIZE / 40.0, OSIZE / 40.0
FLIPS = 1e-4          # flipped snaps allowed, per snap


@pytest.fixture(scope="module")
def world():
    """A few loop-log scans (every third beam) and the maps they build."""
    log = replay.make_log(0)
    pts = replay.to_device(log, "cpu").points[:, ::3].numpy()
    valid = log.valid[:, ::3]
    hole = np.full(SIZE * SIZE, 32750, np.int32)
    obst = np.full((OSIZE, OSIZE), -5, np.int8)
    for t in range(0, 40, 4):
        hole = np.asarray(jhole.update_hole_map(
            jnp.asarray(hole), SIZE, SCALE, jnp.asarray(pts[t]),
            jnp.asarray(valid[t]), jnp.asarray(log.traj[t]), 2.0, 50))
        obst = np.asarray(jobst.update_obstacle_map(
            jnp.asarray(obst), OSIZE, OSCALE, jnp.asarray(pts[t]),
            jnp.asarray(valid[t]), jnp.asarray(log.traj[t]), 10))
    return log.traj, pts, valid, hole, obst


def _flips(a, b):
    return int((np.asarray(a) != np.asarray(b)).sum())


def _check_flips(n_diff, n_snaps, what):
    assert n_diff <= FLIPS * n_snaps, f"{what}: {n_diff} of {n_snaps}"


@pytest.mark.parametrize("seed", [0, 1])
def test_rosetta_line_cells_equal(seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(-5, 70, (300, 2)).astype(np.int32)
    e = rng.integers(-40, 110, (300, 2)).astype(np.int32)
    e[:20] = b[:20]                                   # zero-length beams
    e[20:40, 0] = b[20:40, 0]                         # vertical
    e[40:60] = b[40:60] + np.array([[7, 7]], np.int32)   # diagonal
    want = jras.rosetta_line_cells(jnp.asarray(b), jnp.asarray(e), 64, 128)
    got = rasterize.rosetta_line_cells(torch.from_numpy(b),
                                       torch.from_numpy(e), 64, 128)
    m = np.asarray(want[0].mask)
    np.testing.assert_array_equal(got[0].mask.numpy(), m)
    np.testing.assert_array_equal(got[0].flat.numpy()[m],
                                  np.asarray(want[0].flat)[m])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert m.sum() > 1000


@pytest.mark.parametrize("x1,y1", [(60, 64), (0, 127), (127, 3)])
def test_hole_ray_cells_equal(x1, y1):
    """Endpoints in, beyond and on the map's edges (ClipRay's branches), hit
    points before and past them (the V-profile's legs), zero-length
    profiles."""
    rng = np.random.default_rng(x1 + y1)
    n = 400
    x2 = rng.integers(-90, 220, n).astype(np.int32)
    y2 = rng.integers(-90, 220, n).astype(np.int32)
    xp = (x2 + rng.integers(-12, 12, n)).astype(np.int32)
    yp = (y2 + rng.integers(-12, 12, n)).astype(np.int32)
    xp[:10], yp[:10] = x2[:10], y2[:10]              # derrorv == 0
    x2[10:20] = x1                                  # vertical rays
    want = jras.hole_ray_cells(x1, y1, jnp.asarray(x2), jnp.asarray(y2),
                               jnp.asarray(xp), jnp.asarray(yp), 0, 65500,
                               SIZE, SIZE)
    got = rasterize.hole_ray_cells(
        torch.tensor(x1, dtype=torch.int32), torch.tensor(y1,
                                                          dtype=torch.int32),
        *(torch.from_numpy(a) for a in (x2, y2, xp, yp)), 0, 65500, SIZE,
        SIZE)
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.flat.numpy()[m], np.asarray(want.flat)[m])
    np.testing.assert_array_equal(got.pixval.numpy()[m],
                                  np.asarray(want.pixval)[m])
    assert m.sum() > 5000


def test_idiv_trunc_truncates_toward_zero():
    a = torch.tensor([7, -7, 7, -7, 0, 9], dtype=torch.int32)
    b = torch.tensor([2, 2, -2, -2, 3, 3], dtype=torch.int32)
    np.testing.assert_array_equal(rasterize.idiv_trunc(a, b).numpy(),
                                  [3, -3, -3, 3, 0, 3])
    np.testing.assert_array_equal(
        rasterize.idiv_trunc(-65500, b[:1]).numpy(),
        np.asarray(jras.idiv_trunc(jnp.int32(-65500), jnp.int32(2)))[None])


def _candidates(traj, t, n, seed):
    rng = np.random.default_rng(seed)
    c = traj[t] + rng.normal(0, 1, (n, 3)) * [0.1, 0.1, math.pi / 18]
    c[0] = traj[t]
    return c.astype(np.float32)


def _jax_snaps(poses, pts, scale):
    """JAX's score_candidates snap (slamnet_tpu/ops/score.py:48-55)."""
    poses, pts = jnp.asarray(poses), jnp.asarray(pts)
    px = poses[:, 0] * scale + 0.5
    py = poses[:, 1] * scale + 0.5
    c = jnp.cos(poses[:, 2]) * scale
    s = jnp.sin(poses[:, 2]) * scale
    X, Y = pts[:, 0][None, :], pts[:, 1][None, :]
    return (np.asarray(jtrunc(px[:, None] + c[:, None] * X - s[:, None] * Y)),
            np.asarray(jtrunc(py[:, None] + s[:, None] * X + c[:, None] * Y)))


@pytest.mark.parametrize("t", [12, 30])
def test_score_candidates_against_jax(world, t):
    traj, pts, valid, hole, _ = world
    cands = _candidates(traj, t, 256, t)
    js, jn = jscore.score_candidates(jnp.asarray(hole), SIZE, SCALE,
                                     jnp.asarray(pts[t]),
                                     jnp.asarray(valid[t]), jnp.asarray(cands))
    ts, tn = score.score_candidates(torch.from_numpy(hole), SIZE, SCALE,
                                    torch.from_numpy(pts[t]),
                                    torch.from_numpy(valid[t]),
                                    torch.from_numpy(cands))
    jx, jy = _jax_snaps(cands, pts[t], SCALE)
    tx, ty = score.candidate_pixels(torch.from_numpy(cands),
                                    torch.from_numpy(pts[t]), SCALE)
    flipped = (tx.numpy() != jx) | (ty.numpy() != jy)
    _check_flips(int(flipped.sum()), flipped.size, "score snaps")
    clean = ~flipped.any(axis=1)
    assert clean.sum() >= 250
    np.testing.assert_array_equal(ts.numpy()[clean], np.asarray(js)[clean])
    np.testing.assert_array_equal(tn.numpy()[clean], np.asarray(jn)[clean])
    assert ts.dtype == torch.int32 and int(tn.max()) > 100


def test_best_of_on_jax_candidates_is_jax_search(world):
    """JAX's monte_carlo_search draws its candidates from the key; the same
    candidate set through the port's best_of gives JAX's pose and sum."""
    traj, pts, valid, hole, _ = world
    for t, seed in ((12, 0), (30, 5), (38, 9)):
        key = jax.random.PRNGKey(seed)
        sp = jnp.asarray(traj[t] + np.float32([0.04, -0.03, 0.02]))
        want_pose, want_sum = jscore.monte_carlo_search(
            jnp.asarray(hole), SIZE, SCALE, jnp.asarray(pts[t]),
            jnp.asarray(valid[t]), sp, 0.1, math.pi / 18, 256, key)
        kxy, kth = jax.random.split(key)       # score.py:83-88
        d = jnp.concatenate([jax.random.normal(kxy, (256, 2)) * 0.1,
                             jax.random.normal(kth, (256, 1))
                             * (math.pi / 18)], axis=1).at[0].set(0.0)
        cands = np.asarray(sp[None, :] + d)
        pose, best = score.best_of(torch.from_numpy(cands),
                                   torch.from_numpy(hole), SIZE, SCALE,
                                   torch.from_numpy(pts[t]),
                                   torch.from_numpy(valid[t]))
        np.testing.assert_array_equal(pose.numpy(), np.asarray(want_pose))
        assert int(best) == int(want_sum)


def test_sample_candidates_distribution():
    sp = torch.tensor([20.0, 20.0, 0.3])
    g = torch.Generator().manual_seed(3)
    c = score.sample_candidates(sp, 0.1, math.pi / 18, 4096, g)
    assert c.shape == (4096, 3) and torch.equal(c[0], sp)
    d = (c[1:] - sp).double()
    np.testing.assert_allclose(d.mean(0).numpy(), 0.0, atol=4 * 0.18 / 64)
    np.testing.assert_allclose(d.std(0).numpy(), [0.1, 0.1, math.pi / 18],
                               rtol=0.05)


def test_ties_pick_the_first_and_out_of_bounds_is_int_max():
    """A planted tie: every candidate scores the same; the first wins, as the
    reference's strict-improvement update keeps it.  A candidate with no
    point in bounds scores int-max, and a set of only such candidates gives
    int-max."""
    size = 16
    hole = torch.full((size * size,), 7, dtype=torch.int32)
    pts = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    valid = torch.ones(2, dtype=torch.bool)
    cands = torch.tensor([[1000.0, 1000.0, 0.0], [5.0, 5.0, 0.0],
                          [5.0, 5.0, 0.0], [5.5, 5.0, 0.0]])
    pose, best = score.best_of(cands, hole, size, 1.0, pts, valid)
    assert torch.equal(pose, cands[1]) and int(best) == 14
    far = cands[:1].repeat(3, 1)
    pose, best = score.best_of(far, hole, size, 1.0, pts, valid)
    assert int(best) == 2**31 - 1 and torch.equal(pose, far[0])
    s, n = score.score_candidates(hole, size, 1.0, pts, valid, far)
    assert int(n.max()) == 0
    assert int(score.reference_score(s, n, 2)[0]) == 2**31 - 1
    want = jscore.reference_score(jnp.asarray(s.numpy()),
                                  jnp.asarray(n.numpy()), 2)
    assert int(want[0]) == 2**31 - 1
    # the correlative search on the same contract: nothing in bounds
    p, b = correlate.correlative_search(hole, size, 1.0, pts, valid,
                                        far[0], 4, 3, 0.1)
    assert int(b) == 2**31 - 1 and torch.isfinite(p).all()


@pytest.mark.parametrize("t", [12, 30])
def test_correlative_scores_exact(world, t):
    traj, pts, valid, hole, _ = world
    sp = (traj[t] + np.float32([0.05, -0.04, 0.03])).astype(np.float32)
    thetas = jnp.asarray(sp[2]) + jnp.linspace(-0.3, 0.3, 8)
    js, jn = jcorr.correlative_scores(jnp.asarray(hole), SIZE, SCALE,
                                      jnp.asarray(pts[t]),
                                      jnp.asarray(valid[t]), jnp.asarray(sp),
                                      thetas, 8)
    ts, tn = correlate.correlative_scores(
        torch.from_numpy(hole), SIZE, SCALE, torch.from_numpy(pts[t]),
        torch.from_numpy(valid[t]), torch.from_numpy(sp),
        torch.from_numpy(np.asarray(thetas)), 8)
    assert ts.shape == tn.shape == (8, 8, 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # JAX's f32 recombination rounds sums above 2^24; the port's equal them
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn.max()) > 100 and int(ts.max()) > 2**24 // 8


def test_correlative_search_pose_bit_for_bit(world):
    traj, pts, valid, hole, _ = world
    for t, off in ((12, (0.05, -0.04, 0.03)), (30, (-0.1, 0.08, -0.05))):
        sp = (traj[t] + np.float32(off)).astype(np.float32)
        want = jcorr.correlative_search(jnp.asarray(hole), SIZE, SCALE,
                                        jnp.asarray(pts[t]),
                                        jnp.asarray(valid[t]),
                                        jnp.asarray(sp), 8, 8, 0.3)
        got = correlate.correlative_search(
            torch.from_numpy(hole), SIZE, SCALE, torch.from_numpy(pts[t]),
            torch.from_numpy(valid[t]), torch.from_numpy(sp), 8, 8, 0.3)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
    th = correlate.theta_grid(torch.tensor(0.25), 8, 0.3).numpy()
    j = np.asarray(jnp.float32(0.25) + jnp.linspace(-0.3, 0.3, 8))
    assert np.abs(th - j).max() <= 1e-7


HOLE_FNS = [("line", jhole.update_hole_map, holemap.update_hole_map, ()),
            ("dense", jhole.update_hole_map_dense,
             holemap.update_hole_map_dense, (64,)),
            ("sequential", jhole.update_hole_map_sequential_blend,
             holemap.update_hole_map_sequential_blend, ())]


@pytest.mark.parametrize("name,jf,tf,extra", HOLE_FNS,
                         ids=[h[0] for h in HOLE_FNS])
def test_hole_map_updates(world, name, jf, tf, extra):
    """Each update from the built map at three poses (one off the scan's
    truth).  The sequential blend (the bit-exact oracle) is exact; the line
    and dense updates may differ only at flipped snaps, at most 1 cell in
    10^4, and the line update's composed blend by one gray level at most
    where the f32 pow could differ (it does not here)."""
    traj, pts, valid, hole, _ = world
    for t, off in ((12, (0, 0, 0)), (30, (0.3, -0.2, 0.1)), (38, (0, 0, 0))):
        pose = (traj[t] + np.float32(off)).astype(np.float32)
        want = np.asarray(jf(jnp.asarray(hole), SIZE, SCALE,
                             jnp.asarray(pts[t]), jnp.asarray(valid[t]),
                             jnp.asarray(pose), 2.0, 50, *extra))
        got = tf(torch.from_numpy(hole), SIZE, SCALE, torch.from_numpy(pts[t]),
                 torch.from_numpy(valid[t]), torch.from_numpy(pose), 2.0, 50,
                 *extra).numpy()
        assert got.dtype == np.int32
        if name == "sequential":
            np.testing.assert_array_equal(got, want)
        else:
            _check_flips(_flips(got, want), got.size, f"{name} hole map")
        assert (got != hole).sum() > 500


OBST_FNS = [("line", jobst.update_obstacle_map, obstacle.update_obstacle_map,
             ()),
            ("dense", jobst.update_obstacle_map_dense,
             obstacle.update_obstacle_map_dense, (64,))]


@pytest.mark.parametrize("name,jf,tf,extra", OBST_FNS,
                         ids=[o[0] for o in OBST_FNS])
def test_obstacle_map_updates(world, name, jf, tf, extra):
    traj, pts, valid, _, obst = world
    for t, off in ((12, (0, 0, 0)), (30, (0.3, -0.2, 0.1))):
        pose = (traj[t] + np.float32(off)).astype(np.float32)
        want = np.asarray(jf(jnp.asarray(obst), OSIZE, OSCALE,
                             jnp.asarray(pts[t]), jnp.asarray(valid[t]),
                             jnp.asarray(pose), 10, *extra))
        got = tf(torch.from_numpy(obst), OSIZE, OSCALE,
                 torch.from_numpy(pts[t]), torch.from_numpy(valid[t]),
                 torch.from_numpy(pose), 10, *extra).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
        assert (got != obst).sum() > 20


def test_robot_outside_the_map_leaves_both_maps(world):
    traj, pts, valid, hole, obst = world
    p, v = torch.from_numpy(pts[12]), torch.from_numpy(valid[12])
    for pose in ([-2.0, 20.0, 0.3], [20.0, 45.0, 0.0]):
        pose = torch.tensor(pose)
        h, o = torch.from_numpy(hole), torch.from_numpy(obst)
        for fn in (holemap.update_hole_map, holemap.update_hole_map_dense,
                   holemap.update_hole_map_sequential_blend):
            assert torch.equal(fn(h, SIZE, SCALE, p, v, pose, 2.0, 50), h)
        for fn in (obstacle.update_obstacle_map,
                   obstacle.update_obstacle_map_dense):
            assert torch.equal(fn(o, OSIZE, OSCALE, p, v, pose, 10), o)
