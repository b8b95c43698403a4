"""K7, CoreSLAM's line-mode map update (``csrc/coreslam_map.cu``), held on
the CPU.

The kernel runs only on a card.  Here: the wrappers take the plain path
for CPU tensors and count no launch; the kernel's arithmetic, written out
in Python below as the kernel does it (the pose frame op by op in f32, the
reference's integer recurrences step by step, the u64 visit words, the
blend from ``decay_table``), equals ``update_hole_map_plain`` and
``update_obstacle_map_plain`` bit for bit on the loop log's scans at the
benchmark's 256-px / 64-px maps, with the robot near every edge so that
ClipRay and the walks' exits run; the wrappers' input checks.  One test
holds the kernel itself against the plain path on the card and skips
without one.
"""
import math

import numpy as np
import pytest
import torch

from slamnet_tpu_torch import replay
from slamnet_tpu_torch.ops import _build, holemap, obstacle

SIZE, OSIZE = 256, 64                    # coreslam_sim256
SCALE, OSCALE = SIZE / 40.0, OSIZE / 40.0
HOLE_WIDTH, QUALITY, MAX_HITS = 2.0, 50, 10
F32 = np.float32
# (scan, pose): on the loop, and near each edge and corner of the map
POSES = [(12, None), (200, None), (40, (0.3, 20.0, 0.4)),
         (90, (39.5, 2.0, -2.5)), (150, (20.0, 39.6, 1.2)),
         (300, (0.05, 0.05, 0.8))]


@pytest.fixture(scope="module")
def world():
    """The loop log's clouds with a few beams invalid, and maps built by
    the plain path over 30 scans."""
    log = replay.make_log(0)
    dl = replay.to_device(log, "cpu")
    pts, valid = dl.points, dl.valid.clone()
    valid[:, 7::37] = False
    hole = torch.full((SIZE * SIZE,), 32750, dtype=torch.int32)
    obst = torch.full((OSIZE, OSIZE), -5, dtype=torch.int8)
    for t in range(0, 60, 2):
        pose = torch.from_numpy(log.traj[t])
        hole = holemap.update_hole_map_plain(hole, SIZE, SCALE, pts[t],
                                             valid[t], pose, HOLE_WIDTH,
                                             QUALITY)
        obst = obstacle.update_obstacle_map_plain(obst, OSIZE, OSCALE, pts[t],
                                                  valid[t], pose, MAX_HITS)
    return log.traj, pts, valid, hole, obst


def _pose(traj, t, p):
    return torch.tensor(traj[t] if p is None else p, dtype=torch.float32)


# ---- the kernel's arithmetic, step by step (csrc/coreslam_map.cu) --------
def _frame(pose, scale):
    """pose_frame: (px, py, c, s, x1, y1) in f32, each operation rounded."""
    sc = F32(scale)
    px = F32(pose[0]) * sc + F32(0.5)
    py = F32(pose[1]) * sc + F32(0.5)
    th = float(F32(pose[2]))
    return (px, py, F32(math.cos(th)) * sc, F32(math.sin(th)) * sc,
            int(np.trunc(px)), int(np.trunc(py)))


def _cdiv(a, b):
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _sign(v):
    return (v > 0) - (v < 0)


def _clip_ray(size, xyc, yxc, xy, yx):
    if xyc < 0:
        if xyc == xy:
            return False, xyc, yxc
        yxc += _cdiv((yxc - yx) * (-xyc), xyc - xy)
        xyc = 0
    if xyc >= size:
        if xyc == xy:
            return False, xyc, yxc
        yxc += _cdiv((yxc - yx) * (size - 1 - xyc), xyc - xy)
        xyc = size - 1
    return True, xyc, yxc


def _hole_walk(size, x1, y1, x2, y2, xp, yp):
    """hole_walk_kernel's recurrence: [(pixel, value)] of one beam."""
    ok, x2c, y2c = _clip_ray(size, x2, y2, x1, y1)
    if not ok:
        return []
    ok, y2c, x2c = _clip_ray(size, y2c, x2c, y1, x1)
    if not ok:
        return []
    dx, dy = abs(x2 - x1), abs(y2 - y1)
    dxc, dyc = abs(x2c - x1), abs(y2c - y1)
    incx, incy = _sign(x2 - x1), _sign(y2 - y1) * size
    sincv = -1
    if dx > dy:
        derrorv = abs(xp - x2)
    else:
        dx = dy
        dxc, dyc = dyc, dxc
        incx, incy = incy, incx
        derrorv = abs(yp - y2)
    if derrorv == 0:
        return []
    error, horiz, diago = 2 * dyc - dxc, 2 * dyc, 2 * (dyc - dxc)
    errorv = derrorv // 2
    incv = _cdiv(-65500, derrorv)
    incerrorv = -65500 - derrorv * incv
    ptr, pixval, out = y1 * size + x1, 65500, []
    for x in range(dxc + 1):
        if x > dx - 2 * derrorv:
            if x <= dx - derrorv:
                pixval += incv
                errorv += incerrorv
                if errorv > derrorv:
                    pixval += sincv
                    errorv -= derrorv
            else:
                pixval -= incv
                errorv -= incerrorv
                if errorv < 0:
                    pixval -= sincv
                    errorv += derrorv
        out.append((ptr, pixval))
        if error > 0:
            ptr += incy
            error += diago
        else:
            error += horiz
        ptr += incx
    return out


def _blend(hole, words, decay, n):
    """hole_blend_kernel over every pixel: decode the u64 words, blend."""
    vsum = words.astype(np.uint32).view(np.int32).astype(np.int64)
    k = ((words - vsum.astype(np.uint64)) >> np.uint64(32)).astype(np.int64)
    hit = k > 0
    vbar = vsum[hit].astype(F32) / k[hit].astype(F32)
    d = decay[np.minimum(k[hit], n)]
    out = hole.copy()
    out[hit] = np.floor(d * (hole[hit].astype(F32) - vbar) + vbar).astype(
        np.int32)
    return out


def hole_twin(hole, size, scale, points, valid, pose, hole_width, quality):
    px, py, c, s, x1, y1 = _frame(pose.numpy(), scale)
    if not (0 <= x1 < size and 0 <= y1 < size):
        return hole.clone()
    half = F32(hole_width * scale / 2.0)
    words = np.zeros(size * size, np.uint64)
    pts, val = points.numpy(), valid.numpy()
    for b in range(pts.shape[0]):
        if not val[b]:
            continue
        X, Y = F32(pts[b, 0]), F32(pts[b, 1])
        x2p, y2p = c * X - s * Y, s * X + c * Y
        xp, yp = int(np.trunc(px + x2p)), int(np.trunc(py + y2p))
        dist = F32(math.sqrt(float(x2p * x2p + y2p * y2p)))
        if not dist > F32(1e-6):
            continue
        ext = F32(1.0) + half / max(dist, F32(1e-6))
        x2, y2 = int(np.trunc(px + x2p * ext)), int(np.trunc(py + y2p * ext))
        for ptr, v in _hole_walk(size, x1, y1, x2, y2, xp, yp):
            if 0 <= ptr < size * size:
                words[ptr] += np.uint64(((1 << 32) + v) % (1 << 64))
    n = pts.shape[0]
    decay = holemap.decay_table(quality, n, torch.device("cpu")).numpy()
    return torch.from_numpy(_blend(hole.numpy(), words, decay, n))


def obstacle_twin(obst, size, scale, points, valid, pose, max_hits):
    px, py, c, s, x1, y1 = _frame(pose.numpy(), scale)
    if not (0 <= x1 < size and 0 <= y1 < size):
        return obst.clone()
    hits = np.zeros((size, size), np.int64)
    passed = np.zeros((size, size), bool)
    pts, val = points.numpy(), valid.numpy()
    for b in range(pts.shape[0]):
        if not val[b]:
            continue
        X, Y = F32(pts[b, 0]), F32(pts[b, 1])
        x2, y2 = int(np.trunc(px + c * X - s * Y)), int(np.trunc(py + s * X
                                                                 + c * Y))
        dx, sx = abs(x2 - x1), _sign(x2 - x1)
        dy, sy = abs(y2 - y1), _sign(y2 - y1)
        err = _cdiv(dx if dx > dy else -dy, 2)
        x, y = x1, y1
        while 0 <= x < size and 0 <= y < size:
            if x == x2 and y == y2:
                hits[y, x] += 1
                break
            passed[y, x] = True
            e2 = err
            if e2 > -dx:
                err -= dy
                x += sx
            if e2 < dy:
                err += dx
                y += sy
    v0 = obst.numpy().astype(np.int64)
    v1 = np.minimum(v0 + hits, np.maximum(v0, max_hits))
    v2 = np.where(passed & (v1 < 0), v1 + 1,
                  np.where(passed & (v1 > 0), v1 - 1, v1))
    return torch.from_numpy(v2.astype(np.int8))


# ---- the tests ----------------------------------------------------------
def test_cpu_takes_the_plain_path_and_counts_no_launch(world):
    traj, pts, valid, hole, obst = world
    c0 = _build.kernel_launches()
    for t, p in POSES[:3]:
        pose = _pose(traj, t, p)
        assert torch.equal(
            holemap.update_hole_map(hole, SIZE, SCALE, pts[t], valid[t], pose,
                                    HOLE_WIDTH, QUALITY),
            holemap.update_hole_map_plain(hole, SIZE, SCALE, pts[t], valid[t],
                                          pose, HOLE_WIDTH, QUALITY))
        assert torch.equal(
            obstacle.update_obstacle_map(obst, OSIZE, OSCALE, pts[t], valid[t],
                                         pose, MAX_HITS),
            obstacle.update_obstacle_map_plain(obst, OSIZE, OSCALE, pts[t],
                                               valid[t], pose, MAX_HITS))
    assert _build.kernel_launches() == c0
    # no CPU test counts a K7 launch: the stand-in replays set theirs back
    assert all(c0[k] == 0 for k in ("K7_hole_walk", "K7_hole_blend",
                                    "K7_obstacle"))


def test_decay_table_is_blend_visits_pow():
    """The table is float64 beta^k rounded once to f32 for k = 0..400, and
    the kernel's blend from it gives ``blend_visits``'s pixels for every k,
    including pixels whose values sum below zero."""
    n = 400
    table = holemap.decay_table(QUALITY, n, torch.device("cpu")).numpy()
    beta = (256.0 - QUALITY) / 256.0
    want = np.array([F32(np.float64(beta) ** k) for k in range(n + 1)])
    np.testing.assert_array_equal(table, want)
    rng = np.random.default_rng(3)
    k = np.repeat(np.arange(n + 1), 40)
    vsum = (rng.integers(-200, 65501, k.size) * k).astype(np.int32)
    hole = rng.integers(0, 65501, k.size).astype(np.int32)
    got = _blend(hole, k.astype(np.uint64) * np.uint64(1 << 32)
                 + vsum.astype(np.int64).astype(np.uint64), table, n)
    blend = holemap.blend_visits(torch.from_numpy(hole),
                                 torch.from_numpy(k.astype(np.int32)),
                                 torch.from_numpy(vsum), QUALITY).numpy()
    np.testing.assert_array_equal(got, blend)


@pytest.mark.parametrize("case", range(len(POSES)))
def test_hole_walk_and_blend_equal_the_plain_path(world, case):
    traj, pts, valid, hole, _ = world
    t, p = POSES[case]
    pose = _pose(traj, t, p)
    want = holemap.update_hole_map_plain(hole, SIZE, SCALE, pts[t], valid[t],
                                         pose, HOLE_WIDTH, QUALITY)
    got = hole_twin(hole, SIZE, SCALE, pts[t], valid[t], pose, HOLE_WIDTH,
                    QUALITY)
    assert torch.equal(got, want)
    assert int((want != hole).sum()) > 200


@pytest.mark.parametrize("case", range(len(POSES)))
def test_obstacle_walk_equals_the_plain_path(world, case):
    traj, pts, valid, _, obst = world
    t, p = POSES[case]
    pose = _pose(traj, t, p)
    fresh = torch.full_like(obst, -5)
    for base in (obst, fresh):
        want = obstacle.update_obstacle_map_plain(base, OSIZE, OSCALE, pts[t],
                                                  valid[t], pose, MAX_HITS)
        got = obstacle_twin(base, OSIZE, OSCALE, pts[t], valid[t], pose,
                            MAX_HITS)
        assert torch.equal(got, want)
    assert int((want != fresh).sum()) > 20


def test_robot_outside_and_no_valid_beam(world):
    """A robot pixel outside the map and a scan with no valid beam leave
    both maps as they were, in the plain path and in the twin."""
    traj, pts, valid, hole, obst = world
    none = torch.zeros_like(valid[12])
    for pose, v in ((torch.tensor([-2.0, 20.0, 0.3]), valid[12]),
                    (torch.tensor([20.0, 41.0, 0.0]), valid[12]),
                    (_pose(traj, 12, None), none)):
        for fn in (holemap.update_hole_map_plain, hole_twin):
            assert torch.equal(fn(hole, SIZE, SCALE, pts[12], v, pose,
                                  HOLE_WIDTH, QUALITY), hole)
        for fn in (obstacle.update_obstacle_map_plain, obstacle_twin):
            assert torch.equal(fn(obst, OSIZE, OSCALE, pts[12], v, pose,
                                  MAX_HITS), obst)


def test_the_kernel_inputs_are_checked(world):
    traj, pts, valid, hole, obst = world
    pose = _pose(traj, 12, None)
    assert holemap.check_hole_inputs(hole, SIZE, pts[12], valid[12],
                                     pose) == 400
    assert obstacle.check_obstacle_inputs(obst, OSIZE, pts[12], valid[12],
                                          pose) == 400
    bad_holes = (torch.zeros(2 * SIZE * SIZE, dtype=torch.int32)[::2],
                 hole.to(torch.int64), hole[:-1])
    for h in bad_holes:
        with pytest.raises(ValueError, match="K7 hole map hole_map"):
            holemap.check_hole_inputs(h, SIZE, pts[12], valid[12], pose)
    for o in (obst.t(), obst.to(torch.int32), obst[:-1]):
        with pytest.raises(ValueError, match="K7 obstacle map obstacle_map"):
            obstacle.check_obstacle_inputs(o, OSIZE, pts[12], valid[12], pose)
    with pytest.raises(ValueError, match="valid"):
        holemap.check_hole_inputs(hole, SIZE, pts[12], valid[12].int(), pose)
    with pytest.raises(ValueError, match="pose"):
        obstacle.check_obstacle_inputs(obst, OSIZE, pts[12], valid[12],
                                       pose.double())


@pytest.mark.card
def test_the_kernels_equal_the_plain_path_on_the_card(world):
    """K7 against the plain path on the card, bit for bit, one launch
    count a call; runs where a card is present (``chip_smoke.py`` phase 38
    covers a whole job)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traj, pts, valid, hole, obst = world
    dev = torch.device("cuda")
    c0 = _build.kernel_launches()
    for t, p in POSES:
        args = (pts[t].to(dev), valid[t].to(dev), _pose(traj, t, p).to(dev))
        hk = holemap.update_hole_map(hole.to(dev), SIZE, SCALE, *args,
                                     HOLE_WIDTH, QUALITY)
        hp = holemap.update_hole_map_plain(hole.to(dev), SIZE, SCALE, *args,
                                           HOLE_WIDTH, QUALITY)
        ok = obstacle.update_obstacle_map(obst.to(dev), OSIZE, OSCALE, *args,
                                          MAX_HITS)
        op = obstacle.update_obstacle_map_plain(obst.to(dev), OSIZE, OSCALE,
                                                *args, MAX_HITS)
        assert torch.equal(hk, hp) and torch.equal(ok, op)
    got = _build.kernel_launches()
    rose = {k: got[k] - c0[k] for k in got if got[k] != c0[k]}
    assert rose == dict.fromkeys(
        ("K7_hole_walk", "K7_hole_blend", "K7_obstacle"), len(POSES))
