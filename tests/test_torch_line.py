"""K4's plain version (the Bresenham line update) against the JAX package.

* ``ops/rasterize.py::hector_line_cells`` equals JAX's closed form and the
  step-by-step golden walk (``tests/golden.py``) in every octant: integer
  math, so equal.
* ``ops/logodds.py::update_occupancy`` equals JAX's ``update_occupancy``
  cell for cell.  Endpoints are rounded from ``cos``/``sin`` of the pose, and
  torch's and XLA's may differ in the last bit: a beam whose rounded
  endpoint moves is named, and only its cells may differ.
* the plain mark-and-apply equals the TPU kernel K4
  (``occupancy_scatter_pallas``, interpret mode) fed the same cells.
* ``ops/line.py``'s wrappers update every level in place, gated, equal to
  JAX's ``hector.update_maps`` with ``dense_free_fill=False``, and refuse bad
  inputs on any device.
* the kernel's tiling: ``tile_walk`` (the kernel's per-(beam, tile)
  k-interval and restarted recurrence) gives every cell of every walk in
  exactly one tile, in walk order, with the walk's own error term; the work
  items cover every cell once; and the tiled mark-and-apply over the work
  list's block shares equals the plain version bit for bit.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.ops import logodds as jlogodds
from slamnet_tpu.ops import rasterize as jrasterize
from slamnet_tpu.ops.pallas_scatter import occupancy_scatter_pallas
from slamnet_tpu_torch.core.geometry import dotnet_round
from slamnet_tpu_torch.ops import fill, line, logodds, rasterize
from slamnet_tpu_torch.replay import fixed_config

LOF = float(np.log(0.4 / 0.6))
LOO = float(np.log(0.9 / 0.1))
SMALL = dict(num_levels=2, map_size=128, map_resolution=0.3125,
             estimate_iterations=(5, 4))
W = 64
BEGIN = (30, 33)
# every octant and both diagonals, the axes, begin == end, and ends outside
# the map on every side
ENDS = [(50, 40), (40, 50), (20, 50), (10, 40), (10, 25), (20, 10), (40, 12),
        (55, 20), (50, 53), (10, 13), (45, 33), (30, 60), (5, 33), (30, 2),
        (30, 33), (31, 33), (90, 40), (-12, 20), (35, 70), (40, -5)]


def _cells(ends):
    begin = np.broadcast_to(np.asarray(BEGIN, np.int32), (len(ends), 2))
    end = np.asarray(ends, np.int32)
    got = rasterize.hector_line_cells(torch.from_numpy(begin.copy()),
                                      torch.from_numpy(end), W, W)
    want = jrasterize.hector_line_cells(jnp.asarray(begin), jnp.asarray(end),
                                        W, W)
    return got, want


def test_hector_line_cells_match_jax_and_golden():
    got, want = _cells(ENDS)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    np.testing.assert_array_equal(got.flat.numpy()[m], np.asarray(want.flat)[m])
    for i, end in enumerate(ENDS):
        cells = list(got.flat.numpy()[i][m[i]])
        if end == BEGIN:
            assert cells == []              # skipped (OccGridMap.cs:137)
        elif 0 <= end[0] < W and 0 <= end[1] < W:
            assert cells == golden.hector_bresenham_free_cells(BEGIN, end, W), \
                end
        else:                               # geometry only, as in JAX
            assert len(cells) == max(abs(end[0] - BEGIN[0]),
                                     abs(end[1] - BEGIN[1]))


def test_hector_line_cells_batched_rows_equal_single():
    # a leading instance axis: each row as the unbatched call computes it
    got, _ = _cells(ENDS)
    begin = torch.tensor(BEGIN, dtype=torch.int32).expand(2, len(ENDS), 2)
    end = torch.tensor(ENDS, dtype=torch.int32).expand(2, -1, -1)
    both = rasterize.hector_line_cells(begin, end, W, W)
    for row in range(2):
        assert torch.equal(both.mask[row], got.mask)
        assert torch.equal(both.flat[row][got.mask], got.flat[got.mask])


def _case(seed, width, n=300, invalid_frac=0.1):
    """Random map (some cells above the cap) and a room-like scan; some beams
    run past the map edge."""
    rng = np.random.default_rng(seed)
    maps = rng.uniform(-3.0, 3.0, width * width).astype(np.float32)
    maps[rng.random(width * width) < 0.05] = 55.0
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = (0.3 * width / 3.2) * (1.0 + 0.6 * np.sin(3 * ang + seed)) \
        + rng.uniform(-0.05, 0.05, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    valid = rng.random(n) >= invalid_frac
    pose = np.array([width / 6.4 + 0.3, width / 6.4 - 0.2, 0.4 + seed],
                    np.float32)
    return maps, pts, valid, pose


def _ends(pts, pose, scale, rnd, cos, sin):
    c, s = cos(pose[2]), sin(pose[2])
    ex = (c * pts[:, 0] - s * pts[:, 1] + pose[0]) * scale
    ey = (s * pts[:, 0] + c * pts[:, 1] + pose[1]) * scale
    return np.stack([np.asarray(rnd(ex)), np.asarray(rnd(ey))], -1)


def _both(maps, pts, valid, pose, width, scale=3.2):
    want = np.asarray(jlogodds.update_occupancy(
        jnp.asarray(maps), width, jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(pose), jnp.zeros(2, jnp.float32), scale, LOF, LOO))
    got = logodds.update_occupancy(
        torch.from_numpy(maps), width, torch.from_numpy(pts),
        torch.from_numpy(valid), torch.from_numpy(pose), torch.zeros(2), scale,
        LOF, LOO).numpy()
    return got, want


def _assert_equal_but_moved_beams(got, want, pts, valid, pose, width,
                                  scale=3.2):
    """Equal cell for cell, except on the lines of beams whose rounded
    endpoint differs between torch's and XLA's cos/sin (named)."""
    tp = torch.from_numpy(pts)
    t_end = _ends(tp, torch.from_numpy(pose), scale, lambda x: torch.round(x),
                  torch.cos, torch.sin)
    j_end = _ends(jnp.asarray(pts), jnp.asarray(pose), scale, jnp.round,
                  jnp.cos, jnp.sin)
    moved = np.nonzero(valid & (t_end != j_end).any(axis=1))[0]
    assert len(moved) <= 2, f"beams {moved} round to other endpoints"
    allowed = np.zeros(width * width, bool)
    begin = np.asarray(np.round(np.asarray(pose[:2]) * scale), np.int32)
    for b in moved:                     # named: only these beams' cells
        for end in (t_end[b], j_end[b]):
            cells = golden.hector_bresenham_free_cells(
                tuple(begin), tuple(int(v) for v in end), width)
            allowed[[c for c in cells if 0 <= c < width * width]] = True
            if 0 <= end[0] < width and 0 <= end[1] < width:
                allowed[end[1] * width + end[0]] = True
    diff = got != want
    assert not (diff & ~allowed).any(), np.nonzero(diff & ~allowed)[0][:10]


@pytest.mark.parametrize("width,seed", [(64, 0), (64, 1), (128, 2), (128, 3)])
def test_update_occupancy_matches_jax(width, seed):
    maps, pts, valid, pose = _case(seed, width)
    got, want = _both(maps, pts, valid, pose, width)
    _assert_equal_but_moved_beams(got, want, pts, valid, pose, width)
    assert (got - maps < 0).sum() > 50           # free cells were marked
    assert (got - maps > 0).sum() > 20           # endpoints were marked


def test_update_occupancy_no_beam_and_the_cap():
    maps, pts, valid, pose = _case(4, 64, invalid_frac=0.0)
    got, want = _both(maps, pts, np.zeros(len(pts), bool), pose, 64)
    np.testing.assert_array_equal(got, maps)
    np.testing.assert_array_equal(want, maps)
    capped = np.full_like(maps, 50.0)            # every cell at the cap
    got, want = _both(capped, pts, valid, pose, 64)
    _assert_equal_but_moved_beams(got, want, pts, valid, pose, 64)
    assert not (got > 50.0).any()                # occupied cells stay
    assert (got < 50.0).any()                    # free cells still decrease


@pytest.mark.parametrize("seed", [5, 6])
def test_mark_and_apply_matches_pallas_scatter(seed):
    # K4's plain version against the TPU kernel fed the same cells: the free
    # cells of every counted beam and its endpoint, above-cap cells included
    width, scale = 128, 3.2
    maps, pts, valid, pose = _case(seed, width)
    got = logodds.update_occupancy(
        torch.from_numpy(maps), width, torch.from_numpy(pts),
        torch.from_numpy(valid), torch.from_numpy(pose), torch.zeros(2), scale,
        LOF, LOO).numpy()
    end = _ends(torch.from_numpy(pts), torch.from_numpy(pose), scale,
                lambda x: torch.round(x).to(torch.int32), torch.cos,
                torch.sin).astype(np.int32)
    begin = np.round(pose[:2] * scale).astype(np.int32)
    in_map = ((end >= 0) & (end < width)).all(axis=1)
    beam_ok = valid & in_map & (end != begin).any(axis=1)
    cells = rasterize.hector_line_cells(
        torch.from_numpy(np.broadcast_to(begin, end.shape).copy()),
        torch.from_numpy(end), width, width)
    fmask = cells.mask.numpy() & beam_ok[:, None]
    want = np.asarray(occupancy_scatter_pallas(
        jnp.asarray(maps), jnp.asarray(np.where(fmask, cells.flat.numpy(), 0)),
        jnp.asarray(fmask), jnp.asarray(np.where(
            beam_ok, end[:, 1] * width + end[:, 0], 0).astype(np.int32)),
        jnp.asarray(beam_ok), LOF, LOO, 50.0, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (maps >= 50.0)[got > maps].sum() == 0  # the cap held


def _level_args(seed=7):
    cfg = fixed_config(**SMALL)
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, cfg.total_cells).astype(np.float32)
    base[rng.random(cfg.total_cells) < 0.05] = 55.0
    _, pts, valid, _ = _case(seed, 128)
    pose = np.array([19.7, 20.4, 0.3], np.float32)
    return cfg, base, pts, valid, pose


def test_update_maps_line_all_levels_matches_jax_update_maps():
    # the K4 wrapper on CPU tensors: every level, in place, gated, uncounted
    cfg, base, pts, valid, pose = _level_args()
    jcfg = JHectorConfig(**SMALL)
    want = np.asarray(jhector.update_maps(
        jnp.asarray(base), JScan(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.zeros(3, jnp.float32)),
        jnp.asarray(pose), jcfg))
    maps = torch.from_numpy(base.copy())
    args = (torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(pose), torch.zeros(3))
    before = line.update_maps_line.launches
    out = line.update_maps_line(maps, *args, torch.tensor(True), cfg)
    assert out is maps and line.update_maps_line.launches == before
    for off, w, res in zip(cfg.level_offsets, cfg.level_sizes,
                           cfg.level_resolutions):
        sl = slice(off, off + w * w)
        _assert_equal_but_moved_beams(maps.numpy()[sl], want[sl], pts, valid,
                                      pose, w, 1.0 / res)
    again = maps.clone()
    line.update_maps_line(maps, *args, torch.tensor(False), cfg)
    assert torch.equal(maps, again)               # gated: bit for bit


POSES = np.array([[19.7, 20.4, 0.3], [18.0, 22.0, -1.0], [21.0, 19.0, 2.5],
                  [20.2, 20.0, 0.0]], np.float32)


def _batch_plain_case(b):
    # the batched plain version is the per-instance one where fire is set
    # and the identity elsewhere, bit for bit; the CPU wrapper takes it
    cfg, _, pts, valid, _ = _level_args()
    c = cfg.total_cells
    rng = np.random.default_rng(8)
    base = torch.from_numpy(rng.uniform(-3.0, 3.0, b * c).astype(np.float32))
    fire = torch.tensor([True, False, True, True][:b])
    poses = torch.from_numpy(POSES[:b].copy())
    p = torch.from_numpy(np.stack([pts * (1.0 + 0.05 * i) for i in range(b)]))
    v = torch.from_numpy(np.stack([valid] * b))
    zero = torch.zeros(b, 3)
    got = line.update_maps_line_batch_plain(base, p, v, poses, zero, fire, cfg)
    for i in range(b):
        one = line.update_maps_line_plain(base[i * c:(i + 1) * c], p[i], v[i],
                                          poses[i], zero[i], fire[i], cfg)
        assert torch.equal(got[i * c:(i + 1) * c], one), i
        assert fire[i] or torch.equal(one, base[i * c:(i + 1) * c])
    assert not torch.equal(got, base)
    maps = base.clone()
    before = line.update_maps_line_batch.launches
    out = line.update_maps_line_batch(maps, p, v, poses, zero, fire, cfg)
    assert out is maps and torch.equal(maps, got)
    assert line.update_maps_line_batch.launches == before


def test_update_maps_line_batch_plain_equals_per_instance():
    _batch_plain_case(4)


@pytest.mark.parametrize("b", [1, 3])
def test_update_maps_line_batch_plain_equals_per_instance_at_b(b):
    _batch_plain_case(b)


def _refusals():
    cfg = fixed_config(**SMALL)
    c = cfg.total_cells
    maps, marks = torch.zeros(c), torch.zeros(c, dtype=torch.uint8)
    pts, v = torch.zeros(50, 2), torch.ones(50, dtype=torch.bool)
    pose, yes = torch.zeros(3), torch.tensor(True)
    bm, bk = torch.zeros(4 * c), torch.zeros(4 * c, dtype=torch.uint8)
    bp, bv = torch.zeros(4, 50, 2), torch.ones(4, 50, dtype=torch.bool)
    bpose, fire = torch.zeros(4, 3), torch.ones(4, dtype=torch.bool)
    return {
        # K4 takes no global scratch: a marks tensor in the arguments is
        # refused, whatever its dtype or size
        "marks_dtype": (TypeError, "positional", lambda: line.update_maps_line(
            maps, marks.to(torch.int32), pts, v, pose, pose, yes, cfg)),
        "maps_size": (ValueError, "K4 maps", lambda: line.update_maps_line(
            maps[:-1], pts, v, pose, pose, yes, cfg)),
        "gate_dtype": (ValueError, "K4 fire", lambda: line.update_maps_line(
            maps, pts, v, pose, pose, yes.to(torch.uint8), cfg)),
        "pose_strided": (ValueError, "K4 poses", lambda: line.update_maps_line(
            maps, pts, v, torch.zeros(6)[::2], pose, yes, cfg)),
        "levels": (ValueError, "K4 takes", lambda: line.update_maps_line(
            maps, pts, v, pose, pose, yes,
            cfg.overlay({"num_levels": 5, "estimate_iterations": (1,) * 5}))),
        "batch_points_rank": (ValueError, "K4 batch points", lambda:
                              line.update_maps_line_batch(
                                  bm, bp[0], bv, bpose, bpose, fire, cfg)),
        "batch_fire_shape": (ValueError, "K4 batch fire", lambda:
                             line.update_maps_line_batch(
                                 bm, bp, bv, bpose, bpose, fire[:3], cfg)),
        "batch_marks_size": (TypeError, "marks", lambda:
                             line.update_maps_line_batch(
                                 bm, bp, bv, bpose, bpose, fire, cfg,
                                 marks=bk[:c])),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_line_wrappers_refuse(case):
    # the wrappers check every input on any device before choosing a path
    exc, msg, call = _refusals()[case]
    with pytest.raises(exc, match=msg):
        call()


def _tile_beams(width, seed):
    """(begin, end) pixel pairs, begin != end, both in the map: random beams
    in every direction; axis-aligned beams (abs_db = 0), one-cell beams and
    diagonals from random begins; beams that begin or end on a tile edge
    (a tile's first or last row or column)."""
    rng = np.random.default_rng(seed)
    t = line.TILE
    edges = [v for k in range(0, width + 1, t) for v in (k - 1, k)
             if 0 <= v < width]
    pairs = [(tuple(rng.integers(0, width, 2)), tuple(rng.integers(0, width, 2)))
             for _ in range(150)]
    for _ in range(30):
        bx, by = (int(a) for a in rng.integers(0, width, 2))
        run = int(rng.integers(1, width))
        for ux, uy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1),
                       (1, -1), (-1, -1)):
            pairs.append(((bx, by), (bx + ux, by + uy)))           # one cell
            pairs.append(((bx, by), (bx + ux * run, by + uy * run)))
    for _ in range(150):
        ex, ey = rng.choice(edges), rng.choice(edges)
        bx, by = (int(a) for a in rng.integers(0, width, 2))
        pairs += [((bx, by), (ex, int(rng.integers(0, width)))),
                  ((bx, by), (int(rng.integers(0, width)), ey)),
                  ((ex, ey), (bx, by)), ((bx, ey), (ex, by))]
    inside = [(tuple(map(int, b)), tuple(map(int, e))) for b, e in pairs
              if b != e and all(0 <= v < width for v in (*b, *e))]
    return sorted(set(inside))


@pytest.mark.parametrize("width", [400, 200, 100])
def test_tile_walk_covers_each_walk_once(width):
    # the union over tiles of a beam's tile_walk cells is its walk, each cell
    # once and in walk order, and each tile restarts with the walk's own
    # error term; the walk is the closed form of both packages
    pairs = _tile_beams(width, seed=width)
    begin = np.asarray([b for b, _ in pairs], np.int32)
    end = np.asarray([e for _, e in pairs], np.int32)
    got = rasterize.hector_line_cells(torch.from_numpy(begin),
                                      torch.from_numpy(end), width, width)
    want = jrasterize.hector_line_cells(jnp.asarray(begin), jnp.asarray(end),
                                        width, width)
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    np.testing.assert_array_equal(got.flat.numpy()[mask],
                                  np.asarray(want.flat)[mask])
    n = line.tiles_per_side(width)
    kinds = collections.Counter()
    for i, ((bx, by), (ex, ey)) in enumerate(pairs):
        walk = list(got.flat.numpy()[i][mask[i]])
        dx, dy = ex - bx, ey - by
        maj, mino = max(abs(dx), abs(dy)), min(abs(dx), abs(dy))
        errs = [(maj // 2 + k * mino) % maj for k in range(maj)]
        kinds.update({"x-major" if abs(dx) >= abs(dy) else "y-major",
                      f"direction {np.sign(dx)},{np.sign(dy)}"})
        kinds.update(["axis-aligned"] * (mino == 0) + ["one-cell"] * (maj == 1)
                     + ["on a tile edge"] * any(
                         v % line.TILE in (0, line.TILE - 1)
                         for v in (bx, by, ex, ey)))
        covered = []
        for ty in range(n):
            for tx in range(n):
                tw = line.tile_walk((bx, by), (ex, ey), width,
                                    tx * line.TILE, ty * line.TILE)
                if tw is None:
                    continue
                assert tw.cells == walk[tw.k0:tw.k1 + 1], (i, tx, ty)
                assert tw.err == errs[tw.k0], (i, tx, ty)
                covered += tw.cells
        assert collections.Counter(covered) == collections.Counter(walk), i
    for kind in ("x-major", "y-major", "axis-aligned", "one-cell",
                 "on a tile edge", "direction 1,1", "direction -1,1",
                 "direction 1,-1", "direction -1,-1"):
        assert kinds[kind] >= 5, (kind, kinds)


@pytest.mark.parametrize("sizes", [(400, 200, 100), (64, 32, 16), (65, 32, 16)])
@pytest.mark.parametrize("batch", [1, 64, 300])
def test_line_work_items_cover_every_cell_once(sizes, batch):
    # the wrapper's schedule (_params): an instance's square tiles cover each
    # level's cells once, and the grid is K2's, from B and the SM count, at
    # most as many blocks an SM as it holds at once
    starts = line.tile_starts(sizes)
    for level, w in enumerate(sizes):
        n = line.tiles_per_side(w)
        assert starts[level + 1] - starts[level] == n * n
        cover = np.zeros((w, w), int)
        for k in range(n * n):
            y0, x0 = (k // n) * line.TILE, (k % n) * line.TILE
            cover[y0:y0 + line.TILE, x0:x0 + line.TILE] += 1
        assert (cover == 1).all(), (level, w)
    cfg = fixed_config(map_size=sizes[0], num_levels=3,
                       estimate_iterations=(1, 1, 1))
    assert cfg.level_sizes == sizes
    for resident in (1, 2, 4):
        p = line._params(cfg, 400, batch, 132, resident)
        assert p.grid == fill.grid_size(batch, starts[-1], 132, resident)
        assert p.grid <= min(batch * starts[-1], resident * 132)
    assert list(p.tile_start)[:4] == starts
    assert list(p.tiles)[:3] == [line.tiles_per_side(w) for w in sizes]
    assert (p.batch, p.n, p.cells) == (batch, 400, cfg.total_cells)
    if sizes == (400, 200, 100):                # one firing robot: at most
        assert starts[-1] == 81 + 25 + 9 <= 132  # one item a block


def _tiled_update(maps, pts, valid, poses, fire, cfg, grid):
    """The kernel's schedule and marks in plain Python: ``grid`` blocks take
    their shares of the firing instances' (level, tile) items; each item
    marks its beams' free cells by tile_walk, then its occupied endpoints,
    and applies (v + f) + o to the marked cells."""
    b, c = pts.shape[0], cfg.total_cells
    out = maps.clone().view(b, c)
    starts = line.tile_starts(cfg.level_sizes)
    per = starts[-1]
    firing = [i for i in range(b) if fire[i]]
    items = len(firing) * per
    seen = []
    for blk in range(grid):
        for item in range(items * blk // grid, items * (blk + 1) // grid):
            seen.append(item)
            inst, t = firing[item // per], item % per
            level = max(l for l in range(cfg.num_levels) if t >= starts[l])
            w, off = cfg.level_sizes[level], cfg.level_offsets[level]
            n = line.tiles_per_side(w)
            k = t - starts[level]
            y0, x0 = (k // n) * line.TILE, (k % n) * line.TILE
            scale = 1.0 / cfg.level_resolutions[level]
            pose = poses[inst:inst + 1]
            c_, s_ = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
            bx = int(dotnet_round(pose[:, 0:1] * scale))
            by = int(dotnet_round(pose[:, 1:2] * scale))
            p = pts[inst]
            ex = dotnet_round((c_ * p[:, 0] - s_ * p[:, 1] + pose[:, 0:1])
                              * scale)[0]
            ey = dotnet_round((s_ * p[:, 0] + c_ * p[:, 1] + pose[:, 1:2])
                              * scale)[0]
            marks = {}
            ok = [bool(valid[inst, j]) and (int(ex[j]), int(ey[j])) != (bx, by)
                  and all(0 <= v < w for v in (bx, by, int(ex[j]), int(ey[j])))
                  for j in range(p.shape[0])]
            for j in range(p.shape[0]):
                tw = ok[j] and line.tile_walk((bx, by), (int(ex[j]), int(ey[j])),
                                              w, x0, y0)
                for cell in (tw.cells if tw else []):
                    marks[cell] = 1
            for j in range(p.shape[0]):
                if ok[j] and x0 <= ex[j] < x0 + line.TILE \
                        and y0 <= ey[j] < y0 + line.TILE:
                    marks[int(ey[j]) * w + int(ex[j])] = 2
            row = out[inst, off:off + w * w]
            for cell, mk in marks.items():
                v = row[cell:cell + 1]
                f = torch.where(torch.tensor(mk == 1), cfg.log_odds_free,
                                torch.zeros_like(v))
                o = torch.where(torch.tensor(mk == 2) & (v < cfg.occupied_cap),
                                cfg.log_odds_occupied, torch.zeros_like(v))
                row[cell:cell + 1] = (v + f) + o
    assert seen == list(range(items))
    return out.reshape(-1)


@pytest.mark.parametrize("grid", [1, 5, 40])
def test_tile_schedule_reproduces_the_plain_update(grid):
    # 96/48 px levels (partial tiles at the right and bottom edges), the
    # first robot on a tile corner, some beams along the axes, three robots
    # of which two fire, one of them outside the map: the tiled update
    # equals the plain one bit for bit, whatever the number of blocks
    cfg = fixed_config(map_size=96, map_resolution=0.5, num_levels=2,
                       estimate_iterations=(1, 1))
    rng = np.random.default_rng(11)
    b = 3
    base = torch.from_numpy(rng.uniform(-3.0, 3.0, b * cfg.total_cells)
                            .astype(np.float32))
    base[torch.from_numpy(rng.random(b * cfg.total_cells) < 0.05)] = 55.0
    ang = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    r = 6.0 + 14.0 * rng.random(60)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    pts[::7] = np.round(pts[::7])          # some beams along the axes
    p = torch.from_numpy(np.stack([pts, pts * 0.8, pts[::-1].copy()]))
    v = torch.from_numpy(rng.random((b, 60)) >= 0.1)
    poses = torch.tensor([[20.0, 20.0, 0.0], [-3.0, 12.0, 0.7],
                          [27.3, 21.1, 2.2]])
    fire = torch.tensor([True, True, False])
    want = line.update_maps_line_batch_plain(base, p, v, poses,
                                             torch.zeros(b, 3), fire, cfg)
    got = _tiled_update(base, p, v, poses, fire, cfg, grid)
    assert torch.equal(got, want)
    c = cfg.total_cells
    assert not torch.equal(got[:c], base[:c])
    assert torch.equal(got[c:], base[c:])   # outside the map; not firing
