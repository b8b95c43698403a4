"""K2's plain version (the dense polar fill) against the JAX package on CPU.

``slamnet_tpu_torch.ops.logodds.update_occupancy_dense`` ports the JAX
function's CPU branch (an exact ``table[cbin]`` lookup).  The two compute the
same formulas, but torch's and XLA's ``atan2`` may differ in the last bit, so
a cell on a bin boundary can read the neighbouring bin's range: occupied
increments must be identical, at most 0.1% of cells may differ, and each
differing cell by exactly one free increment |log_odds_free|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.ops import logodds as jlogodds
from slamnet_tpu_torch.ops import fill, logodds
from slamnet_tpu_torch.replay import pallas_dense_config

LOF = float(np.log(0.4 / 0.6))
LOO = float(np.log(0.9 / 0.1))


def _case(seed, width, n=300, invalid_frac=0.1):
    """Random map (some cells above the cap) and a smooth room-like scan."""
    rng = np.random.default_rng(seed)
    maps = rng.uniform(-3.0, 3.0, width * width).astype(np.float32)
    maps[rng.random(width * width) < 0.05] = 55.0
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = (0.3 * width / 3.2) * (1.0 + 0.3 * np.sin(3 * ang + seed)) \
        + rng.uniform(-0.05, 0.05, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    valid = rng.random(n) >= invalid_frac
    pose = np.array([width / 6.4 + 0.3, width / 6.4 - 0.2, 0.4 + seed],
                    np.float32)
    return maps, pts, valid, pose


def _both(maps, pts, valid, pose, width, scale=3.2, margin=0.75):
    args = (width,)
    kw = dict(free_margin_px=margin)
    want = np.asarray(jlogodds.update_occupancy_dense(
        jnp.asarray(maps), *args, jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(pose), jnp.zeros(2, jnp.float32), scale, LOF, LOO, **kw))
    got = logodds.update_occupancy_dense(
        torch.from_numpy(maps), *args, torch.from_numpy(pts),
        torch.from_numpy(valid), torch.from_numpy(pose), torch.zeros(2), scale,
        LOF, LOO, **kw).numpy()
    return got, want


def _assert_fill_agrees(got, want, base):
    dg, dw = got - base, want - base
    np.testing.assert_array_equal(dg > 0, dw > 0)            # occupied set
    np.testing.assert_array_equal(got[dw > 0], want[dw > 0])
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    np.testing.assert_allclose(np.abs(got[diff] - want[diff]), abs(LOF),
                               atol=1e-5)


@pytest.mark.parametrize("width,seed", [(128, 0), (128, 1), (160, 2),
                                        (160, 3)])
def test_dense_fill_matches_jax(width, seed):
    maps, pts, valid, pose = _case(seed, width)
    got, want = _both(maps, pts, valid, pose, width)
    _assert_fill_agrees(got, want, maps)
    assert (got - maps < 0).sum() > 100          # free space was marked
    assert (got - maps > 0).sum() > 50           # endpoints were marked


def test_dense_fill_no_beam_is_noop():
    maps, pts, _, pose = _case(4, 128)
    got, want = _both(maps, pts, np.zeros(len(pts), bool), pose, 128)
    np.testing.assert_array_equal(got, maps)
    np.testing.assert_array_equal(want, maps)


def test_dense_fill_respects_the_cap():
    maps, pts, valid, pose = _case(5, 128, invalid_frac=0.0)
    capped = np.full_like(maps, 50.0)     # every cell at the cap
    got, want = _both(capped, pts, valid, pose, 128)
    _assert_fill_agrees(got, want, capped)
    assert not (got > 50.0).any()         # occupied cells at the cap stay
    assert (got < 50.0).any()             # free cells still decrease


def test_update_maps_all_levels_matches_jax_update_maps():
    # the K2 wrapper on CPU tensors: every level, in place, gated
    small = dict(map_size=160, map_resolution=0.25, num_levels=3,
                 estimate_iterations=(7, 4, 4))
    cfg = pallas_dense_config(**small)
    jcfg = JHectorConfig(dense_free_fill=True, **small)
    rng = np.random.default_rng(7)
    base = rng.uniform(-2.0, 2.0, cfg.total_cells).astype(np.float32)
    _, pts, valid, _ = _case(6, 160)
    pose = np.array([19.7, 20.4, 0.3], np.float32)
    want = np.asarray(jhector.update_maps(
        jnp.asarray(base), JScan(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.zeros(3, jnp.float32)),
        jnp.asarray(pose), jcfg))
    maps = torch.from_numpy(base.copy())
    args = (torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(pose), torch.zeros(3))
    before = fill.update_maps.launches
    out = fill.update_maps(maps, *args, torch.tensor(True), cfg)
    assert out is maps and fill.update_maps.launches == before
    for off, w in zip(cfg.level_offsets, cfg.level_sizes):
        sl = slice(off, off + w * w)
        _assert_fill_agrees(maps.numpy()[sl], want[sl], base[sl])
    # do_update = False leaves the maps bit for bit
    again = maps.clone()
    fill.update_maps(maps, *args, torch.tensor(False), cfg)
    assert torch.equal(maps, again)


@pytest.mark.parametrize("sizes", [(400, 200, 100), (65, 33, 17)])
@pytest.mark.parametrize("batch", [1, 64, 300])
def test_fill_work_items_cover_every_cell_once(sizes, batch):
    # the wrapper's schedule (_params): an instance's tiles cover each
    # level's cells once, and the grid stays within the items of B robots
    # and BLOCKS_PER_SM an SM
    starts = fill.tile_starts(sizes)
    for level, w in enumerate(sizes):
        cover = np.zeros(w * w, int)
        for t in range(starts[level], starts[level + 1]):
            k = t - starts[level]
            cover[k * fill.TILE:min((k + 1) * fill.TILE, w * w)] += 1
        assert (cover == 1).all(), (level, w)
    per = starts[-1]
    grid = fill.grid_size(batch, per, sms=132)
    assert 1 <= grid <= min(batch * per, fill.BLOCKS_PER_SM * 132)
    cfg = pallas_dense_config()
    p = fill._params(cfg, 400, batch, 132)
    nl = cfg.num_levels
    assert list(p.tile_start)[:nl + 1] == fill.tile_starts(cfg.level_sizes)
    assert p.grid == fill.grid_size(batch, p.tile_start[nl], 132)


def test_one_firing_robot_fills_the_card():
    # one robot at 400/200/100 px has at least as many work items as blocks,
    # one block on each of the H100's 132 SMs, so every block takes an item
    per = fill.tile_starts((400, 200, 100))[-1]
    grid = fill.grid_size(1, per, sms=132)
    assert 132 == grid <= per


def test_cpu_wrappers_never_build_the_kernels(monkeypatch):
    # CPU tensors take the plain versions: no nvcc, no library is asked for
    from slamnet_tpu_torch.ops import _build, line, match

    def refuse():
        raise AssertionError("a CPU call reached the kernel build")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    cfg = pallas_dense_config(map_size=64, map_resolution=0.8, num_levels=2,
                              estimate_iterations=(2, 2))
    _, pts, valid, _ = _case(8, 64, n=40)
    b = 2
    maps = torch.zeros(b * cfg.total_cells)
    p = torch.from_numpy(np.stack([pts, pts]))
    v = torch.from_numpy(np.stack([valid, valid]))
    poses = torch.tensor([[25.0, 25.0, 0.1], [26.0, 24.0, -0.2]])
    zeros, fire = torch.zeros(b, 3), torch.tensor([True, False])
    fill.update_maps(maps[:cfg.total_cells], p[0], v[0], poses[0], zeros[0],
                     torch.tensor(True), cfg)
    fill.update_maps_batch(maps, p, v, poses, zeros, fire, cfg)
    line.update_maps_line_batch(maps, p, v, poses, zeros, fire,
                                cfg.overlay({"dense_free_fill": False}))
    assert match.match(maps[:cfg.total_cells], p[0], v[0], poses[0],
                       cfg).shape == (match.OUT,)
    assert match.match_batch(maps, p, v, poses, cfg).shape == (b, match.OUT)
    assert match.match_packed(maps, p, v, poses, cfg, 2).shape == (b, match.OUT)
    assert torch.isfinite(maps).all() and (maps != 0).any()
