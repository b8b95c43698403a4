"""The fleet slice: slamnet_tpu_torch.models.fleet against the JAX package.

Four robots (B = 4) on a 2-level 128 px pyramid at 0.3125 m (40 m), 200
beams, each robot on its own straight path so the motion gates fire out of
step.  The scans are the port's noise-free ray cast plus uniform noise drawn
with numpy from a seed: the same numpy inputs go to both packages.

* The JAX fleet runs ``matcher_mode="onehot_bf16"`` (K5's bf16 selection, in
  XLA) with the dense fill; the port runs ``sub4_pallas_dense`` through its
  plain versions on the CPU.  Only the order of the beam sums differs, so
  poses agree to 2e-3 m (``tests/test_torch_hector.py``'s tolerance), the
  gates fire on the same batch-scans, and at most 0.1% of an instance-level's
  cells differ, each by one free increment |log_odds_free| (the fill's
  ``atan2`` may differ in the last bit, ``tests/test_torch_fill.py``).
* ``match_batch_plain`` is held against JAX's K5 in interpret mode (as
  ``tests/test_fleet.py`` runs it): poses 2e-3, equal solve failures,
  residual rtol 0.05.
* ``sub1`` (the bench's fleet accuracy anchor: the gather matcher, batched
  K3, and line updates, batched K4) against the JAX fleet in ``gather``
  mode: the f32 table on both sides, so poses agree to 1e-4 m, the gates
  fire on the same batch-scans, and at most 0.1% of an instance-level's
  cells differ (a 1-ulp cos/sin difference may move a rounded endpoint,
  ``tests/test_torch_line.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.models import fleet as jfleet
from slamnet_tpu.models import hector as jhector
from slamnet_tpu_torch import convert, replay
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import fleet, hector
from slamnet_tpu_torch.ops import fill, match
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim.field import ray_cast

SMALL = dict(num_levels=2, map_size=128, map_resolution=0.3125,
             estimate_iterations=(5, 4))
B, N, T = 4, 200, 12
BOOT = 3
STARTS = np.asarray([[20.0, 20.0, 0.0], [26.0, 12.0, 1.0],
                     [12.0, 28.0, -0.7], [24.0, 28.0, 2.0]], np.float32)
VEL = np.asarray([[0.12, 0.05, 0.02], [-0.08, 0.11, -0.03],
                  [0.1, -0.06, 0.05], [-0.05, -0.1, 0.01]], np.float32)
LOF = abs(float(np.log(0.4 / 0.6)))
# the JAX fleet step, compiled once per config
jax_step = jax.jit(jfleet.update_fleet, static_argnames=("cfg",))


def port_cfg(**over):
    return replay.sub4_pallas_dense_config(**SMALL).overlay(over)


def sub1_cfg(**over):
    return replay.sub1_config(**SMALL).overlay(over)


def jax_cfg(cfg, mode="onehot_bf16"):
    """The JAX HectorConfig with the port config's fields."""
    return JHectorConfig(**{**dataclasses.asdict(cfg), "matcher_mode": mode})


@pytest.fixture(scope="module")
def flog():
    """T batch-scans of the 4 robots: true poses f32[T, B, 3], robot-local
    clouds f32[T, B, N, 2] and valid bool[T, B, N] (numpy seed 0)."""
    traj = (STARTS[None] + np.arange(T, dtype=np.float32)[:, None, None]
            * VEL[None]).astype(np.float32)
    angles = revolution_angles(N)
    hit, dist = ray_cast(default_field(), torch.from_numpy(traj[..., :2]),
                         torch.from_numpy(angles + traj[..., 2:3]), 40.0)
    rng = np.random.default_rng(0)
    hit = hit.numpy()
    r = np.where(hit, dist.numpy()
                 + rng.integers(-100, 100, hit.shape) / 100.0 * 0.02, 0.0)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1)
    return traj, pts.astype(np.float32), hit


def run_port(cfg, flog):
    """bench's fleet flow through the port: BOOT forced batch-scans at the
    true poses, then tracked ones; (per-step poses, map_updated, maps)."""
    traj, pts, v = flog
    st = fleet.init_fleet(cfg, traj[0], device="cpu")
    out = []
    for t in range(T):
        if t < BOOT:
            st = st._replace(match_pose=torch.from_numpy(traj[t]))
        st, info = fleet.update_fleet(st, torch.from_numpy(pts[t]),
                                      torch.from_numpy(v[t]), cfg, t < BOOT)
        out.append((st.match_pose.numpy().copy(),
                    info.map_updated.numpy().copy(), st.maps.numpy().copy()))
    return out


def run_jax(jcfg, flog):
    traj, pts, v = flog
    st = jfleet.init_fleet(jcfg, traj[0])
    out = []
    for t in range(T):
        if t < BOOT:
            st = st._replace(match_pose=jnp.asarray(traj[t]))
        st, info = jax_step(st, jnp.asarray(pts[t]), jnp.asarray(v[t]),
                            cfg=jcfg, map_without_matching=jnp.asarray(t < BOOT))
        out.append((np.asarray(st.match_pose), np.asarray(info.map_updated),
                    np.asarray(st.maps)))
    return out


@pytest.fixture(scope="module")
def jax_boot(flog):
    """The JAX fleet after 6 forced batch-scans at the true poses, and the
    config it ran."""
    traj, pts, v = flog
    jcfg = jax_cfg(port_cfg())
    st = jfleet.init_fleet(jcfg, traj[0])
    for t in range(6):
        st = st._replace(match_pose=jnp.asarray(traj[t]))
        st, _ = jax_step(st, jnp.asarray(pts[t]), jnp.asarray(v[t]), cfg=jcfg,
                         map_without_matching=jnp.asarray(True))
    return st, jcfg


def assert_maps_agree(got, want, cfg, what=""):
    """Per instance and level: at most 0.1% of cells differ, each by |lof|."""
    g = got.reshape(B, cfg.total_cells)
    w = want.reshape(B, cfg.total_cells)
    for off, size in zip(cfg.level_offsets, cfg.level_sizes):
        sl = slice(off, off + size * size)
        diff = g[:, sl] != w[:, sl]
        assert diff.mean(axis=1).max() <= 1e-3, (what, diff.mean(axis=1))
        np.testing.assert_allclose(np.abs(g[:, sl][diff] - w[:, sl][diff]),
                                   LOF, atol=1e-5, err_msg=what)


def test_one_robot_fleet_equals_hector_update(flog):
    # the JAX package's invariant (tests/test_fleet.py:50-73) in the port: a
    # 1-robot fleet IS hector.update, over 2 forced + 2 tracked scans
    traj, pts, v = flog
    cfg = port_cfg()
    single = hector.init(cfg, traj[0, 0], device="cpu")
    batch = fleet.init_fleet(cfg, traj[0, :1], device="cpu")
    for t, boot in enumerate((True, True, False, False)):
        scan = Scan.from_points(pts[t, 0], v[t, 0])
        single, sinfo = hector.update(single, scan, single.match_pose, cfg,
                                      boot)
        batch, binfo = fleet.update_fleet(batch, torch.from_numpy(pts[t, :1]),
                                          torch.from_numpy(v[t, :1]), cfg,
                                          boot)
        assert bool(binfo.map_updated[0]) == bool(sinfo.map_updated)
    np.testing.assert_allclose(batch.match_pose[0].numpy(),
                               single.match_pose.numpy(), atol=1e-5)
    assert torch.equal(batch.maps, single.maps)
    assert torch.equal(batch.last_update_pose[0], single.last_update_pose)
    assert batch._fields == single._fields == convert.FIELDS   # no scratch


def test_match_batch_plain_matches_jax_k5(flog, jax_boot):
    # JAX's K5 (interpret mode) on the JAX-bootstrapped maps; robot 2 has
    # no valid beam and must come back at its hint
    traj, pts, v = flog
    jst, _ = jax_boot
    cfg = port_cfg(match_subsample=2)
    jcfg = jax_cfg(cfg, "pallas")
    valid = v[6].copy()
    valid[2] = False
    hints = (traj[6] + np.asarray([0.1, -0.05, 0.02], np.float32)).astype(
        np.float32)
    poses_j, stats_j = jfleet._match_batch(
        jst.maps, jfleet.fleet_cells(jcfg), jnp.asarray(pts[6]),
        jnp.asarray(valid), jnp.asarray(hints), jcfg)
    maps = torch.from_numpy(np.array(jst.maps))
    args = (torch.from_numpy(pts[6]), torch.from_numpy(valid),
            torch.from_numpy(hints))
    out = match.match_batch_plain(maps, *args, cfg)
    np.testing.assert_allclose(out[:, :3].numpy(), np.asarray(poses_j),
                               atol=2e-3)
    np.testing.assert_array_equal(out[:, 3].numpy().astype(np.int32),
                                  np.asarray(stats_j.solve_failures))
    np.testing.assert_allclose((out[:, 4] / out[:, 5].clamp(min=1.0)).numpy(),
                               np.asarray(stats_j.residual), rtol=0.05)
    np.testing.assert_array_equal(out[2, :3].numpy(), hints[2])
    assert np.linalg.norm(out[[0, 1, 3], :2].numpy() - traj[6, [0, 1, 3], :2],
                          axis=1).max() < 0.1
    # each row is the one-robot match of that instance, bit for bit
    c = cfg.total_cells
    for i in range(B):
        one = match.match_plain(maps[i * c:(i + 1) * c], args[0][i], args[1][i],
                                args[2][i], cfg)
        assert torch.equal(one, out[i]), i
    # the K5 and K6 wrappers take the plain version on the CPU, uncounted
    counts = (match.match_batch.launches, match.match_packed.launches)
    assert torch.equal(match.match_batch(maps, *args, cfg), out)
    assert torch.equal(match.match_packed(maps, *args, cfg, 2), out)
    assert (match.match_batch.launches, match.match_packed.launches) == counts


@pytest.mark.parametrize("capacity", [1 << 30, 1])
def test_update_fleet_matches_jax(flog, capacity):
    # uncapped: the gates fire on the same batch-scans; capacity 1: JAX's
    # stable-argsort budget defers, never drops (tests/test_fleet.py:76-102),
    # with the same map_updated sequence
    cfg = port_cfg(fleet_update_capacity=capacity)
    got = run_port(cfg, flog)
    want = run_jax(jax_cfg(cfg), flog)
    upd = np.stack([g[1] for g in got])
    for t, ((gp, gu, gm), (wp, wu, wm)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gu, wu, err_msg=f"map_updated, step {t}")
        np.testing.assert_allclose(gp, wp, atol=2e-3, err_msg=f"step {t}")
        assert_maps_agree(gm, wm, cfg, f"step {t}")
    if capacity == 1:
        # one update a batch-scan while a gate is armed, lowest index first:
        # robot 0 takes the forced bootstrap, robots 1-3 (armed since init)
        # follow one a batch-scan; nobody is dropped
        assert (upd.sum(axis=1) <= 1).all()
        assert upd[:BOOT, 0].all()
        np.testing.assert_array_equal(np.argmax(upd[BOOT:BOOT + B - 1], axis=1),
                                      np.arange(1, B))
    else:
        assert upd[:BOOT].all()
        assert 1 <= upd[BOOT:].sum() < (T - BOOT) * B   # fired, not always
        traj = flog[0]
        err = np.linalg.norm(got[-1][0][:, :2] - traj[-1, :, :2], axis=1)
        assert err.max() < 0.1


def test_onehot_bf16_runs_the_same_kernels(flog, jax_boot):
    # onehot_bf16 is K1/K5's table precision: the port's step under it
    # equals the pallas step bit for bit, and JAX's onehot_bf16 step to 2e-3
    traj, pts, v = flog
    jst, _ = jax_boot
    arrays = {k: np.asarray(getattr(jst, k)) for k in convert.FIELDS}
    p, vv = torch.from_numpy(pts[6]), torch.from_numpy(v[6])
    outs = {}
    for mode in ("pallas", "onehot_bf16"):
        st = convert.fleet_state_from_numpy(**arrays, device="cpu")
        outs[mode] = fleet.update_fleet(st, p, vv,
                                        port_cfg(matcher_mode=mode))
    (sp, ip), (so, io) = outs["pallas"], outs["onehot_bf16"]
    assert torch.equal(sp.match_pose, so.match_pose)
    assert torch.equal(sp.maps, so.maps)
    assert torch.equal(ip.map_updated, io.map_updated)
    jcfg = jax_cfg(port_cfg())
    jst2, jinfo = jax_step(jst, jnp.asarray(pts[6]), jnp.asarray(v[6]),
                           cfg=jcfg, map_without_matching=jnp.asarray(False))
    np.testing.assert_allclose(so.match_pose.numpy(),
                               np.asarray(jst2.match_pose), atol=2e-3)
    np.testing.assert_array_equal(io.map_updated.numpy(),
                                  np.asarray(jinfo.map_updated))
    assert_maps_agree(so.maps.numpy(), np.asarray(jst2.maps), port_cfg())
    # the serving profile's matcher runs the single robot too
    scan = Scan.from_points(pts[6, 0], v[6, 0])
    st1 = hector.init(port_cfg(matcher_mode="onehot_bf16"), traj[6, 0],
                      device="cpu")
    hector.update(st1, scan, st1.match_pose, port_cfg(matcher_mode="onehot_bf16"))
    # a mode no kernel runs is refused by both models; an early exit under
    # "pallas" (port_cfg's matcher) too, as JAX's single robot and fleet
    # refuse it, while onehot_bf16 takes it in both
    for bad, exc, msg in (({"matcher_mode": "onehot"}, NotImplementedError,
                           "matcher_mode"),
                          ({"early_exit_tol": 1e-3}, ValueError,
                           "early_exit_tol")):
        with pytest.raises(exc, match=msg):
            fleet.update_fleet(
                convert.fleet_state_from_numpy(**arrays, device="cpu"), p, vv,
                port_cfg(**bad))
        with pytest.raises(exc, match=msg):
            hector.update(st1, scan, st1.match_pose, port_cfg(**bad))
    exit_cfg = port_cfg(matcher_mode="onehot_bf16", early_exit_tol=1e-3)
    _, info = hector.update(st1, scan, st1.match_pose, exit_cfg)
    assert 1 <= int(info.gn_iterations) <= 15


def test_update_maps_batch_plain_equals_per_instance(flog):
    # the batched fill is the per-instance fill where fire is set and the
    # identity elsewhere, bit for bit; the CPU wrapper takes it uncounted
    traj, pts, v = flog
    cfg = port_cfg()
    c = cfg.total_cells
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.uniform(-3.0, 3.0, B * c).astype(np.float32))
    base[torch.from_numpy(rng.random(B * c) < 0.05)] = 55.0
    fire = torch.tensor([True, False, True, True])
    poses = torch.from_numpy(traj[4] + np.float32(0.03))
    zero = torch.zeros(B, 3)
    p, vv = torch.from_numpy(pts[4]), torch.from_numpy(v[4])
    got = fill.update_maps_batch_plain(base, p, vv, poses, zero, fire, cfg)
    for i in range(B):
        one = fill.update_maps_plain(base[i * c:(i + 1) * c], p[i], vv[i],
                                     poses[i], zero[i], fire[i], cfg)
        assert torch.equal(got[i * c:(i + 1) * c], one), i
        assert fire[i] or torch.equal(one, base[i * c:(i + 1) * c])
    assert not torch.equal(got, base)
    maps = base.clone()
    before = fill.update_maps_batch.launches
    out = fill.update_maps_batch(maps, p, vv, poses, zero, fire, cfg)
    assert out is maps and torch.equal(maps, got)
    assert fill.update_maps_batch.launches == before


def test_fleet_convert_round_trip(jax_boot):
    jst, _ = jax_boot
    arrays = {k: np.asarray(getattr(jst, k)) for k in convert.FIELDS}
    st = convert.fleet_state_from_numpy(**arrays, device="cpu")
    assert st.maps.shape == (B * port_cfg().total_cells,)
    assert st.match_pose.shape == st.last_update_pose.shape == (B, 3)
    assert st._fields == convert.FIELDS              # no update scratch
    back = convert.fleet_state_to_numpy(st)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    rebuilt = jhector.HectorState(**{k: jnp.asarray(a) for k, a in back.items()})
    np.testing.assert_array_equal(np.asarray(rebuilt.match_pose),
                                  arrays["match_pose"])
    st.maps.add_(1.0)      # a copy: the numpy arrays are not touched
    np.testing.assert_array_equal(convert.fleet_state_to_numpy(st)["maps"],
                                  arrays["maps"] + 1.0)
    with pytest.raises(ValueError, match="match_pose"):
        convert.fleet_state_from_numpy(arrays["maps"], arrays["match_pose"][0],
                                       arrays["last_update_pose"], "cpu")


def _refusals():
    cfg = port_cfg()
    c = cfg.total_cells
    maps = torch.zeros(B * c)
    pts = torch.zeros(B, N, 2)
    v = torch.ones(B, N, dtype=torch.bool)
    h = torch.zeros(B, 3)
    marks = torch.zeros(B * c, dtype=torch.uint8)
    fire = torch.ones(B, dtype=torch.bool)
    wide = cfg.overlay({"match_subsample": 1})
    return {
        "valid_dtype": (ValueError, "K5 valid",
                        lambda: match.match_batch(maps, pts, v.to(torch.uint8),
                                                  h, cfg)),
        "hints_shape": (ValueError, "K5 hints",
                        lambda: match.match_batch(maps, pts, v, h[:, :2], cfg)),
        "maps_size": (ValueError, "K5 maps",
                      lambda: match.match_batch(maps[:-1], pts, v, h, cfg)),
        "points_rank": (ValueError, "K5 points",
                        lambda: match.match_batch(maps, pts[0], v, h, cfg)),
        "g_pack_value": (ValueError, "g_pack",
                         lambda: match.match_packed(maps, pts, v, h, cfg, 3)),
        "g_pack_divides": (ValueError, "g_pack",
                           lambda: match.match_packed(maps, pts, v, h, cfg, 8)),
        "block_threads": (ValueError, "exceed",
                          lambda: match.match_packed(
                              torch.zeros(8 * c), torch.zeros(8, 1024, 2),
                              torch.ones(8, 1024, dtype=torch.bool),
                              torch.zeros(8, 3), wide, 2)),
        "fill_fire_dtype": (ValueError, "K2 batch fire",
                            lambda: fill.update_maps_batch(
                                maps, pts, v, h, h, fire.to(torch.uint8),
                                cfg)),
        # K2 takes no global scratch: a marks tensor is refused
        "fill_marks_shape": (TypeError, "positional",
                             lambda: fill.update_maps_batch(
                                 maps, marks[:c], pts, v, h, h, fire, cfg)),
        "k3_batch_valid_dtype": (ValueError, "K3 batch valid",
                                 lambda: match.match_batch(
                                     maps, pts, v.to(torch.uint8), h,
                                     sub1_cfg())),
        "k3_batch_maps_size": (ValueError, "K3 batch maps",
                               lambda: match.match_batch(maps[:-1], pts, v, h,
                                                         sub1_cfg())),
        "build_without_cuda": (RuntimeError, "CUDA device", match._launcher),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_fleet_wrappers_refuse(case):
    # the wrappers check every input on any device before choosing a path;
    # on a machine without a card the kernels' build says so
    if case == "build_without_cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exc, msg, call = _refusals()[case]
    with pytest.raises(exc, match=msg):
        call()


def test_fleet_flow_helpers():
    # make_fleet_log's slices are bench.py:456-459's, and fleet_ate_of is
    # bench.py:489-493's RMS / max / median-instance ATE
    log = replay.make_log(seed=0)
    flog = replay.make_fleet_log(log, b=8, t=5)
    span = 5 + log.bootstrap
    starts = np.linspace(0, log.radii.shape[0] - span, 8).astype(int)
    assert flog.radii.shape == (span, 8, log.radii.shape[1])
    for i, s in enumerate(starts):
        np.testing.assert_array_equal(flog.radii[:, i], log.radii[s:s + span])
        np.testing.assert_array_equal(flog.traj[:, i], log.traj[s:s + span])
    truth = flog.traj[log.bootstrap:]
    poses = truth.copy()
    poses[:, :, 0] += np.arange(8, dtype=np.float32) * 0.01
    rms, mx, med = replay.fleet_ate_of(poses, truth)
    np.testing.assert_allclose(
        [rms, mx, med],
        [np.sqrt(np.mean((np.arange(8) * 0.01) ** 2)), 0.07, 0.035],
        rtol=1e-4)
    d = replay.to_device(flog, "cpu")
    assert d.points.shape == (span, 8, log.radii.shape[1], 2)


def test_fleet_replay_is_update_fleet_in_a_loop(flog):
    # replay_fleet tracks on a copy of the maps and returns every step's pose
    traj, pts, v = flog
    cfg = port_cfg()
    st = fleet.init_fleet(cfg, traj[0], device="cpu")
    dlog = replay.DeviceLog(torch.from_numpy(pts), torch.from_numpy(v),
                            torch.from_numpy(traj))
    st = replay.fleet_bootstrap(st, dlog, BOOT, cfg)
    np.testing.assert_array_equal(st.last_update_pose.numpy(), traj[BOOT - 1])
    maps0 = st.maps.clone()
    stf, poses = fleet.replay_fleet(st, dlog.points[BOOT:], dlog.valid[BOOT:],
                                    cfg)
    assert torch.equal(st.maps, maps0)
    assert poses.shape == (T - BOOT, B, 3)
    ref = run_port(cfg, flog)
    np.testing.assert_array_equal(poses.numpy(),
                                  np.stack([r[0] for r in ref[BOOT:]]))
    np.testing.assert_array_equal(stf.maps.numpy(), ref[-1][2])
    rms, mx, _ = replay.fleet_ate_of(poses.numpy(), traj[BOOT:])
    assert mx < 0.1 and rms < 0.05



def test_sub1_fleet_matches_jax(flog):
    # the fleet's accuracy anchor: batched K3 + batched K4 plain versions
    # against the JAX fleet in gather mode with line updates
    cfg = sub1_cfg()
    got = run_port(cfg, flog)
    want = run_jax(jax_cfg(cfg, "gather"), flog)
    upd = np.stack([g[1] for g in got])
    for t, ((gp, gu, gm), (wp, wu, wm)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gu, wu, err_msg=f"map_updated, step {t}")
        np.testing.assert_allclose(gp, wp, atol=1e-4, err_msg=f"step {t}")
        g = gm.reshape(B, cfg.total_cells)
        w = wm.reshape(B, cfg.total_cells)
        for off, size in zip(cfg.level_offsets, cfg.level_sizes):
            sl = slice(off, off + size * size)
            frac = (g[:, sl] != w[:, sl]).mean(axis=1)
            assert frac.max() <= 1e-3, (t, frac)
    assert upd[:BOOT].all()
    assert 1 <= upd[BOOT:].sum() < (T - BOOT) * B    # fired, not always
    err = np.linalg.norm(got[-1][0][:, :2] - flog[0][-1, :, :2], axis=1)
    assert err.max() < 0.1


def test_one_robot_sub1_fleet_equals_hector_update(flog):
    # a 1-robot sub1 fleet IS the port's fixed-mode hector.update (batched K3
    # and K4 plain versions against the single ones), bit for bit
    traj, pts, v = flog
    cfg = sub1_cfg()
    single = hector.init(cfg, traj[0, 0], device="cpu")
    batch = fleet.init_fleet(cfg, traj[0, :1], device="cpu")
    for t, boot in enumerate((True, True, False, False, False)):
        scan = Scan.from_points(pts[t, 0], v[t, 0])
        single, sinfo = hector.update(single, scan, single.match_pose, cfg,
                                      boot)
        batch, binfo = fleet.update_fleet(batch, torch.from_numpy(pts[t, :1]),
                                          torch.from_numpy(v[t, :1]), cfg,
                                          boot)
        assert bool(binfo.map_updated[0]) == bool(sinfo.map_updated)
    assert torch.equal(batch.match_pose[0], single.match_pose)
    assert torch.equal(batch.maps, single.maps)
    assert torch.equal(batch.last_update_pose[0], single.last_update_pose)
    assert batch._fields == single._fields == convert.FIELDS   # no scratch


@pytest.mark.parametrize("mode", ["gather", "onehot_bf16", "pallas"])
def test_fleet_empty_scan_rule_follows_the_jax_mode(flog, jax_boot, mode):
    # robot 2's valid beams all fall between the subsampled ones, its hint
    # heading is 4.0: JAX's fleet tests the subsampled beams in every mode
    # (fleet.py:67-71 subsamples valid before :119), so each mode returns
    # the hint itself, where the single robot's XLA modes return the GN
    # estimate (tests/test_torch_match.py); the other robots match
    traj, pts, v = flog
    jst, _ = jax_boot
    cfg = port_cfg(matcher_mode=mode)
    valid = v[6].copy()
    valid[2] = np.arange(N) % 4 != 0
    hints = traj[6].copy()
    hints[2] = [20.0, 20.0, 4.0]
    poses_j, stats_j = jfleet._match_batch(
        jst.maps, jfleet.fleet_cells(jax_cfg(cfg, mode)), jnp.asarray(pts[6]),
        jnp.asarray(valid), jnp.asarray(hints), jax_cfg(cfg, mode))
    out = match.match_batch(torch.from_numpy(np.array(jst.maps)),
                            torch.from_numpy(pts[6]), torch.from_numpy(valid),
                            torch.from_numpy(hints), cfg)
    np.testing.assert_array_equal(out[2, :3].numpy(), hints[2])
    np.testing.assert_allclose(np.asarray(poses_j)[2], hints[2], atol=1e-6)
    assert int(out[2, 3]) == int(stats_j.solve_failures[2]) == 9
    np.testing.assert_allclose(out[:, :3].numpy(), np.asarray(poses_j),
                               atol=2e-3)


# ---- the fleet's batch-wide early exit (slamnet_tpu/models/fleet.py:154-172):
# a level stops only after an iteration in which no robot moved by more than
# the tolerance, and every robot runs that shared count.  The f32 table
# (gather) is held to 1e-5 m, K1's table against JAX's onehot_bf16 to 2e-3
# (as above); the shared counts and the solve failures exactly.
EXIT_OFFSETS = np.asarray([[0.1, -0.05, 0.02], [-0.08, 0.06, -0.03],
                           [0.05, 0.1, 0.01], [0.12, 0.04, -0.02]], np.float32)


def _batch_match(maps_j, cfg, pts, valid, hints):
    """(port plain f32[B, 7], JAX (poses, stats)) on the same inputs."""
    jcfg = jax_cfg(cfg, cfg.matcher_mode)
    poses_j, stats_j = jfleet._match_batch(
        maps_j, jfleet.fleet_cells(jcfg), jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(hints), jcfg)
    out = match.match_batch(torch.from_numpy(np.array(maps_j)),
                            torch.from_numpy(pts), torch.from_numpy(valid),
                            torch.from_numpy(hints), cfg)
    return out.numpy(), np.asarray(poses_j), stats_j


@pytest.mark.parametrize("tol", [1e-3, 0.3])
@pytest.mark.parametrize("mode", ["gather", "onehot_bf16"])
def test_batch_exit_plain_matches_jax(flog, jax_boot, mode, tol):
    # B = 4 on the JAX-bootstrapped 2-level pyramid; at 0.3 px the levels
    # exit early, at bench's 1e-3 the young maps keep a robot moving
    traj, pts, v = flog
    jst, _ = jax_boot
    cfg = sub1_cfg(matcher_mode=mode, early_exit_tol=tol)
    hints = (traj[6] + EXIT_OFFSETS).astype(np.float32)
    out, poses_j, stats_j = _batch_match(jst.maps, cfg, pts[6], v[6], hints)
    np.testing.assert_allclose(out[:, :3], poses_j,
                               atol=1e-5 if mode == "gather" else 2e-3)
    np.testing.assert_array_equal(out[:, 3].astype(np.int32),
                                  np.asarray(stats_j.solve_failures))
    iters = out[:, 6].astype(np.int32)
    np.testing.assert_array_equal(iters, np.asarray(stats_j.iterations))
    assert (iters == iters[0]).all()                  # one shared count
    if tol == 0.3:
        assert iters[0] < sum(SMALL["estimate_iterations"])
    # the wrapper takes the plain version on the CPU, uncounted
    counts = (match.match_batch.launches, match.match_batch.launches_f32,
              match.match_batch.exit_launches)
    assert (match.match_batch.launches, match.match_batch.launches_f32,
            match.match_batch.exit_launches) == counts


def test_batch_exit_is_not_the_per_robot_rule(flog, jax_boot):
    # one level of 8 iterations, tolerance 0.05 px: alone, robot 0 (hint
    # near its pose) stops after 2 iterations and robot 1 (hint 0.36 m and
    # 0.05 rad off) after 5.  Together JAX's fleet runs both 5 times; a
    # per-robot exit would stop robot 0 at 2, with another pose
    traj, pts, v = flog
    jst, _ = jax_boot
    c = port_cfg().total_cells
    cfg = sub1_cfg(num_levels=1, estimate_iterations=(8,), early_exit_tol=0.05)
    w = cfg.total_cells
    maps = np.array(jst.maps).reshape(B, c)[:2, :w].reshape(-1)
    hints = (traj[6, :2] + np.asarray([[0.05, 0.03, 0.01], [0.3, -0.2, 0.05]],
                                      np.float32)).astype(np.float32)
    out, poses_j, stats_j = _batch_match(jnp.asarray(maps), cfg, pts[6, :2],
                                         v[6, :2], hints)
    np.testing.assert_array_equal(np.asarray(stats_j.iterations), [5, 5])
    np.testing.assert_array_equal(out[:, 6], [5, 5])
    np.testing.assert_allclose(out[:, :3], poses_j, atol=1e-5)
    alone = [match.match_batch_plain(torch.from_numpy(maps[i * w:(i + 1) * w]),
                                     torch.from_numpy(pts[6, i:i + 1]),
                                     torch.from_numpy(v[6, i:i + 1]),
                                     torch.from_numpy(hints[i:i + 1]), cfg)[0]
             for i in range(2)]
    assert [int(a[6]) for a in alone] == [2, 5]
    assert np.abs(alone[0][:3].numpy() - poses_j[0]).max() > 1e-4
    np.testing.assert_array_equal(alone[1].numpy(), out[1])


@pytest.mark.parametrize("mode", ["gather", "onehot_bf16"])
def test_batch_exit_at_one_robot_is_the_single_robots(flog, jax_boot, mode):
    # B = 1: the batch-wide rule is the single robot's (hector.py:227-244),
    # bit for bit in the port and in the iterations JAX's single robot runs
    traj, pts, v = flog
    jst, _ = jax_boot
    c = port_cfg().total_cells
    maps = np.array(jst.maps)[:c]
    for tol in (1e-3, 0.3):
        cfg = sub1_cfg(matcher_mode=mode, early_exit_tol=tol)
        hint = (traj[6, 0] + EXIT_OFFSETS[0]).astype(np.float32)
        args = (torch.from_numpy(pts[6, 0]), torch.from_numpy(v[6, 0]),
                torch.from_numpy(hint))
        one = match.match_plain(torch.from_numpy(maps), *args, cfg)
        batch = match.match_batch_plain(torch.from_numpy(maps),
                                        *(a[None] for a in args), cfg)
        assert torch.equal(batch[0], one)
        jcfg = jax_cfg(cfg, mode)
        _, jstats = jhector.match_with_stats(
            jnp.asarray(maps), jhector.Scan(jnp.asarray(pts[6, 0]),
                                            jnp.asarray(v[6, 0]),
                                            jnp.zeros(3, jnp.float32)),
            jnp.asarray(hint), jcfg)
        assert int(one[6]) == int(jstats.iterations)


def _rows_run(cfg, flog):
    """The port's and JAX's fleet flow (BOOT forced batch-scans, then
    tracked ones): per step (poses, map_updated, maps, GN iterations)."""
    traj, pts, v = flog
    jcfg = jax_cfg(cfg, cfg.matcher_mode)
    st = fleet.init_fleet(cfg, traj[0], device="cpu")
    jst = jfleet.init_fleet(jcfg, traj[0])
    got, want = [], []
    for t in range(T):
        if t < BOOT:
            st = st._replace(match_pose=torch.from_numpy(traj[t]))
            jst = jst._replace(match_pose=jnp.asarray(traj[t]))
        st, info = fleet.update_fleet(st, torch.from_numpy(pts[t]),
                                      torch.from_numpy(v[t]), cfg, t < BOOT)
        jst, jinfo = jax_step(jst, jnp.asarray(pts[t]), jnp.asarray(v[t]),
                              cfg=jcfg,
                              map_without_matching=jnp.asarray(t < BOOT))
        got.append((st.match_pose.numpy().copy(),
                    info.map_updated.numpy().copy(), st.maps.numpy().copy(),
                    info.gn_iterations.numpy().copy()))
        want.append((np.asarray(jst.match_pose), np.asarray(jinfo.map_updated),
                     np.asarray(jst.maps), np.asarray(jinfo.gn_iterations)))
    return got, want


@pytest.mark.parametrize("row", ["sub4", "sub4_onehot", "sub4_onehot_cap2",
                                 "sub1_exit", "sub1_exit_fires"])
def test_fleet_rows_match_jax(flog, row):
    # bench's other fleet rows (bench.py:506-523) and sub1 with the exit,
    # through the plain versions, against the JAX fleet: poses (1e-4 m on
    # the f32 table, as sub1; 2e-3 on K1's), the same fire flags a step,
    # maps within 0.1% of an instance-level's cells, equal GN iterations
    cfg = {"sub4": replay.sub4_config(**SMALL),
           "sub4_onehot": replay.sub4_onehot_config(**SMALL),
           "sub4_onehot_cap2": replay.sub4_onehot_cap_config(2, **SMALL),
           "sub1_exit": replay.sub1_exit_config(**SMALL),
           "sub1_exit_fires": replay.sub1_exit_config(
               early_exit_tol=0.3, **SMALL)}[row]
    got, want = _rows_run(cfg, flog)
    tol = 2e-3 if cfg.matcher_mode == "onehot_bf16" else 1e-4
    for t, ((gp, gu, gm, gi), (wp, wu, wm, wi)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gu, wu, err_msg=f"map_updated, step {t}")
        np.testing.assert_allclose(gp, wp, atol=tol, err_msg=f"step {t}")
        np.testing.assert_array_equal(gi, wi, err_msg=f"iterations, step {t}")
        g = gm.reshape(B, cfg.total_cells)
        w = wm.reshape(B, cfg.total_cells)
        for off, size in zip(cfg.level_offsets, cfg.level_sizes):
            sl = slice(off, off + size * size)
            frac = (g[:, sl] != w[:, sl]).mean(axis=1)
            assert frac.max() <= 1e-3, (t, frac)
    upd = np.stack([g[1] for g in got])
    iters = np.stack([g[3] for g in got])
    if row == "sub4_onehot_cap2":
        # at most 2 updates a batch-scan; a deferred robot tracks on a map
        # that lags (bench.py:514-516), so no accuracy bound here
        assert (upd.sum(axis=1) <= 2).all() and upd[BOOT:].any()
        return
    if row == "sub1_exit_fires":
        assert (iters[BOOT:] < sum(SMALL["estimate_iterations"])).any()
    err = np.linalg.norm(got[-1][0][:, :2] - flog[0][-1, :, :2], axis=1)
    assert err.max() < 0.1
