"""The multi-device layer: slamnet_tpu_torch.parallel (the mesh, the
launcher, hessian, tiles, search) on gloo ranks on the CPU, against
slamnet_tpu.parallel on JAX's 8-device CPU mesh and the dense ops.

* The mesh: every collective on each axis of a 2x2 mesh (ranks 0-3) and a
  4x2 mesh (all eight) and on both axes, equal to its definition on every
  rank's inputs (the ppermute's receivers without a sender get zeros).
* The counterparts of ``tests/test_parallel.py``, each on 1-axis meshes of
  4 and 8 ranks, at its tolerance: the beam-sharded (H, dTr) and the tiled
  (H, dTr) within 1e-5 of the dense ``gn.hessian_derivs`` (and of JAX's
  sharded versions), the tiled line update within 1e-5 of
  ``logodds.update_occupancy`` (bit for bit the port's dense one) with
  every halo the next tile's first row, the tiles' roundtrip, and the
  sharded Monte-Carlo search: its pose scores its minimum, which beats the
  search pose, and equals the dense argmin over the same candidates (the
  port's per-shard generators rebuilt here; their draws are not JAX's).
* The launcher: a rank that raises and a deadlock each fail the launch
  (``RankError``) within its limit; NCCL with more ranks than cards and a
  rank without a card refuse, never fall back.
"""
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.ops import gn as jgn
from slamnet_tpu.ops import logodds as jlogodds
from slamnet_tpu.ops import score as jscore
from slamnet_tpu.parallel import hessian as jhessian
from slamnet_tpu.parallel import make_mesh as jmake_mesh
from slamnet_tpu.parallel import tiles as jtiles
from slamnet_tpu_torch.ops import logodds
from slamnet_tpu_torch.parallel import launch, mesh, search

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
LAUNCH_TIMEOUT_S = 240
LOF, LOO = -0.405465, 2.19722
MESHES = {"2x2": (2, 2), "4x2": (4, 2)}
# JAX's dense ops run eagerly, as tests/test_parallel.py runs them (under
# jit XLA fuses the sums into another order)
hessian_derivs, gn_iteration = jgn.hessian_derivs, jgn.gn_iteration


def _launch(target, tmp, world=8, timeout=LAUNCH_TIMEOUT_S, **kwargs):
    return launch.launch(f"_torch_sharded_ranks:{target}", world, kwargs,
                         backend="gloo", timeout_s=timeout,
                         pythonpath=[TESTS_DIR])


# ------------------------------------------------------------------ mesh

@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll") / "out.npz"
    _launch("collectives", None, out=str(out))
    return dict(np.load(out))


@pytest.mark.parametrize("name", list(MESHES))
def test_collectives_equal_their_definitions(coll, name):
    T, S = MESHES[name]
    n = T * S
    x = {r: np.arange(4, dtype=np.float32) * 10 + r for r in range(n)}

    def line(r, axis):
        t, s = divmod(r, S)
        return ([u * S + s for u in range(T)] if axis == "tile"
                else [t * S + v for v in range(S)])

    for r in range(n):
        got = {k[len(name) + 1:-len(str(r)) - 1]: v for k, v in coll.items()
               if k.startswith(f"{name}_") and k.endswith(f"_{r}")}
        for axis in ("tile", "search", "both"):
            ranks = list(range(n)) if axis == "both" else line(r, axis)
            vals = np.stack([x[q] for q in ranks])
            np.testing.assert_array_equal(got[f"psum_{axis}"], vals.sum(0))
            np.testing.assert_array_equal(got[f"pmax_{axis}"], vals.max(0))
            np.testing.assert_array_equal(got[f"pmin_{axis}"],
                                          (-vals).min(0))
        for axis in ("tile", "search"):
            ranks = line(r, axis)
            i = ranks.index(r)
            cat = np.concatenate([x[q] for q in ranks])
            np.testing.assert_array_equal(got[f"gather_{axis}"], cat)
            np.testing.assert_array_equal(got[f"tiled_{axis}"], cat)
            south = x[ranks[i + 1]] if i + 1 < len(ranks) else np.zeros(4)
            np.testing.assert_array_equal(got[f"perm_{axis}"], south)
            np.testing.assert_array_equal(got[f"ring_{axis}"],
                                          x[ranks[i - 1]])
    # 9 reductions, 4 collectives on each axis, the gather of the results;
    # on the CPU no host copy
    np.testing.assert_array_equal(coll[f"{name}_counts"], [18, 0])


# ------------------------------------------------------- parallel/ blocks

@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(1)
    d = dict(h_map=rng.normal(0, 1, 64 * 64).astype(np.float32),
             h_width=np.int32(64),
             h_pts=rng.uniform(-3, 3, (128, 2)).astype(np.float32),
             h_valid=rng.random(128) > 0.2,
             h_pose=np.asarray([32.0, 32.0, 0.3], np.float32))
    rng = np.random.default_rng(2)
    d.update(t_grid=rng.normal(0, 1, (64, 64)).astype(np.float32),
             t_pts=rng.uniform(-3, 3, (96, 2)).astype(np.float32),
             t_valid=rng.random(96) > 0.1,
             t_pose=np.asarray([32.0, 32.0, -0.2], np.float32))
    rng = np.random.default_rng(5)
    d.update(u_grid=rng.normal(0, 1, (64, 64)).astype(np.float32),
             u_pts=rng.uniform(-3, 3, (96, 2)).astype(np.float32),
             u_valid=rng.random(96) > 0.1,
             u_pose=np.asarray([20.0, 20.0, 0.4], np.float32),
             lof=np.float32(LOF), loo=np.float32(LOO),
             r_grid=np.arange(64 * 8, dtype=np.float32).reshape(64, 8))
    rng = np.random.default_rng(7)
    d.update(s_hole=rng.integers(0, 65500, 64 * 64).astype(np.int32),
             s_pts=rng.uniform(-10, 10, (128, 2)).astype(np.float32),
             s_valid3=np.ones(128, bool), s_valid11=rng.random(128) > 0.1,
             s_pose=np.asarray([20.0, 20.0, 0.1], np.float32))
    np.savez(tmp / "in.npz", **d)
    _launch("parallel_ops", tmp, data=str(tmp / "in.npz"),
            out=str(tmp / "out.npz"))
    return d, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_hessian_equals_dense(ops, n):
    d, p = ops
    args = (jnp.asarray(d["h_map"]), 64, jnp.asarray(d["h_pts"]),
            jnp.asarray(d["h_valid"]), jnp.asarray(d["h_pose"]), 10.0)
    Hd, dtrd = hessian_derivs(*args)
    Hs, dtrs = jhessian.sharded_hessian_derivs(jmake_mesh({"beam": 8}), *args)
    for H, dtr in ((Hd, dtrd), (Hs, dtrs)):
        np.testing.assert_allclose(p[f"{n}_H"], np.asarray(H), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p[f"{n}_dtr"], np.asarray(dtr), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(p[f"{n}_gn_pose"],
                               np.asarray(gn_iteration(*args)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [4, 8])
def test_tiled_hessian_equals_dense(ops, n):
    d, p = ops
    Hd, dtrd = hessian_derivs(
        jnp.asarray(d["t_grid"]).reshape(-1), 64, jnp.asarray(d["t_pts"]),
        jnp.asarray(d["t_valid"]), jnp.asarray(d["t_pose"]), 10.0)
    np.testing.assert_allclose(p[f"{n}_tH"], np.asarray(Hd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p[f"{n}_tdtr"], np.asarray(dtrd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        p[f"{n}_tgn_pose"], np.asarray(gn_iteration(
            jnp.asarray(d["t_grid"]).reshape(-1), 64, jnp.asarray(d["t_pts"]),
            jnp.asarray(d["t_valid"]), jnp.asarray(d["t_pose"]), 10.0)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [4, 8])
def test_tiled_occupancy_update_equals_dense(ops, n):
    d, p = ops
    want = np.asarray(jlogodds.update_occupancy(
        jnp.asarray(d["u_grid"]).reshape(-1), 64, jnp.asarray(d["u_pts"]),
        jnp.asarray(d["u_valid"]), jnp.asarray(d["u_pose"]),
        jnp.zeros(2, jnp.float32), 1.6, LOF, LOO)).reshape(64, 64)
    got = p[f"{n}_upd_grid"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    port = logodds.update_occupancy(
        torch.from_numpy(d["u_grid"]).reshape(-1), 64,
        torch.from_numpy(d["u_pts"]), torch.from_numpy(d["u_valid"]),
        torch.from_numpy(d["u_pose"]), torch.zeros(2), 1.6, LOF, LOO)
    np.testing.assert_array_equal(got, port.numpy().reshape(64, 64))
    # halo invariant: tile t's halo row is tile t+1's first owned row, the
    # last tile's zeros
    tl = p[f"{n}_upd_tiles"]
    for t in range(n - 1):
        np.testing.assert_array_equal(tl[t, -1], tl[t + 1, 0])
    np.testing.assert_array_equal(tl[-1, -1], np.zeros(64))


@pytest.mark.parametrize("n", [4, 8])
def test_shard_unshard_roundtrip(ops, n):
    d, p = ops
    np.testing.assert_array_equal(p[f"{n}_roundtrip"], d["r_grid"])
    np.testing.assert_array_equal(
        np.asarray(jtiles.unshard_grid(jtiles.shard_grid(
            jmake_mesh({"tile": n}), jnp.asarray(d["r_grid"])))),
        p[f"{n}_roundtrip"])


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_search_matches_reference_semantics(ops, n):
    # the returned pose scores the returned minimum, which beats (or ties)
    # the unperturbed search pose
    d, p = ops
    hole, pts = jnp.asarray(d["s_hole"]), jnp.asarray(d["s_pts"])
    valid = jnp.asarray(d["s_valid3"])
    best, gmin = p[f"{n}_best3"], p[f"{n}_gmin3"]
    sums, _ = jscore.score_candidates(hole, 64, 1.6, pts, valid,
                                      jnp.asarray(best)[None])
    assert int(sums[0]) == int(gmin)
    s0, _ = jscore.score_candidates(hole, 64, 1.6, pts, valid,
                                    jnp.asarray(d["s_pose"])[None])
    assert int(gmin) <= int(s0[0])


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_search_equals_dense_same_candidates(ops, n):
    # the per-shard generators rebuilt here: concatenated in shard order,
    # first shard wins equals first index wins
    d, p = ops
    pose = torch.from_numpy(d["s_pose"])
    cands = torch.cat([search.shard_candidates(pose, 0.1, 0.1, 1024 // n, 11,
                                               i) for i in range(n)])
    assert (cands[0] == pose).all()
    sums, nb = jscore.score_candidates(
        jnp.asarray(d["s_hole"]), 64, 1.6, jnp.asarray(d["s_pts"]),
        jnp.asarray(d["s_valid11"]), jnp.asarray(cands.numpy()))
    eff = np.where(np.asarray(nb) > 0, np.asarray(sums), jscore.INT32_MAX)
    bi = int(np.argmin(eff))
    assert int(p[f"{n}_gmin11"]) == int(eff[bi])
    np.testing.assert_array_equal(p[f"{n}_best11"], cands[bi].numpy())


# ------------------------------------------------------------ the launcher

def test_launch_fails_when_a_rank_raises():
    with pytest.raises(launch.RankError, match="fails on purpose"):
        _launch("fail", None, world=2, timeout=120, bad_rank=1)


def test_launch_kills_a_deadlock_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(launch.RankError):
        _launch("deadlock", None, world=2, timeout=15)
    assert time.monotonic() - t0 < 60


def test_backends_refuse_rather_than_fall_back():
    # NCCL needs a card a rank: more ranks than cards raises
    with pytest.raises(RuntimeError, match="card a rank"):
        mesh.check_backend("nccl", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="backend"):
        mesh.check_backend("mpi", 1)
    if torch.cuda.device_count() == 0:
        # a rank runs on the card unless told otherwise: no card, no rank
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.rank_device()
    assert mesh.rank_device("cpu") == torch.device("cpu")
