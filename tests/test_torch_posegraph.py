"""slamnet_tpu_torch.graph.posegraph against slamnet_tpu.graph.posegraph.

The same random graph, made with numpy: 40 nodes in 128 slots (so the
active prefix is the 64-node bucket), 39 odometry edges and 30 loop edges
with noisy measurements in 160 edge slots (and a twin whose last loop edge
is a gross outlier, for the robust kernels).  The port assembles H and b as a
product with the edge-incidence matrix where JAX scatters blocks, so the
sums run in another order: H and b agree to rtol 1e-5 (with an absolute
floor of 1e-5 of H's largest non-anchor entry), and a GN step's poses to
1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.graph import posegraph as jpg
from slamnet_tpu_torch.graph import posegraph as tpg

K, E, NODES, LOOPS = 128, 160, 40, 30
INT = ("num_nodes", "edge_i", "edge_j", "num_edges")
BOOL = ("node_valid", "edge_valid")


def _graph_arrays(seed=0, wild=False):
    """A drifting 40-node walk with odometry and loop edges, as numpy;
    ``wild`` makes the last loop edge a gross outlier."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((NODES, 3))
    for n in range(1, NODES):
        th = truth[n - 1, 2] + rng.uniform(-0.4, 0.4)
        step = rng.uniform(0.3, 0.8)
        truth[n] = [truth[n - 1, 0] + step * np.cos(th),
                    truth[n - 1, 1] + step * np.sin(th), th]

    def between(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         b[2] - a[2]])
    pairs = [(n, n + 1) for n in range(NODES - 1)]
    pairs += [tuple(sorted(rng.choice(NODES, 2, replace=False)))
              for _ in range(LOOPS)]
    arrays = {
        "poses": np.zeros((K, 3), np.float32),
        "node_valid": np.zeros(K, bool),
        "num_nodes": np.int32(NODES),
        "edge_i": np.zeros(E, np.int32), "edge_j": np.zeros(E, np.int32),
        "edge_meas": np.zeros((E, 3), np.float32),
        "edge_w": np.ones((E, 3), np.float32),
        "edge_valid": np.zeros(E, bool), "num_edges": np.int32(len(pairs))}
    # the estimate drifts from the truth; the measurements are noisy truth
    arrays["poses"][:NODES] = truth + rng.normal(0, [0.01, 0.01, 0.005],
                                                 (NODES, 3))
    arrays["poses"][0] = truth[0]
    arrays["node_valid"][:NODES] = True
    for e, (i, j) in enumerate(pairs):
        arrays["edge_i"][e], arrays["edge_j"][e] = i, j
        arrays["edge_meas"][e] = between(truth[i], truth[j]) + rng.normal(
            0, [0.02, 0.02, 0.01])
        arrays["edge_w"][e] = (50.0, 50.0, 200.0) if j == i + 1 \
            else (100.0, 100.0, 400.0)
        arrays["edge_valid"][e] = True
    if wild:      # for the robust kernels to down-weight
        arrays["edge_meas"][len(pairs) - 1] += (3.0, -2.0, 1.0)
    return arrays


def _jax(arrays):
    return jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port(arrays):
    return tpg.PoseGraph(**{k: torch.tensor(
        np.asarray(v), dtype=torch.int32 if k in INT else torch.bool
        if k in BOOL else torch.float32) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def graphs():
    arrays = _graph_arrays()
    return arrays, _jax(arrays), _port(arrays)


@pytest.fixture(scope="module")
def wild():
    arrays = _graph_arrays(wild=True)
    return arrays, _jax(arrays), _port(arrays)


def _close_h(got, want):
    off = np.abs(want).copy()
    off[np.abs(want) >= 1e5] = 0.0          # the anchor's 1e6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * off.max())


@pytest.mark.parametrize("robust", [None, "huber", "dcs"])
def test_build_normal_equations_matches_jax(wild, robust):
    _, jg, tg = wild
    kw = {} if robust is None else dict(huber_delta=1.5, robust_kernel=robust)
    jH, jb = jpg.build_normal_equations(jg, **kw)
    tH, tb = tpg.build_normal_equations(tg, **kw)
    assert tH.shape == (3 * K, 3 * K) and tb.shape == (3 * K,)
    _close_h(tH.numpy(), np.asarray(jH))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jb)).max())
    # the active prefix is the full system's top-left block
    aH, ab = tpg.build_normal_equations(tg, active_k=64, **kw)
    np.testing.assert_array_equal(aH.numpy(), tH.numpy()[:192, :192])
    np.testing.assert_array_equal(ab.numpy(), tb.numpy()[:192])


def test_assembly_is_deterministic(graphs):
    # two assemblies of the same graph give the same H and b, bit for bit
    _, _, tg = graphs
    h1, b1 = tpg.build_normal_equations(tg, huber_delta=1.5)
    h2, b2 = tpg.build_normal_equations(tg, huber_delta=1.5)
    assert torch.equal(h1, h2) and torch.equal(b1, b2)


def test_residuals_and_robust_scale_match_jax(wild):
    arrays, jg, tg = wild
    want = jpg.edge_residuals_and_jacobians(jg.poses, jg.edge_i, jg.edge_j,
                                            jg.edge_meas, jg.edge_valid)
    got = tpg.edge_residuals_and_jacobians(tg.poses, tg.edge_i, tg.edge_j,
                                           tg.edge_meas, tg.edge_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    r, w = got[0], tg.edge_w * tg.edge_valid[:, None]
    for kernel in ("huber", "dcs"):
        s = tpg.robust_scale(r, w, 1.5, kernel).numpy()
        np.testing.assert_allclose(
            s, np.asarray(jpg.robust_scale(jnp.asarray(r.numpy()),
                                           jnp.asarray(w.numpy()), 1.5,
                                           kernel)), rtol=1e-6)
        assert s[NODES - 1 + LOOPS - 1] < 0.5     # the wild edge
    with pytest.raises(ValueError, match="robust kernel"):
        tpg.robust_scale(r, w, 1.5, "cauchy")
    np.testing.assert_allclose(float(tpg.total_error(tg)),
                               float(jpg.total_error(jg)), rtol=1e-5)


@pytest.mark.parametrize("iterations", [1, 3])
def test_gn_step_and_optimize_match_jax(graphs, iterations):
    _, jg, tg = graphs
    want = np.asarray(jpg.optimize(jg, iterations=iterations).poses)
    got = tpg.optimize(tg, iterations=iterations, num_nodes=NODES).poses
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got[NODES:], tg.poses[NODES:])   # empty slots stay
    # the error falls
    err0 = float(tpg.total_error(tg))
    assert float(tpg.total_error(tg._replace(poses=got))) < err0
    # the 64-node bucket's step gives the full 128-node system's poses
    np.testing.assert_allclose(tpg.gn_step(tg, num_nodes=NODES).poses.numpy(),
                               tpg.gn_step(tg, num_nodes=K).poses.numpy(),
                               atol=1e-5)


def test_active_prefix_solve_equals_full_solve(graphs):
    # 40 nodes: the 64-node bucket's solve gives the full system's dx
    _, _, tg = graphs
    assert tpg._size_buckets(K) == [32, 64, 128]
    assert [tpg.bucket(K, n) for n in (1, 32, 33, 64, 65, 128)] == \
        [32, 32, 64, 64, 128, 128]
    H, b = tpg.build_normal_equations(tg)
    full = torch.linalg.solve(H, -b)
    dx = tpg._active_gn_dx(tg, 1e6, 1e-6, 0.0, NODES)
    np.testing.assert_allclose(dx.numpy(), full.numpy(), atol=1e-5)
    assert torch.equal(dx[192:], torch.zeros(3 * K - 192))


def test_solve_schur_equals_dense_solve(graphs):
    # an f32 elimination of a chain's ill-conditioned H: JAX's own test's
    # tolerance (tests/test_posegraph.py:99)
    _, jg, tg = graphs
    H, b = tpg.build_normal_equations(tg, active_k=64)
    dense = torch.linalg.solve(H, -b)
    for keep in (10, 40):
        np.testing.assert_allclose(tpg.solve_schur(H, b, keep).numpy(),
                                   dense.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(
        tpg.solve_schur(H, b, 40).numpy(),
        np.asarray(jpg.solve_schur(jnp.asarray(H.numpy()),
                                   jnp.asarray(b.numpy()), 40)),
        rtol=2e-3, atol=2e-4)


def test_add_node_and_edge_at_capacity():
    # fill a 3-node, 2-edge graph past capacity in both packages: the
    # clamped index, the counters and the untouched slots agree
    jg, tg = jpg.init(3, 2), tpg.init(3, 2, device="cpu")
    for n in range(5):
        pose = (1.0 + n, 2.0 * n, 0.1 * n)
        jg, ji = jpg.add_node(jg, jnp.asarray(pose, jnp.float32))
        tg, ti = tpg.add_node(tg, pose)
        assert int(ti) == int(ji) == min(n, 2)
        assert bool(tpg.has_node_room(tg)) == bool(jpg.has_node_room(jg))
    for e in range(4):
        meas = (0.5 * e, -0.5, 0.02 * e)
        jg = jpg.add_edge(jg, e % 3, (e + 1) % 3, meas, (2.0, 3.0, 4.0),
                          enable=e != 1)
        tg = tpg.add_edge(tg, e % 3, (e + 1) % 3, meas, (2.0, 3.0, 4.0),
                          enable=e != 1)
    # a device flag gates as a bool does
    tg = tpg.add_edge(tg, 0, 1, (9.0, 9.0, 9.0),
                      enable=torch.zeros((), dtype=torch.bool))
    for k in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    assert int(tg.num_nodes) == 3 and int(tg.num_edges) == 2
