"""The node-sharded Schur GN step: slamnet_tpu_torch.graph.schur on 8 gloo
ranks against JAX's graph.schur on the 8-device CPU mesh.

The graphs are ``tests/test_posegraph.py``'s circle (numpy seed 0): 128
nodes with noisy odometry edges and two exact closures in 256 edge slots;
the same with a gross outlier edge (for the robust kernel); and 64 nodes
whose first block is tied to the fifth by a cluster of loop edges (every
node of block 0 a separator), which overflows ``sep_capacity=2``.  The port
runs on 8 gloo ranks on the CPU (``parallel/launch.py``, ONE launch for the
file, a 'node' axis of 8); JAX runs ``schur_gn_step`` on
``make_mesh({"node": 8})`` under ``jax.jit`` (outside jit its shard_map
runs op by op, ~40 s a step here), on the same numpy arrays.

Tolerances are JAX's own (``tests/test_posegraph.py:113-122``): the step
within rtol/atol 2e-4 after one step and 5e-4 after two; the overflow
counts equal; with enough slots, the dense step within 2e-3.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core.geometry import pose_between, pose_compose
from slamnet_tpu.graph import posegraph as jpg
from slamnet_tpu.graph import schur as jschur
from slamnet_tpu.parallel import make_mesh as jmake_mesh
from slamnet_tpu_torch.graph import posegraph as tpg
from slamnet_tpu_torch.graph import schur
from slamnet_tpu_torch.parallel import launch

LAUNCH_TIMEOUT_S = 300
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
INT = ("num_nodes", "edge_i", "edge_j", "num_edges")
BOOL = ("node_valid", "edge_valid")
HUBER = 3.0
# (name, graph, sep_capacity, huber_delta, steps)
CASES = [("circle", "c128", 8, 0.0, 2), ("huber", "c128w", 8, HUBER, 2),
         ("over2", "c64x", 2, 0.0, 1), ("over16", "c64x", 16, 0.0, 1)]


def _circle_graph(n, max_nodes, max_edges, odo_noise=0.03, radius=5.0):
    """tests/test_posegraph.py's circle (JAX's posegraph, numpy seed 0)."""
    rng = np.random.default_rng(0)
    ths = np.linspace(0, 2 * math.pi, n, endpoint=False)
    truth = np.stack([radius * np.cos(ths), radius * np.sin(ths),
                      ths + math.pi / 2], -1).astype(np.float32)
    g = jpg.init(max_nodes, max_edges)
    est = truth[0].copy()
    g, _ = jpg.add_node(g, est)
    for t in range(1, n):
        rel = np.asarray(pose_between(jnp.asarray(truth[t - 1]),
                                      jnp.asarray(truth[t])))
        noisy = rel + rng.normal(0, odo_noise, 3).astype(np.float32)
        est = np.asarray(pose_compose(jnp.asarray(est), jnp.asarray(noisy)))
        g, _ = jpg.add_node(g, est)
        g = jpg.add_edge(g, t - 1, t, noisy, (10.0, 10.0, 40.0))
    for i, j in ((0, n // 2), (n - 1, 0)):
        rel = np.asarray(pose_between(jnp.asarray(truth[i]),
                                      jnp.asarray(truth[j])))
        g = jpg.add_edge(g, i, j, rel, (100.0, 100.0, 400.0))
    return g, truth


def _graphs():
    """The three JAX graphs by name."""
    c128, _ = _circle_graph(128, 128, 256)
    wild = jpg.add_edge(c128, 2, 66, np.asarray([4.0, -4.0, 1.5], np.float32),
                        (100.0, 100.0, 400.0))
    c64, truth = _circle_graph(64, 64, 256)
    m = 64 // 8
    for t in range(m):          # block 0's node t <-> block 4's node t
        rel = np.asarray(pose_between(jnp.asarray(truth[t]),
                                      jnp.asarray(truth[t + 4 * m])))
        c64 = jpg.add_edge(c64, t, t + 4 * m, rel, (10.0, 10.0, 40.0))
    return {"c128": c128, "c128w": wild, "c64x": c64}


def _port(g) -> tpg.PoseGraph:
    return tpg.PoseGraph(**{k: torch.tensor(
        np.asarray(getattr(g, k)), dtype=torch.int32 if k in INT else
        torch.bool if k in BOOL else torch.float32) for k in tpg.PoseGraph._fields})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schur")
    graphs = _graphs()
    np.savez(tmp / "in.npz", **{f"{name}_{k}": np.asarray(getattr(g, k))
                                for name, g in graphs.items()
                                for k in jpg.PoseGraph._fields})
    launch.launch("_torch_sharded_ranks:schur", 8,
                  {"data": str(tmp / "in.npz"), "out": str(tmp / "out.npz"),
                   "cases": CASES},
                  backend="gloo", timeout_s=LAUNCH_TIMEOUT_S,
                  pythonpath=[TESTS_DIR])
    port = dict(np.load(tmp / "out.npz"))
    mesh = jmake_mesh({"node": 8})
    jax_out = {}
    for name, gname, cap, huber, steps in CASES:
        g = graphs[gname]
        step = jax.jit(functools.partial(jschur.schur_gn_step, mesh,
                                         sep_capacity=cap, huber_delta=huber))
        for i in range(steps):
            g, of = step(g)
            jax_out[f"{name}_step{i + 1}"] = np.asarray(g.poses)
            jax_out[f"{name}_overflow{i + 1}"] = int(of)
    return dict(port=port, jax=jax_out, graphs=graphs)


@pytest.mark.parametrize("name", ["circle", "huber"])
def test_schur_step_equals_jax(run, name):
    # one step within 2e-4 of JAX's node-sharded step, two within 5e-4
    # (JAX's tolerances against its dense step); no overflow at 8 slots
    p, j = run["port"], run["jax"]
    for step, tol in ((1, 2e-4), (2, 5e-4)):
        np.testing.assert_allclose(p[f"{name}_step{step}"],
                                   j[f"{name}_step{step}"], rtol=tol,
                                   atol=tol, err_msg=f"step {step}")
        assert int(p[f"{name}_overflow{step}"]) == 0 == \
            j[f"{name}_overflow{step}"]


def test_schur_step_equals_dense(run):
    # and within the same tolerances of the port's dense GN step
    g = _port(run["graphs"]["c128"])
    for step, tol in ((1, 2e-4), (2, 5e-4)):
        g = tpg.gn_step(g, num_nodes=128)
        np.testing.assert_allclose(run["port"][f"circle_step{step}"],
                                   g.poses.numpy(), rtol=tol, atol=tol,
                                   err_msg=f"step {step}")


def test_huber_moves_the_step(run):
    # the robust kernel changes the step (the outlier's pull is cut)
    p = run["port"]
    assert np.abs(p["huber_step1"] - p["circle_step1"]).max() > 1e-3


def test_overflow_is_loud(run):
    # at 2 slots the cluster's block overflows: the count is JAX's integer;
    # at 16 it is 0 and the step is the dense one (JAX's 2e-3)
    p, j = run["port"], run["jax"]
    assert int(p["over2_overflow1"]) == j["over2_overflow1"] > 0
    assert int(p["over16_overflow1"]) == j["over16_overflow1"] == 0
    dense = tpg.gn_step(_port(run["graphs"]["c64x"]), num_nodes=64)
    np.testing.assert_allclose(p["over16_step1"], dense.poses.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(p["over16_step1"], j["over16_step1"],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cap", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("gname", ["c128", "c64x"])
def test_check_separator_capacity_equals_jax(run, gname, cap):
    g = run["graphs"][gname]
    assert schur.check_separator_capacity(_port(g), 8, cap) == \
        jschur.check_separator_capacity(g, 8, cap)


def test_three_collectives_a_step(run):
    # the slot all_gather, ONE psum (system, right side, overflow), the pose
    # all_gather; and every rank holds the same poses
    p = run["port"]
    for name, *_ in CASES:
        assert float(p[f"{name}_collectives"]) == 3.0, name
    assert bool(p["ranks_equal"])


def test_schur_optimize(run):
    # schur_optimize is the steps in a row; its worst overflow is 0 here
    p = run["port"]
    g = _port(run["graphs"]["c128"])
    for _ in range(3):
        g = tpg.gn_step(g, num_nodes=128)
    np.testing.assert_allclose(p["optimize"], g.poses.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert int(p["optimize_overflow"]) == 0
