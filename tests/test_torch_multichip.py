"""``python -m slamnet_tpu_torch.multichip``: dryrun_multichip(4)'s flows as
4 gloo ranks on the CPU, against the JAX package on 4 virtual CPU devices.

One ``multichip.run`` (ONE launch of 4 ranks, the env rendezvous, the plain
versions) at a cut depth and JAX's full widths: the sharded Hector over the
first 16 scans of ``make_log(0)`` (10 forced, 6 matched) on the 2x2 and 4x1
meshes with its checkpoint at scan 13 resumed on both and the onehot_bf16
and exit runs on 2x2, the production and parity CoreSLAM over 16 scans on
2x2, section 3's first 30 scans on 2x2 in both
frontends (the first loop closure is at scan 29) with the onehot_bf16
run's rebuild on 4x1 and its checkpoint at scan 15 resumed on 2x2 and
restored on 4x1, every collective of both meshes, the edge-sharded GN,
the Schur step and the loop-closure cluster's separator overflow.  The ranks hold themselves
to the dense pipeline (``multichip``'s own checks); this file holds them to
JAX.  The mesh fleet's section runs in ``tests/test_torch_mesh_fleet.py``
on 8 ranks and on the card; its single-process references take most of a
minute here, so it is left out of this run.

JAX runs live in this process, as ``scripts/torch_port_ref_ate.py
--sharded / --sharded-graph --devices 4 --scans K`` runs it (its
``run_sharded`` and ``run_sharded_graph``): ``hector_sharded`` and
``coreslam_sharded`` on ``make_mesh({"tile": 2, "search": 2})`` and
``({"tile": 4, "search": 1})``, ``graph_slam_sharded`` on the 2x2 mesh in
both frontends, over ``jax.devices()[:4]`` and the same numpy logs.

Tolerances: tests/test_torch_hector_sharded.py's, JAX's own sharded-vs-
dense ones (a replay's poses 5e-3 m), and the chip's ATE gate (JAX's ATE
+ 1e-4); CoreSLAM's ATE within 2e-3 of JAX's (``replay.coreslam_gate``'s
slack; its own sharded-vs-dense check is bit for bit); the graph through
``replay.graph_gate`` (the same keyframes, ATE within 15%, max within
0.01 m) with JAX's keyframe and closure scans exactly.
"""
import concurrent.futures
import importlib.util
import os

import numpy as np
import pytest

from slamnet_tpu_torch import multichip, replay

CARDS = 4
HECTOR_SCANS, CORESLAM_SCANS, GRAPH_SCANS = 16, 16, 30
SECTIONS = ("collectives", "hector", "coreslam", "graph", "posegraph",
            "checkpoint")
POSE_TOL = 5e-3
ATE_SLACK = 1e-4
CORESLAM_SLACK = 2e-3
GRAPH_MODES = ("onehot_bf16", "gather")


def _ref_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_port_ref_ate.py")
    spec = importlib.util.spec_from_file_location("torch_port_ref_ate", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def _jax_flows():
    """JAX's sharded flows on 4 of the 8 virtual CPU devices."""
    import jax
    assert len(jax.devices()) >= CARDS
    ref = _ref_script()
    out = ref.run_sharded(replay.make_log(0), CARDS, HECTOR_SCANS,
                          with_poses=True)
    full = replay.make_sharded_graph_log()
    glog = full._replace(traj=full.traj[:GRAPH_SCANS],
                         radii=full.radii[:GRAPH_SCANS],
                         valid=full.valid[:GRAPH_SCANS])
    for mode in GRAPH_MODES:
        out[f"graph_{mode}"] = ref.run_sharded_graph(glog, mode, CARDS)
    return out


@pytest.fixture(scope="module")
def both():
    """The port's 4 ranks (subprocesses, waited on from a thread) while JAX
    runs here: the two runs share nothing but the inputs' seeds."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(multichip.run, CARDS, "gloo", "cpu", HECTOR_SCANS,
                           CORESLAM_SCANS, GRAPH_SCANS, SECTIONS,
                           timeout_s=600.0)
        jax_out = _jax_flows()
        return port.result(), jax_out


@pytest.fixture(scope="module")
def out(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_out(both):
    return both[1]


@pytest.fixture(scope="module")
def num(out):
    return out["ranks"][0]["numbers"]


def test_every_rank_on_its_device_and_every_section_ran(out, num):
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == list(range(CARDS))
    assert all(r["device"] == "cpu" and r["backend"] == "gloo"
               for r in ranks)
    # gloo on CPU tensors stages nothing; the plain versions launch nothing
    assert all(c["host_copies"] == 0 for r in ranks
               for c in r["counts"].values())
    assert all(not c for r in ranks for c in r["launches"].values())
    assert set(num) == {"collective_us", "hector", "coreslam", "graph",
                        "posegraph", "checkpoint"}
    lines = multichip.report(out, CARDS, "gloo")
    assert any("1. sharded Hector 4x1" in ln for ln in lines)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_hector_follows_jax_at_4_devices(num, jax_out, mesh):
    o, j = num["hector"][mesh], jax_out[f"hector_{mesh}"]
    poses = np.asarray(o["poses"])
    assert poses.shape == (HECTOR_SCANS - 10, 3)
    assert np.abs(poses - np.asarray(j["poses"])).max() <= POSE_TOL
    assert o["ate_m"] <= j["ate_m"] + ATE_SLACK
    # JAX's count has the 10 forced scans' updates too
    assert o["map_updates"] + HECTOR_SCANS - o["scans"] == j["map_updates"]
    assert o["collectives_per_scan"] == 17
    assert o["pose_err_m"] <= POSE_TOL and o["map_err"] <= 1e-2
    if mesh == "2x2":             # onehot_bf16 and the exit on the first mesh
        m = o["modes"]
        assert m["onehot_bf16"]["scans"] == HECTOR_SCANS - 10
        assert m["onehot_bf16"]["pose_err_m"] <= POSE_TOL
        assert m["exit"]["pose_err_m"] <= POSE_TOL
        assert m["exit"]["gn_iterations"] < (HECTOR_SCANS - 10) * 15
    else:
        assert "modes" not in o


def test_sharded_coreslam_follows_jax(num, jax_out):
    o = num["coreslam"]["production"]
    assert o["scans"] == CORESLAM_SCANS
    j = jax_out["coreslam_production_2x2"]
    assert abs(o["ate_m"] - j["ate_m"]) <= CORESLAM_SLACK
    # the parity mode (Monte-Carlo, line updates) ran too, bit for bit the
    # dense pipeline's (the ranks' own check)
    assert num["coreslam"]["parity"]["scans"] == CORESLAM_SCANS


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_sharded_graph_follows_jax_at_4_devices(num, jax_out, mode):
    o, j = num["graph"][mode], jax_out[f"graph_{mode}"]
    assert j["max_overflow"] == 0 and j["loop_closures"] >= 1
    assert replay.graph_gate(o, j) == []
    flags = np.asarray(o["flags"], bool)
    assert [t for t in range(GRAPH_SCANS) if flags[t, 0]] == \
        j["keyframe_scans"]
    assert [t for t in range(GRAPH_SCANS) if flags[t, 2]] == j["loop_scans"]
    assert o["keyframes"] == j["keyframes"]
    assert o["loop_closures"] == j["loop_closures"]
    assert o["max_overflow"] == 0 and o["searches"] >= 1
    assert o["collectives_per_keyframe_event"] == 10
    if mode == "onehot_bf16":     # rebuilt on 4x1 = rebuild_maps
        assert o["rebuild"] == {"mesh": "4x1", "nodes": o["keyframes"]}


def test_collectives_posegraph_and_checkpoint(num):
    assert len(num["collective_us"]) == 2 * 13
    pg = num["posegraph"]
    assert pg["schur_collectives_per_step"] == 3
    assert pg["schur_err_step1"] <= 2e-4 and pg["schur_err_step2"] <= 5e-4
    assert pg["cluster_overflow_small"] > 0 and pg["cluster_slots_big"] == 16
    ck = num["checkpoint"]
    assert ck["saved_on"] == "2x2" and ck["cut"] == 13
    assert ck["2x2"]["bit_for_bit"]
    assert ck["4x1"]["pose_err_m"] <= POSE_TOL
    assert ck["4x1"]["map_err"] <= 1e-2
    # section 3's: resumed on 2x2 bit for bit, restored on 4x1 as saved
    g = ck["graph"]
    assert (g["saved_on"], g["restored_on"], g["cut"]) == ("2x2", "4x1",
                                                          GRAPH_SCANS // 2)
    assert 1 <= g["nodes_at_cut"] < num["graph"]["onehot_bf16"]["keyframes"]


def test_refuses_an_odd_count_and_nccl_without_cards(capsys):
    with pytest.raises(ValueError, match="even device count"):
        multichip.run(3, "gloo", "cpu")
    with pytest.raises(RuntimeError, match="a card a rank"):
        multichip.run(4, "nccl", "cpu")
    # the default is the card: without one, exit 2 and no result line
    assert multichip.main([]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_a_reference_failing_its_own_check_is_flagged(mode):
    # dryrun_multichip(2) misses its own final-error check: at 2x1 the port
    # is held to JAX's numbers only, and the run says so
    assert multichip.jax_fails_own_check(mode, "2x1")
    assert not multichip.jax_fails_own_check(mode, "2x2")
    assert not multichip.jax_fails_own_check(mode, "3x3")
    ref = replay.sharded_graph_reference(mode, "2x1")
    assert multichip.graph_fails(ref, mode, "2x1") == []
    assert replay.sharded_graph_gate(ref, ref) != []
