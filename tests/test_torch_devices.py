"""Which card a kernel and a rank run on.

A kernel wrapper launches through ``ops/_build.launch``, which makes the
tensors' card the current device for the C launcher's call: a
``<<<..., stream>>>`` launch goes to the thread's current device, so
without the guard a kernel on ``cuda:1`` ran on card 0.  Here, without a
card, the library and the guard are stand-ins that record what each
launcher saw; the real launches on cards 1-3 are ``python -m
slamnet_tpu_torch.multichip``'s (README).

A rank of ``parallel.launch`` makes ``cuda:LOCAL_RANK`` current before its
world comes up, and an NCCL world is created on that card
(``device_id``): ``torch.cuda`` and ``dist.init_process_group`` are
stand-ins that record the order of the calls.
"""
import ctypes
import json
import os

import pytest
import torch
import torch.distributed as dist

from slamnet_tpu_torch.core.config import HectorConfig
from slamnet_tpu_torch.ops import _build, fill, line, match
from slamnet_tpu_torch.parallel import mesh, rank

CFG = HectorConfig().overlay(dict(map_size=64, num_levels=2,
                                  estimate_iterations=(2, 1)))
LAUNCHERS = ("slamnet_match", "slamnet_match_batch_exit", "slamnet_fill",
             "slamnet_line")
CACHED = (match._launcher, match._exit_launcher, fill._launcher,
          line._launcher, line._resident, _build.check_device)


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in kernel library and device guard: each C function call is
    recorded with the devices current at the time."""
    current, calls = [], []

    class Guard:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    class Fn:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, list(current), args[-1]))
            return 0

    class Lib:
        def __getattr__(self, name):
            fn = Fn(name)
            setattr(self, name, fn)
            return fn

    for f in CACHED:
        f.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(_build, "library", lambda: (Lib(), 0.0, ""))
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 12345)
    monkeypatch.setattr(_build, "check_device", lambda index: None)
    monkeypatch.setattr(fill, "sm_count", lambda index: 132)
    monkeypatch.setattr(line, "sm_count", lambda index: 132)
    yield calls
    for f in CACHED:
        f.cache_clear()


def _inputs(batch):
    maps = torch.zeros(batch * CFG.total_cells)
    points = torch.zeros((batch, 8, 2))
    valid = torch.ones((batch, 8), dtype=torch.bool)
    poses = torch.zeros((batch, 3))
    return maps, points, valid, poses


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_every_launch_runs_with_its_tensors_card_current(recorder, launcher):
    maps, points, valid, poses = _inputs(2)
    fire = torch.ones(2, dtype=torch.bool)
    call = {"slamnet_match": lambda: match._launch(
                "K3", maps, points, valid, poses, CFG, 2, 1),
            "slamnet_match_batch_exit": lambda: match._launch_exit(
                "K3 exit", maps, points, valid, poses, CFG, 2),
            "slamnet_fill": lambda: fill._launch(
                "K2", maps, points, valid, poses, poses, fire, CFG, 2),
            "slamnet_line": lambda: line._launch(
                "K4", maps, points, valid, poses, poses, fire, CFG, 2)}
    call[launcher]()
    launches = [c for c in recorder if c[0] in LAUNCHERS]
    # one call of the launcher, inside the guard of the maps' device, on
    # the stream of that device
    assert [(name, devs, stream) for name, devs, stream in launches] == \
        [(launcher, [maps.device], 12345)]


def test_launch_raises_on_the_launchers_error_code(recorder, monkeypatch):
    def failing(*args):
        return 700

    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.launch("K1 match", failing, torch.device("cpu"), 1, 2)


@pytest.fixture
def world(monkeypatch, tmp_path):
    """``torch.cuda`` with 4 cards and ``dist.init_process_group`` as
    stand-ins that record their calls in order."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: calls.append(("set_device",
                                                  torch.device(dev))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(("init", kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    return calls


def _spec(tmp_path, backend, rendezvous="file"):
    spec = {"target": "json:dumps", "kwargs": {"obj": [1, 2]},
            "backend": backend, "world_size": 4, "rendezvous": rendezvous,
            "init_method": f"file://{tmp_path / 'rendezvous'}",
            "timeout_s": 10.0, "out": str(tmp_path)}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    return str(path)


def test_rank_binds_its_card_before_the_nccl_world(world, tmp_path):
    assert rank.main(_spec(tmp_path, "nccl")) == 0
    cuda2 = torch.device("cuda", 2)
    assert [c[0] for c in world] == ["set_device", "set_device", "init"]
    assert all(dev == cuda2 for what, dev in world[:2])
    kw = world[2][1]
    assert kw["backend"] == "nccl" and kw["rank"] == 2 \
        and kw["world_size"] == 4 and kw["device_id"] == cuda2
    assert json.loads((tmp_path / "result_2.json").read_text()) == "[1, 2]"


def test_env_rendezvous_binds_before_initialize_multihost(world, tmp_path,
                                                          monkeypatch):
    # the target brings the world up itself: the rank binds first anyway,
    # and initialize_multihost binds again before its world
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert rank.main(_spec(tmp_path, "nccl", "env")) == 0
    assert [c[0] for c in world] == ["set_device"]
    mesh.initialize_multihost("nccl", timeout_s=10.0)
    assert [c[0] for c in world] == ["set_device", "set_device", "init"]
    assert world[2][1]["device_id"] == torch.device("cuda", 2)
    assert world[2][1]["init_method"] == "env://"


def test_gloo_binds_the_card_but_creates_the_world_without_device_id(
        world, tmp_path):
    assert rank.main(_spec(tmp_path, "gloo")) == 0
    assert [c[0] for c in world] == ["set_device", "set_device", "init"]
    assert "device_id" not in world[2][1]


def test_gloo_on_a_host_without_a_card_binds_nothing(world, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert rank.main(_spec(tmp_path, "gloo")) == 0
    assert [c[0] for c in world] == ["init"]


def test_nccl_refuses_more_ranks_than_cards(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="a card a rank"):
        rank.main(_spec(tmp_path, "nccl"))
    assert [c[0] for c in world if c[0] == "init"] == []


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.bind_device("nccl")
