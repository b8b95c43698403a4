"""The comparison that decides ``correct`` shown to fail: a run of each
kind on the CPU at a small size, with the timed path replaced or broken
underneath by ``control.py``'s plants (the control, a step that leaves
its state unchanged, an answer altered where it is produced), comes out
not correct.  The look for a card is skipped; the rest of a run is driven
as ``run.py`` drives it.  Run: ``python -m pytest slambench -q``."""
from __future__ import annotations

import time

import pytest
import torch

from slambench import control
from slambench.kinds import sharded
from slambench.run import run_cell
from slambench.test_slambench_harness import FLEET, tiny, tiny_sharded
from slamnet_tpu_torch.models import fleet
from slamnet_tpu_torch.models.hector import HectorState
from slamnet_tpu_torch.parallel import launch as launch_mod
from slamnet_tpu_torch.parallel.mesh import Mesh

SEED = 2 ** 31 + 11
CELLS = [("robot_replay", {}), ("robot_replay", FLEET), ("robot_live17", {})]
IDS = ["robot_replay", "robot_replay_fleet", "robot_live17"]


def run(name, fleet_kw=None, seconds=0.5):
    cfg, tr = tiny(name, **(fleet_kw or {}))
    return run_cell(name, SEED, seconds, False, "cpu", time.time(), cfg, tr)


@pytest.mark.parametrize("name,fleet_kw", CELLS, ids=IDS)
def test_a_sound_run_is_correct(name, fleet_kw):
    result, checks = run(name, fleet_kw)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("plant", control.PLANTS)
@pytest.mark.parametrize("name,fleet_kw", CELLS, ids=IDS)
def test_a_planted_fault_or_the_control_fails(name, fleet_kw, plant):
    """``altered``: the 12th match (the 4th of the window, after 4
    bootstrap and 4 warm-up scans) moves one robot's x by five times the
    cell's pose limit."""
    cfg, tr = tiny(name, **fleet_kw)
    result, checks = control.run_planted(name, plant, SEED, 2.0, "cpu",
                                         cfg, tr)
    assert not result["correct"], checks


def test_half_the_fleet_left_out_fails(monkeypatch):
    """Only the first half of the robots is served; the rest keep their
    state."""
    real = fleet.update_fleet

    def half(states, points, valid, cfg, force=False, plain=False):
        b = points.shape[0]
        h, c = b // 2, cfg.total_cells
        sub = HectorState(states.maps[:h * c], states.match_pose[:h],
                          states.last_update_pose[:h])
        new, info = real(sub, points[:h], valid[:h], cfg, force, plain)
        pose = torch.cat([new.match_pose, states.match_pose[h:]])
        last = torch.cat([new.last_update_pose, states.last_update_pose[h:]])
        fired = torch.cat([info.map_updated,
                           torch.zeros(b - h, dtype=torch.bool)])
        return HectorState(states.maps, pose, last), info._replace(
            map_updated=fired)
    monkeypatch.setattr(fleet, "update_fleet", half)
    result, checks = run("robot_replay", FLEET)
    assert not result["correct"], checks


# ------------------------------------------------------- the sharded kind
def rank_without_exchange(**kwargs):
    """A rank of the sharded kind whose collectives of the step exchange
    nothing: each rank sums and marks only its own beams and rows."""
    Mesh.psum = lambda self, x, axes: x
    Mesh.pmax = lambda self, x, axes: x
    Mesh.ppermute = lambda self, x, axis, perm=None: x
    return sharded.rank_main(**kwargs)


def run_sharded():
    cfg, tr = tiny_sharded()
    return sharded.run("sharded", cfg, tr, SEED, 1.0, False, "cpu",
                       time.time(), [])


def test_sharded_sound_and_without_the_exchange(monkeypatch):
    result, checks = run_sharded()
    assert result["correct"], checks
    real = launch_mod.launch

    def launch(target, *args, **kwargs):
        return real("slambench.test_slambench_faults:rank_without_exchange",
                    *args, **kwargs)
    monkeypatch.setattr(launch_mod, "launch", launch)
    result, checks = run_sharded()
    assert not result["correct"], checks
