"""The system under test: the entry points of ``slamnet_tpu_torch`` the cells
drive, and the configuration files turned into its ``HectorConfig``.

This is the only module of the harness that imports the program (the
sharded kind's ranks import its multi-device layer too).  Each function is
the program's own entry, called as a user of the package calls it:
``models/hector.update`` for one robot, ``models/fleet.update_fleet`` for a
fleet, ``models/hector_sharded.make_step``'s ``Step`` on a mesh.
"""
from __future__ import annotations

import torch

from slamnet_tpu_torch.core.config import HectorConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import fleet, hector


def hector_config(d: dict) -> HectorConfig:
    """A configuration's ``"hector"`` group as the program's config."""
    return HectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items()})


class Robots:
    """One robot (``hector.update``) or a fleet (``fleet.update_fleet``) as
    one interface: ``init`` a state at start poses f32[B, 3], ``step`` every
    robot once, forced or matched from its own pose."""

    def __init__(self, cfg_dict: dict, robots: int, device):
        self.cfg = hector_config(cfg_dict)
        self.robots = robots
        self.device = torch.device(device)
        self._zero = torch.zeros(3, dtype=torch.float32, device=self.device)

    def init(self, start_poses: torch.Tensor):
        if self.robots == 1:
            return hector.init(self.cfg, start_poses[0], self.device)
        return fleet.init_fleet(self.cfg, start_poses, self.device)

    def step(self, state, points, valid, force: bool, cfg=None):
        """One scan per robot (``points`` f32[B, N, 2]); returns (state,
        match poses f32[B, 3], map_updated bool[B]) on the device."""
        cfg = self.cfg if cfg is None else cfg
        if self.robots == 1:
            state, info = hector.update(
                state, Scan(points[0], valid[0], self._zero),
                state.match_pose, cfg, force)
            return state, state.match_pose[None], info.map_updated[None]
        state, info = fleet.update_fleet(state, points, valid, cfg, force)
        return state, state.match_pose, info.map_updated

    def clone(self, state):
        """A copy of ``state`` (a new job starts from the bootstrapped one;
        each job's maps and poses stay its own)."""
        return type(state)(*(t.clone() for t in state))

    def set_pose(self, state, poses: torch.Tensor):
        """``state`` with every robot's match pose set to ``poses`` f32[B, 3]
        (the bootstrap maps at the true pose)."""
        return state._replace(match_pose=(poses[0] if self.robots == 1
                                          else poses).clone())
