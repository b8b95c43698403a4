"""Single-step entry point: one Hector update at bench scale.

Port of ``__graft_entry__.py:23-45`` with an explicit device: ``entry(device)``
returns ``(step, (state, points, valid))``; ``step`` runs one matched update
of the 3-level 400x400 pipeline in the JAX entry's own configuration
(``HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))``, the bench's
reference-exact ``fixed`` mode: K3 match + motion-gated K4 line update) and
returns the new state.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.scan import Scan
from .models import hector
from .replay import fixed_config


def entry(device: torch.device | str = "cuda"):
    cfg = fixed_config()
    n = 400
    state = hector.init(cfg, (20.0, 20.0, 0.0), device)
    rng = np.random.default_rng(0)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    radii = rng.uniform(2.0, 20.0, n).astype(np.float32)
    pts = np.stack([radii * np.cos(angles), radii * np.sin(angles)], -1)
    points = torch.as_tensor(pts, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    zero = torch.zeros(3, dtype=torch.float32, device=device)

    def step(state: hector.HectorState, points: torch.Tensor,
             valid: torch.Tensor) -> hector.HectorState:
        new_state, _ = hector.update(state, Scan(points, valid, zero),
                                     state.match_pose, cfg,
                                     map_without_matching=False)
        return new_state

    return step, (state, points, valid)
