"""Carry Hector state between this package and the JAX package, as numpy.

``hector_state_from_numpy`` takes the arrays of a ``slamnet_tpu``
``HectorState`` (``maps``, ``match_pose``, ``last_update_pose``, e.g.
``np.asarray(jax_state.maps)``) and builds this package's state on
``device``; ``hector_state_to_numpy`` gives back a dict with the same three
names, so ``slamnet_tpu.models.hector.HectorState(**d)`` rebuilds the JAX
state.  The K2 scratch ``marks`` has no JAX counterpart and starts at zero.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.hector import HectorState

FIELDS = ("maps", "match_pose", "last_update_pose")


def hector_state_from_numpy(maps, match_pose, last_update_pose,
                            device: torch.device | str = "cpu") -> HectorState:
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    maps_t = t(maps)
    if maps_t.dim() != 1:
        raise ValueError(f"maps must be flat f32[total_cells], got {maps_t.shape}")
    return HectorState(maps_t, t(match_pose), t(last_update_pose),
                       torch.zeros(maps_t.shape, dtype=torch.uint8,
                                   device=device))


def hector_state_to_numpy(state: HectorState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).detach().cpu().numpy().copy()
            for name in FIELDS}
