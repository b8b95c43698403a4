"""Carry Hector state between this package and the JAX package, as numpy.

``hector_state_from_numpy`` takes the arrays of a ``slamnet_tpu``
``HectorState`` (``maps``, ``match_pose``, ``last_update_pose``, e.g.
``np.asarray(jax_state.maps)``) and builds this package's state on
``device``; ``hector_state_to_numpy`` gives back a dict with the same three
names, so ``slamnet_tpu.models.hector.HectorState(**d)`` rebuilds the JAX
state.

``fleet_state_from_numpy`` / ``fleet_state_to_numpy`` do the same for a
fleet's state (``slamnet_tpu.models.fleet``): flat maps f32[B*C] and poses
f32[B, 3].
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
    return HectorState(maps_t, t(match_pose), t(last_update_pose))


def hector_state_to_numpy(state: HectorState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).detach().cpu().numpy().copy()
            for name in FIELDS}


def fleet_state_from_numpy(maps, match_pose, last_update_pose,
                           device: torch.device | str = "cpu") -> HectorState:
    """A fleet state from flat ``maps`` f32[B*C] and poses f32[B, 3]."""
    st = hector_state_from_numpy(maps, match_pose, last_update_pose, device)
    for name in ("match_pose", "last_update_pose"):
        pose = getattr(st, name)
        if pose.dim() != 2 or pose.shape[1] != 3 \
                or st.maps.numel() % pose.shape[0]:
            raise ValueError(f"{name} must be [B, 3] with B dividing the "
                             f"{st.maps.numel()} map cells, got "
                             f"{tuple(pose.shape)}")
    return st


fleet_state_to_numpy = hector_state_to_numpy
