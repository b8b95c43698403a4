"""The reference's object API: ``CoreSLAMProcessor`` / ``HectorSLAMProcessor``.

Port of ``slamnet_tpu/compat.py``.  A user of the reference drives
processor objects with ``Update(...)`` / ``Reset()`` and reads ``Pose`` /
``MatchPose`` (CoreSLAM/CoreSLAMProcessor.cs:119-175,717;
HectorSLAM/Main/HectorSLAMProcessor.cs:66-138).  These stateful wrappers give
that surface over the functional models: each ``Update`` is one call of
``models.coreslam.update`` / ``models.hector.update`` (the default
``gather`` matcher and line updates run K3 + K4, ``matcher_mode=
"onehot_bf16"`` K1), and the state lives on the device between calls.  A
property write rebuilds the configuration, as JAX's ``_set_cfg`` re-jits.

``HectorSLAMProcessor.Update`` reads the map-updated flag and the failed
solves back to the host (one read a scan, as JAX's does); the properties
(``Pose``, ``MatchPose``, ``MapRep``, ...) read the state.  The
constructors put the state on the card unless ``device`` names another.
"""
from __future__ import annotations

import dataclasses
import time as time_module
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.config import CoreSlamConfig, HectorConfig
from .core.scan import Scan, SegmentScan
from .io import export
from .io.metrics import EmaTimer
from .models import coreslam, hector


def _on(device: torch.device, tup):
    """A Scan / SegmentScan with its fields as tensors on ``device``."""
    return type(tup)(*(torch.as_tensor(x, device=device) for x in tup))


class CoreSLAMProcessor:
    """Mirror of CoreSLAM/CoreSLAMProcessor.cs's public surface."""

    def __init__(self, physical_map_size: float, hole_map_size: int,
                 obstacle_map_size: int, start_pose,
                 sigma_xy: float, sigma_theta: float,
                 iterations_per_thread: int = 1000,
                 num_search_threads: int = 4, *,
                 hole_width: float = 0.6, quality: int = 50, seed: int = 0,
                 device: torch.device | str = "cuda"):
        # threads x iterations becomes one candidate batch (SURVEY.md §2.5 P2)
        num_candidates = max(iterations_per_thread * max(num_search_threads, 1),
                             1)
        self.cfg = CoreSlamConfig(
            physical_map_size=physical_map_size, hole_map_size=hole_map_size,
            obstacle_map_size=obstacle_map_size, sigma_xy=sigma_xy,
            sigma_theta=sigma_theta, num_candidates=num_candidates,
            hole_width=hole_width, quality=quality)
        self.device = torch.device(device)
        self._start_pose = np.asarray(start_pose, np.float32)
        self._seed = seed
        self.Reset()

    def Reset(self) -> None:
        """CoreSLAMProcessor.Reset (:167-175): fresh maps at the start pose,
        the generator seeded anew."""
        self.state = coreslam.init(self.cfg, self._start_pose, seed=self._seed,
                                   device=self.device)

    def Update(self, segments: SegmentScan) -> None:
        """CoreSLAMProcessor.Update (:717-752); segments as a SegmentScan."""
        self.state, _ = coreslam.update(self.state, _on(self.device, segments),
                                        self.cfg)

    def Dispose(self) -> None:
        """IDisposable parity (CoreSLAMProcessor.cs:767-773).  The reference
        throws when constructed with numSearchThreads <= 0 (SURVEY.md §2.2);
        here that is safe."""
        self.state = None

    def _set_cfg(self, **kw) -> None:
        """Mutable-property parity (CoreSLAMProcessor.cs:80-101)."""
        self.cfg = dataclasses.replace(self.cfg, **kw)

    @property
    def Quality(self) -> int:
        return self.cfg.quality

    @Quality.setter
    def Quality(self, v: int) -> None:
        self._set_cfg(quality=int(v))

    @property
    def HoleWidth(self) -> float:
        return self.cfg.hole_width

    @HoleWidth.setter
    def HoleWidth(self, v: float) -> None:
        self._set_cfg(hole_width=float(v))

    @property
    def PositionSearchBeginning(self) -> int:
        return self.cfg.position_search_beginning

    @PositionSearchBeginning.setter
    def PositionSearchBeginning(self, v: int) -> None:
        self._set_cfg(position_search_beginning=int(v))

    @property
    def UnmappedObstacleHits(self) -> int:
        return self.cfg.unmapped_obstacle_hits

    @UnmappedObstacleHits.setter
    def UnmappedObstacleHits(self, v: int) -> None:
        self._set_cfg(unmapped_obstacle_hits=int(v))

    @property
    def MaxObstacleHits(self) -> int:
        return self.cfg.max_obstacle_hits

    @MaxObstacleHits.setter
    def MaxObstacleHits(self, v: int) -> None:
        self._set_cfg(max_obstacle_hits=int(v))

    @property
    def Pose(self) -> np.ndarray:
        return self.state.pose.cpu().numpy()

    @property
    def HoleMap(self) -> np.ndarray:
        return export.hole_map_u16(self.state.hole_map, self.cfg.hole_map_size)

    @property
    def ObstacleMap(self) -> np.ndarray:
        return self.state.obstacle_map.cpu().numpy()


class HectorSLAMProcessor:
    """Mirror of HectorSLAM/Main/HectorSLAMProcessor.cs's public surface."""

    def __init__(self, map_resolution: float, map_size: int, start_pose,
                 num_depth: int = 4, num_threads: int = 4, logger=None, *,
                 min_distance_diff_for_map_update: float = 0.3,
                 min_angle_diff_for_map_update: float = 0.13,
                 estimate_iterations: Optional[Sequence[int]] = None,
                 matcher_mode: str = "gather",
                 device: torch.device | str = "cuda"):
        del num_threads  # threads dissolve into the kernels
        iters = tuple(estimate_iterations) if estimate_iterations \
            else tuple([3] * num_depth)
        # matcher_mode: "gather" (reference-exact, K3) or "onehot_bf16" (the
        # bf16 table, K1): no reference counterpart, exposed for users who
        # switch for throughput without leaving the object surface
        self.cfg = HectorConfig(
            map_resolution=map_resolution, map_size=map_size,
            num_levels=num_depth, estimate_iterations=iters,
            min_distance_diff_for_map_update=min_distance_diff_for_map_update,
            min_angle_diff_for_map_update=min_angle_diff_for_map_update,
            matcher_mode=matcher_mode)
        self.device = torch.device(device)
        self._start_pose = np.asarray(start_pose, np.float32)
        self.logger = logger
        self.MatchTiming = EmaTimer()
        self.UpdateTiming = EmaTimer()
        self.Reset()

    def Reset(self) -> None:
        self.state = hector.init(self.cfg, self._start_pose, self.device)

    def Dispose(self) -> None:
        self.state = None

    def _set_cfg(self, **kw) -> None:
        self.cfg = dataclasses.replace(self.cfg, **kw)

    def SetUpdateFactorFree(self, v: float) -> None:
        """MapRepMultiMap.SetUpdateFactorFree broadcast (MapRepMultiMap.cs:83-88)."""
        self._set_cfg(update_factor_free=float(v))

    def SetUpdateFactorOccupied(self, v: float) -> None:
        """MapRepMultiMap.SetUpdateFactorOccupied (MapRepMultiMap.cs:90-95)."""
        self._set_cfg(update_factor_occupied=float(v))

    def Update(self, scan: Scan, pose_hint_world=None,
               map_without_matching: bool = False) -> bool:
        """HectorSLAMProcessor.Update (:86-126); returns the map-updated flag.

        The reference times the match and the map update apart (:92-96,
        :111-115); here both run in one step, so MatchTiming tracks the
        whole step (its read of the flags included) and UpdateTiming the
        steps where a map update fired."""
        with self.MatchTiming.time() as t:
            if pose_hint_world is not None:
                self.state = self.state._replace(match_pose=torch.as_tensor(
                    pose_hint_world, dtype=torch.float32, device=self.device))
            self.state, info = hector.update(
                self.state, _on(self.device, scan), self.state.match_pose,
                self.cfg, map_without_matching)
            updated, fails = torch.stack([
                info.map_updated.to(torch.int32),
                info.solve_failures.to(torch.int32)]).tolist()
        if updated:
            self.UpdateTiming.update(time_module.perf_counter() - t.t0)
        if self.logger is not None:
            # the reference's ILogger surface (ScanMatcher.cs:99-115)
            if fails:
                self.logger.log(f"H is not invertible ({fails} GN steps)",
                                level="Information")
            if updated:
                self.logger.log(f"Map update at {self.MatchPose}")
        return bool(updated)

    @property
    def MatchPose(self) -> np.ndarray:
        return self.state.match_pose.cpu().numpy()

    @property
    def MapRep(self) -> List[np.ndarray]:
        """Per-level log-odds grids (MapRepMultiMap.Maps analogue)."""
        return [hector.level_view(self.state.maps, self.cfg, i).cpu().numpy()
                for i in range(self.cfg.num_levels)]

    def GetBitmapData(self, level: int = 0) -> np.ndarray:
        """GridMap.GetBitmapData (GridMap.cs:104-115)."""
        return export.occupancy_bitmap(
            hector.level_view(self.state.maps, self.cfg, level).reshape(-1),
            self.cfg.level_sizes[level])
