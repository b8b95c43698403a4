"""HectorSLAM pipeline: multi-resolution pyramid + coarse-to-fine Gauss-Newton.

Port of ``slamnet_tpu/models/hector.py``: HectorSLAMProcessor +
MapRepMultiMap + ScanMatcher (HectorSLAM/Main/*.cs, Matcher/ScanMatcher.cs).
The state holds one flat f32 table with every pyramid level concatenated,
finest first (``cfg.level_offsets``).  Level i+1 has half the pixels and
twice the cell length of level i (MapRepMultiMap.cs:49-57); every level is
updated from the raw scan.

The configuration picks the kernels (``ops/match.py``, ``ops/fill.py``,
``ops/line.py``):

* matcher: ``matcher_mode`` ``"gather"`` (the default, reference-exact) or
  ``"onehot_highest"`` (bit-identical to it in JAX) -> K3 on the f32 table;
  ``"pallas"`` or ``"onehot_bf16"`` (the serving profile's) -> K1 on the
  bf16-rounded table;
* map update: ``dense_free_fill=False`` (the default, the reference's
  Bresenham lines) -> K4; ``True`` (the dense polar fill) -> K2.

So ``HectorConfig()``'s defaults (the bench's ``fixed`` mode) run K3 + K4
and ``pallas_dense`` runs K1 + K2.  ``early_exit_tol > 0`` stops each
level's GN iterations early, as JAX's while loop does, under K3 and
``"onehot_bf16"``; ``"pallas"`` refuses it with ValueError, as JAX's does.
Other modes and a non-zero ``offset`` raise NotImplementedError.

The entry points (``init``, ``HectorSLAM``) put the state on the card
unless the caller names another device.

One scan's step is one match launch, a few small PyTorch operators for
the guards and the motion gate, and one map-update call that reads the gate
as a device flag.  Nothing in it waits for the device or branches on a
device value.  ``update`` changes ``state.maps`` IN PLACE and returns a
state that shares it (JAX returns a new array).

On the card ``update`` replays that step as one CUDA graph (``StepGraphs``)
once it has seen the same map, config, beam count and kind of force on two
calls in a row: the second call runs the step and captures it, and from the
third on a scan costs a few input copies, one graph launch and one copy of
the packed results, instead of ~28 launches from Python.  The graph runs
the same kernels on the same inputs in the same order, so its answers are
the step's bit for bit.  CPU tensors, ``plain=True`` and a caller that is
itself capturing a graph run the step as it is.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, rad_diff
from ..core.scan import Scan
from ..io import metrics
from ..ops import _build, fill, line, match as match_op
from . import capture

# float.MinValue (-3.4028235e38, the f32 lowest): the first squared distance
# to it overflows to +inf in f32, so the first scan always updates the maps
# (HectorSLAMProcessor.cs:66-77, 131-138)
FLOAT_MIN = torch.finfo(torch.float32).min


class HectorState(NamedTuple):
    maps: torch.Tensor              # f32[total_cells], all levels, finest first
    match_pose: torch.Tensor        # f32[3] world
    last_update_pose: torch.Tensor  # f32[3] world


class HectorInfo(NamedTuple):
    map_updated: torch.Tensor       # bool
    residual: torch.Tensor          # mean (1-M(p))^2 at the final GN evaluation
    gn_iterations: torch.Tensor     # i32 GN iterations executed (all levels)
    solve_failures: torch.Tensor    # i32 iterations with a singular H


class MatchStats(NamedTuple):
    residual: torch.Tensor        # f32 mean squared occupancy residual, finest level
    iterations: torch.Tensor      # i32 total GN iterations (all levels)
    solve_failures: torch.Tensor  # i32 iterations where the 3x3 solve failed
    in_map_frac: torch.Tensor     # f32 in-bounds fraction of valid matcher beams


MATCHERS = match_op.F32_MATCHERS + match_op.BF16_MATCHERS


def _check_cfg(cfg: HectorConfig) -> None:
    if cfg.matcher_mode not in MATCHERS or tuple(cfg.offset) != (0.0, 0.0):
        raise NotImplementedError(
            f"slamnet_tpu_torch runs matcher_mode in {MATCHERS} with offset "
            f"(0, 0); got matcher_mode={cfg.matcher_mode!r}, "
            f"offset={cfg.offset}")
    if cfg.early_exit_tol > 0.0 and \
            cfg.matcher_mode not in match_op.EXIT_MATCHERS:
        raise ValueError(
            f"matcher_mode={cfg.matcher_mode!r} runs fixed per-level "
            "iterations, as JAX's does (slamnet_tpu/models/hector.py:172-176); "
            f"early_exit_tol is unsupported (got {cfg.early_exit_tol})")


def init(cfg: HectorConfig, start_pose,
         device: torch.device | str = "cuda") -> HectorState:
    """Ctor/Reset semantics (HectorSLAMProcessor.cs:66-77, 131-138): zeroed
    maps, match pose at start, last-update pose at float.MinValue."""
    return HectorState(
        maps=torch.zeros(cfg.total_cells, dtype=torch.float32, device=device),
        match_pose=torch.as_tensor(start_pose, dtype=torch.float32,
                                   device=device).clone(),
        last_update_pose=torch.full((3,), FLOAT_MIN, dtype=torch.float32,
                                    device=device))


def level_view(maps: torch.Tensor, cfg: HectorConfig, level: int) -> torch.Tensor:
    """The [S, S] log-odds grid of one pyramid level (a view of ``maps``)."""
    off = cfg.level_offsets[level]
    s = cfg.level_sizes[level]
    return maps[off:off + s * s].view(s, s)


def map_extents(maps: torch.Tensor, cfg: HectorConfig, level: int = 0):
    """Bounding box of touched (non-zero) cells at one level: (found, x_min,
    y_min, x_max, y_max) as 0-dim tensors — GridMap.GetMapExtends
    (GridMap.cs:147-207)."""
    grid = level_view(maps, cfg, level)
    touched = grid != 0.0
    any_t = touched.any()
    s = grid.shape[0]
    idx = torch.arange(s, device=maps.device)
    cols, rows = touched.any(dim=0), touched.any(dim=1)
    big = torch.full_like(idx, s)
    neg = torch.full_like(idx, -1)
    z = torch.zeros((), dtype=idx.dtype, device=maps.device)
    x_min = torch.where(cols, idx, big).min()
    y_min = torch.where(rows, idx, big).min()
    x_max = torch.where(cols, idx, neg).max()
    y_max = torch.where(rows, idx, neg).max()
    return (any_t, torch.where(any_t, x_min, z), torch.where(any_t, y_min, z),
            torch.where(any_t, x_max, z), torch.where(any_t, y_max, z))


def world_to_map(pose_world: torch.Tensor, scale_to_map: float,
                 offset) -> torch.Tensor:
    """GetMapCoordsPose (GridMap.cs:122-137): p_map = p * scale + offset."""
    return torch.stack([pose_world[0] * scale_to_map + offset[0],
                        pose_world[1] * scale_to_map + offset[1],
                        pose_world[2]])


def map_to_world(pose_map: torch.Tensor, scale_to_map: float,
                 offset) -> torch.Tensor:
    return torch.stack([(pose_map[0] - offset[0]) / scale_to_map,
                        (pose_map[1] - offset[1]) / scale_to_map,
                        pose_map[2]])


def match_with_stats(maps: torch.Tensor, scan: Scan, hint_pose_world: torch.Tensor,
                     cfg: HectorConfig, plain: bool = False
                     ) -> Tuple[torch.Tensor, MatchStats]:
    """ScanMatcher.MatchData over the pyramid (ScanMatcher.cs:41-84) through
    K1 or K3 (by ``cfg.matcher_mode``), plus matcher health
    (ScanMatcher.cs:99-115).  ``plain=True`` runs the kernel's plain version
    whatever the device (for comparisons)."""
    _check_cfg(cfg)
    fn = match_op.match_plain if plain else match_op.match
    out = fn(maps, scan.points, scan.valid, hint_pose_world, cfg)
    n_valid = scan.valid[::cfg.match_subsample].sum(dtype=torch.float32)
    stats = MatchStats(
        residual=out[4] / out[5].clamp(min=1.0),
        iterations=out[6].to(torch.int32),
        solve_failures=out[3].to(torch.int32),
        in_map_frac=out[5] / n_valid.clamp(min=1.0))
    return out[:3], stats


def match(maps: torch.Tensor, scan: Scan, hint_pose_world: torch.Tensor,
          cfg: HectorConfig) -> torch.Tensor:
    """ScanMatcher.MatchData over the pyramid: the matched world pose
    f32[3] (``match_with_stats`` without the stats)."""
    return match_with_stats(maps, scan, hint_pose_world, cfg)[0]


def update_maps(state: HectorState, scan: Scan, pose_world: torch.Tensor,
                do_update: torch.Tensor, cfg: HectorConfig,
                plain: bool = False) -> torch.Tensor:
    """MapRepMultiMap.UpdateByScan (MapRepMultiMap.cs:73-77), in place on
    ``state.maps`` where the 0-dim bool ``do_update`` is set: the dense fill
    (K2) or the Bresenham line update (K4), by ``cfg.dense_free_fill``.
    ``plain=True`` runs the kernel's plain version whatever the device."""
    _check_cfg(cfg)
    if plain:
        plain_fn = (fill.update_maps_plain if cfg.dense_free_fill
                    else line.update_maps_line_plain)
        return state.maps.copy_(plain_fn(state.maps, scan.points, scan.valid,
                                         pose_world, scan.pose, do_update, cfg))
    fn = fill.update_maps if cfg.dense_free_fill else line.update_maps_line
    return fn(state.maps, scan.points, scan.valid, pose_world, scan.pose,
              do_update, cfg)


def update(state: HectorState, scan: Scan, pose_hint_world: torch.Tensor,
           cfg: HectorConfig, map_without_matching: bool | torch.Tensor = False,
           plain: bool = False) -> Tuple[HectorState, HectorInfo]:
    """HectorSLAMProcessor.Update (HectorSLAMProcessor.cs:86-126): match,
    then update the maps only if the pose moved beyond the distance/angle
    thresholds or mapping is forced (``map_without_matching``, a Python bool
    or a 0-dim bool tensor).  ``state.maps`` is updated in place; the poses
    and the info returned are new tensors, shared with no later call.

    On the card the step runs through ``STEP_GRAPHS`` (the module's note):
    eager on a first sight, captured on a second, replayed after.  Under a
    profiler the call is the span ``slamnet.hector.update``, holding its
    phases ``.match``, ``.guards`` and ``.map_update`` where the step runs
    eager and one ``.graph_replay`` where it is replayed (``io/metrics``).
    ``update.graph_captures`` and ``update.graph_replays`` count the steps
    captured and replayed."""
    with metrics.span("hector.update"):
        if not graphable(state.maps, plain):
            return _update_eager(state, scan, pose_hint_world, cfg,
                                 map_without_matching, plain)
        return STEP_GRAPHS.step(state, scan, pose_hint_world, cfg,
                                map_without_matching)


update.graph_captures = 0
update.graph_replays = 0


def graphable(maps: torch.Tensor, plain: bool) -> bool:
    """Whether a step on ``maps`` may run as a CUDA graph: the maps are on
    a CUDA card, the caller asked for the kernels (not ``plain``), and the
    current stream is not capturing already (a caller's own graph takes the
    step's launches as they are)."""
    return (not plain and maps.is_cuda
            and not torch.cuda.is_current_stream_capturing())


def _update_eager(state: HectorState, scan: Scan,
                  pose_hint_world: torch.Tensor, cfg: HectorConfig,
                  map_without_matching: bool | torch.Tensor = False,
                  plain: bool = False) -> Tuple[HectorState, HectorInfo]:
    """``update``'s step, each operator launched from Python."""
    dev = state.maps.device
    hint = torch.as_tensor(pose_hint_world, dtype=torch.float32, device=dev)
    if isinstance(map_without_matching, torch.Tensor):
        force = map_without_matching.to(device=dev, dtype=torch.bool)
    else:   # a fill on the device: no host-to-device copy, no wait
        force = torch.full((), bool(map_without_matching),
                           dtype=torch.bool, device=dev)

    with metrics.span("hector.match"):
        matched, mstats = match_with_stats(state.maps, scan, hint, cfg,
                                           plain)
    with metrics.span("hector.guards"):
        if cfg.min_match_in_map_frac > 0.0:
            # a match resting on too few in-map beams is a one-sided
            # degenerate solve: keep the odometry hint
            matched = torch.where(
                mstats.in_map_frac >= cfg.min_match_in_map_frac,
                matched, hint)
        if cfg.max_match_jump > 0.0:
            # a physically impossible per-scan jump is a degenerate-view
            # solve
            jump2 = ((matched[:2] - hint[:2]) ** 2).sum()
            matched = torch.where(jump2 <= cfg.max_match_jump ** 2,
                                  matched, hint)
        match_pose = torch.where(force, hint, matched)

        last = state.last_update_pose
        dist2 = ((match_pose[:2] - last[:2]) ** 2).sum()
        if cfg.angle_gate_compat:
            # reference quirk: DegDiff (degrees formula) on radian
            # values, SIGNED compare (HectorSLAMProcessor.cs:108)
            ang_gate = deg_diff(match_pose[2], last[2]) \
                > cfg.min_angle_diff_for_map_update
        else:
            ang_gate = rad_diff(match_pose[2], last[2]).abs() \
                > cfg.min_angle_diff_for_map_update
        do_update = (dist2 > cfg.min_distance_diff_for_map_update ** 2) \
            | ang_gate | force

    with metrics.span("hector.map_update"):
        maps = update_maps(state, scan, match_pose, do_update, cfg, plain)
        new_last = torch.where(do_update, match_pose, last)
    return (HectorState(maps, match_pose, new_last),
            HectorInfo(map_updated=do_update, residual=mstats.residual,
                       gn_iterations=mstats.iterations,
                       solve_failures=mstats.solve_failures))


GRAPHS_PER_DEVICE = 4     # captured steps a card keeps, least recent out
# a replayed step's results in one byte buffer: f32 match pose [0:12], f32
# last-update pose [12:24], f32 residual [24:28], i32 GN iterations [28:32],
# i32 solve failures [32:36], bool map_updated [36]
PACKED_BYTES = 37


def _unpack(packed: torch.Tensor) -> tuple:
    """(match pose, last-update pose, residual, GN iterations, solve
    failures, map_updated): typed views of a packed result buffer."""
    f = packed[:36].view(torch.float32)
    return (f[0:3], f[3:6], f[6], f[7].view(torch.int32),
            f[8].view(torch.int32), packed[36].view(torch.bool))


class CapturedStep(NamedTuple):
    graph: object             # .replay() runs the step, .reset() frees it
    inputs: tuple             # the static inputs the graph reads
    packed: torch.Tensor      # u8[PACKED_BYTES], the results it writes
    launched: tuple           # its (kernel key, launches) pairs


def _inputs(scan: Scan, hint: torch.Tensor, last: torch.Tensor,
            force) -> tuple:
    """A step's inputs in a captured step's order: points, valid, hint,
    last-update pose, the cloud's pose and a tensor force flag."""
    t = (scan.points, scan.valid, hint, last, scan.pose)
    return t + (force,) if isinstance(force, torch.Tensor) else t


class StepGraphs:
    """``update``'s steps on the card as CUDA graphs, a bounded cache a
    device.

    A step's key is its map's address and device, the config, the scan's
    shape, the shapes and dtypes of the maps and the scan (what the eager
    step's checks read) and the force's kind (the Python bool's value, or
    "tensor").  A key met for the first time runs the step eagerly; met
    again on the very next call, the step runs eagerly once more and is
    then captured (``record``: its launches recorded, nothing run); from
    then on the step is replayed: the call's inputs are copied into the
    graph's static buffers, the graph is launched, and its packed results
    are cloned, so no result of one call is a tensor of a later one.  The
    maps are written in place at the key's address: a map freed and another
    allocated there with the same key is the same tensor to the kernels.
    A caller that hands in a new map every scan never pays for a capture.

    Each device keeps ``GRAPHS_PER_DEVICE`` graphs, the least recently used
    evicted first (and ``reset``).  A capture adds nothing to the launch
    counts (``ops/_build``), as nothing ran; a replay adds what its graph
    holds.  ``record(body, device)`` captures ``body`` and returns an
    object with ``replay()`` and ``reset()``; tests hand in a stand-in."""

    def __init__(self, record=None):
        self.record = record if record is not None else capture.CudaRecorder()
        self.graphs: dict = {}    # device -> OrderedDict(key -> step)
        self.last_key = None

    @staticmethod
    def key(maps: torch.Tensor, scan: Scan, cfg: HectorConfig,
            force) -> tuple:
        kind = "tensor" if isinstance(force, torch.Tensor) else bool(force)
        return (maps.data_ptr(), maps.device, cfg, scan.points.shape,
                maps.shape, maps.dtype, scan.points.dtype, scan.valid.shape,
                scan.valid.dtype, kind)

    def step(self, state: HectorState, scan: Scan, pose_hint_world,
             cfg: HectorConfig, force) -> Tuple[HectorState, HectorInfo]:
        key = self.key(state.maps, scan, cfg, force)
        seen, self.last_key = key == self.last_key, key
        cache = self.graphs.get(key[1])
        if cache is None:
            cache = self.graphs[key[1]] = OrderedDict()
        g = cache.get(key)
        if g is not None:
            cache.move_to_end(key)
            with metrics.span("hector.graph_replay"):
                hint = torch.as_tensor(pose_hint_world, dtype=torch.float32,
                                       device=key[1])
                out = self._replay(g, _inputs(scan, hint,
                                              state.last_update_pose, force))
            update.graph_replays += 1
            pose, last, resid, iters, fails, fired = out
            return (HectorState(state.maps, pose, last),
                    HectorInfo(map_updated=fired, residual=resid,
                               gn_iterations=iters, solve_failures=fails))
        out = _update_eager(state, scan, pose_hint_world, cfg, force)
        if seen:
            cache[key] = self._capture(state, scan, cfg, force)
            update.graph_captures += 1
            if len(cache) > GRAPHS_PER_DEVICE:
                cache.popitem(last=False)[1].graph.reset()
        return out

    def _capture(self, state: HectorState, scan: Scan, cfg: HectorConfig,
                 force) -> CapturedStep:
        """The step on static copies of its inputs, recorded into a graph
        that writes its results into one packed buffer."""
        dev = state.maps.device

        def fresh(t):
            return torch.empty(t.shape, dtype=t.dtype, device=dev)

        points, valid, last, scan_pose = map(fresh, (
            scan.points, scan.valid, state.last_update_pose, scan.pose))
        hint = torch.empty(3, dtype=torch.float32, device=dev)
        flag = torch.empty((), dtype=torch.bool, device=dev) \
            if isinstance(force, torch.Tensor) else force
        static = _inputs(Scan(points, valid, scan_pose), hint, last, flag)
        packed = torch.zeros(PACKED_BYTES, dtype=torch.uint8, device=dev)

        def body():
            st, info = _update_eager(
                HectorState(state.maps, hint, last),
                Scan(points, valid, scan_pose), hint, cfg, flag)
            # one kernel packs the results (a copy a result would be a
            # graph node each)
            torch.cat([t.reshape(-1).view(torch.uint8) for t in (
                st.match_pose, st.last_update_pose, info.residual,
                info.gn_iterations, info.solve_failures, info.map_updated)],
                out=packed)

        graph, launched = capture.recorded(self.record, body, dev)
        return CapturedStep(graph, static, packed, launched)

    @staticmethod
    def _replay(g: CapturedStep, inputs: tuple) -> tuple:
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        g.graph.replay()
        _build.add_launches(g.launched)
        return _unpack(g.packed.clone())


STEP_GRAPHS = StepGraphs()

class HectorSLAM(nn.Module):
    """Stateful wrapper: the state lives in buffers, so ``.to(device)`` moves
    it.  ``forward(scan, hint, force)`` runs one ``update`` in place and
    returns its ``HectorInfo``."""

    def __init__(self, cfg: HectorConfig, start_pose=(20.0, 20.0, 0.0),
                 device: torch.device | str = "cuda"):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        st = init(cfg, start_pose, device)
        self.register_buffer("maps", st.maps)
        self.register_buffer("match_pose", st.match_pose)
        self.register_buffer("last_update_pose", st.last_update_pose)

    @property
    def state(self) -> HectorState:
        return HectorState(self.maps, self.match_pose, self.last_update_pose)

    def forward(self, scan: Scan, pose_hint_world: torch.Tensor | None = None,
                map_without_matching: bool | torch.Tensor = False) -> HectorInfo:
        hint = self.match_pose if pose_hint_world is None else pose_hint_world
        st, info = update(self.state, scan, hint, self.cfg, map_without_matching)
        self.match_pose.copy_(st.match_pose)
        self.last_update_pose.copy_(st.last_update_pose)
        return info
