"""CoreSLAM: a hole map, an obstacle map and a pose searched against the
hole map each scan.

Port of ``slamnet_tpu/models/coreslam.py`` (CoreSLAMProcessor.cs): ``update``
de-skews a segment scan and ``update_cloud`` takes a cloud; each searches the
pose (Monte-Carlo, ``ops/score.py``, or correlative, ``ops/correlate.py``)
from the last pose plus the odometry delta, then updates both maps at the new
pose (``ops/holemap.py``, ``ops/obstacle.py``; line or dense by the config).

Two of JAX's constructs change form:

- JAX carries a PRNG key and splits it in each step (``coreslam.py:76``);
  the state here carries a seeded ``torch.Generator`` on its device, which
  the Monte-Carlo search draws from.  Its numbers differ from
  ``jax.random``'s; the distribution is the same.
- JAX's ``lax.cond(warm, ...)`` (``:97``) is a Python branch on the host's
  count of warm-up scans (``CoreSlamState.scans``, as the graph keeps its
  node count), so no step reads the device.  ``scan_count`` stays in the
  state as a tensor, for ``convert``.

``searched`` and ``best_sum`` stay device tensors.  On the card the line
mode's map update is K7 (``csrc/coreslam_map.cu``: three launches a scan,
through ``holemap.update_hole_map`` and ``obstacle.update_obstacle_map``)
and the Monte-Carlo search's scores and first minimum are K8
(``csrc/mc_search.cu``, one launch a searched scan, through
``score.best_of``); the candidates' draws, the correlative search and the
dense fills are PyTorch operators (the JAX package computes CoreSLAM in
XLA, so no TPU kernel stands behind any of them).  The
entry point (``init``) puts the state on the card unless the caller names
another device.

On the card, where the config runs the Monte-Carlo search and the line
updates (K8 and K7: no host read), ``update`` and ``update_cloud`` replay
the step as one CUDA graph (``StepGraphs``): a key (the entry, the config,
searched or trusted, the shapes) met on two calls in a row is captured on
the second, and from then on a scan costs one copy of its inputs, one
graph launch and three clones instead of ~47 launches from Python.  The
graph runs the same kernels on the same inputs in the same order, so its
answers are the eager step's bit for bit.  The state stays functional: a
replay copies the state's maps, poses and count into the graph's static
inputs and clones what the graph wrote, so no returned state shares
storage with a later replay, and one graph serves every job of the
process, each from its own ``init``.  A searched step's graph draws from a
generator of its own, registered with the graph; a replay hands it the
state's generator's seed and offset and takes the offset back, so the
draws, and where the state's generator stands after them, are the eager
step's.  CPU tensors, the correlative search, the dense fills, a wrapped
step function and a caller that is itself capturing a graph run the step
as it is.

Under a profiler a scan is the span ``slamnet.coreslam.update`` (the whole
``update`` or ``update_cloud`` call), holding ``.search`` on a searched scan
and then ``.map_update`` where the step runs eagerly, and one
``.graph_replay`` where it is replayed (``io/metrics``).
``update_cloud.searches`` and ``update_cloud.candidates`` count the
searched scans and the candidate poses they scored, and
``update.graph_captures`` and ``update.graph_replays`` the steps captured
and replayed, on the host.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Tuple

import torch

from ..core.config import CoreSlamConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan, SegmentScan, segments_to_cloud
from ..io import metrics
from ..ops import _build, correlate, holemap, obstacle, score
from . import capture

HOLE_INIT = (holemap.TS_OBSTACLE + holemap.TS_NO_OBSTACLE) // 2  # 32750 (:169)


class CoreSlamState(NamedTuple):
    hole_map: torch.Tensor         # i32[S*S] flat (HoleMap.cs's ushort[])
    obstacle_map: torch.Tensor     # i8[OS, OS]
    pose: torch.Tensor             # f32[3]
    last_odometry: torch.Tensor    # f32[3]
    scan_count: torch.Tensor       # i32[] warm-up scans counted so far
    generator: torch.Generator     # the Monte-Carlo search's draws
    scans: int                     # the host's copy of scan_count


class CoreSlamInfo(NamedTuple):
    searched: torch.Tensor         # bool: did the search run this scan?
    best_sum: torch.Tensor         # i32: the best candidate's pixel sum


def init(cfg: CoreSlamConfig, start_pose, seed: int = 0,
         device: torch.device | str = "cuda",
         generator: torch.Generator | None = None) -> CoreSlamState:
    """Reset semantics of CoreSLAMProcessor.Reset (CoreSLAMProcessor.cs:
    167-175): the hole map at HOLE_INIT, the obstacle map at
    ``unmapped_obstacle_hits``; a generator on ``device`` seeded with
    ``seed`` unless one is given."""
    s, os_ = cfg.hole_map_size, cfg.obstacle_map_size
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return CoreSlamState(
        hole_map=torch.full((s * s,), HOLE_INIT, dtype=torch.int32,
                            device=device),
        obstacle_map=torch.full((os_, os_), cfg.unmapped_obstacle_hits,
                                dtype=torch.int8, device=device),
        pose=torch.as_tensor(start_pose, dtype=torch.float32,
                             device=device).clone(),
        last_odometry=torch.zeros(3, dtype=torch.float32, device=device),
        scan_count=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator, scans=0)


def reset(state: CoreSlamState, cfg: CoreSlamConfig,
          start_pose) -> CoreSlamState:
    """A fresh state on the same device that keeps drawing from the same
    generator (JAX's reset keeps its key)."""
    return init(cfg, start_pose, device=state.hole_map.device,
                generator=state.generator)


def update(state: CoreSlamState, segments: SegmentScan,
           cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """One scan from segments: de-skew against the newest odometry pose,
    then ``update_cloud`` (CoreSLAMProcessor.Update, :717-752).  On the card
    the step runs through ``STEP_GRAPHS`` (the module's note): eager on a
    first sight, captured on a second, replayed after."""
    with metrics.span("coreslam.update"):
        if graphable(state, cfg, segments):
            return STEP_GRAPHS.step("update", state, tuple(segments), cfg)
        return _step("update", state, segments, cfg)


update.graph_captures = 0
update.graph_replays = 0


def search(state: CoreSlamState, cloud: Scan, search_pose: torch.Tensor,
           cfg: CoreSlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config's search around ``search_pose``: (pose f32[3], sum i32[])."""
    if cfg.search_mode == "correlative":
        span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta
        return correlate.correlative_search(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, search_pose, cfg.corr_window, cfg.corr_num_theta,
            span)
    if cfg.search_mode != "mc":
        raise ValueError(f"search_mode {cfg.search_mode!r}: 'mc' or "
                         "'correlative'")
    return score.monte_carlo_search(
        state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
        cloud.valid, search_pose, cfg.sigma_xy, cfg.sigma_theta,
        cfg.num_candidates, state.generator)


def update_obstacle(obstacle_map: torch.Tensor, cloud: Scan,
                    pose: torch.Tensor, cfg: CoreSlamConfig) -> torch.Tensor:
    """The obstacle map updated at ``pose``, line or dense by the config."""
    if cfg.dense_obstacle_fill:
        return obstacle.update_obstacle_map_dense(
            obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
            cloud.points, cloud.valid, pose, cfg.max_obstacle_hits,
            cfg.angle_bins)
    return obstacle.update_obstacle_map(
        obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
        cloud.points, cloud.valid, pose, cfg.max_obstacle_hits)


def update_maps(state: CoreSlamState, cloud: Scan, pose: torch.Tensor,
                cfg: CoreSlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both maps updated at ``pose``, line or dense by the config."""
    if cfg.dense_hole_fill:
        hole = holemap.update_hole_map_dense(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, pose, cfg.hole_width, cfg.quality, cfg.angle_bins)
    else:
        hole = holemap.update_hole_map(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, pose, cfg.hole_width, cfg.quality)
    return hole, update_obstacle(state.obstacle_map, cloud, pose, cfg)


def candidates_scored(cfg: CoreSlamConfig) -> int:
    """The candidate poses one search scores: ``num_candidates`` draws, or
    the correlative grid's headings x window x window."""
    if cfg.search_mode == "correlative":
        return cfg.corr_num_theta * cfg.corr_window * cfg.corr_window
    return cfg.num_candidates


def update_cloud(state: CoreSlamState, cloud: Scan, odometry_pose,
                 cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """One scan from a de-skewed cloud: the search prior is the last pose
    plus the odometry delta (:728); during the first
    ``position_search_beginning`` scans the odometry pose is adopted as it
    is (:739-743); the heading is normalised (:746); both maps update at the
    new pose.  On the card the step runs through ``STEP_GRAPHS``, as
    ``update``'s does."""
    with metrics.span("coreslam.update"):
        if not graphable(state, cfg, cloud):
            return _update_cloud(state, cloud, odometry_pose, cfg)
        odo = torch.as_tensor(odometry_pose, dtype=torch.float32,
                              device=state.pose.device)
        return STEP_GRAPHS.step("update_cloud", state, (*cloud, odo), cfg)


update_cloud.searches = 0
update_cloud.candidates = 0


def _update_cloud(state: CoreSlamState, cloud: Scan, odometry_pose,
                  cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """``update_cloud`` without its span (``update`` holds its own)."""
    dev = state.pose.device
    odo = torch.as_tensor(odometry_pose, dtype=torch.float32, device=dev)
    warm = state.scans >= cfg.position_search_beginning
    if warm:
        with metrics.span("coreslam.search"):
            best, best_sum = search(
                state, cloud, state.pose + (odo - state.last_odometry), cfg)
        update_cloud.searches += 1
        update_cloud.candidates += candidates_scored(cfg)
    else:
        best, best_sum = odo, torch.zeros((), dtype=torch.int32, device=dev)
    new_pose = torch.stack([best[0], best[1], normalize_angle(best[2])])
    with metrics.span("coreslam.map_update"):
        hole, obst = update_maps(state, cloud, new_pose, cfg)
    new_state = state._replace(
        hole_map=hole, obstacle_map=obst, pose=new_pose, last_odometry=odo,
        scan_count=state.scan_count if warm else state.scan_count + 1,
        scans=state.scans if warm else state.scans + 1)
    return new_state, CoreSlamInfo(
        searched=torch.full((), warm, dtype=torch.bool, device=dev),
        best_sum=best_sum)


def _step(entry: str, state: CoreSlamState, inputs,
          cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """The eager step of ``entry`` without its span: ``"update"`` on a
    ``SegmentScan`` (or its four tensors), ``"update_cloud"`` on a cloud's
    points, flags and pose and the odometry pose f32[3]."""
    if entry == "update":
        seg = SegmentScan(*inputs)
        return _update_cloud(state, segments_to_cloud(seg),
                             seg.odometry_pose, cfg)
    points, valid, pose, odo = inputs
    return _update_cloud(state, Scan(points, valid, pose), odo, cfg)


def _looked_up() -> tuple:
    """The functions the step reaches by their module's name at each
    call."""
    return (score.monte_carlo_search, score.sample_candidates, score.best_of,
            holemap.update_hole_map, obstacle.update_obstacle_map)


_AS_DEFINED = _looked_up()


def graphable(state: CoreSlamState, cfg: CoreSlamConfig, tensors) -> bool:
    """Whether a step may run as a CUDA graph: the state, its generator and
    the scan's ``tensors`` are on one CUDA card; the config runs the
    Monte-Carlo search and the line updates (K8 and K7: no host read); the
    count is ``init``'s i32[]; the step's functions are the package's own
    (a caller's wrapper, such as the benchmark's planted faults, may keep
    Python state that a replay would skip); and the current stream is not
    capturing already (a caller's own graph takes the step's launches as
    they are)."""
    dev, gen = state.hole_map.device, state.generator.device
    return (dev.type == "cuda" and cfg.search_mode == "mc"
            and not cfg.dense_hole_fill and not cfg.dense_obstacle_fill
            # torch.Generator(device="cuda") names no card: the current one
            and gen.type == "cuda" and gen.index in (None, dev.index)
            and all(t.device == dev for t in tensors)
            and state.scan_count.dtype == torch.int32
            and state.scan_count.dim() == 0
            and _looked_up() == _AS_DEFINED
            and not torch.cuda.is_current_stream_capturing())


GRAPHS_PER_DEVICE = 4     # captured steps a card keeps, least recent out


def _unpack(packed: torch.Tensor) -> tuple:
    """(pose, odometry, count, best sum, searched): typed views of a
    replayed step's results in one byte buffer: f32 pose [0:12], f32
    odometry [12:24], i32 count [24:28], i32 best sum [28:32], bool
    searched [32]."""
    pose, odo = packed[:24].view(torch.float32).split(3)
    count, best_sum = packed[24:32].view(torch.int32).unbind()
    return pose, odo, count, best_sum, packed[32].view(torch.bool)


class CapturedStep(NamedTuple):
    graph: object             # .replay() runs the step, .reset() frees it
    inputs: tuple             # the static inputs the graph reads
    outputs: dict             # what it writes: "maps" and "packed"
    generator: object         # a searched step's own generator; None
                              # for a trusted step, which draws nothing
    launched: tuple           # its (kernel key, launches) pairs


class StepGraphs:
    """CoreSLAM's steps on the card as CUDA graphs, a bounded cache a
    device.

    A step's key is the entry (``"update"`` with its de-skew, or
    ``"update_cloud"``), the device, the config, the warm flag (searched
    or trusted) and the shapes and dtypes of the state's tensors and the
    scan's; never an address.  A key met for the first time runs the step
    eagerly; met again on the very next call, the step runs eagerly once
    more and is then captured (``record``: its launches recorded, nothing
    run); from then on the step is replayed.  A replay copies the state's
    maps, poses and count and the scan into the graph's static inputs,
    launches the graph and clones what it wrote (both maps and one packed
    buffer of the pose, the odometry, the count, the best sum and
    ``searched``): the state stays functional, and no returned tensor is
    one a later replay writes.  So a graph captured once serves every job
    of the process, each from its own ``init``.

    A searched step's graph draws from a generator of its own, registered
    with the graph.  Before a replay that generator takes the state's
    generator's seed and offset, and after it gives the offset back, so the
    state's generator stands where the eager draws would leave it and the
    replay draws the eager step's numbers (host reads and writes of the
    generators' states; nothing waits for the card).

    Each device keeps ``GRAPHS_PER_DEVICE`` graphs, the least recently used
    evicted first (and ``reset``).  A capture adds nothing to the launch
    counts (``ops/_build``) or to ``update_cloud.searches`` and
    ``.candidates``, as nothing ran; a replay adds what its graph holds.
    ``record(body, device, generators)`` captures ``body`` and returns an
    object with ``replay()`` and ``reset()``; tests hand in a stand-in."""

    def __init__(self, record=None):
        self.record = record if record is not None else capture.CudaRecorder()
        self.graphs: dict = {}    # device -> OrderedDict(key -> step)
        self.last_key = None

    @staticmethod
    def key(entry: str, state: CoreSlamState, inputs: tuple,
            cfg: CoreSlamConfig) -> tuple:
        warm = state.scans >= cfg.position_search_beginning
        return (entry, state.hole_map.device, cfg, warm) + tuple(
            (t.shape, t.dtype) for t in (*state[:5], *inputs))

    def step(self, entry: str, state: CoreSlamState, inputs: tuple,
             cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
        key = self.key(entry, state, inputs, cfg)
        seen, self.last_key = key == self.last_key, key
        cache = self.graphs.get(key[1])
        if cache is None:
            cache = self.graphs[key[1]] = OrderedDict()
        g = cache.get(key)
        if g is not None:
            cache.move_to_end(key)
            return self._replay(g, state, inputs, cfg)
        out = _step(entry, state, inputs, cfg)
        if seen:
            cache[key] = self._capture(entry, state, inputs, cfg)
            update.graph_captures += 1
            if len(cache) > GRAPHS_PER_DEVICE:
                cache.popitem(last=False)[1].graph.reset()
        return out

    def _capture(self, entry: str, state: CoreSlamState, inputs: tuple,
                 cfg: CoreSlamConfig) -> CapturedStep:
        """The step on static copies of its inputs, recorded into a graph
        that writes both maps and one packed buffer of the rest."""
        dev = state.hole_map.device
        static = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in (*state[:5], *inputs))
        warm = state.scans >= cfg.position_search_beginning
        gen = torch.Generator(device=dev) if warm else None
        st = CoreSlamState(*static[:5], generator=gen, scans=state.scans)
        outputs = {}

        def body():
            new, info = _step(entry, st, static[5:], cfg)
            outputs["maps"] = (new.hole_map, new.obstacle_map)
            # one kernel packs the rest (a copy a result would be a graph
            # node each, and a clone each on the host)
            outputs["packed"] = torch.cat([t.reshape(-1).view(torch.uint8)
                                           for t in (new.pose,
                                                     new.last_odometry,
                                                     new.scan_count,
                                                     info.best_sum,
                                                     info.searched)])

        counts = update_cloud.searches, update_cloud.candidates
        try:
            graph, launched = capture.recorded(
                self.record, body, dev, (gen,) if warm else ())
        finally:
            update_cloud.searches, update_cloud.candidates = counts
        return CapturedStep(graph, static, outputs, gen, launched)

    @staticmethod
    def _replay(g: CapturedStep, state: CoreSlamState, inputs: tuple,
                cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
        with metrics.span("coreslam.graph_replay"):
            torch._foreach_copy_(g.inputs, (*state[:5], *inputs))
            if g.generator is not None:
                g.generator.set_state(state.generator.get_state())
            g.graph.replay()
            if g.generator is not None:
                state.generator.set_state(g.generator.get_state())
            hole, obst = (m.clone() for m in g.outputs["maps"])
            packed = g.outputs["packed"].clone()
        _build.add_launches(g.launched)
        update.graph_replays += 1
        warm = g.generator is not None
        if warm:
            update_cloud.searches += 1
            update_cloud.candidates += candidates_scored(cfg)
        pose, odo, count, best_sum, searched = _unpack(packed)
        return (state._replace(hole_map=hole, obstacle_map=obst, pose=pose,
                               last_odometry=odo, scan_count=count,
                               scans=state.scans if warm else state.scans + 1),
                CoreSlamInfo(searched=searched, best_sum=best_sum))


STEP_GRAPHS = StepGraphs()
