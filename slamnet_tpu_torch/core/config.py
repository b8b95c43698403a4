"""Frozen config dataclasses — the framework's entire knob inventory.

A field-for-field mirror of ``slamnet_tpu/core/config.py`` (pure Python; it is
copied rather than imported because ``slamnet_tpu.core`` imports jax).  Every
knob is a field on a frozen dataclass; defaults are the reference's golden
values with the citation on each field.  ``overlay`` applies dict/JSON
overrides for CLI use.  ``tests/test_torch_config.py`` holds the two files
equal.  Comments below that speak of XLA/TPU measurements describe the JAX
package the values came from.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Tuple


def _replace_nested(cfg, updates: dict):
    kw = {}
    for k, v in updates.items():
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _replace_nested(cur, v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


class _Overlayable:
    def overlay(self, updates: dict | str):
        """Return a copy with (possibly nested) overrides applied; str = JSON."""
        if isinstance(updates, str):
            updates = json.loads(updates)
        return _replace_nested(self, updates)


@dataclass(frozen=True)
class CoreSlamConfig(_Overlayable):
    """CoreSLAM knobs (CoreSLAMProcessor.cs:80-162; sim values MainWindow.xaml.cs:69-72)."""

    physical_map_size: float = 40.0     # meters (sim ctor arg)
    hole_map_size: int = 256            # pixels (sim ctor arg)
    obstacle_map_size: int = 64         # pixels (sim ctor arg)
    sigma_xy: float = 0.1               # meters (sim ctor arg)
    sigma_theta: float = math.pi / 18   # 10 deg in radians (sim ctor arg)
    # Reference: iterationsPerThread=1000 x numSearchThreads=4 => 4000 perturbed
    # candidates + the search pose itself per scan (CoreSLAMProcessor.cs:624-653,
    # 674-710).  TPU-native: one batch of `num_candidates` scored in a fused kernel;
    # 4096 keeps the reference's search budget and pads to a lane-friendly size.
    num_candidates: int = 4096
    quality: int = 50                   # map-update alpha 1..255 (:80)
    hole_width: float = 2.0             # meters (sim sets 2.0, default 0.6) (:85)
    position_search_beginning: int = 5  # first N scans trust odometry (:90)
    unmapped_obstacle_hits: int = -5    # obstacle map init (:96)
    max_obstacle_hits: int = 10         # obstacle hit cap (:101)
    search_mode: str = "mc"
    # "mc" (default): the reference's Monte-Carlo candidate sampling
    # (ops/score.monte_carlo_search).  "correlative": deterministic dense
    # grid search over (theta bins x WxW pixel shifts) with sub-pixel
    # quadratic refinement (ops/correlate.correlative_search) — same score
    # function, full coverage of the search region, no RNG.
    corr_window: int = 8        # pixel-shift window (W x W, centered)
    corr_num_theta: int = 32    # theta bins across +/- corr_theta_span
    corr_theta_span: float = 0.0
    # radians; 0.0 means "3 * sigma_theta" (match the MC mode's 3-sigma reach)
    dense_hole_fill: bool = False
    # False (default): reference-parity per-beam V-profile ray draw
    # (ops/holemap.update_hole_map).  True: scatter-free dense polar fill
    # (update_hole_map_dense) — order-of-magnitude faster on TPU (XLA scatter
    # serializes), denser evidence between beams; documented divergence.
    dense_obstacle_fill: bool = False
    # Same trade for the obstacle map (ops/obstacle.update_obstacle_map_dense).
    angle_bins: int = 256
    # Polar sectors for the dense fills; must stay <= beam count so every
    # sector is covered by at least one beam.

    @property
    def hole_scale(self) -> float:
        """Pixels per meter (HoleMap.cs:19)."""
        return self.hole_map_size / self.physical_map_size

    @property
    def obstacle_scale(self) -> float:
        return self.obstacle_map_size / self.physical_map_size


@dataclass(frozen=True)
class HectorConfig(_Overlayable):
    """HectorSLAM knobs (HectorSLAMProcessor.cs:51-77, OccGridMap.cs:24-53,
    sim values MainWindow.xaml.cs:76-86)."""

    map_resolution: float = 0.1         # meters/pixel at level 0 (sim: 40/400)
    map_size: int = 400                 # pixels at level 0
    num_levels: int = 4                 # pyramid depth (sim ctor arg)
    # Per-level Gauss-Newton iterations, finest first (sim: 7/4/4/4,
    # MainWindow.xaml.cs:83-86; default 3 per OccGridMap.cs:53).
    estimate_iterations: Tuple[int, ...] = (7, 4, 4, 4)
    update_factor_free: float = 0.4     # odds (OccGridMap.cs:25)
    update_factor_occupied: float = 0.9  # odds (OccGridMap.cs:24)
    min_distance_diff_for_map_update: float = 0.4   # meters (sim; default 0.3)
    min_angle_diff_for_map_update: float = math.pi / 22.5  # 8 deg (sim; default 0.13)
    angle_gate_compat: bool = False
    # False (default): gate on |rad_diff| as the reference *intended*.
    # True: reproduce the reference bug — MathEx.DegDiff (a degrees function) applied
    # to radian poses and compared SIGNED to the radian threshold
    # (HectorSLAMProcessor.cs:108; documented in SURVEY.md §2.3).
    dense_free_fill: bool = False
    # False (default): reference-parity Bresenham-line free marking.
    # True: scatter-free dense polygon fill (ops/logodds.update_occupancy_dense)
    # — 10-20x faster map updates, denser free evidence; use for fleet/mapping-
    # heavy workloads (documented semantic difference).  Uncovered angular
    # sectors are never marked free (empty polar bins stay at range 0), so
    # partial-FoV sensors are handled; the round-4 "6x worse on the
    # 180-degree log" finding was actually WALL EROSION from a zero free
    # margin, fixed by dense_free_margin_px (see below): 0.208 -> 0.038 m
    # rms at the default margin (line mode: 0.034; max err 0.065 vs line's
    # 0.234), and 0.015 at margin 2.0 (docs/PERF.md).
    dense_free_margin_px: float = 0.75
    # Moat of unmarked cells the dense fill leaves in front of each measured
    # range (per-level pixels).  0.5 (the round-4 behavior) lets range noise
    # repeatedly paint free over wall neighbors until walls erode to a
    # one-cell ridge; a slipped odometry hint then locks onto a false
    # minimum (measured on adversarial_180.clf: 0.208 m rms at 0.5 vs 0.038
    # at 0.75 / 0.015 at 2.0).  The default is the largest value that holds
    # the CLEAN bench's strict ATE gate (margin sweep, docs/PERF.md round
    # 5): clean ATE 0.002082 at 0.75 (fixed-mode 0.002109) vs 0.00223+ at
    # >= 1.25.  Degraded-sensor deployments should raise it to 1.5-2.0.
    early_exit_tol: float = 0.0
    # 0 (default): the reference's fixed per-level iteration counts.
    # > 0: stop a level's GN iterations once the step norm (map pixels /
    # radians) drops below the tolerance — converged iterations are numeric
    # no-ops, so accuracy is unchanged while typical matches finish in a
    # fraction of the budget (lax.while_loop; see docs/PERF.md).
    occupied_cap: float = 50.0          # log-odds cap (OccGridMap.cs:211)
    deriv_clamp: float = 0.2            # GN rotation step clamp, rad (ScanMatcher.cs:107-117)
    match_subsample: int = 1
    # 1 (default): match on every beam (reference behavior).  k > 1: the GN
    # MATCHER uses every k-th beam (map updates still use all beams) — the
    # matcher is gather-rate-bound on TPU (~117M gathered elements/s,
    # docs/PERF.md), so matching cost drops ~k-fold for a small precision
    # trade (H conditioning scales with sqrt(beams)).  Production fleet
    # serving uses 4 (100 of 400 beams) — ATE verified in scripts/bench_fleet.
    xy_step_clamp_px: float = 0.0
    # 0 (default): reference parity — only the rotation step is clamped, so a
    # near-singular H in a degenerate view (e.g. bootstrap facing a single
    # wall) can throw the pose off-map in one GN step, after which there is no
    # recovery (the reference has the same failure mode, README.md:39).
    # > 0: robustness extension — per-iteration translation step bounded to
    # +/- this many map pixels (recommended ~10 for production serving).
    matcher_mode: str = "gather"
    # "gather" (default): stacked [4,N] take.  "onehot_highest" /
    # "onehot_bf16": the 4-neighbor fetch as one-hot row matmuls on the MXU
    # (ops/gn.fused_gn_iteration_onehot_stats) — wins when the map table is a
    # loop-carried (variant) operand, where XLA's gather rate is the matcher
    # wall (docs/PERF.md).  "onehot_highest" is bit-identical to "gather";
    # "onehot_bf16" lets the MXU round the table (fast path, ATE-gated).
    # "pallas": the whole coarse-to-fine match as ONE kernel with every
    # level's row table VMEM-resident across all GN iterations
    # (ops/pallas_onehot.py; onehot_bf16 selection semantics, 2.9x faster).
    # Scope limits: requires offset == (0, 0) (asserted; the only value any
    # model uses) and fixed iteration counts — early_exit_tol is
    # rejected (measured unnecessary: converged iterations are no-ops and
    # the kernel's fixed-iteration cost is below the XLA early-exit path).
    max_match_jump: float = 0.0
    # 0 (default): reference parity — the matched pose is always adopted.
    # > 0: robustness extension — if the matcher moved more than this many
    # METERS from its hint in one scan (physically impossible at real scan
    # rates; the signature of a degenerate-view solve, README.md:39), the
    # match is REJECTED and the hint kept.  Bounds per-scan damage in
    # production serving; see docs/PERF.md fleet robustness notes.
    min_match_in_map_frac: float = 0.0
    # 0 (default): reference parity — a match is adopted however few beams
    # landed inside the map.  > 0: robustness extension for worlds LARGER
    # than the map (BASELINE north-star regime) and map-boundary transits:
    # when fewer than this fraction of the matcher's valid beams fall inside
    # map bounds (MatchStats.in_map_frac, last GN iteration), the match is
    # rejected and the hint (odometry prior) kept — a half-out-of-map scan
    # otherwise produces a degenerate one-sided solve that is WORSE than
    # odometry (measured on the office-world bench, scripts/
    # bench_office_graph.py).  ~0.5 recommended when the trajectory can
    # leave the mapped region.
    gn_damping: float = 0.0
    # 0 (default): reference parity — raw Gauss-Newton solve.
    # > 0: Levenberg-style robustness extension — H's diagonal scaled by
    # (1 + gn_damping), shrinking the step along poorly-observed directions
    # (corridor views make H near-singular along the corridor axis and a raw
    # GN step can throw the pose off-map; the reference shares this failure
    # mode, README.md:39).  ~0.1 recommended for production serving.
    fleet_update_capacity: int = 1 << 30
    # Max instances whose gated map update runs per fleet batch-scan
    # (models/fleet.update_fleet phase 3; effective cap = min(B, this)).
    # Instances beyond the budget defer one scan (their gate stays armed).
    # Default = unlimited (every gated instance updates): measured at B=64 on
    # v5e, budget deferral was the DOMINANT fleet accuracy cost — cap=8 gave
    # median instance ATE 0.089 m vs 0.0033 m uncapped, for only ~25% more
    # throughput (docs/PERF.md round-3 fleet findings).  Cap it only when
    # map-update bandwidth is provably the bottleneck and the ATE trade is
    # measured; per-shard in the mesh fleet, so capacity scales with devices.
    offset: Tuple[float, float] = (0.0, 0.0)  # map offset (MapRepMultiMap passes zero)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        """Per-level pixel dims: next level halves pixels (MapRepMultiMap.cs:49-57)."""
        out, s = [], self.map_size
        for _ in range(self.num_levels):
            out.append(s)
            s //= 2
        return tuple(out)

    @property
    def level_resolutions(self) -> Tuple[float, ...]:
        out, r = [], self.map_resolution
        for _ in range(self.num_levels):
            out.append(r)
            r *= 2.0
        return tuple(out)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        """Start offset of each level inside the concatenated pyramid table."""
        out, off = [], 0
        for s in self.level_sizes:
            out.append(off)
            off += s * s
        return tuple(out)

    @property
    def total_cells(self) -> int:
        return sum(s * s for s in self.level_sizes)

    @property
    def log_odds_free(self) -> float:
        p = self.update_factor_free
        return math.log(p / (1.0 - p))

    @property
    def log_odds_occupied(self) -> float:
        p = self.update_factor_occupied
        return math.log(p / (1.0 - p))


@dataclass(frozen=True)
class SimConfig(_Overlayable):
    """Simulator constants (MainWindow.xaml.cs:35-39, Field.cs:43-72)."""

    num_scan_points: int = 400
    scans_per_second: float = 17.0
    max_scan_dist: float = 40.0         # meters
    measure_error: float = 0.02         # +/- uniform noise, meters
    field_scale: float = 30.0           # CreateDefaultField(30, (5,5)) (MainWindow:97)
    field_offset: Tuple[float, float] = (5.0, 5.0)
    start_pose: Tuple[float, float, float] = (20.0, 20.0, 0.0)  # MainWindow:65


@dataclass(frozen=True)
class ParticleConfig(_Overlayable):
    """Batched particle layer (BASELINE.json config 4; TPU-only design)."""

    num_particles: int = 8192
    top_k: int = 64                     # refine budget after coarse scoring
    refine_candidates: int = 64         # per-survivor local perturbations
    resample_ess_frac: float = 0.5      # resample when ESS < frac * N
    scorer: str = "exact"
    # Population scoring kernel.  "exact": one fused [P, N] gather batch per
    # scan (the BASELINE config-4 contract; gather-rate bound, docs/PERF.md).
    # "grid": the correlative count-grid x shifted-planes MXU scorer
    # (ops/correlate) evaluated once per scan on the ccfg.corr_* grid around
    # the odometry prior; each particle reads its nearest (theta-bin, pixel-
    # shift) cell — scores quantized to (1 px, 1 bin), particles outside the
    # grid score int-max.  The grid's sub-pixel argmin is injected as a
    # refine survivor, so the estimate keeps correlative-matcher accuracy.
    score_subsample: int = 1
    # Beam stride for "exact" population scoring (coarse-to-fine: the
    # population ranks on every k-th beam; the top-k refine re-scores
    # candidates on refine_subsample).  1 = bit-exact base semantics.
    refine_subsample: int = 1           # beam stride for the refine stage


@dataclass(frozen=True)
class PoseGraphConfig(_Overlayable):
    """Keyframe pose-graph layer (greenfield; BASELINE.json north star)."""

    max_keyframes: int = 256
    max_edges: int = 1024
    keyframe_dist: float = 0.5          # meters between keyframes
    keyframe_angle: float = 0.35        # radians between keyframes
    loop_closure_radius: float = 2.0    # candidate search radius, meters
    # a loop candidate's index is below the new node's less this gap, so it
    # is at least gap + 1 keyframes older (5: the JAX package's constant)
    loop_min_index_gap: int = 5
    gn_iterations: int = 10
    # per-KEYFRAME-event GN iterations of the incremental pose-graph
    # optimizer (models/graph_slam._spawn_keyframe): each iteration is one
    # dense active-block solve.  The trajectory changes little between
    # keyframes, so the incremental solve converges in 1 iteration unless a
    # loop closure just landed (measured on the 512-scan turning revisit
    # bench: 1/3 vs 3/3 gives IDENTICAL ATE/keyframes/closures at +16%
    # throughput, scripts/profile_graph.py, docs/PERF.md round 4; also
    # validated on the adversarial drifting log, scripts/
    # bench_graph_adversarial.py --optimize-iterations ablation).  For
    # robust-kernel-heavy workloads (huber_delta > 0 with many suspect
    # closures) the DCS/Huber IRLS reweighting gets one re-linearization per
    # non-closure keyframe under this default — restore 3 if closures are
    # frequent and heavily down-weighted.
    optimize_iterations: int = 1
    # GN iterations when this keyframe ACCEPTED a loop closure (the graph
    # residual jumps, so the solve needs the extra iterations); only used
    # when != optimize_iterations.
    optimize_iterations_loop: int = 3
    damping: float = 1e-6
    # loop-closure acceptance (rejects aliased/false candidates): the matcher
    # must stay near its initialization AND land its points on occupied cells
    loop_max_translation: float = 1.0   # meters matcher may move from init
    loop_min_inlier_frac: float = 0.4   # fraction of points on occupied cells
    odom_edge_weights: Tuple[float, float, float] = (50.0, 50.0, 200.0)
    loop_edge_weights: Tuple[float, float, float] = (100.0, 100.0, 400.0)
    # robust IRLS weighting in the GN normal equations: 0 = off; > 0 = the
    # whitened-residual scale of the redescending DCS kernel (posegraph.
    # robust_scale) — a surviving false loop loses its influence entirely
    huber_delta: float = 0.0


def serving_hector_config(**overrides) -> "HectorConfig":
    """The production FLEET-SERVING profile — every knob picked from a
    measured ablation (docs/PERF.md fleet sections), so deployments start
    from the data instead of re-deriving it:

    - ``match_subsample=4`` + ``matcher_mode="onehot_bf16"``: the measured
      serving point (B=64: 2394 -> ~5050 instance-scans/s inside the bench's
      2x ATE gate; the Pallas batched matcher measured a null result here);
    - ``xy_step_clamp_px=10`` + ``max_match_jump=1.0``: bound the damage of
      degenerate-view solves (unrecoverable off-map excursions otherwise);
    - ``gn_damping=0.1``: at the T=256 uncapped serving horizon this halves
      worst-case excursions (max 3.97 -> 1.78 m) at NO median-instance cost
      (0.0051 -> 0.0049) — the round-4 capacity ablation's conclusion,
      encoded as the default it recommended (VERDICT r04 item 6);
    - ``dense_free_fill=True``: with the one-hot fill lookup + wall-erosion
      margin (round 5) the dense fill is 2.3x fleet throughput (4484 ->
      10423 inst-scans/s at B=64 T=256) at 5x BETTER max error (0.119 ->
      0.024 m; median 0.0033 -> 0.0041) — the round-2 "line mode in fleet"
      advice predates both fixes;
    - update capacity UNCAPPED (the HectorConfig default): budget deferral
      compounds map-staleness error ~20x on the median instance for ~25%
      throughput.

    keyword overrides are applied on top (e.g. ``num_levels``/``map_size``
    for a different pyramid).
    """
    base = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        match_subsample=4, matcher_mode="onehot_bf16",
                        xy_step_clamp_px=10.0, max_match_jump=1.0,
                        gn_damping=0.1, dense_free_fill=True)
    return dataclasses.replace(base, **overrides) if overrides else base


@dataclass(frozen=True)
class SlamConfig(_Overlayable):
    """Top-level bundle: both pipelines + sim + aux layers."""

    coreslam: CoreSlamConfig = field(default_factory=CoreSlamConfig)
    hector: HectorConfig = field(default_factory=HectorConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    particle: ParticleConfig = field(default_factory=ParticleConfig)
    graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
