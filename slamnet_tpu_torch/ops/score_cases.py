"""K8's cases (``csrc/mc_search.cu``, ``score.best_of`` on a card) against
``score.best_of_plain``, shared by ``tests/test_torch_mc_search_kernel.py``
(the plain path on the CPU, K8 on a card) and ``chip_smoke.py`` phase 39.

All at coreslam_sim256's size (4,001 candidates, a 256-px hole map, 400
beams), on a ``World``: the loop log's scan 200 with 4,001 candidates
drawn around its pose under ``SEED``, on a hole map built along the log's
first 200 scans, and a planted tie.  ``CASES`` maps each case's name to
(the arguments of ``best_of``, the candidate that must win or None, its
sum or None):

- ``tie``: two distinct poses on two map pixels of value 3 (50 elsewhere)
  with every point at the origin: the first wins, 3 x 400;
- ``out_of_bounds``: every candidate out of the map: candidate 0,
  INT32_MAX;
- ``no_valid_beam``: every beam invalid: candidate 0, INT32_MAX;
- ``b1``, ``b2000`` (the benchmark's ``half_search`` plant's half) and
  ``b4001``: the first 1, 2,000 and all 4,001 candidates (candidate 0
  wins at B = 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, score

SEED = 2                  # the generator seed of the candidates' draws
TIE = (1234, 3999)        # the planted tie's candidates: the first must win


class World(NamedTuple):
    cands: torch.Tensor   # f32[4001, 3] around the log's scan 200
    hole: torch.Tensor    # i32[S * S], built along scans 0..190
    size: int
    scale: float
    points: torch.Tensor  # f32[400, 2], scan 200's cloud
    valid: torch.Tensor   # bool[400]
    tie: torch.Tensor     # f32[4001, 3] with the tie planted at TIE
    flat: torch.Tensor    # i32[S * S]: 50, and 3 under the tie


def world(dev) -> World:
    """The cases' inputs on ``dev``."""
    from .. import replay
    from ..core.config import CoreSlamConfig
    from ..models import coreslam
    from . import holemap

    cfg = CoreSlamConfig(num_candidates=4001)
    S, hs, B = cfg.hole_map_size, cfg.hole_scale, cfg.num_candidates
    dlog = replay.to_device(replay.make_log(seed=0), dev)
    hole = torch.full((S * S,), coreslam.HOLE_INIT, dtype=torch.int32,
                      device=dev)
    for t in range(0, 200, 10):
        hole = holemap.update_hole_map(hole, S, hs, dlog.points[t],
                                       dlog.valid[t], dlog.traj[t],
                                       cfg.hole_width, cfg.quality)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cands = score.sample_candidates(dlog.traj[200], cfg.sigma_xy,
                                    cfg.sigma_theta, B, gen)
    # the tie: candidates about (10 m, 20 m), two planted in the map's
    # right half on pixels of value 3
    flat = torch.full((S * S,), 50, dtype=torch.int32, device=dev)
    tie = score.sample_candidates(
        torch.tensor([10.0, 20.0, 0.0], device=dev), cfg.sigma_xy,
        cfg.sigma_theta, B, gen)
    for i, (x, y, th) in zip(TIE, ((200, 100, 0.3), (230, 60, -1.2))):
        flat[y * S + x] = 3
        tie[i] = torch.tensor([(x + 0.25) / hs, (y + 0.25) / hs, th],
                              device=dev)
    return World(cands, hole, S, hs, dlog.points[200], dlog.valid[200], tie,
                 flat)


def _on(w: World, cands, points=None, valid=None) -> tuple:
    return (cands, w.hole, w.size, w.scale,
            w.points if points is None else points,
            w.valid if valid is None else valid)


CASES = {
    "tie": lambda w: ((w.tie, w.flat, w.size, w.scale,
                       torch.zeros_like(w.points), torch.ones_like(w.valid)),
                      TIE[0], 3 * 400),
    "out_of_bounds": lambda w: (_on(w, w.cands - torch.tensor(
        [100.0, 0.0, 0.0], device=w.cands.device)), 0, score.INT32_MAX),
    "no_valid_beam": lambda w: (_on(w, w.cands,
                                    valid=torch.zeros_like(w.valid)),
                                0, score.INT32_MAX),
    "b1": lambda w: (_on(w, w.cands[:1]), 0, None),
    "b2000": lambda w: (_on(w, w.cands[:2000]), None, None),
    "b4001": lambda w: (_on(w, w.cands), None, None),
}


def run(name: str, w: World) -> tuple:
    """Case ``name`` on ``w``: ``score.best_of`` (K8 on a card) against
    ``best_of_plain`` bit for bit, the pose and sum it must give, one K8
    launch on a card and none on the CPU.  Raises AssertionError where it
    differs; returns (the winning candidate's index, the sum)."""
    args, want_index, want_sum = CASES[name](w)
    cands = args[0]
    c0 = _build.kernel_launches()["K8_search"]
    pose, best = score.best_of(*args)
    launched = _build.kernel_launches()["K8_search"] - c0
    ppose, pbest = score.best_of_plain(*args)
    bits = pose.view(torch.int32)
    if not (torch.equal(bits, ppose.view(torch.int32))
            and torch.equal(best, pbest)):
        raise AssertionError(f"K8 case {name}: {pose.tolist()} {int(best)}, "
                             f"plain {ppose.tolist()} {int(pbest)}")
    won = (cands.view(torch.int32) == bits).all(dim=1).nonzero()
    index, total = int(won[0, 0]), int(best)
    if want_index is not None and index != want_index:
        raise AssertionError(f"K8 case {name}: candidate {index} won, want "
                             f"{want_index}")
    if want_sum is not None and total != want_sum:
        raise AssertionError(f"K8 case {name}: sum {total}, want {want_sum}")
    if launched != (cands.device.type == "cuda"):
        raise AssertionError(f"K8 case {name}: {launched} K8 launches on "
                             f"{cands.device}")
    return index, total


def each_candidate(cands, hole_map_flat, size, scale, points,
                   valid) -> int:
    """``best_of`` on each candidate alone (B = 1, so K8 on a card returns
    that candidate's effective sum) against ``score_candidates``' effective
    sums: the number of candidates that differ.  No host read but the
    count."""
    got = torch.stack([score.best_of(cands[i:i + 1], hole_map_flat, size,
                                     scale, points, valid)[1]
                       for i in range(cands.shape[0])])
    sums, nb = score.score_candidates(hole_map_flat, size, scale, points,
                                      valid, cands)
    want = torch.where(nb > 0, sums, torch.full_like(sums, score.INT32_MAX))
    return int((got != want).sum())
