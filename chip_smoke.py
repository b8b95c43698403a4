#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (slamnet_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  1. device   — a CUDA device is required; its name and power limit;
  2. build    — nvcc builds csrc/*.cu (match.cu: K1/K3/K5/K6, fill.cu: K2,
                line.cu: K4, coreslam_map.cu: K7), one nvcc a source
                started together, into
                build/; each kernel's registers, stack and spills as ptxas
                reports them;
  3. K1       — the match kernel against its plain version on a bootstrapped
                400x400 pyramid: 3 hints (pose within 2e-3, equal solve
                failures, residual within rtol 0.05), the guard config
                (xy clamp, damping, subsample 4; pose within 3e-3), an
                empty scan (returns the hint), a map whose free cells hold
                -100 and -1e4 (below -88.73 e^-v overflows; the same
                bounds, and some such cell must lie under the beams); its
                device time at
                estimate_iterations (1,1,1), (7,4,4) and (14,8,8), and the
                line through them: the cost of one GN iteration (slope) and
                of the launch around them (intercept);
  4. K2       — the fill kernel against its plain version on all 3 levels of
                a bootstrapped map and of random maps: identical occupied
                increments, at most 0.1% of cells per level differing, each
                by |log_odds_free|; do_update=0 leaves the maps bit for bit;
                timed firing and gated;
  5. slice    — the pallas_dense replay of 10 + 512 loop scans through the
                kernels (the 10 bootstrap scans in the fixed config, as the
                bench does): one K1 and one K2 call per replayed scan (launch
                counts), ATE <= JAX_REF_ATE_M + 2e-4 and max error <= 0.05 m;
                scans/s of the kernel path beside the plain path's;
  6. K5       — the fleet match kernel against its plain version on a
                bootstrapped 64-robot fleet (sub4_pallas_dense): 3 hint
                offsets and the guard config (damping), one robot with no
                valid beam (returns its hint), the fleet's maps with free
                cells at -100 and -1e4 (as in 3); equal, bit for bit, to 64
                separate K1 calls;
  7. K6       — the packed fleet match (on no path of its own) equal to K5
                bit for bit at g_pack 1, 2, 4 and 8, and within K5's
                tolerances of the plain version;
  8. K2 batch — the batched fill against its plain version on the fleet's
                maps and random maps, fire masks all / none / ~1 in 18: the
                K2 checks per instance and level, non-firing robots
                untouched bit for bit; the same at B = 300
                robots (the fleet's robots repeated, 252 MB of maps: more
                work items than blocks) and at B = 5000 robots on a
                64/32/16-px pyramid (more robots than one block ranks at
                once);
  9. fleet    — the sub4_pallas_dense fleet of 64 robots, 10 + 64
                batch-scans: one K5 and one batched K2 call per batch-scan
                (74 each, no K1 or single K2), RMS / max / median-instance
                ATE within FLEET_JAX_REF_* + 5e-4 / 0.01 / 2e-4;
                instance-scans/s of the kernel path beside the plain path's;
 10. K3       — the f32-table match against its plain version on a fixed-mode
                400x400 pyramid: 3 hints and the guard config (pose within
                K3_POSE_TOL 1e-5, equal solve failures, residual within
                K3_RESID_RTOL 1e-5), and K1 on the same inputs outside the
                residual bound in at least one of them (so a kernel reading
                the bf16 table fails), free cells at -100 and -1e4 (as in 3,
                within K3's bounds), an empty scan (returns the hint), and a
                scan whose valid beams
                all fall between the subsampled ones (match_subsample 4,
                heading 4.0): the XLA modes' full-scan rule gives the wrapped
                GN estimate, equal to the plain version bit for bit, where
                K1's rule returns the hint; the batched K3 on the 64-robot
                sub1 fleet equals 64 K3 calls bit for bit, its plain version
                within the same tolerances (on its maps with free cells at
                -100 and -1e4 too), and K5 on the same inputs outside the
                residual bound on some robot of each case;
 11. K4       — no global scratch (no map update takes a marks tensor, the
                state carries none); the line update against its plain
                version on all 3 levels of the fixed-mode map and of random
                maps, of a scan whose beams run along the axes and the
                tiles' edges (from a tile corner and a tile's last column)
                and of a robot outside the map, bit for bit, its other
                inputs untouched; do_update=0 leaves the maps bit for bit;
                the batched K4 on the fleet's and random maps, fire masks
                all / none / ~1 in 18, a robot outside the map, B = 300
                robots (more work items than blocks) and B = 5000 robots on
                a 64/32/16-px pyramid (more robots than one block ranks at
                once) x the same masks, bit for bit, non-firing robots
                untouched; timed firing / gated, and at 64 robots none /
                ~1 in 18 / all firing;
 12. fixed    — the fixed replay of 10 + 512 loop scans: one K3 and one K4
                call per replayed scan (no K1, no K2), ATE <=
                JAX_FIXED_REF_ATE_M + 1e-4 (bench.py:256's slack) and max
                error <= 0.05 m; scans/s beside the plain path; the bench's
                relative gate (pallas_dense ATE <= fixed ATE + 1e-4) printed
                for the port and for JAX, as information;
 13. sub1     — the 64-robot sub1 fleet (gather + line updates, subsample 1),
                10 + 64 batch-scans: one batched K3 and one batched K4 call a
                batch-scan (74 each, no K5, no batched K2), RMS / max /
                median-instance ATE within FLEET_SUB1_JAX_REF_* + 5e-4 / 0.01
                / 2e-4; instance-scans/s beside the plain path (best of 1);
 14. exit     — K1's table (onehot_bf16) and K3 with early_exit_tol 1e-3 and
                0.3 px (where every match leaves a level early) against
                their plain versions at the hints of phases 3 and 10: pose
                within K3_POSE_TOL, the same iterations run and solve
                failures; the bench's default candidate onehot_bf16_dense
                replayed over 10 + 512 loop scans through K1 (with the exit)
                and K2: 512 launches each, ATE <= the port's fixed ATE +
                1e-4 (bench.py:256) and <= JAX_EXIT_REF_ATE_M + 2e-4, fewer
                than 15 x 512 GN iterations (the exit fired);
 15. frontend — K1-K4 at the graph frontend's shape (one 128-px level at
                0.25 m, 20 iterations, 400 beams, a fresh zero grid, the
                fire flag set): K4 bit for bit on a simulated scan and on
                beams to the 45-cell tiles' edges, K2 at margin 0.5 with at
                most 0.1% of cells differing, K3 (pose within K3_POSE_TOL)
                and K1 (2e-3) with 20 iterations each; timed, with bounds;
 16. graph    — graph-SLAM replays of the 512-scan turning revisit
                (make_graph_log(7), 12 forced) in gather (K3 + K4) and
                pallas_full (K1 + K2): one match and one map update a scan
                and one of each a loop search (launch counts), a host read a
                scan, one more a keyframe event and one more a search, the
                bench's graph gate (same keyframes, closures
                >= ref - 2, ATE <= 1.15 x ref, max error <= ref + 0.01)
                against GRAPH_JAX_REF_* / GRAPH_ONEHOT_JAX_REF_* and
                pallas_full against gather; scans/s (best of 2, each
                replay's poses the first's bit for bit); the final graph's
                normal equations assembled twice, equal bit for bit; the host
                us a scan of the Hector-only fixed replay of the same log
                without and with one read a scan beside the graph replay's;
                rebuild_maps after the gather replay (256 K4 launches) equal
                to its plain version bit for bit.
 17. office   — the office loop (replay.make_office_log(3), 689 scans, 10
                forced, drifting odometry hints): K3 and K4 on its 200/100/
                50-px pyramid (damping 0.1, the in-map guard) against their
                plain versions, the robot inside the map and outside it (K3
                within K3_POSE_TOL / K3_RESID_RTOL, K4 bit for bit), timed
                with bounds; the Hector-only and graph replays with launch
                counts (one K3 and one K4 a scan; the graph's frontend one
                K1 and one K2 a loop search), host reads (none Hector-only;
                a scan + an event + a search in the graph), the forced
                scans on the odometry, the office gate against
                OFFICE_JAX_REF_* (the same keyframes, closures >= ref - 2,
                optimised keyframe ATE and Hector-only ATE <= 1.15 x ref,
                closure margin >= 0.85 x ref), scans/s best of 2;
 18. coreslam ops — CoreSLAM's ops at the bench's shapes (256-px hole map,
                64-px obstacle map, 400 beams, 4096 candidates, a 32 x 8 x 8
                grid) on the card against the CPU on the same inputs: the
                snaps of score_candidates and correlative_scores and the
                cells of both hole and both obstacle updates differing in at
                most 1 in 10^4, everything else bit for bit; hole_ray_cells
                exact; two runs on the card bit for bit; planted ties keep
                the first minimum; a robot outside the map leaves the maps;
                each op's device us;
 19. coreslam — the 522 loop scans in the production mode from the true
                start and starts moved by 1-3 f32 ulps (CORESLAM_NUDGES) and
                in the parity mode under generator seeds 1-9: the medians
                against CORESLAM_JAX_REF_ATE_M + 2e-3 and the largest of
                CORESLAM_PARITY_JAX_REF_ATES_M (replay.coreslam_gate), 517
                scans searched in every replay, no host read in a replay
                (the first replay of each mode with CUDA's sync debug mode
                set to error), kernels a searched scan (the profiler over
                scans 20-39),
                scans/s (the best of the 2 replays after the first), a
                repeat of the first replay giving its poses bit for bit.
 20. exit     — the fleet's batch-wide early exit (JAX's fleet.py:154-172:
                a level stops only when no robot moved more than the
                tolerance; every robot runs the shared count): K5 (K1's
                onehot_bf16 table) and the batched K3 against their plain
                versions on the bootstrapped 64-robot fleets at tol 1e-3 and
                0.3 px and the 3 exit hints: the same shared count, one per
                batch; the answers of a fixed launch whose per-level counts
                sum to it, bit for bit, as the plain version's exit is its
                fixed loop's; equal solve failures; robot 5 with no valid
                beam at its hint; at 1e-3 (converged) pose within 2e-3 /
                K3_POSE_TOL and residual within rtol 0.05 / K3_RESID_RTOL,
                at 0.3 px (stopped short, the exit firing) the pose error
                reported; at a tolerance no step meets (1e-18) equal to the
                tol-0 launch bit for bit; B = 300 (the fleet repeated) and
                B = 5000 on a 64/32/16-px pyramid, each equal bit for bit to
                the B = 64 launch it repeats, with the plain version's
                counts; device times (CUDA graph) beside the tol-0 launch;
 21. rows     — bench.py's other fleet rows (sub4, sub4_onehot,
                sub4_onehot_cap8, sub4_onehot_cap32) and the exit rows
                sub1_exit and sub4_onehot_exit, 64 robots x (10 + 64)
                batch-scans each: 74 launches of the row's match (and of the
                exit) and 74 of the batched K4, none of any other kernel,
                replay.fleet_row_gate against FLEET_ROW_JAX_REFS, at most
                the cap's updates a batch-scan in the capped rows, the exit
                rows' GN iterations equal to JAX's; instance-scans/s; the
                bench's headline rule (bench.py:540-543) over every row;
 22. particle ops — one particle step of each bench mode at 8192 particles
                on the card and on the CPU from one state (40 scans of the
                exact replay) with one set of draws: particles, scores and
                map cells that differ counted, the same resample decision;
                device us of the 8192 x 400 score, the 4096 x 400 refine,
                the grid, the resample and each mode's step;
 23. particle — the 522 loop scans at 8192 particles in exact and
                grid_dense under generator seeds 1-9: replay.particle_gate
                (each median <= the worst of JAX's nine, grid_dense <= exact
                + 0.02 m), max errors, resamples, no host read in a replay
                (the first of each mode under CUDA's sync debug mode
                "error"), a repeat of each mode's first replay giving its
                poses bit for bit, scans/s; sub4, grid and grid_small one
                seed each, reported.
 24. sim pyramid — K3, K1 (onehot_bf16) and K4 at HectorConfig()'s
                4-level 400/200/100/50-px pyramid (the simulator's and the
                processors'): phase 10's three hints and the guard config
                (K3 within K3_POSE_TOL / K3_RESID_RTOL, K1 within 2e-3 /
                3e-3 and rtol 0.05), an empty scan, K4 bit for bit on all 4
                levels of a bootstrapped and a random map, gated maps
                untouched; K3 and K4 at 181 beams on the dataset pyramid (40
                m over 400 px, 3 levels) of adversarial_180.clf, robot
                inside the loop, nearest the map's edge and 1 m from it
                (beams leaving the map); timed with bounds;
 25. datasets — replay.carmen_replay over examples/data/sim_loop.clf (120
                scans) and adversarial_180.clf (360, robust): the native
                parser's log equal to the Python reader's; one K3 and one
                K4 a scan, no other kernel; no host read (the first under
                CUDA's sync debug mode "error"); replay.dataset_gate
                (sim_loop: Hector within 1e-3 m of JAX's track at every
                scan; adversarial: RMS <= 1.15 x JAX's, max <= JAX's + 0.05,
                RMS < 0.15, max < 0.6, RMS < 0.5 x odometry's; CoreSLAM's
                median over CORESLAM_NUDGES starts <= JAX's + 2e-3);
                scans/s; a track JSONL and occupancy / hole PNGs written;
 26. compat   — HectorSLAMProcessor at the simulator's constructor over the
                10 + 512 loop scans: the track and maps of hector.update bit
                for bit, ATE <= COMPAT_JAX_REF_ATE_M + 1e-4, one K3 + one K4
                an Update (onehot_bf16: one K1 + one K4), MapRep, bitmaps,
                timings; CoreSLAMProcessor over 60 scans, Reset; checkpoints:
                the fixed replay saved at scan 256 and CoreSLAM's parity
                replay at scan 200 (its generator's state inside) resume bit
                for bit, the card's checkpoint restores and steps on the CPU
                within K3_POSE_TOL; debug.all_finite on every state with no
                host read; metrics.device_trace names K3's kernel;
 27. interactive — InteractiveSession() on the card, 40 steps (K3 + K4 a
                step, CoreSLAM MC), no divergence, frames of levels 0-3 and
                the hole map, serve() answering GET /state and POST /pose on
                127.0.0.1, the session's scan rate.
 28-34. multi-device — ``multichip.run(8, "gloo", "cuda")``, the lines
                of ``multichip.report``: ONE launch of 8 ranks
                (slamnet_tpu_torch/parallel/launch.py) sharing the card
                over gloo (NCCL refuses two ranks on one device), every
                section of dryrun_multichip(8) (slamnet_tpu_torch/
                multichip.py's docstring): every collective of the 2x4 and
                4x2 meshes against its definition; the sharded Hector on
                both against the dense replay, its checkpoint resumed on
                both, its onehot_bf16 and exit (0.3 px) runs on 2x4; the
                sharded CoreSLAM, production and parity (K7's obstacle
                launch a scan), = the dense pipeline bit for bit;
                section 3 on 2x4 in both frontends through
                replay.sharded_graph_gate, its rebuild on 4x2 = the serial
                rebuild_maps bit for bit, its checkpoint resumed on 2x4 bit
                for bit and restored on 4x2 = the saved state; the mesh
                fleet = the single-process fleet bit for bit; the
                edge-sharded GN and the Schur step against the dense ones,
                the loop-closure cluster's overflow at 2 slots;
                K1-K5 on the card against their plain versions; each
                section's launches exactly its kernels.
Then 8 one-scan device traces (metrics.device_trace over one fixed
hector.update each, late in this long process) must each hold a K3 and a
K4 kernel.
 35. entry points — in-process, each printing to a buffer:
                ``python -m slamnet_tpu_torch.bench --sections hector,fleet
                --repeats 1`` (exit 0, one JSON line with bench.py's keys,
                correct, nothing skipped; launches a step K3 + K4 in fixed,
                K1 + K2 in onehot_bf16_dense and pallas_dense, the batched
                K3 + K4 in sub1, K5 + the batched K2 in sub4_onehot_dense,
                one each, nothing else); the example replay_demo
                --pipeline all --scans 60 (every pipeline OK, only K3 and
                K4, and K7 for CoreSLAM's and the particle layer's line
                updates, launched); replay_dataset on sim_loop.clf (one K3 and
                one K4 a scan, the written Hector track within 1e-3 m of
                JAX's, the PNGs).
 36. NCCL     — a one-rank NCCL world on the card
                (parallel.launch(..., backend="nccl", world_size 1)): every
                collective of a {"tile": 1, "search": 1} mesh and of an
                {"edge": 1} mesh equals its definition, the barrier, and
                10 forced + 8 matched scans of the sharded Hector at 1x1,
                bit for bit the same scans on a one-rank gloo world on the
                card; no host copy under NCCL.
 37. graph    — hector.update's CUDA graph: the pallas_dense and fixed
                replays of 512 scans through hector.update = the same
                through hector._update_eager bit for bit (poses, every
                HectorInfo field, the maps), one capture and 510 replays,
                the eager run's launch counts; stretches of 20 replayed
                steps under metrics.device_trace hold 20 match_kernel and
                20 fill_kernel records, for a graph captured before the
                stretch and for one captured inside it.
 38. K7       — CoreSLAM's map update (coreslam_map.cu): a 522-scan
                coreslam_sim256 job through the kernels (no host read) =
                the same job through the plain versions bit for bit
                (poses, best sums, hole and obstacle maps every scan), one
                launch of each of K7's three kernels a scan; edges, a robot
                outside the maps, a scan with no valid beam, refused maps;
                the kernels' times beside their bounds and the plain times.
Phases 17-38 print their seconds.
Then one JSON line of kernel measurements, and last the result line.  Each
kernel's entry carries its bound: the larger of the bytes it must move on
this run's inputs (each input read once, each output written once; a match
counts each distinct table cell its beams read, a map update (K2, K4) the
cells it changes) over 3.35 TB/s and its
f32 operations over 67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W), and
library_ms null: no single PyTorch call computes any of these functions.
The frontend entries' launches are a graph replay's count less its 512
Hector launches (one a scan): the loop searches'.  Phases 3 and 10 print
K1's and K3's answers at their hints as f32 bits, to compare two trees' runs.
"""
import base64
import inspect
import itertools
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request

REPS_KERNEL = 200
REPS_PLAIN = 20
TIMED_REPLAYS = 2
G_PACKS = (1, 2, 4, 8)
K6_G_REPORTED = 4     # the g_pack of K6's entry in the kernels line
# K3 vs its plain version: the f32 table leaves only the order of the beam
# sums, 1 ulp of a 20 m coordinate in pose (1.9e-6 measured on the H100) and
# 3.6e-7 of the residual.  K1's bf16 table moved the same match's pose by only
# 2 ulp (3.8e-6) but its residual by 8.7e-5, so the residual bound is the one
# that tells the tables apart; the phase checks that it does on its own inputs
K3_POSE_TOL = 1e-5
K3_RESID_RTOL = 1e-5
SLOPE_ITERS = ((1, 1, 1), (7, 4, 4), (14, 8, 8))
# the card's peaks for a kernel's bound (NVIDIA H100 SXM data sheet, 700 W):
# HBM3 bytes/s, and f32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
MATCH_OPS_PER_BEAM = 90   # f32 operations of one beam in one GN iteration
FILL_OPS_PER_CELL = 30    # a firing cell's distance, bin and free test
LINE_OPS_PER_CELL = 10    # a Bresenham step and its update
EXPF_OVERFLOW = -88.73    # log-odds below which e^-v overflows a float
EXIT_TOL = 1e-3           # bench.py:215's early_exit_tol
EXIT_TOL_FIRES = 0.3      # px: a tolerance at which every match exits early
EXIT_HINTS = ((0.2, -0.15, 0.04), (-0.1, 0.12, -0.03), (0.05, 0.2, 0.06))


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def k3_readings(out, plain, bf16):
    """K3's f32[B, 6] outputs against its plain version's and against the
    bf16 table's (K1/K5) on the same inputs: max |pose err|, max residual
    relative error, max |pose diff| and max residual relative diff (the
    residual is resid_sum / max(n_in, 1), as the JAX stats give it)."""
    import numpy as np

    def resid(o):
        return o[:, 4] / np.maximum(o[:, 5], 1.0)

    def rel(a, b):
        return float((np.abs(resid(a) - resid(b))
                      / np.maximum(np.abs(resid(b)), 1e-30)).max())
    return (float(np.abs(out[:, :3] - plain[:, :3]).max()), rel(out, plain),
            float(np.abs(out[:, :3] - bf16[:, :3]).max()), rel(out, bf16))


def f32_bits(out) -> str:
    """A match's first six outputs (x, y, theta, solve failures, residual
    sum, in-bounds beams) as the hex of their f32 bits."""
    import numpy as np
    return " ".join(f"{b:08x}" for b in
                    np.asarray(out[:6], np.float32).view(np.uint32))


def bound(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``nbytes`` moved and ``ops`` f32 operations done."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cells_read(maps, points, valid, hints, cfg):
    """The distinct table cells (flat indices into ``maps``) that a batched
    match's beams read on these inputs: the plain version's loop, recording
    the cells."""
    import torch
    from slamnet_tpu_torch.core.geometry import normalize_angle
    from slamnet_tpu_torch.ops import match
    from slamnet_tpu_torch.ops.gn import _gn_coords, _gn_tail

    b, sub = points.shape[0], cfg.match_subsample
    X, Y, V = points[:, ::sub, 0], points[:, ::sub, 1], valid[:, ::sub]
    table = (maps if match.table_f32(cfg)
             else maps.to(torch.bfloat16).to(torch.float32))
    inst = torch.arange(b, device=maps.device)[:, None] * cfg.total_cells
    tol2 = match._tol2(cfg)
    seen = []
    pose = hints
    for level in range(cfg.num_levels - 1, -1, -1):
        w = cfg.level_sizes[level]
        scale = 1.0 / cfg.level_resolutions[level]
        row0 = inst + cfg.level_offsets[level]
        est = torch.stack([pose[:, 0] * scale, pose[:, 1] * scale, pose[:, 2]],
                          dim=1)
        live = True     # the batch-wide rule: one flag for every instance
        for _ in range(cfg.estimate_iterations[level]):
            if not live:                            # the iterations that run
                break
            sr, cr, mx, my, ok, xi, yi = _gn_coords(w, scale, est, X, Y, V)
            base = row0 + (yi * w + xi).long()
            idx = torch.stack([base, base + 1, base + w, base + w + 1])
            seen.append(idx.reshape(-1))
            new = _gn_tail(torch.sigmoid(table[idx]), mx, my, xi, yi, ok, X,
                           Y, sr, cr, est, cfg.deriv_clamp,
                           cfg.xy_step_clamp_px, cfg.gn_damping)[0]
            d = new - est
            est = new
            if tol2 > 0.0:
                live = bool((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                             + d[:, 2] * d[:, 2]).max() > tol2)
        pose = torch.stack([est[:, 0] / scale, est[:, 1] / scale,
                            normalize_angle(est[:, 2])], dim=1)
    return torch.unique(torch.cat(seen))


def match_work(maps, points, valid, hints, cfg, iters=None) -> tuple:
    """Bytes and f32 operations of a batched match on these inputs: each
    distinct table cell its beams read (4 B), the matcher beams' points and
    flags, the hints, the f32[7] outputs; MATCH_OPS_PER_BEAM a
    beam-iteration, over ``iters`` iterations an instance (the GN
    iterations the run made; default the fixed counts)."""
    cells = int(cells_read(maps, points, valid, hints, cfg).numel())
    beams = valid[:, ::cfg.match_subsample].numel()
    if iters is None:
        iters = sum(cfg.estimate_iterations[:cfg.num_levels])
    return (4 * cells + 9 * beams + 40 * points.shape[0],
            MATCH_OPS_PER_BEAM * iters * beams)


def deep_free(torch, maps):
    """A copy of ``maps`` whose free cells (log-odds below 0) hold -100 and
    -1e4 in turn: below EXPF_OVERFLOW, where e^-v overflows a float and the
    sigmoid 1 / (1 + e^-v) is 0.  Nothing bounds a free cell's log-odds
    from below (each update adds log(0.4/0.6)), so a long run reaches them."""
    out = maps.clone()
    odd = torch.arange(maps.numel(), device=maps.device) % 2 == 1
    out[(maps < 0) & ~odd] = -100.0
    out[(maps < 0) & odd] = -1e4
    return out


def check_deep(what, deep, out, plain, points, valid, hints, cfg, pose_tol,
               resid_rtol) -> tuple:
    """A match kernel's f32[7] or f32[B, 7] ``out`` on ``deep`` (from
    deep_free) against its plain version's ``plain``: cells below
    EXPF_OVERFLOW under the beams, finite, the pose within ``pose_tol``,
    equal solve failures, the residual within ``resid_rtol``.  Returns the
    max |pose err| and how many cells read lie below EXPF_OVERFLOW."""
    import numpy as np
    from slamnet_tpu_torch.ops import match
    k = out.reshape(-1, match.OUT).cpu().numpy()
    p = plain.reshape(-1, match.OUT).cpu().numpy()
    b = k.shape[0]
    read = cells_read(deep, points.reshape(b, -1, 2), valid.reshape(b, -1),
                      hints.reshape(b, 3), cfg)
    n_deep = int((deep[read] < EXPF_OVERFLOW).sum())
    check(n_deep > 0, f"{what}: no cell below {EXPF_OVERFLOW} under the beams")
    check(np.isfinite(k).all(), f"{what}: output not finite: {k}")
    err = float(np.abs(k[:, :3] - p[:, :3]).max())
    check(err <= pose_tol, f"{what}: pose vs plain max diff {err} (tol "
          f"{pose_tol})")
    check((k[:, 3] == p[:, 3]).all(),
          f"{what}: solve failures {k[:, 3]} vs plain {p[:, 3]}")
    res_k = k[:, 4] / np.maximum(k[:, 5], 1.0)
    res_p = p[:, 4] / np.maximum(p[:, 5], 1.0)
    rel = float((np.abs(res_k - res_p) / np.maximum(np.abs(res_p), 1e-30)).max())
    check(rel <= resid_rtol, f"{what}: residual rel err {rel} vs plain (rtol "
          f"{resid_rtol})")
    return err, n_deep


def fill_work(cfg, changed: int, n: int, n_fire: int, batch: int) -> tuple:
    """K2's bytes and operations: each cell the fill changes, read and
    written once (f32; counted from the run, as for K4), the firing robots'
    scans (points, valid, two poses), the B fire flags; FILL_OPS_PER_CELL
    for every cell of a firing robot's levels, each of which the polar test
    decides."""
    return (8 * changed + n_fire * (9 * n + 24) + batch,
            FILL_OPS_PER_CELL * n_fire * cfg.total_cells)


def line_work(cells: int, n: int, n_fire: int, batch: int) -> tuple:
    """K4's bytes and operations: each cell its walks change, read and
    written once (f32), the firing robots' scans, the B fire flags."""
    return 8 * cells + n_fire * (9 * n + 24) + batch, LINE_OPS_PER_CELL * cells


def iteration_slope(torch, run, cfg, reps: int = REPS_KERNEL) -> tuple:
    """Device ms of ``run(c)`` (a CUDA graph of ``reps`` calls) for ``c`` =
    ``cfg`` at each SLOPE_ITERS, and the least-squares line through them
    over the total iterations: (times, ms an iteration, ms at none)."""
    ms = [graph_ms(torch, lambda c=cfg.overlay({"estimate_iterations": it}):
                   run(c), reps) for it in SLOPE_ITERS]
    xs = [sum(it) for it in SLOPE_ITERS]
    mx, my = sum(xs) / len(xs), sum(ms) / len(ms)
    k = (sum((x - mx) * (y - my) for x, y in zip(xs, ms))
         / sum((x - mx) ** 2 for x in xs))
    return ms, k, my - k * mx


def _events_ms(torch, run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(torch, fn, reps: int) -> float:
    """Time per call of ``fn`` as a caller sees it: CUDA events around
    ``reps`` eager calls after a warm-up call (host launch cost included
    where the device waits for the host)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _events_ms(torch, run, reps)


def graph_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, timed with CUDA events over a replay, so no host launch cost is
    left between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, reps)


MESH_RANKS = 8            # phases 28-34: gloo ranks sharing the card
ONE_SCAN_TRACES = 8       # one-scan device traces late in the script


# ---- phase 36: NCCL on the one card ---------------------------------------
NCCL_SCANS = 8            # matched scans after the bootstrap
NCCL_TIMEOUT_S = 120


def nccl_phase(work: str, device: str | None = None) -> dict:
    """Phase 36 on the one rank of a world ``nccl_smoke`` launches (NCCL or
    gloo, on the card unless ``device`` names another: a rehearsal of the
    gloo run on the CPU): every collective of a 1x1 mesh and of a one-rank
    edge mesh against its definition, the barrier, then the sharded
    Hector's bootstrap and NCCL_SCANS matched scans at 1x1, whose poses and
    maps go to ``work/<backend>.npz``.  Any failed check raises."""
    import numpy as np
    import torch
    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.models import hector_sharded as hs
    from slamnet_tpu_torch.parallel import make_mesh

    m = make_mesh({"tile": 1, "search": 1}, device)
    edge = make_mesh({"edge": 1}, device)
    dev = m.device
    check(device is not None or dev == torch.device("cuda", 0)
          == torch.device("cuda", torch.cuda.current_device()),
          f"the rank runs on {dev}")
    x = torch.arange(4, dtype=torch.float32, device=dev) * 10 + 1
    zero = torch.zeros(4, device=dev)
    for name, mm, axes in (("1x1", m, ("tile", "search",
                                       ("tile", "search"))),
                           ("edge", edge, ("edge",))):
        for a in axes:
            for op, fn in (("psum", mm.psum), ("pmax", mm.pmax),
                           ("pmin", mm.pmin)):
                check(torch.equal(fn(x, a), x), f"{name} {op} {a}")
            if isinstance(a, str):
                check(torch.equal(mm.all_gather(x, a), x[None])
                      and torch.equal(mm.all_gather(x, a, tiled=True), x),
                      f"{name} all_gather {a}")
                check(torch.equal(mm.ppermute(x, a, []), zero),
                      f"{name} ppermute {a}")
        mm.barrier()
    coll = m.counts["collectives"] + edge.counts["collectives"]
    cfg = replay.fixed_config()
    log = replay.make_log(0)
    dlog = replay.head(replay.to_device(log, dev),
                       log.bootstrap + NCCL_SCANS)
    st, out = replay.sharded_replay(m, dlog, cfg)
    maps = hs.unshard_maps(m, st, cfg)
    np.savez(f"{work}/{m.backend}.npz", poses=out.poses.cpu().numpy(),
             maps=maps.cpu().numpy())
    return {"backend": m.backend, "device": str(dev),
            "collectives_checked": coll,
            "counts": {"1x1": dict(m.counts), "edge": dict(edge.counts)}}


def nccl_smoke(torch) -> dict:
    """Phase 36: ``nccl_phase`` on a one-rank NCCL world on the card, then
    on a one-rank gloo world; their tracks and maps bit for bit."""
    import numpy as np
    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        runs, secs = {}, {}
        for backend in ("nccl", "gloo"):
            t1 = time.perf_counter()
            runs[backend] = launch.launch(
                "chip_smoke:nccl_phase", 1, {"work": tmp}, backend=backend,
                timeout_s=NCCL_TIMEOUT_S)[0]
            secs[backend] = time.perf_counter() - t1
        got = {b: dict(np.load(f"{tmp}/{b}.npz")) for b in runs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nc = runs["nccl"]
    check(nc["backend"] == "nccl" and nc["device"] == "cuda:0",
          f"phase 36 ran on {nc['backend']} / {nc['device']}")
    copies = {k: c["host_copies"] for k, c in nc["counts"].items()}
    check(not any(copies.values()), f"host copies under NCCL: {copies}")
    same = all(np.array_equal(got["nccl"][k], got["gloo"][k])
               for k in ("poses", "maps"))
    check(same, "the sharded Hector at 1x1 on NCCL differs from gloo's")
    n = got["nccl"]["poses"].shape[0]
    boot = replay.make_log(0).bootstrap
    say(f"[nccl] a one-rank NCCL world on {nc['device']}: "
        f"{nc['collectives_checked']} collectives of the 1x1 and edge meshes "
        f"= their definitions, the barrier; the sharded Hector at 1x1 over "
        f"{boot} forced + {n - boot} matched scans = the one-rank gloo "
        f"run's poses and maps bit for bit; host copies {copies} (gloo "
        f"{sum(c['host_copies'] for c in runs['gloo']['counts'].values())});"
        f" {secs['nccl']:.1f} s NCCL, {secs['gloo']:.1f} s gloo")
    total = time.perf_counter() - t0
    say(f"[seconds] phase 36: {total:.1f}")
    return {"collectives_checked": nc["collectives_checked"],
            "nccl_counts": nc["counts"], "scans": int(n),
            "bit_for_bit_gloo": same, "seconds": total}


# ---- phase 35: the entry points -------------------------------------------
BENCH_SECTIONS = ("hector", "fleet")
# the bench's keys for those sections, letter for letter (bench.py:261-273,
# :543-553), and each mode's kernels, one launch a step each on the card
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "fixed_iter_scans_per_sec", "ate_m", "max_err_m", "map_updates",
              "gn_residual_mean", "solve_failures", "hector_modes", "n_scans",
              "fleet_batch", "fleet_mode", "fleet_instance_scans_per_sec",
              "fleet_vs_single_instance", "fleet_ate_m", "fleet_ate_median_m",
              "fleet_max_err_m", "fleet_ate_bound_m", "fleet_modes",
              "device", "sections", "correct")
BENCH_KERNELS = {"hector_modes": {"fixed": ("K3", "K4"),
                                  "onehot_bf16_dense": ("K1", "K2"),
                                  "pallas_dense": ("K1", "K2")},
                 "fleet_modes": {"sub1": ("K3_batch", "K4_batch"),
                                 "sub4_onehot_dense": ("K5", "K2_batch")}}
DEMO_SCANS = 60
CORESLAM_LINE_KERNELS = ("K7_hole_walk", "K7_hole_blend", "K7_obstacle")


def entry_point_smoke(torch, dev) -> dict:
    """Phase 35: the port's bench (its hector and fleet sections, one timed
    replay a mode) and the examples replay_demo (every pipeline) and
    replay_dataset (sim_loop.clf), in-process through their ``main``, each
    printing to a buffer."""
    import contextlib
    import io
    import numpy as np
    from slamnet_tpu_torch import bench, replay
    from slamnet_tpu_torch.examples import replay_dataset, replay_demo
    from slamnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    device = ["--device", "cuda" if on_card else "cpu"]

    def call(main, argv):
        buf = io.StringIO()
        _build.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = main([*device, *argv])
        if on_card:
            torch.cuda.synchronize()
        counts = {k: v for k, v in _build.kernel_launches().items() if v}
        return rc, buf.getvalue(), counts

    rc, out, _ = call(bench.main, ["--sections", ",".join(BENCH_SECTIONS),
                                   "--repeats", "1"])
    lines = out.splitlines()
    check(rc == 0 and len(lines) == 1, f"the bench exited {rc} with "
          f"{len(lines)} lines: {out[-3000:]}")
    line = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in line]
    check(not missing, f"the bench's line lacks {missing}")
    check(line["correct"] and all(line["sections"][s]["correct"]
                                  for s in BENCH_SECTIONS)
          and "skipped" not in line and "errors" not in line,
          f"the bench: {line['sections']}, skipped {line.get('skipped')}, "
          f"errors {line.get('errors')}")
    for table, modes in BENCH_KERNELS.items():
        for mode, kernels in modes.items():
            got = line[table][mode]["launches_per_step"]
            want = dict.fromkeys(kernels, 1.0) if on_card else {}
            check(got == want, f"the bench's {mode}: launches a step {got}, "
                  f"want {want}")
    bench_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    rc, demo_out, demo_counts = call(replay_demo.main, [
        "--pipeline", "all", "--scans", str(DEMO_SCANS)])
    oks = re.findall(r"^(\w+): ATE=([0-9.]+) m .*\[OK\]$", demo_out, re.M)
    check(rc == 0 and [n for n, _ in oks] == ["coreslam", "particle", "graph",
                                               "hector"],
          f"replay_demo exited {rc}: {demo_out[-2000:]}")
    if on_card:   # Hector and graph-SLAM at HectorConfig(): K3 + K4;
        # CoreSLAM and the particle layer's line updates: K7
        check(set(demo_counts) == {"K3", "K4", *CORESLAM_LINE_KERNELS}
              and min(demo_counts["K3"], demo_counts["K4"])
              >= 2 * (DEMO_SCANS - 10),
              f"replay_demo's launches {demo_counts}")
    demo_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        rc, ds_out, ds_counts = call(replay_dataset.main,
                                     ["--out-dir", out_dir])
        with open(os.path.join(out_dir, "track.jsonl")) as f:
            track = np.asarray([json.loads(ln)["hector"] for ln in f])
        pngs = []
        for name in ("hole_map.png", "occupancy.png"):
            with open(os.path.join(out_dir, name), "rb") as f:
                pngs.append(f.read(8) == b"\x89PNG\r\n\x1a\n")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n = track.shape[0]
    check(rc == 0 and n == 120 and all(pngs),
          f"replay_dataset exited {rc}, {n} track lines, PNGs {pngs}: "
          f"{ds_out[-2000:]}")
    if on_card:
        check(ds_counts == {"K3": n, "K4": n},
              f"replay_dataset's launches {ds_counts}, want one K3 and one "
              "K4 a scan")
    # the track is written to 4 decimals
    dev_jax = float(np.abs(track[:, :2] - replay.dataset_reference_track(
        "sim_loop")[:, :2]).max())
    check(dev_jax <= 1e-3 + 5e-5, f"replay_dataset's Hector track {dev_jax} "
          "m from JAX's")
    ds_s = time.perf_counter() - t2

    h, fl = line["hector_modes"], line["fleet_modes"]
    say(f"[entry] python -m slamnet_tpu_torch.bench --sections "
        f"{','.join(BENCH_SECTIONS)} --repeats 1 in-process: exit 0, one "
        f"line, correct; headline {line['hector_mode']} "
        f"{line['value']:.1f} scans/s (x{line['vs_baseline']:.1f} the "
        f"baseline), fixed {line['fixed_iter_scans_per_sec']:.1f}; fleet "
        f"{line['fleet_mode']} {line['fleet_instance_scans_per_sec']:.1f} "
        "instance-scans/s; launches a step "
        + "; ".join(f"{m} {r['launches_per_step']}"
                    for m, r in {**h, **fl}.items())
        + f"; {bench_s:.1f} s")
    say(f"[entry] replay_demo --pipeline all --scans {DEMO_SCANS}: "
        + ", ".join(f"{p} ATE {a} m" for p, a in oks)
        + f", all OK, launches {demo_counts}; {demo_s:.1f} s")
    say(f"[entry] replay_dataset on sim_loop.clf: {n} scans, launches "
        f"{ds_counts}, Hector track within {dev_jax:.3g} m of JAX's (4 "
        f"decimals), track JSONL and PNGs written; {ds_s:.1f} s")
    secs = time.perf_counter() - t0
    say(f"[seconds] phase 35: {secs:.1f}")
    return {"bench": {k: line[k] for k in BENCH_KEYS},
            "demo_ates_m": dict(oks), "demo_launches": demo_counts,
            "dataset_launches": ds_counts, "dataset_max_dev_from_jax_m":
            dev_jax, "seconds": secs}


# ---- phase 37: hector.update's CUDA graph -----------------------------------
GRAPH_TRACE_STEPS = 20    # steps of each traced stretch of phase 37


def graph_step_smoke(torch, dev) -> dict:
    """Phase 37: ``hector.update`` replays its step as a CUDA graph.  The
    512-scan replays in ``pallas_dense`` and ``fixed`` through ``update``
    equal the same replays through ``hector._update_eager`` bit for bit
    (every pose, HectorInfo field and the maps), with one capture a map,
    the steps less 2 replays and the eager run's launch counts; and
    profiled stretches of replayed steps (``metrics.device_trace``) record
    one ``match_kernel`` and one ``fill_kernel`` a step, both for a graph
    captured before the stretch and for one captured inside it."""
    from torch.autograd import DeviceType
    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.core.scan import Scan
    from slamnet_tpu_torch.io import metrics as io_metrics
    from slamnet_tpu_torch.models import hector
    from slamnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = replay.make_log(seed=0)
    dlog = replay.to_device(log, dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    b = log.bootstrap
    n = dlog.points.shape[0] - b

    def clone(st):
        return hector.HectorState(*(t.clone() for t in st))

    def run(step, st, cfg, t0, t1):
        poses, infos = [], []
        for t in range(t0, t1):
            st, info = step(st, Scan(dlog.points[t], dlog.valid[t], zero),
                            st.match_pose, cfg)
            poses.append(st.match_pose)
            infos.append(info)
        return st, poses, infos

    def same(a, b):
        ok = torch.equal(a[0].maps, b[0].maps) and torch.equal(
            a[0].last_update_pose, b[0].last_update_pose)
        ok = ok and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        return ok and all(u.dtype == v.dtype and torch.equal(u, v)
                          for x, y in zip(a[2], b[2]) for u, v in zip(x, y))

    out = {}
    for name, cfg in (("pallas_dense", replay.pallas_dense_config()),
                      ("fixed", replay.fixed_config())):
        st0 = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog, b,
                               cfg)
        _build.reset_launches()
        eager = run(hector._update_eager, clone(st0), cfg, b, b + n)
        torch.cuda.synchronize()
        want = _build.kernel_launches()
        _build.reset_launches()
        g0 = (hector.update.graph_captures, hector.update.graph_replays)
        graph = run(hector.update, clone(st0), cfg, b, b + n)
        torch.cuda.synchronize()
        got = _build.kernel_launches()
        g1 = (hector.update.graph_captures - g0[0],
              hector.update.graph_replays - g0[1])
        check(same(graph, eager), f"{name}: the {n}-scan replay through "
              "hector.update differs from the eager step's")
        check(g1 == (1, n - 2), f"{name}: {g1[0]} captures and {g1[1]} "
              f"replays over {n} scans of one map, want 1 and {n - 2}")
        check(got == want, f"{name}: launch counts {got}, eager {want}")
        secs = {}
        for label, step in (("eager", hector._update_eager),
                            ("graph", hector.update)):
            st = clone(st0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(step, st, cfg, b, b + n)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t
        out[name] = {"captures_replays": g1,
                     "launches": {k: v for k, v in got.items() if v},
                     "scans_per_s": {k: n / v for k, v in secs.items()}}
        say(f"[graph] {name}: {n} scans through hector.update = the eager "
            f"step bit for bit; {g1[0]} capture, {g1[1]} replays; launches "
            f"{out[name]['launches']} as eager; "
            f"{n / secs['graph']:.1f} scans/s replayed vs "
            f"{n / secs['eager']:.1f} eager")

    cfg = replay.pallas_dense_config()
    st0 = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog, b, cfg)
    k = GRAPH_TRACE_STEPS
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_graph_")

    def traced(st, t0, label):
        with io_metrics.device_trace(trace_dir) as tr:
            res = run(hector.update, st, cfg, t0, t0 + k)
        names = [e.name for e in tr.prof.events()
                 if e.device_type == DeviceType.CUDA]
        spans = [e.name for e in tr.prof.events()
                 if e.name.startswith("slamnet.hector.")]
        got = {"match_kernel": sum("match_kernel" in x for x in names),
               "fill_kernel": sum("fill_kernel" in x for x in names),
               "replay_spans": spans.count("slamnet.hector.graph_replay")}
        check(got["match_kernel"] == k and got["fill_kernel"] == k,
              f"{label}: {got} over {k} steps, want one match_kernel and "
              "one fill_kernel a step")
        out[label] = got
        return res

    try:
        before, twin = clone(st0), clone(st0)
        before = run(hector.update, before, cfg, b, b + k)[0]
        twin = run(hector._update_eager, twin, cfg, b, b + k)[0]
        a = traced(before, b + k, "captured_before")
        e = run(hector._update_eager, twin, cfg, b + k, b + 2 * k)
        check(same(a, e), "replays of a graph captured before the profiler "
              "differ from the eager step's")
        inside, twin2 = clone(st0), clone(st0)
        c = traced(inside, b, "captured_inside")
        e2 = run(hector._update_eager, twin2, cfg, b, b + k)
        check(same(c, e2), "steps captured inside a profiled stretch differ "
              "from the eager step's")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    secs = time.perf_counter() - t0
    say(f"[graph] profiled stretches of {k} steps: a graph captured before "
        f"{out['captured_before']}, one captured inside "
        f"{out['captured_inside']}; {secs:.1f} s")
    say(f"[seconds] phase 37: {secs:.1f}")
    out["seconds"] = secs
    return out

# ---- phase 38: CoreSLAM's map update, K7 ----------------------------------
CORESLAM_MAP_SEED = 1     # the generator seed of phase 38's job


def coreslam_map_smoke(torch, dev) -> dict:
    """Phase 38: K7 (``csrc/coreslam_map.cu``) against its plain versions
    on the card.  One whole job of ``coreslam_sim256`` (the loop log's
    scans through ``coreslam.update_cloud`` from the true start, 4,001
    Monte-Carlo candidates, line updates) through the kernels, under CUDA's
    sync debug mode "error", and again through ``update_hole_map_plain`` /
    ``update_obstacle_map_plain``: every pose, best sum, hole map and
    obstacle map bit for bit, and one launch of each K7 kernel a scan.
    Then, on the job's last maps: the robot near an edge (ClipRay) bit for
    bit, a robot pixel outside the maps leaves both (and the inputs) as
    they were, a scan with no valid beam equals the plain path and leaves
    the maps, and the wrappers raise on a non-contiguous or wrongly typed
    map.  Times each kernel (a CUDA graph of REPS_KERNEL calls, and eager
    calls with the host's launch cost) beside its bytes bound and the plain
    version's time."""
    from unittest import mock
    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.core.config import CoreSlamConfig
    from slamnet_tpu_torch.core.scan import Scan
    from slamnet_tpu_torch.models import coreslam
    from slamnet_tpu_torch.ops import _build, holemap, obstacle

    t0 = time.perf_counter()
    cfg = CoreSlamConfig(num_candidates=4001)
    S, OS = cfg.hole_map_size, cfg.obstacle_map_size
    hs, osc = cfg.hole_scale, cfg.obstacle_scale
    dlog = replay.to_device(replay.make_log(seed=0), dev)
    n_scans, n = dlog.points.shape[:2]
    zero = torch.zeros(3, dtype=torch.float32, device=dev)

    def job():
        st = coreslam.init(cfg, dlog.traj[0], seed=CORESLAM_MAP_SEED,
                           device=dev)
        poses, sums, holes, obsts = [], [], [], []
        for t in range(n_scans):
            st, info = coreslam.update_cloud(
                st, Scan(dlog.points[t], dlog.valid[t], zero), st.pose, cfg)
            poses.append(st.pose)
            sums.append(info.best_sum)
            holes.append(st.hole_map)
            obsts.append(st.obstacle_map)
        return torch.stack(poses), torch.stack(sums), holes, obsts

    def counts():
        got = _build.kernel_launches()
        return tuple(got[k] for k in CORESLAM_LINE_KERNELS)

    # one call of each before the timed jobs: the kernel library (phase 2
    # of a full run builds it), the scratch and the decay table
    holemap.update_hole_map(
        torch.full((S * S,), coreslam.HOLE_INIT, dtype=torch.int32,
                   device=dev), S, hs, dlog.points[0], dlog.valid[0],
        dlog.traj[0], cfg.hole_width, cfg.quality)
    obstacle.update_obstacle_map(
        torch.full((OS, OS), cfg.unmapped_obstacle_hits, dtype=torch.int8,
                   device=dev), OS, osc, dlog.points[0], dlog.valid[0],
        dlog.traj[0], cfg.max_obstacle_hits)
    c0 = counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # no host read in the job
    tk = time.perf_counter()
    try:
        kp, ks, kh, ko = job()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tk = time.perf_counter() - tk
    launches = tuple(b - a for a, b in zip(c0, counts()))
    check(launches == (n_scans,) * 3, f"K7 launch counts {launches} over "
          f"{n_scans} scans, want one of each kernel a scan")
    with mock.patch.object(holemap, "update_hole_map",
                           holemap.update_hole_map_plain), \
            mock.patch.object(obstacle, "update_obstacle_map",
                              obstacle.update_obstacle_map_plain):
        tp = time.perf_counter()
        pp, ps, ph, po = job()
        torch.cuda.synchronize()
        tp = time.perf_counter() - tp
    check(counts() == tuple(a + b for a, b in zip(c0, launches)),
          "the plain job launched K7")
    diff = {"pose_scans": int((kp != pp).any(dim=1).sum()),
            "best_sum_scans": int((ks != ps).sum()),
            "hole_pixels": int(sum((a != b).sum() for a, b in zip(kh, ph))),
            "obstacle_cells": int(sum((a != b).sum() for a, b in zip(ko, po)))}
    check(not any(diff.values()), f"K7's job differs from the plain path's "
          f"over {n_scans} scans: {diff}")
    hole, obst = kh[-1], ko[-1]
    changed = (int((hole != coreslam.HOLE_INIT).sum()),
               int((obst != cfg.unmapped_obstacle_hits).sum()))
    check(changed[0] > 10000 and changed[1] > 200,
          f"the job's maps hardly changed: {changed} pixels and cells")

    t = n_scans // 5
    pts, val = dlog.points[t], dlog.valid[t]
    hcopy, ocopy = hole.clone(), obst.clone()

    def both(p, v):
        """(kernel, plain) for the hole map, then for the obstacle map."""
        ha = (S, hs, pts, v, p, cfg.hole_width, cfg.quality)
        oa = (OS, osc, pts, v, p, cfg.max_obstacle_hits)
        return ((holemap.update_hole_map(hole, *ha),
                 holemap.update_hole_map_plain(hole, *ha)),
                (obstacle.update_obstacle_map(obst, *oa),
                 obstacle.update_obstacle_map_plain(obst, *oa)))

    for pose in ((0.3, 20.0, 0.4), (39.5, 2.0, -2.5), (20.0, 39.6, 1.2)):
        (hk, hp), (ok_, op) = both(torch.tensor(pose, device=dev), val)
        check(torch.equal(hk, hp) and torch.equal(ok_, op),
              f"K7 at the map's edge {pose} differs from the plain path")
    for pose in ((-3.0, 20.0, 0.2), (20.0, 40.5, 1.0)):
        (hk, hp), (ok_, op) = both(torch.tensor(pose, device=dev), val)
        check(all(torch.equal(x, hole) for x in (hk, hp))
              and all(torch.equal(x, obst) for x in (ok_, op)),
              f"a robot outside the maps at {pose} changed them")
    (hk, hp), (ok_, op) = both(dlog.traj[t].clone(), torch.zeros_like(val))
    check(torch.equal(hk, hp) and torch.equal(hk, hole)
          and torch.equal(ok_, op) and torch.equal(ok_, obst),
          "a scan with no valid beam changed a map or differs from plain")
    check(torch.equal(hole, hcopy) and torch.equal(obst, ocopy),
          "K7 wrote into its input map")
    pose = dlog.traj[t].clone()
    bad = {"non-contiguous hole map": lambda: holemap.update_hole_map(
               torch.empty(2 * S * S, dtype=torch.int32, device=dev)[::2], S,
               hs, pts, val, pose, cfg.hole_width, cfg.quality),
           "int64 hole map": lambda: holemap.update_hole_map(
               hole.long(), S, hs, pts, val, pose, cfg.hole_width,
               cfg.quality),
           "transposed obstacle map": lambda: obstacle.update_obstacle_map(
               obst.t(), OS, osc, pts, val, pose, cfg.max_obstacle_hits),
           "int32 obstacle map": lambda: obstacle.update_obstacle_map(
               obst.int(), OS, osc, pts, val, pose, cfg.max_obstacle_hits)}
    c1 = counts()
    for name, fn in bad.items():
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"K7 took a {name}")
    check(counts() == c1, "a refused call counted a launch")
    real = holemap.update_hole_map           # a caller wrapping the name
    with mock.patch.object(holemap, "update_hole_map",
                           lambda *a, **k: real(*a, **k)):
        wrapped = coreslam.update_maps(
            coreslam.init(cfg, pose, device=dev)._replace(
                hole_map=hole, obstacle_map=obst),
            Scan(pts, val, zero), pose, cfg)
    check(counts() == tuple(c + 1 for c in c1)
          and torch.equal(wrapped[0], holemap.update_hole_map_plain(
              hole, S, hs, pts, val, pose, cfg.hole_width, cfg.quality)),
          "a wrapped update_hole_map did not reach K7 or its count")

    ha = (hole, S, hs, pts, val, pose, cfg.hole_width, cfg.quality)
    oa = (obst, OS, osc, pts, val, pose, cfg.max_obstacle_hits)

    def plain_ms(fn) -> float:
        try:
            return graph_ms(torch, fn, REPS_PLAIN)
        except RuntimeError:
            torch.cuda.synchronize()
            return eager_ms(torch, fn, REPS_PLAIN)
    timing = {
        "hole_us": graph_ms(torch, lambda: holemap.update_hole_map(*ha),
                            REPS_KERNEL) * 1e3,
        "obstacle_us": graph_ms(torch, lambda: obstacle.update_obstacle_map(
            *oa), REPS_KERNEL) * 1e3,
        "hole_eager_us": eager_ms(torch, lambda: holemap.update_hole_map(*ha),
                                  REPS_KERNEL) * 1e3,
        "obstacle_eager_us": eager_ms(
            torch, lambda: obstacle.update_obstacle_map(*oa),
            REPS_KERNEL) * 1e3,
        "hole_plain_ms": plain_ms(lambda: holemap.update_hole_map_plain(*ha)),
        "obstacle_plain_ms": plain_ms(
            lambda: obstacle.update_obstacle_map_plain(*oa)),
        # each input read once, each output written once: the map both
        # ways, the scan's points, flags and pose (the scratch is K7's own)
        "hole_bound_us": (8 * S * S + 9 * n + 12) / PEAK_BYTES_PER_S * 1e6,
        "obstacle_bound_us": (2 * OS * OS + 9 * n + 12) / PEAK_BYTES_PER_S
        * 1e6}
    secs = time.perf_counter() - t0
    out = {"scans": n_scans, "launches": launches, "differing": diff,
           "maps_changed": changed, **timing,
           "job_scans_per_s": {"kernel": n_scans / tk, "plain": n_scans / tp},
           "seconds": secs}
    say(f"[coreslam map] K7 over a {n_scans}-scan coreslam_sim256 job ({S}-px "
        f"hole map, {OS}-px obstacle map, {n} beams, {cfg.num_candidates} "
        f"candidates, seed {CORESLAM_MAP_SEED}): poses, best sums, hole and "
        f"obstacle maps = the plain path's bit for bit {diff}; launches "
        f"{launches}; no host read; edges, a robot outside, a scan with no "
        "valid beam and refused maps as expected; hole walk + blend "
        f"{timing['hole_us']:.2f} us (eager {timing['hole_eager_us']:.1f}, "
        f"bound {timing['hole_bound_us']:.3f} by bytes, plain "
        f"{timing['hole_plain_ms']:.3f} ms), obstacle "
        f"{timing['obstacle_us']:.2f} us (eager "
        f"{timing['obstacle_eager_us']:.1f}, bound "
        f"{timing['obstacle_bound_us']:.4f}, plain "
        f"{timing['obstacle_plain_ms']:.3f} ms); the job "
        f"{n_scans / tk:.1f} scans/s through K7, {n_scans / tp:.1f} plain")
    say(f"[seconds] phase 38: {secs:.1f}")
    return out


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    import numpy as np

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slamnet_tpu_torch import replay
    from slamnet_tpu_torch.core.scan import Scan
    from slamnet_tpu_torch.graph import frontend, posegraph
    from slamnet_tpu_torch import convert, multichip
    from slamnet_tpu_torch.models import (coreslam, fleet, graph_slam, hector,
                                          particle)
    from slamnet_tpu_torch.ops import _build, correlate, fill, holemap, match
    from slamnet_tpu_torch.ops import line as line_ops
    from slamnet_tpu_torch.ops import obstacle
    from slamnet_tpu_torch.ops import rasterize as ras
    from slamnet_tpu_torch.ops import score as score_ops
    from slamnet_tpu_torch.sim import default_field, revolution_angles
    from slamnet_tpu_torch.sim import scan_revolution

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(f"[device] {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)})")
    say(f"[device] nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------------
    _, build_s, build_log = _build.library()
    # a tree from before per-source flags has none: this script can then
    # time that tree's kernels beside these in one call
    say(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} (and "
        f"{getattr(_build, 'SOURCE_FLAGS', {})}): {build_s:.1f} s "
        f"({', '.join(p.name for p in _build.sources())})")
    for line in build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            say(f"[build]   {line.strip()}")

    def launched(*keys) -> int:
        """The launches counted under the kernel ``keys``, summed."""
        counts = _build.kernel_launches()
        return sum(counts[k] for k in keys)

    cfg = replay.pallas_dense_config()
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)

    # a bootstrapped 400x400 pyramid at the start pose: 6 forced updates
    truth = torch.tensor([20.0, 20.0, 0.0], device=dev)
    angles = torch.as_tensor(revolution_angles(400), device=dev)
    fld = default_field(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def sim_scan(pose):
        r, v = scan_revolution(fld, pose, angles, 40.0, 0.02, gen)
        return Scan(torch.stack([r * torch.cos(angles), r * torch.sin(angles)],
                                -1).contiguous(), v, zero3)

    state = hector.init(cfg, truth, dev)
    for _ in range(6):
        state, _ = hector.update(state, sim_scan(truth), truth, cfg, True)
    scan = sim_scan(truth)
    maps = state.maps

    # ---- 3. K1 vs its plain version ------------------------------------------
    k1_before = launched("K1")
    k1_calls = 0
    k1_err = 0.0
    k1_bits = []
    cases = [(cfg, (0.2, -0.15, 0.04), 2e-3), (cfg, (-0.1, 0.12, -0.03), 2e-3),
             (cfg, (0.05, 0.2, 0.06), 2e-3),
             (cfg.overlay({"xy_step_clamp_px": 10.0, "gn_damping": 0.1,
                           "match_subsample": 4}), (0.15, 0.1, -0.03), 3e-3)]
    for c, off, tol in cases:
        hint = truth + torch.tensor(off, device=dev)
        ok_ = match.match(maps, scan.points, scan.valid, hint, c)
        k1_calls += 1
        op = match.match_plain(maps, scan.points, scan.valid, hint, c)
        ok_, op = ok_.cpu().numpy(), op.cpu().numpy()
        k1_bits.append(f32_bits(ok_))
        err = float(np.abs(ok_[:3] - op[:3]).max())
        k1_err = max(k1_err, err)
        check(np.isfinite(ok_).all(), f"K1 output not finite: {ok_}")
        check(err <= tol, f"K1 pose {ok_[:3]} vs plain {op[:3]} (tol {tol})")
        check(ok_[3] == op[3], f"K1 solve failures {ok_[3]} vs plain {op[3]}")
        res_k, res_p = ok_[4] / max(ok_[5], 1.0), op[4] / max(op[5], 1.0)
        check(abs(res_k - res_p) <= 0.05 * abs(res_p),
              f"K1 residual {res_k} vs plain {res_p}")
        check(np.linalg.norm(ok_[:2] - truth[:2].cpu().numpy()) < 0.08,
              f"K1 did not converge to the true pose: {ok_[:3]}")
    hint = torch.tensor([20.0, 20.0, 0.5], device=dev)
    empty = torch.zeros(400, dtype=torch.bool, device=dev)
    oe = match.match(maps, scan.points, empty, hint, cfg)
    k1_calls += 1
    check(torch.equal(oe[:3], hint), f"K1 empty scan: {oe[:3]} != hint {hint}")
    hint = truth + torch.tensor((0.2, -0.15, 0.04), device=dev)
    deep = deep_free(torch, maps)
    od = match.match(deep, scan.points, scan.valid, hint, cfg)
    k1_calls += 1
    pd = match.match_plain(deep, scan.points, scan.valid, hint, cfg)
    k1_deep_err, k1_deep = check_deep("K1 deep free cells", deep, od, pd,
                                      scan.points, scan.valid, hint, cfg,
                                      2e-3, 0.05)
    del deep
    torch.cuda.synchronize()
    check(launched("K1") - k1_before == k1_calls,
          f"K1 launch count rose by {launched('K1') - k1_before}, "
          f"expected {k1_calls}")

    def k1():
        return match.match(maps, scan.points, scan.valid, hint, cfg)

    def k1_plain():
        return match.match_plain(maps, scan.points, scan.valid, hint, cfg)

    k1_ms = graph_ms(torch, k1, REPS_KERNEL)
    k1_plain_ms = graph_ms(torch, k1_plain, REPS_PLAIN)
    k1_eager = eager_ms(torch, k1, REPS_KERNEL)
    k1_plain_eager = eager_ms(torch, k1_plain, REPS_PLAIN)
    k1_bound = bound(*match_work(maps, scan.points[None], scan.valid[None],
                                 hint[None], cfg))
    say(f"[K1] {len(cases)} matches + empty scan agree with the plain version: "
        f"max |pose err| {k1_err:.3g} (tol 2e-3/3e-3), equal solve failures, "
        f"residual within rtol 0.05; so does a map whose free cells hold -100 "
        f"and -1e4 ({k1_deep} cells read below {EXPF_OVERFLOW}; |pose err| "
        f"{k1_deep_err:.3g}); device {k1_ms:.4f} ms/match vs plain "
        f"{k1_plain_ms:.4f} ms (CUDA graph; bound {k1_bound[0]:.6f} ms by "
        f"{k1_bound[1]}); eager {k1_eager:.4f} ms vs plain "
        f"{k1_plain_eager:.4f} ms; answers' f32 bits {k1_bits}")
    slope_ms, per_it, icpt = iteration_slope(torch, lambda c: match.match(
        maps, scan.points, scan.valid, hint, c), cfg)
    say(f"[K1] iteration slope: {per_it * 1e3:.4f} us a GN iteration, "
        f"intercept {icpt * 1e3:.4f} us (device ms at estimate_iterations "
        + ", ".join(f"{it}: {t:.4f}" for it, t in zip(SLOPE_ITERS, slope_ms))
        + ")")

    # ---- 4. K2 vs its plain version ------------------------------------------
    lof, loo = cfg.log_odds_free, cfg.log_odds_occupied
    rng = np.random.default_rng(0)
    rand_maps = torch.as_tensor(rng.uniform(-8.0, 60.0, cfg.total_cells)
                                .astype(np.float32), device=dev)
    k2_err = 0.0
    k2_worst = 0.0
    k2_cells = {}
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    pose = truth + torch.tensor((0.37, -0.21, 0.3), device=dev)
    k2_scan = sim_scan(pose)
    k2_before = launched("K2")
    for name, base in (("bootstrapped", maps), ("random", rand_maps)):
        mk = base.clone()
        fill.update_maps(mk, k2_scan.points, k2_scan.valid, pose, zero3, yes,
                         cfg)
        mp = fill.update_maps_plain(base, k2_scan.points, k2_scan.valid, pose,
                                    zero3, yes, cfg)
        check(bool(torch.isfinite(mk).all()), f"K2 {name}: maps not finite")
        dk, dp = mk - base, mp - base
        for level in range(cfg.num_levels):
            off, w = cfg.level_offsets[level], cfg.level_sizes[level]
            sl = slice(off, off + w * w)
            occ_k, occ_p = dk[sl] > 0, dp[sl] > 0
            check(torch.equal(occ_k, occ_p) and torch.equal(mk[sl][occ_k],
                                                            mp[sl][occ_p]),
                  f"K2 {name} level {level}: occupied increments differ")
            diff = (mk[sl] != mp[sl])
            frac = float(diff.float().mean())
            k2_worst = max(k2_worst, frac)
            check(frac <= 1e-3, f"K2 {name} level {level}: {frac:.2%} of cells "
                  "differ (limit 0.1%)")
            if bool(diff.any()):
                gap = (mk[sl][diff] - mp[sl][diff]).abs()
                check(bool(((gap - abs(lof)).abs() <= 1e-4).all()),
                      f"K2 {name} level {level}: a cell differs by other than "
                      f"|lof|: {gap.max().item()}")
        check(bool((dk < 0).any()), f"K2 {name}: no free cell marked")
        k2_cells[name] = int((mk != base).sum())
        k2_err = max(k2_err, float((mk - mp).abs().max()))
        # do_update = 0: maps unchanged bit for bit
        mz = base.clone()
        fill.update_maps(mz, k2_scan.points, k2_scan.valid, pose, zero3, no,
                         cfg)
        check(torch.equal(mz, base), f"K2 {name}: do_update=0 changed the maps")
    torch.cuda.synchronize()
    check(launched("K2") - k2_before == 4, "K2 launch count")
    mt = maps.clone()

    def k2():
        return fill.update_maps(mt, k2_scan.points, k2_scan.valid, pose, zero3,
                                yes, cfg)

    def k2_plain():
        return fill.update_maps_plain(mt, k2_scan.points, k2_scan.valid, pose,
                                      zero3, yes, cfg)

    k2_ms = graph_ms(torch, k2, REPS_KERNEL)
    k2_plain_ms = graph_ms(torch, k2_plain, REPS_PLAIN)
    k2_eager = eager_ms(torch, k2, REPS_KERNEL)
    k2_plain_eager = eager_ms(torch, k2_plain, REPS_PLAIN)
    k2_gated_ms = graph_ms(torch, lambda: fill.update_maps(
        mt, k2_scan.points, k2_scan.valid, pose, zero3, no, cfg), REPS_KERNEL)
    k2_bound = bound(*fill_work(cfg, k2_cells["bootstrapped"],
                                k2_scan.points.shape[0], 1, 1))
    say(f"[K2] 3 levels x (bootstrapped, random) agree with the plain version: "
        f"identical occupied increments, worst level {k2_worst:.4%} cells "
        f"differ (each by |lof|={abs(lof):.4f}), do_update=0 bit-exact "
        f"({k2_cells} cells changed); "
        f"device {k2_ms:.4f} ms/scan firing (bound {k2_bound[0]:.6f} ms by "
        f"{k2_bound[1]}), {k2_gated_ms:.4f} gated, vs plain "
        f"{k2_plain_ms:.4f} ms (CUDA graph); eager {k2_eager:.4f} ms vs plain "
        f"{k2_plain_eager:.4f} ms")

    # ---- 5. the slice end to end -------------------------------------------
    t0 = time.perf_counter()
    log = replay.make_log(seed=0)
    dlog = replay.to_device(log, dev)
    n = dlog.points.shape[0] - log.bootstrap
    st0 = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog,
                           log.bootstrap, cfg)
    torch.cuda.synchronize()
    say(f"[slice] log {log.radii.shape[0]} scans x {log.radii.shape[1]} beams "
        f"+ {log.bootstrap}-scan bootstrap in {time.perf_counter() - t0:.1f} s")

    _build.reset_launches()
    stf, out = replay.replay(st0, dlog, log.bootstrap, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.kernel_launches().items() if v}
    check(launches == {"K1": n, "K2": n},
          f"launches in the {n}-scan replay: {launches}")

    poses = out.poses.cpu().numpy()
    check(poses.shape == (n, 3) and np.isfinite(poses).all(),
          f"replay poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    check(bool(torch.isfinite(stf.maps).all()), "replay maps not finite")
    ate, max_err = replay.ate_of(poses, log.traj[log.bootstrap:])
    updates = int(out.map_updated.sum())
    fails = int(out.solve_failures.sum())

    def best_replay(plain: bool) -> float:
        replay.replay(st0, dlog, log.bootstrap, cfg, plain)   # warm-up
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(TIMED_REPLAYS):
            t = time.perf_counter()
            replay.replay(st0, dlog, log.bootstrap, cfg, plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    t_kernel = best_replay(False)
    t_plain = best_replay(True)
    _, out_p = replay.replay(st0, dlog, log.bootstrap, cfg, plain=True)
    ate_p, max_p = replay.ate_of(out_p.poses.cpu().numpy(),
                                 log.traj[log.bootstrap:])
    say(f"[slice] pallas_dense replay of {n} scans: ATE {ate:.6f} m "
        f"(JAX ref {replay.JAX_REF_ATE_M:.6f}, gate +2e-4), max err "
        f"{max_err:.4f} m, map updates {updates}, solve failures {fails}, "
        f"launches {launches}; kernels {n / t_kernel:.1f} scans/s vs plain "
        f"{n / t_plain:.1f} scans/s (plain ATE {ate_p:.6f}, max {max_p:.4f})")
    check(ate <= replay.JAX_REF_ATE_M + 2e-4,
          f"ATE {ate} above JAX_REF_ATE_M + 2e-4 = {replay.JAX_REF_ATE_M + 2e-4}")
    check(max_err <= 0.05, f"max error {max_err} m above 0.05 m")

    # ---- 6. K5 vs its plain version and vs 64 K1 calls ---------------------
    fcfg = replay.sub4_pallas_dense_config()
    flog = replay.make_fleet_log(log)
    fdlog = replay.to_device(flog, dev)
    fb, boot = flog.radii.shape[1], flog.bootstrap
    cells = fcfg.total_cells
    t0 = time.perf_counter()
    fst0 = replay.fleet_bootstrap(fleet.init_fleet(fcfg, flog.traj[0], dev),
                                  fdlog, boot, fcfg)
    torch.cuda.synchronize()
    say(f"[K5] fleet log {fb} robots x {flog.radii.shape[0]} batch-scans "
        f"(phase-shifted slices); {boot}-batch-scan bootstrap in "
        f"{time.perf_counter() - t0:.1f} s")
    fmaps = fst0.maps
    fpts = fdlog.points[boot]
    fval = fdlog.valid[boot].clone()
    empty_inst = 5
    fval[empty_inst] = False
    ftruth = fdlog.traj[boot]
    k5_cases = [(fcfg, (0.2, -0.15, 0.04), 2e-3),
                (fcfg, (-0.1, 0.12, -0.03), 2e-3),
                (fcfg, (0.05, 0.2, 0.06), 2e-3),
                (fcfg.overlay({"gn_damping": 0.1}), (0.15, 0.1, -0.03), 3e-3)]
    k5_err = 0.0
    k5_outs = []
    for c, off, tol in k5_cases:
        hints = (ftruth + torch.tensor(off, device=dev)).contiguous()
        ok_ = match.match_batch(fmaps, fpts, fval, hints, c)
        op = match.match_batch_plain(fmaps, fpts, fval, hints, c)
        k5_outs.append((c, hints, ok_, op, tol))
        for b in range(fb):       # each instance against a K1 call of its own
            o1 = match.match(fmaps[b * cells:(b + 1) * cells], fpts[b],
                             fval[b], hints[b], c)
            check(torch.equal(o1, ok_[b]),
                  f"K5 instance {b} {ok_[b].tolist()} != K1 {o1.tolist()}")
        k, pl = ok_.cpu().numpy(), op.cpu().numpy()
        check(np.isfinite(k).all(), "K5 output not finite")
        err = float(np.abs(k[:, :3] - pl[:, :3]).max())
        k5_err = max(k5_err, err)
        check(err <= tol, f"K5 pose vs plain: max diff {err} (tol {tol})")
        check((k[:, 3] == pl[:, 3]).all(),
              f"K5 solve failures {k[:, 3]} vs plain {pl[:, 3]}")
        res_k = k[:, 4] / np.maximum(k[:, 5], 1.0)
        res_p = pl[:, 4] / np.maximum(pl[:, 5], 1.0)
        check((np.abs(res_k - res_p) <= 0.05 * np.abs(res_p)).all(),
              f"K5 residual {res_k} vs plain {res_p}")
        check(torch.equal(ok_[empty_inst, :3], hints[empty_inst]),
              f"K5 empty instance {ok_[empty_inst, :3]} != hint")
        dist = np.linalg.norm(k[:, :2] - ftruth[:, :2].cpu().numpy(), axis=1)
        check(float(np.median(dist)) < 0.05,
              f"K5 did not converge: median distance to truth {np.median(dist)}")
    fhints = k5_outs[0][1]
    deep = deep_free(torch, fmaps)
    k5_deep_err, k5_deep = check_deep(
        "K5 deep free cells", deep,
        match.match_batch(deep, fpts, fval, fhints, fcfg),
        match.match_batch_plain(deep, fpts, fval, fhints, fcfg), fpts, fval,
        fhints, fcfg, 2e-3, 0.05)
    del deep

    def k5():
        return match.match_batch(fmaps, fpts, fval, fhints, fcfg)

    def k5_plain():
        return match.match_batch_plain(fmaps, fpts, fval, fhints, fcfg)

    k5_ms = graph_ms(torch, k5, REPS_KERNEL)
    k5_bound = bound(*match_work(fmaps, fpts, fval, fhints, fcfg))
    k5_plain_ms = graph_ms(torch, k5_plain, REPS_PLAIN)
    k5_eager = eager_ms(torch, k5, REPS_KERNEL)
    k5_plain_eager = eager_ms(torch, k5_plain, REPS_PLAIN)
    say(f"[K5] {len(k5_cases)} x {fb} matches (robot {empty_inst} with no "
        f"valid beam returns its hint) agree with the plain version: max "
        f"|pose err| {k5_err:.3g} (tol 2e-3/3e-3), equal solve failures, "
        f"residual within rtol 0.05, and on maps whose free cells hold -100 "
        f"and -1e4 ({k5_deep} cells read below {EXPF_OVERFLOW}; |pose err| "
        f"{k5_deep_err:.3g}); equal bit for bit to {fb} K1 calls; "
        f"device {k5_ms:.4f} ms/batch vs plain {k5_plain_ms:.4f} ms (CUDA "
        f"graph; one K1 {k1_ms:.4f} ms); eager {k5_eager:.4f} ms vs plain "
        f"{k5_plain_eager:.4f} ms")

    # ---- 7. K6 vs K5 -------------------------------------------------------
    k6_ms = {}
    k6_err = 0.0
    k6_before = launched("K6")
    for g in G_PACKS:
        for c, hints, ok_, op, tol in k5_outs:
            o6 = match.match_packed(fmaps, fpts, fval, hints, c, g)
            check(torch.equal(o6, ok_), f"K6 g_pack={g} differs from K5")
            err = float((o6[:, :3] - op[:, :3]).abs().max())
            k6_err = max(k6_err, err)
            check(err <= tol, f"K6 g_pack={g} pose vs plain: max diff {err} "
                  f"(tol {tol})")
            check(torch.equal(o6[:, 3], op[:, 3]),
                  f"K6 g_pack={g} solve failures differ from the plain version")
    torch.cuda.synchronize()
    k6_calls = len(G_PACKS) * len(k5_outs)
    check(launched("K6") - k6_before == k6_calls,
          f"K6 launch count rose by {launched('K6') - k6_before}, "
          f"expected {k6_calls}")
    for g in G_PACKS:
        k6_ms[g] = graph_ms(torch, lambda g=g: match.match_packed(
            fmaps, fpts, fval, fhints, fcfg, g), REPS_KERNEL)
    say(f"[K6] g_pack {G_PACKS} x {len(k5_outs)} cases equal K5 bit for bit "
        f"({k6_calls} launches); max |pose err| vs plain {k6_err:.3g}; "
        f"device ms/batch (CUDA graph) " + ", ".join(
            f"g{g} {t:.4f}" for g, t in k6_ms.items())
        + f" vs K5 {k5_ms:.4f} and plain {k5_plain_ms:.4f}")

    # ---- 8. batched K2 vs its plain version --------------------------------
    def fill_batch_case(what, base, pts, val, poses, fire_np, c):
        """One batched K2 call against its plain version; returns the worst
        instance-level fraction of differing cells, the max |error| and how
        many cells the call changed."""
        b = pts.shape[0]
        fire = torch.as_tensor(fire_np, device=dev)
        zeros = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        mk = base.clone()
        fill.update_maps_batch(mk, pts, val, poses, zeros, fire, c)
        mp = fill.update_maps_batch_plain(base, pts, val, poses, zeros, fire, c)
        check(bool(torch.isfinite(mk).all()), f"{what}: maps not finite")
        b2 = base.view(b, c.total_cells)
        mk2, mp2 = mk.view(b, c.total_cells), mp.view(b, c.total_cells)
        check(torch.equal(mk2[~fire], b2[~fire]),
              f"{what}: a non-firing robot's maps changed")
        worst = 0.0
        for level in range(c.num_levels):
            off, w = c.level_offsets[level], c.level_sizes[level]
            sl = slice(off, off + w * w)
            k_, p_, b_ = mk2[fire, sl], mp2[fire, sl], b2[fire, sl]
            occ_k, occ_p = k_ - b_ > 0, p_ - b_ > 0
            check(torch.equal(occ_k, occ_p)
                  and torch.equal(k_[occ_k], p_[occ_p]),
                  f"{what} level {level}: occupied increments differ")
            diff = k_ != p_
            if diff.numel():
                frac = float(diff.float().mean(dim=1).max())
                worst = max(worst, frac)
                check(frac <= 1e-3, f"{what} level {level}: {frac:.2%} of "
                      "an instance's cells differ (limit 0.1%)")
            if bool(diff.any()):
                gap = (k_[diff] - p_[diff]).abs()
                check(bool(((gap - abs(lof)).abs() <= 1e-4).all()),
                      f"{what} level {level}: a cell differs by other "
                      f"than |lof|: {gap.max().item()}")
            if bool(fire.any()):
                check(bool((k_ - b_ < 0).any(dim=1).all()),
                      f"{what} level {level}: a firing robot marked no "
                      "free cell")
        return worst, float((mk - mp).abs().max()), int((mk != base).sum())

    def fire_masks(b, seed):
        sparse = np.random.default_rng(seed).random(b) < 1.0 / 18.0
        sparse[0], sparse[1] = True, False
        return {"all": np.ones(b, bool), "none": np.zeros(b, bool),
                "1-in-18": sparse}

    rng = np.random.default_rng(1)
    frand = torch.as_tensor(rng.uniform(-8.0, 60.0, fb * cells)
                            .astype(np.float32), device=dev)
    sparse = rng.random(fb) < 1.0 / 18.0
    sparse[0], sparse[1] = True, False
    masks = {"all": np.ones(fb, bool), "none": np.zeros(fb, bool),
             "1-in-18": sparse}
    fzero = torch.zeros((fb, 3), dtype=torch.float32, device=dev)
    fposes = ftruth + torch.tensor((0.05, -0.03, 0.02), device=dev)
    fpts_all, fval_all = fdlog.points[boot], fdlog.valid[boot]
    kb_err = 0.0
    kb_worst = 0.0
    kb_cells = {}
    kb_before = launched("K2_batch")
    for name, base in (("fleet", fmaps), ("random", frand)):
        for mname, m in masks.items():
            worst, err, changed = fill_batch_case(
                f"K2 batch {name}/{mname}", base, fpts_all, fval_all, fposes,
                m, fcfg)
            kb_worst, kb_err = max(kb_worst, worst), max(kb_err, err)
            if name == "fleet":                     # the timed inputs
                kb_cells[mname] = changed
    # B = 300: the fleet's robots repeated (more work items than blocks)
    big = 300
    rep = torch.arange(big, device=dev) % fb
    big_args = (fpts_all[rep].contiguous(), fval_all[rep].contiguous(),
                fposes[rep].contiguous())
    big_maps = fmaps.view(fb, cells)[rep].reshape(-1)
    big_masks = fire_masks(big, 3)
    for mname, m in big_masks.items():
        worst, err, _ = fill_batch_case(f"K2 batch B={big}/{mname}", big_maps,
                                        *big_args, m, fcfg)
        kb_worst, kb_err = max(kb_worst, worst), max(kb_err, err)
    # B = 5000 on a 64/32/16-px pyramid: more robots than a block ranks at
    # once, so every block walks the fire flags chunk by chunk
    huge = 5000
    hcfg = fcfg.overlay({"map_size": 64, "map_resolution": 0.8})
    hrep = torch.arange(huge, device=dev) % fb
    huge_maps = torch.as_tensor(rng.uniform(-8.0, 60.0, huge * hcfg.total_cells)
                                .astype(np.float32), device=dev)
    for mname, m in fire_masks(huge, 4).items():
        worst, err, _ = fill_batch_case(
            f"K2 batch B={huge}/{mname}", huge_maps,
            fpts_all[hrep].contiguous(), fval_all[hrep].contiguous(),
            fposes[hrep].contiguous(), m, hcfg)
        kb_worst, kb_err = max(kb_worst, worst), max(kb_err, err)
    torch.cuda.synchronize()
    check(launched("K2_batch") - kb_before == 12,
          "batched K2 launch count")
    fmt = fmaps.clone()
    kb_ms = {}
    kb_plain_ms = {}
    for mname in ("1-in-18", "all", "none"):
        fire = torch.as_tensor(masks[mname], device=dev)
        kb_ms[mname] = graph_ms(torch, lambda fire=fire: fill.update_maps_batch(
            fmt, fpts_all, fval_all, fposes, fzero, fire, fcfg), REPS_KERNEL)
        kb_plain_ms[mname] = graph_ms(
            torch, lambda fire=fire: fill.update_maps_batch_plain(
                fmt, fpts_all, fval_all, fposes, fzero, fire, fcfg), REPS_PLAIN)
    bmt = big_maps.clone()
    bzero = torch.zeros((big, 3), dtype=torch.float32, device=dev)
    big_ms = {}
    for mname in ("1-in-18", "all"):
        fire = torch.as_tensor(big_masks[mname], device=dev)
        big_ms[mname] = graph_ms(torch, lambda fire=fire: fill.update_maps_batch(
            bmt, *big_args, bzero, fire, fcfg), REPS_KERNEL)
    del bmt, big_maps, huge_maps
    kb_bound = {m: bound(*fill_work(fcfg, kb_cells[m], fpts_all.shape[1],
                                    int(masks[m].sum()), fb))
                for m in ("1-in-18", "all")}
    say(f"[K2 batch] {fb} robots x 3 levels x (fleet, random) x fire masks "
        f"{list(masks)} ({int(sparse.sum())} of {fb} fire in 1-in-18), "
        f"{big} robots and {huge} robots ({hcfg.level_sizes} px) x the same "
        f"masks agree with the plain version: identical occupied increments, "
        f"worst instance-level {kb_worst:.4%} cells differ (each by |lof|), "
        f"non-firing robots bit-exact (fleet maps: {kb_cells} "
        f"cells changed); device ms/batch-scan "
        f"(CUDA graph) 1-in-18 {kb_ms['1-in-18']:.4f} vs plain "
        f"{kb_plain_ms['1-in-18']:.4f} (bound {kb_bound['1-in-18'][0]:.6f}), "
        f"all {kb_ms['all']:.4f} vs plain {kb_plain_ms['all']:.4f} (bound "
        f"{kb_bound['all'][0]:.6f}), none {kb_ms['none']:.4f}; {big} robots "
        f"1-in-18 ({int(big_masks['1-in-18'].sum())} fire) "
        f"{big_ms['1-in-18']:.4f}, all {big_ms['all']:.4f} (single K2 "
        f"{k2_ms:.4f} ms)")

    # ---- 9. the fleet end to end -------------------------------------------
    _build.reset_launches()
    fst = replay.fleet_bootstrap(fleet.init_fleet(fcfg, flog.traj[0], dev),
                                 fdlog, boot, fcfg)
    fstf, fout = fleet.replay_fleet(fst, fdlog.points[boot:],
                                    fdlog.valid[boot:], fcfg)
    torch.cuda.synchronize()
    flaunch = _build.kernel_launches()
    nb = fdlog.points.shape[0]
    want = dict.fromkeys(flaunch, 0)
    want.update(K5=nb, K2_batch=nb)
    check(flaunch == want, f"launches in the fleet flow: {flaunch}, want {want}")
    fposes_np = fout.cpu().numpy()
    nt = nb - boot
    check(fposes_np.shape == (nt, fb, 3) and np.isfinite(fposes_np).all(),
          f"fleet poses: shape {fposes_np.shape}, finite "
          f"{np.isfinite(fposes_np).all()}")
    check(bool(torch.isfinite(fstf.maps).all()), "fleet maps not finite")
    fate, fmax, fmed = replay.fleet_ate_of(fposes_np, flog.traj[boot:])

    def best_fleet(plain: bool, reps: int) -> float:
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            fleet.replay_fleet(fst, fdlog.points[boot:], fdlog.valid[boot:],
                               fcfg, plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    fleet.replay_fleet(fst, fdlog.points[boot:], fdlog.valid[boot:], fcfg)
    torch.cuda.synchronize()                                    # warm-up
    tf_kernel = best_fleet(False, TIMED_REPLAYS)
    tf_plain = best_fleet(True, 1)
    _, pl_out = fleet.replay_fleet(fst, fdlog.points[boot:], fdlog.valid[boot:],
                                   fcfg, plain=True)
    pate, pmax, pmed = replay.fleet_ate_of(pl_out.cpu().numpy(),
                                           flog.traj[boot:])
    iscans = nt * fb
    say(f"[fleet] sub4_pallas_dense, {fb} robots x ({boot} + {nt}) "
        f"batch-scans: RMS ATE {fate:.6f} m (JAX ref "
        f"{replay.FLEET_JAX_REF_ATE_M:.6f}, gate +5e-4), max err {fmax:.4f} m "
        f"(ref {replay.FLEET_JAX_REF_MAX_M:.4f}, gate +0.01), median "
        f"instance ATE {fmed:.6f} m (ref {replay.FLEET_JAX_REF_MEDIAN_M:.6f}, "
        f"gate +2e-4); launches {flaunch}; "
        f"kernels {iscans / tf_kernel:.1f} instance-scans/s (best of "
        f"{TIMED_REPLAYS}) vs plain {iscans / tf_plain:.1f} (best of 1; plain "
        f"ATE {pate:.6f}, max {pmax:.4f}, median {pmed:.6f})")
    check(fate <= replay.FLEET_JAX_REF_ATE_M + 5e-4,
          f"fleet ATE {fate} above FLEET_JAX_REF_ATE_M + 5e-4")
    check(fmax <= replay.FLEET_JAX_REF_MAX_M + 0.01,
          f"fleet max error {fmax} above FLEET_JAX_REF_MAX_M + 0.01")
    check(fmed <= replay.FLEET_JAX_REF_MEDIAN_M + 2e-4,
          f"fleet median instance ATE {fmed} above FLEET_JAX_REF_MEDIAN_M + 2e-4")

    # ---- 10. K3 vs its plain version; the batched K3 vs 64 K3 calls --------
    xcfg = replay.fixed_config()
    xstate = hector.init(xcfg, truth, dev)
    for _ in range(6):
        xstate, _ = hector.update(xstate, sim_scan(truth), truth, xcfg, True)
    xscan = sim_scan(truth)
    xmaps = xstate.maps
    k3_before = launched("K3")
    k3_calls = 0
    k3_err = k3_res = k3_gap = k3_res_gap = 0.0
    k3_bits = []
    k3_cases = [(xcfg, (0.2, -0.15, 0.04)), (xcfg, (-0.1, 0.12, -0.03)),
                (xcfg, (0.05, 0.2, 0.06)),
                (xcfg.overlay({"xy_step_clamp_px": 10.0, "gn_damping": 0.1,
                               "match_subsample": 4}), (0.15, 0.1, -0.03))]
    for i, (c, off) in enumerate(k3_cases):
        hint = truth + torch.tensor(off, device=dev)
        ok_ = match.match(xmaps, xscan.points, xscan.valid, hint, c)
        k3_calls += 1
        op = match.match_plain(xmaps, xscan.points, xscan.valid, hint, c)
        # K1 on the same input: what K3 would return through the bf16 table
        o1 = match.match(xmaps, xscan.points, xscan.valid, hint,
                         c.overlay({"matcher_mode": "pallas"}))
        ok_, op, o1 = ok_.cpu().numpy(), op.cpu().numpy(), o1.cpu().numpy()
        err, res, gap, res_gap = k3_readings(ok_[None], op[None], o1[None])
        k3_bits.append(f32_bits(ok_))
        k3_err, k3_res = max(k3_err, err), max(k3_res, res)
        k3_gap, k3_res_gap = max(k3_gap, gap), max(k3_res_gap, res_gap)
        say(f"[K3] case {i}: vs plain |pose err| {err:.3g}, residual rel err "
            f"{res:.3g}; vs K1 (bf16 table) |pose diff| {gap:.3g}, residual "
            f"rel diff {res_gap:.3g}; f32 bits {k3_bits[-1]}")
        check(np.isfinite(ok_).all(), f"K3 output not finite: {ok_}")
        check(err <= K3_POSE_TOL,
              f"K3 pose {ok_[:3]} vs plain {op[:3]} (tol {K3_POSE_TOL})")
        check(res <= K3_RESID_RTOL, f"K3 residual rel err {res} vs plain "
              f"(rtol {K3_RESID_RTOL})")
        check(ok_[3] == op[3], f"K3 solve failures {ok_[3]} vs plain {op[3]}")
        check(np.linalg.norm(ok_[:2] - truth[:2].cpu().numpy()) < 0.08,
              f"K3 did not converge to the true pose: {ok_[:3]}")
    # a K3 that read the bf16 table would give K1's answers: some case must
    # put them outside the bounds K3 is held to
    check(k3_res_gap > K3_RESID_RTOL,
          f"K1's residuals within rtol {K3_RESID_RTOL} of K3's in every case "
          f"(max {k3_res_gap}): the check cannot tell the f32 table from bf16")
    hint = torch.tensor([20.0, 20.0, 0.5], device=dev)
    oe = match.match(xmaps, xscan.points, empty, hint, xcfg)
    k3_calls += 1
    check(torch.equal(oe[:3], hint), f"K3 empty scan: {oe[:3]} != hint {hint}")
    # valid beams only between the subsampled ones: the XLA modes' rule (the
    # full scan has valid beams) gives the GN estimate with its heading
    # wrapped; K1's rule (no valid matcher beam) gives the hint
    between = xscan.valid & (torch.arange(400, device=dev) % 4 != 0)
    hint4 = torch.tensor([20.0, 20.0, 4.0], device=dev)
    x4 = xcfg.overlay({"match_subsample": 4})
    o4 = match.match(xmaps, xscan.points, between, hint4, x4)
    k3_calls += 1
    p4 = match.match_plain(xmaps, xscan.points, between, hint4, x4)
    check(torch.equal(o4, p4), f"K3 between-beams scan {o4.tolist()} != plain "
          f"{p4.tolist()}")
    check(abs(float(o4[2]) - (4.0 - 2 * np.pi)) < 1e-5
          and float((o4[:2] - hint4[:2]).abs().max()) < 1e-5
          and float(o4[3]) == 15.0,
          f"K3 between-beams scan: {o4.tolist()}, want the hint with heading "
          "4 - 2 pi and 15 failed solves")
    o4k1 = match.match(xmaps, xscan.points, between, hint4,
                       x4.overlay({"matcher_mode": "pallas"}))
    check(torch.equal(o4k1[:3], hint4),
          f"K1 between-beams scan {o4k1[:3].tolist()} != hint")
    hint = truth + torch.tensor((0.2, -0.15, 0.04), device=dev)
    deep = deep_free(torch, xmaps)
    od = match.match(deep, xscan.points, xscan.valid, hint, xcfg)
    k3_calls += 1
    k3_deep_err, k3_deep = check_deep(
        "K3 deep free cells", deep, od,
        match.match_plain(deep, xscan.points, xscan.valid, hint, xcfg),
        xscan.points, xscan.valid, hint, xcfg, K3_POSE_TOL, K3_RESID_RTOL)
    del deep
    torch.cuda.synchronize()
    check(launched("K3") - k3_before == k3_calls,
          f"K3 launch count rose by {launched('K3') - k3_before}, "
          f"expected {k3_calls}")

    def k3():
        return match.match(xmaps, xscan.points, xscan.valid, hint, xcfg)

    def k3_plain():
        return match.match_plain(xmaps, xscan.points, xscan.valid, hint, xcfg)

    k3_ms = graph_ms(torch, k3, REPS_KERNEL)
    k3_bound = bound(*match_work(xmaps, xscan.points[None], xscan.valid[None],
                                 hint[None], xcfg))
    k3_plain_ms = graph_ms(torch, k3_plain, REPS_PLAIN)
    k3_eager = eager_ms(torch, k3, REPS_KERNEL)
    k3_plain_eager = eager_ms(torch, k3_plain, REPS_PLAIN)

    scfg = replay.sub1_config()
    t0 = time.perf_counter()
    sst0 = replay.fleet_bootstrap(fleet.init_fleet(scfg, flog.traj[0], dev),
                                  fdlog, boot, scfg)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    smaps = sst0.maps
    k3b_err = k3b_res = 0.0
    k3b_before = launched("K3_batch")
    for c, off in ((scfg, (0.2, -0.15, 0.04)), (scfg, (-0.1, 0.12, -0.03)),
                   (scfg.overlay({"gn_damping": 0.1}), (0.15, 0.1, -0.03))):
        hints = (ftruth + torch.tensor(off, device=dev)).contiguous()
        ok_ = match.match_batch(smaps, fpts, fval, hints, c)
        op = match.match_batch_plain(smaps, fpts, fval, hints, c)
        o5 = match.match_batch(smaps, fpts, fval, hints,
                               c.overlay({"matcher_mode": "pallas"}))   # K5
        for b in range(fb):       # each instance against a K3 call of its own
            o1 = match.match(smaps[b * cells:(b + 1) * cells], fpts[b],
                             fval[b], hints[b], c)
            check(torch.equal(o1, ok_[b]),
                  f"batched K3 instance {b} {ok_[b].tolist()} != K3 "
                  f"{o1.tolist()}")
        k, pl = ok_.cpu().numpy(), op.cpu().numpy()
        err, res, gap, res_gap = k3_readings(k, pl, o5.cpu().numpy())
        k3b_err, k3b_res = max(k3b_err, err), max(k3b_res, res)
        say(f"[K3 batch] {off}: vs plain max |pose err| {err:.3g}, residual "
            f"rel err {res:.3g}; vs K5 (bf16 table) max |pose diff| {gap:.3g}, "
            f"residual rel diff {res_gap:.3g}")
        check(np.isfinite(k).all(), "batched K3 output not finite")
        check(err <= K3_POSE_TOL,
              f"batched K3 pose vs plain: max diff {err} (tol {K3_POSE_TOL})")
        check(res <= K3_RESID_RTOL, f"batched K3 residual rel err {res} vs "
              f"plain (rtol {K3_RESID_RTOL})")
        check(res_gap > K3_RESID_RTOL,
              f"K5's residuals within rtol {K3_RESID_RTOL} of the batched K3's "
              f"on every robot (max {res_gap}): the check cannot tell the f32 "
              "table from bf16")
        check((k[:, 3] == pl[:, 3]).all(),
              f"batched K3 solve failures {k[:, 3]} vs plain {pl[:, 3]}")
        check(torch.equal(ok_[empty_inst, :3], hints[empty_inst]),
              f"batched K3 empty instance {ok_[empty_inst, :3]} != hint")
        dist = np.linalg.norm(k[:, :2] - ftruth[:, :2].cpu().numpy(), axis=1)
        check(float(np.median(dist)) < 0.05, "batched K3 did not converge: "
              f"median distance to truth {np.median(dist)}")
    shints = (ftruth + torch.tensor((0.2, -0.15, 0.04), device=dev)).contiguous()
    deep = deep_free(torch, smaps)
    k3b_deep_err, k3b_deep = check_deep(
        "batched K3 deep free cells", deep,
        match.match_batch(deep, fpts, fval, shints, scfg),
        match.match_batch_plain(deep, fpts, fval, shints, scfg), fpts, fval,
        shints, scfg, K3_POSE_TOL, K3_RESID_RTOL)
    del deep
    torch.cuda.synchronize()
    check(launched("K3_batch") - k3b_before == 4,
          "batched K3 launch count")

    def k3b():
        return match.match_batch(smaps, fpts, fval, shints, scfg)

    def k3b_plain():
        return match.match_batch_plain(smaps, fpts, fval, shints, scfg)

    k3b_ms = graph_ms(torch, k3b, REPS_KERNEL)
    k3b_bound = bound(*match_work(smaps, fpts, fval, shints, scfg))
    k3b_plain_ms = graph_ms(torch, k3b_plain, REPS_PLAIN)
    say(f"[K3] {len(k3_cases)} matches + empty scan + between-beams scan "
        f"agree with the plain version: max |pose err| {k3_err:.3g} (tol "
        f"{K3_POSE_TOL}), equal solve failures, max residual rel err "
        f"{k3_res:.3g} (rtol {K3_RESID_RTOL}); K1's bf16-table answers "
        f"differ by up to {k3_gap:.3g} in pose and {k3_res_gap:.3g} in "
        f"residual; the "
        f"between-beams scan (subsample 4, heading 4.0) gives "
        f"{[round(float(x), 6) for x in o4[:3]]}, the plain version's bit for "
        f"bit, and K1's rule the hint; a map whose free cells hold -100 and "
        f"-1e4 within the same bounds ({k3_deep} cells read below "
        f"{EXPF_OVERFLOW}; |pose err| {k3_deep_err:.3g}); device "
        f"{k3_ms:.4f} ms/match vs plain "
        f"{k3_plain_ms:.4f} ms (CUDA graph; K1 {k1_ms:.4f}); eager "
        f"{k3_eager:.4f} ms vs plain {k3_plain_eager:.4f} ms")
    say(f"[K3 batch] sub1 fleet of {fb} robots bootstrapped ({boot} "
        f"batch-scans, {boot_s:.1f} s); 3 x {fb} matches (robot {empty_inst} "
        f"with no valid beam returns its hint) equal {fb} K3 calls bit for "
        f"bit and the plain version within max |pose err| {k3b_err:.3g} "
        f"(tol {K3_POSE_TOL}) and residual rel err {k3b_res:.3g} (rtol "
        f"{K3_RESID_RTOL}), K5's residuals outside the bound in each case; "
        f"maps whose free cells hold -100 and -1e4 within the same bounds "
        f"({k3b_deep} cells read below {EXPF_OVERFLOW}; |pose err| "
        f"{k3b_deep_err:.3g}); "
        f"device {k3b_ms:.4f} ms/batch vs plain {k3b_plain_ms:.4f} ms (CUDA "
        f"graph; K5 {k5_ms:.4f})")

    # ---- 11. K4 and the batched K4 vs their plain versions ----------------
    # no global scratch: the map updates take none, the state carries none
    for f in (line_ops.update_maps_line, line_ops.update_maps_line_batch,
              fill.update_maps, fill.update_maps_batch):
        check("marks" not in inspect.signature(f).parameters,
              f"{f.__name__} takes a marks scratch")
    check("marks" not in hector.HectorState._fields,
          "HectorState carries a marks scratch")
    k4_before = (launched("K4"), launched("K4_batch"))
    k4_err = {"single": 0.0, "batch": 0.0}

    def line_case(what, base, pts, val, pose_, gate, c):
        """One K4 call against its plain version, bit for bit, its inputs
        other than the maps untouched; returns the kernel's maps."""
        ins = [t.clone() for t in (pts, val, pose_, gate)]
        mk = base.clone()
        line_ops.update_maps_line(mk, pts, val, pose_, zero3, gate, c)
        mp = line_ops.update_maps_line_plain(base, pts, val, pose_, zero3,
                                             gate, c)
        check(all(torch.equal(a, t) for a, t in zip(ins, (pts, val, pose_,
                                                          gate))),
              f"{what}: an input other than the maps changed")
        check(bool(torch.isfinite(mk).all()), f"{what}: maps not finite")
        for level in range(c.num_levels):
            off, w = c.level_offsets[level], c.level_sizes[level]
            sl = slice(off, off + w * w)
            check(torch.equal(mk[sl], mp[sl]),
                  f"{what} level {level}: {int((mk[sl] != mp[sl]).sum())} "
                  "cells differ from the plain version")
        k4_err["single"] = max(k4_err["single"], float((mk - mp).abs().max()))
        return mk

    k4_cells = {}
    for name, base in (("fixed-mode", xmaps), ("random", rand_maps)):
        mk = line_case(f"K4 {name}", base, k2_scan.points, k2_scan.valid,
                       pose, yes, xcfg)
        for level in range(xcfg.num_levels):
            off, w = xcfg.level_offsets[level], xcfg.level_sizes[level]
            d = mk[off:off + w * w] - base[off:off + w * w]
            check(bool((d < 0).any()) and bool((d > 0).any()),
                  f"K4 {name} level {level}: no free or no occupied cell")
        k4_cells[name] = int((mk != base).sum())
        mz = line_case(f"K4 {name} gated", base, k2_scan.points,
                       k2_scan.valid, pose, no, xcfg)
        check(torch.equal(mz, base), f"K4 {name}: do_update=0 changed the maps")
    # beams along the axes and the tiles' edges: the robot on a tile corner
    # and on a tile's last column of the 400-px level (0.1 m cells);
    # endpoints on tiles' first and last columns and rows, one cell away,
    # and along the diagonals
    edge_rng = np.random.default_rng(5)
    tile = line_ops.TILE
    edge_px = [k * tile + e for k in range(2, 8) for e in (-1, 0)]
    ry = 4 * tile
    for rx in (ry, ry + tile - 1):
        ends = [(rx + sx * d, ry + sy * d)
                for d in (1, 2, tile - 1, tile, tile + 1, 2 * tile, 150)
                for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1),
                               (-1, 1), (1, -1), (-1, -1))]
        ends += [(e, int(edge_rng.integers(40, 360))) for e in edge_px]
        ends += [(int(edge_rng.integers(40, 360)), e) for e in edge_px]
        robot = torch.tensor([rx / 10.0, ry / 10.0, 0.0], device=dev)
        pts_e = torch.tensor([(x / 10.0 - rx / 10.0, y / 10.0 - ry / 10.0)
                              for x, y in ends], dtype=torch.float32,
                             device=dev)
        val_e = torch.ones(len(ends), dtype=torch.bool, device=dev)
        what = f"K4 edges from ({rx}, {ry})"
        mk = line_case(what, rand_maps, pts_e, val_e, robot, yes, xcfg)
        k4_cells[f"edges {rx}"] = int((mk != rand_maps).sum())
        check(k4_cells[f"edges {rx}"] > 2000,
              f"{what}: only {k4_cells[f'edges {rx}']} cells changed")
    # a robot outside the map: no beam counts, on any level
    outside = torch.tensor([-5.0, 20.0, 0.3], device=dev)
    mo = line_case("K4 robot outside the map", rand_maps, k2_scan.points,
                   k2_scan.valid, outside, yes, xcfg)
    check(torch.equal(mo, rand_maps), "K4: a robot outside the map changed it")
    k4_single = 7

    def line_batch_case(what, base, pts, val, poses, fire_np, c):
        """One batched K4 call against its plain version, bit for bit, its
        inputs other than the maps untouched, non-firing robots untouched;
        returns the kernel's and the base's maps f32[B, C] and how many
        cells changed."""
        fire = torch.as_tensor(fire_np, device=dev)
        b = pts.shape[0]
        zeros = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        ins = [t.clone() for t in (pts, val, poses, fire)]
        mk = base.clone()
        line_ops.update_maps_line_batch(mk, pts, val, poses, zeros, fire, c)
        mp = line_ops.update_maps_line_batch_plain(base, pts, val, poses,
                                                   zeros, fire, c)
        check(all(torch.equal(a, t) for a, t in zip(ins, (pts, val, poses,
                                                          fire))),
              f"{what}: an input other than the maps changed")
        check(torch.equal(mk, mp), f"{what}: "
              f"{int((mk != mp).sum())} cells differ from the plain version")
        k4_err["batch"] = max(k4_err["batch"], float((mk - mp).abs().max()))
        mk2, b2 = mk.view(b, c.total_cells), base.view(b, c.total_cells)
        check(torch.equal(mk2[~fire], b2[~fire]),
              f"{what}: a non-firing robot's maps changed")
        return mk2, b2, int((mk != base).sum())

    srand = torch.as_tensor(np.random.default_rng(2).uniform(
        -8.0, 60.0, fb * cells).astype(np.float32), device=dev)
    k4b_cells = {}
    for name, base in (("fleet", smaps), ("random", srand)):
        for mname, m in masks.items():
            mk2, b2, changed = line_batch_case(
                f"K4 batch {name}/{mname}", base, fpts_all, fval_all, fposes,
                m, scfg)
            fire = torch.as_tensor(m, device=dev)
            if bool(fire.any()):
                check(bool((mk2[fire] != b2[fire]).any(dim=1).all()),
                      f"K4 batch {name}/{mname}: a firing robot's maps did "
                      "not change")
            if name == "fleet":                     # the timed inputs
                k4b_cells[mname] = changed
    del srand
    # robot 0 outside the map, every robot firing
    out_poses = fposes.clone()
    out_poses[0] = outside
    mk2, b2, _ = line_batch_case("K4 batch, robot 0 outside the map", smaps,
                                 fpts_all, fval_all, out_poses,
                                 masks["all"], scfg)
    check(torch.equal(mk2[0], b2[0])
          and bool((mk2[1:] != b2[1:]).any(dim=1).all()),
          "K4 batch: robot 0 outside the map changed, or another did not")
    # B = 300: the fleet's robots repeated (more work items than blocks)
    big_line = (fpts_all[rep].contiguous(), fval_all[rep].contiguous(),
                fposes[rep].contiguous())
    big_smaps = smaps.view(fb, cells)[rep].reshape(-1)
    for mname, m in big_masks.items():
        line_batch_case(f"K4 batch B={big}/{mname}", big_smaps, *big_line, m,
                        scfg)
    del big_smaps
    # B = 5000 on a 64/32/16-px pyramid: more robots than a block ranks at
    # once, so every block walks the fire flags chunk by chunk
    hscfg = scfg.overlay({"map_size": 64, "map_resolution": 0.8})
    hs_maps = torch.as_tensor(np.random.default_rng(6).uniform(
        -8.0, 60.0, huge * hscfg.total_cells).astype(np.float32), device=dev)
    for mname, m in fire_masks(huge, 4).items():
        line_batch_case(f"K4 batch B={huge}/{mname}", hs_maps,
                        fpts_all[hrep].contiguous(),
                        fval_all[hrep].contiguous(),
                        fposes[hrep].contiguous(), m, hscfg)
    del hs_maps
    torch.cuda.synchronize()
    k4_calls = (launched("K4") - k4_before[0],
                launched("K4_batch") - k4_before[1])
    check(k4_calls == (k4_single, 13),
          f"K4 launch counts {k4_calls}, want ({k4_single}, 13)")
    mt = xmaps.clone()
    k4_ms, k4_plain_ms = {}, {}
    for gname, gate in (("fire", yes), ("gated", no)):
        k4_ms[gname] = graph_ms(torch, lambda gate=gate: line_ops.update_maps_line(
            mt, k2_scan.points, k2_scan.valid, pose, zero3, gate, xcfg),
            REPS_KERNEL)
        k4_plain_ms[gname] = graph_ms(
            torch, lambda gate=gate: line_ops.update_maps_line_plain(
                mt, k2_scan.points, k2_scan.valid, pose, zero3, gate, xcfg),
            REPS_PLAIN)
    k4_eager = eager_ms(torch, lambda: line_ops.update_maps_line(
        mt, k2_scan.points, k2_scan.valid, pose, zero3, yes, xcfg),
        REPS_KERNEL)
    smt = smaps.clone()
    k4b_ms, k4b_plain_ms = {}, {}
    for mname in ("1-in-18", "all", "none"):
        fire = torch.as_tensor(masks[mname], device=dev)
        k4b_ms[mname] = graph_ms(
            torch, lambda fire=fire: line_ops.update_maps_line_batch(
                smt, fpts_all, fval_all, fposes, fzero, fire, scfg),
            REPS_KERNEL)
        k4b_plain_ms[mname] = graph_ms(
            torch, lambda fire=fire: line_ops.update_maps_line_batch_plain(
                smt, fpts_all, fval_all, fposes, fzero, fire, scfg), REPS_PLAIN)
    del smt
    k4_bound = bound(*line_work(k4_cells["fixed-mode"], 400, 1, 1))
    k4b_bound = {m: bound(*line_work(k4b_cells[m], 400, int(masks[m].sum()),
                                     fb))
                 for m in ("1-in-18", "all")}
    say(f"[K4] 3 levels x (fixed-mode, random, beams along the axes and "
        f"tile edges from 2 robot cells, a robot outside the map) equal the "
        f"plain version bit for bit ({k4_cells} cells changed), do_update=0 "
        f"bit-exact, inputs other than the maps untouched, no marks scratch; "
        f"device {k4_ms['fire']:.4f} ms/scan firing (bound "
        f"{k4_bound[0]:.6f} ms by {k4_bound[1]}), {k4_ms['gated']:.4f} gated "
        f"vs plain {k4_plain_ms['fire']:.4f} / {k4_plain_ms['gated']:.4f} ms "
        f"(CUDA graph; K2 {k2_ms:.4f}); eager firing {k4_eager:.4f} ms")
    grids = [line_ops._params(c, 400, b, fill.sm_count(0),
                              line_ops._resident()).grid
             for c, b in ((xcfg, 1), (scfg, fb))]
    say(f"[K4] grid {grids[0]} blocks for one robot, {grids[1]} for {fb} "
        f"({line_ops._resident()} an SM held at once)")
    say(f"[K4 batch] {fb} robots x (fleet, random) x fire masks {list(masks)}, "
        f"a robot outside the map, {big} robots and {huge} robots "
        f"({hscfg.level_sizes} px) x the same masks equal the plain version "
        f"bit for bit, non-firing robots untouched (fleet maps: {k4b_cells} "
        f"cells changed); device ms/batch-scan (CUDA graph) 1-in-18 "
        f"{k4b_ms['1-in-18']:.4f} vs plain {k4b_plain_ms['1-in-18']:.4f} "
        f"(bound {k4b_bound['1-in-18'][0]:.6f}), all {k4b_ms['all']:.4f} vs "
        f"plain {k4b_plain_ms['all']:.4f} (bound {k4b_bound['all'][0]:.6f}), "
        f"none {k4b_ms['none']:.4f} vs plain {k4b_plain_ms['none']:.4f}")

    # ---- 12. the fixed replay end to end ------------------------------------
    xst0 = replay.bootstrap(hector.init(xcfg, log.traj[0], dev), dlog,
                            log.bootstrap, xcfg)
    _build.reset_launches()
    xstf, xout = replay.replay(xst0, dlog, log.bootstrap, xcfg)
    torch.cuda.synchronize()
    xlaunch = _build.kernel_launches()
    want = dict.fromkeys(xlaunch, 0)
    want.update(K3=n, K4=n)
    check(xlaunch == want, f"launches in the fixed replay: {xlaunch}, want {want}")
    xposes = xout.poses.cpu().numpy()
    check(xposes.shape == (n, 3) and np.isfinite(xposes).all(),
          f"fixed replay poses: shape {xposes.shape}, finite "
          f"{np.isfinite(xposes).all()}")
    check(bool(torch.isfinite(xstf.maps).all()), "fixed replay maps not finite")
    xate, xmax = replay.ate_of(xposes, log.traj[log.bootstrap:])
    xupdates = int(xout.map_updated.sum())
    xfails = int(xout.solve_failures.sum())

    def best_fixed(plain: bool) -> float:
        replay.replay(xst0, dlog, log.bootstrap, xcfg, plain)   # warm-up
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(TIMED_REPLAYS):
            t = time.perf_counter()
            replay.replay(xst0, dlog, log.bootstrap, xcfg, plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    tx_kernel = best_fixed(False)
    tx_plain = best_fixed(True)
    _, xout_p = replay.replay(xst0, dlog, log.bootstrap, xcfg, plain=True)
    xate_p, xmax_p = replay.ate_of(xout_p.poses.cpu().numpy(),
                                   log.traj[log.bootstrap:])
    nonzero = {k: v for k, v in xlaunch.items() if v}
    say(f"[fixed] fixed replay of {n} scans: ATE {xate:.6f} m (JAX ref "
        f"{replay.JAX_FIXED_REF_ATE_M:.6f}, gate +1e-4), max err {xmax:.4f} m, "
        f"map updates {xupdates}, solve failures {xfails}, launches "
        f"{nonzero} (all others 0); kernels {n / tx_kernel:.1f} scans/s vs "
        f"plain {n / tx_plain:.1f} scans/s (plain ATE {xate_p:.6f}, max "
        f"{xmax_p:.4f})")
    port_gate = ate <= xate + 1e-4
    jax_gate = replay.JAX_REF_ATE_M <= replay.JAX_FIXED_REF_ATE_M + 1e-4
    say(f"[fixed] bench.py:256's gate, information only: pallas_dense ATE <= "
        f"fixed ATE + 1e-4 — port {ate:.6f} vs {xate + 1e-4:.6f} "
        f"({'holds' if port_gate else 'fails'}); JAX "
        f"{replay.JAX_REF_ATE_M:.6f} vs {replay.JAX_FIXED_REF_ATE_M + 1e-4:.6f} "
        f"({'holds' if jax_gate else 'fails'})")
    check(xate <= replay.JAX_FIXED_REF_ATE_M + 1e-4,
          f"fixed ATE {xate} above JAX_FIXED_REF_ATE_M + 1e-4")
    check(xmax <= 0.05, f"fixed max error {xmax} m above 0.05 m")

    # ---- 13. the sub1 fleet end to end -------------------------------------
    _build.reset_launches()
    sst = replay.fleet_bootstrap(fleet.init_fleet(scfg, flog.traj[0], dev),
                                 fdlog, boot, scfg)
    sstf, sout = fleet.replay_fleet(sst, fdlog.points[boot:],
                                    fdlog.valid[boot:], scfg)
    torch.cuda.synchronize()
    slaunch = _build.kernel_launches()
    want = dict.fromkeys(slaunch, 0)
    want.update(K3_batch=nb, K4_batch=nb)
    check(slaunch == want, f"launches in the sub1 fleet flow: {slaunch}, want "
          f"{want}")
    sposes = sout.cpu().numpy()
    check(sposes.shape == (nt, fb, 3) and np.isfinite(sposes).all(),
          f"sub1 poses: shape {sposes.shape}, finite {np.isfinite(sposes).all()}")
    check(bool(torch.isfinite(sstf.maps).all()), "sub1 maps not finite")
    sate, smax, smed = replay.fleet_ate_of(sposes, flog.traj[boot:])

    def best_sub1(plain: bool, reps: int) -> float:
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            fleet.replay_fleet(sst, fdlog.points[boot:], fdlog.valid[boot:],
                               scfg, plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    fleet.replay_fleet(sst, fdlog.points[boot:], fdlog.valid[boot:], scfg)
    torch.cuda.synchronize()                                    # warm-up
    ts_kernel = best_sub1(False, TIMED_REPLAYS)
    ts_plain = best_sub1(True, 1)
    _, spl = fleet.replay_fleet(sst, fdlog.points[boot:], fdlog.valid[boot:],
                                scfg, plain=True)
    spate, spmax, spmed = replay.fleet_ate_of(spl.cpu().numpy(),
                                              flog.traj[boot:])
    nonzero = {k: v for k, v in slaunch.items() if v}
    say(f"[sub1] sub1 fleet, {fb} robots x ({boot} + {nt}) batch-scans: RMS "
        f"ATE {sate:.6f} m (JAX ref {replay.FLEET_SUB1_JAX_REF_ATE_M:.6f}, gate "
        f"+5e-4), max err {smax:.4f} m (ref "
        f"{replay.FLEET_SUB1_JAX_REF_MAX_M:.4f}, gate +0.01), median instance "
        f"ATE {smed:.6f} m (ref {replay.FLEET_SUB1_JAX_REF_MEDIAN_M:.6f}, gate "
        f"+2e-4); launches {nonzero} (all others 0); kernels "
        f"{iscans / ts_kernel:.1f} instance-scans/s (best of {TIMED_REPLAYS}) "
        f"vs plain {iscans / ts_plain:.1f} (best of 1; plain ATE {spate:.6f}, "
        f"max {spmax:.4f}, median {spmed:.6f})")
    check(sate <= replay.FLEET_SUB1_JAX_REF_ATE_M + 5e-4,
          f"sub1 ATE {sate} above FLEET_SUB1_JAX_REF_ATE_M + 5e-4")
    check(smax <= replay.FLEET_SUB1_JAX_REF_MAX_M + 0.01,
          f"sub1 max error {smax} above FLEET_SUB1_JAX_REF_MAX_M + 0.01")
    check(smed <= replay.FLEET_SUB1_JAX_REF_MEDIAN_M + 2e-4,
          f"sub1 median instance ATE {smed} above FLEET_SUB1_JAX_REF_MEDIAN_M "
          "+ 2e-4")

    # ---- 14. the early exit: K1's table and K3 with early_exit_tol -------
    # against their plain versions at the hints of phases 3 and 10: the
    # pose within K3_POSE_TOL and the same iterations run; then the bench's
    # default candidate onehot_bf16_dense replayed through K1 with the exit
    ecfg = replay.onehot_bf16_dense_config()
    x_exit = xcfg.overlay({"early_exit_tol": EXIT_TOL})
    k1_exit_err, exit_iters = 0.0, {}
    exit_before = (launched("K1"), launched("K3"))
    for name, c0, m in (("K1", ecfg, maps), ("K3", x_exit, xmaps)):
        sc = scan if name == "K1" else xscan
        its = []
        # bench's tolerance, then a looser one at which every hint's match
        # leaves some level early (on these 6-scan maps the finest level's
        # steps stay above 1e-3 px: the replay shows the exit at 1e-3)
        for c, off in [(c0, off) for off in EXIT_HINTS] + [
                (c0.overlay({"early_exit_tol": EXIT_TOL_FIRES}), off)
                for off in EXIT_HINTS]:
            h = truth + torch.tensor(off, device=dev)
            ok_ = match.match(m, sc.points, sc.valid, h, c)
            op = match.match_plain(m, sc.points, sc.valid, h, c)
            fixed = match.match(m, sc.points, sc.valid, h,
                                c.overlay({"early_exit_tol": 0.0}))
            ok_, op = ok_.cpu().numpy(), op.cpu().numpy()
            err = float(np.abs(ok_[:3] - op[:3]).max())
            k1_exit_err = max(k1_exit_err, err)
            check(np.isfinite(ok_).all(), f"{name} exit output not finite")
            check(err <= K3_POSE_TOL, f"{name} exit pose {ok_[:3]} vs plain "
                  f"{op[:3]} (tol {K3_POSE_TOL})")
            check(ok_[6] == op[6], f"{name} exit ran {ok_[6]} iterations, "
                  f"the plain version {op[6]}")
            check(ok_[3] == op[3], f"{name} exit solve failures {ok_[3]} vs "
                  f"plain {op[3]}")
            check(float(fixed[6]) == 15.0 and 3 <= ok_[6] <= 15,
                  f"{name}: {ok_[6]} iterations with the exit, "
                  f"{float(fixed[6])} without")
            its.append(int(ok_[6]))
        check(max(its[len(EXIT_HINTS):]) < 15,
              f"{name}: the exit at {EXIT_TOL_FIRES} did not fire: {its}")
        exit_iters[name] = its
    torch.cuda.synchronize()
    check((launched("K1") - exit_before[0], launched("K3") - exit_before[1])
          == (4 * len(EXIT_HINTS), 4 * len(EXIT_HINTS)),
          "exit-phase launch counts")
    h_exit = truth + torch.tensor(EXIT_HINTS[0], device=dev)

    def k1_exit():
        return match.match(maps, scan.points, scan.valid, h_exit, ecfg)

    def k1_exit_plain():
        return match.match_plain(maps, scan.points, scan.valid, h_exit, ecfg)

    k1x_ms = graph_ms(torch, k1_exit, REPS_KERNEL)
    k1x_plain_ms = graph_ms(torch, k1_exit_plain, REPS_PLAIN)
    k3x_ms = graph_ms(torch, lambda: match.match(
        xmaps, xscan.points, xscan.valid, h_exit, x_exit), REPS_KERNEL)
    k1x_bound = bound(*match_work(maps, scan.points[None], scan.valid[None],
                                  h_exit[None], ecfg, exit_iters["K1"][0]))

    est0 = replay.bootstrap(hector.init(ecfg, log.traj[0], dev), dlog,
                            log.bootstrap, ecfg)
    _build.reset_launches()
    estf, eout = replay.replay(est0, dlog, log.bootstrap, ecfg)
    torch.cuda.synchronize()
    elaunch = _build.kernel_launches()
    want = dict.fromkeys(elaunch, 0)
    want.update(K1=n, K2=n)
    check(elaunch == want, f"launches in the onehot_bf16_dense replay: "
          f"{elaunch}, want {want}")
    eposes = eout.poses.cpu().numpy()
    check(eposes.shape == (n, 3) and np.isfinite(eposes).all(),
          "onehot_bf16_dense poses")
    check(bool(torch.isfinite(estf.maps).all()), "onehot_bf16_dense maps")
    eate, emax = replay.ate_of(eposes, log.traj[log.bootstrap:])
    e_iters = int(eout.gn_iterations.sum())

    def best_exit(plain: bool) -> float:
        replay.replay(est0, dlog, log.bootstrap, ecfg, plain)   # warm-up
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(TIMED_REPLAYS if not plain else 1):
            t = time.perf_counter()
            replay.replay(est0, dlog, log.bootstrap, ecfg, plain)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    te_kernel = best_exit(False)
    te_plain = best_exit(True)
    say(f"[exit] K1's table and K3 with early_exit_tol {EXIT_TOL} at "
        f"{len(EXIT_HINTS)} hints agree with their plain versions: max |pose "
        f"err| {k1_exit_err:.3g} (tol {K3_POSE_TOL}), equal iterations run "
        f"{exit_iters} (15 without the exit; the last {len(EXIT_HINTS)} at "
        f"tol {EXIT_TOL_FIRES}), equal solve failures; device "
        f"K1 {k1x_ms:.4f} ms vs plain {k1x_plain_ms:.4f} (bound "
        f"{k1x_bound[0]:.6f} ms by {k1x_bound[1]}), K3 {k3x_ms:.4f} (CUDA "
        f"graph; fixed K1 {k1_ms:.4f}, K3 {k3_ms:.4f})")
    say(f"[exit] onehot_bf16_dense replay of {n} scans: ATE {eate:.6f} m "
        f"(port fixed {xate:.6f}, gate +1e-4; JAX ref "
        f"{replay.JAX_EXIT_REF_ATE_M:.6f}, gate +2e-4), max err {emax:.4f} m, "
        f"GN iterations {e_iters} (< 15 x {n} = {15 * n}), map updates "
        f"{int(eout.map_updated.sum())}, launches "
        f"{ {k: v for k, v in elaunch.items() if v} } (all others 0); kernels "
        f"{n / te_kernel:.1f} scans/s vs plain {n / te_plain:.1f} "
        f"(pallas_dense {n / t_kernel:.1f})")
    check(eate <= xate + 1e-4, f"onehot_bf16_dense ATE {eate} above the "
          f"port's fixed ATE {xate} + 1e-4")
    check(eate <= replay.JAX_EXIT_REF_ATE_M + 2e-4, f"onehot_bf16_dense ATE "
          f"{eate} above JAX_EXIT_REF_ATE_M + 2e-4")
    check(emax <= 0.05, f"onehot_bf16_dense max error {emax} above 0.05 m")
    check(e_iters < 15 * n, f"{e_iters} GN iterations: the exit never fired")

    # ---- 15. K1-K4 at the graph frontend's shapes ---------------------------
    # the local grid: one 128-px level at 0.25 m, 20 GN iterations, all 400
    # beams; a fresh zero grid a keyframe event, the fire flag set
    gcfg_l = frontend.ScanMatchConfig()
    gcfg_d = frontend.ScanMatchConfig(matcher_mode="pallas", dense_fill=True)
    h_l, h_d = frontend.grid_config(gcfg_l), frontend.grid_config(gcfg_d)
    center = frontend._center(gcfg_l, dev)
    ref_scan = sim_scan(truth)
    fr_before = (launched("K4"), launched("K2"))
    grid_l = frontend.rasterize_scan(ref_scan, gcfg_l)
    grid_lp = frontend.rasterize_scan(ref_scan, gcfg_l, plain=True)
    check(torch.equal(grid_l, grid_lp), f"K4 at 128 px: "
          f"{int((grid_l != grid_lp).sum())} cells differ from the plain version")
    fr_line_cells = int((grid_l != 0).sum())
    # beams to the 45-cell tiles' edges of the 128-px grid, the robot at its
    # centre (64, 64): endpoints on tiles' first and last columns and rows,
    # along the axes and the diagonals
    tile = line_ops.TILE
    edges = [0, tile - 1, tile, 2 * tile - 1, 2 * tile, 127]
    ends = [(x, y) for x in edges for y in edges]
    ends += [(64 + sx * d, 64 + sy * d) for d in (1, 2, 19, 25, 26, 63)
             for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1),
                            (-1, 1), (1, -1), (-1, -1)) if 0 <= 64 + sx * d < 128
             and 0 <= 64 + sy * d < 128]
    e_pts = torch.tensor([((x - 64) * 0.25, (y - 64) * 0.25) for x, y in ends],
                         dtype=torch.float32, device=dev)
    e_scan = Scan(e_pts, torch.ones(len(ends), dtype=torch.bool, device=dev),
                  zero3)
    g_e = frontend.rasterize_scan(e_scan, gcfg_l)
    check(torch.equal(g_e, frontend.rasterize_scan(e_scan, gcfg_l, True)),
          "K4 at 128 px, tile-edge beams: differs from the plain version")
    check(int((g_e > 0).sum()) >= len(set(ends)) - 1,
          "K4 at 128 px: tile-edge endpoints not marked")
    grid_d = frontend.rasterize_scan(ref_scan, gcfg_d)
    grid_dp = frontend.rasterize_scan(ref_scan, gcfg_d, plain=True)
    occ_k, occ_p = grid_d > 0, grid_dp > 0
    check(torch.equal(occ_k, occ_p) and torch.equal(grid_d[occ_k],
                                                    grid_dp[occ_p]),
          "K2 at 128 px: occupied cells differ")
    fr_fill_frac = float((grid_d != grid_dp).float().mean())
    fr_fill_err = float((grid_d - grid_dp).abs().max())
    check(fr_fill_frac <= 1e-3, f"K2 at 128 px: {fr_fill_frac:.2%} of cells "
          "differ (limit 0.1%)")
    fr_fill_cells = int((grid_d != 0).sum())
    torch.cuda.synchronize()
    check((launched("K4") - fr_before[0], launched("K2") - fr_before[1])
          == (2, 1),
          "frontend map update launch counts")
    # the query: a scan 0.3 m and 0.05 rad on, matched from the odometry
    qpose = truth + torch.tensor((0.3, -0.2, 0.05), device=dev)
    q_scan = sim_scan(qpose)
    fr_hint = torch.tensor((0.3 + 0.06, -0.2 - 0.04, 0.05 + 0.02),
                           device=dev) + center
    fr_err = {}
    for name, c, grid, tol in (("K3", h_l, grid_l, K3_POSE_TOL),
                               ("K1", h_d, grid_d, 2e-3)):
        ok_ = match.match(grid, q_scan.points, q_scan.valid, fr_hint, c)
        op = match.match_plain(grid, q_scan.points, q_scan.valid, fr_hint, c)
        ok_, op = ok_.cpu().numpy(), op.cpu().numpy()
        err = float(np.abs(ok_[:3] - op[:3]).max())
        fr_err[name] = err
        check(np.isfinite(ok_).all() and err <= tol,
              f"{name} at 128 px: pose {ok_[:3]} vs plain {op[:3]} (tol {tol})")
        check(ok_[3] == op[3] and ok_[6] == op[6] == 20.0,
              f"{name} at 128 px: failures / iterations {ok_[3:]} vs {op[3:]}")
        rel = ok_[:3] - center.cpu().numpy()
        check(np.abs(rel[:2] - [0.3, -0.2]).max() < 0.1,
              f"{name} at 128 px did not converge: rel {rel}")
    fr = {}
    for name, c, grid in (("K3", h_l, grid_l), ("K1", h_d, grid_d)):
        fr[name] = (
            graph_ms(torch, lambda c=c, g=grid: match.match(
                g, q_scan.points, q_scan.valid, fr_hint, c), REPS_KERNEL),
            graph_ms(torch, lambda c=c, g=grid: match.match_plain(
                g, q_scan.points, q_scan.valid, fr_hint, c), REPS_PLAIN),
            bound(*match_work(grid, q_scan.points[None], q_scan.valid[None],
                              fr_hint[None], c)))
    gt_l = torch.zeros(h_l.total_cells, device=dev)
    gt_d = torch.zeros(h_d.total_cells, device=dev)
    fr["K4"] = (
        graph_ms(torch, lambda: line_ops.update_maps_line(
            gt_l, ref_scan.points, ref_scan.valid, center, zero3, yes, h_l),
            REPS_KERNEL),
        graph_ms(torch, lambda: line_ops.update_maps_line_plain(
            gt_l, ref_scan.points, ref_scan.valid, center, zero3, yes, h_l),
            REPS_PLAIN),
        bound(*line_work(fr_line_cells, 400, 1, 1)))
    fr["K2"] = (
        graph_ms(torch, lambda: fill.update_maps(
            gt_d, ref_scan.points, ref_scan.valid, center, zero3, yes, h_d),
            REPS_KERNEL),
        graph_ms(torch, lambda: fill.update_maps_plain(
            gt_d, ref_scan.points, ref_scan.valid, center, zero3, yes, h_d),
            REPS_PLAIN),
        bound(*fill_work(h_d, fr_fill_cells, 400, 1, 1)))
    del gt_l, gt_d
    say(f"[frontend] the {h_l.map_size}-px local grid ({h_l.map_resolution} "
        f"m, 1 level, 20 iterations, 400 beams): K4 equals its plain version "
        f"bit for bit ({fr_line_cells} cells; {len(ends)} beams to the "
        f"{tile}-cell tiles' edges too), K2 {fr_fill_frac:.4%} of cells "
        f"differ, max |err| {fr_fill_err:.3g} (margin "
        f"{h_d.dense_free_margin_px}); K3 |pose err| "
        f"{fr_err['K3']:.3g} (tol {K3_POSE_TOL}), K1 {fr_err['K1']:.3g} (tol "
        f"2e-3), 20 iterations each; device ms (CUDA graph) "
        + ", ".join(f"{k} {v[0]:.4f} vs plain {v[1]:.4f} (bound "
                    f"{v[2][0]:.6f} by {v[2][1]})" for k, v in fr.items()))

    # ---- 16. graph-SLAM: the gather and pallas_full replays ---------------
    glog = replay.make_graph_log()
    gdlog = replay.to_device(glog, dev)
    gn = gdlog.points.shape[0]
    graph_runs = {}
    for gmode, (hc, mc), ref in (
            ("gather", replay.graph_gather_config(),
             replay.graph_reference()),
            ("pallas_full", replay.graph_pallas_full_config(),
             replay.graph_reference(onehot=True))):
        _build.reset_launches()
        syncs0 = graph_slam.update.syncs
        searches0 = graph_slam.update.searches
        gst, gout = replay.graph_replay(gdlog, hc, mc)
        torch.cuda.synchronize()
        glaunch = _build.kernel_launches()
        gsyncs = graph_slam.update.syncs - syncs0
        searches = graph_slam.update.searches - searches0
        events = int(gout.keyframe_added.sum())
        mkey, ukey = ("K3", "K4") if gmode == "gather" else ("K1", "K2")
        want = dict.fromkeys(glaunch, 0)
        want.update({mkey: gn + searches, ukey: gn + searches})
        check(glaunch == want, f"launches in the {gmode} graph replay: "
              f"{glaunch}, want {want} ({searches} loop searches)")
        check(gsyncs == gn + events + searches, f"{gmode}: {gsyncs} host "
              f"reads, want {gn} + {events} + {searches}")
        gposes = gout.poses.cpu().numpy()
        check(gposes.shape == (gn, 3) and np.isfinite(gposes).all(),
              f"{gmode} graph poses")
        res = replay.graph_ate_of(gst, gposes, glog.traj)
        check(res["keyframes"] == events + 1,
              f"{gmode}: {res['keyframes']} keyframes, {events} events")
        check(res["loop_closures"] <= searches <= events,
              f"{gmode}: {searches} loop searches, {events} events, "
              f"{res['loop_closures']} closures")
        fails = replay.graph_gate(res, ref)
        check(not fails, f"{gmode} graph gate vs JAX: {fails}")
        if gmode == "pallas_full":
            fails = replay.graph_gate(res, graph_runs["gather"]["res"])
            check(not fails, f"pallas_full graph gate vs gather: {fails}")

        def best_graph(hc=hc, mc=mc, first=gout.poses) -> float:
            # each timed replay gives the first one's poses bit for bit: the
            # graph's assembly, solves and kernels are deterministic
            best = float("inf")
            for _ in range(TIMED_REPLAYS):
                t = time.perf_counter()
                _, again = replay.graph_replay(gdlog, hc, mc)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t)
                check(torch.equal(again.poses, first), f"{gmode}: a second "
                      "graph replay gave other poses")
            return best
        graph_runs[gmode] = {"res": res, "launches": glaunch, "events": events,
                             "searches": searches, "syncs": gsyncs,
                             "s": best_graph(), "state": gst}
        say(f"[graph] {gmode} replay of {gn} scans ({glog.bootstrap} forced): "
            f"ATE {res['ate_m']:.6f} m (JAX ref {ref['ate_m']:.6f}, gate x1.15), "
            f"max err {res['max_err_m']:.4f} m (ref {ref['max_err_m']:.4f}), "
            f"keyframes {res['keyframes']} (ref {ref['keyframes']}), loop "
            f"closures {res['loop_closures']} (ref {ref['loop_closures']}); "
            f"launches { {k: v for k, v in glaunch.items() if v} } (all "
            f"others 0: {gn} a scan + {searches} loop searches in {events} "
            f"keyframe events); host reads {gsyncs} a replay ({gn} + {events} "
            f"+ {searches}); {gn / graph_runs[gmode]['s']:.1f} scans/s "
            f"(best of {TIMED_REPLAYS}, each replay's poses the first's bit "
            "for bit)")
    # the cost of the keyframe branch's read: the Hector-only fixed replay
    # over the same graph log, without and with one read of the device a
    # scan, beside the gather graph replay, each best of TIMED_REPLAYS
    hc = replay.fixed_config()
    zero_g = torch.zeros(3, dtype=torch.float32, device=dev)

    def hector_only(read: bool) -> float:
        best = float("inf")
        for _ in range(TIMED_REPLAYS):
            st = hector.init(hc, gdlog.traj[0], dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(gn):
                st, _ = hector.update(
                    st, Scan(gdlog.points[i], gdlog.valid[i], zero_g),
                    st.match_pose, hc, i < glog.bootstrap)
                if read:
                    bool(st.match_pose[0] > -1e9)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    t_h = hector_only(False)
    t_hr = hector_only(True)
    us = {k: v * 1e6 / gn for k, v in (("hector", t_h), ("hector_read", t_hr),
                                        ("graph", graph_runs["gather"]["s"]))}
    say(f"[graph] host us a scan over the graph log: Hector-only fixed "
        f"{us['hector']:.1f}, with one read of the device a scan "
        f"{us['hector_read']:.1f} (the read costs "
        f"{us['hector_read'] - us['hector']:.1f}), graph gather "
        f"{us['graph']:.1f} (+{us['graph'] - us['hector']:.1f} over "
        f"Hector-only)")
    # the normal equations of the gather replay's final graph, assembled
    # twice on the card: the same H and b bit for bit (no atomics)
    gst = graph_runs["gather"]["state"]
    ak = posegraph.bucket(gst.graph.poses.shape[0], gst.nodes)
    h1, b1 = posegraph.build_normal_equations(gst.graph, active_k=ak)
    h2, b2 = posegraph.build_normal_equations(gst.graph, active_k=ak)
    check(torch.equal(h1, h2) and torch.equal(b1, b2),
          "two assemblies of the normal equations differ")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matrix products are on: the assembly needs full f32")
    say(f"[graph] the final graph's normal equations ({3 * ak} x {3 * ak}, "
        f"{gst.nodes} nodes, {int(gst.graph.num_edges)} edges) assembled "
        "twice on the card: equal bit for bit")
    del h1, b1, h2, b2
    # map finalization after the gather replay: every keyframe slot through
    # K4, equal to the plain version bit for bit
    _build.reset_launches()
    rebuilt = graph_slam.rebuild_maps(gst, hc)
    torch.cuda.synchronize()
    rl = launched("K4")
    rebuilt_p = graph_slam.rebuild_maps(gst, hc, plain=True)
    check(torch.equal(rebuilt, rebuilt_p), f"rebuild_maps: "
          f"{int((rebuilt != rebuilt_p).sum())} cells differ from the plain "
          "version")
    check(rl == gst.kf_points.shape[0], f"rebuild_maps launched K4 {rl} times")
    l0 = rebuilt[:hc.map_size ** 2]
    say(f"[graph] rebuild_maps of {gst.nodes} keyframes in "
        f"{gst.kf_points.shape[0]} slots ({rl} K4 launches) equals its plain "
        f"version bit for bit ({int((l0 > 0).sum())} occupied, "
        f"{int((l0 < 0).sum())} free cells at the finest level)")
    del graph_runs["gather"]["state"], graph_runs["pallas_full"]["state"], gst

    # ---- 17. the office loop: K3 and K4 at 200/100/50 px, two replays ------
    t17 = time.perf_counter()
    ohc, ogc, omc = replay.office_config()
    olog = replay.make_office_log()
    odl = replay.to_device(olog, dev)
    oodo_np, odel_np = replay.office_odometry(olog.traj)
    oodo = torch.from_numpy(oodo_np).to(dev)
    odel = torch.from_numpy(odel_np).to(dev)
    on = odl.points.shape[0]
    # a map from the log's bootstrap scans at the truth; the robot inside it
    # (room A) and outside it (room B, beyond x = 20 m)
    ost = hector.init(ohc, odl.traj[0], dev)
    for t in range(olog.bootstrap):
        ost, _ = hector.update(ost, Scan(odl.points[t], odl.valid[t], zero3),
                               odl.traj[t], ohc, True)
    omaps = ost.maps
    t_out = int(np.argmax(olog.traj[:, 0] > 24.0))
    o_err = {"K3": 0.0, "K3_res": 0.0, "K4": 0.0}
    o_k4_cells = {}
    for where, t, off in (("inside", 12, (0.15, -0.1, 0.03)),
                          ("inside", 40, (-0.1, 0.12, -0.02)),
                          ("outside", t_out, (0.1, 0.1, 0.02))):
        oscan = Scan(odl.points[t], odl.valid[t], zero3)
        hint = odl.traj[t] + torch.tensor(off, device=dev)
        ok_ = match.match(omaps, oscan.points, oscan.valid, hint, ohc)
        op = match.match_plain(omaps, oscan.points, oscan.valid, hint, ohc)
        ok_, op = ok_.cpu().numpy(), op.cpu().numpy()
        err, res, _, _ = k3_readings(ok_[None], op[None], op[None])
        o_err["K3"], o_err["K3_res"] = max(o_err["K3"], err), max(
            o_err["K3_res"], res)
        check(np.isfinite(ok_).all() and err <= K3_POSE_TOL,
              f"K3 at 200 px, robot {where} (scan {t}): pose {ok_[:3]} vs "
              f"plain {op[:3]} (tol {K3_POSE_TOL})")
        check(res <= K3_RESID_RTOL and ok_[3] == op[3] and ok_[5] == op[5],
              f"K3 at 200 px, robot {where}: residual rel err {res}, "
              f"failures / in-map beams {ok_[3:6]} vs {op[3:6]}")
        mk = line_case(f"K4 at 200 px, robot {where}", omaps, oscan.points,
                       oscan.valid, odl.traj[t], yes, ohc)
        o_k4_cells[f"{where}_{t}"] = int((mk != omaps).sum())
        say(f"[office] K3 robot {where} (scan {t}, in-map beams {ok_[5]:.0f} "
            f"of {int(oscan.valid.sum())}): |pose err| {err:.3g}, residual "
            f"rel err {res:.3g}; K4 equals its plain version bit for bit "
            f"({o_k4_cells[f'{where}_{t}']} cells changed)")
    check(o_k4_cells[f"outside_{t_out}"] < o_k4_cells["inside_12"],
          "K4 with the robot outside the map changed as much as inside")
    oscan = Scan(odl.points[40], odl.valid[40], zero3)
    ohint = odl.traj[40] + torch.tensor((-0.1, 0.12, -0.02), device=dev)
    gt_o = omaps.clone()
    o_ms = {
        "K3": (graph_ms(torch, lambda: match.match(
            omaps, oscan.points, oscan.valid, ohint, ohc), REPS_KERNEL),
            graph_ms(torch, lambda: match.match_plain(
                omaps, oscan.points, oscan.valid, ohint, ohc), REPS_PLAIN),
            bound(*match_work(omaps, oscan.points[None], oscan.valid[None],
                              ohint[None], ohc))),
        "K4": (graph_ms(torch, lambda: line_ops.update_maps_line(
            gt_o, oscan.points, oscan.valid, odl.traj[40], zero3, yes, ohc),
            REPS_KERNEL),
            graph_ms(torch, lambda: line_ops.update_maps_line_plain(
                gt_o, oscan.points, oscan.valid, odl.traj[40], zero3, yes,
                ohc), REPS_PLAIN),
            bound(*line_work(o_k4_cells["inside_40"], 400, 1, 1)))}
    del gt_o
    say(f"[office] {ohc.level_sizes} px, damping {ohc.gn_damping}, in-map "
        f"guard {ohc.min_match_in_map_frac}: device ms (CUDA graph) "
        + ", ".join(f"{k} {v[0]:.4f} vs plain {v[1]:.4f} (bound "
                    f"{v[2][0]:.6f} by {v[2][1]})" for k, v in o_ms.items()))
    office_runs = {}
    for oname, g in (("hector", None), ("graph", ogc)):
        _build.reset_launches()
        syncs0 = graph_slam.update.syncs
        searches0 = graph_slam.update.searches
        ostf, oout = replay.office_replay(odl, oodo, odel, ohc, g,
                                          omc if g else None)
        torch.cuda.synchronize()
        olaunch = _build.kernel_launches()
        osyncs = graph_slam.update.syncs - syncs0
        searches = graph_slam.update.searches - searches0
        events = int(oout.keyframe_added.sum())
        want = dict.fromkeys(olaunch, 0)
        want.update(K3=on, K4=on, K1=searches, K2=searches)
        check(olaunch == want, f"launches in the office {oname} replay: "
              f"{olaunch}, want {want}")
        check(osyncs == (on + events + searches if g else 0),
              f"office {oname}: {osyncs} host reads")
        oposes = oout.poses.cpu().numpy()
        check(oposes.shape == (on, 3) and np.isfinite(oposes).all(),
              f"office {oname} poses")
        check(np.array_equal(oposes[:olog.bootstrap],
                             oodo_np[:olog.bootstrap]),
              f"office {oname}: the forced scans' poses are not the odometry")

        def best_office(g=g, first=oout.poses) -> float:
            best = float("inf")
            for _ in range(TIMED_REPLAYS):
                t = time.perf_counter()
                _, again = replay.office_replay(odl, oodo, odel, ohc, g,
                                                omc if g else None)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t)
                check(torch.equal(again.poses, first), f"office {oname}: a "
                      "second replay gave other poses")
            return best
        office_runs[oname] = {"state": ostf, "poses": oposes,
                              "kf": oout.keyframe_added.cpu().numpy(),
                              "launches": olaunch, "syncs": osyncs,
                              "searches": searches, "events": events,
                              "s": best_office()}
    ores = replay.office_metrics(olog.traj, office_runs["hector"]["poses"],
                                 office_runs["graph"]["state"],
                                 office_runs["graph"]["poses"],
                                 office_runs["graph"]["kf"])
    oref = replay.office_reference()
    check(ores["keyframes"] == office_runs["graph"]["events"] + 1,
          f"office: {ores['keyframes']} keyframes, "
          f"{office_runs['graph']['events']} events")
    ofails = replay.office_gate(ores, oref)
    og = office_runs["graph"]
    say(f"[office] replays of {on} scans ({olog.bootstrap} forced): "
        + ", ".join(f"{k} {v:.6g} (JAX {oref[k]:.6g})" for k, v in ores.items()
                    if k in oref)
        + f"; launches hector-only "
        f"{ {k: v for k, v in office_runs['hector']['launches'].items() if v} }"
        f", graph { {k: v for k, v in og['launches'].items() if v} } ("
        f"{og['searches']} loop searches in {og['events']} keyframe events); "
        f"host reads {og['syncs']} ({on} + {og['events']} + "
        f"{og['searches']}), hector-only 0; scans/s hector-only "
        f"{on / office_runs['hector']['s']:.1f}, graph {on / og['s']:.1f} "
        f"(best of {TIMED_REPLAYS}, each replay's poses the first's bit for "
        f"bit); {time.perf_counter() - t17:.1f} s")
    check(not ofails, f"office gate vs JAX: {ofails}")
    del office_runs["graph"]["state"], ostf

    # ---- 18. CoreSLAM's ops on the card against the CPU ------------------
    t18 = time.perf_counter()
    clog = replay.make_log(0)
    cdl = replay.to_device(clog, dev)
    pcfg = replay.coreslam_production_config()
    mcfg_ = replay.coreslam_parity_config()
    S, OS = pcfg.hole_map_size, pcfg.obstacle_map_size
    hs, osc = pcfg.hole_scale, pcfg.obstacle_scale
    # maps from the first 40 scans of the production replay on the card
    cst = coreslam.init(pcfg, cdl.traj[0], device=dev)
    for t in range(40):
        cst, _ = coreslam.update_cloud(
            cst, Scan(cdl.points[t], cdl.valid[t], zero3), cst.pose, pcfg)
    t = 40
    on_card = {"hole": cst.hole_map, "obst": cst.obstacle_map,
               "pts": cdl.points[t], "valid": cdl.valid[t],
               "pose": cdl.traj[t] + torch.tensor((0.03, -0.02, 0.01),
                                                   device=dev)}
    on_cpu = {k: v.cpu() for k, v in on_card.items()}
    flips = {}
    snaps = {}

    def both(fn, *names, extra=()):
        """``fn`` on the card (twice: bit for bit) and on the CPU, same
        inputs; returns (card, cpu) outputs as CPU tensors."""
        a = fn(*(on_card[n] for n in names), *extra)
        b = fn(*(on_card[n] for n in names), *extra)
        c = fn(*(on_cpu[n] for n in names), *extra)
        a, b, c = ([x.cpu() for x in o] if isinstance(o, tuple) else o.cpu()
                   for o in (a, b, c))
        same = (all(torch.equal(x, y) for x, y in zip(a, b))
                if isinstance(a, list) else torch.equal(a, b))
        check(same, f"{fn.__name__}: two runs on the card differ")
        return a, c
    # Monte-Carlo scores: 4096 candidates drawn on the CPU, the same on both
    cands = score_ops.sample_candidates(on_cpu["pose"], mcfg_.sigma_xy,
                                        mcfg_.sigma_theta, 4096,
                                        torch.Generator().manual_seed(0))
    on_cpu["cands"], on_card["cands"] = cands, cands.to(dev)
    (gx, gy), (cx, cy) = both(lambda p, q: score_ops.candidate_pixels(p, q, hs),
                              "cands", "pts")
    flipped = (gx != cx) | (gy != cy)
    flips["score"], snaps["score"] = int(flipped.sum()), flipped.numel()
    (gs_, gn_), (cs_, cn_) = both(lambda h, p, v, c: score_ops.score_candidates(
        h, S, hs, p, v, c), "hole", "pts", "valid", "cands")
    clean = ~flipped.any(dim=1)
    check(torch.equal(gs_[clean], cs_[clean]) and torch.equal(
        gn_[clean], cn_[clean]), "score_candidates: the card's sums differ "
          "from the CPU's on candidates with no flipped snap")
    # correlative scores on the production grid around the pose
    span = 3.0 * pcfg.sigma_theta
    thetas = correlate.theta_grid(on_cpu["pose"][2], pcfg.corr_num_theta, span)
    on_cpu["thetas"], on_card["thetas"] = thetas, thetas.to(dev)
    (gx, gy), (cx, cy) = both(
        lambda p, th, q: correlate.correlative_pixels(p, th, q, hs),
        "pose", "thetas", "pts")
    kflip = ((gx != cx) | (gy != cy))
    flips["correlative"], snaps["correlative"] = int(kflip.sum()), \
        kflip.numel()
    (gsum, gnb), (csum, cnb) = both(
        lambda h, p, v, sp, th: correlate.correlative_scores(
            h, S, hs, p, v, sp, th, pcfg.corr_window),
        "hole", "pts", "valid", "pose", "thetas")
    kclean = ~kflip.any(dim=1)
    check(torch.equal(gsum[kclean], csum[kclean])
          and torch.equal(gnb[kclean], cnb[kclean]),
          "correlative_scores: the card's sums or counts differ from the "
          "CPU's on headings with no flipped snap")
    (gp, gb), (cp, cb) = both(
        lambda h, p, v, sp: correlate.correlative_search(
            h, S, hs, p, v, sp, pcfg.corr_window, pcfg.corr_num_theta, span),
        "hole", "pts", "valid", "pose")
    check(flips["correlative"] > 0 or (torch.equal(gp, cp)
                                       and torch.equal(gb, cb)),
          f"correlative_search: card {gp.tolist()} {int(gb)} vs CPU "
          f"{cp.tolist()} {int(cb)}")
    # the hole-map walk on integer inputs: exact
    pfr = holemap.pose_frame(on_cpu["pose"], S, hs)
    x2p = pfr.c * on_cpu["pts"][:, 0] - pfr.s * on_cpu["pts"][:, 1]
    y2p = pfr.s * on_cpu["pts"][:, 0] + pfr.c * on_cpu["pts"][:, 1]
    ints = [pfr.x1, pfr.y1, torch.trunc(pfr.px + 1.3 * x2p).int(),
            torch.trunc(pfr.py + 1.3 * y2p).int(),
            torch.trunc(pfr.px + x2p).int(), torch.trunc(pfr.py + y2p).int()]
    for i, name in enumerate(("x1", "y1", "x2", "y2", "xp", "yp")):
        on_cpu[name], on_card[name] = ints[i], ints[i].to(dev)
    ga, ca = both(lambda *a: tuple(ras.hole_ray_cells(*a, 0, 65500, S, S)),
                  "x1", "y1", "x2", "y2", "xp", "yp")
    check(all(torch.equal(x, y) for x, y in zip(ga, ca)),
          "hole_ray_cells: the card differs from the CPU")
    map_ops = {
        "hole_line": (lambda h, p, v, q: holemap.update_hole_map(
            h, S, hs, p, v, q, pcfg.hole_width, pcfg.quality), "hole"),
        "hole_dense": (lambda h, p, v, q: holemap.update_hole_map_dense(
            h, S, hs, p, v, q, pcfg.hole_width, pcfg.quality,
            pcfg.angle_bins), "hole"),
        "obstacle_line": (lambda o, p, v, q: obstacle.update_obstacle_map(
            o, OS, osc, p, v, q, pcfg.max_obstacle_hits), "obst"),
        "obstacle_dense": (lambda o, p, v, q:
                           obstacle.update_obstacle_map_dense(
                               o, OS, osc, p, v, q, pcfg.max_obstacle_hits,
                               pcfg.angle_bins), "obst")}
    outside = {"pose": torch.tensor([-3.0, 20.0, 0.2])}
    for name, (fn, m) in map_ops.items():
        g_, c_ = both(fn, m, "pts", "valid", "pose")
        flips[name], snaps[name] = int((g_ != c_).sum()), g_.numel()
        check(int((g_ != on_cpu[m]).sum()) > 20, f"{name}: no cell changed")
        o_card = fn(on_card[m], on_card["pts"], on_card["valid"],
                    outside["pose"].to(dev))
        check(torch.equal(o_card, on_card[m]),
              f"{name}: a robot outside the map changed the map")
    for name in flips:
        check(flips[name] <= 1e-4 * snaps[name],
              f"{name}: {flips[name]} of {snaps[name]} snaps or cells differ "
              "between the card and the CPU (limit 1 in 10^4)")
    # planted ties: the first minimum wins on the card
    same = on_card["pose"][None].repeat(4096, 1)
    tp, tb = score_ops.best_of(same, on_card["hole"], S, hs, on_card["pts"],
                               on_card["valid"])
    eff_tie = torch.full((4096,), 7, dtype=torch.int32, device=dev)
    eff_tie[[3, 1000, 4000]] = 5
    check(int(torch.argmin(eff_tie)) == 3 and torch.equal(tp, same[0]),
          "argmin on the card did not keep the first minimum")
    grid_tie = torch.full((32, 8, 8), 9, dtype=torch.int32, device=dev)
    grid_tie[5, 2, 3] = grid_tie[5, 2, 4] = grid_tie[20, 0, 0] = 1
    tpose, tsum = correlate.refine_from_scores(grid_tie, on_card["pose"], hs,
                                               8, 32, span)
    cpose, csum_ = correlate.refine_from_scores(grid_tie.cpu(), on_cpu["pose"],
                                                hs, 8, 32, span)
    check(int(tsum) == 1 and torch.equal(tpose.cpu(), cpose),
          f"refine_from_scores on planted ties: card {tpose.tolist()} vs CPU "
          f"{cpose.tolist()}")

    def op_us(fn) -> float:
        try:
            return graph_ms(torch, fn, REPS_PLAIN) * 1e3
        except RuntimeError:
            torch.cuda.synchronize()
            return eager_ms(torch, fn, REPS_PLAIN) * 1e3
    a = [on_card[k] for k in ("hole", "pts", "valid")]
    core_us = {
        "score_candidates_4096": op_us(lambda: score_ops.score_candidates(
            a[0], S, hs, a[1], a[2], on_card["cands"])),
        "correlative_search": op_us(lambda: correlate.correlative_search(
            a[0], S, hs, a[1], a[2], on_card["pose"], pcfg.corr_window,
            pcfg.corr_num_theta, span)),
        **{name: op_us(lambda fn=fn, m=m: fn(on_card[m], a[1], a[2],
                                              on_card["pose"]))
           for name, (fn, m) in map_ops.items()}}
    say(f"[coreslam ops] {S}-px hole map, {OS}-px obstacle map, 400 beams, "
        f"4096 candidates, {pcfg.corr_num_theta} x {pcfg.corr_window} x "
        f"{pcfg.corr_window} grid: card against CPU, snaps or cells "
        f"differing { {k: f'{flips[k]}/{snaps[k]}' for k in flips} }, the "
        "rest bit for bit; hole_ray_cells exact; two runs on the card bit "
        "for bit; planted ties keep the first minimum; a robot outside the "
        "map leaves it; device us "
        + ", ".join(f"{k} {v:.1f}" for k, v in core_us.items())
        + f"; {time.perf_counter() - t18:.1f} s")

    # ---- 19. CoreSLAM end to end: both modes over the 522 loop scans ------
    t19 = time.perf_counter()
    cn = cdl.points.shape[0]
    warm = pcfg.position_search_beginning
    core_runs = {}
    for mode, cfg_, key, keys in (
            ("production", pcfg, "nudge", replay.CORESLAM_NUDGES),
            ("parity", mcfg_, "seed", replay.CORESLAM_SEEDS)):
        ates, searched, secs = [], [], []
        for i, k in enumerate(keys):
            kw = {key: k}
            torch.cuda.synchronize()
            if i == 0:    # no host read in a replay: syncs raise here
                torch.cuda.set_sync_debug_mode("error")
            tt = time.perf_counter()
            try:
                _, cout = replay.coreslam_replay(cdl, cfg_, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - tt)
            cp_ = cout.poses.cpu().numpy()
            check(np.isfinite(cp_).all(), f"{mode} {key} {k}: poses")
            ates.append(replay.ate_of(cp_, clog.traj)[0])
            searched.append(int(cout.searched.sum()))
            if i == 0:
                first = cout.poses
        kw = {key: keys[0]}
        _, again = replay.coreslam_replay(cdl, cfg_, **kw)
        check(torch.equal(again.poses, first), f"{mode}: a second replay "
              "gave other poses")
        # device kernels a searched scan: scans 20-39 of a replay, traced
        pst = coreslam.init(cfg_, cdl.traj[0], device=dev)

        def steps(lo, hi, pst=pst):
            for t in range(lo, hi):
                pst, _ = coreslam.update_cloud(
                    pst, Scan(cdl.points[t], cdl.valid[t], zero3), pst.pose,
                    cfg_)
            torch.cuda.synchronize()
            return pst
        pst = steps(0, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(20, 40, pst)
        n_k = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        best = min(secs[1:1 + TIMED_REPLAYS])
        core_runs[mode] = {"ates_m": ates, key + "s": list(keys),
                           "median_ate_m": float(np.median(ates)),
                           "searched": searched,
                           "kernels_per_scan": n_k / 20,
                           "scans_per_s": cn / best}
    cfails = replay.coreslam_gate(
        core_runs["production"]["ates_m"], core_runs["parity"]["ates_m"],
        core_runs["parity"]["searched"], core_runs["production"]["searched"],
        cn, warm)
    for mode, ref in (("production", replay.CORESLAM_JAX_REF_ATES_M),
                      ("parity", replay.CORESLAM_PARITY_JAX_REF_ATES_M)):
        r = core_runs[mode]
        say(f"[coreslam] {mode} replays of {cn} scans: ATE "
            + " ".join(f"{x:.6f}" for x in r["ates_m"])
            + f" m (median {r['median_ate_m']:.6f}; JAX "
            + " ".join(f"{x:.6f}" for x in ref) + f", median "
            f"{float(np.median(ref)):.6f}), scans searched {r['searched']}, "
            f"no host read in a replay (sync debug mode 'error'), "
            f"{r['kernels_per_scan']:.1f} kernels a searched scan, "
            f"{r['scans_per_s']:.1f} scans/s (best of the {TIMED_REPLAYS} "
            "replays after the first; a repeat of the first gave its poses "
            "bit for bit)")
    say(f"[coreslam] gate: production median <= "
        f"{replay.CORESLAM_JAX_REF_ATE_M:.6f} + 2e-3, parity median <= "
        f"{max(replay.CORESLAM_PARITY_JAX_REF_ATES_M):.6f}; "
        f"{time.perf_counter() - t19:.1f} s")
    check(not cfails, f"CoreSLAM gate vs JAX: {cfails}")

    # ---- 20. the fleet's batch-wide early exit: K5 and the batched K3 -----
    t20 = time.perf_counter()
    x5cfg = fcfg.overlay({"matcher_mode": "onehot_bf16"})    # K5's table
    exit_err = {"K5": 0.0, "K3": 0.0}        # at bench's 1e-3: converged
    exit_err_fires = {"K5": 0.0, "K3": 0.0}  # at 0.3 px: stopped early
    exit_counts = {"K5": [], "K3": []}
    exit_levels = {"K5": [], "K3": []}

    def exit_case(name, maps_, cfg0, pts, val, hints, empty=None,
                  levels=False):
        """One batch-wide exit launch against its plain version: the same
        shared count on every robot; at bench's tolerance (converged
        matches) the pose, failures and residual within the kernel's bounds;
        with ``levels``, the per-level counts: some fixed launch whose
        iterations a level sum to the shared count gives the exit's answers
        bit for bit, and so does the plain version's fixed loop at those
        counts.  Returns the kernel's output and the |pose err| vs plain."""
        ok_ = match.match_batch(maps_, pts, val, hints, cfg0)
        op = match.match_batch_plain(maps_, pts, val, hints, cfg0)
        k, pl = ok_.cpu().numpy(), op.cpu().numpy()
        pose_tol, rtol = ((K3_POSE_TOL, K3_RESID_RTOL) if name == "K3"
                          else (2e-3, 0.05))
        check(np.isfinite(k).all(), f"{name} exit output not finite")
        check((k[:, 6] == k[0, 6]).all() and (k[:, 6] == pl[:, 6]).all(),
              f"{name} exit: iterations {np.unique(k[:, 6])} vs plain "
              f"{np.unique(pl[:, 6])}: not one shared count")
        err = float(np.abs(k[:, :3] - pl[:, :3]).max())
        check((k[:, 3] == pl[:, 3]).all(), f"{name} exit solve failures")
        if cfg0.early_exit_tol <= EXIT_TOL:
            exit_err[name] = max(exit_err[name], err)
            check(err <= pose_tol, f"{name} exit pose vs plain: {err} (tol "
                  f"{pose_tol})")
            res_k = k[:, 4] / np.maximum(k[:, 5], 1.0)
            res_p = pl[:, 4] / np.maximum(pl[:, 5], 1.0)
            check((np.abs(res_k - res_p) <= rtol * np.abs(res_p)).all(),
                  f"{name} exit residual vs plain (rtol {rtol})")
        if empty is not None:
            check(torch.equal(ok_[empty, :3], hints[empty]),
                  f"{name} exit: robot {empty} with no valid beam moved")
        if levels:
            its = cfg0.estimate_iterations[:cfg0.num_levels]
            for c in itertools.product(*(range(1, n + 1) for n in its)):
                if sum(c) != int(k[0, 6]):
                    continue
                fc = cfg0.overlay({"early_exit_tol": 0.0,
                                   "estimate_iterations": c})
                if torch.equal(match.match_batch(maps_, pts, val, hints, fc),
                               ok_):
                    check(torch.equal(match.match_batch_plain(
                        maps_, pts, val, hints, fc), op),
                          f"{name} exit: the plain version's exit differs "
                          f"from its fixed loop at {c}")
                    exit_levels[name].append(c)
                    break
            else:
                check(False, f"{name} exit tol {cfg0.early_exit_tol}: no "
                      f"fixed launch of {int(k[0, 6])} iterations gives its "
                      "answers")
        return ok_, err

    exit_before = launched("K5_exit", "K3_batch_exit")
    exit_calls = 0
    x_out = {}
    for name, maps_, c0 in (("K5", fmaps, x5cfg), ("K3", smaps, scfg)):
        for tol in (EXIT_TOL, EXIT_TOL_FIRES):
            c = c0.overlay({"early_exit_tol": tol})
            for off in EXIT_HINTS:
                hints = (ftruth + torch.tensor(off, device=dev)).contiguous()
                o, err = exit_case(name, maps_, c, fpts, fval, hints,
                                   empty_inst, levels=True)
                exit_calls += 1
                if tol == EXIT_TOL_FIRES:
                    exit_err_fires[name] = max(exit_err_fires[name], err)
                exit_counts[name].append(int(o[0, 6]))
                x_out[(name, tol, off)] = o
        check(min(exit_counts[name][len(EXIT_HINTS):]) < 15,
              f"{name}: the exit at {EXIT_TOL_FIRES} px never fired: "
              f"{exit_counts[name]}")
        # at a tolerance no step meets, the per-level launches and their
        # carried state give the single launch's answers bit for bit
        c = c0.overlay({"early_exit_tol": 1e-18})
        o = match.match_batch(maps_, fpts, fval, fhints, c)
        exit_calls += 1
        fixed = match.match_batch(maps_, fpts, fval, fhints, c0)
        check(torch.equal(o, fixed), f"{name}: the exit at 1e-18 differs from "
              f"the tol-0 launch ({int((o != fixed).sum())} numbers)")
    # B = 300: the fleet repeated; the batch's maximum is the fleet's, so
    # every row is its B = 64 twin's bit for bit
    rep300 = torch.arange(big, device=dev) % fb
    pts300, val300 = fpts[rep300].contiguous(), fval[rep300].contiguous()
    for name, maps_, c0 in (("K5", fmaps, x5cfg), ("K3", smaps, scfg)):
        m300 = maps_.view(fb, cells)[rep300].reshape(-1)
        for tol in (EXIT_TOL, EXIT_TOL_FIRES):
            c = c0.overlay({"early_exit_tol": tol})
            off = EXIT_HINTS[0]
            hints = (ftruth + torch.tensor(off, device=dev))[rep300]
            o, _ = exit_case(name, m300, c, pts300, val300,
                             hints.contiguous())
            exit_calls += 1
            check(torch.equal(o, x_out[(name, tol, off)][rep300]),
                  f"{name} exit B={big} tol {tol}: differs from B={fb}")
        del m300
    # B = 5000 on a 64/32/16-px pyramid (no co-residency limit): 64 robots
    # bootstrapped at that size, repeated
    small_px = {"map_size": 64, "map_resolution": 0.8}
    rep5k = torch.arange(huge, device=dev) % fb
    pts5k, val5k = fpts[rep5k].contiguous(), fval[rep5k].contiguous()
    exit_5k_ms = {}
    for name, c0 in (("K5", x5cfg), ("K3", scfg)):
        c64 = c0.overlay(small_px)
        st64 = replay.fleet_bootstrap(fleet.init_fleet(
            c64.overlay({"early_exit_tol": 0.0}), flog.traj[0], dev), fdlog,
            boot, c64.overlay({"early_exit_tol": 0.0}))
        m5k = st64.maps.view(fb, c64.total_cells)[rep5k].reshape(-1)
        h64 = (ftruth + torch.tensor(EXIT_HINTS[0], device=dev)).contiguous()
        for tol in (EXIT_TOL, EXIT_TOL_FIRES):
            c = c64.overlay({"early_exit_tol": tol})
            o64, _ = exit_case(name, st64.maps, c, fpts, fval, h64,
                               empty_inst, levels=True)
            o, _ = exit_case(name, m5k, c, pts5k, val5k,
                             h64[rep5k].contiguous())
            exit_calls += 2
            check(torch.equal(o, o64[rep5k]),
                  f"{name} exit B={huge} tol {tol}: differs from B={fb}")
        h5k = h64[rep5k].contiguous()
        timed0 = launched("K5_exit", "K3_batch_exit")   # timing: not counted
        exit_5k_ms[name] = {
            "exit": graph_ms(torch, lambda c=c64.overlay(
                {"early_exit_tol": EXIT_TOL_FIRES}): match.match_batch(
                    m5k, pts5k, val5k, h5k, c), REPS_PLAIN),
            "tol0": graph_ms(torch, lambda: match.match_batch(
                m5k, pts5k, val5k, h5k, c64), REPS_PLAIN)}
        exit_before += launched("K5_exit", "K3_batch_exit") - timed0
        del m5k, st64
    torch.cuda.synchronize()
    exits = launched("K5_exit", "K3_batch_exit") - exit_before
    check(exits == exit_calls, f"exit launch count rose by {exits}, want "
          f"{exit_calls}")
    # device times at B = 64 (CUDA graph) beside the tol-0 launch
    exit_ms, exit_plain_ms, exit_bound = {}, {}, {}
    for name, maps_, c0 in (("K5", fmaps, x5cfg), ("K3", smaps, scfg)):
        for tol in (EXIT_TOL, EXIT_TOL_FIRES):
            c = c0.overlay({"early_exit_tol": tol})
            exit_ms[(name, tol)] = graph_ms(torch, lambda c=c, m=maps_:
                                            match.match_batch(
                                                m, fpts, fval, fhints, c),
                                            REPS_KERNEL)
            exit_plain_ms[(name, tol)] = graph_ms(
                torch, lambda c=c, m=maps_: match.match_batch_plain(
                    m, fpts, fval, fhints, c), REPS_PLAIN)
            its = int(match.match_batch_plain(maps_, fpts, fval, fhints,
                                              c)[0, 6])
            exit_bound[(name, tol)] = bound(*match_work(
                maps_, fpts, fval, fhints, c, its))
    say(f"[exit] the fleet's batch-wide exit, K5 (onehot_bf16 table) and the "
        f"batched K3, {fb} robots x {len(EXIT_HINTS)} hints x tol "
        f"({EXIT_TOL}, {EXIT_TOL_FIRES}) agree with the plain version: one "
        f"shared count per batch, equal to the plain version's (K5 "
        f"{exit_counts['K5']}, K3 {exit_counts['K3']}; 15 without the exit), "
        f"each the answers of a fixed launch at per-level counts (K5 "
        f"{exit_levels['K5']}, K3 {exit_levels['K3']}) bit for bit, as the "
        f"plain version's; at {EXIT_TOL} max |pose err| K5 "
        f"{exit_err['K5']:.3g} (tol 2e-3), K3 {exit_err['K3']:.3g} (tol "
        f"{K3_POSE_TOL}), at {EXIT_TOL_FIRES} (stopped short of "
        f"convergence, reported) K5 {exit_err_fires['K5']:.3g}, K3 "
        f"{exit_err_fires['K3']:.3g}; equal solve failures, "
        f"robot {empty_inst} at its hint; at tol 1e-18 equal to the tol-0 "
        f"launch bit for bit; B = {big} and B = {huge} ({small_px['map_size']}"
        f"/32/16 px) equal their B = {fb} twins bit for bit; "
        f"{exit_calls} exit launches; device ms/batch (CUDA graph) "
        + ", ".join(f"{n} tol {t}: {v:.4f} vs plain "
                    f"{exit_plain_ms[(n, t)]:.4f} (bound "
                    f"{exit_bound[(n, t)][0]:.6f} by "
                    f"{exit_bound[(n, t)][1]})"
                    for (n, t), v in exit_ms.items())
        + f"; tol 0: K5 {k5_ms:.4f}, K3 {k3b_ms:.4f}; B = {huge}: "
        + ", ".join(f"{n} exit {v['exit']:.4f} vs tol-0 {v['tol0']:.4f}"
                    for n, v in exit_5k_ms.items())
        + f"; {time.perf_counter() - t20:.1f} s")

    # ---- 21. the bench's other fleet rows and the exit rows, end to end ----
    t21 = time.perf_counter()
    row_names = ("sub4", "sub4_onehot", "sub4_onehot_cap8",
                 "sub4_onehot_cap32", "sub1_exit", "sub4_onehot_exit")
    rows = {}
    for rname in row_names:
        rc = replay.FLEET_MODES[rname]()
        _build.reset_launches()
        rst = replay.fleet_bootstrap(fleet.init_fleet(rc, flog.traj[0], dev),
                                     fdlog, boot, rc)
        st = rst._replace(maps=rst.maps.clone())
        rposes, riters, rupd = [], [], []
        for t in range(boot, nb):
            st, info = fleet.update_fleet(st, fdlog.points[t], fdlog.valid[t],
                                          rc)
            rposes.append(st.match_pose)
            riters.append(info.gn_iterations)
            rupd.append(info.map_updated)
        torch.cuda.synchronize()
        rl = _build.kernel_launches()
        want = dict.fromkeys(rl, 0)
        mkey = "K3_batch" if match.table_f32(rc) else "K5"
        if rc.early_exit_tol > 0.0:
            mkey += "_exit"
        want.update({mkey: nb, "K4_batch": nb})
        check(rl == want, f"launches in the {rname} fleet flow: {rl}, want "
              f"{want}")
        rp = torch.stack(rposes).cpu().numpy()
        check(rp.shape == (nt, fb, 3) and np.isfinite(rp).all(),
              f"{rname} poses")
        its = torch.stack(riters).cpu().numpy()
        check((its == its[:, :1]).all(), f"{rname}: iterations not shared")
        upd = torch.stack(rupd).cpu().numpy()
        if rc.fleet_update_capacity < fb:
            check(upd.sum(axis=1).max() <= rc.fleet_update_capacity,
                  f"{rname}: more than {rc.fleet_update_capacity} updates in "
                  "a batch-scan")
        rate = []
        for _ in range(TIMED_REPLAYS):
            t = time.perf_counter()
            fleet.replay_fleet(rst, fdlog.points[boot:], fdlog.valid[boot:],
                               rc)
            torch.cuda.synchronize()
            rate.append(iscans / (time.perf_counter() - t))
        got = (*replay.fleet_ate_of(rp, flog.traj[boot:]),
               int(its[:, 0].sum()))
        rows[rname] = {"ate_m": got[0], "max_err_m": got[1],
                       "ate_median_m": got[2], "gn_iterations": got[3],
                       "map_updates": int(upd.sum()),
                       "instance_scans_per_s": max(rate),
                       "launches": {k: v for k, v in rl.items() if v},
                       "fails": replay.fleet_row_gate(rname, got)}
    headline_rows = {n: (r["instance_scans_per_s"], r["ate_m"])
                     for n, r in rows.items()}
    headline_rows["sub1"] = (iscans / ts_kernel, sate)
    headline_rows["sub4_pallas_dense"] = (iscans / tf_kernel, fate)
    pick, hbound = replay.fleet_headline(headline_rows)
    for rname, r in rows.items():
        ref = replay.FLEET_ROW_JAX_REFS[rname]
        say(f"[rows] {rname}: RMS ATE {r['ate_m']:.6f} m (JAX {ref[0]:.6f}), "
            f"max err {r['max_err_m']:.4f} (JAX {ref[1]:.4f}), median "
            f"instance ATE {r['ate_median_m']:.6f} (JAX {ref[2]:.6f}), GN "
            f"iterations {r['gn_iterations']} (JAX {ref[3]}), map updates "
            f"{r['map_updates']}, launches {r['launches']} (all others 0); "
            f"{r['instance_scans_per_s']:.1f} instance-scans/s (best of "
            f"{TIMED_REPLAYS})"
            + (f"; FAILS {r['fails']}" if r["fails"] else ""))
    say(f"[rows] bench.py:540-543's headline rule (fastest row with RMS ATE "
        f"<= 2 x sub1's = {hbound:.6f} m): {pick} at "
        f"{headline_rows[pick][0]:.1f} instance-scans/s; rows "
        + ", ".join(f"{n} {v[0]:.1f}/s {v[1]:.6f} m"
                    for n, v in headline_rows.items())
        + f"; {time.perf_counter() - t21:.1f} s")
    for rname, r in rows.items():
        check(not r["fails"], f"{rname} fleet row vs JAX: {r['fails']}")

    # ---- 22. the particle layer's ops: the card against the CPU ------------
    t22 = time.perf_counter()
    e_ccfg, e_pcfg = replay.PARTICLE_MODES["exact"]
    pst = particle.init(e_ccfg, e_pcfg, cdl.traj[0], seed=1, device=dev)
    for t in range(40):
        pst, _ = particle.update(pst, Scan(cdl.points[t], cdl.valid[t], zero3),
                                 pst.pose, e_ccfg, e_pcfg)
    parrays = convert.particle_state_to_numpy(pst)
    pscan = {"cuda": Scan(cdl.points[40], cdl.valid[40], zero3),
             "cpu": Scan(cdl.points[40].cpu(), cdl.valid[40].cpu(),
                         zero3.cpu())}
    pdiff, pus = {}, {}
    for pmode, (ccfg_m, pcfg_m) in replay.PARTICLE_MODES.items():
        states = {d: convert.particle_state_from_numpy(**parrays, device=d)
                  for d in ("cuda", "cpu")}
        noise_cpu = particle.draw(states["cpu"]._replace(
            generator=torch.Generator().manual_seed(7)), ccfg_m, pcfg_m)
        noise = {"cpu": noise_cpu, "cuda": particle.ParticleNoise(
            *(x.to(dev) for x in noise_cpu))}
        outs = {d: particle.step(states[d], pscan[d], states[d].pose,
                                 noise[d], ccfg_m, pcfg_m) for d in states}
        (gs, gi), (cs, ci) = outs["cuda"], outs["cpu"]
        g_np, c_np = (convert.particle_state_to_numpy(x) for x in (gs, cs))
        check(all(np.isfinite(g_np[k]).all() for k in ("particles", "pose")),
              f"particle {pmode}: not finite on the card")
        check(bool(gi.resampled) == bool(ci.resampled),
              f"particle {pmode}: the card and the CPU resample differently")
        pdiff[pmode] = {
            "particles": int((np.abs(g_np["particles"] - c_np["particles"])
                              .max(axis=1) > 0).sum()),
            "scores": int((g_np["scores"] != c_np["scores"]).sum()),
            "hole_cells": int((g_np["hole_map"] != c_np["hole_map"]).sum()),
            "obstacle_cells": int((g_np["obstacle_map"]
                                   != c_np["obstacle_map"]).sum()),
            "pose_err": float(np.abs(g_np["pose"] - c_np["pose"]).max()),
            "ess_rel": float(abs(float(gi.ess) - float(ci.ess))
                             / float(ci.ess))}
        stc = states["cuda"]
        pus[f"step_{pmode}"] = op_us(lambda s=stc, n=noise["cuda"], c=ccfg_m,
                                     q=pcfg_m: particle.step(
                                         s, pscan["cuda"], s.pose, n, c, q))
    stc = convert.particle_state_from_numpy(**parrays, device=dev)
    sc = pscan["cuda"]
    pus["score_8192x400"] = op_us(lambda: particle._score(
        stc, e_ccfg, sc.points, sc.valid, stc.particles))
    ref_poses = stc.particles[:e_pcfg.top_k * e_pcfg.refine_candidates]
    pus["refine_4096x400"] = op_us(lambda: particle._score(
        stc, e_ccfg, sc.points, sc.valid, ref_poses))
    g_ccfg = replay.PARTICLE_MODES["grid_dense"][0]
    pus["grid"] = op_us(lambda: particle._grid_score(
        stc, g_ccfg, sc, stc.pose, stc.particles))
    u0 = torch.full((), 0.37, device=dev)
    pus["resample"] = op_us(lambda: particle.resample(
        stc.particles, stc.scores, sc.valid, u0, e_pcfg.resample_ess_frac))
    say(f"[particle ops] one step of each mode at {e_pcfg.num_particles} "
        f"particles from the state after 40 exact scans, one set of draws, "
        f"the card against the CPU: differing "
        + "; ".join(f"{m} {d}" for m, d in pdiff.items())
        + "; the same resample decision in every mode; device us "
        + ", ".join(f"{k} {v:.1f}" for k, v in pus.items())
        + f"; {time.perf_counter() - t22:.1f} s")

    # ---- 23. the particle replays: exact and grid_dense under 9 seeds -----
    t23 = time.perf_counter()
    cn = cdl.points.shape[0]
    prun = {}
    for pmode in ("exact", "grid_dense", "sub4", "grid", "grid_small"):
        ccfg_m, pcfg_m = replay.PARTICLE_MODES[pmode]
        seeds = (replay.PARTICLE_SEEDS if pmode in ("exact", "grid_dense")
                 else replay.PARTICLE_SEEDS[:1])
        ms, secs = [], []
        for i, seed in enumerate(seeds):
            torch.cuda.synchronize()
            if i == 0:    # no host read in a replay: syncs raise here
                torch.cuda.set_sync_debug_mode("error")
            tt = time.perf_counter()
            try:
                _, pout = replay.particle_replay(cdl, ccfg_m, pcfg_m, seed)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - tt)
            check(bool(torch.isfinite(pout.poses).all()),
                  f"particle {pmode} seed {seed}: poses not finite")
            ms.append(replay.particle_metrics(pout, clog.traj))
            if i == 0:
                first = pout.poses
        # a replay repeats bit for bit: the draws, the scores, the exact CDF
        _, again = replay.particle_replay(cdl, ccfg_m, pcfg_m, seeds[0])
        check(torch.equal(again.poses, first), f"particle {pmode}: a second "
              f"replay of seed {seeds[0]} gave other poses")
        ates = [m["ate_m"] for m in ms]
        prun[pmode] = {"ates_m": ates, "median_ate_m": float(np.median(ates)),
                       "max_err_m": [m["max_err_m"] for m in ms],
                       "resamples": [m["resamples"] for m in ms],
                       "scans_per_s": cn / min(secs[1:] or secs)}
    pfails = replay.particle_gate(prun["exact"]["ates_m"],
                                  prun["grid_dense"]["ates_m"])
    for pmode, r in prun.items():
        ref = {"exact": replay.PARTICLE_JAX_REF_ATES_M,
               "grid_dense": replay.PARTICLE_GRID_DENSE_JAX_REF_ATES_M}.get(
                   pmode)
        say(f"[particle] {pmode} replays of {cn} scans at "
            f"{replay.PARTICLE_MODES[pmode][1].num_particles} particles, "
            f"seeds {list(replay.PARTICLE_SEEDS[:len(r['ates_m'])])}: ATE "
            + " ".join(f"{x:.6f}" for x in r["ates_m"])
            + f" m (median {r['median_ate_m']:.6f}"
            + (f"; JAX median {float(np.median(ref)):.6f}, worst "
               f"{max(ref):.6f}" if ref else "")
            + f"), max err {' '.join(f'{x:.4f}' for x in r['max_err_m'])}, "
            f"resamples {r['resamples']}, no host read in a replay (sync "
            f"debug mode 'error'), a repeat of the first replay bit for bit, "
            f"{r['scans_per_s']:.1f} scans/s")
    say(f"[particle] gate: exact median {prun['exact']['median_ate_m']:.6f} "
        f"<= {max(replay.PARTICLE_JAX_REF_ATES_M):.6f}, grid_dense median "
        f"{prun['grid_dense']['median_ate_m']:.6f} <= "
        f"{max(replay.PARTICLE_GRID_DENSE_JAX_REF_ATES_M):.6f} and <= exact "
        f"+ 0.02 (bench.py:810); {time.perf_counter() - t23:.1f} s")
    check(not pfails, f"particle gate vs JAX: {pfails}")

    # ---- 24. K3 + K4 (+ K1) at the simulator's pyramid and 181 beams -----
    t24 = time.perf_counter()
    from slamnet_tpu_torch import compat, hostio
    from slamnet_tpu_torch.core import debug
    from slamnet_tpu_torch.core.config import HectorConfig
    from slamnet_tpu_torch.io import checkpoint, interactive, live
    from slamnet_tpu_torch.io import datasets as io_datasets
    from slamnet_tpu_torch.io import export as io_export
    from slamnet_tpu_torch.io import metrics as io_metrics

    scfg = HectorConfig()        # the simulator's: 4 levels, 7/4/4/4
    check(scfg.level_sizes == (400, 200, 100, 50)
          and scfg.matcher_mode == "gather" and not scfg.dense_free_fill,
          f"HectorConfig() is not the simulator's pyramid: {scfg}")
    sst = hector.init(scfg, truth, dev)
    for _ in range(6):
        sst, _ = hector.update(sst, sim_scan(truth), truth, scfg, True)
    smaps = sst.maps
    sscan = sim_scan(truth)
    guard = {"xy_step_clamp_px": 10.0, "gn_damping": 0.1,
             "match_subsample": 4}
    l4_err = {"K3": 0.0, "K3_res": 0.0, "K1": 0.0}
    l4_cases = [(scfg, off) for off in EXIT_HINTS] + [
        (scfg.overlay(guard), (0.15, 0.1, -0.03))]
    s1cfg = scfg.overlay({"matcher_mode": "onehot_bf16"})     # K1's table
    for i, (c, off) in enumerate(l4_cases):
        hint = truth + torch.tensor(off, device=dev)
        ok_ = match.match(smaps, sscan.points, sscan.valid, hint, c)
        op = match.match_plain(smaps, sscan.points, sscan.valid, hint, c)
        c1 = c.overlay({"matcher_mode": "onehot_bf16"})
        o1 = match.match(smaps, sscan.points, sscan.valid, hint, c1)
        p1 = match.match_plain(smaps, sscan.points, sscan.valid, hint, c1)
        ok_, op, o1, p1 = (x.cpu().numpy() for x in (ok_, op, o1, p1))
        err, res, _, _ = k3_readings(ok_[None], op[None], op[None])
        err1 = float(np.abs(o1[:3] - p1[:3]).max())
        l4_err["K3"], l4_err["K3_res"] = max(l4_err["K3"], err), max(
            l4_err["K3_res"], res)
        l4_err["K1"] = max(l4_err["K1"], err1)
        check(np.isfinite(ok_).all() and err <= K3_POSE_TOL
              and res <= K3_RESID_RTOL and ok_[3] == op[3],
              f"K3 at 4 levels, case {i}: {ok_[:6]} vs plain {op[:6]} (pose "
              f"err {err}, residual rel err {res})")
        check(np.linalg.norm(ok_[:2] - truth[:2].cpu().numpy()) < 0.08,
              f"K3 at 4 levels did not converge: {ok_[:3]}")
        tol1 = 3e-3 if c.match_subsample > 1 else 2e-3
        r1k, r1p = o1[4] / max(o1[5], 1.0), p1[4] / max(p1[5], 1.0)
        check(np.isfinite(o1).all() and err1 <= tol1 and o1[3] == p1[3]
              and abs(r1k - r1p) <= 0.05 * abs(r1p),
              f"K1 at 4 levels, case {i}: {o1[:6]} vs plain {p1[:6]}")
    hint = torch.tensor([20.0, 20.0, 0.5], device=dev)
    for c in (scfg, s1cfg):
        oe = match.match(smaps, sscan.points, empty, hint, c)
        check(torch.equal(oe[:3], hint),
              f"{c.matcher_mode} at 4 levels, empty scan: {oe[:3]} != hint")
    rand4 = torch.as_tensor(np.random.default_rng(7).uniform(
        -8.0, 60.0, scfg.total_cells).astype(np.float32), device=dev)
    l4_cells = {}
    for name, base in (("simulator", smaps), ("random", rand4)):
        mk = line_case(f"K4 at 4 levels, {name} maps", base, k2_scan.points,
                       k2_scan.valid, pose, yes, scfg)
        for level in range(4):
            off, w = scfg.level_offsets[level], scfg.level_sizes[level]
            d = mk[off:off + w * w] - base[off:off + w * w]
            check(bool((d < 0).any()) and bool((d > 0).any()),
                  f"K4 at 4 levels, {name} level {level}: no free or no "
                  "occupied cell")
        l4_cells[name] = int((mk != base).sum())
        mz = line_case(f"K4 at 4 levels, {name} gated", base, k2_scan.points,
                       k2_scan.valid, pose, no, scfg)
        check(torch.equal(mz, base), f"K4 at 4 levels ({name}): do_update=0 "
              "changed the maps")
    # the dataset pyramid (3 levels, 40 m over 400 px, the robust guards)
    # fed 181-beam scans of adversarial_180.clf: maps from its first 60
    # scans' replay; scans inside the loop, the one nearest the map's edge,
    # and that scan with the robot 1 m from the map's edge (beams leave it)
    dhc = replay.dataset_config(robust=True)[0]
    d60 = replay.load_carmen(replay.ADVERSARIAL_LOG, dev, max_scans=60)
    dst, _, _ = replay.carmen_replay(d60, dhc, None)
    dmaps = dst.maps
    dfull = io_datasets.read_carmen(str(replay.ADVERSARIAL_LOG))
    dtruth = dfull.truth.copy()
    dtruth[:, :2] -= d60.offset[None, :]
    edge = np.minimum(dtruth[:, :2], 40.0 - dtruth[:, :2]).min(axis=1)
    t_edge = int(np.argmin(edge[60:])) + 60
    dpts = torch.as_tensor(io_datasets.log_points(dfull), device=dev)
    dval = torch.as_tensor(dfull.valid, device=dev)
    d_err = {"K3": 0.0, "K3_res": 0.0}
    d_cells = {}
    for where, t, robot in (("inside", 60, None), ("inside", 61, None),
                            ("nearest the edge", t_edge, None),
                            ("1 m from the edge", t_edge,
                             (1.0, float(dtruth[t_edge, 1]),
                              float(dtruth[t_edge, 2])))):
        at = torch.tensor(dtruth[t] if robot is None else robot, device=dev)
        hint = at + torch.tensor((0.08, -0.06, 0.02), device=dev)
        ok_ = match.match(dmaps, dpts[t], dval[t], hint, dhc)
        op = match.match_plain(dmaps, dpts[t], dval[t], hint, dhc)
        ok_, op = ok_.cpu().numpy(), op.cpu().numpy()
        err, res, _, _ = k3_readings(ok_[None], op[None], op[None])
        d_err["K3"], d_err["K3_res"] = max(d_err["K3"], err), max(
            d_err["K3_res"], res)
        check(np.isfinite(ok_).all() and err <= K3_POSE_TOL
              and res <= K3_RESID_RTOL and ok_[3] == op[3]
              and ok_[5] == op[5],
              f"K3 at 181 beams, robot {where} (scan {t}): {ok_[:6]} vs "
              f"plain {op[:6]}")
        mk = line_case(f"K4 at 181 beams, robot {where} (scan {t})", dmaps,
                       dpts[t], dval[t], at, yes, dhc)
        d_cells[f"{where} {t}"] = int((mk != dmaps).sum())
    # the last case's beams leave the map: endpoints at x < 0
    th = float(dtruth[t_edge, 2])
    ex = 1.0 + (dpts[t_edge, :, 0] * math.cos(th)
                - dpts[t_edge, :, 1] * math.sin(th))
    d_off = int(((ex < 0) & dval[t_edge]).sum())
    check(d_off > 0, "no beam of the edge case leaves the map")
    gt4 = smaps.clone()
    gtd = dmaps.clone()
    h4 = truth + torch.tensor(EXIT_HINTS[0], device=dev)
    hd = torch.tensor(dtruth[61], device=dev) + torch.tensor(
        (0.08, -0.06, 0.02), device=dev)
    l4_ms = {
        "K3": (lambda: match.match(smaps, sscan.points, sscan.valid, h4, scfg),
               lambda: match.match_plain(smaps, sscan.points, sscan.valid, h4,
                                         scfg),
               match_work(smaps, sscan.points[None], sscan.valid[None],
                          h4[None], scfg)),
        "K1": (lambda: match.match(smaps, sscan.points, sscan.valid, h4,
                                   s1cfg),
               lambda: match.match_plain(smaps, sscan.points, sscan.valid, h4,
                                         s1cfg),
               match_work(smaps, sscan.points[None], sscan.valid[None],
                          h4[None], s1cfg)),
        "K4": (lambda: line_ops.update_maps_line(
            gt4, k2_scan.points, k2_scan.valid, pose, zero3, yes, scfg),
            lambda: line_ops.update_maps_line_plain(
                gt4, k2_scan.points, k2_scan.valid, pose, zero3, yes, scfg),
            line_work(l4_cells["simulator"], 400, 1, 1)),
        "K3_181": (lambda: match.match(dmaps, dpts[61], dval[61], hd, dhc),
                   lambda: match.match_plain(dmaps, dpts[61], dval[61], hd,
                                             dhc),
                   match_work(dmaps, dpts[61][None], dval[61][None], hd[None],
                              dhc)),
        "K4_181": (lambda: line_ops.update_maps_line(
            gtd, dpts[61], dval[61], hd, zero3, yes, dhc),
            lambda: line_ops.update_maps_line_plain(
                gtd, dpts[61], dval[61], hd, zero3, yes, dhc),
            line_work(d_cells["inside 61"], 181, 1, 1))}
    l4_ms = {k: (graph_ms(torch, f, REPS_KERNEL), graph_ms(torch, p, REPS_PLAIN),
                 bound(*w)) for k, (f, p, w) in l4_ms.items()}
    del gt4, gtd
    say(f"[sim pyramid] {scfg.level_sizes} px, 7/4/4/4: K3 equals its plain "
        f"version within |pose err| {l4_err['K3']:.3g} (tol {K3_POSE_TOL}), "
        f"residual rel err {l4_err['K3_res']:.3g} over {len(l4_cases)} hints "
        f"(guard config included); K1 (onehot_bf16) |pose err| "
        f"{l4_err['K1']:.3g} (tol 2e-3/3e-3); the empty scan returns the "
        f"hint; K4 bit for bit on all 4 levels ({l4_cells} cells changed), "
        f"gated maps untouched")
    say(f"[181 beams] adversarial_180.clf on the dataset pyramid "
        f"{dhc.level_sizes} px: K3 |pose err| {d_err['K3']:.3g}, residual "
        f"rel err {d_err['K3_res']:.3g}; K4 bit for bit ({d_cells} cells "
        f"changed; scan {t_edge} is {edge[t_edge]:.2f} m from the edge; "
        f"{d_off} beams end off the map 1 m from it)")
    say("[sim pyramid] device ms (CUDA graph): "
        + ", ".join(f"{k} {v[0]:.4f} vs plain {v[1]:.4f} (bound "
                    f"{v[2][0]:.6f} by {v[2][1]})" for k, v in l4_ms.items())
        + f"; {time.perf_counter() - t24:.1f} s")

    # ---- 25. the dataset replays of the checked-in CARMEN logs ------------
    t25 = time.perf_counter()
    ds_runs = {}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        for dname, dpath, robust in (
                ("sim_loop", replay.SIM_LOOP_LOG, False),
                ("adversarial", replay.ADVERSARIAL_LOG, True)):
            nat = hostio.read_carmen_native(str(dpath))
            py = io_datasets.read_carmen(str(dpath))
            check(all(np.array_equal(getattr(nat, f), getattr(py, f))
                      for f in ("ranges", "valid", "odometry", "angles",
                                "timestamps"))
                  and nat.max_range == py.max_range
                  and (nat.truth is None) == (py.truth is None)
                  and (nat.truth is None
                       or np.array_equal(nat.truth, py.truth)),
                  f"{dname}: the native parser's log differs from the Python "
                  "reader's")
            data = replay.load_carmen(dpath, dev,
                                      truth=replay.sim_loop_truth(120))
            hcd, ccd = replay.dataset_config(robust)
            tn = data.points.shape[0]
            _build.reset_launches()
            torch.cuda.synchronize()
            if dname == "sim_loop":   # no host read in a replay: syncs raise
                torch.cuda.set_sync_debug_mode("error")
            tt = time.perf_counter()
            try:
                hstd, cstd, dout = replay.carmen_replay(data, hcd, ccd)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            both_s = time.perf_counter() - tt
            dlaunch = _build.kernel_launches()
            want = dict.fromkeys(dlaunch, 0)
            want.update(K3=tn, K4=tn)
            check(dlaunch == want, f"launches in the {dname} replay: "
                  f"{dlaunch}, want {want}")
            tt = time.perf_counter()
            _, _, hout = replay.carmen_replay(data, hcd, None)
            torch.cuda.synchronize()
            hector_s = time.perf_counter() - tt
            check(torch.equal(hout.hector, dout.hector),
                  f"{dname}: Hector alone gave another track")
            dm = replay.dataset_metrics(data, dout)
            c_ates, core_s = [dm["coreslam_ate_m"]], []
            for k in replay.CORESLAM_NUDGES[1:]:
                tt = time.perf_counter()
                _, _, cout = replay.carmen_replay(data, None, ccd, nudge=k)
                torch.cuda.synchronize()
                core_s.append(time.perf_counter() - tt)
                c_ates.append(replay.ate_of(cout.coreslam.cpu().numpy(),
                                            data.truth)[0])
            htrack = dout.hector.cpu().numpy()
            ctrack = dout.coreslam.cpu().numpy()
            check(np.isfinite(htrack).all() and np.isfinite(ctrack).all(),
                  f"{dname}: tracks not finite")
            dfails = replay.dataset_gate(dname, dm, htrack, c_ates)
            ref_err = None
            if dname == "sim_loop":
                ref_err = float(np.abs(htrack[:, :2] - replay.
                                       dataset_reference_track(dname)[:, :2])
                                .max())
            # the example's outputs: a track JSONL, occupancy and hole PNGs
            with open(os.path.join(out_dir, f"{dname}_track.jsonl"), "w") as f:
                for t in range(tn):
                    f.write(json.dumps({
                        "t": t, "odom": [round(float(x), 4)
                                         for x in data.odo[t]],
                        "coreslam": [round(float(x), 4) for x in ctrack[t]],
                        "hector": [round(float(x), 4)
                                   for x in htrack[t]]}) + "\n")
            occ = live._png_bytes(np.flipud(io_export.occupancy_bitmap(
                hector.level_view(hstd.maps, hcd, 0).reshape(-1),
                hcd.map_size)))
            hole = live._png_bytes(np.flipud(
                (cstd.hole_map.reshape(ccd.hole_map_size, -1).cpu().numpy()
                 .astype(np.uint16) >> 8).astype(np.uint8)))
            for nm, png in (("occupancy", occ), ("hole_map", hole)):
                with open(os.path.join(out_dir, f"{dname}_{nm}.png"),
                          "wb") as f:
                    f.write(png)
                check(png[:8] == b"\x89PNG\r\n\x1a\n", f"{dname} {nm} PNG")
            lines = sum(1 for _ in open(os.path.join(
                out_dir, f"{dname}_track.jsonl")))
            check(lines == tn, f"{dname}: {lines} track lines for {tn} scans")
            ds_runs[dname] = {
                **dm, "scans": tn, "beams": int(data.points.shape[1]),
                "coreslam_ates_m": c_ates,
                "coreslam_median_ate_m": float(np.median(c_ates)),
                "hector_max_dev_from_jax_m": ref_err,
                "launches": {k: v for k, v in dlaunch.items() if v},
                "scans_per_s": tn / both_s,
                "hector_scans_per_s": tn / hector_s,
                "coreslam_scans_per_s": tn / min(core_s),
                "png_bytes": {"occupancy": len(occ), "hole_map": len(hole)}}
            ref = replay.DATASET_JAX_REFS[dname]
            say(f"[dataset] {dname} ({tn} scans x {data.points.shape[1]} "
                f"beams, native parser = Python reader bit for bit): Hector "
                f"RMS / max ATE {dm['hector_ate_m']:.6f} / "
                f"{dm['hector_max_err_m']:.6f} m (JAX {ref['hector_ate_m']:.6f}"
                f" / {ref['hector_max_err_m']:.6f}"
                + (f"; track within {ref_err:.3g} m of JAX's at every scan"
                   if ref_err is not None else "")
                + f"), odometry {dm['odometry_ate_m']:.6f}; CoreSLAM ATE "
                + " ".join(f"{x:.6f}" for x in c_ates)
                + f" m over {len(c_ates)} starts (median "
                f"{np.median(c_ates):.6f}; JAX {ref['coreslam_ate_m'][0]:.6f})"
                f"; launches {ds_runs[dname]['launches']}, no host read"
                + (" (sync debug mode 'error')" if dname == "sim_loop" else "")
                + f"; scans/s both {tn / both_s:.1f}, Hector "
                f"{tn / hector_s:.1f}, CoreSLAM {tn / min(core_s):.1f}; track "
                f"JSONL + PNGs ({len(occ)} + {len(hole)} B) written")
            check(not dfails, f"{dname} gate vs JAX: {dfails}")
            ds_runs[dname]["states"] = (hstd, cstd)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    say(f"[dataset] {time.perf_counter() - t25:.1f} s")

    # ---- 26. the reference API, checkpoints, debug, trace -----------------
    t26 = time.perf_counter()
    procs = {}
    for mode in ("gather", "onehot_bf16"):
        proc = compat.HectorSLAMProcessor(0.1, 400, (20.0, 20.0, 0.0), 4, 4,
                                          estimate_iterations=(7, 4, 4, 4),
                                          matcher_mode=mode, device=dev)
        # the processor's own motion gates (0.3 m, 0.13 rad), the
        # simulator's pyramid
        check(proc.cfg == scfg.overlay({
            "matcher_mode": mode, "min_distance_diff_for_map_update": 0.3,
            "min_angle_diff_for_map_update": 0.13}),
            f"the processor's config is not the simulator's: {proc.cfg}")
        _build.reset_launches()
        ptrack, pupd = [], 0
        tt = time.perf_counter()
        for t in range(dlog.points.shape[0]):
            sc = Scan(dlog.points[t], dlog.valid[t], zero3)
            if t < log.bootstrap:
                proc.Update(sc, dlog.traj[t], map_without_matching=True)
            else:
                pupd += proc.Update(sc)
                ptrack.append(proc.state.match_pose)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tt
        plaunch = _build.kernel_launches()
        want = dict.fromkeys(plaunch, 0)
        want.update({"K3" if mode == "gather" else "K1":
                     n + log.bootstrap, "K4": n + log.bootstrap})
        check(plaunch == want, f"launches of the {mode} processor: "
              f"{plaunch}, want {want}")
        ptrack = torch.stack(ptrack)
        pate, pmax = replay.ate_of(ptrack.cpu().numpy(), log.traj[log.bootstrap:])
        procs[mode] = {"proc": proc, "track": ptrack, "ate_m": pate,
                       "max_err_m": pmax, "map_updates": pupd,
                       "launches": {k: v for k, v in plaunch.items() if v},
                       "scans_per_s": dlog.points.shape[0] / secs}
    proc = procs["gather"]["proc"]
    dst_ = hector.init(proc.cfg, truth, dev)
    direct = []
    for t in range(dlog.points.shape[0]):
        sc = Scan(dlog.points[t], dlog.valid[t], zero3)
        force = t < log.bootstrap
        dst_, _ = hector.update(dst_, sc, dlog.traj[t] if force
                                else dst_.match_pose, proc.cfg, force)
        if not force:
            direct.append(dst_.match_pose)
    check(torch.equal(torch.stack(direct), procs["gather"]["track"])
          and torch.equal(dst_.maps, proc.state.maps),
          "the processor's track or maps differ from hector.update's")
    check(procs["gather"]["ate_m"] <= replay.COMPAT_JAX_REF_ATE_M + 1e-4,
          f"processor ATE {procs['gather']['ate_m']} > JAX's "
          f"{replay.COMPAT_JAX_REF_ATE_M} + 1e-4")
    check(procs["onehot_bf16"]["max_err_m"] <= 0.05,
          f"onehot_bf16 processor max error {procs['onehot_bf16']['max_err_m']}")
    reps = proc.MapRep
    check([r.shape for r in reps] == [(s, s) for s in scfg.level_sizes],
          f"MapRep shapes {[r.shape for r in reps]}")
    bvals = set(np.unique(proc.GetBitmapData(0)).tolist())
    check(bvals <= {0, 127, 254} and len(bvals) == 3,
          f"GetBitmapData values {bvals}")
    check(proc.MatchTiming.ms > 0.0 and proc.UpdateTiming.ms > 0.0,
          "processor timings not taken")
    # the simulator's constructor (MainWindow.xaml.cs:69-72)
    cproc = compat.CoreSLAMProcessor(40.0, 256, 64, log.traj[0], 0.1,
                                     math.pi / 18, 1024, 4, hole_width=2.0,
                                     device=dev)
    ang_t = torch.as_tensor(log.angles, device=dev)
    rad_t = torch.as_tensor(log.radii, device=dev)
    val_t = torch.as_tensor(log.valid, device=dev)
    from slamnet_tpu_torch.core.scan import SegmentScan
    cposes = []
    for t in range(60):
        cproc.Update(SegmentScan.single(ang_t, rad_t[t], val_t[t],
                                        dlog.traj[t]))
        cposes.append(cproc.state.pose)
    cate = replay.ate_of(torch.stack(cposes).cpu().numpy(), log.traj[:60])
    check(np.isfinite(cate[0]) and cate[1] < 0.5,
          f"CoreSLAMProcessor over 60 scans: ATE {cate}")
    check(bool((cproc.HoleMap != coreslam.HOLE_INIT).any()),
          "CoreSLAMProcessor left the hole map at its initial value")
    cproc.Reset()
    check(bool((cproc.HoleMap == coreslam.HOLE_INIT).all())
          and np.array_equal(cproc.Pose, log.traj[0]),
          "CoreSLAMProcessor.Reset did not restore HOLE_INIT and the start")
    # checkpoints: the fixed replay saved at scan 256 and resumed in a fresh
    # state; a CoreSLAM parity replay saved at scan 200 (its generator's
    # state in the checkpoint)
    ck = {}
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        xst_b = replay.bootstrap(hector.init(xcfg, log.traj[0], dev), dlog,
                                 log.bootstrap, xcfg)
        x_fin, x_full = replay.replay(xst_b, dlog, log.bootstrap, xcfg)
        cut = replay.DeviceLog(dlog.points[:256], dlog.valid[:256],
                               dlog.traj[:256])
        x_mid, _ = replay.replay(xst_b, cut, log.bootstrap, xcfg)
        checkpoint.save(os.path.join(ck_dir, "fixed"), x_mid, {"scan": 256})
        x_back = checkpoint.restore(os.path.join(ck_dir, "fixed"),
                                    hector.init(xcfg, (0.0, 0.0, 0.0), dev))
        x_end, x_rest = replay.replay(x_back, dlog, 256, xcfg)
        check(torch.equal(x_rest.poses, x_full.poses[256 - log.bootstrap:])
              and torch.equal(x_end.maps, x_fin.maps),
              "the resumed fixed replay differs from the uninterrupted one")
        # the card's checkpoint on the CPU: plain npz, one step on the CPU
        with np.load(os.path.join(ck_dir, "fixed", "state.npz"),
                     allow_pickle=False) as z:
            check(all(z[k].dtype != object for k in z.files),
                  "object arrays in the checkpoint")
        x_cpu = checkpoint.restore(os.path.join(ck_dir, "fixed"),
                                   x_back, device="cpu")
        sc = Scan(dlog.points[256].cpu(), dlog.valid[256].cpu(),
                  torch.zeros(3))
        x_cpu2, _ = hector.update(x_cpu, sc, x_cpu.match_pose, xcfg)
        cpu_err = float((x_cpu2.match_pose - x_rest.poses[0].cpu()).abs()
                        .max())
        check(cpu_err <= K3_POSE_TOL, f"the checkpoint stepped on the CPU "
              f"lands {cpu_err} from the card's next pose")
        c_full_st, c_full = replay.coreslam_replay(cdl, mcfg_, seed=1)
        ccut = replay.DeviceLog(cdl.points[:200], cdl.valid[:200],
                                cdl.traj[:200])
        c_mid, _ = replay.coreslam_replay(ccut, mcfg_, seed=1)
        checkpoint.save(os.path.join(ck_dir, "coreslam"), c_mid,
                        {"scan": 200})
        c_st = checkpoint.restore(os.path.join(ck_dir, "coreslam"),
                                  coreslam.init(mcfg_, (0.0, 0.0, 0.0),
                                                seed=99, device=dev))
        c_rest = []
        for t in range(200, cdl.points.shape[0]):
            c_st, _ = coreslam.update_cloud(
                c_st, Scan(cdl.points[t], cdl.valid[t], zero3), c_st.pose,
                mcfg_)
            c_rest.append(c_st.pose)
        check(torch.equal(torch.stack(c_rest), c_full.poses[200:])
              and torch.equal(c_st.hole_map, c_full_st.hole_map)
              and torch.equal(c_st.obstacle_map, c_full_st.obstacle_map),
              "the resumed CoreSLAM parity replay differs from the "
              "uninterrupted one")
        ck = {"trace_k3_events": None,
              "fixed_resume_bit_for_bit": True,
              "coreslam_resume_bit_for_bit": True,
              "card_to_cpu_pose_err": cpu_err,
              "bytes": {k: os.path.getsize(os.path.join(ck_dir, k,
                                                        "state.npz"))
                        for k in ("fixed", "coreslam")}}
        # every state is finite, and asking reads nothing back
        states = [x_end, c_st, c_full_st, proc.state, procs["onehot_bf16"][
            "proc"].state] + [s for r in ds_runs.values() for s in r.pop(
                "states")]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            flags = torch.stack([debug.all_finite(s) for s in states])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(flags.all()), f"debug.all_finite: {flags.tolist()}")
        # the trace of the resumed replay (266 scans, ~0.1 s): a window of
        # one scan late in this long process once held no kernel (PERF.md,
        # open questions)
        with io_metrics.device_trace(os.path.join(ck_dir, "trace")) as tr:
            replay.replay(x_back, dlog, 256, xcfg)
        with open(tr.path) as f:
            k3_events = [e["name"] for e in json.load(f)["traceEvents"]
                         if "match_kernel<true" in e.get("name", "")]
        k3_names = sorted(set(k3_events))
        check(bool(k3_names), "the device trace holds no K3 kernel")
        ck["trace_k3_events"] = len(k3_events)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    say(f"[compat] HectorSLAMProcessor(0.1, 400, (20, 20, 0), 4, 4, 7/4/4/4) "
        f"over {dlog.points.shape[0]} loop scans ({log.bootstrap} forced): "
        f"the track and maps of hector.update bit for bit; ATE "
        f"{procs['gather']['ate_m']:.6f} (JAX {replay.COMPAT_JAX_REF_ATE_M:.6f}"
        f"), max {procs['gather']['max_err_m']:.6f}, launches "
        f"{procs['gather']['launches']}, {procs['gather']['scans_per_s']:.1f} "
        f"scans/s (one host read a scan); onehot_bf16: ATE "
        f"{procs['onehot_bf16']['ate_m']:.6f}, max "
        f"{procs['onehot_bf16']['max_err_m']:.6f}, launches "
        f"{procs['onehot_bf16']['launches']}, "
        f"{procs['onehot_bf16']['scans_per_s']:.1f} scans/s; MapRep 4 levels, "
        f"bitmap values {sorted(bvals)}, MatchTiming {proc.MatchTiming.ms:.3f}"
        f" ms; CoreSLAMProcessor 60 scans ATE {cate[0]:.4f} m, Reset restores "
        f"HOLE_INIT")
    say(f"[checkpoint] the fixed replay saved at scan 256 and the CoreSLAM "
        f"parity replay at scan 200 (generator state inside) resume bit for "
        f"bit; the card's checkpoint steps on the CPU to {cpu_err:.3g} m of "
        f"the card's next pose; npz bytes {ck['bytes']}; debug.all_finite "
        f"true on {len(states)} states with no host read; the trace holds "
        f"{len(k3_events)} of the resumed replay's "
        f"{dlog.points.shape[0] - 256} K3 launches, named "
        f"{(k3_names or [''])[0][:60]}; {time.perf_counter() - t26:.1f} s")

    # ---- 27. the interactive simulator ------------------------------------
    t27 = time.perf_counter()
    sess = interactive.InteractiveSession()
    _build.reset_launches()
    steps = 40
    tt = time.perf_counter()
    for _ in range(steps):
        sess.step()
    torch.cuda.synchronize()
    sess_s = time.perf_counter() - tt
    ilaunch = _build.kernel_launches()
    want = dict.fromkeys(ilaunch, 0)
    # Hector's K3 + K4 and CoreSLAM's line updates (K7) a step
    want.update(dict.fromkeys(("K3", "K4", *CORESLAM_LINE_KERNELS), steps))
    check(ilaunch == want, f"launches of {steps} session steps: {ilaunch}, "
          f"want {want}")
    check(sess.diverged_at is None and sess.loops == steps,
          f"the session diverged at {sess.diverged_at}")
    for level in (0, 1, 2, 3, -1):
        snap = sess.frame(level)
        raw = base64.b64decode(snap["png"])
        w, h = struct.unpack(">II", raw[16:24])
        want_size = 256 if level < 0 else scfg.level_sizes[level]
        check(raw[:8] == b"\x89PNG\r\n\x1a\n" and w == h == want_size
              and snap["size"] == want_size,
              f"frame({level}): {w} x {h}, want {want_size}")
    srv = interactive.serve(sess, port=0)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/state?level=0", timeout=10) as r:
            st_json = json.load(r)
        req = urllib.request.Request(
            f"{base}/pose", data=json.dumps({"x": 21.0, "y": 20.0}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            posted = json.load(r)
    finally:
        sess.stop()
        srv.shutdown()
        srv.server_close()
    check(st_json["size"] == 400 and st_json["has_coreslam"]
          and posted == {"ok": True}
          and sess.real_pose[:2].tolist() == [21.0, 20.0],
          f"HTTP round trip: {st_json.get('size')}, {posted}, "
          f"{sess.real_pose}")
    say(f"[interactive] InteractiveSession() on the card: {steps} steps "
        f"(10 forced), Hector 4 levels (K3 + K4 a step: {ilaunch['K3']}"
        f" + {ilaunch['K4']}), CoreSLAM MC {sess.ccfg.num_candidates}; no "
        f"divergence; {steps / sess_s:.1f} scans/s (rate EMA "
        f"{sess.scan_rate_ema:.1f}); frames of levels 0-3 and the hole map "
        f"decode at their sizes; GET /state and POST /pose answered on "
        f"127.0.0.1; {time.perf_counter() - t27:.1f} s")
    say(f"[seconds] phases 24-27: {t25 - t24:.1f} / {t26 - t25:.1f} / "
        f"{t27 - t26:.1f} / {time.perf_counter() - t27:.1f}")

    # ---- 28-34. the multi-device layer: 8 gloo ranks sharing the card -----
    t28 = time.perf_counter()
    mc = multichip.run(MESH_RANKS, "gloo", "cuda")
    for text in multichip.report(mc, MESH_RANKS, "gloo"):
        say(text)
    say(f"[seconds] phases 28-34: {time.perf_counter() - t28:.1f}")

    def rank_launches(section: str, kernel: str) -> int:
        """``kernel``'s launches in a multichip section, over the ranks."""
        return sum(r["launches"][section].get(kernel, 0) for r in mc["ranks"])

    mesh_err = {k: max(r["kernel_errors"][k] for r in mc["ranks"])
                for k in mc["ranks"][0]["kernel_errors"]}

    # ---- a one-scan device trace late in the process -----------------------
    # (such a window once held no kernel; the 266-scan trace of phase 26
    # stays)
    t35 = time.perf_counter()
    one_dir = tempfile.mkdtemp(prefix="chip_smoke_trace1_")
    try:
        one_st = replay.bootstrap(hector.init(xcfg, log.traj[0], dev), dlog,
                                  log.bootstrap, xcfg)
        one_scan = Scan(dlog.points[log.bootstrap], dlog.valid[log.bootstrap],
                        zero3)
        hector.update(one_st, one_scan, one_st.match_pose, xcfg)  # warm
        torch.cuda.synchronize()
        one_k3, one_k4 = [], []
        for _ in range(ONE_SCAN_TRACES):
            with io_metrics.device_trace(one_dir) as tr:
                hector.update(one_st, one_scan, one_st.match_pose, xcfg)
            with open(tr.path) as f:
                names = [e.get("name", "") for e in
                         json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"]
            one_k3.append(sum("match_kernel<true" in nm for nm in names))
            one_k4.append(sum("line_kernel" in nm for nm in names))
    finally:
        shutil.rmtree(one_dir, ignore_errors=True)
    check(min(one_k3) >= 1 and min(one_k4) >= 1, f"one-scan device traces "
          f"hold {one_k3} K3 and {one_k4} K4 kernels")
    say(f"[trace] one fixed hector.update scan after phase 34 traced "
        f"{ONE_SCAN_TRACES} times with metrics.device_trace: K3 kernels "
        f"{one_k3}, K4 {one_k4}; {time.perf_counter() - t35:.1f} s")

    # ---- 35. the entry points: the bench and two examples ------------------
    entry_points = entry_point_smoke(torch, dev)
    # ---- 36. NCCL on the one card ------------------------------------------
    nccl_one = nccl_smoke(torch)
    # ---- 37. hector.update's CUDA graph -------------------------------------
    graph_step = graph_step_smoke(torch, dev)
    # ---- 38. CoreSLAM's map update, K7 --------------------------------------
    coreslam_map = coreslam_map_smoke(torch, dev)

    def entry(name, source, replaces, launches, err, ms, plain, bnd):
        return {"name": name, "route": "cuda",
                "source": f"slamnet_tpu_torch/csrc/{source}",
                "replaces": f"slamnet_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("match", "match.cu", "pallas_onehot.py:500", launches["K1"],
              k1_err, k1_ms, k1_plain_ms, k1_bound),
        entry("fill", "fill.cu", "pallas_fill.py:86", launches["K2"], k2_err,
              k2_ms, k2_plain_ms, k2_bound),
        entry("match_batch", "match.cu", "pallas_onehot.py:235",
              flaunch["K5"], k5_err, k5_ms, k5_plain_ms, k5_bound),
        entry("match_packed", "match.cu", "pallas_onehot.py:460",
              flaunch["K6"], k6_err, k6_ms[K6_G_REPORTED],
              k5_plain_ms, k5_bound),
        entry("fill_batch", "fill.cu", "pallas_fill.py:86",
              flaunch["K2_batch"], kb_err, kb_ms["1-in-18"],
              kb_plain_ms["1-in-18"], kb_bound["1-in-18"]),
        entry("match_f32", "match.cu", "pallas_gn.py:133", xlaunch["K3"],
              k3_err, k3_ms, k3_plain_ms, k3_bound),
        entry("match_f32_batch", "match.cu", "pallas_gn.py:133",
              slaunch["K3_batch"], k3b_err, k3b_ms, k3b_plain_ms,
              k3b_bound),
        entry("line", "line.cu", "pallas_scatter.py:71", xlaunch["K4"],
              k4_err["single"], k4_ms["fire"], k4_plain_ms["fire"], k4_bound),
        entry("line_batch", "line.cu", "pallas_scatter.py:71",
              slaunch["K4_batch"], k4_err["batch"], k4b_ms["1-in-18"],
              k4b_plain_ms["1-in-18"], k4b_bound["1-in-18"]),
        entry("match_exit", "match.cu", "pallas_onehot.py:500",
              elaunch["K1"], k1_exit_err, k1x_ms, k1x_plain_ms, k1x_bound),
        # the fleet's batch-wide exit: the exit rows' launches, timed at 64
        # robots and bench's 1e-3 (the bound counts the shared iterations)
        entry("match_batch_exit", "match.cu", "pallas_onehot.py:235",
              rows["sub4_onehot_exit"]["launches"]["K5_exit"],
              exit_err["K5"], exit_ms[("K5", EXIT_TOL)],
              exit_plain_ms[("K5", EXIT_TOL)], exit_bound[("K5", EXIT_TOL)]),
        entry("match_f32_batch_exit", "match.cu", "pallas_gn.py:133",
              rows["sub1_exit"]["launches"]["K3_batch_exit"],
              exit_err["K3"], exit_ms[("K3", EXIT_TOL)],
              exit_plain_ms[("K3", EXIT_TOL)], exit_bound[("K3", EXIT_TOL)]),
        # the frontend's launches: a graph replay's count less its n Hector
        # launches (one a scan)
        entry("match_frontend", "match.cu", "pallas_onehot.py:500",
              graph_runs["pallas_full"]["launches"]["K1"] - gn,
              fr_err["K1"], *fr["K1"]),
        entry("fill_frontend", "fill.cu", "pallas_fill.py:86",
              graph_runs["pallas_full"]["launches"]["K2"] - gn, fr_fill_err,
              *fr["K2"]),
        entry("match_f32_frontend", "match.cu", "pallas_gn.py:133",
              graph_runs["gather"]["launches"]["K3"] - gn,
              fr_err["K3"], *fr["K3"]),
        entry("line_frontend", "line.cu", "pallas_scatter.py:71",
              graph_runs["gather"]["launches"]["K4"] - gn, 0.0,
              *fr["K4"]),
        # the office graph replay's Hector launches, timed at 200 px
        entry("match_f32_office", "match.cu", "pallas_gn.py:133",
              office_runs["graph"]["launches"]["K3"], o_err["K3"],
              *o_ms["K3"]),
        entry("line_office", "line.cu", "pallas_scatter.py:71",
              office_runs["graph"]["launches"]["K4"], 0.0, *o_ms["K4"]),
        # the simulator's 4-level pyramid: the processors' replays' launches
        entry("match_f32_l4", "match.cu", "pallas_gn.py:133",
              procs["gather"]["launches"]["K3"], l4_err["K3"],
              *l4_ms["K3"]),
        entry("match_l4", "match.cu", "pallas_onehot.py:500",
              procs["onehot_bf16"]["launches"]["K1"], l4_err["K1"],
              *l4_ms["K1"]),
        entry("line_l4", "line.cu", "pallas_scatter.py:71",
              procs["gather"]["launches"]["K4"], 0.0, *l4_ms["K4"]),
        # the 181-beam dataset pyramid: both dataset replays' launches
        entry("match_f32_181", "match.cu", "pallas_gn.py:133",
              sum(r["launches"]["K3"] for r in ds_runs.values()),
              d_err["K3"], *l4_ms["K3_181"]),
        entry("line_181", "line.cu", "pallas_scatter.py:71",
              sum(r["launches"]["K4"] for r in ds_runs.values()), 0.0,
              *l4_ms["K4_181"]),
        # the fleet over the search axis (phases 28-34): every rank's
        # launches summed, the largest error of a rank's robots against
        # plain; not timed at a rank's shape (the 64-robot rows above are)
        entry("match_batch_mesh", "match.cu", "pallas_onehot.py:235",
              rank_launches("fleet_sub4_pallas_dense", "K5"), mesh_err["K5"],
              None, None, (None, None)),
        entry("fill_batch_mesh", "fill.cu", "pallas_fill.py:86",
              rank_launches("fleet_sub4_pallas_dense", "K2_batch"),
              mesh_err["K2 batched"], None, None, (None, None)),
        entry("match_batch_f32_mesh", "match.cu", "pallas_gn.py:133",
              rank_launches("fleet_sub1", "K3_batch"),
              mesh_err["K3 batched"], None, None, (None, None)),
        entry("line_batch_mesh", "line.cu", "pallas_scatter.py:71",
              rank_launches("fleet_sub1", "K4_batch"),
              mesh_err["K4 batched"], None, None, (None, None)),
        # the sharded graph's frontend on every rank (phases 28-34): every
        # rank's launches summed, timed at the frontend's shape (phase 15)
        entry("match_graph_sharded", "match.cu", "pallas_onehot.py:500",
              rank_launches("graph_onehot_bf16", "K1"), fr_err["K1"],
              *fr["K1"]),
        entry("fill_graph_sharded", "fill.cu", "pallas_fill.py:86",
              rank_launches("graph_onehot_bf16", "K2"), fr_fill_err,
              *fr["K2"]),
        entry("match_f32_graph_sharded", "match.cu", "pallas_gn.py:133",
              rank_launches("graph_gather", "K3"), fr_err["K3"], *fr["K3"]),
        entry("line_graph_sharded", "line.cu", "pallas_scatter.py:71",
              rank_launches("graph_gather", "K4"), 0.0, *fr["K4"])],
        "replay_scans_per_s": n / t_kernel,
        "replay_plain_scans_per_s": n / t_plain,
        "ate_m": ate, "max_err_m": max_err, "jax_ref_ate_m": replay.JAX_REF_ATE_M,
        "fleet_instance_scans_per_s": iscans / tf_kernel,
        "fleet_plain_instance_scans_per_s": iscans / tf_plain,
        "fleet_ate_m": fate, "fleet_max_err_m": fmax,
        "fleet_ate_median_m": fmed, "k6_ms_by_g_pack": k6_ms,
        "match_ms_per_iteration": per_it, "match_ms_intercept": icpt,
        "match_ms_by_iterations": dict(zip(map(str, SLOPE_ITERS), slope_ms)),
        "fill_gated_ms": k2_gated_ms, "fill_batch_none_ms": kb_ms["none"],
        "fill_batch_all_fire_bound_ms": kb_bound["all"][0],
        "fill_batch_300_ms": big_ms,
        "fill_batch_all_fire_ms": kb_ms["all"],
        "fill_batch_all_fire_plain_ms": kb_plain_ms["all"],
        "fixed_replay_scans_per_s": n / tx_kernel,
        "fixed_replay_plain_scans_per_s": n / tx_plain,
        "fixed_ate_m": xate, "fixed_max_err_m": xmax,
        "jax_fixed_ref_ate_m": replay.JAX_FIXED_REF_ATE_M,
        "sub1_instance_scans_per_s": iscans / ts_kernel,
        "sub1_plain_instance_scans_per_s": iscans / ts_plain,
        "sub1_ate_m": sate, "sub1_max_err_m": smax, "sub1_ate_median_m": smed,
        "line_gated_ms": k4_ms["gated"],
        "line_batch_none_ms": k4b_ms["none"],
        "line_batch_all_fire_ms": k4b_ms["all"],
        "line_batch_all_fire_plain_ms": k4b_plain_ms["all"],
        "line_batch_all_fire_bound_ms": k4b_bound["all"][0],
        "line_cells_changed": k4_cells, "line_batch_cells_changed": k4b_cells,
        "exit_replay_scans_per_s": n / te_kernel,
        "exit_replay_plain_scans_per_s": n / te_plain,
        "exit_ate_m": eate, "exit_max_err_m": emax,
        "exit_gn_iterations": e_iters, "exit_iterations_at_hints": exit_iters,
        "match_f32_exit_ms": k3x_ms, "fill_frontend_cells_differing": fr_fill_frac,
        "graph": {m: {**r["res"], "keyframe_events": r["events"],
                      "loop_searches": r["searches"], "host_reads": r["syncs"], "scans_per_s": gn / r["s"],
                      "launches": {k: v for k, v in r["launches"].items() if v}}
                  for m, r in graph_runs.items()},
        "graph_host_us_per_scan": us,
        "office": {**ores, "jax_ref": oref,
                   "launches": {k: {n: v for n, v in r["launches"].items()
                                    if v} for k, r in office_runs.items()},
                   "keyframe_events": office_runs["graph"]["events"],
                   "loop_searches": office_runs["graph"]["searches"],
                   "host_reads": office_runs["graph"]["syncs"],
                   "scans_per_s": {k: on / r["s"]
                                   for k, r in office_runs.items()},
                   "k3_k4_200px_ms": {k: v[0] for k, v in o_ms.items()}},
        "coreslam": {**core_runs, "ops_device_us": core_us,
                     "card_vs_cpu_differing": flips, "compared": snaps,
                     "jax_ref_production_ates_m":
                         replay.CORESLAM_JAX_REF_ATES_M,
                     "jax_ref_parity_ates_m":
                         replay.CORESLAM_PARITY_JAX_REF_ATES_M},
        "fleet_exit": {"shared_counts": exit_counts,
                       "level_counts": exit_levels,
                       "max_pose_err": exit_err,
                       "max_pose_err_stopped_early": exit_err_fires,
                       "ms_b64": {f"{n}_tol{t}": v
                                  for (n, t), v in exit_ms.items()},
                       "ms_b5000": exit_5k_ms, "launches": exit_calls},
        "fleet_rows": rows, "fleet_headline": pick,
        "fleet_headline_bound_m": hbound,
        "particle": {**prun, "ops_device_us": pus, "card_vs_cpu": pdiff,
                     "jax_ref_exact_ates_m": replay.PARTICLE_JAX_REF_ATES_M,
                     "jax_ref_grid_dense_ates_m":
                         replay.PARTICLE_GRID_DENSE_JAX_REF_ATES_M},
        "sim_pyramid": {"level_sizes": scfg.level_sizes,
                        "max_pose_err": l4_err, "line_cells_changed": l4_cells,
                        "dataset_k3_err": d_err,
                        "dataset_line_cells_changed": d_cells,
                        "edge_beams_off_map": d_off},
        "datasets": ds_runs,
        "compat": {m: {k: v for k, v in r.items() if k not in ("proc",
                                                              "track")}
                   for m, r in procs.items()},
        "compat_jax_ref_ate_m": replay.COMPAT_JAX_REF_ATE_M,
        "coreslam_processor_ate_m": cate[0], "checkpoint": ck,
        "interactive": {"steps": steps, "scans_per_s": steps / sess_s,
                        "launches": {k: v for k, v in ilaunch.items() if v},
                        "diverged_at": sess.diverged_at},
        "match_bits": {"K1": k1_bits, "K3": k3_bits},
        "multichip": multichip.strip_tracks(mc),
        "one_scan_trace": {"k3_events": one_k3, "k4_events": one_k4},
        "entry_points": entry_points,
        "nccl_one_rank": nccl_one,
        "graph_step": graph_step,
        "coreslam_map": coreslam_map,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
