"""Replay a 2D lidar dataset (CARMEN log format) through both pipelines.

Port of ``examples/replay_dataset.py``, the real-robot ingestion path
(CoreSLAMProcessor.cs:717 consumes arbitrary scan streams):

    python -m slamnet_tpu_torch.examples.replay_dataset \\
        --log examples/data/sim_loop.clf --out-dir OUT

Reads the FLASER / ROBOTLASER1 scans and odometry with the native parser
(``hostio.read_carmen_native``; the Python reader for a log without FLASER
lines), moves the first odometry pose to the map's centre (CARMEN
coordinates are arbitrary; the maps span [0, map_size_m]), replays Hector
(K3 + K4, the odometry step as its motion prior) and CoreSLAM (correlative,
dense fills) as ``replay.carmen_replay`` does, with no host read in the
loop, and writes the pose track as JSONL and the final occupancy (level 0)
and hole maps as grayscale PNGs (the JAX script draws them with
matplotlib).  A log with ``# TRUTH`` lines gets its ATEs printed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import replay
from ..io import export
from ..io.live import _png_bytes
from ..models import hector
from . import device_or_exit


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", default=str(replay.SIM_LOOP_LOG))
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "slamnet_dataset"))
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--map-size-m", type=float,
                    default=replay.DATASET_MAP_SIZE_M)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, no fallback) or cpu")
    ap.add_argument("--robust", action="store_true",
                    help="the production robustness guards (xy step clamp, "
                         "match-jump reject, GN damping), for degraded logs "
                         "with odometry slips (examples/data/"
                         "adversarial_180.clf)")
    return ap.parse_args(argv)


def write_png(path: str, gray: np.ndarray) -> None:
    """A [H, W] uint8 image as a PNG, row 0 at the top (world y max)."""
    with open(path, "wb") as f:
        f.write(_png_bytes(np.flipud(gray)))


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_or_exit(args.device, "replay_dataset")
    data = replay.load_carmen(args.log, dev, max_scans=args.max_scans,
                              map_size_m=args.map_size_m)
    hcfg, ccfg = replay.dataset_config(args.robust, args.map_size_m)
    n, beams = data.points.shape[:2]

    t0 = time.perf_counter()
    hst, cst, out = replay.carmen_replay(data, hcfg, ccfg)
    htrack, ctrack = out.hector.cpu().numpy(), out.coreslam.cpu().numpy()
    dt = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    track_path = os.path.join(args.out_dir, "track.jsonl")
    with open(track_path, "w") as f:
        for t in range(n):
            f.write(json.dumps({
                "t": t, "odom": [round(float(x), 4) for x in data.odo[t]],
                "coreslam": [round(float(x), 4) for x in ctrack[t]],
                "hector": [round(float(x), 4) for x in htrack[t]]}) + "\n")
    hole_png = os.path.join(args.out_dir, "hole_map.png")
    occ_png = os.path.join(args.out_dir, "occupancy.png")
    write_png(hole_png, (export.hole_map_u16(cst.hole_map, ccfg.hole_map_size)
                         >> 8).astype(np.uint8))
    write_png(occ_png, export.occupancy_bitmap(
        hector.level_view(hst.maps, hcfg, 0).reshape(-1), hcfg.map_size))

    odo = data.odo
    print(f"{n} scans x {beams} beams in {dt:.1f}s ({n / dt:.1f} scans/s) "
          f"on {dev}")
    print(f"final vs odometry: coreslam "
          f"{np.linalg.norm(ctrack[-1, :2] - odo[-1, :2]):.3f} m, hector "
          f"{np.linalg.norm(htrack[-1, :2] - odo[-1, :2]):.3f} m")
    if data.truth is not None:
        m = replay.dataset_metrics(data, out)
        print("ATE vs truth (rms/max m): odometry-only "
              f"{m['odometry_ate_m']:.3f}/{m['odometry_max_err_m']:.3f}  "
              f"coreslam {m['coreslam_ate_m']:.3f}/"
              f"{m['coreslam_max_err_m']:.3f}  hector "
              f"{m['hector_ate_m']:.3f}/{m['hector_max_err_m']:.3f}")
    print(f"track: {track_path}")
    print(f"maps:  {hole_png}  {occ_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
