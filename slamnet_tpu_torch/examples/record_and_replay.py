"""Dataset round trip: record simulator scans to a .slog, replay SLAM from it.

Port of ``examples/record_and_replay.py``, the host data path: the
simulator, the native scan-log writer (``hostio.SlogWriter``), a producer
thread reading the log back into the native ``hostio.ScanQueue``, and the
consumer feeding Hector on the device (3 levels, 7/4/4, K3 + K4; the first
BOOTSTRAP scans mapped without matching), then the ATE against the recorded
odometry (the true poses).

    python -m slamnet_tpu_torch.examples.record_and_replay --scans 200

The revolutions are simulated in one batch on the device from seed 0, and
the poses stay there until the replay ends (one host read).
"""
from __future__ import annotations

import argparse
import os
import struct
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import hostio
from ..core.config import HectorConfig, SimConfig
from ..core.scan import Scan
from ..models import hector
from ..sim import default_field, revolution_angles, scan_revolution
from ..sim.trajectory import loop_trajectory
from . import device_or_exit

BOOTSTRAP = 10


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, no fallback) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "slamnet_demo.slog"))
    return ap.parse_args(argv)


def record(path: str, traj: np.ndarray, dev: torch.device) -> int:
    """Simulate a revolution at each pose of ``traj`` and write them, with
    the pose as the odometry, to the scan log ``path``; returns the beams a
    scan."""
    sim = SimConfig()
    angles = torch.as_tensor(revolution_angles(sim.num_scan_points),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    radii, valid = scan_revolution(
        default_field(sim.field_scale, sim.field_offset, device=dev),
        torch.as_tensor(traj, device=dev), angles, sim.max_scan_dist,
        sim.measure_error, gen)
    radii, valid = radii.cpu().numpy(), valid.cpu().numpy()
    w = hostio.SlogWriter(path, angles.shape[0])
    try:
        for t in range(traj.shape[0]):
            w.append(int(t * 1e9 / sim.scans_per_second), traj[t], radii[t],
                     valid[t])
    finally:
        w.close()
    return angles.shape[0]


def replay_log(path: str, n_beams: int, start_pose, dev: torch.device):
    """Hector over the scan log, read by a producer thread into the native
    queue; returns the match poses f32[T, 3] and the recorded odometry
    f32[T, 3] (host), and the queue's dropped count."""
    slot = 8 + 12 + 4 * n_beams + n_beams     # ts + odometry + radii + valid
    q = hostio.ScanQueue(capacity=8, slot_bytes=slot)
    reader = hostio.SlogReader(path)

    def producer():
        try:
            for ts, odom, radii, valid in reader:
                q.push(struct.pack("<Q", ts) + odom.tobytes() + radii.tobytes()
                       + valid.astype(np.uint8).tobytes(), timeout_ms=5000)
        finally:
            reader.close()
            q.close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    state = hector.init(cfg, start_pose, dev)
    angles = revolution_angles(n_beams)
    cos, sin = np.cos(angles), np.sin(angles)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    poses, odoms = [], []
    while (item := q.pop(timeout_ms=5000)) is not None:
        odoms.append(np.frombuffer(item, np.float32, 3, offset=8))
        radii = np.frombuffer(item, np.float32, n_beams, offset=20)
        valid = np.frombuffer(item, np.uint8, n_beams,
                              offset=20 + 4 * n_beams).astype(bool)
        pts = torch.as_tensor(np.stack([radii * cos, radii * sin], -1),
                              device=dev)
        state, _ = hector.update(
            state, Scan(pts, torch.as_tensor(valid, device=dev), zero),
            state.match_pose, cfg, len(poses) < BOOTSTRAP)
        poses.append(state.match_pose)
    thread.join(timeout=10)
    return torch.stack(poses).cpu().numpy(), np.asarray(odoms), q.dropped


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_or_exit(args.device, "record_and_replay")
    traj = loop_trajectory(speed=0.3)[:args.scans]

    t0 = time.perf_counter()
    n_beams = record(args.out, traj, dev)
    print(f"recorded {traj.shape[0]} scans -> {args.out} "
          f"({os.path.getsize(args.out) / 1024:.0f} KB) in "
          f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    poses, odoms, dropped = replay_log(args.out, n_beams, traj[0], dev)
    dt = time.perf_counter() - t0
    pos = np.linalg.norm(poses[:, :2] - odoms[:, :2], axis=1)
    ok = bool(pos.max() < 1.0)
    print(f"replayed {poses.shape[0]} scans from log on {dev}: "
          f"ATE={np.sqrt((pos ** 2).mean()):.6f} m max={pos.max():.3f} m "
          f"rate={poses.shape[0] / dt:.1f} scans/s dropped={dropped} "
          f"[{'OK' if ok else 'DIVERGED'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
