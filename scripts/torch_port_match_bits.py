#!/usr/bin/env python3
"""Fingerprints of the match kernels' fixed-iteration answers, to show that
a change to ``csrc/match.cu`` left them as they were.

Run from the root of each tree on the same GPU (for example the parent as a
``git archive`` under ``build/`` and the change), and compare the lines:

    (cd build/parent && python3 ../../scripts/torch_port_match_bits.py)
    python3 scripts/torch_port_match_bits.py

It imports the package of the current directory, bootstraps the loop log's
maps as the replays do (10 forced scans), and prints one line a kernel, the
first 16 hex digits of the SHA-256 of its f32 outputs: K1 and K3 at three
hints on scan 10, and K5, K6 (g_pack 4) and the batched K3 over the 64-robot
fleet's batch-scan 10.
"""
import hashlib
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from slamnet_tpu_torch import replay  # noqa: E402
from slamnet_tpu_torch.models import fleet, hector  # noqa: E402
from slamnet_tpu_torch.ops import match  # noqa: E402

HINTS = ((0.2, -0.15, 0.04), (-0.1, 0.12, -0.03), (0.05, 0.2, 0.06))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    log = replay.make_log(0)
    dlog = replay.to_device(log, dev)
    out = {}
    for name, cfg in (("K1", replay.pallas_dense_config()),
                      ("K3", replay.fixed_config())):
        st = replay.bootstrap(hector.init(cfg, log.traj[0], dev), dlog, 10,
                              cfg)
        out[name] = torch.stack([
            match.match(st.maps, dlog.points[10], dlog.valid[10],
                        dlog.traj[10] + torch.tensor(h, device=dev), cfg)
            for h in HINTS])
    flog = replay.make_fleet_log(log)
    fdlog = replay.to_device(flog, dev)
    for name, cfg in (("K5", replay.sub4_pallas_dense_config()),
                      ("K3 batch", replay.sub1_config())):
        st = replay.fleet_bootstrap(fleet.init_fleet(cfg, flog.traj[0], dev),
                                    fdlog, 10, cfg)
        args = (st.maps, fdlog.points[10], fdlog.valid[10],
                (fdlog.traj[10] + torch.tensor(HINTS[0], device=dev))
                .contiguous())
        out[name] = match.match_batch(*args, cfg)
        if name == "K5":
            out["K6"] = match.match_packed(*args, cfg, 4)
    for name, o in out.items():
        print(name, hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
