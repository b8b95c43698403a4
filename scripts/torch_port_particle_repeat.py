#!/usr/bin/env python3
"""Repeat particle replays on one GPU and say whether they repeat bit for
bit.

    python3 scripts/torch_port_particle_repeat.py [--mode grid_small]
        [--seeds 1 2] [--repeats 4] [--f32-cdf]

Each seed's replay of the 522 loop scans (``replay.particle_replay``) runs
``--repeats`` times.  ``--f32-cdf`` resamples from an f32 ``torch.cumsum``
CDF, the form ``models/particle.resample`` had before its exact fixed-point
CDF, to show how that one rounds from run to run on the card.  Prints one
JSON object: for each seed, the ATE of every repeat and whether all repeats
gave the same poses.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from slamnet_tpu_torch import replay  # noqa: E402
from slamnet_tpu_torch.core.geometry import true_div  # noqa: E402
from slamnet_tpu_torch.models import particle  # noqa: E402


def _resample_f32_cdf(particles, eff, valid, u0, ess_frac):
    """``particle.resample`` with the CDF an f32 ``torch.cumsum``."""
    p = eff.shape[0]
    valid_n = valid.sum(dtype=torch.int32).clamp(min=1)
    logw = -eff.to(torch.float32) / (2000.0 * valid_n.to(torch.float32))
    e = torch.exp(logw - logw.max())
    w = e / e.sum()
    ess = true_div(1.0, (w * w).sum())
    do_resample = ess < ess_frac * p
    u = true_div(u0 + torch.arange(p, device=eff.device), p)
    idx = torch.searchsorted(torch.cumsum(w, dim=0), u).clamp(0, p - 1)
    return (torch.where(do_resample, particles.index_select(0, idx),
                        particles),
            torch.where(do_resample, eff.index_select(0, idx), eff), ess,
            do_resample)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="grid_small",
                    choices=sorted(replay.PARTICLE_MODES))
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--f32-cdf", action="store_true",
                    help="resample from an f32 torch.cumsum CDF")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.f32_cdf:
        particle.resample = _resample_f32_cdf
    dev = torch.device("cuda", 0)
    log = replay.make_log(0)
    dlog = replay.to_device(log, dev)
    ccfg, pcfg = replay.PARTICLE_MODES[args.mode]
    out = {"device": torch.cuda.get_device_name(0), "mode": args.mode,
           "f32_cdf": args.f32_cdf, "seeds": {}}
    for seed in args.seeds:
        runs = [replay.particle_replay(dlog, ccfg, pcfg, seed)[1].poses
                for _ in range(args.repeats)]
        out["seeds"][seed] = {
            "ates_m": [replay.ate_of(r.cpu().numpy(), log.traj)[0]
                       for r in runs],
            "bit_for_bit": all(torch.equal(r, runs[0]) for r in runs)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
