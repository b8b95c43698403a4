#!/usr/bin/env python
"""Reference ATE of the JAX package on the PyTorch port's scan log.

The port (``slamnet_tpu_torch``) gates its H100 replay on
``replay.JAX_REF_ATE_M``; this script produces that number.  It makes the
log with ``slamnet_tpu_torch.replay.make_log(seed)`` (the port's simulator,
on the CPU) and runs the JAX package over it with the bench's flow
(``bench.py:147-172``): a 10-scan forced bootstrap at the true poses in the
``fixed`` config whatever the mode, then 512 scans each hinted with the
previous match pose.

Modes (single robot):
  * ``fixed``: the reference-exact gather matcher with line updates.  Its
    ATE is ``JAX_FIXED_REF_ATE_M``.
  * ``onehot_bf16_dense``: ``matcher_mode="onehot_bf16"``,
    ``dense_free_fill=True``, fixed 7/4/4 iterations — the same bf16 table
    selection K1 makes, and the port's dense fill.  Its ATE is
    ``JAX_REF_ATE_M``.

``--fleet`` runs the fleet instead: ``fleet.update_fleet`` over
``make_fleet_log``'s 64 phase-shifted slices of the same log, with bench's
flow (``bench.py:462-493``: 10 forced batch-scans with ``match_pose`` set to
the true poses in the mode's own config, then 64 tracked ones).  ``--mode``
picks the bench's fleet mode: ``sub4_onehot_dense`` (the headline, K5's
bf16 selection in XLA; ``replay.FLEET_JAX_REF_*``) or ``sub1`` (the accuracy
anchor, gather + line updates; ``replay.FLEET_SUB1_JAX_REF_*``): its RMS,
max and median instance ATE.

Runs on the CPU (a few minutes); prints one JSON object.

    python scripts/torch_port_ref_ate.py [--seed 0] [--fleet [--mode sub1]]
"""
import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from slamnet_tpu.core import HectorConfig  # noqa: E402
from slamnet_tpu.core.scan import Scan  # noqa: E402
from slamnet_tpu.models import fleet, hector  # noqa: E402
from slamnet_tpu_torch.replay import (ate_of, fleet_ate_of,  # noqa: E402
                                      make_fleet_log, make_log, sub1_config,
                                      sub4_pallas_dense_config)

FLEET_FIELDS = ("num_levels", "estimate_iterations", "xy_step_clamp_px",
                "max_match_jump", "match_subsample", "dense_free_fill",
                "matcher_mode")


def run_mode(cfg, boot_cfg, log):
    angles = jnp.asarray(log.angles)
    radii = jnp.asarray(log.radii)
    valids = jnp.asarray(log.valid)
    traj = jnp.asarray(log.traj)
    b = log.bootstrap

    def cloud(r, v):
        pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
        return Scan(pts, v, jnp.zeros(3, jnp.float32))

    @jax.jit
    def boot(state, radii, valids, poses):
        def body(st, inp):
            r, v, p = inp
            st, _ = hector.update(st, cloud(r, v), p, boot_cfg,
                                  map_without_matching=jnp.asarray(True))
            return st, None
        return jax.lax.scan(body, state, (radii, valids, poses))[0]

    @jax.jit
    def replay(state, radii, valids):
        def body(st, inp):
            r, v = inp
            st, info = hector.update(st, cloud(r, v), st.match_pose, cfg,
                                     map_without_matching=jnp.asarray(False))
            return st, (st.match_pose, info.map_updated, info.solve_failures)
        return jax.lax.scan(body, state, (radii, valids))

    state = boot(hector.init(cfg, log.traj[0]), radii[:b], valids[:b],
                 traj[:b])
    _, (poses, upd, fails) = replay(state, radii[b:], valids[b:])
    ate, mx = ate_of(np.asarray(poses), log.traj[b:])
    return {"ate_m": ate, "max_err_m": mx,
            "map_updates": int(np.asarray(upd).sum()),
            "solve_failures": int(np.asarray(fails).sum())}


def run_fleet(cfg, flog):
    angles = jnp.asarray(flog.angles)
    radii = jnp.asarray(flog.radii)
    valids = jnp.asarray(flog.valid)
    traj = jnp.asarray(flog.traj)
    b = flog.bootstrap

    def points(r):
        return jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)

    @jax.jit
    def boot_step(states, r, v, poses):
        states = states._replace(match_pose=poses)
        return fleet.update_fleet(states, points(r), v, cfg,
                                  map_without_matching=True)[0]

    @jax.jit
    def replay(states, radii, valids):
        def body(sts, inp):
            r, v = inp
            sts, info = fleet.update_fleet(sts, points(r), v, cfg)
            return sts, (sts.match_pose, info.map_updated, info.solve_failures)
        return jax.lax.scan(body, states, (radii, valids))

    states = fleet.init_fleet(cfg, flog.traj[0])
    for t in range(b):
        states = boot_step(states, radii[t], valids[t], traj[t])
    _, (poses, upd, fails) = replay(states, radii[b:], valids[b:])
    ate, mx, med = fleet_ate_of(np.asarray(poses), flog.traj[b:])
    return {"ate_m": ate, "max_err_m": mx, "ate_median_m": med,
            "map_updates": int(np.asarray(upd).sum()),
            "solve_failures": int(np.asarray(fails).sum())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet", action="store_true",
                    help="the 64-robot fleet instead of the single robot")
    ap.add_argument("--mode", choices=("sub4_onehot_dense", "sub1"),
                    default="sub4_onehot_dense", help="the fleet's mode")
    args = ap.parse_args()
    log = make_log(seed=args.seed)
    base = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    out = {"seed": args.seed, "n_scans": int(log.radii.shape[0] - log.bootstrap),
           "bootstrap": log.bootstrap, "jax": jax.__version__,
           "device": str(jax.devices()[0])}
    if args.fleet:
        flog = make_fleet_log(log)
        port_cfg = (sub1_config() if args.mode == "sub1" else
                    sub4_pallas_dense_config(matcher_mode="onehot_bf16"))
        cfg = HectorConfig(**{f: getattr(port_cfg, f) for f in FLEET_FIELDS})
        out["robots"], out["n_batch_scans"] = flog.radii.shape[1], \
            flog.radii.shape[0] - flog.bootstrap
        name = f"fleet_{args.mode}"
        t0 = time.time()
        out[name] = run_fleet(cfg, flog)
        out[name]["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(out))
        return
    for name, cfg in (("fixed", base),
                      ("onehot_bf16_dense",
                       base.overlay({"matcher_mode": "onehot_bf16",
                                     "dense_free_fill": True}))):
        t0 = time.time()
        out[name] = run_mode(cfg, base, log)
        out[name]["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
