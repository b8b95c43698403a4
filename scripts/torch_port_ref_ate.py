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

``--exit`` runs bench's default candidate ``onehot_bf16_dense``
(``bench.py:214-217``: ``early_exit_tol=1e-3``, ``matcher_mode=
"onehot_bf16"``, dense fill) on the same log and flow; its ATE is
``JAX_EXIT_REF_ATE_M``.

``--graph`` runs graph-SLAM (``models/graph_slam.update``) over
``make_graph_log(7)`` with bench's graph flow (``bench.py:613-647``: every
scan from the live match pose, the first 12 forced in the mode's own config;
the ATE over the scans after them): ``--mode gather`` (the bench's
parity mode, ``replay.GRAPH_JAX_REF_*``) or ``onehot_full`` (``bench.py:
669-674``, ``replay.GRAPH_ONEHOT_JAX_REF_*``): ATE, max error, keyframes
and loop closures.

``--fleet`` runs the fleet instead: ``fleet.update_fleet`` over
``make_fleet_log``'s 64 phase-shifted slices of the same log, with bench's
flow (``bench.py:462-493``: 10 forced batch-scans with ``match_pose`` set to
the true poses in the mode's own config, then 64 tracked ones).  ``--mode``
picks the bench's fleet mode: ``sub4_onehot_dense`` (the headline, K5's
bf16 selection in XLA; ``replay.FLEET_JAX_REF_*``) or ``sub1`` (the accuracy
anchor, gather + line updates; ``replay.FLEET_SUB1_JAX_REF_*``): its RMS,
max and median instance ATE.

Runs on the CPU (a few minutes); prints one JSON object.

    python scripts/torch_port_ref_ate.py [--seed 0] [--exit]
        [--fleet [--mode sub1]] [--graph [--mode onehot_full]]
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

from slamnet_tpu.core import HectorConfig, PoseGraphConfig  # noqa: E402
from slamnet_tpu.core.scan import Scan  # noqa: E402
from slamnet_tpu.graph import frontend  # noqa: E402
from slamnet_tpu.models import fleet, graph_slam, hector  # noqa: E402
from slamnet_tpu_torch.replay import (GRAPH_SEED, ate_of,  # noqa: E402
                                      fleet_ate_of, make_fleet_log,
                                      make_graph_log, make_log, sub1_config,
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


def run_graph(hcfg, mcfg, log):
    """bench.py's graph flow (``bench.py:613-647``) over ``log``."""
    angles = jnp.asarray(log.angles)
    gcfg = PoseGraphConfig()
    n = log.radii.shape[0]
    force = jnp.arange(n) < log.bootstrap

    @jax.jit
    def replay(state, radii, valids, force):
        def body(st, inp):
            rr, vv, f = inp
            pts = jnp.stack([rr * jnp.cos(angles), rr * jnp.sin(angles)], -1)
            st, _ = graph_slam.update(
                st, Scan(pts, vv, jnp.zeros(3, jnp.float32)), hcfg, gcfg,
                mcfg=mcfg, map_without_matching=f)
            return st, st.hector.match_pose
        return jax.lax.scan(body, state, (radii, valids, force))

    state = graph_slam.init(hcfg, gcfg, log.traj[0], int(angles.shape[0]))
    stf, poses = replay(state, jnp.asarray(log.radii), jnp.asarray(log.valid),
                        force)
    b = log.bootstrap
    ate, mx = ate_of(np.asarray(poses)[b:], log.traj[b:])
    return {"ate_m": ate, "max_err_m": mx,
            "keyframes": int(np.asarray(stf.graph.num_nodes)),
            "loop_closures": int(np.asarray(stf.loop_count))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="the log's seed (default 0, or 7 with --graph)")
    ap.add_argument("--exit", action="store_true",
                    help="onehot_bf16_dense with early_exit_tol=1e-3")
    ap.add_argument("--fleet", action="store_true",
                    help="the 64-robot fleet instead of the single robot")
    ap.add_argument("--graph", action="store_true",
                    help="graph-SLAM over the turning revisit log")
    ap.add_argument("--mode", choices=("sub4_onehot_dense", "sub1", "gather",
                                       "onehot_full"),
                    help="the fleet's mode (default sub4_onehot_dense) or "
                         "the graph's (default gather)")
    args = ap.parse_args()
    if args.graph:
        mode = args.mode or "gather"
        if mode not in ("gather", "onehot_full"):
            ap.error(f"--mode {mode} is not a graph mode")
        seed = GRAPH_SEED if args.seed is None else args.seed
        log = make_graph_log(seed=seed)
        hcfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
        mcfg = None
        if mode == "onehot_full":
            hcfg = hcfg.overlay({"matcher_mode": "onehot_bf16",
                                 "dense_free_fill": True,
                                 "dense_free_margin_px": 0.5})
            mcfg = frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                            dense_fill=True)
        out = {"seed": seed, "n_scans": int(log.radii.shape[0]),
               "bootstrap": log.bootstrap, "jax": jax.__version__,
               "device": str(jax.devices()[0])}
        t0 = time.time()
        out[f"graph_{mode}"] = run_graph(hcfg, mcfg, log)
        out[f"graph_{mode}"]["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(out))
        return
    if args.mode in ("gather", "onehot_full"):
        ap.error(f"--mode {args.mode} needs --graph")
    args.mode = args.mode or "sub4_onehot_dense"
    args.seed = 0 if args.seed is None else args.seed
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
    modes = (("fixed", base),
             ("onehot_bf16_dense",
              base.overlay({"matcher_mode": "onehot_bf16",
                            "dense_free_fill": True})))
    if args.exit:
        modes = (("onehot_bf16_dense_exit",
                  base.overlay({"matcher_mode": "onehot_bf16",
                                "dense_free_fill": True,
                                "early_exit_tol": 1e-3})),)
    for name, cfg in modes:
        t0 = time.time()
        out[name] = run_mode(cfg, base, log)
        out[name]["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
