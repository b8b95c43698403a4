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

``--fleet --matcher gather|onehot_bf16`` swaps the mode's matcher, and
``--fleet --eager`` runs JAX op by op (``jax.disable_jit``): the capped
rows' numbers move with XLA's fusion (PERF.md section 6, PR 8).

``--office`` runs bench's office loop (``bench.py:318-431``) over
``make_office_log(3)`` with ``office_odometry``'s drifting odometry: Hector
alone and graph-SLAM, each scan hinted with the match pose plus the odometry
delta, the first 10 forced and then set to the odometry; every ``office_*``
number but the rate (``replay.OFFICE_JAX_REF_*``).

``--particle`` runs the particle layer (``bench.py:738-767``) over every scan
of ``make_log(0)``, the state's own pose as the odometry, from
``PRNGKey(--seed)`` (default 1): ``--mode exact|sub4|grid|grid_small|
grid_dense`` (``replay.PARTICLE_MODES``, default exact): ATE and max error
over every scan, and the resample count (``replay.PARTICLE_JAX_REF_ATES_M``
and ``PARTICLE_GRID_DENSE_JAX_REF_ATES_M`` hold keys 1-9).

``--coreslam`` runs CoreSLAM (``bench.py:825-875``) over every scan of
``make_log(0)``, the state's own pose as the odometry: ``--mode
production`` (correlative search, dense fills; ``replay.
CORESLAM_JAX_REF_ATE_M``) or ``parity`` (Monte-Carlo with 4096 candidates,
line updates) under ``PRNGKey(--seed)`` (default 1;
``replay.CORESLAM_PARITY_JAX_REF_ATES_M`` holds seeds 1-3); ``--nudge k``
starts from the first true pose with its x moved by k f32 ulps
(``replay.CORESLAM_JAX_REF_ATES_M`` holds k = 0, 1, -1, 2, -2).

Runs on the CPU (a few minutes); prints one JSON object.

    python scripts/torch_port_ref_ate.py [--seed 0] [--exit]
        [--fleet [--mode sub1]] [--graph [--mode onehot_full]] [--office]
        [--coreslam [--mode parity|production] [--seed 1] [--nudge 0]]
        [--particle [--mode exact|sub4|grid|grid_small|grid_dense]
         [--seed 1]]
"""
import argparse
import dataclasses
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
import torch  # noqa: E402

from slamnet_tpu.core import (CoreSlamConfig, HectorConfig,  # noqa: E402
                              ParticleConfig, PoseGraphConfig)
from slamnet_tpu.core.scan import Scan  # noqa: E402
from slamnet_tpu.graph import frontend  # noqa: E402
from slamnet_tpu.models import (coreslam, fleet, graph_slam,  # noqa: E402
                                hector, particle)
from slamnet_tpu_torch import replay as port  # noqa: E402
from slamnet_tpu_torch.replay import (GRAPH_SEED, ate_of,  # noqa: E402
                                      fleet_ate_of, make_fleet_log,
                                      make_graph_log, make_log)

FLEET_FIELDS = ("num_levels", "estimate_iterations", "xy_step_clamp_px",
                "max_match_jump", "match_subsample", "dense_free_fill",
                "matcher_mode", "fleet_update_capacity", "early_exit_tol")
# the fleet modes: bench.py's names (sub4_onehot_dense is the port's
# sub4_pallas_dense, K5's selection) -> replay.FLEET_MODES
FLEET_PORT_MODES = {"sub4_onehot_dense": "sub4_pallas_dense", "sub1": "sub1",
                    "sub4": "sub4", "sub4_onehot": "sub4_onehot",
                    "sub4_onehot_cap8": "sub4_onehot_cap8",
                    "sub4_onehot_cap32": "sub4_onehot_cap32",
                    "sub1_exit": "sub1_exit",
                    "sub4_onehot_exit": "sub4_onehot_exit"}


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
            return sts, (sts.match_pose, info.map_updated, info.solve_failures,
                         info.gn_iterations[0])
        return jax.lax.scan(body, states, (radii, valids))

    states = fleet.init_fleet(cfg, flog.traj[0])
    for t in range(b):
        states = boot_step(states, radii[t], valids[t], traj[t])
    _, (poses, upd, fails, iters) = replay(states, radii[b:], valids[b:])
    ate, mx, med = fleet_ate_of(np.asarray(poses), flog.traj[b:])
    return {"ate_m": ate, "max_err_m": mx, "ate_median_m": med,
            "map_updates": int(np.asarray(upd).sum()),
            "solve_failures": int(np.asarray(fails).sum()),
            "gn_iterations": int(np.asarray(iters).sum())}


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


def run_office(log, num_levels=3, map_size=200, map_resolution=0.1):
    """bench.py's office flow (``bench.py:353-431``) over ``log``: the
    ``office_*`` numbers but the rate, unrounded."""
    odo, deltas = port.office_odometry(log.traj)
    angles = jnp.asarray(log.angles)
    pcfg, pg, pm = port.office_config()
    hcfg = HectorConfig(
        num_levels=num_levels, map_size=map_size,
        map_resolution=map_resolution,
        estimate_iterations=pcfg.estimate_iterations[:num_levels],
        xy_step_clamp_px=pcfg.xy_step_clamp_px,
        max_match_jump=pcfg.max_match_jump, gn_damping=pcfg.gn_damping,
        min_match_in_map_frac=pcfg.min_match_in_map_frac)
    gcfg = PoseGraphConfig(keyframe_dist=pg.keyframe_dist,
                           loop_closure_radius=pg.loop_closure_radius)
    mcfg = frontend.ScanMatchConfig(matcher_mode=pm.matcher_mode,
                                    dense_fill=pm.dense_fill)
    n = log.radii.shape[0]
    force = jnp.arange(n) < log.bootstrap
    xs = (jnp.asarray(log.radii), jnp.asarray(log.valid), force,
          jnp.asarray(deltas), jnp.asarray(odo))

    def cloud(r, v):
        pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
        return Scan(pts, v, jnp.zeros(3, jnp.float32))

    @jax.jit
    def replay_hector(state, xs):
        def body(st, inp):
            r, v, f, d, o = inp
            st, _ = hector.update(st, cloud(r, v), st.match_pose + d, hcfg, f)
            st = st._replace(match_pose=jnp.where(f, o, st.match_pose))
            return st, st.match_pose
        return jax.lax.scan(body, state, xs)

    @jax.jit
    def replay_graph(state, xs):
        def body(st, inp):
            r, v, f, d, o = inp
            st = st._replace(hector=st.hector._replace(
                match_pose=st.hector.match_pose + d))
            st, info = graph_slam.update(st, cloud(r, v), hcfg, gcfg,
                                         mcfg=mcfg, map_without_matching=f)
            st = st._replace(hector=st.hector._replace(
                match_pose=jnp.where(f, o, st.hector.match_pose)))
            return st, (st.hector.match_pose, info.keyframe_added)
        return jax.lax.scan(body, state, xs)

    _, h_track = replay_hector(hector.init(hcfg, log.traj[0]), xs)
    stf, (g_track, kf) = replay_graph(
        graph_slam.init(hcfg, gcfg, log.traj[0], int(angles.shape[0])), xs)
    out = port.office_metrics(log.traj, np.asarray(h_track), _NpGraph(stf),
                              np.asarray(g_track), np.asarray(kf))
    return out, np.asarray(h_track), np.asarray(g_track), np.asarray(kf)


class _NpGraph:
    """A JAX graph-SLAM state as ``office_metrics`` reads it: the node
    count, the closures, the graph's poses as a torch tensor."""

    def __init__(self, st):
        self.nodes = int(np.asarray(st.graph.num_nodes))
        self.loop_count = int(np.asarray(st.loop_count))
        self.graph = st.graph._replace(
            poses=torch.from_numpy(np.array(st.graph.poses)))


def run_coreslam(cfg, log, seed, nudge=0):
    """bench.py's CoreSLAM flow (``bench.py:830-856``) over every scan of
    ``log``, from the first true pose with its x moved by ``nudge`` f32 ulps
    (``replay.nudged_start``): ATE and max error over every scan, scans
    searched."""
    angles = jnp.asarray(log.angles)

    @jax.jit
    def replay(state, radii, valids):
        def body(st, inp):
            r, v = inp
            pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
            st, info = coreslam.update_cloud(
                st, Scan(pts, v, jnp.zeros(3, jnp.float32)), st.pose, cfg)
            return st, (st.pose, info.searched)
        return jax.lax.scan(body, state, (radii, valids))

    start = port.nudged_start(torch.from_numpy(log.traj[0]), nudge).numpy()
    state = coreslam.init(cfg, start, key=jax.random.PRNGKey(seed))
    _, (poses, searched) = replay(state, jnp.asarray(log.radii),
                                  jnp.asarray(log.valid))
    ate, mx = ate_of(np.asarray(poses), log.traj)
    return {"ate_m": ate, "max_err_m": mx,
            "searched": int(np.asarray(searched).sum())}


def run_particle(ccfg, pcfg, log, seed):
    """bench.py's particle flow (``bench.py:738-767``) over every scan of
    ``log`` from its first true pose under ``PRNGKey(seed)``: ATE and max
    error over every scan, the resample count."""
    angles = jnp.asarray(log.angles)

    @jax.jit
    def replay(state, radii, valids):
        def body(st, inp):
            r, v = inp
            pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
            st, info = particle.update(
                st, Scan(pts, v, jnp.zeros(3, jnp.float32)), st.pose, ccfg,
                pcfg)
            return st, (st.pose, info.resampled)
        return jax.lax.scan(body, state, (radii, valids))

    state = particle.init(ccfg, pcfg, log.traj[0], key=jax.random.PRNGKey(seed))
    _, (poses, resampled) = replay(state, jnp.asarray(log.radii),
                                   jnp.asarray(log.valid))
    ate, mx = ate_of(np.asarray(poses), log.traj)
    return {"ate_m": ate, "max_err_m": mx,
            "resamples": int(np.asarray(resampled).sum())}


def _jax_cfg(cls, cfg):
    """The JAX config with the port config's fields."""
    return cls(**dataclasses.asdict(cfg))


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
    ap.add_argument("--office", action="store_true",
                    help="the office loop: Hector alone and graph-SLAM")
    ap.add_argument("--coreslam", action="store_true",
                    help="CoreSLAM over the loop log")
    ap.add_argument("--particle", action="store_true",
                    help="the particle layer over the loop log")
    ap.add_argument("--matcher", choices=("gather", "onehot_bf16"),
                    help="fleet: run the mode with this matcher_mode")
    ap.add_argument("--eager", action="store_true",
                    help="fleet: run JAX op by op (jax.disable_jit), where "
                         "XLA fuses nothing")
    ap.add_argument("--nudge", type=int, default=0,
                    help="CoreSLAM: move the start's x by this many f32 ulps")
    ap.add_argument("--mode", choices=(*FLEET_PORT_MODES, "gather",
                                       "onehot_full", "parity", "production",
                                       *port.PARTICLE_MODES),
                    help="the fleet's mode (default sub4_onehot_dense), the "
                         "graph's (default gather) or CoreSLAM's (default "
                         "production)")
    args = ap.parse_args()
    if args.office:
        log = port.make_office_log()
        out = {"seed": port.OFFICE_SEED, "n_scans": int(log.radii.shape[0]),
               "bootstrap": log.bootstrap, "jax": jax.__version__,
               "device": str(jax.devices()[0])}
        t0 = time.time()
        out["office"] = run_office(log)[0]
        out["office"]["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(out))
        return
    if args.particle:
        mode = args.mode or "exact"
        if mode not in port.PARTICLE_MODES:
            ap.error(f"--mode {mode} is not a particle mode")
        seed = 1 if args.seed is None else args.seed
        ccfg, pcfg = port.PARTICLE_MODES[mode]
        log = make_log(0)
        out = {"seed": seed, "n_scans": int(log.radii.shape[0]),
               "jax": jax.__version__, "device": str(jax.devices()[0])}
        t0 = time.time()
        out[f"particle_{mode}"] = run_particle(
            _jax_cfg(CoreSlamConfig, ccfg), _jax_cfg(ParticleConfig, pcfg),
            log, seed)
        out[f"particle_{mode}"]["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(out))
        return
    if args.mode in port.PARTICLE_MODES:
        ap.error(f"--mode {args.mode} needs --particle")
    if args.coreslam:
        mode = args.mode or "production"
        if mode not in ("parity", "production"):
            ap.error(f"--mode {mode} is not a CoreSLAM mode")
        seed = 1 if args.seed is None else args.seed
        pc = (port.coreslam_production_config() if mode == "production"
              else port.coreslam_parity_config())
        cfg = CoreSlamConfig(**{f: getattr(pc, f) for f in (
            "num_candidates", "search_mode", "dense_hole_fill",
            "dense_obstacle_fill")})
        log = make_log(0)
        out = {"seed": seed, "n_scans": int(log.radii.shape[0]),
               "jax": jax.__version__, "device": str(jax.devices()[0])}
        t0 = time.time()
        out["nudge_ulps"] = args.nudge
        out[f"coreslam_{mode}"] = run_coreslam(cfg, log, seed, args.nudge)
        out[f"coreslam_{mode}"]["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(out))
        return
    if args.mode in ("parity", "production"):
        ap.error(f"--mode {args.mode} needs --coreslam")
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
        port_cfg = port.FLEET_MODES[FLEET_PORT_MODES[args.mode]]()
        if args.mode == "sub4_onehot_dense":
            port_cfg = port_cfg.overlay({"matcher_mode": "onehot_bf16"})
        if args.matcher:
            port_cfg = port_cfg.overlay({"matcher_mode": args.matcher})
        cfg = HectorConfig(**{f: getattr(port_cfg, f) for f in FLEET_FIELDS})
        out["robots"], out["n_batch_scans"] = flog.radii.shape[1], \
            flog.radii.shape[0] - flog.bootstrap
        out["matcher_mode"], out["eager"] = cfg.matcher_mode, args.eager
        name = f"fleet_{args.mode}"
        t0 = time.time()
        if args.eager:
            with jax.disable_jit():
                out[name] = run_fleet(cfg, flog)
        else:
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
