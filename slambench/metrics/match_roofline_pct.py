"""The scan match's share of its roofline (%): the least time its work
needs on the card over the traced time of the match kernels.

The work is the algorithm's, from the cell's shapes, whatever implements
it.  A match of one robot runs sum(estimate_iterations) Gauss-Newton
iterations over its ceil(N / match_subsample) matcher beams.  A
beam-iteration is OPS_PER_BEAM_ITERATION f32 operations: the rotation
into the map (8), the bilinear weights (4), the interpolated value and its
two gradients (21), the four neighbours' sigmoids (12), the rotation
derivative (9), the in-map test (4) and the eleven products and sums of
the normal equations (22).  The bytes are each input read once and each
output written once: the matcher beams' points (8 B) and flags (1 B), the
hint (12 B), the answer (28 B), and the four neighbour cells (4 B each)
of every beam at every level.  The least time is the larger of the
operations over the f32 peak and the bytes over HBM's; at the cells' shapes
the operations bound it.  A step runs one match for every robot.
"""
import math

OPS_PER_BEAM_ITERATION = 80
KERNELS = ("match_kernel", "exit_finish_kernel")


def work(hector: dict, robots: int, beams: int):
    """(f32 operations, bytes) of one step's match of every robot."""
    n = math.ceil(beams / hector["match_subsample"])
    levels = hector["num_levels"]
    iters = sum(hector["estimate_iterations"][:levels])
    ops = robots * n * iters * OPS_PER_BEAM_ITERATION
    nbytes = robots * (n * 9 + 12 + 28 + 4 * 4 * n * levels)
    return ops, nbytes


def least_s(hector, robots, beams, peaks) -> tuple:
    ops, nbytes = work(hector, robots, beams)
    t_ops = ops / peaks["fp32_flops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def read(ctx):
    t_us = sum(e - s for name, s, e in ctx["summary"]["device_ops"]
               if any(k in name for k in KERNELS))
    if not t_us:
        return None
    least, _ = least_s(ctx["hector"], ctx["robots"], ctx["beams"],
                       ctx["peaks"])
    return 100.0 * least * ctx["steps"] / (t_us * 1e-6)
