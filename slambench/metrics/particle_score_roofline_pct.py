"""The particle layer's scoring share of its roofline (%): the least time
the traced scans' scoring work needs on the card over the card's busy time
in the traced stretch (the union of its operations).

The work is the algorithm's, from the cell's shapes, whatever implements
it (today PyTorch's operators; later, perhaps, K8's scoring half).  A scan
scores two batches of poses against the hole map: the population (P) and
the top-k's refinements (k x r).  As K8 is counted (PERF.md section 6), a
pose and a valid beam are OPS_PER_POSE_BEAM f32 operations (the rotation
and translation into the map, 4 multiplies and 4 adds); each batch reads
the map (4 B a pixel), the scan's points (8 B) and flags (1 B) and its
poses (12 B) once.  A scan's least time is the larger of its operations
over the f32 peak and its bytes over HBM's; at the cell's shapes the
operations bound it.  Every traced scan scores, the warm-up's too.
"""
from slambench import harness as H

OPS_PER_POSE_BEAM = 8


def work(w: dict, valid: int) -> tuple:
    """(f32 operations, bytes) of one scan's two scoring batches with
    ``valid`` valid beams."""
    ops = sum(w["batches"]) * valid * OPS_PER_POSE_BEAM
    nbytes = sum(w["map_pixels"] * 4 + w["beams"] * 9 + b * 12
                 for b in w["batches"])
    return ops, nbytes


def least_s(w: dict, peaks: dict) -> float:
    """The least time of the traced scans' scoring on the card (s)."""
    total = 0.0
    for valid in w["valid_beams"]:
        ops, nbytes = work(w, valid)
        total += max(ops / peaks["fp32_flops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return total


def read(ctx):
    busy_us = H.busy_us(ctx["summary"]["device_ops"])
    if not busy_us:
        return None
    return 100.0 * least_s(ctx["work"], ctx["peaks"]) / (busy_us * 1e-6)
