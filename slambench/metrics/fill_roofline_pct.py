"""The map update's share of its roofline (%): the least time its work
needs on the card over the traced time of the map-update kernels (the dense
fill K2, or the line update K4).

The work is the algorithm's, whatever implements it: each update that
fired reads its scan once (8 B a point, 1 B a flag, the 12-B pose) and
reads and writes once every cell it marks (4 + 4 B), counted over every
level by the reference's own marking rule (``reference.changed_cells``)
at the poses the program used; every robot's fire flag is read once a step
(1 B).  No arithmetic is counted: the bytes bound it.  Gated steps, which
change nothing, add kernel time and no work.
"""
KERNELS = ("fill_kernel", "line_kernel")


def least_s(ctx) -> float:
    """The least time of the traced steps' map updates on the card (s)."""
    nbytes = (ctx["map_updates"] * (ctx["beams"] * 9 + 12)
              + ctx["cells_changed"] * 8 + ctx["steps"] * ctx["robots"])
    return nbytes / ctx["peaks"]["hbm_bytes_per_s"]


def read(ctx):
    t_us = sum(e - s for name, s, e in ctx["summary"]["device_ops"]
               if any(k in name for k in KERNELS))
    if not t_us:
        return None
    return 100.0 * least_s(ctx) / (t_us * 1e-6)
