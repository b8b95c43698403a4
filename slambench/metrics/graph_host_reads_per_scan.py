"""The host's reads of a device value a graph-SLAM scan: the program's
counter ``graph_slam.update.syncs`` over the traced stretch, over its
scans (one gate read a scan, one more a keyframe event, one more a
searched event).  The kind hands the counts in; None where the program has
no such counter; moves ``scans_per_s``."""


def read(ctx):
    counts = ctx.get("counters")
    if not counts or counts.get("syncs") is None or not ctx.get("steps"):
        return None
    return counts["syncs"] / ctx["steps"]
