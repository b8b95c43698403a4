"""The median latency of a live scan (ms): from its due time to its pose on
the host, over the window's scans before the traced stretch.  Host clock;
moves ``scans_in_time_pct``."""
from slambench import harness as H


def read(ctx):
    lat = ctx.get("latency_s")
    return H.percentile(lat, 50) * 1e3 if lat is not None and len(lat) else None
