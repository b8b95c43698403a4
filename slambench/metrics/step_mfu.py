"""The whole step's share of the card's peak (%): the least time of every
step's match and map-update work (the counts of ``match_roofline_pct`` and
``fill_roofline_pct``) over the traced window's wall time.  A kernel taken
off the path leaves its own roofline silent; this share still bounds the
step."""
import importlib.util
from pathlib import Path


def _sibling(name):
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name}", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(ctx):
    window = ctx["summary"]["window_s"]
    if not ctx["summary"]["device_ops"] or window <= 0:
        return None
    match, _ = _sibling("match_roofline_pct").least_s(
        ctx["hector"], ctx["robots"], ctx["beams"], ctx["peaks"])
    least = match * ctx["steps"] + _sibling("fill_roofline_pct").least_s(ctx)
    return 100.0 * least / window
