"""slamnet_tpu_torch config mirror + import isolation.

The port copies ``core/config.py`` (pure Python) because ``slamnet_tpu.core``
imports jax; these tests hold the copy equal to the JAX package's, field by
field, and check that importing the port never pulls in jax.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from slamnet_tpu.core import config as jcfg
from slamnet_tpu_torch.core import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["CoreSlamConfig", "HectorConfig", "SimConfig", "ParticleConfig",
           "PoseGraphConfig", "SlamConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_mirrors_jax_field_by_field(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [(f.name, str(f.type)) for f in jf] == \
        [(f.name, str(f.type)) for f in tf]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert j.__dataclass_params__.frozen and t.__dataclass_params__.frozen


def test_hector_properties_overlay_and_serving_profile():
    over = {"map_size": 160, "map_resolution": 0.25, "num_levels": 3,
            "estimate_iterations": (7, 4, 4)}
    j, t = jcfg.HectorConfig().overlay(over), tcfg.HectorConfig().overlay(over)
    for prop in ("level_sizes", "level_resolutions", "level_offsets",
                 "total_cells", "log_odds_free", "log_odds_occupied"):
        assert getattr(j, prop) == getattr(t, prop), prop
    nested = '{"hector": {"num_levels": 2}, "sim": {"measure_error": 0.05}}'
    assert dataclasses.asdict(jcfg.SlamConfig().overlay(nested)) == \
        dataclasses.asdict(tcfg.SlamConfig().overlay(nested))
    assert dataclasses.asdict(jcfg.serving_hector_config(map_size=200)) == \
        dataclasses.asdict(tcfg.serving_hector_config(map_size=200))


def test_import_never_pulls_in_jax():
    # a subprocess: this test process already imported jax (tests/conftest.py)
    code = ("import sys, slamnet_tpu_torch, slamnet_tpu_torch.replay, "
            "slamnet_tpu_torch.entry, slamnet_tpu_torch.convert, "
            "slamnet_tpu_torch.models.fleet, slamnet_tpu_torch.models.graph_slam, "
            "slamnet_tpu_torch.graph.frontend, slamnet_tpu_torch.graph.posegraph, "
            "slamnet_tpu_torch.ops.bilinear, slamnet_tpu_torch.io.datasets, "
            "slamnet_tpu_torch.models.coreslam, slamnet_tpu_torch.ops.score, "
            "slamnet_tpu_torch.ops.correlate, slamnet_tpu_torch.ops.holemap, "
            "slamnet_tpu_torch.ops.obstacle, slamnet_tpu_torch.sim.field, "
            "slamnet_tpu_torch.sim.trajectory, "
            "slamnet_tpu_torch.models.particle, slamnet_tpu_torch.ops.match; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'slamnet_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
