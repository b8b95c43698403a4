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
# the port's fields that JAX's config lacks, with the default each must
# keep: the constant the JAX package writes in their place
# (slamnet_tpu/models/graph_slam.py's loop-candidate gap, 5)
PORT_ONLY = {"PoseGraphConfig": {"loop_min_index_gap": 5}}


def _mirrored(d: dict) -> dict:
    """A port config's ``asdict`` without its port-only fields, nested
    groups included."""
    drop = {k for extra in PORT_ONLY.values() for k in extra}
    return {k: _mirrored(v) if isinstance(v, dict) else v
            for k, v in d.items() if k not in drop}


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_mirrors_jax_field_by_field(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    extra = PORT_ONLY.get(name, {})
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [(f.name, str(f.type)) for f in jf] == \
        [(f.name, str(f.type)) for f in tf if f.name not in extra]
    assert dataclasses.asdict(j()) == _mirrored(dataclasses.asdict(t()))
    for k, v in extra.items():
        assert getattr(t(), k) == v, k
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
        _mirrored(dataclasses.asdict(tcfg.SlamConfig().overlay(nested)))
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
            "slamnet_tpu_torch.models.particle, slamnet_tpu_torch.ops.match, "
            "slamnet_tpu_torch.compat, slamnet_tpu_torch.hostio, "
            "slamnet_tpu_torch.core.debug, slamnet_tpu_torch.io.checkpoint, "
            "slamnet_tpu_torch.io.export, slamnet_tpu_torch.io.metrics, "
            "slamnet_tpu_torch.io.live, slamnet_tpu_torch.io.viz, "
            "slamnet_tpu_torch.io.interactive, slamnet_tpu_torch.sim.lidar, "
            "slamnet_tpu_torch.parallel, slamnet_tpu_torch.parallel.mesh, "
            "slamnet_tpu_torch.parallel.launch, "
            "slamnet_tpu_torch.parallel.rank, "
            "slamnet_tpu_torch.parallel.hessian, "
            "slamnet_tpu_torch.parallel.tiles, "
            "slamnet_tpu_torch.parallel.search, "
            "slamnet_tpu_torch.models.hector_sharded, "
            "slamnet_tpu_torch.models.coreslam_sharded, "
            "slamnet_tpu_torch.graph.distributed, "
            "slamnet_tpu_torch.graph.schur, "
            "slamnet_tpu_torch.models.graph_slam_sharded, "
            "slamnet_tpu_torch.bench, slamnet_tpu_torch.multichip, "
            "slamnet_tpu_torch.examples, "
            "slamnet_tpu_torch.examples.replay_demo, "
            "slamnet_tpu_torch.examples.replay_dataset, "
            "slamnet_tpu_torch.examples.record_and_replay, "
            "slamnet_tpu_torch.examples.interactive_sim; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'slamnet_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
