"""slamnet_tpu_torch: the PyTorch + CUDA port of slamnet_tpu for NVIDIA Hopper.

The JAX package ``slamnet_tpu`` is the reference; this package imports torch
and never jax.  It holds the single-robot Hector pipeline (``models.hector``,
the reference-exact ``fixed`` mode and ``pallas_dense``) and the fleet that
tracks B robots on one card (``models.fleet``, ``sub1`` and
``sub4_pallas_dense``) over hand-written CUDA kernels: the coarse-to-fine
Gauss-Newton match on the bf16-rounded table for one robot (K1), one block a
robot (K5) or g_pack robots a block (K6), and on the f32 table (K3, single
or one block a robot) in ``ops.match``; the dense polar occupancy fill (K2)
in ``ops.fill`` and the Bresenham line update (K4) in ``ops.line``, each
single or batched with per-robot fire flags; built from ``csrc/`` with nvcc
at first use.  Each kernel wrapper runs its plain
PyTorch version for CPU tensors (tests) and the kernel for CUDA tensors.
Graph-SLAM (``models.graph_slam``) runs the same kernels at its frontend's
shape; CoreSLAM (``models.coreslam``) runs PyTorch operators, as the JAX
package runs it in XLA.  The host surface: the reference's processor objects
(``compat``), CARMEN logs (``io.datasets``, the native parser in ``hostio``)
and their replay (``replay.carmen_replay``), checkpoints, metrics, export and
the interactive simulator (``io``).  ``python3 chip_smoke.py`` drives every
path on the card.
"""
from . import core, io, models, ops, sim

__all__ = ["core", "io", "models", "ops", "sim"]
