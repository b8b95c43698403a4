"""slamnet_tpu_torch: the PyTorch + CUDA port of slamnet_tpu for NVIDIA Hopper.

The JAX package ``slamnet_tpu`` is the reference; this package imports torch
and never jax.  It holds the single-robot Hector ``pallas_dense`` pipeline:
``models.hector`` over two hand-written CUDA kernels, K1 (``ops.match``, the
coarse-to-fine Gauss-Newton match) and K2 (``ops.fill``, the dense polar
occupancy fill), built from ``csrc/`` with nvcc at first use.  Each kernel
wrapper runs its plain PyTorch version for CPU tensors (tests) and the kernel
for CUDA tensors.  ``python3 chip_smoke.py`` drives it on the card.
"""
from . import core, models, ops, sim

__all__ = ["core", "models", "ops", "sim"]
