"""Ops of the Hector path: GN math, K1 (match), the dense fill and K2 (fill).

Each kernel module holds its CUDA wrapper (a launch count on the wrapper
function) beside its plain PyTorch version; the wrapper takes the plain
version only for tensors on the CPU.
"""
from . import fill, gn, logodds, match

__all__ = ["fill", "gn", "logodds", "match"]
