"""Ops of the Hector paths: GN math, K1/K5/K6 (match), the dense fill and K2
(fill, single and batched).

Each kernel module holds its CUDA wrapper (a launch count on the wrapper
function) beside its plain PyTorch version; the wrapper takes the plain
version only for tensors on the CPU.
"""
from . import fill, gn, logodds, match

__all__ = ["fill", "gn", "logodds", "match"]
