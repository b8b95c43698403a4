"""Ops of the Hector paths: GN math, K1/K3/K5/K6 (match), the dense fill and
K2 (fill), the Bresenham line update and K4 (rasterize, logodds, line), each
single and batched.

Each kernel module holds its CUDA wrapper (a launch count on the wrapper
function) beside its plain PyTorch version; the wrapper takes the plain
version only for tensors on the CPU.
"""
from . import fill, gn, line, logodds, match, rasterize

__all__ = ["fill", "gn", "line", "logodds", "match", "rasterize"]
