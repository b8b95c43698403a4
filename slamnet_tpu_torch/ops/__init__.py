"""Ops of the Hector paths: GN math, K1/K3/K5/K6 (match), the dense fill and
K2 (fill), the Bresenham line update and K4 (rasterize, logodds, line), each
single and batched; and CoreSLAM's: the Monte-Carlo score (score), the
correlative search (correlate), the hole and obstacle map updates (holemap,
obstacle) and their walks (rasterize).

Each kernel module holds its CUDA wrapper (a launch count on the wrapper
function) beside its plain PyTorch version; the wrapper takes the plain
version only for tensors on the CPU.  CoreSLAM's line-mode map updates
(K7, holemap and obstacle) and its Monte-Carlo search's scores and first
minimum (K8, score.best_of) are hand-written kernels; its other ops are
PyTorch operators on the tensors' device.  The JAX package computes all of
CoreSLAM in XLA, with no Pallas kernel to port.  ``score_cases`` holds
K8's check cases.
"""
from . import (correlate, fill, gn, holemap, line, logodds, match, obstacle,
               rasterize, score)

__all__ = ["correlate", "fill", "gn", "holemap", "line", "logodds", "match",
           "obstacle", "rasterize", "score"]
