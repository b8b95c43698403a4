"""The multi-device layer: a named-axis mesh over ``torch.distributed``
(``mesh``), its launcher (``launch``), and the sharded building blocks —
beam-sharded Gauss-Newton sums (``hessian``), map-row tiles with a halo
(``tiles``) and a candidate-sharded Monte-Carlo search (``search``)."""
from . import hessian, launch, mesh, search, tiles
from .mesh import (Mesh, host_local_scans_to_global, initialize_multihost,
                   make_mesh, rank_device, shard_range)

__all__ = ["hessian", "launch", "mesh", "search", "tiles", "Mesh",
           "make_mesh", "initialize_multihost", "host_local_scans_to_global",
           "rank_device", "shard_range"]
