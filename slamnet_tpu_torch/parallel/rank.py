"""One rank of a ``parallel.launch``: bring up the world, run the target.

Run as ``python -m slamnet_tpu_torch.parallel.rank SPEC`` (``launch`` does;
``RANK`` and ``LOCAL_RANK`` are in the environment).  It first makes the
rank's card current (``mesh.bind_device``: ``cuda:LOCAL_RANK``), before the
target is imported and before the world comes up.  With the ``"file"``
rendezvous it calls
``mesh.init_world`` on the spec's ``file://`` store; with ``"env"`` the
target brings the world up itself (``mesh.initialize_multihost``).  The
target's JSON-able result is written to ``result_{rank}.json`` in the
spec's directory; an exception prints its traceback and exits 1.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
from pathlib import Path

import torch.distributed as dist

from . import mesh


def main(spec_path: str) -> int:
    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    mesh.bind_device(spec["backend"])
    if spec["rendezvous"] == "file":
        mesh.init_world(spec["backend"], spec["init_method"], rank,
                        spec["world_size"], spec["timeout_s"])
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**spec["kwargs"])
    if dist.is_initialized():
        dist.destroy_process_group()
    (Path(spec["out"]) / f"result_{rank}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
