"""The port's command-line examples, the counterparts of ``examples/*.py``.

Run each as ``python -m slamnet_tpu_torch.examples.<name>``: ``replay_demo``
(simulator -> pipelines -> ATE), ``replay_dataset`` (a CARMEN log through
both pipelines), ``record_and_replay`` (a scan log written and replayed
through the native host path) and ``interactive_sim`` (the browser
simulator).  Each runs on the card unless ``--device cpu`` is given, with
no fallback: without a card it exits non-zero at once.
"""
from __future__ import annotations

import sys

import torch


def device_or_exit(name: str, prog: str) -> torch.device:
    """``torch.device(name)``; exits with status 2 and a message when it
    names the card and there is none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs on the CPU", file=sys.stderr)
        raise SystemExit(2)
    return dev
