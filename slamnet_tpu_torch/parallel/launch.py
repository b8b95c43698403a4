"""Start N ranks of a function as processes, and wait for them with a limit.

The port's launcher (JAX's multi-device code runs in one process under
``shard_map``; here each shard is a process).  ``launch`` starts
``world_size`` processes of ``python -m slamnet_tpu_torch.parallel.rank``,
each of which brings up the world and calls ``target`` (``"module:function"``,
importable in a fresh interpreter) with ``kwargs`` (JSON); what each rank's
call returns (JSON-able) comes back as the list ``launch`` returns, rank by
rank.

Rendezvous: ``"file"`` (default) gives ``init_process_group`` a ``file://``
store in a temporary directory; ``"env"`` sets torchrun's variables
(``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and leaves the
bring-up to the target (``mesh.initialize_multihost``).  Every rank runs on
this host: rank r gets ``LOCAL_RANK = r`` and so takes ``cuda:r``
(``mesh.rank_device``; ranks beyond the cards share them round-robin, which
only gloo allows), and ``LOCAL_WORLD_SIZE`` is the world size.

The wait has its own limit (``timeout_s``): when it expires, or when any
rank exits with an error, every rank is killed and ``RankError`` is raised
with each rank's exit code and the tail of its output.  A deadlock fails
the call that waits on it, never stalls its caller.  Each rank runs with
``OMP_NUM_THREADS=1``: N ranks share the host's cores.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
TAIL_BYTES = 6000


class RankError(RuntimeError):
    """A launch failed: a rank exited with an error, or the wait expired."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path) -> str:
    data = path.read_bytes() if path.exists() else b""
    return data[-TAIL_BYTES:].decode("utf-8", "replace")


def launch(target: str, world_size: int, kwargs: dict | None = None, *,
           backend: str, timeout_s: float, rendezvous: str = "file",
           pythonpath: Sequence[str] = ()) -> List[Any]:
    """Run ``target(**kwargs)`` on ``world_size`` ranks (``backend`` "gloo"
    or "nccl") and return each rank's result; raise ``RankError`` if a rank
    fails or the ranks are not done within ``timeout_s`` seconds."""
    if rendezvous not in ("file", "env"):
        raise ValueError(f"rendezvous must be 'file' or 'env', got "
                         f"{rendezvous!r}")
    work = Path(tempfile.mkdtemp(prefix="slamnet_launch_"))
    spec = {"target": target, "kwargs": kwargs or {}, "backend": backend,
            "world_size": world_size, "rendezvous": rendezvous,
            "init_method": f"file://{work / 'rendezvous'}",
            "timeout_s": timeout_s, "out": str(work)}
    (work / "spec.json").write_text(json.dumps(spec))
    path = os.pathsep.join([str(REPO_ROOT), *map(str, pythonpath),
                            os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    base_env = dict(os.environ, PYTHONPATH=path,
                    OMP_NUM_THREADS="1",
                    WORLD_SIZE=str(world_size),
                    LOCAL_WORLD_SIZE=str(world_size))
    if rendezvous == "env":
        base_env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs, logs = [], []
    try:
        for r in range(world_size):
            log = work / f"rank{r}.log"
            logs.append(log)
            with open(log, "wb") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "slamnet_tpu_torch.parallel.rank",
                     str(work / "spec.json")],
                    env=dict(base_env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=fh, stderr=subprocess.STDOUT, cwd=REPO_ROOT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                why = f"rank(s) {failed} exited with an error"
                break
            if all(c == 0 for c in codes):
                return [json.loads((work / f"result_{r}.json").read_text())
                        for r in range(world_size)]
            if time.monotonic() > deadline:
                why = f"ranks not done within {timeout_s:.0f} s"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        report = "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{_tail(log)}"
            for r, (p, log) in enumerate(zip(procs, logs)))
        raise RankError(f"launch of {target} on {world_size} ranks: {why}\n"
                        f"{report}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
