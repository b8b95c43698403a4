"""A named-axis device mesh over a ``torch.distributed`` world.

Port of ``slamnet_tpu/parallel/mesh.py``.  JAX lays a ``jax.sharding.Mesh``
over devices and runs one SPMD program under ``shard_map``; here each shard
is a process (a rank), and the mesh names how the ranks are laid out and
which process groups each axis talks over.  Axis conventions (as JAX's):

  'search' — data parallelism over Monte-Carlo candidates / instances
  'beam'   — the lidar beam axis (partial sums of the Gauss-Newton system)
  'tile'   — map-row tiling, a 1-row halo exchanged with the south neighbour
  'edge'   — pose-graph constraint edges

Layout: the mesh covers the first prod(sizes) ranks of the world, row-major
over the axes in the order given, as ``make_mesh`` lays ``jax.devices()[:n]``
out: for ``{"tile": T, "search": S}`` rank ``r = t * S + s`` holds tile ``t``
and search index ``s``.  Each axis has one process group per line of ranks
along it (every other coordinate fixed); a collective over every axis uses
the mesh's own group (the world's when the mesh covers it).  Every rank of
the world builds every mesh, in the same order: ``dist.new_group`` must be
called by all ranks for every group.  A rank outside the mesh
(``mesh.member`` False) takes part in no collective of it.

The collectives are JAX's, on tensors on the mesh's device: ``psum`` /
``pmax`` / ``pmin`` (``all_reduce`` SUM / MAX / MIN; the result is the same
bits on every rank), ``all_gather`` (``tiled`` concatenates, else stacks),
``ppermute`` (``batch_isend_irecv`` between the axis line's ranks; a rank
that receives nothing gets zeros, as JAX gives), ``axis_index`` and
``axis_size``.

The backend is the caller's choice, made when the world is initialised and
never switched: ``"nccl"`` needs a card a rank and raises when the host has
more ranks than cards (NCCL refuses two ranks on one device); ``"gloo"`` is
for the CPU and for ranks that share a card.  On gloo, a tensor on a card
is copied to the host before the collective and back after it, in one place
(``_host`` / ``_back``), and ``counts["host_copies"]`` counts each copy;
``counts["collectives"]`` counts the collectives.  Their cost on the card
is the NCCL kernels' time in a device trace (``multichip``).  Nothing falls
back to the CPU and no failed collective is caught.

Each rank computes on ``cuda:LOCAL_RANK`` (``rank_device``), made the
current device before its world comes up (``bind_device``; NCCL's
point-to-point calls can hang without it), and an NCCL world is created
with that card as its ``device_id``.

``initialize_multihost`` brings a world up from torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``);
``host_local_scans_to_global`` is JAX's per-host scan feeding, which here is
a rank keeping its own slice: there is no global array to build.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Iterable, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, else the
    global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: torch.device | str | None = None) -> torch.device:
    """The device a rank computes on: ``device`` when given, else the card
    ``cuda:{local_rank % device_count}`` (ranks beyond the host's cards
    share them round-robin; only gloo allows that)."""
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: a rank runs on the card unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda", local_rank() % n)


def check_backend(backend: str, local_world: int) -> None:
    """Refuse a backend that cannot serve ``local_world`` ranks on this
    host: NCCL needs one card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"backend 'nccl' needs a card a rank: {local_world} ranks on "
                f"a host with {cards} card(s) (NCCL refuses two ranks on one "
                "device); use backend='gloo' for ranks that share a card")


def bind_device(backend: str) -> torch.device | None:
    """Make this rank's card (``rank_device()``) the current device and
    return it; under gloo on a host without a card (CPU ranks) bind nothing
    and return None.  Under NCCL a rank that finds no card raises."""
    if backend == "nccl" or torch.cuda.is_available():
        dev = rank_device()
        torch.cuda.set_device(dev)
        return dev
    return None


def init_world(backend: str, init_method: str, rank: int, world_size: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``dist.init_process_group`` with the backend checked, the rank bound
    to its card first (NCCL's world is created on it, ``device_id``) and
    every collective bounded by ``timeout_s`` (a rank stuck in one raises).
    ``LOCAL_WORLD_SIZE`` (default the world size: one host) is the number
    of ranks that share this host's cards."""
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size)))
    dev = bind_device(backend)
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **extra)


def initialize_multihost(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> None:
    """Multi-process bring-up from torchrun's environment: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` for the card a rank takes, which is made current
    before the world comes up).  The counterpart of
    ``jax.distributed.initialize``; afterwards ``make_mesh`` lays axes over
    the world.  ``backend`` is required: ``"nccl"`` (a card a rank) or
    ``"gloo"``."""
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                           "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize_multihost: the environment lacks "
                           f"{missing} (torchrun sets them)")
    init_world(backend, "env://", int(os.environ["RANK"]),
               int(os.environ["WORLD_SIZE"]), timeout_s)


class Mesh:
    """Named axes over the first prod(sizes) ranks of the world (see the
    module docstring).  Build it on every rank, in the same order as every
    other mesh."""

    def __init__(self, axes: Mapping[str, int],
                 device: torch.device | str | None = None):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialised world "
                               "(initialize_multihost or parallel.launch)")
        self.names: Tuple[str, ...] = tuple(axes)
        self.sizes: Tuple[int, ...] = tuple(int(v) for v in axes.values())
        self.shape = dict(zip(self.names, self.sizes))
        self.size = math.prod(self.sizes)
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} "
                             f"ranks; the world has {world}")
        self.rank = dist.get_rank()
        self.member = self.rank < self.size
        self.backend = dist.get_backend()
        self.device = rank_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("backend 'nccl' runs on the card; got device "
                             f"{self.device}")
        self.coords = self._coords(self.rank) if self.member else None
        self.counts = {"collectives": 0, "host_copies": 0}
        # every rank creates every group, in this order
        all_ranks = list(range(self.size))
        if self.size == world:
            self._all = (None, all_ranks)
        else:
            g = dist.new_group(all_ranks)
            self._all = (g, all_ranks)
        self._lines = {}
        for axis in self.names:
            for line in self._axis_lines(axis):
                g = dist.new_group(line) if line != all_ranks else self._all[0]
                if self.rank in line:
                    self._lines[axis] = (g, line)
        if self.backend == "nccl" and self.member:
            # every group's communicator comes up here, all its ranks at
            # once, so no ppermute in which a rank sends and receives
            # nothing is a group's first call (batch_isend_irecv's rule)
            one = torch.zeros(1, device=self.device)
            for g, _ in (self._all, *(self._lines[a] for a in self.names)):
                dist.all_reduce(one, group=g)

    # ------------------------------------------------------------ layout
    def _coords(self, rank: int) -> dict:
        out, rem = {}, rank
        for name, size in reversed(list(zip(self.names, self.sizes))):
            out[name] = rem % size
            rem //= size
        return {n: out[n] for n in self.names}

    def _rank_of(self, coords: Mapping[str, int]) -> int:
        r = 0
        for name, size in zip(self.names, self.sizes):
            r = r * size + coords[name]
        return r

    def _axis_lines(self, axis: str) -> list:
        """The ranks of every line along ``axis``, in a fixed order."""
        others = [n for n in self.names if n != axis]
        lines = []
        for fixed in _product([self.shape[n] for n in others]):
            base = dict(zip(others, fixed))
            lines.append([self._rank_of({**base, axis: i})
                          for i in range(self.shape[axis])])
        return lines

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def _group(self, axes) -> tuple:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is outside the mesh "
                               f"{self.shape}")
        if set(axes) == set(self.names):
            return self._all
        if len(axes) != 1:
            raise NotImplementedError(f"collectives over {axes} of a mesh "
                                      f"{self.shape}: one axis or all")
        return self._lines[axes[0]]

    # --------------------------------------------------- host staging
    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer a collective works on: a host copy of a card tensor on
        gloo, else a copy on its device (the collectives work in place)."""
        if self._staged(x):
            self.counts["host_copies"] += 1
            return x.detach().to("cpu", copy=True)
        return x.detach().clone()

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self._staged(like):
            self.counts["host_copies"] += 1
            return buf.to(like.device)
        return buf

    # ------------------------------------------------------ collectives
    def _done(self) -> None:
        self.counts["collectives"] += 1

    def _reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        group, _ = self._group(axes)
        buf = self._host(x.contiguous())
        dist.all_reduce(buf, op=op, group=group)
        out = self._back(buf, x)
        self._done()
        return out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, axes, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor, axis: str,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, in axis order: stacked on a new
        leading dim, or (``tiled``) concatenated along dim 0."""
        group, line = self._group(axis)
        buf = self._host(x.contiguous())
        parts = [torch.empty_like(buf) for _ in line]
        dist.all_gather(parts, buf, group=group)
        out = self._back(torch.cat(parts) if tiled else torch.stack(parts), x)
        self._done()
        return out

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Send ``x`` from axis index ``src`` to ``dst`` for each pair of
        ``perm``; returns what this rank received, zeros if nothing."""
        group, line = self._group(axis)
        me = self.coords[axis]
        buf = self._host(x.contiguous())
        recv = torch.zeros_like(buf)
        ops = []
        for src, dst in perm:
            if src == me:
                ops.append(dist.P2POp(dist.isend, buf, line[dst], group))
            if dst == me:
                ops.append(dist.P2POp(dist.irecv, recv, line[src], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = self._back(recv, x)
        self._done()
        return out

    def barrier(self) -> None:
        group, _ = self._group(self.names)
        if self.backend == "nccl":
            dist.barrier(group=group, device_ids=[self.device.index])
        else:
            dist.barrier(group=group)
        self._done()


def _product(sizes: Sequence[int]) -> Iterable[tuple]:
    if not sizes:
        yield ()
        return
    for head in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (head,) + rest


def make_mesh(axes: Mapping[str, int],
              device: torch.device | str | None = None) -> Mesh:
    """A mesh of the given {axis_name: size} layout over the first
    prod(sizes) ranks of the world, on ``device`` (default the rank's card,
    ``rank_device``)."""
    return Mesh(axes, device)


def shard_range(n: int, mesh: Mesh, axis: str) -> Tuple[int, int]:
    """[start, stop) of this rank's contiguous share of ``n`` rows sharded
    over ``axis`` (n divisible by the axis size, as JAX's ``P(axis)``)."""
    size = mesh.axis_size(axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide over axis {axis!r} of "
                         f"size {size}")
    k = n // size
    i = mesh.axis_index(axis)
    return i * k, (i + 1) * k


def host_local_scans_to_global(mesh: Mesh, local_batch, axis: str
                               ) -> torch.Tensor:
    """Per-host scan feeding: JAX assembles a global array whose ``axis``
    dimension is sharded across processes from each process's local batch.
    Here a rank IS its shard, so there is no global array to build: the
    rank keeps ``local_batch`` (its own slice of the ``axis`` dimension, as
    ``shard_range`` gives it) and puts it on the mesh's device."""
    return torch.as_tensor(local_batch).to(mesh.device)
