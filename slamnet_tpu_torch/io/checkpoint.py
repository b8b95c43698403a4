"""Checkpoint / resume of the port's states, in the JAX package's layout.

Port of ``slamnet_tpu/io/checkpoint.py``'s ``save`` / ``restore`` /
``load_metadata`` (``:28-51``).  A checkpoint is a directory holding
``state.npz`` (``leaf_{i}``, the state's leaves depth first in its
NamedTuples' field order) and ``meta.json`` (the caller's metadata plus
``num_leaves``).  The npz holds plain arrays, no pickled object, so a
checkpoint written on the card restores on the CPU and the other way round.

The port's states are JAX's with host-side fields beside the arrays:

* a ``torch.Generator`` (CoreSLAM, the particle layer) where JAX carries its
  PRNG key: saved as its ``get_state()`` bytes and restored with
  ``set_state``, so a resumed replay draws what the uninterrupted one draws.
  A CUDA generator's state restores only into a CUDA generator (and a CPU
  generator's into a CPU one): the two kinds' states differ;
* the host's counts (``CoreSlamState.scans``, ``GraphSlamState.nodes``):
  saved as 0-dim arrays after the other leaves of their NamedTuple.

``meta.json`` of a port checkpoint names its ``format``; a checkpoint
without it is JAX's.  ``restore`` reads JAX's leaves through ``convert``
(``*_state_from_numpy``): a JAX ``HectorState`` (or fleet state) restores
as it is; a CoreSLAM, particle or graph-SLAM state gets a generator seeded
with ``seed`` in place of JAX's key.

``save_sharded`` / ``restore_sharded`` (JAX's ``:58-98``) checkpoint a
sharded Hector, CoreSLAM or graph-SLAM state densified: every rank of the
mesh gathers the tiles (and a graph state's keyframe clouds over the search
axis), rank 0 writes the dense state's checkpoint with ``sharded_kind`` in
its metadata, so a checkpoint does not depend on the mesh's shape, and
``restore_sharded`` shards it onto any mesh the config divides over (for a
graph state, any search size that divides ``max_keyframes``).
``save_orbax`` / ``restore_orbax`` wrap orbax, which has no PyTorch
counterpart: the npz pair is the port's format.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

import numpy as np
import torch

from ..core.debug import leaves

FORMAT = "slamnet_tpu_torch"


def _flatten(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves(tree)]


def _unflatten(like: Any, it) -> Any:
    """``like``'s structure (``core.debug.leaves``' order) over the leaves
    of ``it``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    return next(it)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any, metadata: dict | None = None) -> None:
    """Save a state (nested NamedTuples of tensors, generators and host
    counts) and JSON-able ``metadata`` to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state)
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(flat)})
    meta = dict(metadata or {})
    meta["num_leaves"] = len(flat)
    meta["format"] = FORMAT
    meta["state_type"] = type(state).__name__
    meta["generators"] = [l.device.type for l in flat
                          if isinstance(l, torch.Generator)]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _restore_leaf(arr: np.ndarray, like, device: torch.device):
    if isinstance(like, torch.Tensor):
        return torch.tensor(arr, dtype=like.dtype, device=device)
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=device)
        try:
            gen.set_state(torch.from_numpy(arr.copy()))
        except RuntimeError as e:
            raise ValueError(
                f"a generator's saved state does not fit a {device.type} "
                f"generator (CPU and CUDA generator states differ): {e}"
            ) from None
        return gen
    return type(like)(arr.item())


def _device_of(like: Any) -> torch.device:
    for leaf in _flatten(like):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _from_jax(saved: List[np.ndarray], like: Any, device, seed: int):
    """A JAX-written state's leaves (JAX's field order) as the port's
    ``type(like)`` through ``convert``."""
    from .. import convert

    kind = type(like).__name__
    if kind == "HectorState":
        return convert.hector_state_from_numpy(*saved[:3], device=device)
    if kind == "CoreSlamState":
        return convert.coreslam_state_from_numpy(*saved[:5], seed=seed,
                                                 device=device)
    if kind == "ParticleState":
        return convert.particle_state_from_numpy(*saved[:7], seed=seed,
                                                 device=device)
    if kind == "GraphSlamState":
        hector = dict(zip(convert.FIELDS, saved[:3]))
        n = len(convert.GRAPH_FIELDS)
        graph = dict(zip(convert.GRAPH_FIELDS, saved[3:3 + n]))
        rest = dict(zip(convert.GRAPH_STATE_FIELDS[2:], saved[3 + n:]))
        return convert.graph_state_from_numpy(
            {"hector": hector, "graph": graph, **rest}, device=device)
    raise TypeError(f"no JAX layout known for {kind}")


def restore(path: str, like: Any, device: torch.device | str | None = None,
            seed: int = 0) -> Any:
    """Restore a state saved by ``save`` (this package's or the JAX
    package's) with ``like``'s structure and dtypes, on ``device`` (default
    ``like``'s).  ``seed`` seeds the generator of a state restored from a
    JAX checkpoint, which carries a PRNG key instead."""
    device = torch.device(device) if device is not None else _device_of(like)
    meta = load_metadata(path)
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as data:
        saved = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    if meta.get("format") != FORMAT:
        return _from_jax(saved, like, device, seed)
    like_leaves = _flatten(like)
    if len(like_leaves) != len(saved):
        raise ValueError(f"{path} holds {len(saved)} leaves, "
                         f"{type(like).__name__} has {len(like_leaves)}")
    return _unflatten(like, iter(
        _restore_leaf(a, l, device) for a, l in zip(saved, like_leaves)))


def save_sharded(path: str, state: Any, cfg: Any, mesh,
                 metadata: dict | None = None, tile_axis: str = "tile",
                 search_axis: str = "search") -> None:
    """Checkpoint a sharded state (``ShardedHectorState`` /
    ``ShardedCoreSlamState`` / ``ShardedGraphSlamState``, ``cfg`` its
    ``HectorConfig`` or ``CoreSlamConfig``) densified.  Every rank of
    ``mesh`` calls it (the tiles and clouds are gathered); rank 0 writes;
    it returns once the files are written (a barrier)."""
    from ..models import coreslam_sharded, graph_slam_sharded, hector_sharded

    kind = type(state).__name__
    if kind == "ShardedHectorState":
        dense = hector_sharded.to_dense(mesh, state, cfg, tile_axis)
    elif kind == "ShardedCoreSlamState":
        dense = coreslam_sharded.to_dense(mesh, state, tile_axis)
    elif kind == "ShardedGraphSlamState":
        dense = graph_slam_sharded.to_dense(mesh, state, cfg, tile_axis,
                                            search_axis)
    else:
        raise TypeError(f"not a sharded state: {kind}")
    if mesh.rank == 0:
        save(path, dense, {**(metadata or {}), "sharded_kind": kind})
    mesh.barrier()


def restore_sharded(path: str, mesh, cfg: Any, like_dense: Any,
                    tile_axis: str = "tile", search_axis: str = "search"
                    ) -> Any:
    """Restore a ``save_sharded`` checkpoint onto ``mesh`` (any shape the
    config divides over): every rank reads the dense state (``like_dense``
    gives its structure, e.g. ``hector.init(cfg, pose, device)`` or
    ``graph_slam.init(hcfg, gcfg, pose, beams, device)``) and keeps its own
    share."""
    from ..models import coreslam_sharded, graph_slam_sharded, hector_sharded

    kind = load_metadata(path).get("sharded_kind")
    shard = {"ShardedHectorState": lambda d: hector_sharded.shard_state(
                 mesh, d, cfg, tile_axis),
             "ShardedCoreSlamState": lambda d: coreslam_sharded.shard_state(
                 mesh, d, cfg, tile_axis),
             "ShardedGraphSlamState": lambda d: graph_slam_sharded.shard_dense(
                 mesh, d, cfg, tile_axis, search_axis)}.get(kind)
    if shard is None:
        raise TypeError(f"{path} holds no sharded checkpoint (kind {kind!r})")
    return shard(restore(path, like_dense, device=mesh.device))
