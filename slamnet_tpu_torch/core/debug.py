"""Debug mode: numeric sanity checks of a pipeline's state.

Port of ``slamnet_tpu/core/debug.py``.  JAX wires
``jax.experimental.checkify`` into a step; here:

* ``all_finite(state)``: a 0-dim bool tensor on the state's device, True
  when every floating leaf is finite; it reads nothing back to the host, so
  a production monitor can keep it beside each scan and read it later (pair
  it with ``io.metrics.DivergenceMonitor``);
* ``checked(fn)``: ``fn`` with its outputs checked after each call; it
  raises FloatingPointError naming the first non-finite floating leaf.  It
  reads every floating leaf back to the host: a debug tool.

checkify's ``index_checks`` have no PyTorch counterpart, and need none:
PyTorch checks indexing itself, on the CPU with an IndexError and on CUDA
with a device-side assert.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf of nested NamedTuples, tuples, lists and
    dicts, depth first in field order (JAX's pytree order for a state of
    NamedTuples)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from leaves(v, f"{path}.{name}" if path else name)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _floats(tree: Any):
    return [(p, t) for p, t in leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def all_finite(tree: Any) -> torch.Tensor:
    """0-dim bool: every floating tensor leaf of ``tree`` is finite.  No
    host read: the flag stays on the leaves' device."""
    fl = _floats(tree)
    if not fl:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(t).all() for _, t in fl]).all()


def checked(fn: Callable) -> Callable:
    """``fn`` whose outputs are checked after each call: raises
    FloatingPointError on the first non-finite floating leaf (a host read
    of each floating leaf; debug only)."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _floats(out):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite value in "
                    f"output {path or '<root>'}")
        return out

    return wrapper
