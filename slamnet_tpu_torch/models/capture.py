"""Recording a model's step as a CUDA graph: what ``hector.StepGraphs`` and
``coreslam.StepGraphs`` share.  Each cache keeps its own keys, replays and
results (Hector writes its maps in place; CoreSLAM returns new maps).

A ``CudaRecorder`` captures a step's body on a side stream of its card.
Every graph one recorder captures on a card shares one memory pool: replays
run one at a time on the caller's stream, and each cache copies its results
out right after a replay, before another graph can write over the pool.
Each cache owns its recorder, so a pool lives as long as the cache that
uses it (CUDA's allocator refuses a pool whose every graph has gone).
``recorded`` wraps a recorder with the launch registry (``ops/_build``): a
capture counts no launch, and the (kernel key, launches) pairs it would
have counted come back so that each replay adds them.
"""
from __future__ import annotations

import torch

from ..ops import _build


class CudaRecorder:
    """``recorder(body, device, generators=())``: ``body``'s launches
    captured into a CUDA graph on a side stream of ``device`` that waits
    for the current one (``thread_local``: another thread's CUDA calls stay
    legal meanwhile).  Each of ``generators`` (CUDA generators on
    ``device`` that ``body`` draws from) is registered with the graph
    first: a replay reads its seed and offset at launch and moves the
    offset on by the draws, as the eager draws would.  Not
    ``torch.cuda.graph``: its entry collects garbage and empties the
    allocator's cache, milliseconds on every capture."""

    def __init__(self):
        self._pools: dict = {}    # device -> the memory pool its graphs share
        self._streams: dict = {}  # device -> the side stream it captures on

    def __call__(self, body, device: torch.device, generators=()):
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
            self._streams[device] = torch.cuda.Stream(device)
        side = self._streams[device]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            for g in generators:
                graph.register_generator_state(g)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pools[device],
                                    capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    graph.capture_end()
        return graph


def recorded(record, body, device: torch.device, *args) -> tuple:
    """``record(body, device, *args)``'s graph and the (kernel key,
    launches) pairs its capture counted; the launch counts are set back to
    what they were before it."""
    before = _build.kernel_launches()
    try:
        graph = record(body, device, *args)
    finally:
        after = _build.kernel_launches()
        _build.reset_launches(before)
    return graph, tuple((k, n - before[k]) for k, n in after.items()
                        if n != before[k])
