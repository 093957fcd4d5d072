"""One CUDA graph per step shape: the port's counterpart of the reference's
jit caches (`repro.api.engine`'s jitted `_decode`, its `_unified_fn` per
(sample, stop) re-specialised per span width, and
`SpeculationController.step_fn` per (k, sample)). The reference has no
module of its own for this; XLA compiles once per static shape, and here
a `StepGraph` captures once per static shape.

A `StepGraph` owns a step function and the static tensors it reads. The
engine refills those in place (`copy_`, `fill_`) before each call; the
step writes its carried state (the next input token, the ring of recent
tokens, a position) back into them in place, on the stream; the call
returns copies of the step's outputs, so what a caller keeps survives
the next replay, which overwrites the graph's own output tensors.

On CUDA (`capture=True`) the first call runs the step eagerly on a side
stream -- the warm-up, where a kernel is first built and sets its
function attributes, and lazily made tables are made -- and that run is
the call's step. It is then captured into a `torch.cuda.CUDAGraph` (on
the capture stream, which is the stream the kernels' wrappers launch
on); every later call replays it. A failed capture or replay raises.
Without capture (the CPU, or an engine built with `cuda_graphs=False`)
every call runs the step eagerly through the same static tensors and
the same copies.

Launch counters. The kernels' wrappers count their launches in
`kernels.build` when Python calls them, so a replay counts nothing by
itself. The capture's counts (the step's launches, which the capture
records but does not run) are taken out of the counters and kept as the
graph's, and every replay adds them back: a captured run counts exactly
what the same run counts eagerly.

Memory. Graphs that share a `pool` (`torch.cuda.graph_pool_handle()`)
allocate their intermediates and outputs from one private pool. That is
safe here because every replay's outputs are copied out, on the same
stream, before any other graph of the pool replays, and no static input
lives in the pool.
"""
from __future__ import annotations

import collections
import gc
import time

import torch

from repro_torch.kernels import build

_COUNTERS = (build.LAUNCHES, build.LAUNCH_SHAPES, build.LAUNCH_RANKS)


def _snapshot() -> list:
    return [collections.Counter(c) for c in _COUNTERS]


def _add(deltas, sign: int = 1) -> None:
    for counter, delta in zip(_COUNTERS, deltas):
        for key, n in delta.items():
            counter[key] += sign * n
            if counter[key] == 0:
                del counter[key]


class StepGraph:
    """A step function `fn(**inputs)` returning a tuple of tensors (or
    None), over the static tensors `inputs`; captured on its first call
    when `capture` holds (see the module's docstring)."""

    def __init__(self, fn, inputs: dict, *, capture: bool, pool=None):
        self.fn = fn
        self.inputs = inputs
        self.capture = capture
        self.pool = pool
        self.graph = None
        self.outputs = None
        self.launches = None        # counter deltas of one replay
        self.capture_seconds = 0.0
        self.pool_bytes = 0         # device memory the capture reserved

    def __call__(self) -> tuple:
        if self.graph is not None:
            self.graph.replay()
            _add(self.launches)
            out = self.outputs
        elif self.capture:
            out = self._warm_up_and_capture()
        else:
            out = self.fn(**self.inputs)
        return tuple(None if t is None else t.clone() for t in out)

    def _warm_up_and_capture(self) -> tuple:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(**self.inputs)
        main.wait_stream(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # Destroying a CUDA graph while a capture runs invalidates the
        # capture, and the cyclic garbage collector may free a dropped
        # engine's graphs at any allocation: collect now, not during it.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.launches = [c - b for c, b in zip(_snapshot(), before)]
        _add(self.launches, -1)     # captured, not run
        self.graph, self.outputs = graph, outputs
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_seconds = time.perf_counter() - t0
        return out


def stats(graphs) -> dict:
    """Graphs captured among `graphs`, the seconds their captures took and
    the device bytes they reserved."""
    done = [g for g in graphs if g.graph is not None]
    return {"graphs": len(done),
            "capture_seconds": sum(g.capture_seconds for g in done),
            "pool_bytes": sum(g.pool_bytes for g in done)}
