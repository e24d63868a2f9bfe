"""One captured CUDA graph per front-end batch shape.

The port's counterpart of the JAX package's jit cache of ``_front_end``
/ ``_front_end_bt`` (its models/pipeline.py): there each static
shape compiles once into one executable, and every batch is one
dispatch of it.  Here each key (models/pipeline.py ``_fe_key``: the
device, B, L, M, A, whether K2 runs, the cuts, whether the index is
HPC, every keyword of the front end, and the DeviceIndex whose tensors
it reads) gets one ``FrontEndGraph``: static input buffers, the front
end (sketch -> seed lookup -> K1, then K2 or the anchor stack) captured
once reading them, and its static outputs.  A batch is then, under the
graph's lock and in stream order: the staged host arrays copied into
the static inputs, one replay, and the outputs copied out (``take``),
so the next replay may overwrite them.

``capture_cuda_graph`` (the only capture the engine uses) runs the
front end once on a side stream, which sets the kernels' attributes and
warms the allocator outside the capture, then captures it into a
``torch.cuda.CUDAGraph`` with its own memory pool, in "thread_local"
capture mode so that other threads' pinned allocations, event waits
and uploads stay legal meanwhile, and with Python's garbage collector
paused (a collection could destroy another engine's graph, which
voids the capture).  Captures are serialized.  A capture
or a replay that fails raises; nothing falls back to the eager ops.

Launch counts: inside a capture K1's and K2's wrappers launch nothing
and count nothing; ``cuda_build.recording`` notes their calls, and
every replay credits ``chain_kernel.launches`` / ``backtrack.launches``
with what its capture recorded.  The engine counts captures, replays
and the pools' MB (``fe_graph_captures``, ``fe_graph_replays``,
``fe_graph_pool_mb`` in its EngineMetrics).
"""
from __future__ import annotations

import gc
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..ops import backtrack as _bt
from ..ops import chain_kernel as _ck
from ..ops import cuda_build

#: kernel name (cuda_build.note) -> the module whose launches it counts
_COUNTERS = {"chain_dp": _ck, "backtrack_chains": _bt}


@dataclass
class Captured:
    """What a capture function returns: the graph (anything with
    ``replay()``), its static outputs, the device bytes its memory pool
    took, and the kernel launches one replay makes, by kernel name."""

    graph: object
    outputs: tuple
    pool_bytes: int
    launches: Dict[str, int]


def capture_cuda_graph(fn: Callable[[], tuple],
                       device: torch.device) -> Captured:
    """Warm `fn` once on a side stream, then capture it into a
    torch.cuda.CUDAGraph with a private memory pool.  The pool's size is
    torch.cuda.memory_reserved's growth over the capture (other threads'
    allocations meanwhile count too)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(side):
        fn()  # first use: kernel attributes, allocator blocks, workspaces
        before = torch.cuda.memory_reserved(device)
        # a collection on this thread while it captures could destroy an
        # unreachable graph (another engine's), which CUDA refuses during
        # a capture and which voids it: collect after the capture instead
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with cuda_build.recording() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = fn()
                finally:
                    graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
        pool = torch.cuda.memory_reserved(device) - before
    cur.wait_stream(side)
    return Captured(graph, tuple(outputs), max(pool, 0), dict(launches))


class FrontEndGraph:
    """One key's captured front end.  `inputs` are the static input
    buffers (named as stage_batch names the host arrays), `fn` the front
    end over them; the rest is set by the first ``run``."""

    def __init__(self, shape: dict, dev_index,
                 inputs: Dict[str, torch.Tensor],
                 fn: Callable[[], tuple]) -> None:
        self.shape = shape
        self.dev_index = dev_index  # kept alive while the graph reads it
        self.inputs = inputs
        self.fn = fn
        self.lock = threading.Lock()
        self.captured: Optional[Captured] = None
        self.replays = 0

    def _replay(self) -> None:
        self.captured.graph.replay()
        for name, n in self.captured.launches.items():
            _COUNTERS[name].credit(n)

    def probe(self) -> None:
        """One replay on the inputs of the last batch (probe_front_end):
        the device work of a batch, without copies in or out."""
        with self.lock:
            self._replay()


class FrontEndGraphs:
    """Thread-safe cache of captured front ends, one per key.
    `capture(fn, device) -> Captured` defaults to capture_cuda_graph;
    `metrics` is the engine's EngineMetrics."""

    def __init__(self, metrics, capture=None) -> None:
        self.metrics = metrics
        self.capture = capture or capture_cuda_graph
        self._mu = threading.Lock()
        self._capture_mu = threading.Lock()
        self._graphs: Dict[tuple, FrontEndGraph] = {}

    def get(self, key: tuple, shape: dict, device: torch.device, dev_index,
            like: Dict[str, torch.Tensor],
            make_fn: Callable[[Dict[str, torch.Tensor]], Callable]
            ) -> FrontEndGraph:
        """The graph of `key`, made on first use: static inputs shaped as
        `like` on `device`, and ``make_fn(inputs)`` the front end over
        them.  A graph of the same device built against another
        DeviceIndex is dropped: a rebuilt or re-uploaded index is never
        read through freed addresses."""
        with self._mu:
            g = self._graphs.get(key)
            if g is None:
                for k in [k for k, o in self._graphs.items()
                          if o.shape["device"] == shape["device"]
                          and o.dev_index is not dev_index]:
                    del self._graphs[k]
                inputs = {n: torch.empty(t.shape, dtype=t.dtype, device=device)
                          for n, t in like.items()}
                g = self._graphs[key] = FrontEndGraph(
                    shape, dev_index, inputs, make_fn(inputs))
            return g

    def run(self, g: FrontEndGraph, staged: Dict[str, torch.Tensor],
            device: torch.device, take: Callable):
        """One batch through `g`: under its lock, copy `staged` into the
        static inputs, capture on first use, replay, and return
        ``take(*outputs)``, which must copy the outputs out before the
        lock is released."""
        with g.lock:
            for name, t in staged.items():
                g.inputs[name].copy_(t, non_blocking=True)
            if g.captured is None:
                with self._capture_mu:
                    g.captured = self.capture(g.fn, device)
                self.metrics.add("fe_graph_captures", 1)
                self.metrics.add("fe_graph_pool_mb",
                                 g.captured.pool_bytes / 2**20)
            g._replay()
            g.replays += 1
            self.metrics.add("fe_graph_replays", 1)
            return take(*g.captured.outputs)

    def stats(self) -> List[dict]:
        """One row per captured key: its shape, pool MB, replays and the
        kernel launches of one replay."""
        with self._mu:
            graphs = list(self._graphs.values())
        return [{**{k: v for k, v in g.shape.items() if k != "device"},
                 "pool_mb": g.captured.pool_bytes / 2**20,
                 "replays": g.replays, "launches": dict(g.captured.launches)}
                for g in graphs if g.captured is not None]
