"""One captured CUDA graph per static key: the port's counterpart of the
JAX package's jit caches.

There each static shape of a jitted function compiles once into one
executable, and every call is one dispatch of it.  Here a ``GraphCache``
gives each key one ``Graph``: static input buffers, the function
captured once reading them, and its static outputs.  A call is then,
under the graph's lock and in stream order: the caller's tensors copied
into the static inputs, one replay, and the outputs copied out
(``take``), so the next replay may overwrite them.  Three callers each
hold a cache of their own:

- the front end (models/pipeline.py ``_fe_key``: the device, B, L, M,
  A, whether K2 runs, the cuts, whether the index is HPC, every keyword
  of the front end, the tables it reads, and under a device grid the
  grid's shape and the row): sketch -> seed lookup -> K1, then K2 or
  the anchor stack, on one device or on one row of a grid whose cells
  all sit on one device (the JAX package's ``_front_end`` /
  ``_front_end_bt`` and its ``shard_map`` wrappers);
- the device extension (ops/extend_kernel.py): K3 + K4 per job-group
  shape (``_extend_traceback_jit``), or K3 alone for "device_dl"
  (``_extend_pallas_device``);
- the decision step (parallel/mesh.py ``build_sharded_map_step``), one
  graph per row and batch shape (the JAX package's jitted step).

``capture_cuda_graph`` (the only capture the port uses) runs the
function once on the device's one side stream, which sets the kernels'
attributes and warms the allocator outside the capture (the blocks of
one warm-up serve the next), then captures it into a
``torch.cuda.CUDAGraph`` with its own memory pool, in "thread_local"
capture mode so that other threads' pinned allocations, event waits
and uploads stay legal meanwhile, and with Python's garbage collector
paused (a collection could destroy another engine's graph, which
voids the capture).  Captures are serialized over the process, every
cache's.  A capture or a replay that fails raises; nothing falls back
to the eager ops.  A graph
captures on one device, so a caller whose work spans several cards
(a grid row whose cells sit on different cards) runs its ops eagerly:
the caller decides that from the grid's layout, never by catching a
failed capture.

Memory: each graph keeps its private pool while it is cached.  The
front end's and the extension's keys are a bounded set (the device
batch sizes and L buckets; the job-group classes), so their caches are
unbounded.  The decision step's keys follow the callers' batch sizes
(one per row and B_pad, as the JAX package compiles one executable per
shape), so its cache has a byte budget: after a capture takes the
cached pools over it, the least recently used graphs leave the cache
(``<prefix>_evictions``) and ``torch.cuda.empty_cache`` returns their
pools to the card.  That call needs no capture underway in the
process, hence the one capture lock.  An evicted key captures again
when it comes back.

Launch counts: inside a capture the kernel wrappers launch nothing and
count nothing; ``cuda_build.recording`` notes their calls (K3's with
its shape), and every replay credits each kernel's ``launches`` (and
K3's ``shapes``) with what its capture recorded.  Each cache counts its
captures, replays and the pools' MB in the owner's EngineMetrics under
its prefix (``fe_graph_*``, ``ext_graph_*``, ``dec_graph_*``):
``_pool_mb`` sums the pools captured, ``pool_mb()`` is what the cached
graphs hold now.
"""
from __future__ import annotations

import collections
import gc
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..ops import backtrack as _bt
from ..ops import chain_kernel as _ck
from ..ops import cuda_build
from ..ops import extend_kernel as _ek
from ..ops import traceback as _tb

#: kernel name (cuda_build.note) -> the module whose launches it counts
_COUNTERS = {"chain_dp": _ck, "backtrack_chains": _bt, "extend_dp": _ek,
             "traceback": _tb}

#: held by every capture, and by the empty_cache of an eviction, which
#: the caching allocator refuses while a capture runs
_CAPTURE_MU = threading.RLock()
#: the captures' side stream, one per device: the allocator caches a
#: block for the stream that freed it, so one stream lets every warm-up
#: reuse the blocks of the ones before (a stream per capture strands
#: each warm-up's working set in the cache until an empty_cache)
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def credit(launches: Dict) -> None:
    """Credit each kernel with the launches of one replay: `launches`
    as a capture recorded them (cuda_build.note keys: a kernel name, or
    (name, detail) where the wrapper noted a detail, K3's shape)."""
    for key, n in launches.items():
        name, *detail = key if isinstance(key, tuple) else (key,)
        _COUNTERS[name].credit(n, *detail)


def by_name(launches: Dict) -> Dict[str, int]:
    """A recording's launches summed per kernel name."""
    out: Dict[str, int] = collections.Counter()
    for key, n in launches.items():
        out[key[0] if isinstance(key, tuple) else key] += n
    return dict(out)


@dataclass
class Captured:
    """What a capture function returns: the graph (anything with
    ``replay()``), its static outputs, the device bytes its memory pool
    took, and the kernel launches one replay makes (cuda_build.note
    keys)."""

    graph: object
    outputs: tuple
    pool_bytes: int
    launches: Dict


def capture_cuda_graph(fn: Callable[[], tuple],
                       device: torch.device) -> Captured:
    """Warm `fn` once on the device's side stream, then capture it into
    a torch.cuda.CUDAGraph with a private memory pool, under the capture
    lock.  The pool's size is torch.cuda.memory_reserved's growth over
    the capture (other threads' allocations meanwhile count too)."""
    with _CAPTURE_MU:
        return _capture(fn, device)


def _capture(fn: Callable[[], tuple], device: torch.device) -> Captured:
    cur = torch.cuda.current_stream(device)
    side = _SIDE.get(cur.device)
    if side is None:
        side = _SIDE[cur.device] = torch.cuda.Stream(cur.device)
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


class Graph:
    """One key's captured function.  `inputs` are the static input
    buffers, `fn` the function over them, `owner` the object whose
    tensors it reads besides its inputs (kept alive while the graph
    lives; None when it reads its inputs alone); the rest is set by the
    first ``run``."""

    def __init__(self, shape: dict, device: torch.device, owner,
                 inputs: Dict[str, torch.Tensor],
                 fn: Callable[[], tuple]) -> None:
        self.shape = shape
        self.device = device
        self.owner = owner
        self.inputs = inputs
        self.fn = fn
        self.lock = threading.Lock()
        self.captured: Optional[Captured] = None
        self.replays = 0

    def _replay(self) -> None:
        self.captured.graph.replay()
        credit(self.captured.launches)

    def probe(self) -> None:
        """One replay on the inputs of the last call (probe_front_end):
        the device work of a call, without copies in or out."""
        with self.lock:
            self._replay()


class GraphCache:
    """Thread-safe cache of captured functions, one per key.
    `metrics` is the owner's EngineMetrics, `prefix` names its counters
    (``<prefix>_captures``, ``_replays``, ``_pool_mb``, ``_evictions``);
    `capture(fn, device) -> Captured` defaults to capture_cuda_graph;
    `budget_mb` bounds the cached pools (None: no bound)."""

    def __init__(self, metrics, prefix: str = "fe_graph",
                 capture=None, budget_mb: Optional[float] = None) -> None:
        self.metrics = metrics
        self.prefix = prefix
        self.capture = capture or capture_cuda_graph
        self.budget_mb = budget_mb
        self._mu = threading.Lock()
        # least recently used first
        self._graphs: "collections.OrderedDict[tuple, Graph]" = \
            collections.OrderedDict()

    def captures_on(self, device: torch.device) -> bool:
        """Whether this cache's graphs may run on `device`: a CUDA graph
        captures on a card; an injected capture (the CPU tests'
        stand-in) anywhere."""
        return (self.capture is not capture_cuda_graph
                or device.type == "cuda")

    def pool_mb(self) -> float:
        """MB of the pools the cached graphs hold now."""
        with self._mu:
            return sum(g.captured.pool_bytes for g in self._graphs.values()
                       if g.captured is not None) / 2**20

    def get(self, key: tuple, shape: dict, device: torch.device, owner,
            like: Dict[str, torch.Tensor],
            make_fn: Callable[[Dict[str, torch.Tensor]], Callable]
            ) -> Graph:
        """The graph of `key`, made on first use: static inputs shaped as
        `like` on `device`, and ``make_fn(inputs)`` the function over
        them.  A graph of the same device whose owner is another object
        of the same kind is dropped: a rebuilt index or re-placed shards
        are never read through freed addresses, nor kept alive."""
        with self._mu:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
            else:
                for k in [k for k, o in self._graphs.items()
                          if o.device == device and o.owner is not owner
                          and type(o.owner) is type(owner)]:
                    del self._graphs[k]
                inputs = {n: torch.empty(t.shape, dtype=t.dtype, device=device)
                          for n, t in like.items()}
                g = self._graphs[key] = Graph(shape, device, owner, inputs,
                                              make_fn(inputs))
            return g

    def run(self, g: Graph, staged: Dict[str, torch.Tensor],
            device: torch.device, take: Callable):
        """One call through `g`: under its lock, copy `staged` into the
        static inputs, capture on first use, replay, and return
        ``take(*outputs)``, which must copy the outputs out before the
        lock is released."""
        with g.lock:
            for name, t in staged.items():
                g.inputs[name].copy_(t, non_blocking=True)
            if g.captured is None:
                with _CAPTURE_MU:
                    g.captured = self.capture(g.fn, device)
                    self.metrics.add(f"{self.prefix}_captures", 1)
                    self.metrics.add(f"{self.prefix}_pool_mb",
                                     g.captured.pool_bytes / 2**20)
                    self._evict(keep=g)
            g._replay()
            g.replays += 1
            self.metrics.add(f"{self.prefix}_replays", 1)
            return take(*g.captured.outputs)

    def _evict(self, keep: Graph) -> None:
        """Drop least recently used captured graphs, never `keep`, until
        the cached pools fit the budget, and return their memory to the
        card.  Called under _CAPTURE_MU.  A thread that still holds an
        evicted graph finishes its call on it; the pool goes with the
        last reference."""
        if self.budget_mb is None:
            return
        gone = self._pop_over_budget(keep, self.budget_mb * 2**20)
        if not gone:
            return
        self.metrics.add(f"{self.prefix}_evictions", len(gone))
        cuda = any(g.device.type == "cuda" for g in gone)
        del gone  # the cache's references: their pools are released
        if cuda:
            torch.cuda.empty_cache()

    def _pop_over_budget(self, keep: Graph, budget: float) -> List[Graph]:
        with self._mu:
            held = sum(g.captured.pool_bytes for g in self._graphs.values()
                       if g.captured is not None)
            gone = []
            for key in list(self._graphs):
                if held <= budget:
                    break
                g = self._graphs[key]
                if g is not keep and g.captured is not None:
                    held -= g.captured.pool_bytes
                    gone.append(self._graphs.pop(key))
            return gone

    def stats(self) -> List[dict]:
        """One row per captured key: its shape, pool MB, replays and the
        kernel launches of one replay, by kernel name."""
        with self._mu:
            graphs = list(self._graphs.values())
        return [{**{k: v for k, v in g.shape.items() if k != "device"},
                 "pool_mb": g.captured.pool_bytes / 2**20,
                 "replays": g.replays,
                 "launches": by_name(g.captured.launches)}
                for g in graphs if g.captured is not None]
