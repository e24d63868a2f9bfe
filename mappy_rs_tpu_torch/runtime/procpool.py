"""Multi-process mapping workers, "classic" topology: each child process
runs the whole pipeline on cfg.device.

Why processes: the threaded pool (runtime/batch.py) overlaps the card's
work with the host's, but the per-read Python of the post-chain holds
the interpreter lock, so threads stop scaling where that Python does.
A child process has its own interpreter lock; under this topology it
also has its own CUDA context and its own copy of the index tables on
the card, uploaded from the host arrays that index/share.py hands over
through mmap'd ``.npy`` files.  runtime/devowner.py keeps one context
and one copy in the parent instead.

The parent's WorkerPool threads become thin proxies: each drains reads
from the shared bounded work queue (the contract is unchanged:
capacities, back-off, Done pills) and round-trips one chunk to a child
over a pipe.  Requests carry ids and a per-child reader thread
dispatches the replies, so several proxies can keep chunks in flight to
one child.  Children run the unmodified AlignmentEngine and answer with
a packed block (runtime/pack.py), so a read's result equals the
single-process path's whichever child maps it.

Children start with the "spawn" method, never "fork": the parent may
hold a CUDA context, which a forked child cannot use.  The kernels'
shared libraries are built in the parent before any child starts.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List


def serve(conn, idx_dir: str, map_opt, cfg, work) -> None:
    """A child's request loop: build the engine on the shared index,
    then answer control requests (_CONTROL) and work requests, whose
    payload ``work(eng, no_2nd, *args)`` computes, until the parent
    sends None.  Errors go back to the parent as ("error", rid, repr)."""
    try:
        from ..config import MM_F_NO_PRINT_2ND
        from ..index.share import load_index_dir
        from ..models.pipeline import AlignmentEngine

        eng = AlignmentEngine(load_index_dir(idx_dir), map_opt, cfg)
        no_2nd = bool(map_opt.flag & MM_F_NO_PRINT_2ND)
        conn.send(("ready", -1, os.getpid()))
        while True:
            msg = conn.recv()
            if msg is None:
                conn.send(("bye", -1, eng.metrics.snapshot()))
                return
            kind, rid = msg[0], msg[1]
            try:
                if kind in _CONTROL:
                    reply = ("metrics", rid, _CONTROL[kind](eng, *msg[2:]))
                else:
                    reply = ("okp", rid, work(eng, no_2nd, *msg[2:]))
            except Exception as exc:  # noqa: BLE001 — surface to parent
                reply = ("error", rid, repr(exc))
            conn.send(reply)
    except (EOFError, KeyboardInterrupt):
        pass
    except Exception as exc:  # noqa: BLE001 — init failure: tell parent
        try:
            conn.send(("error", -1, repr(exc)))
        except (OSError, ValueError):
            pass


def _map_chunk(eng, no_2nd: bool, seqs, cs: bool, md: bool):
    """A classic child's work: map a chunk, each distinct read once;
    (order, packed block), order None when the reads are distinct."""
    import numpy as np

    key_ix: Dict[str, int] = {}
    for s in seqs:
        if s not in key_ix:
            key_ix[s] = len(key_ix)
    block = eng.map_batch_packed(list(key_ix), cs=cs, md=md, no_2nd=no_2nd)
    order = (np.fromiter((key_ix[s] for s in seqs), np.int32, len(seqs))
             if len(key_ix) != len(seqs) else None)
    return order, block


def _child_main(conn, idx_dir: str, map_opt, cfg) -> None:
    """Entry point of a spawned classic worker process."""
    serve(conn, idx_dir, map_opt, cfg, _map_chunk)


def _reset(eng) -> dict:
    eng.metrics.reset()
    return {}


#: requests every child answers besides its work
_CONTROL = {
    "metrics": lambda eng: eng.metrics.snapshot(),
    "metrics_reset": _reset,
    "probe": lambda eng, n: eng.probe_front_end(n),
    "roofline": lambda eng: eng.front_end_roofline(),
}


class _Child:
    """Parent-side handle: pipe + send lock + reply dispatcher."""

    def __init__(self, proc, conn) -> None:
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()
        self.pending: Dict[int, "queue.SimpleQueue"] = {}
        self.pending_lock = threading.Lock()
        self.ready_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.bye = threading.Event()
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                kind, rid, payload = self.conn.recv()
            except (EOFError, OSError):
                break
            if kind == "ready":
                self.ready_q.put(payload)
                continue
            if kind == "bye":
                self.ready_q.put(payload)  # metrics snapshot
                self.bye.set()
                break
            if rid == -1:  # init-time failure
                self.ready_q.put(RuntimeError(str(payload)))
                continue
            with self.pending_lock:
                waiter = self.pending.pop(rid, None)
            if waiter is not None:
                waiter.put((kind, payload))
        # child gone: fail everything still in flight
        with self.pending_lock:
            waiters = list(self.pending.values())
            self.pending.clear()
        for w in waiters:
            w.put(("error", "worker process exited"))

    def request(self, rid: int, msg) -> tuple:
        waiter: "queue.SimpleQueue" = queue.SimpleQueue()
        with self.pending_lock:
            self.pending[rid] = waiter
        try:
            with self.send_lock:
                self.conn.send(msg)
        except (OSError, ValueError) as exc:
            with self.pending_lock:
                self.pending.pop(rid, None)
            return ("error", f"send failed: {exc!r}")
        return waiter.get()


def build_kernels(cfg) -> None:
    """Build the libraries the children load, once, in the parent: the
    host C++ and, for a card config, the CUDA kernels.  Both builds
    write a per-process temporary file and rename it, so a process that
    builds at the same time never loads a half-written library; building
    here first keeps the children from running nvcc at all."""
    from .. import native
    from ..index.index import resolve_device

    native.available()
    if resolve_device(cfg.device).type == "cuda":
        from ..ops import cuda_build

        cuda_build.build()


class ChildPool:
    """N spawned children over one shared index directory; the parts of
    the process runtime that do not depend on the topology."""

    def __init__(self, n_procs: int, target, index, args: tuple) -> None:
        from ..index.share import save_index_dir

        self.n_procs = n_procs
        self._seq_names = list(index.seq_names)
        self._seq_lens = index.seq_lens
        self._children: List[_Child] = []
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._closed = False
        self._tmp = tempfile.mkdtemp(prefix="mappy_rs_tpu_torch_idx_")
        atexit.register(self.shutdown)
        try:
            t0 = time.perf_counter()
            save_index_dir(index, self._tmp)
            #: seconds of writing the children's index directory
            self.save_seconds = time.perf_counter() - t0
            ctx = mp.get_context("spawn")
            for _ in range(n_procs):
                parent_c, child_c = ctx.Pipe()
                p = ctx.Process(target=target,
                                args=(child_c, self._tmp, *args),
                                daemon=True)
                p.start()
                child_c.close()
                self._children.append(_Child(p, parent_c))
        except BaseException:
            self.shutdown()
            raise

    @property
    def pids(self) -> List[int]:
        return [c.proc.pid for c in self._children]

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def _call(self, child: _Child, kind: str, *args):
        """One control request; its payload, or None if the child is
        gone or failed."""
        rid = self._next_rid()
        got, payload = child.request(rid, (kind, rid, *args))
        return payload if got == "metrics" else None

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Block until every child has built its engine (no device work
        yet: a classic child uploads its index on its first chunk)."""
        for child in self._children:
            try:
                got = child.ready_q.get(timeout=timeout)
            except queue.Empty:
                return False
            if isinstance(got, Exception):
                return False
        return True

    def map_fn(self, i: int) -> Callable:
        raise NotImplementedError

    def warmup(self, seqs: List[str]) -> None:
        """Pay every child's one-time costs up front (a shared work queue
        would let one warm child take the whole warm batch): one chunk
        through each child's map_fn, all at once.  Raises the first
        failure."""
        errs: List[BaseException] = []

        def run(fn) -> None:
            try:
                fn(list(seqs))
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errs.append(exc)

        threads = [threading.Thread(target=run, args=(self.map_fn(i),),
                                    daemon=True)
                   for i in range(self.n_procs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def reset_metrics(self) -> None:
        for child in self._children:
            self._call(child, "metrics_reset")

    def metrics(self) -> List[dict]:
        snaps = (self._call(child, "metrics") for child in self._children)
        return [s for s in snaps if s is not None]

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.shutdown)
        for child in self._children:
            try:
                with child.send_lock:
                    child.conn.send(None)
                child.bye.wait(timeout=5.0)
                child.conn.close()
            except (OSError, ValueError):
                pass
            child.proc.join(timeout=5.0)
            if child.proc.is_alive():
                child.proc.terminate()
                child.proc.join(timeout=5.0)
        shutil.rmtree(self._tmp, ignore_errors=True)


class ProcMapper(ChildPool):
    """The classic topology: N children, each with the whole pipeline on
    cfg.device, and per-proxy map_fns that round-trip chunks to them."""

    def __init__(self, n_procs: int, index, map_opt, cfg) -> None:
        build_kernels(cfg)
        super().__init__(n_procs, _child_main, index,
                         (map_opt, cfg.replace(worker_processes=0)))

    def map_fn(self, i: int) -> Callable:
        """A WorkerPool map_fn that round-trips chunks to child
        i % n_procs.  Several proxies may target one child: requests
        interleave on the pipe and the child maps them back to back."""
        from .pack import unpack_mappings_block

        child = self._children[i % self.n_procs]
        names, lens_ = self._seq_names, self._seq_lens

        def fn(seqs, cs: bool = True, md: bool = False):
            rid = self._next_rid()
            kind, payload = child.request(rid, ("map", rid, seqs, cs, md))
            if kind != "okp":
                raise RuntimeError(f"worker process failed: {payload}")
            order, block = payload
            tables = unpack_mappings_block(block, names, lens_)
            if order is None:
                return tables
            return [tables[k] for k in order.tolist()]

        return fn

    def probe_front_end(self, n: int = 10) -> list:
        """Front-end seconds per batch from child 0 (every child runs the
        same shapes); [] if unavailable."""
        return self._call(self._children[0], "probe", n) or []

    def front_end_roofline(self) -> dict:
        """The front-end cost model from child 0; {} if unavailable."""
        return self._call(self._children[0], "roofline") or {}
