"""Streaming batch runtime: worker pool + bounded queues.

Re-creation of the reference's L3 threading layer (SURVEY.md §2a #9-11):
a persistent pool of worker threads consuming a bounded work queue
(capacity 50,000), a bounded result channel (capacity 20,000) feeding a
Python iterator out of submission order, Done-pill batch termination
and an epoch barrier so one pool serves many successive map_batch
calls (/root/reference/src/lib.rs:535-636, 768-906, 922-992).

Where a reference worker maps ONE read per pop, a worker here drains
up to ``device_batch_size`` reads per pop and maps them as one
lock-step device batch — the queueing contract (capacities, back-off,
error text, out-of-order streaming) is preserved exactly.  Each work
item carries its destination iterator, so results from successive
batches can never cross-route even while a previous batch is still
streaming out.

Block-granular plumbing: results travel between stages as per-chunk
BLOCKS (one queue operation per mapped chunk) while every capacity
stays accounted in READS, so the observable contract — 50k work + 50k
results + 20k channel absorbency, per-read back-off messages,
Done-pill fan-out — is unchanged, with one lock round-trip per chunk
instead of several per read."""
from __future__ import annotations

import queue
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import EngineMetrics

WORK_QUEUE_CAP = 50_000  # reference: work ArrayQueue::new(50000), lib.rs:429
RESULTS_QUEUE_CAP = 50_000  # reference: results ArrayQueue::new(50000), lib.rs:430
RESULT_CAP = 20_000  # reference: bounded channel(20000), lib.rs:950
# NB: total pipeline capacity work+results+channel = 120k is observable
# behaviour — the reference's 100k-read back-off test only passes because
# the three stages together can absorb the whole batch.

_DONE = ("__done__",)


class _WorkQueue:
    """Bounded FIFO of per-read work items with a one-lock batch drain.

    Items are ``(sink, id_num, seq)`` tuples; a Done pill is
    ``(sink, None, None)``.  Capacity counts items (reads + pills),
    matching the reference's ArrayQueue::new(50000) slot semantics.
    ``take_batch`` pops a same-sink run of reads in ONE lock
    acquisition, stopping (without popping) at a pill or a foreign
    sink — the per-item ``get_nowait`` + put-back dance this replaces
    was the pool's dominant lock traffic."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._q: deque = deque()
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)

    def put_nowait(self, item: tuple) -> None:
        with self._mu:
            if len(self._q) >= self.cap:
                raise queue.Full
            self._q.append(item)
            self._not_empty.notify()

    def put_nowait_block(self, items: List[tuple]) -> int:
        """Append as many items as fit under one lock; returns the
        count appended.  The caller handles the remainder through the
        per-read slow path so full-queue behaviour (back-off sleeps,
        drop messages, no-back-off raise) is byte-identical."""
        with self._mu:
            free = self.cap - len(self._q)
            if free <= 0:
                return 0
            n = min(free, len(items))
            self._q.extend(items[:n])
            if n >= 2:
                self._not_empty.notify_all()
            else:
                self._not_empty.notify()
            return n

    def put(self, item: tuple) -> None:
        """Blocking append (used for Done pills)."""
        with self._not_full:
            while len(self._q) >= self.cap:
                self._not_full.wait(timeout=0.2)
            self._q.append(item)
            self._not_empty.notify()

    def take_batch(self, k: int, timeout: float):
        """One of: ``None`` (timeout), ``(sink, None)`` (pill), or
        ``(sink, [(id_num, seq), ...])`` — up to k same-sink reads
        that were immediately available (no waiting to fill)."""
        with self._not_empty:
            if not self._q:
                if timeout > 0:
                    self._not_empty.wait(timeout=timeout)
                if not self._q:
                    return None
            first = self._q[0]
            sink = first[0]
            if first[1] is None:  # Done pill
                self._q.popleft()
                self._not_full.notify()
                return sink, None
            items: List[Tuple[int, str]] = []
            while self._q and len(items) < k:
                nxt = self._q[0]
                if nxt[1] is None or nxt[0] is not sink:
                    break  # pill / next batch stays queued for its turn
                self._q.popleft()
                items.append((nxt[1], nxt[2]))
            self._not_full.notify_all()
            return sink, items


class _BlockChannel:
    """Bounded channel whose traffic is blocks but whose capacity is
    accounted in reads (+1 per Done pill), preserving the reference
    channel's absorbency.  Single consumer, multiple producers."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._q: deque = deque()  # (payload, nreads)
        self._n = 0
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)

    def put(self, payload, nreads: int, timeout: float) -> bool:
        """False if capacity did not free up within ``timeout``."""
        with self._not_full:
            if self._n + nreads > self.cap and self._n > 0:
                if timeout > 0:
                    self._not_full.wait(timeout=timeout)
                if self._n + nreads > self.cap and self._n > 0:
                    return False
            self._q.append((payload, nreads))
            self._n += nreads
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        """Next payload (a results block or ``_DONE``), or ``None`` on
        timeout.  Capacity frees when the block leaves the queue."""
        with self._not_empty:
            if not self._q:
                self._not_empty.wait(timeout=timeout)
                if not self._q:
                    return None
            payload, nreads = self._q.popleft()
            self._n -= nreads
            self._not_full.notify_all()
            return payload

    def get_held(self, timeout: Optional[float] = None):
        """Like :meth:`get` but returns ``(payload, nreads)`` WITHOUT
        freeing capacity — the consumer calls :meth:`release` once the
        payload is fully drained, so a block buffered inside the
        iterator still counts against the channel's absorbency."""
        with self._not_empty:
            if not self._q:
                self._not_empty.wait(timeout=timeout)
                if not self._q:
                    return None
            return self._q.popleft()

    def release(self, nreads: int) -> None:
        with self._not_full:
            self._n -= nreads
            self._not_full.notify_all()


class AlignmentBatchResultIter:
    """Streaming iterator over batch results (lib.rs:922-992 parity).

    Yields ``(mappings, data_dict)`` tuples as workers finish them —
    out of submission order; the caller's full input dict flows through
    untouched."""

    def __init__(self) -> None:
        self.channel = _BlockChannel(RESULT_CAP)
        self.data: Dict[int, Dict[str, Any]] = {}
        self._n_threads = 0
        self._n_finished = 0
        self._buf: List[tuple] = []
        self._buf_i = 0
        self._buf_held = 0  # channel capacity still held by _buf
        self._mu = threading.Lock()  # concurrent next() safety
        # Disconnect flag: the reference's workers learn the iterator was
        # dropped through a failing channel send (lib.rs:822-826); Python
        # queues have no receiver-dropped signal, so workers poll this.
        self.closed = False

    def set_n_threads(self, n: int) -> None:
        self._n_threads = n

    def close(self) -> None:
        self.closed = True

    def __del__(self) -> None:
        self.closed = True

    def __iter__(self) -> "AlignmentBatchResultIter":
        return self

    def __next__(self):
        # the lock makes concurrent iteration from several threads
        # hand each result out exactly once; channel capacity stays
        # held until the buffered block is fully drained, so the
        # 20k-read absorbency contract is block-exact
        with self._mu:
            while True:
                if self._buf_i < len(self._buf):
                    mappings, id_num = self._buf[self._buf_i]
                    self._buf_i += 1
                    if self._buf_i == len(self._buf) and self._buf_held:
                        self.channel.release(self._buf_held)
                        self._buf_held = 0
                    data = self.data.pop(id_num)
                    return mappings, data
                got = self.channel.get_held()
                if got is None:
                    continue
                item, nreads = got
                if item is _DONE:
                    self.channel.release(nreads)
                    self._n_finished += 1
                    if self._n_finished == self._n_threads:
                        self.closed = True
                        raise StopIteration
                    continue
                self._buf = item
                self._buf_i = 0
                self._buf_held = nreads


class WorkerPool:
    """Persistent worker threads over a shared bounded work queue."""

    def __init__(self, n_threads: int, map_fn, batch_size: int = 256,
                 metrics: Optional[EngineMetrics] = None):
        """map_fn(list[str]) -> list[list[Mapping]] (threaded path maps
        with cs=True, MD=False, as the reference hard-codes,
        lib.rs:587-592).

        ``map_fn``/``batch_size`` may also be per-worker lists of
        length ``n_threads`` — the multi-process runtime gives each
        worker thread a proxy to its own child process.  The workers'
        waits are spans of `metrics` (the engine's): ``queue_wait``,
        ``epoch_wait`` and ``result_wait``."""
        self.n_threads = n_threads
        self.metrics = metrics if metrics is not None else EngineMetrics()
        if not isinstance(map_fn, (list, tuple)):
            map_fn = [map_fn] * n_threads
        if not isinstance(batch_size, (list, tuple)):
            batch_size = [batch_size] * n_threads
        self.map_fns = list(map_fn)
        self.batch_sizes = list(batch_size)
        self.map_fn = self.map_fns[0]  # back-compat alias
        self.batch_size = self.batch_sizes[0]
        self.work = _WorkQueue(WORK_QUEUE_CAP)
        self.results = _BlockChannel(RESULTS_QUEUE_CAP)
        self.stop = threading.Event()
        # epoch barrier state (the reference's dones vec + spin,
        # lib.rs:556-575): a Condition instead of threading.Barrier —
        # Barrier.wait(timeout) BREAKS the barrier when one worker's
        # map legitimately runs long (first-compile in a fresh child
        # process), double-counting Done pills; the reference spins
        # without any timeout.  This wait is unbounded but stop-aware.
        self._epoch_cv = threading.Condition()
        self._epoch_count = 0
        self._epoch_gen = 0
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i,), daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()
        # collector: drains the results queue into each batch's bounded
        # iterator channel (the reference spawns one per map_batch,
        # lib.rs:798-839; a single long-lived one with sink-tagged items
        # is equivalent and cannot cross-route)
        self._collector = threading.Thread(target=self._collector_loop, daemon=True)
        self._collector.start()

    # -- producer side --------------------------------------------------
    def push_work(
        self,
        sink: AlignmentBatchResultIter,
        id_num: int,
        seq: str,
        back_off: bool,
    ) -> None:
        item = (sink, id_num, seq)
        try:
            self.work.put_nowait(item)
            return
        except queue.Full:
            pass
        if back_off:
            sleep = 0.05  # 50 ms * 2^i, 6 attempts (lib.rs:871-887)
            for _ in range(6):
                try:
                    self.work.put_nowait(item)
                    return
                except queue.Full:
                    time.sleep(sleep)
                    sleep *= 2
            print(
                f"Internal error adding data to work queue, with backoff. "
                f"Full {id_num}, Attempts: 6",
                file=sys.stderr,
            )
            # the read is dropped (reference parity) — reclaim its
            # stashed data dict so long-lived iterators don't leak
            sink.data.pop(id_num, None)
        else:
            raise RuntimeError(
                f"Internal error adding data to work queue, without backoff. "
                f"Full(..) {id_num}. Is your fastq batch larger than "
                f"{WORK_QUEUE_CAP}? Perhaps try `map_batch` with back_off=True?"
            )

    def push_work_block(
        self,
        sink: AlignmentBatchResultIter,
        start_id: int,
        seqs: List[str],
        back_off: bool,
    ) -> None:
        """Fast path for the producer's tight loop: one lock
        acquisition for a run of reads; anything that doesn't fit
        falls through to the per-read slow path so full-queue
        behaviour (messages, ids, raise) is identical."""
        items = [
            (sink, start_id + i, s) for i, s in enumerate(seqs)
        ]
        n = self.work.put_nowait_block(items)
        for sink_, id_num, s in items[n:]:
            self.push_work(sink_, id_num, s, back_off)

    def push_done_pills(self, sink: AlignmentBatchResultIter) -> None:
        for _ in range(self.n_threads):
            self.work.put((sink, None, None))

    # -- worker side ----------------------------------------------------
    def _worker_loop(self, wi: int = 0) -> None:
        map_fn = self.map_fns[wi]
        batch_size = self.batch_sizes[wi]
        while not self.stop.is_set():
            got = self.work.take_batch(batch_size, timeout=0.0)
            if got is None:
                with self.metrics.span("queue_wait"):
                    while got is None and not self.stop.is_set():
                        got = self.work.take_batch(batch_size, timeout=0.05)
                if got is None:
                    continue
            sink, items = got
            if items is None:  # Done pill
                self._put_results_q(sink, _DONE, 1)
                # epoch barrier: wait until every worker saw this batch's
                # Done so the next batch cannot mix (lib.rs:556-575)
                self._epoch_wait()
                continue
            if sink.closed:
                continue  # iterator dropped: discard silently
            try:
                results = map_fn([seq for _, seq in items])
            except Exception as exc:  # noqa: BLE001 — match lib.rs:621-623
                print(
                    f"Failed to map sequence in threaded implementation. {exc}",
                    file=sys.stderr,
                )
                continue
            block = [
                (mappings, id_num)
                for (id_num, _), mappings in zip(items, results)
            ]
            self._put_results_q(sink, block, len(block))

    def _epoch_wait(self) -> None:
        """All-workers-saw-Done rendezvous (lib.rs:556-575 semantics:
        spin until every thread marked done, no timeout; here a
        Condition so shutdown can interrupt the wait)."""
        with self.metrics.span("epoch_wait"), self._epoch_cv:
            gen = self._epoch_gen
            self._epoch_count += 1
            if self._epoch_count == self.n_threads:
                self._epoch_count = 0
                self._epoch_gen += 1
                self._epoch_cv.notify_all()
                return
            while self._epoch_gen == gen and not self.stop.is_set():
                self._epoch_cv.wait(timeout=0.5)

    def _put_results_q(
        self, sink: AlignmentBatchResultIter, item, nreads: int
    ) -> bool:
        """Worker -> results queue (cap 50,000 reads), dropping when
        the destination iterator is gone."""
        if self.stop.is_set() or (sink.closed and item is not _DONE):
            return False
        if self.results.put((sink, item), nreads, timeout=0.0):
            return True
        with self.metrics.span("result_wait"):
            while not self.stop.is_set():
                if sink.closed and item is not _DONE:
                    return False
                if self.results.put((sink, item), nreads, timeout=0.2):
                    return True
        return False

    def _collector_loop(self) -> None:
        """results queue -> per-batch bounded channel (lib.rs:798-839)."""
        while not self.stop.is_set():
            got = self.results.get(timeout=0.05)
            if got is None:
                continue
            sink, item = got
            nreads = 1 if item is _DONE else len(item)
            while not self.stop.is_set():
                if sink.closed:
                    if item is not _DONE:
                        # one message per discarded BLOCK; the read
                        # count keeps log-based drop accounting exact
                        # (the reference printed one line per read)
                        print(
                            "Internal error returning data, the receiver "
                            f"iterator has finished. ({nreads} reads "
                            "discarded)",
                            file=sys.stderr,
                        )
                    break
                if sink.channel.put(item, nreads, timeout=0.2):
                    break

    def shutdown(self) -> None:
        self.stop.set()
