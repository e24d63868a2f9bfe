"""The two ways a traffic mix offers load to ``Aligner.map_batch``.

``open_loop``: readfish's.  Batches are due at a fixed interval from the
window's start, whatever the system is doing; a feeder thread hands
each batch to ``map_batch`` at its due time (or as soon after as it
can: its lateness is reported) and a consumer thread iterates the
batches' result iterators in order.  A read's latency runs from its
batch's due time to the moment the iterator yields it, so a stall
delays every read queued behind it.

``closed_loop``: mappy-rs's own benchmark.  ``map_batch`` calls over a
stream of reads longer than the window, each queued behind the one
being read, keep every worker busy; the reads the iterators yield
inside the window count.  At the close every
read up to the last one returned in the window is waited for (a read
the workers had taken is late, not lost); one that never comes within
``DRAIN_S`` has failed.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

#: seconds a read may come late after the window before it counts as lost
DRAIN_S = 60.0


@dataclasses.dataclass
class LoopResult:
    attempted: int
    returned: Dict[int, tuple]  # read id -> (seconds after t0, mappings)
    lost: List[int]  # attempted ids that never came
    t0: float
    t_end: float  # when the last attempted read came (or the drain ended)
    window_s: float
    latency_s: Optional[Dict[int, float]] = None  # open loop only
    lateness_s: Optional[List[float]] = None  # open loop: feeder's lateness
    in_window: Optional[List[int]] = None  # closed loop: ids done in window


def open_loop(al, batches: List[List[str]], interval_s: float,
              seconds: float) -> LoopResult:
    """Offer batches[b] at t0 + b * interval_s for the batches due
    inside `seconds`; wait for every read of them (DRAIN_S at most)."""
    n_due = min(len(batches), int(-(-seconds // interval_s)))
    if n_due < len(batches) and n_due * interval_s < seconds:
        raise RuntimeError("the traffic holds fewer batches than the window")
    ids, first = [], 0
    for b in range(n_due):
        ids.append(list(range(first, first + len(batches[b]))))
        first += len(batches[b])
    its: "queue.Queue" = queue.Queue()
    returned: Dict[int, tuple] = {}
    lateness: List[float] = []
    t0 = time.perf_counter() + 0.05

    def feed():
        for b in range(n_due):
            due = t0 + b * interval_s
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lateness.append(time.perf_counter() - due)
            payload = [{"i": i, "seq": s} for i, s in zip(ids[b], batches[b])]
            its.put(al.map_batch(payload))
        its.put(None)

    def consume():
        while True:
            it = its.get()
            if it is None:
                return
            for ms, d in it:
                returned[d["i"]] = (time.perf_counter() - t0, ms)

    feeder = threading.Thread(target=feed, daemon=True)
    consumer = threading.Thread(target=consume, daemon=True)
    feeder.start()
    consumer.start()
    feeder.join()
    consumer.join(timeout=max(0.0, t0 + seconds + DRAIN_S
                              - time.perf_counter()))
    t_end = time.perf_counter() - t0
    latency = {}
    for b in range(n_due):
        for i in ids[b]:
            if i in returned:
                latency[i] = returned[i][0] - b * interval_s
    attempted = first
    return LoopResult(attempted, returned,
                      [i for i in range(attempted) if i not in returned],
                      t0, t_end, seconds, latency, lateness)


def closed_loop(al, reads: List[str], seconds: float,
                chunk: int) -> LoopResult:
    """map_batch in calls of `chunk` reads, the next call always queued
    behind the one being read (the runtime's work queue holds 50,000
    reads), over an endless stream: read i is reads[i % len(reads)]; the
    reads done inside `seconds`."""
    got: List[tuple] = []
    calls: List[object] = []
    stop = threading.Event()
    t0 = time.perf_counter()

    def submit(start):
        n = len(reads)
        calls.append(al.map_batch([{"i": i, "seq": reads[i % n]}
                                   for i in range(start, start + chunk)]))
        return start + chunk

    def run():
        # blocks on the last iterator after it is closed; a daemon, it
        # ends with the process
        nxt = submit(0)
        for k in itertools.count():
            if not stop.is_set():
                nxt = submit(nxt)
            if k >= len(calls):
                return
            for ms, d in calls[k]:
                got.append((time.perf_counter() - t0, d["i"], ms))

    threading.Thread(target=run, daemon=True).start()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    stop.set()
    in_window = [g[1] for g in list(got) if g[0] <= seconds]
    hi = max(in_window, default=-1)
    deadline = time.perf_counter() + DRAIN_S
    while time.perf_counter() < deadline:
        have = {g[1] for g in list(got)}
        if all(i in have for i in range(hi + 1)):
            break
        time.sleep(0.01)
    for it in list(calls):
        it.close()
    returned = {g[1]: (g[0], g[2]) for g in list(got)}
    t_end = time.perf_counter() - t0
    return LoopResult(hi + 1, returned,
                      [i for i in range(hi + 1) if i not in returned],
                      t0, t_end, seconds, in_window=in_window)


def stop_pool(al) -> None:
    """Stop the Aligner's worker threads and wait until each has ended
    (each finishes the batch it holds)."""
    pool = al._pool
    al.enable_threading(0)
    if pool is not None:
        for t in [*pool._threads, pool._collector]:
            t.join(timeout=DRAIN_S)
