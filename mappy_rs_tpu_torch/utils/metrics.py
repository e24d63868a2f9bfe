"""Engine metrics: per-stage sums, counters and the workers' timeline.

The reference has no observability beyond eprintln (SURVEY.md §5).
Here every stage is a ``span``: its thread seconds and calls are
summed per name (``time_<name>_s``, ``calls_<name>``) beside plain
counters (``add``), aggregated per AlignmentEngine; ``snapshot()``
returns them as a plain dict.  Each thread sums its own spans into its
own dict, so a span takes no lock, and reuses one span object per name,
so a span makes no object of its own.

The spans named in ``STATES`` are what a worker thread is doing: waiting
for work, for its peers or for room in the results queue, staging,
submitting or waiting on a front end, or the post-chain.  A state opened
inside another pauses it: the outer state's sums leave the inner one's
time out, so the states' sums split a worker's time without counting any
of it twice.  The other spans (``map_batch``, ``front_end``, ``extend``,
...) are sums only.

The timeline, off unless switched on (``set_timeline``,
``Aligner.enable_timeline``), keeps each thread's last
``TIMELINE_RECORDS`` states as records (the oldest dropped and counted
in ``timeline_dropped``); ``span_events`` gives them as Chrome-trace
events on torch.profiler's clock, to lay beside the card's trace.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List

#: the spans that are a worker thread's state (runtime/batch.py,
#: models/pipeline.py, models/graphs.py)
STATES = frozenset({
    "queue_wait",     # the work queue empty
    "epoch_wait",     # the barrier after a call's Done pill
    "result_wait",    # the results queue full
    "fe_stage",       # the reads' codes, a front end's host arrays, its upload
    "fe_submit",      # its graph replay or eager launch
    "fe_wait",        # the wait for its results on the card
    "fe_host_bt",     # the host chain backtrack and its download
    "graph_capture",  # a CUDA graph's capture
    "post_chain",     # the native post-chain call
    "finalize",       # records out of the post-chain
    "post_chain_py",  # the Python post-chain of fallback reads
})

#: the waits: one open at ``reset()`` is not summed, since its time
#: reaches back before the reset (an idle worker waits for minutes)
WAITS = frozenset({"queue_wait", "epoch_wait", "result_wait"})

#: state records each thread keeps while the timeline is on
TIMELINE_RECORDS = 1 << 16

_perf_ns = time.perf_counter_ns


class _Line:
    """One thread's span sums (name -> [nanoseconds, calls]) from reset
    number `gen` on, its span objects, its open states and, with the
    timeline on, its records (name, start, end) in perf_counter ns."""

    __slots__ = ("thread", "tid", "gen", "sums", "spans", "stack", "buf",
                 "dropped")

    def __init__(self, gen: int, on: bool) -> None:
        self.thread = threading.current_thread()
        self.tid = threading.get_native_id()
        self.gen = gen
        self.sums: Dict[str, list] = {}
        self.spans: Dict[str, "_Span"] = {}
        self.stack: List["_Span"] = []
        self.buf = _buffer() if on else None
        self.dropped = 0

    def emit(self, name: str, start: int, end: int) -> None:
        buf = self.buf
        if buf is None or end <= start:
            return
        if len(buf) == buf.maxlen:
            self.dropped += 1
        buf.append((name, start, end))


def _buffer() -> collections.deque:
    return collections.deque(maxlen=TIMELINE_RECORDS)


class _Span:
    """A span of one name on one thread, entered again for each use."""

    __slots__ = ("_m", "_line", "_name", "_state", "_wait", "_open", "_gen",
                 "_t0", "_seg", "_t_in")

    def __init__(self, m: "EngineMetrics", line: _Line, name: str) -> None:
        self._m = m
        self._line = line
        self._name = name
        self._state = name in STATES
        self._wait = name in WAITS
        self._open = False

    def __enter__(self) -> "_Span":
        self._open = True
        self._gen = self._m._gen
        self._t0 = t0 = _perf_ns()
        if self._state:
            line = self._line
            self._seg = t0
            self._t_in = 0
            if line.stack and line.buf is not None:
                outer = line.stack[-1]
                line.emit(outer._name, outer._seg, t0)
            line.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        t1 = _perf_ns()
        dt = t1 - self._t0
        line = self._line
        if self._state:
            line.stack.pop()
            if line.buf is not None:
                line.emit(self._name, self._seg, t1)
            if line.stack:
                outer = line.stack[-1]
                outer._t_in += dt
                outer._seg = t1
            dt -= self._t_in
        self._open = False
        gen = self._m._gen
        if line.gen != gen:
            # the first span to end after a reset starts the sums anew;
            # the dict before the number, which snapshot() reads first
            line.sums = {}
            line.gen = gen
        if self._wait and self._gen != gen:
            return  # a wait begun before a reset: not summed
        acc = line.sums.get(self._name)
        if acc is None:
            acc = line.sums[self._name] = [0, 0]
        acc[0] += dt
        acc[1] += 1


class EngineMetrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self._local = threading.local()
        self._lines: List[_Line] = []
        self._on = False
        self._gen = 0  # reset() count
        # one (perf_counter_ns, time_ns) pair maps the records to Unix time
        self._clock = (0, 0)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def span(self, name: str) -> _Span:
        """``with metrics.span(name):`` sums the block's thread seconds
        under `name`; a name in STATES is also a state of the thread
        (see the module's docstring)."""
        try:
            line = self._local.line
        except AttributeError:
            line = self._new_line()
        sp = line.spans.get(name)
        if sp is None:
            sp = line.spans[name] = _Span(self, line, name)
        elif sp._open:  # the same name nested: a span of its own
            sp = _Span(self, line, name)
        return sp

    def _new_line(self) -> _Line:
        with self._lock:
            line = self._local.line = _Line(self._gen, self._on)
            self._lines.append(line)
        return line

    # -- the timeline ---------------------------------------------------
    def set_timeline(self, on: bool) -> None:
        """Switch the timeline on (each thread keeps its last
        TIMELINE_RECORDS states) or off (its records gone)."""
        with self._lock:
            if bool(on) == self._on:
                return
            self._on = bool(on)
            if on:
                self._clock = (_perf_ns(), time.time_ns())
            for line in self._lines:
                line.buf = _buffer() if on else None
                line.dropped = 0

    @property
    def timeline(self) -> bool:
        """Whether the timeline is on."""
        return self._on

    def trace_us(self, t_ns: int, base_ns: int = 0) -> float:
        """A perf_counter_ns reading on torch.profiler's trace clock: µs
        after `base_ns`, the trace's ``baseTimeNanoseconds`` (the result
        plus base_ns / 1e3 is Unix time in µs).  Needs the timeline on."""
        p0, e0 = self._clock
        return (e0 + (t_ns - p0) - base_ns) / 1e3

    def span_events(self, base_ns: int = 0) -> List[dict]:
        """The timeline's records as Chrome-trace "X" events (category
        ``user_annotation``, ``tid`` the thread's native id, ``ts`` and
        ``dur`` in µs on the clock of ``trace_us``), in start order."""
        with self._lock:
            lines = [(ln.tid, ln.thread.name, list(ln.buf))
                     for ln in self._lines if ln.buf is not None]
        pid = os.getpid()
        out = [{"ph": "X", "cat": "user_annotation", "name": name,
                "pid": pid, "tid": tid, "ts": self.trace_us(s, base_ns),
                "dur": (e - s) / 1e3, "args": {"thread": tname}}
               for tid, tname, recs in lines for name, s, e in recs]
        out.sort(key=lambda e: e["ts"])
        return out

    # -- reading --------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            tot: Dict[str, list] = {}
            for line in self._lines:
                if line.gen != self._gen:
                    continue  # no span ended on it since the reset
                for k, (t, n) in list(line.sums.items()):
                    acc = tot.setdefault(k, [0, 0])
                    acc[0] += t
                    acc[1] += n
            for k, (t, n) in tot.items():
                out[f"time_{k}_s"] = round(t * 1e-9, 4)
                out[f"calls_{k}"] = n
            if self._on:
                out["timeline_dropped"] = sum(ln.dropped for ln in self._lines)
            return out

    def reset(self) -> None:
        """Zero every sum and counter and empty the timeline.  A span
        open now is summed whole when it ends, as the stage timers were,
        except a wait (WAITS); every record still enters the timeline."""
        with self._lock:
            self._gen += 1
            self.counters.clear()
            self._lines = [ln for ln in self._lines if ln.thread.is_alive()]
            for line in self._lines:
                if line.buf is not None:
                    line.buf.clear()
                line.dropped = 0
