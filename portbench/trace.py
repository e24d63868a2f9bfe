"""The traced run's device profile: busy time, kernel time by name, the
top device operations and the longest idle gaps.

``parse_trace`` is mappy_rs_tpu_torch/tools/trace_front_end.py's
(commit 112cabc5c64b): device work is the profiler's kernel, memcpy and
memset events.  Changed: busy time is the union of those events'
intervals (several streams overlap under the worker threads, so their
sum could pass the window), and the events are kept for the gaps.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time

import numpy as np

#: the profiler's categories of device work (trace_front_end.py)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side categories that say what the host was doing in a gap
HOST = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
        "cuda_driver")


def parse_trace(trace: dict):
    """(µs by device op name, merged busy intervals [(start, end)] in
    µs, host events [(start, end, name)])."""
    by_name = collections.Counter()
    iv, host = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, d = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_WORK:
            by_name[e["name"]] += d
            iv.append((ts, ts + d))
        elif cat in HOST:
            host.append((ts, ts + d, e.get("name", "?")))
    iv.sort()
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return by_name, merged, host


def summarize(trace: dict, t_lo: float, t_hi: float, top: int = 10) -> dict:
    """Device fields of a trace whose window ran from t_lo to t_hi (µs,
    on the trace's clock): busy seconds, kernel seconds by name, the
    top device ops and the longest idle gaps, each gap named by the
    longest host event that covers its middle."""
    by_name, merged, host = parse_trace(trace)
    busy = sum(max(0.0, min(t, t_hi) - max(s, t_lo)) for s, t in merged)
    edges = [t_lo] + [x for s, t in merged for x in (s, t)] + [t_hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    named = []
    for s, t in gaps[:top]:
        mid = (s + t) / 2
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        name = (host[int(cover[np.argmax(he[cover] - hs[cover])])][2]
                if len(cover) else "no CUDA call on the host (host C++ or "
                "Python work)")
        named.append([name, (t - s) / 1e6])
    return {
        "busy_s": busy / 1e6,
        "kernel_s": {n: d / 1e6 for n, d in by_name.items()},
        "device_ops": [[n, d / 1e6] for n, d in by_name.most_common(top)],
        "idle_gaps": named,
        "n_device_events": len(merged),
    }


class Profile:
    """torch.profiler's CUDA activity over the end of the window (the
    device's kernels, copies and sets, and the host's CUDA API calls; no
    CPU op events, whose volume under four worker threads costs minutes
    to process).  One helper thread drives it: ``arm`` enters the
    profiler in its warm-up phase before the window (the profiler's own
    set-up takes seconds and would stall the window), ``start_timer``
    switches it to recording `delay_s` after the window opens, and
    ``stop`` ends it once the window's reads are all done, so that
    processing the trace stalls nothing inside the window.  The times of
    the switch and the stop give the reads it covers.  Exported once and parsed (the export goes to the temporary
    directory and is deleted)."""

    def __init__(self, al, delay_s: float):
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1))
        self._al = al
        self.delay_s = delay_s
        self.wall_s = 0.0
        self.t_on = self.t_off = 0.0  # perf_counter at the switch, the stop
        self._t0 = None

    def arm(self) -> None:
        import threading

        armed = threading.Event()
        self._go = threading.Event()
        self._done = threading.Event()

        def run():
            # the thread that enters the profiler also steps and stops it
            self._prof.__enter__()
            armed.set()
            self._go.wait()
            time.sleep(max(0.0, self._t0 + self.delay_s - time.perf_counter()))
            self._prof.step()  # warm-up -> recording
            self.t_on = time.perf_counter()
            self._done.wait()
            self.t_off = time.perf_counter()
            self.wall_s = self.t_off - self.t_on
            self._prof.__exit__(None, None, None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        armed.wait()

    def start_timer(self) -> None:
        self._t0 = time.perf_counter()
        self._go.set()

    def stop(self) -> None:
        self._done.set()
        self._thread.join()

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)
        # the window on the trace's clock: from the first to the last
        # event of any kind, at least the wall time measured around it
        ts = [float(e["ts"]) for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
        t_lo = min(ts) if ts else 0.0
        t_hi = max(t_lo + self.wall_s * 1e6,
                   max((float(e["ts"]) + float(e.get("dur", 0))
                        for e in trace.get("traceEvents", [])
                        if e.get("ph") == "X" and "ts" in e), default=0.0))
        out = summarize(trace, t_lo, t_hi)
        out["window_s"] = (t_hi - t_lo) / 1e6
        return out
