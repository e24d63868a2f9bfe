"""Lightweight engine metrics/observability.

The reference has no observability beyond eprintln (SURVEY.md §5);
this build makes per-stage counters first-class since the north-star
metrics include DP cell-updates/sec. Counters are cheap (GIL-atomic
float/int adds) and aggregated per AlignmentEngine; `snapshot()`
returns a plain dict for logging or the bench harness.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class EngineMetrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.timings: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name] += dt
                self.calls[name] += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            for k, v in self.timings.items():
                out[f"time_{k}_s"] = round(v, 4)
                out[f"calls_{k}"] = self.calls[k]
            cells = self.counters.get("dp_cells", 0.0)
            t_ext = self.timings.get("extend", 0.0)
            if cells and t_ext:
                out["dp_cells_per_sec"] = cells / t_ext
            reads = self.counters.get("reads", 0.0)
            t_all = self.timings.get("map_batch", 0.0)
            if reads and t_all:
                out["reads_per_sec"] = reads / t_all
            return out

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timings.clear()
            self.calls.clear()
