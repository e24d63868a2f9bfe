"""What the host gave a run's window, for its log (standard error only;
no metric reads it): the machine's CPU shares from /proc/stat (busy,
idle, steal), this process's CPU seconds, and the busiest threads'
CPU seconds, between two snapshots.  Linux only; elsewhere empty."""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional


def _cpu_line() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as fh:
            return [int(x) for x in fh.readline().split()[1:]]
    except OSError:
        return None


def _threads() -> Dict[str, float]:
    """thread id -> CPU seconds (user + system) of this process's
    threads."""
    out: Dict[str, float] = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                f = fh.read().rsplit(")", 1)[1].split()
            out[tid] = (int(f[11]) + int(f[12])) / tick
        except (OSError, IndexError, ValueError):
            pass
    return out


def snapshot() -> dict:
    t = os.times()
    return {"wall": time.perf_counter(), "proc": t.user + t.system,
            "cpu": _cpu_line(), "threads": _threads()}


def delta(a: dict, b: dict) -> dict:
    """The window between snapshots a and b: wall seconds, the
    machine's busy / idle / steal shares (%), the process's CPU
    seconds, and the five busiest threads' CPU seconds."""
    out = {"wall_s": b["wall"] - a["wall"],
           "process_cpu_s": b["proc"] - a["proc"],
           "cores": os.cpu_count()}
    if a["cpu"] and b["cpu"]:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        tot = max(1, sum(d[:8]))
        idle = d[3] + d[4]
        steal = d[7] if len(d) > 7 else 0
        out.update(busy_pct=100.0 * (tot - idle - steal) / tot,
                   idle_pct=100.0 * idle / tot,
                   steal_pct=100.0 * steal / tot)
    th = sorted((b["threads"][k] - a["threads"].get(k, 0.0)
                 for k in b["threads"]), reverse=True)
    out["top_thread_cpu_s"] = [round(x, 2) for x in th[:5]]
    return out
