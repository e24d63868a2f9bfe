"""Memory-stability soak: the port of tests/memory.py.

    python -m mappy_rs_tpu_torch.tools.memory [--threaded] [--no-op]
        [--cycles N] [--device cuda|cpu] [--out PATH]

Cycles 50 reads of 500 bases (exact substrings of a 100 kb random
genome, drawn from ``default_rng(0)`` as tests/memory.py draws them)
through the aligner --cycles times (50): ``map()`` per read,
``map_batch`` over 2 worker threads (--threaded) or ``map_no_op``
(--no-op).  Prints the process's peak RSS (tests/memory.py's figure)
and its resident set now at cycle 0, every tenth cycle and the last; on
a card the same lines carry ``torch.cuda.memory_allocated`` and
``memory_reserved``.  readfish runs for days in one process, so growth
after the warm-up is a leak.  The resident set now is the one to hold:
a process started by a larger one inherits its peak (Linux keeps
ru_maxrss across fork and exec), which then hides any growth.

Exits 1 when the peak or the current RSS grew more than 200 MB after
cycle 2 (the warm-up allocations), when allocated or reserved card
memory did, or when a cycle's Mappings differ from the first cycle's.
--out writes the record as JSON.
"""
from __future__ import annotations

import hashlib
import json
import os
import resource
import sys

import numpy as np

LIMIT_MB = 200.0


def max_rss_mb() -> float:
    """Peak resident set size of this process: ru_maxrss (KiB on Linux),
    or the resident set now where that is higher (Linux raises its
    high-water mark lazily, so while the set grows ru_maxrss can lag
    it)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    return max(peak, rss_mb())


def rss_mb() -> float:
    """Resident set size of this process now (/proc/self/statm)."""
    with open("/proc/self/statm") as fh:
        pages = int(fh.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def _digest(results) -> str:
    """A cycle's Mappings, every field, in read order, as one hash."""
    h = hashlib.sha256()
    for ms in results:
        h.update(repr([[getattr(m, s) for s in m.__slots__]
                       for m in ms]).encode())
    return h.hexdigest()[:16]


def data():
    """(genome, reads), drawn as tests/memory.py draws them."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=100_000))
    reads = [genome[int(p): int(p) + 500]
             for p in rng.integers(0, len(genome) - 500, 50)]
    return genome, reads


def run(cycles: int = 50, threaded: bool = False, no_op: bool = False,
        device: str = "cuda") -> dict:
    """The soak; its record (lines per report, growth, digests)."""
    import torch

    from ..api import Aligner

    genome, reads = data()
    al = Aligner(seq=genome, device=device)
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    card = al._engine.device.type == "cuda"
    if threaded:
        al.enable_threading(2)

    def card_mb():
        if not card:
            return None
        dev = al._engine.device
        return (torch.cuda.memory_allocated(dev) / 2**20,
                torch.cuda.memory_reserved(dev) / 2**20)

    base = base_card = None
    lines, digests = [], []
    for cycle in range(cycles):
        if no_op:
            got = [al.map_no_op(r) for r in reads]
        elif threaded:
            by_i = {d["i"]: ms for ms, d in al.map_batch(payload)}
            got = [by_i[i] for i in range(len(reads))]
        else:
            got = [al.map(r) for r in reads]
        digests.append(_digest(got))
        if cycle == 2:  # after the warm-up
            base, base_card = (max_rss_mb(), rss_mb()), card_mb()
        if cycle % 10 == 0 or cycle == cycles - 1:
            cm = card_mb()
            line = (f"cycle {cycle:4d}  max_rss={max_rss_mb():8.1f} MB  "
                    f"rss={rss_mb():8.1f} MB")
            if cm is not None:
                line += (f"  cuda allocated={cm[0]:8.1f} MB  "
                         f"reserved={cm[1]:8.1f} MB")
            print(line, flush=True)
            lines.append({"cycle": cycle, "max_rss_mb": max_rss_mb(),
                          "rss_mb": rss_mb(),
                          "cuda_allocated_mb": cm and cm[0],
                          "cuda_reserved_mb": cm and cm[1]})
    al.enable_threading(0)
    rec = {"cycles": cycles, "threaded": threaded, "no_op": no_op,
           "device": str(al._engine.device), "lines": lines,
           "digests_equal": len(set(digests)) <= 1,
           "max_rss_growth_mb": None, "rss_growth_mb": None,
           "cuda_growth_mb": None}
    if base is not None:
        rec["max_rss_growth_mb"] = max_rss_mb() - base[0]
        rec["rss_growth_mb"] = rss_mb() - base[1]
        if base_card is not None:
            now = card_mb()
            rec["cuda_growth_mb"] = {"allocated": now[0] - base_card[0],
                                     "reserved": now[1] - base_card[1]}
    return rec


def check(rec: dict) -> list:
    """What failed: growth over LIMIT_MB, or Mappings that changed."""
    bad = []
    for k in ("max_rss", "rss"):
        v = rec[f"{k}_growth_mb"]
        if v is not None and v > LIMIT_MB:
            bad.append(f"{k} grew {v:.1f} MB")
    for k, v in (rec["cuda_growth_mb"] or {}).items():
        if v > LIMIT_MB:
            bad.append(f"cuda {k} grew {v:.1f} MB")
    if not rec["digests_equal"]:
        bad.append("a cycle's Mappings differ from the first cycle's")
    return bad


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mappy_rs_tpu_torch.tools.memory",
        description="RSS and card memory over streaming cycles.")
    ap.add_argument("--threaded", action="store_true")
    ap.add_argument("--no-op", action="store_true")
    ap.add_argument("--cycles", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rec = run(a.cycles, a.threaded, a.no_op, a.device)
    if rec["rss_growth_mb"] is not None:
        print(f"rss growth after warm-up: peak {rec['max_rss_growth_mb']:.1f}"
              f" MB, now {rec['rss_growth_mb']:.1f} MB")
    if rec["cuda_growth_mb"] is not None:
        g = rec["cuda_growth_mb"]
        print(f"cuda growth after warm-up: allocated {g['allocated']:.1f} "
              f"MB, reserved {g['reserved']:.1f} MB")
    bad = check(rec)
    rec["failed"] = bad
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    if bad:
        print("WARNING: possible leak: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
