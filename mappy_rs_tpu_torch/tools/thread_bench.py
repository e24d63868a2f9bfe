"""The reference-style throughput table: the port of tests/benchmark.py.

    python -m mappy_rs_tpu_torch.tools.thread_bench [n_reads] [read_len]
        [--device cuda|cpu]

n_reads (400) simulated reads of read_len (1,000) bases at 5% error
against a 0.5 Mbp random genome, both from ``default_rng(0)`` and drawn
as tests/benchmark.py draws them (its own per-read ``simulate``, copied
here, so the same seed gives the same reads), map-ont on --device.
After a warm-up, prints single-threaded ``map()`` vs ``map_batch`` at
1, 2 and 4 worker threads: wall seconds, reads/s and reads mapped.
"""
from __future__ import annotations

import sys
import time

import numpy as np

GENOME_LEN = 500_000
THREADS = (1, 2, 4)


def simulate(rng, genome, n, length, err=0.05):
    """tests/benchmark.py's reads: per base, a substitution (60% of
    err), an insertion after it (20%) or a deletion of it and the next
    (20%); capped at length + 24 and half reverse-complemented."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = []
    for _ in range(n):
        start = int(rng.integers(0, len(genome) - length))
        s = list(genome[start: start + length])
        out = []
        i = 0
        while i < len(s):
            r = rng.random()
            if r < err * 0.6:
                out.append(rng.choice([c for c in "ACGT" if c != s[i]]))
                i += 1
            elif r < err * 0.8:
                out.append(s[i])
                out.append(str(rng.choice(list("ACGT"))))
                i += 1
            elif r < err:
                i += 2
            else:
                out.append(s[i])
                i += 1
        read = "".join(out)[: length + 24]
        if rng.random() < 0.5:
            read = "".join(comp[c] for c in reversed(read))
        reads.append(read)
    return reads


def data(n_reads: int, read_len: int):
    """(genome, reads), drawn as tests/benchmark.py draws them."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=GENOME_LEN))
    return genome, simulate(rng, genome, n_reads, read_len)


def run(n_reads: int = 400, read_len: int = 1000, device: str = "cuda") -> dict:
    """The table's rows: (mode, wall seconds, reads mapped)."""
    from ..api import Aligner

    genome, reads = data(n_reads, read_len)
    al = Aligner(seq=genome, preset="map-ont", device=device)
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]

    al.enable_threading(1)  # warm-up: kernel builds, index upload
    for _ in al.map_batch(payload[: min(64, n_reads)]):
        pass
    for r in reads[:4]:
        al.map(r)

    rows = []
    t0 = time.time()
    n = sum(1 for r in reads if al.map(r))
    rows.append(("map() loop, single-threaded", time.time() - t0, n))
    for n_threads in THREADS:
        al.enable_threading(n_threads)
        t0 = time.time()
        n = sum(1 for m, _ in al.map_batch(payload) if m)
        rows.append((f"map_batch, {n_threads} thread(s)", time.time() - t0, n))
    al.enable_threading(0)
    return {"n_reads": n_reads, "read_len": read_len, "device": device,
            "rows": rows}


def report(rec: dict) -> None:
    n_reads = rec["n_reads"]
    print(f"\n{n_reads} reads x {rec['read_len']}bp vs "
          f"{GENOME_LEN / 1e6:.1f}Mbp genome ({rec['device']})")
    print(f"{'mode':<32}{'wall s':>10}{'reads/s':>10}{'mapped':>8}")
    for name, dt, n in rec["rows"]:
        print(f"{name:<32}{dt:>10.2f}{n_reads / dt:>10.1f}{n:>8}", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mappy_rs_tpu_torch.tools.thread_bench",
        description="map() vs map_batch at 1, 2 and 4 threads.")
    ap.add_argument("n_reads", type=int, nargs="?", default=400)
    ap.add_argument("read_len", type=int, nargs="?", default=1000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    report(run(a.n_reads, a.read_len, a.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
