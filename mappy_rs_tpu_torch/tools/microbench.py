"""Microbenchmarks of the card and the front end: the port of microbench.py.

    python -m mappy_rs_tpu_torch.tools.microbench [--device cuda|cpu]
        [--genome-mb N]

On a card:
1. dispatch round trip: a one-element add plus torch.cuda.synchronize;
2. download (card -> host) of 64, 256, 1,024 and 4,096 KB of int32, into
   pageable and into pinned host memory;
3. upload of 4 MB (1,024 x 1,024 int32) from pageable host memory.
Each is timed on the host clock, 5 runs (4 for the transfers): min and
median; the rates are from the median.  Then, on any device:
4. the front end on 256 bench reads (tools/bench.py's workload at
   --genome-mb, 32 by default): one warm engine map_batch, then
   compute only = the engine's ``_probe_dispatch`` replay (the device
   work probe_front_end times: no staging, no download) and compute +
   download = ``fe_submit`` + ``fe_collect`` of the same reads (staging,
   upload, the front end and the chain table's download), 5 runs each,
   and a second warm map_batch with the engine's metrics.
With --device cpu parts 1-3 are left out (there is no card to time) and
part 4 runs the plain versions.
"""
from __future__ import annotations

import sys
import time

import numpy as np

TRANSFER_KB = (64, 256, 1024, 4096)
N_FRONT_END = 256


def timeit(fn, n: int = 5):
    """(min, median) host seconds of n calls of fn."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), sorted(ts)[len(ts) // 2]


def card_parts(dev) -> dict:
    """Parts 1-3: dispatch round trip, download and upload."""
    import torch

    def sync():
        torch.cuda.synchronize(dev)

    out = {}
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    _ = x + 1
    sync()
    mn, md = timeit(lambda: ((x + 1), sync()))
    out["dispatch_ms"] = {"min": 1e3 * mn, "med": 1e3 * md}
    print(f"dispatch+tiny roundtrip: min={mn * 1e3:.3f}ms "
          f"med={md * 1e3:.3f}ms", flush=True)
    out["download"] = {}
    for kb in TRANSFER_KB:
        n = kb * 256
        arr = torch.arange(n, dtype=torch.int32, device=dev)
        pinned = torch.empty(n, dtype=torch.int32, pin_memory=True)
        sync()
        row = {}
        for kind, fn in (("pageable", lambda: arr.cpu()),
                         ("pinned", lambda: pinned.copy_(arr))):
            fn()
            mn, md = timeit(fn, 4)
            row[kind] = {"min_ms": 1e3 * mn, "med_ms": 1e3 * md,
                         "mb_per_s": kb / 1024 / md}
            print(f"download {kb:5d}KB {kind:8s}: min={mn * 1e3:7.3f}ms "
                  f"med={md * 1e3:7.3f}ms  -> {kb / 1024 / md:8.1f} MB/s "
                  f"(med)", flush=True)
        out["download"][kb] = row
    up = np.zeros((1024, 1024), np.int32)  # 4 MB

    def upload():
        torch.from_numpy(up).to(dev)
        sync()

    upload()
    mn, md = timeit(upload, 4)
    out["upload_4096kb"] = {"min_ms": 1e3 * mn, "med_ms": 1e3 * md,
                            "mb_per_s": 4 / md}
    print(f"upload 4096KB: min={mn * 1e3:.3f}ms med={md * 1e3:.3f}ms -> "
          f"{4 / md:.1f} MB/s (med)", flush=True)
    return out


def front_end_part(dev, genome_mb: int) -> dict:
    """Part 4: the front end on 256 bench reads, compute only vs compute
    + download."""
    import torch

    from ..api import Aligner
    from ..utils.seqcodes import encode
    from .bench import PRESET, workload

    wl = workload(genome_mb, N_FRONT_END, 1, N_FRONT_END)
    al = Aligner(seq=wl.genome, preset=PRESET, device=str(dev))
    eng = al._engine
    reads = wl.reads

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    t0 = time.perf_counter()
    eng.map_batch(reads)
    out["warm_map_batch_s"] = time.perf_counter() - t0
    print(f"warm map_batch({len(reads)}): {out['warm_map_batch_s']:.2f}s",
          flush=True)

    replay = eng._probe_dispatch

    def compute_only():
        replay()
        sync()

    mn, md = timeit(compute_only)
    out["compute_only_ms"] = {"min": 1e3 * mn, "med": 1e3 * md}
    print(f"front_end compute only: min={mn * 1e3:.1f}ms "
          f"med={md * 1e3:.1f}ms", flush=True)

    codes = [encode(r) for r in reads]
    L = eng._bucket_len(max(len(c) for c in codes))

    def with_download():
        eng.fe_collect(eng.fe_submit(codes, L))

    mn, md = timeit(with_download)
    out["compute_download_ms"] = {"min": 1e3 * mn, "med": 1e3 * md}
    print(f"front_end + download:   min={mn * 1e3:.1f}ms "
          f"med={md * 1e3:.1f}ms", flush=True)

    eng.metrics.reset()
    t0 = time.perf_counter()
    eng.map_batch(reads)
    out["second_map_batch_s"] = time.perf_counter() - t0
    out["metrics"] = eng.metrics.snapshot()
    print(f"second warm map_batch({len(reads)}): "
          f"{out['second_map_batch_s']:.2f}s  metrics={out['metrics']}",
          flush=True)
    return out


def run(device: str = "cuda", genome_mb: int = 32) -> dict:
    from ..index.index import resolve_device

    dev = resolve_device(device)
    rec = {"device": str(dev)}
    if dev.type == "cuda":
        from .gbp_chip import card_line

        rec["card"] = card_line()
        rec.update(card_parts(dev))
    else:
        print(f"{dev}: no card, so no dispatch or transfer time "
              f"(measured on a card only)", flush=True)
    rec["front_end"] = front_end_part(dev, genome_mb)
    return rec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mappy_rs_tpu_torch.tools.microbench",
        description="Dispatch, transfer and front-end microbenchmarks.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genome-mb", type=int, default=32)
    a = ap.parse_args(argv)
    run(a.device, a.genome_mb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
