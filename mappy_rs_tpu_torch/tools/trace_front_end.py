"""Where a front-end batch spends its time: a device trace of pipelined
front-end replays, and optionally the host's share.

    python -m mappy_rs_tpu_torch.tools.trace_front_end [N] [--preset map-ont]
        [--len 1000] [--err 0.05] [--reads 512] [--genome-len 32000000]
        [--device cuda|cpu] [--host-profile] [--out PATH]

The workload is the bench's: a seeded random genome of ``--genome-len``
bases (32 Mbp) and ``--reads`` simulated reads of ``--len`` bases at
``--err`` (1 kb at 5%), mapped with ``--preset``.  One batch of the
reads' length bucket, at the full batch shape, warms the engine (on
the card it captures the batch's CUDA graph) and leaves its dispatch
behind: ``AlignmentEngine._probe_eager`` runs the front end's ops
eagerly on the batch's inputs, ``_probe_dispatch`` replays them as the
path does (one graph replay on the card).  Then:

- ``probe_front_end(N)``: pipelined and blocking seconds per batch, of
  the path's dispatch (the graph replay on the card);
- N eager runs at depth 3 (at most 3 in flight, as the engine's
  pipeline keeps them) under ``torch.profiler`` (CPU and, on a card,
  CUDA activity), each between two CUDA events.  From the trace
  (``parse_trace``): device busy ms per batch (kernels, copies and
  memsets; device-side annotation spans are envelopes of those and
  stay out of the sum), the top device ops by ms per batch, and duty =
  busy / the loop's wall.  If the trace holds no device kernel event,
  the tool says so on its own line and sets those fields to null.
  From the events: the device span of a run (its first op to its
  last, idle gaps inside included);
- on the card, the same for N graph replays at depth 3 (``graph``):
  the pipelined wall per replay, its device span and busy time, and
  the duty under graphs; ``graph_ms_per_batch`` is the replay's device
  span;
- ``--host-profile``: serial ``map_batch`` over the reads in batches
  of B with the engine's stage timers and a cProfile top list of host
  time, then the reads through ``enable_threading(4)`` + ``map_batch``
  (reads/s, and the front end's thread-ms per batch there).

On ``--device cpu`` every device field is null.  The record is printed
as JSON and written to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

import numpy as np

GENOME_LEN = 32_000_000
READ_LEN = 1000
ERR = 0.05
N_READS = 512
DEPTH = 3  # replays in flight
#: trace event categories of device work summed into busy time
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: device-side spans of host annotations: envelopes of device work
ENVELOPES = ("gpu_user_annotation",)


def parse_trace(trace: dict):
    """(µs by op name, busy µs, span µs, kernel events) of a Chrome trace
    dict as ``torch.profiler`` exports it.  Names are summed over every
    device event, envelopes included; busy sums the device work only,
    so an envelope and its children are not counted twice; span runs
    from the first device event's start to the last one's end."""
    by_name = collections.Counter()
    busy = 0.0
    n_kernels = 0
    t0, t1 = float("inf"), 0.0
    for e in trace.get("traceEvents", []):
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_WORK + ENVELOPES:
            continue
        d = float(e.get("dur", 0))
        by_name[e["name"]] += d
        if cat in DEVICE_WORK:
            busy += d
            n_kernels += cat == "kernel"
        ts = float(e.get("ts", 0))
        t0, t1 = min(t0, ts), max(t1, ts + d)
    return by_name, busy, (t1 - t0 if t1 > t0 else 0.0), n_kernels


def summarize(trace: dict, n: int, wall_s: float, top: int = 12) -> dict:
    """The device fields of a trace of n replays over wall_s seconds:
    busy and span ms per batch, duty, the top ops by ms per batch and
    every device op's name; all None when the trace holds no device
    kernel event."""
    by_name, busy, span, n_kernels = parse_trace(trace)
    if not n_kernels:
        return {"profiler_device_events": False, "busy_ms_per_batch": None,
                "duty": None, "span_ms_per_batch": None, "top_ops": None,
                "op_names": None}
    return {"profiler_device_events": True,
            "op_names": sorted(by_name),
            "busy_ms_per_batch": busy / n / 1e3,
            "duty": busy / 1e6 / wall_s,
            "span_ms_per_batch": span / n / 1e3,
            "top_ops": [[name, d / n / 1e3]
                        for name, d in by_name.most_common(top)]}


def workload(genome_len: int, read_len: int, err: float, n_reads: int,
             seed: int = 0):
    """(genome, reads) of the bench workload."""
    from ..utils.simulate import random_genome, simulate

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    reads, _ = simulate(rng, genome, n_reads, read_len, err)
    return genome, reads


def trace_replays(al, n: int, top: int = 12, replay=None) -> dict:
    """Profile n pipelined runs of `replay` (default: the engine's last
    front end, run eagerly); the device fields are None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = al._engine
    replay = replay or eng._probe_eager
    if replay is None:
        raise RuntimeError("no front-end batch has run")
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    events = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pending = collections.deque()
        for _ in range(n):
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                replay()
                ev[1].record()
                events.append(ev)
                pending.append(ev[1])
                if len(pending) >= DEPTH:
                    pending.popleft().synchronize()
            else:
                replay()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"replays": n, "wall_ms_per_batch": 1e3 * wall / n,
           "profiler_device_events": None, "busy_ms_per_batch": None,
           "duty": None, "span_ms_per_batch": None, "top_ops": None,
           "op_names": None, "event_ms_per_batch": None}
    if not cuda:
        return rec
    rec["event_ms_per_batch"] = sum(a.elapsed_time(b)
                                    for a, b in events) / n
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            rec.update(summarize(json.load(fh), n, wall, top))
    if not rec["profiler_device_events"]:
        print("torch.profiler recorded no device kernel event: its fields "
              "are null; the CUDA events give the device time", flush=True)
    return rec


def trace_eager_and_graph(al, n: int, top: int = 12) -> dict:
    """The eager runs' record, with the graph replays' under "graph" and
    their device span as "graph_ms_per_batch" (both None where the
    engine runs no graph: off the card, under a device grid)."""
    eng = al._engine
    rec = trace_replays(al, n, top)
    rec["graph"] = rec["graph_ms_per_batch"] = None
    if eng._probe_dispatch is not eng._probe_eager:  # a graph replay
        g = trace_replays(al, n, top, eng._probe_dispatch)
        g.pop("op_names")
        rec["graph"] = g
        rec["graph_ms_per_batch"] = g["event_ms_per_batch"]
    return rec


def host_profile(al, reads, top: int = 25) -> dict:
    """Serial map_batch in batches of B through the engine's timers,
    under cProfile; then the reads through enable_threading(4)."""
    eng = al._engine
    L = eng._bucket_len(max(len(r) for r in reads))
    B = eng.fe_shapes(L)[0]
    eng.metrics.reset()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for s in range(0, len(reads), B):
        eng.map_batch(reads[s:s + B], cs=True)
    pr.disable()
    dt = time.perf_counter() - t0
    serial = eng.metrics.snapshot()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(top)

    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    al.enable_threading(4)
    try:
        for _ in al.map_batch(payload[:B]):  # warm the workers
            pass
        al.reset_metrics()
        t1 = time.perf_counter()
        n_out = sum(1 for _ in al.map_batch(payload))
        dt4 = time.perf_counter() - t1
        threaded = al.metrics
    finally:
        al.enable_threading(0)
    if n_out != len(reads):
        raise RuntimeError(f"map_batch gave {n_out} of {len(reads)} reads")

    def per_batch(m):
        return 1e3 * m.get("time_front_end_s", 0.0) / max(
            m.get("fe_batches", 0.0), 1.0)

    return {"serial_reads_per_s": len(reads) / dt, "serial_metrics": serial,
            "serial_front_end_ms_per_batch": per_batch(serial),
            "threads4_reads_per_s": len(reads) / dt4,
            "threads4_metrics": threaded,
            "threads4_front_end_ms_per_batch": per_batch(threaded),
            "cprofile_top": buf.getvalue()}


def run(preset: str = "map-ont", n: int = 20, read_len: int = READ_LEN,
        err: float = ERR, n_reads: int = N_READS,
        genome_len: int = GENOME_LEN, device: str = "cuda",
        host: bool = False, al=None, reads=None) -> dict:
    """The whole tool: build (or take `al` and `reads`), warm one full
    batch, probe, trace, and with `host` profile the host."""
    import torch

    from ..api import Aligner

    if al is None:
        genome, reads = workload(genome_len, read_len, err, n_reads)
        al = Aligner(seq=genome, preset=preset, device=device)
    eng = al._engine
    eng.cfg.single_batch_shape = True
    L = eng._bucket_len(max(len(r) for r in reads))
    B = eng.fe_shapes(L)[0]
    eng.map_batch(reads[:B])  # warm (capture), leave the dispatch behind
    B, L, M, A = eng._probe_shape
    probe = eng.probe_front_end(n)
    rec = {"device": (torch.cuda.get_device_name(eng.device)
                      if eng.device.type == "cuda" else "cpu"),
           "preset": preset, "shape": {"B": B, "L": L, "M": M, "A": A},
           "probe_ms": [1e3 * s for s in probe],
           **trace_eager_and_graph(al, n)}
    if host:
        rec["host"] = host_profile(al, reads)
    return rec


def report(rec: dict) -> None:
    """Print the record's numbers as lines."""
    s = rec["shape"]
    print(f"{rec['preset']} [{s['B']}, {s['L']}] (M={s['M']}, A={s['A']}) "
          f"on {rec['device']}: eager pipelined wall "
          f"{rec['wall_ms_per_batch']:.3f} ms/batch over {rec['replays']} "
          f"runs (probe_front_end said {rec['probe_ms'][0]:.3f} "
          f"pipelined, {rec['probe_ms'][1]:.3f} blocking)", flush=True)
    if rec["busy_ms_per_batch"] is not None:
        print(f"eager: traced device busy {rec['busy_ms_per_batch']:.4f} "
              f"ms/batch, span {rec['span_ms_per_batch']:.3f} ms/batch, "
              f"duty {100 * rec['duty']:.2f}% of the traced wall")
        print("top device ops (ms/batch):")
        for name, ms in rec["top_ops"]:
            print(f"  {ms:8.4f}  {name[:90]}")
    if rec["event_ms_per_batch"] is not None:
        print("eager: CUDA events: device span "
              f"{rec['event_ms_per_batch']:.4f} ms per run")
    g = rec.get("graph")
    if g:
        busy = ("not traced" if g["busy_ms_per_batch"] is None else
                f"busy {g['busy_ms_per_batch']:.4f} ms/batch, duty "
                f"{100 * g['duty']:.2f}% of the traced wall")
        print(f"graph: pipelined wall {g['wall_ms_per_batch']:.3f} ms/batch "
              f"over {g['replays']} replays, device span "
              f"{g['event_ms_per_batch']:.4f} ms per replay (CUDA events); "
              f"{busy}")
    h = rec.get("host")
    if h:
        print(f"host: serial {h['serial_reads_per_s']:.1f} reads/s, front "
              f"end {h['serial_front_end_ms_per_batch']:.2f} ms/batch; "
              f"4 threads {h['threads4_reads_per_s']:.1f} reads/s, front "
              f"end {h['threads4_front_end_ms_per_batch']:.2f} "
              "thread-ms/batch")
        print("serial stage timers: " + json.dumps(
            {k: v for k, v in sorted(h["serial_metrics"].items())
             if k.startswith(("time_", "fe_"))}))
        print(h["cprofile_top"])
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=20,
                    help="front-end replays traced")
    ap.add_argument("--preset", default="map-ont")
    ap.add_argument("--len", type=int, default=READ_LEN, dest="read_len")
    ap.add_argument("--err", type=float, default=ERR)
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host-profile", action="store_true")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)
    rec = run(args.preset, args.n, args.read_len, args.err, args.reads,
              args.genome_len, args.device, args.host_profile)
    report(rec)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
