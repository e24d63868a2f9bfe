"""Reads/sec per card on an ONT-like mapping workload, against a CPU
baseline measured on the same host: the port of the repo's bench.py.

    python -m mappy_rs_tpu_torch.tools.bench [--genome-mb=N] [--baseline]
        [--baseline-file PATH] [--device cuda|cpu] [--out PATH]
        [--reads N] [--passes N] [--cpu-reads N]

Workload (bench.py's): a random genome of --genome-mb Mbp (32; or
BENCH_GENOME_MB) from ``default_rng(0)``, then from the same generator
6 disjoint payloads of 8,000 simulated 1 kb reads at 5% error
(utils/simulate.py ``simulate``, a copy of bench.py's).  The CPU
baseline maps the first 1,500 reads of the first 3 payloads.  The same
seed gives byte-identical reads.  --reads, --passes and --cpu-reads
cut the counts for a small run.

Card path (bench.py's defaults): map-ont on --device, topology
"device_owner" with 3 CUDA-free post-chain children behind 9 proxies
and proc_chunk 512 ("classic": 7 children, 2 proxies each, proc_chunk
1,024); MAPPY_RS_TPU_TOPOLOGY, _PROCS, _PROXIES and _PROC_CHUNK override
them.  ``warmup`` on 256 reads through every child, then ``measure``: a
256-read warm pass, the metrics and the K1 / K2 launch counts reset,
the passes.  The value is the median pass's reads/s.  Then
``probe_front_end(10)`` and ``front_end_roofline()``.

CPU baseline: the all-native CPU path (native front end, C++ extension)
on an Aligner with device="cpu", so no child opens a CUDA context; the
better of n_cores threads and n_cores "classic" processes, each child
on one torch thread; n_cores = len(os.sched_getaffinity(0)), the CPUs
this process may run on.  It is measured in every run: a baseline from
another host divides across hardware.  --baseline-file PATH reads the
baseline from PATH when its workload fingerprint and n_cores match this
run's, and otherwise measures it and writes it there.  --baseline
measures the baseline alone (and writes --baseline-file if named).

Output: one JSON line on stdout with bench.py's keys plus "card"
(nvidia-smi's name and power limit); bench.py's "#" lines on stderr,
with the front end's roofline against the H100's 3.35 TB/s and int32
rate and the front-end CUDA graphs; the whole record (every pass's
placement, this process's K1 / K2 launches during the passes, the
baseline's modes and the compute apps on the card while its children
ran) to --out (default chiprun_out/bench.json), with "fe_graphs": the
graphs captured in the warm-up ("warmup_captures") and during the
passes ("captures"), the replays and front-end batches of the passes
(on one card every batch is a replay; 0 replays off it) and the MB of
the captured graphs' memory pools.

Not carried over from bench.py, each because it hides a failure or
works around the TPU's shared backend:
- the subprocess retry ladder with PYTHONHASHSEED: a hang on the card
  is a fault, not noise to retry;
- the persistent compile cache: a TPU compile workaround (the CUDA
  kernels build once per checkout);
- FALLBACK_BASELINE: a missing native library raises;
- the BENCH_TPU_ONLY pinned divisor: the divisor is always measured;
- writing BASELINE_CPU.json: that file belongs to bench.py;
- the BENCH_BUDGET_S deadline that cut passes short on a congested
  backend: every pass runs, and the median is over all of them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..utils.simulate import random_genome, simulate
from .gbp_chip import card_line, counters, reset_counters

SEED = 0
GENOME_MB = 32
N_READS = 8000       # reads per card pass
N_PASS = 6
N_READS_CPU = 1500   # reads per baseline pass
N_PASS_CPU = 3
N_WARM = 256
N_PROBE = 10
READ_LEN = 1000
ERROR_RATE = 0.05
PRESET = "map-ont"
# H100 SXM peaks (NVIDIA data sheet; chip_smoke.py bound()): HBM3 bytes/s,
# and int32 ops/s = 64 INT32 lanes per SM x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def _log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass
class Workload:
    genome_mb: int
    genome: str
    reads: List[str]
    truth: List[int]
    payloads: list      # card passes: lists of {"i", "seq"}
    cpu_payloads: list  # baseline passes

    @property
    def fingerprint(self) -> dict:
        """bench.py's _workload_fp: a baseline is valid only for it."""
        return {"genome_mb": self.genome_mb,
                "n_reads": len(self.cpu_payloads[0]),
                "read_len": READ_LEN, "error_rate": ERROR_RATE}


def workload(genome_mb: int = GENOME_MB, n_reads: int = N_READS,
             n_pass: int = N_PASS, n_reads_cpu: int = N_READS_CPU) -> Workload:
    """bench.py's genome, reads and payloads for these counts."""
    if not 0 < n_reads_cpu <= n_reads:
        raise ValueError(f"baseline reads {n_reads_cpu} must be in "
                         f"1..{n_reads} (the reads per pass)")
    rng = np.random.default_rng(SEED)
    genome = random_genome(rng, genome_mb * 1_000_000)
    reads, truth = simulate(rng, genome, n_pass * n_reads, READ_LEN,
                            ERROR_RATE)
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    payloads = [payload[p * n_reads:(p + 1) * n_reads] for p in range(n_pass)]
    cpu_payloads = [payload[p * n_reads:p * n_reads + n_reads_cpu]
                    for p in range(min(N_PASS_CPU, n_pass))]
    return Workload(genome_mb, genome, reads, truth, payloads, cpu_payloads)


def measure(al, payloads, truth, n_warm: int = N_WARM,
            reset_after_warm: bool = False):
    """bench.py's _measure: a warm pass on the first payload's first
    n_warm reads, then (with reset_after_warm) the metrics and the K1 /
    K2 launch counts reset, then one timed pass per disjoint payload.
    Returns (passes, best, wall): passes as (reads_per_sec, dt, n_hit,
    n_correct), n_correct = primary within 100 bp of the origin."""
    for _ in al.map_batch(payloads[0][:n_warm]):
        pass
    if reset_after_warm:
        reset_counters(al)
    passes = []
    wall = 0.0
    for payload in payloads:
        n_correct = n_hit = 0
        t0 = time.time()
        for mappings, data in al.map_batch(payload):
            if mappings:
                n_hit += 1
                if abs(mappings[0].target_start - truth[data["i"]]) < 100:
                    n_correct += 1
        dt = time.time() - t0
        wall += dt
        passes.append((len(payload) / dt, dt, n_hit, n_correct))
    best = max(passes, key=lambda p: p[0])
    return passes, best, wall


def median(rates: List[float]) -> float:
    r = sorted(rates)
    h = len(r) // 2
    return r[h] if len(r) % 2 else 0.5 * (r[h - 1] + r[h])


def compute_apps() -> Optional[List[int]]:
    """nvidia-smi's compute-app PIDs (one per process holding a context
    on a card), or None without nvidia-smi."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return [int(x) for x in res.stdout.split() if x.strip().isdigit()]


@contextlib.contextmanager
def _one_thread_children():
    """Children spawned inside inherit OMP_NUM_THREADS=1: one torch
    thread each, so n_cores children do not oversubscribe the cores."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def cpu_aligner(genome: str):
    """The baseline's Aligner: the all-native CPU path on device="cpu"."""
    from ..api import Aligner

    al = Aligner(seq=genome, preset=PRESET, device="cpu")
    al._config.front_end_backend = "cpu"
    al._config.extension_backend = "host"
    al._config.topology = "classic"
    return al


def measure_cpu_baseline(wl: Workload) -> dict:
    """bench.py's _measure_cpu_baseline: the better of n_cores threads
    and n_cores processes.  Raises without the native library, or if
    the children do not start."""
    from .. import native

    if not native.available():
        raise RuntimeError("the CPU baseline needs the native library "
                           "(mappy_rs_tpu_torch/native), which did not build")
    n_cores = len(os.sched_getaffinity(0))
    al = cpu_aligner(wl.genome)
    apps_before = compute_apps()
    apps_during = None
    modes = {}
    cpu_rps, cpu_desc = 0.0, ""
    for n_procs in (0, n_cores):
        al._config.worker_processes = n_procs
        with _one_thread_children():
            al.enable_threading(n_cores)
        try:
            if n_procs and al._procs is None:
                raise RuntimeError("the baseline's worker processes did "
                                   "not start")
            _passes, best, _w = measure(al, wl.cpu_payloads, wl.truth)
            if n_procs:
                apps_during = compute_apps()  # the children are alive
        finally:
            al.enable_threading(0)
        r, _dt, _hit, ok = best
        mode = f"{n_procs} procs" if n_procs else f"{n_cores} threads"
        modes[mode] = r
        if r > cpu_rps:
            cpu_rps = r
            cpu_desc = f"{mode}, {ok}/{len(wl.cpu_payloads[0])} correct"
    on_card = (len(apps_during) - len(apps_before)
               if apps_before is not None and apps_during is not None
               else None)
    return {
        "value": round(cpu_rps, 1),
        "date": time.strftime("%Y-%m-%d"),
        "desc": f"all-native CPU path, best of threads/procs ({cpu_desc})",
        "n_cores": n_cores,
        "workload": wl.fingerprint,
        "modes": modes,
        "compute_apps_before": apps_before,
        "compute_apps_during": apps_during,
        "children_on_card": on_card,
    }


def load_baseline(path: str, fingerprint: dict, n_cores: int) -> Optional[dict]:
    """The baseline in `path` when it was measured on this workload with
    this many cores; else None."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        _log(f"baseline file {path} unreadable ({exc}); measuring anew")
        return None
    if (isinstance(d, dict) and d.get("workload") == fingerprint
            and d.get("n_cores") == n_cores and d.get("value", 0) > 0):
        return d
    return None


def baseline_for(wl: Workload, path: Optional[str], force: bool) -> dict:
    """The baseline from `path` if it matches, else measured (and written
    to `path` when named)."""
    n_cores = len(os.sched_getaffinity(0))
    if path and not force:
        d = load_baseline(path, wl.fingerprint, n_cores)
        if d is not None:
            _log(f"CPU baseline from {path}: {d['value']:.1f} reads/s "
                 f"({d['date']}, {n_cores} cores)")
            return d
    t0 = time.time()
    d = measure_cpu_baseline(wl)
    _log(f"measured CPU baseline {d['value']:.1f} reads/s on {n_cores} "
         f"cores ({time.time() - t0:.1f}s; {d['modes']})")
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(d, fh, indent=1)
    return d


def card_aligner(genome: str, device: str):
    """The card path's Aligner: map-ont on `device`, with bench.py's
    topology, children and chunk (or the environment's)."""
    from ..api import Aligner

    al = Aligner(seq=genome, preset=PRESET, device=device)
    topo = os.environ.get("MAPPY_RS_TPU_TOPOLOGY", "device_owner")
    devown = topo == "device_owner"
    al._config.topology = topo
    al._config.worker_processes = int(os.environ.get(
        "MAPPY_RS_TPU_PROCS", "3" if devown else "7"))
    al._config.proc_chunk = int(os.environ.get(
        "MAPPY_RS_TPU_PROC_CHUNK", "512" if devown else "1024"))
    return al


def run_card(wl: Workload, device: str) -> dict:
    """bench.py's card path: the topology, warm-up, passes and probes."""
    t0 = time.time()
    al = card_aligner(wl.genome, device)
    topo, n_procs = al._config.topology, al._config.worker_processes
    index_s = time.time() - t0
    _log(f"index build: {index_s:.1f}s")
    t0 = time.time()
    # proxies per child: "device_owner" runs the front end in the proxies,
    # so one can wait on its child while another feeds the card
    n_proxies = int(os.environ.get(
        "MAPPY_RS_TPU_PROXIES",
        str((3 if topo == "device_owner" else 2) * n_procs)))
    al.enable_threading(n_proxies)
    try:
        if n_procs > 0 and al._procs is None:
            raise RuntimeError(f"the {topo} worker processes did not start")
        al.warmup(wl.reads[:N_WARM])
        warm_s = time.time() - t0
        _log(f"worker spawn + warmup: {warm_s:.1f}s")
        warm = al.metrics  # the graphs captured in the warm-up
        cpu0 = time.process_time()
        passes, best, wall = measure(al, wl.payloads, wl.truth,
                                     reset_after_warm=True)
        parent_cpu = time.process_time() - cpu0
        launches = counters(al)
        graphs = {
            "warmup_captures": warm.get("fe_graph_captures", 0),
            "captures": launches["fe_graph_captures"],
            "replays": launches["fe_graph_replays"],
            "fe_batches": launches["fe_batches"],
            "pool_mb": (warm.get("fe_graph_pool_mb", 0.0)
                        + launches["fe_graph_pool_mb"])}
        probe = al.probe_front_end(N_PROBE)
        roof = al.front_end_roofline()
        metrics = al.metrics
    finally:
        al.enable_threading(0)
    return {"topology": topo, "procs": n_procs, "proxies": n_proxies,
            "proc_chunk": al._config.proc_chunk, "index_s": index_s,
            "spawn_warmup_s": warm_s, "passes": passes, "best": best,
            "wall": wall, "parent_cpu_s": parent_cpu, "launches": launches,
            "fe_graphs": graphs, "probe": probe, "roofline": roof,
            "metrics": metrics}


def run(genome_mb: int = GENOME_MB, n_reads: int = N_READS,
        n_pass: int = N_PASS, n_reads_cpu: int = N_READS_CPU,
        device: str = "cuda", baseline_file: Optional[str] = None,
        baseline_only: bool = False) -> dict:
    """The whole bench; its record ("line" is the printed JSON line)."""
    from ..index.index import resolve_device

    t_start = time.time()
    dev = resolve_device(device)  # fail before any work
    wl = workload(genome_mb, n_reads, n_pass, n_reads_cpu)
    _log(f"setup (genome + {len(wl.reads)} simulated reads): "
         f"{time.time() - t_start:.1f}s")
    baseline = baseline_for(wl, baseline_file, force=baseline_only)
    rec = {"genome_mb": genome_mb, "n_reads": n_reads, "n_pass": n_pass,
           "device": str(dev), "baseline": baseline,
           "card": card_line() if dev.type == "cuda" else None}
    if baseline_only:
        rec["seconds"] = time.time() - t_start
        return rec
    card = run_card(wl, str(dev))
    cpu_rps = float(baseline["value"])
    med = median([p[0] for p in card["passes"]])
    rec["line"] = {
        "metric": "reads/sec/chip",
        "value": round(med, 2),
        "unit": "reads/s",
        "vs_baseline": round(med / cpu_rps, 3),
        "passes": [round(p[0], 1) for p in card["passes"]],
        "median": round(med, 1),
        "best": round(card["best"][0], 1),
        "baseline": {"value": cpu_rps, "date": baseline.get("date", "?"),
                     "desc": baseline.get("desc", ""),
                     "n_cores": baseline.get("n_cores")},
        "card": rec["card"],
    }
    rec["run"] = card
    rec["fe_graphs"] = card["fe_graphs"]
    rec["passes"] = [{"reads_per_s": r, "seconds": dt, "hit": hit,
                      "placed": ok, "reads": n_reads}
                     for r, dt, hit, ok in card["passes"]]
    rec["seconds"] = time.time() - t_start
    return rec


def report(rec: dict) -> None:
    """bench.py's JSON line on stdout and its '#' lines on stderr."""
    print(json.dumps(rec["line"]), flush=True)
    card = rec["run"]
    baseline = rec["baseline"]
    rps, dt, n_hit, n_correct = card["best"]
    n_reads = rec["n_reads"]
    med = rec["line"]["median"]
    wall = card["wall"]
    m = card["metrics"]
    probe, roof = card["probe"], card["roofline"]
    n_procs = int(m.get("worker_procs", 0)) or 1
    fe = m.get("time_front_end_s", 0.0)
    ext = m.get("time_extend_s", 0.0) + m.get("time_extend_small_s", 0.0)
    fin = m.get("time_finalize_s", 0.0)
    duty_line = ""
    if not rec["device"].startswith("cuda"):
        duty_line = (f"# device: {rec['device']} (the plain versions): no "
                     f"device time, duty or roofline share measured\n")
    elif probe:
        ms_thr, ms_lat = 1000 * probe[0], 1000 * probe[-1]
        batches = m.get("fe_batches", 0.0)
        duty = (batches * ms_thr / 1000.0) / max(wall, 1e-9)
        chain_cps = m.get("chain_cells", 0.0) / max(
            batches * ms_thr / 1000.0, 1e-9)
        duty_line = (
            f"# device: {ms_thr:.1f}ms/batch pipelined "
            f"({ms_lat:.1f}ms blocking RTT), {batches:.0f} batches "
            f"dispatched -> duty~{100 * duty:.0f}% of the {wall:.2f}s "
            f"measured wall; chain-DP ~{chain_cps:.2e} cells/s "
            f"on-device\n")
        if roof:
            t_b = ms_thr / 1e3
            ops = roof["int_ops"] / t_b / INT32_OPS_PER_S
            bw = roof["hbm_bytes"] / t_b / HBM_BYTES_PER_S
            duty_line += (
                f"# roofline/batch (B={roof['B']} L={roof['L']} "
                f"M={roof['M']} A={roof['A']} W={roof['window']}): "
                f"{roof['int_ops']:.2e} int-ops, "
                f"{roof['hbm_bytes'] / 1e6:.0f}MB -> "
                f"{100 * ops:.3f}% of the H100's int32 rate "
                f"({INT32_OPS_PER_S / 1e12:.1f} Top/s), "
                f"{100 * bw:.3f}% of {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
                f"(~{roof['int_ops'] / t_b:.2e} int-ops/s, "
                f"{roof['hbm_bytes'] / t_b / 1e9:.1f}GB/s achieved)\n")
    n_cores = baseline.get("n_cores")
    print(
        f"# baseline: {baseline.get('desc', '')} = "
        f"{baseline['value']:.1f} reads/s ({baseline.get('date', '?')})\n"
        f"# vs_baseline uses the CPU aligner measured on this host "
        f"({n_cores} cores)\n"
        f"# accuracy: {n_correct}/{n_reads} within 100bp of truth; "
        f"mapped {n_hit}/{n_reads} reads in {dt:.2f}s "
        f"({READ_LEN}bp, {ERROR_RATE:.0%} err, {rec['genome_mb']}Mbp ref)\n"
        f"# passes: {rec['line']['passes']} (median {med:.1f}, best "
        f"{rps:.1f}); total wall {rec['seconds']:.1f}s\n"
        f"{duty_line}"
        f"# steady-state stage cpu-seconds over {n_procs} procs "
        f"(per-proc ~= /{n_procs}; measured wall {wall:.2f}s for "
        f"{len(card['passes']) * n_reads} reads): front_end={fe:.2f} "
        f"extend={ext:.2f} finalize={fin:.2f}; host dp_cells/s="
        f"{m.get('dp_cells_per_sec', 0):.3e}\n"
        f"# front-end CUDA graphs: {json.dumps(rec['fe_graphs'])}\n"
        f"# parent-process CPU during measurement: "
        f"{card['parent_cpu_s']:.2f}s over {wall:.2f}s wall = "
        f"{card['parent_cpu_s'] / max(wall, 1e-9):.2f} cores (of "
        f"{len(os.sched_getaffinity(0))}) spent on IPC deserialize + "
        f"queues + iterator",
        file=sys.stderr, flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mappy_rs_tpu_torch.tools.bench",
        description="Reads/sec per card against a CPU baseline measured "
                    "on this host.")
    ap.add_argument("--genome-mb", type=int,
                    default=int(os.environ.get("BENCH_GENOME_MB", GENOME_MB)))
    ap.add_argument("--baseline", action="store_true",
                    help="measure the CPU baseline alone")
    ap.add_argument("--baseline-file", default=None,
                    help="read the baseline here when it matches; else "
                         "measure and write it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reads", type=int, default=N_READS,
                    help="reads per card pass")
    ap.add_argument("--passes", type=int, default=N_PASS)
    ap.add_argument("--cpu-reads", type=int, default=N_READS_CPU,
                    help="reads per baseline pass")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bench.json"))
    a = ap.parse_args(argv)
    rec = run(a.genome_mb, a.reads, a.passes, a.cpu_reads, a.device,
              a.baseline_file, a.baseline)
    if a.baseline:
        print(json.dumps(rec["baseline"]), flush=True)
    else:
        report(rec)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
