"""One run of one cell: set up, measure, check, report.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--sweep R1,R2,...] [--control]

The cell is an entry of the root BENCHMARK.json: its ``config`` names a
configuration file (``configs[].file``), its ``traffic`` a mix,
``portbench/traffic/<traffic>.json``; each per-layer metric is read by
``portbench/metrics/<name>.py``, or by the file of the name's part
before its first dot (``k1_roofline.p95`` -> ``k1_roofline.py``).
A run prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace
1), ``device`` and, traced, ``breakdown``; last of all ``checks``, each
number the correctness check compared beside its limit, which also end
standard error.

``--sweep`` prints no such line: it offers an open-loop cell's traffic
at each rate in turn after one set-up (the knee sweep), one JSON line
per rate.  ``--control`` runs the cell and puts the reference's control
(portbench/reference/) in the program's place on the check's sample:
its result line's ``checks`` are the control's, and
``program_checks`` the program's own on the same sample.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import hostload, loops, seeds
from .genome import make_genome
from .reads import edge_reads, make_reads

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the traced end of a --trace 1 run's window (seconds)
TRACE_S = 5.0
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "mappy_rs_tpu")


# ------------------------------------------------------------------ spec
@dataclasses.dataclass
class Spec:
    cell: dict
    cfg: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(workload: str, root: str = ROOT, here: str = HERE) -> Spec:
    """The cell's entries and files, by the names BENCHMARK.json gives
    (`root` holds BENCHMARK.json and the config files it names, `here`
    the traffic/ directory)."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(here, "traffic", cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Spec(cell, cfg, mix, e2e, layer)


def reader(name: str, here: str = HERE):
    """The per-layer metric's reader module: metrics/<name>.py, else
    metrics/<name up to its first dot>.py."""
    for base in (name, name.split(".", 1)[0]):
        path = os.path.join(here, "metrics", base + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + base.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for per-layer metric {name!r}")


# ------------------------------------------------------------- the system
@dataclasses.dataclass
class System:
    al: object
    build_seconds: Dict[str, float]


def setup_system(cfg: dict, genome, device: str) -> System:
    """The port on the genome: its index built on `device` with the
    preset's options, the Aligner, its device tables and worker
    threads, with the configuration's extension backend."""
    from mappy_rs_tpu_torch.api import Aligner
    from mappy_rs_tpu_torch.config import set_opt
    from mappy_rs_tpu_torch.index.build import build_index

    idx_opt, _ = set_opt(cfg["preset"])
    index = build_index(genome.contigs(), idx_opt, device=device)
    al = Aligner._from_index(index, cfg["preset"], device)
    al._config.extension_backend = cfg["extension_backend"]
    al._engine.dev  # the device tables: upload and build
    al.enable_threading(int(cfg["threads"]))
    return System(al, dict(index.build_seconds))


def warm_shapes(al, reads: List[str]) -> None:
    """Capture, before the window, every front-end graph key the
    traffic can meet (`reads` holds the warm-up's reads and one of each
    of the mix's edge lengths): each length bucket of `reads` at the anchor
    budgets x 1, x 4 and x 16 (the engine's retries), in the small
    (<= 8 reads) and the full batch shape, through the engine's own
    bucket path (models/pipeline.py ``_map_bucket``)."""
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    eng = al._engine
    codes = [encode(s) for s in reads]
    by_L: Dict[int, List[int]] = {}
    for i, c in enumerate(codes):
        by_L.setdefault(eng._bucket_len(len(c)), []).append(i)
    for L, idxs in sorted(by_L.items()):
        for sel in (idxs[:1], (idxs * 9)[:max(9, len(idxs))]):
            for boost in (1, 4, 16):
                out: List[list] = [[] for _ in codes]
                eng._map_bucket(L, sel, codes, out, True, False,
                                a_boost=boost)


# --------------------------------------------------------------- traffic
def batch_sizes(mix: dict, n: int, rng) -> List[int]:
    """n batch sizes spread evenly over [lo, hi], in a seeded order."""
    lo, hi = mix["batch_reads"]
    return [int(x) for x in rng.permutation(
        np.rint(np.linspace(lo, hi, n)).astype(int))]


def interval_s(mix: dict, rate: Optional[float] = None) -> float:
    lo, hi = mix["batch_reads"]
    return (lo + hi) / 2 / float(rate or mix["reads_per_s"])


def open_batches(mix: dict, genome, n_batches: int, stream: int, seed: int,
                 truth_out: Optional[list] = None):
    """The open loop's batches; each read's truth is appended to
    `truth_out` when one is given."""
    rng = seeds.rng(seed, stream)
    sizes = batch_sizes(mix, n_batches, rng)
    reads, truth = make_reads(mix, sum(sizes), genome, rng)
    if truth_out is not None:
        truth_out.extend(truth)
    out, at = [], 0
    for s in sizes:
        out.append(reads[at:at + s])
        at += s
    return out


# ---------------------------------------------------------------- checks
def sample_ids(candidates: List[int], n: int, seed: int) -> List[int]:
    """n of the candidates, drawn from the seed (all when fewer)."""
    c = sorted(candidates)
    if len(c) <= n:
        return c
    pick = seeds.rng(seed, seeds.SAMPLE).choice(len(c), n, replace=False)
    return sorted(c[i] for i in pick)


def program_record(m) -> tuple:
    """A Mapping of the port as the reference's record tuple."""
    return (m.query_start, m.query_end, "+" if m.strand == 1 else "-",
            m.target_name, m.target_len, m.target_start, m.target_end,
            m.match_len, m.block_len, m.mapq, m.is_primary,
            [tuple(map(int, c)) for c in m.cigar], m.NM, m.cs)


# ------------------------------------------------------------------- run
def card_line() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass
class Measured:
    """What a run measured, for the metric readers."""

    cell: str
    cfg: dict
    mix: dict
    loop: loops.LoopResult
    setup_s: float
    counters: Dict[str, float]
    build_seconds: Dict[str, float]
    profile: Optional[dict] = None
    kernel_work: Optional[Dict[str, float]] = None  # over the traced reads
    sm_count: int = 0
    memory_peak_bytes: int = 0  # the card's allocator peak (0: no card)


def end_to_end(m: Measured) -> Dict[str, float]:
    """Every end-to-end quantity the cell's loop gives (the card's
    memory peak only where there is a card)."""
    out = {"setup_s": m.setup_s}
    if m.memory_peak_bytes:
        out["device_memory_peak_mib"] = m.memory_peak_bytes / 2**20
    lp = m.loop
    if lp.latency_s is not None:
        lat = sorted(lp.latency_s.values())
        if lat:
            out["read_p95_ms"] = 1e3 * float(np.percentile(lat, 95))
    if lp.in_window is not None:
        out["reads_per_s"] = len(lp.in_window) / lp.window_s
    return out


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, mode: str = "run",
             rates: Optional[List[float]] = None) -> Optional[dict]:
    """One run on `device`; the result line's object (None in the
    sweep mode, which prints its own lines)."""
    import torch

    cfg, mix = spec.cfg, spec.mix
    cuda = torch.device(device).type == "cuda"
    n_bp = int(cfg["contigs"]) * int(cfg["contig_len"])
    if cuda:
        from .preflight import preflight

        preflight(n_bp, int(cfg["w"]), int(cfg["k"]), device)
    t = time.perf_counter()
    genome = make_genome(cfg, seed, device)
    log(f"genome {n_bp / 1e6:.3f} Mbp in {len(genome.names)} contigs, "
        f"{genome.repeat_bp / n_bp:.1%} repeat copies, "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    sysm = setup_system(cfg, genome, device)
    al = sysm.al
    log(f"port set up in {time.perf_counter() - t:.1f} s: "
        f"{json.dumps(sysm.build_seconds)}, mid_occ "
        f"{al._map_opt.mid_occ}")
    open_loop = mix["loop"] == "open"
    t = time.perf_counter()
    truths: list = []
    if open_loop:
        warm = open_batches(mix, genome, int(mix["warmup_batches"]),
                            seeds.WARMUP, seed)
        timed = (None if mode == "sweep" else open_batches(
            mix, genome, int(math.ceil(seconds / interval_s(mix))),
            seeds.READS, seed, truths))
    else:
        warm, _ = make_reads(mix, int(mix["warmup_reads"]), genome,
                             seeds.rng(seed, seeds.WARMUP))
        timed, truths = make_reads(mix, int(mix["pool_reads"]), genome,
                                   seeds.rng(seed, seeds.READS))
    log(f"traffic made in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    edges = edge_reads(mix, genome, seeds.rng(seed, seeds.EDGES))
    warm_shapes(al, ([s for b in warm for s in b] if open_loop else warm)
                + edges)
    if open_loop:
        loops.open_loop(al, warm, interval_s(mix),
                        len(warm) * interval_s(mix))
    else:
        for _ms, _d in al.map_batch([{"i": i, "seq": s}
                                     for i, s in enumerate(warm)]):
            pass
    log(f"warm-up in {time.perf_counter() - t:.1f} s, "
        f"{al.metrics.get('fe_graph_captures', 0):.0f} graphs captured")
    if mode == "sweep":
        return sweep(al, mix, genome, seed, seconds, rates)
    al.reset_metrics()
    captures0 = al.metrics.get("fe_graph_captures", 0)
    prof = None
    if trace and cuda:
        from .trace import Profile

        # the window's last TRACE_S and its drain; the reads the engine
        # took in meanwhile are counted for the kernels' needed work
        prof = Profile(al, max(0.0, seconds - TRACE_S))
        prof.arm()
    # the harness's own objects (reads, payloads, results: about a
    # million) stay out of the collector's passes inside the window
    gc.collect()
    gc.freeze()
    gc.disable()
    host0 = hostload.snapshot()
    try:
        if prof is not None:
            prof.start_timer()
        if open_loop:
            lp = loops.open_loop(al, timed, interval_s(mix), seconds)
        else:
            lp = loops.closed_loop(al, timed, seconds,
                                   int(mix["call_reads"]))
    finally:
        gc.enable()
        gc.unfreeze()
    host = hostload.delta(host0, hostload.snapshot())
    setup_s = lp.t0 - t_start
    loops.stop_pool(al)
    if prof is not None:
        prof.stop()
    counters = dict(al.metrics)
    captures = counters.get("fe_graph_captures", 0) - captures0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    log(f"window: {len(lp.returned)} of {lp.attempted} reads returned, "
        f"{len(lp.lost)} lost, {captures:.0f} graph captures in the window, "
        f"drain ended {lp.t_end - seconds:.2f} s after the window")
    log_window(lp, host, counters)
    m = Measured(spec.cell["name"], cfg, mix, lp, setup_s, counters,
                 sysm.build_seconds, memory_peak_bytes=int(peak))
    # the program's state is freed before the reference runs
    del al, sysm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    flat = [s for b in timed for s in b] if open_loop else timed
    return finish(spec, m, genome, flat, truths, seed, trace, device, cuda,
                  peak, prof, mode)


def log_window(lp: loops.LoopResult, host: dict, counters: dict) -> None:
    """The window's reads per 5 s, what the host gave it
    (hostload.delta) and the engine's thread-ms per read, to standard
    error: what tells a slow run's cause."""
    n_bins = max(1, int(math.ceil(lp.window_s / 5.0)))
    bins = [0] * n_bins
    for t, _ms in lp.returned.values():
        if t <= lp.window_s:
            bins[min(n_bins - 1, int(t // 5.0))] += 1
    log(f"reads done per 5 s of the window: {bins}")
    log(f"host over the window: {json.dumps(host)}")
    n = max(1.0, float(counters.get("reads", 0)))
    log("engine thread-ms per read: " + json.dumps({
        k: round(1e3 * float(counters[k]) / n, 4)
        for k in ("time_front_end_s", "time_extend_s", "time_finalize_s")
        if k in counters}) + f" over {n:.0f} reads")


def judged(ref, reads, truths, records, lim: dict, missing: float,
           lost: float) -> Dict[str, list]:
    """The numbers compared, each [value, limit], for these records of
    the sample."""
    t = time.perf_counter()
    j = ref.judge(reads, truths, records)
    log(f"judged {j['judged']} reads in {time.perf_counter() - t:.1f} s; "
        f"first inconsistent (sample index, why): {j['first_inconsistent']}; "
        f"widest gap (index, %, record score, best): {j['widest_gap']}")
    return {
        # a window that completed fewer reads than the sample holds is
        # no sound run
        "sample_missing": [missing, 0.0],
        "reads_lost": [lost, float(lim["reads_lost"])],
        "records_inconsistent": [j["records_inconsistent"],
                                 float(lim["records_inconsistent"])],
        "score_gap_pct": [j["score_gap_pct"], float(lim["score_gap_pct"])],
    }


def traced_reads(lp: loops.LoopResult, prof, n_pool: int) -> Dict[int, int]:
    """{read index in the traffic: times taken} over the reads that came
    back while the profiler recorded."""
    lo, hi = prof.t_on - lp.t0, prof.t_off - lp.t0
    out: Dict[int, int] = {}
    for i, (t, _ms) in lp.returned.items():
        if lo <= t <= hi:
            out[i % n_pool] = out.get(i % n_pool, 0) + 1
    return out


def finish(spec, m: Measured, genome, reads, truths, seed, trace, device,
           cuda, peak, prof, mode):
    """The check against the reference, and the result line's object."""
    import torch

    from .reference import Reference

    lp = m.loop
    cands = (lp.in_window if lp.in_window is not None
             else list(lp.returned))
    ids = sample_ids(cands, int(m.mix["sample"]), seed)
    s_reads = [reads[i % len(reads)] for i in ids]
    s_truth = [truths[i % len(reads)] for i in ids]
    ref = Reference(genome, m.cfg, device=device if cuda else "cpu")
    got = [[program_record(x) for x in lp.returned[i][1]] for i in ids]
    lim = m.mix["limits"]
    missing = float(int(m.mix["sample"]) - len(ids))
    checks = judged(ref, s_reads, s_truth, got, lim, missing,
                    float(len(lp.lost)))
    program_checks = None
    if mode == "control":
        t = time.perf_counter()
        ctl = ref.control_records(s_reads, s_truth)
        log(f"control's records in {time.perf_counter() - t:.1f} s")
        program_checks = checks
        checks = judged(ref, s_reads, s_truth, ctl, lim, missing,
                        float(len(lp.lost)))
    correct = all(v <= lim for v, lim in checks.values())
    e2e = end_to_end(m)
    res = {"correct": correct, "attempted": lp.attempted,
           "failed": len(lp.lost)}
    dev_out = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        if prof is not None:
            m.profile = prof.summary()
            dev_out["busy_s"] = m.profile["busy_s"]
            dev_out["window_s"] = m.profile["window_s"]
            m.sm_count = torch.cuda.get_device_properties(
                0).multi_processor_count
            t = time.perf_counter()
            took = traced_reads(lp, prof, len(reads))
            m.kernel_work = ref.kernel_work([reads[i] for i in took],
                                            list(took.values()))
            log(f"kernels' needed work over {sum(took.values())} traced "
                f"reads ({m.kernel_work['anchors']:.0f} anchors) in "
                f"{time.perf_counter() - t:.1f} s")
        metrics = {}
        for entry in spec.per_layer:
            val = reader(entry["name"]).read(m)
            if val is not None:
                metrics[entry["name"]] = {"value": float(val),
                                          "unit": entry["unit"]}
        res["metrics"] = metrics
    else:
        res["metrics"] = {e["name"]: {"value": float(e2e[e["name"]]),
                                      "unit": e["unit"]}
                          for e in spec.end_to_end if e["name"] in e2e}
    res["device"] = dev_out
    if trace and m.profile is not None:
        res["breakdown"] = {"device_ops": m.profile["device_ops"],
                            "idle_gaps": m.profile["idle_gaps"]}
    if lp.lateness_s:
        late = sorted(lp.lateness_s)
        res["generator"] = {"batches": len(late),
                            "late_p95_ms": 1e3 * late[int(0.95 * (len(late)
                                                                   - 1))],
                            "late_max_ms": 1e3 * late[-1]}
    if lp.latency_s:
        third = len(lp.latency_s) // 3
        lat = [lp.latency_s[i] for i in sorted(lp.latency_s)]
        res["read_p95_ms_by_third"] = [
            1e3 * float(np.percentile(lat[k * third:(k + 1) * third], 95))
            for k in range(3)]
    if program_checks is not None:
        res["program_checks"] = {n: {"value": v, "limit": lim}
                                 for n, (v, lim) in program_checks.items()}
    res["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return res


def sweep(al, mix, genome, seed, seconds, rates) -> None:
    """The knee sweep: the open loop at each rate in turn, fresh reads
    each; per rate the p50 / p95 / max latency, the completed rate and
    the backlog's growth (the median latency of the last quarter of the
    batches less the first quarter's)."""
    for k, rate in enumerate(rates):
        iv = interval_s(mix, rate)
        n_b = int(math.ceil(seconds / iv))
        batches = open_batches(mix, genome, n_b, 100 + k, seed)
        lp = loops.open_loop(al, batches, iv, seconds)
        lat = np.array([lp.latency_s[i] for i in sorted(lp.latency_s)])
        q = max(1, len(lat) // 4)
        row = {"offered_reads_per_s": rate,
               "completed_reads_per_s": len(lp.returned) / max(lp.t_end, 1e-9),
               "reads": lp.attempted, "lost": len(lp.lost),
               "p50_ms": 1e3 * float(np.median(lat)),
               "p95_ms": 1e3 * float(np.percentile(lat, 95)),
               "max_ms": 1e3 * float(lat.max()),
               "growth_ms": 1e3 * float(np.median(lat[-q:])
                                        - np.median(lat[:q])),
               "late_p95_ms": 1e3 * float(np.percentile(lp.lateness_s, 95))}
        print(json.dumps(row), flush=True)
        if row["lost"] or row["growth_ms"] > 2000:
            break  # past the knee: higher rates only queue longer
    loops.stop_pool(al)
    return None


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--sweep", default=None,
                    help="comma-separated offered reads/s (open loop)")
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    spec = load_spec(a.workload)
    import torch

    need = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    import mappy_rs_tpu_torch  # noqa: F401  (the system under test)

    log(f"card: {card_line()}")
    mode = "sweep" if a.sweep else ("control" if a.control else "run")
    rates = [float(r) for r in a.sweep.split(",")] if a.sweep else None
    res = run_cell(spec, a.seed, a.seconds, bool(a.trace), "cuda", t_start,
                   mode, rates)
    if res is None:
        return 0
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0
