"""The port's genome-scale run: map 1 kb reads against a human-genome-scale
map-ont index held once on one card.

    python -m mappy_rs_tpu_torch.tools.gbp_chip [--gbp=3.1] [--contig-bits=27]
        [--procs=3] [--reads=8000] [--device=cuda|cpu] [--cache=DIR]
        [--out=PATH] [--warm=256] [--passes=3] [--probe=10]

Genome model (``GenomeModel``): hg38 is about half repeat-derived, and a
uniformly random genome of its size would make almost every minimizer
key distinct.  So the genome is int(gbp * 1e9) // 2^contig_bits contigs
of 2^contig_bits random bases (23 contigs of 2^27 bp at 3.1 Gbp), then
REPEAT_SHARE (52%) of it overwritten, without overlaps, by copies of a
40-element repeat library (SINE: 30 elements of 300 bp, LINE: 10
elements of 6 kb), each copy with DIVERGENCE (0.5%) substitutions.
``build_genome`` draws the same bytes as the JAX package's
tools/gbp_chip.py for the same seed and sizes.

The run: build the genome from SEED, ``build_index`` of its contigs
with PRESET's (map-ont) options (the sort on ``--device``), the device
tables, an Aligner around the prebuilt index,
the "device_owner" topology with ``--procs`` CUDA-free post-chain
children (proc_chunk 1024) and 2 * procs proxies, a warm-up on
``--warm`` (256) spare reads, then ``--passes`` (3) passes of
``--reads`` simulated 1 kb reads at 5% error through ``map_batch`` and
``probe_front_end(--probe)`` (10; 0 leaves it out).  Reads come
from their own generator, seeded apart from the genome's, so a cached
and a fresh run draw the same reads.  Placement is judged on
unique-origin reads (overlapping no repeat copy): repeat-origin reads
map to several copies by construction.

``--cache=DIR`` keeps the genome and the host index under DIR in a
directory whose name carries a hash of everything that decides its
content (genome model, seed, the preset's k / w / flags, TOOL_VERSION);
its ``done`` marker holds the build's timings, which a cache hit
reports.  The hash does not cover the code: a cache is valid only for
the checkout that wrote it, so give each checkout its own DIR.  The
record is printed as JSON and written to ``--out``
(default chiprun_out/gbp_chip.json).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

#: changes whenever the genome model or the index layout the cache holds
#: changes: a cache of another version is never read
TOOL_VERSION = "gbp_chip-torch-1"
SEED = 5             # the genome's generator; the reads' is reads_rng()
PRESET = "map-ont"
SINE = (30, 300)     # repeat library: (count, length) of short elements
LINE = (10, 6000)    # and of long ones
DIVERGENCE = 0.005   # substitution rate of each pasted copy
REPEAT_SHARE = 0.52  # share of the genome covered by copies
READ_LEN = 1000
ERR = 0.05
_COMP = np.array([3, 2, 1, 0], np.uint8)
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass(frozen=True)
class GenomeModel:
    """The hg38-like genome's size: n_contig contigs of 2^contig_bits
    bases (its repeat library is the module's constants)."""

    n_contig: int = 23
    contig_bits: int = 27

    @classmethod
    def for_gbp(cls, gbp: float, contig_bits: int = 27) -> "GenomeModel":
        return cls(n_contig=max(1, int(gbp * 1e9) // (1 << contig_bits)),
                   contig_bits=contig_bits)

    @property
    def contig(self) -> int:
        return 1 << self.contig_bits

    @property
    def n_bp(self) -> int:
        return self.contig * self.n_contig


def build_genome(rng, model: GenomeModel):
    """The genome as one uint8 code buffer (contigs are disjoint views),
    and the repeat copies' starts and lengths."""
    n = model.n_bp
    buf = rng.integers(0, 1 << 32, n // 4, dtype=np.uint32).view(np.uint8)
    buf &= 3
    lib = [rng.integers(0, 4, SINE[1], dtype=np.uint8)
           for _ in range(SINE[0])]
    lib += [rng.integers(0, 4, LINE[1], dtype=np.uint8)
            for _ in range(LINE[0])]
    # non-overlapping dispersed placement (pastes that overwrite each
    # other make novel junction k-mers): draw a copy sequence, then
    # spread the random-sequence budget as gaps between copies
    target = int(REPEAT_SHARE * n)
    lens_lib = np.array([len(e) for e in lib])
    est = int(1.2 * target / lens_lib.mean())
    ids = rng.integers(0, len(lib), est)
    lens = lens_lib[ids]
    keep = np.cumsum(lens) <= target
    ids, lens = ids[keep], lens[keep]
    gap_total = n - int(lens.sum())
    g = rng.random(len(ids) + 1)
    g = np.floor(g / g.sum() * gap_total).astype(np.int64)
    starts = np.cumsum(g[:-1] + np.concatenate(([0], lens[:-1])))
    placed = 0
    for j, e in enumerate(lib):
        sel = starts[ids == j]
        if not len(sel):
            continue
        idx = sel[:, None] + np.arange(len(e))
        copies = np.broadcast_to(e, (len(sel), len(e))).copy()
        mut = rng.random((len(sel), len(e))) < DIVERGENCE
        copies[mut] = (copies[mut] + rng.integers(
            1, 4, int(mut.sum()), dtype=np.uint8)) & 3
        buf[idx.reshape(-1)] = copies.reshape(-1)
        placed += len(sel) * len(e)
    _log(f"genome {n / 1e9:.3f} Gbp in {model.n_contig} contigs, "
         f"{placed / n:.0%} repeat-covered")
    return buf, starts, lens


def sample_reads(rng, buf, n: int, rep_starts, rep_lens, model: GenomeModel,
                 read_len: int = READ_LEN, err: float = ERR):
    """n reads of about read_len bases at `err` error (60/20/20 sub / ins
    / del, half reverse-complemented) with their genome-wide origins and
    a per-read `unique` flag: True where the read's window overlaps no
    repeat copy."""
    W = read_len + 64
    n_total = model.n_bp
    starts = rng.integers(0, n_total - W, n)
    # no read straddles a contig end
    starts -= np.maximum(0, (starts % model.contig) - (model.contig - W))
    i = np.searchsorted(rep_starts, starts)
    prev_end = np.where(
        i > 0, rep_starts[np.maximum(i - 1, 0)]
        + rep_lens[np.maximum(i - 1, 0)], 0)
    next_start = np.where(
        i < len(rep_starts), rep_starts[np.minimum(i, len(rep_starts) - 1)],
        n_total)
    unique = (prev_end <= starts) & (next_start >= starts + W)
    tmpl = buf[starts[:, None] + np.arange(W)]
    r = rng.random((n, W))
    sub = r < err * 0.6
    rot = rng.integers(1, 4, (n, W), dtype=np.uint8)
    subbed = np.where(sub, (tmpl + rot) & 3, tmpl)
    ins = (r >= err * 0.6) & (r < err * 0.8)
    dele = (r >= err * 0.8) & (r < err)
    ins_code = rng.integers(0, 4, (n, W), dtype=np.uint8)
    rc = rng.random(n) < 0.5
    reads = []
    cap = read_len + 24
    for j in range(n):
        keep = ~dele[j]
        base = subbed[j][keep]
        insertions = ins_code[j][ins[j]]
        if insertions.size:
            out = np.insert(base, np.cumsum(keep)[ins[j]], insertions)
        else:
            out = base
        out = out[:cap]
        if rc[j]:
            out = _COMP[out[::-1]]
        reads.append(_BASES[out].tobytes().decode())
    return reads, starts, unique


def reads_rng():
    """The reads' generator: its own stream, apart from the genome's
    (np.random.default_rng(SEED))."""
    return np.random.default_rng([SEED, 1])


# ------------------------------------------------------------------ cache
def cache_spec(model: GenomeModel, idx_opt) -> dict:
    """Everything that decides a cache directory's content."""
    return {"version": TOOL_VERSION, "seed": SEED,
            "model": {**dataclasses.asdict(model), "sine": SINE,
                      "line": LINE, "divergence": DIVERGENCE,
                      "repeat_share": REPEAT_SHARE},
            "index": {"k": idx_opt.k, "w": idx_opt.w, "flag": idx_opt.flag,
                      "bucket_bits": idx_opt.bucket_bits}}


def cache_dir(base: str, model: GenomeModel, idx_opt) -> str:
    spec = json.dumps(cache_spec(model, idx_opt), sort_keys=True)
    h = hashlib.sha256(spec.encode()).hexdigest()[:16]
    return os.path.join(base, f"gbp_{model.n_contig}x{model.contig}_{h}")


@dataclasses.dataclass
class Build:
    buf: np.ndarray
    rep_starts: np.ndarray
    rep_lens: np.ndarray
    index: object
    seconds: Dict[str, float]  # genome, sketch, sort (of the build)
    cache: Optional[str] = None
    cache_hit: bool = False


def build(model: GenomeModel, idx_opt, device,
          cache: Optional[str] = None) -> Build:
    """The genome and its host index: from the cache directory when it
    holds them (its `done` marker), else built (the index's sort on
    `device`) and, with a cache, saved there."""
    from ..index.build import build_index
    from ..index.share import load_index_dir, save_index_dir

    d = cache_dir(cache, model, idx_opt) if cache else None
    done = os.path.join(d, "done") if d else None
    if done and os.path.exists(done):
        t0 = time.perf_counter()
        with open(done) as fh:
            seconds = json.load(fh)["seconds"]
        b = Build(np.load(os.path.join(d, "genome.npy"), mmap_mode="r"),
                  np.load(os.path.join(d, "rep_starts.npy")),
                  np.load(os.path.join(d, "rep_lens.npy")),
                  load_index_dir(d), seconds, d, True)
        _log(f"genome + index from the cache {d} in "
             f"{time.perf_counter() - t0:.1f} s")
        return b
    t0 = time.perf_counter()
    buf, rep_starts, rep_lens = build_genome(np.random.default_rng(SEED),
                                             model)
    genome_s = time.perf_counter() - t0
    C = model.contig
    contigs = [(f"ctg{i:02d}", buf[i * C: (i + 1) * C])
               for i in range(model.n_contig)]
    index = build_index(contigs, idx_opt, device=device)
    seconds = {"genome": genome_s, **index.build_seconds}
    _log(f"index: {len(index.positions)} positions, {len(index.keys)} keys; "
         f"seconds {seconds}")
    if d:
        t0 = time.perf_counter()
        save_index_dir(index, d)
        np.save(os.path.join(d, "genome.npy"), buf)
        np.save(os.path.join(d, "rep_starts.npy"), rep_starts)
        np.save(os.path.join(d, "rep_lens.npy"), rep_lens)
        with open(done, "w") as fh:
            json.dump({"seconds": seconds,
                       "spec": cache_spec(model, idx_opt)}, fh)
        _log(f"cache {d} written in {time.perf_counter() - t0:.1f} s")
    return Build(buf, rep_starts, rep_lens, index, seconds, d, False)


# -------------------------------------------------------------- resources
def host_ram() -> Dict[str, int]:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            name, val = line.split(":", 1)
            if name in ("MemTotal", "MemAvailable"):
                out[name] = int(val.split()[0]) * 1024
    return out


def needs(model: GenomeModel, idx_opt, procs: int) -> Dict[str, float]:
    """Bytes the run needs, from the array sizes: host RAM (the larger of
    the build's peak — genome, its concatenated copy, the per-contig and
    the concatenated keys and y — and the mapped state: genome, index
    arrays, a host copy of the device tables and the children), free
    space where the children's index directory goes (ref_codes, keys,
    offsets, positions), and card memory (the larger of the sort's keys,
    y, sorted keys and order, and the tables with their build scratch:
    about eight int64 arrays of the keys).  Keys are counted at
    hbm_budget's default ratio, the uniform genome's, above a
    repeat-rich genome's."""
    from .hbm_budget import estimate

    n = model.n_bp
    est = estimate(n, idx_opt.w, idx_opt.k)
    m, nk = est["positions"], est["keys"]
    index_host = n + 16 * nk + 8 * m
    return {
        "host_ram": max(2 * n + 32 * m,
                        n + index_host + est["total"] + procs * 1e9),
        "tmp_disk": index_host,
        "card": max(32 * m, est["total"] + 64 * nk),
        "index_estimate": est["total"],
    }


def preflight(model: GenomeModel, idx_opt, device, procs: int,
              cache: Optional[str] = None) -> dict:
    """Raise, naming each shortfall, unless the host RAM, the free space
    of the temporary directory (and of the cache) and the card's free
    memory cover `needs`; else the needs and what is there."""
    import torch

    need = needs(model, idx_opt, procs)
    have = {"host_ram": host_ram()["MemAvailable"],
            "tmp_disk": shutil.disk_usage(tempfile.gettempdir()).free}
    if cache:
        os.makedirs(cache, exist_ok=True)
        have["cache_disk"] = shutil.disk_usage(cache).free
        need["cache_disk"] = need["tmp_disk"] + model.n_bp
    if torch.device(device).type == "cuda":
        have["card"] = torch.cuda.mem_get_info(torch.device(device))[0]
    short = [f"{k}: need {need[k] / 1e9:.2f} GB, have {have[k] / 1e9:.2f} GB"
             for k in have if have[k] < need[k]]
    if short:
        raise RuntimeError("not enough resources for the genome-scale run: "
                           + "; ".join(short))
    return {"need": need, "have": have}


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


# ---------------------------------------------------------------- mapping
def device_index_bytes(dev) -> Dict[str, int]:
    """Bytes of each DeviceIndex tensor, and their sum ("total")."""
    out = {n: getattr(dev, n).numel() * getattr(dev, n).element_size()
           for n in ("offcnt", "pos_rp", "hash_rows", "hash_val")}
    out["total"] = sum(out.values())
    return out


def start_workers(al, procs: int, warm: List[str]) -> dict:
    """The "device_owner" topology with `procs` children behind 2 *
    procs proxies, warmed on `warm`; raises if the children do not
    start (no fallback to threads)."""
    al._config.topology = "device_owner"
    al._config.worker_processes = procs
    al._config.proc_chunk = 1024
    t0 = time.perf_counter()
    al.enable_threading(2 * procs)
    if al._procs is None:
        raise RuntimeError("the device-owner children did not start")
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    al.warmup(warm)
    return {"spawn_s": spawn_s, "warmup_s": time.perf_counter() - t0,
            "index_dir_s": al._procs.save_seconds}


def map_pass(al, reads: List[str], starts, unique, model: GenomeModel) -> dict:
    """One pass of `reads` through map_batch: reads/s and placement (the
    primary on the origin's contig, starting within 100 bp of it)."""
    t0 = time.perf_counter()
    n_hit = n_ok = n_uq = n_uq_ok = 0
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    for ms, d in al.map_batch(payload):
        i = d["i"]
        gs = int(starts[i])
        ok = bool(ms) and (
            ms[0].target_name == f"ctg{gs // model.contig:02d}"
            and abs(ms[0].target_start - gs % model.contig) < 100)
        n_hit += bool(ms)
        n_ok += ok
        n_uq += bool(unique[i])
        n_uq_ok += ok and bool(unique[i])
    wall = time.perf_counter() - t0
    res = {"reads": len(reads), "reads_per_s": len(reads) / wall,
           "wall_s": wall, "hit": n_hit, "placed": n_ok,
           "unique": n_uq, "unique_placed": n_uq_ok}
    _log(f"pass: {res['reads_per_s']:.1f} reads/s ({n_hit} hit; "
         f"unique-origin {n_uq_ok}/{n_uq} placed; overall "
         f"{n_ok}/{len(reads)})")
    return res


def counters(al) -> dict:
    """The parent's K1 / K2 launches and the front end's retry,
    host-backtrack and graph counts since the last reset (the engine
    counters summed over the children under "classic"), and the
    parent's captured front-end graphs: one row per key (B, L, M, A,
    K2 or not, pool MB, replays), so the retried shapes' captures show
    by their A."""
    from ..ops import backtrack as bt
    from ..ops import chain_kernel as ck

    eng = al._engine
    m = al.metrics
    L = eng._bucket_len(READ_LEN)
    A = {b: eng.fe_shapes(L, a_boost=b)[2] for b in (4, 16)}
    graphs = eng._fe_graphs.stats() if eng._fe_graphs is not None else []
    return {"chain_dp": ck.launches, "backtrack_chains": bt.launches,
            "fe_batches": m.get("fe_batches", 0),
            "retry_batches": {f"A={A[b]}": m.get(f"fe_retry_batches_x{b}", 0)
                              for b in (4, 16)},
            "anchor_overflow_retries": m.get("anchor_overflow_retries", 0),
            "host_bt_batches": m.get("host_bt_batches", 0),
            "fe_graph_captures": m.get("fe_graph_captures", 0),
            "fe_graph_replays": m.get("fe_graph_replays", 0),
            "fe_graph_pool_mb": m.get("fe_graph_pool_mb", 0.0),
            "fe_graphs": graphs,
            "graph_captures_by_A": {
                f"A={a}": sum(1 for g in graphs if g["A"] == a)
                for a in sorted({g["A"] for g in graphs})}}


def reset_counters(al) -> None:
    """Zero the engine metrics and the K1 / K2 launch counts."""
    from ..ops import backtrack as bt
    from ..ops import chain_kernel as ck

    al.reset_metrics()
    ck.launches = 0
    bt.launches = 0


@dataclasses.dataclass
class Run:
    """A finished run: its record, and what a caller checks further (the
    Aligner on its index, the genome, the reads with their origins)."""

    record: dict
    al: object
    build: Build
    reads: List[str]
    starts: np.ndarray
    unique: np.ndarray


def run(model: GenomeModel, procs: int = 3, n_reads: int = 8000,
        n_passes: int = 3, device="cuda", cache: Optional[str] = None,
        n_warm: int = 256, n_probe: int = 10) -> Run:
    """The genome-scale run: preflight, build, the device tables, the
    children, the warm-up, the passes and the probe."""
    import torch

    from ..api import Aligner
    from ..config import set_opt
    from ..index.index import resolve_device

    t_all = time.perf_counter()
    dev_t = resolve_device(device)
    idx_opt, _ = set_opt(PRESET)
    card = card_line() if dev_t.type == "cuda" else None
    if dev_t.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev_t)
    pre = preflight(model, idx_opt, dev_t, procs, cache)
    b = build(model, idx_opt, dev_t, cache)
    index = b.index
    al = Aligner._from_index(index, PRESET, str(dev_t))
    dev = al._engine.dev  # the device tables: one upload and the build
    tables = dict(index.build_seconds)
    nbytes = device_index_bytes(dev)
    _log(f"device index {nbytes['total'] / 1e9:.3f} GB on {dev.offcnt.device}"
         f" (upload {tables['upload']:.1f} s, tables {tables['tables']:.1f} s)")
    t0 = time.perf_counter()
    reads, starts, unique = sample_reads(
        reads_rng(), b.buf, n_passes * n_reads + n_warm, b.rep_starts,
        b.rep_lens, model)
    sample_s = time.perf_counter() - t0
    digest = hashlib.sha256("\n".join(reads).encode()).hexdigest()[:16]
    start = start_workers(al, procs, reads[n_passes * n_reads:])
    reset_counters(al)
    passes = [map_pass(al, reads[p * n_reads:(p + 1) * n_reads],
                       starts[p * n_reads:(p + 1) * n_reads],
                       unique[p * n_reads:(p + 1) * n_reads], model)
              for p in range(n_passes)]
    count = counters(al)
    probe = al.probe_front_end(n_probe) if n_probe else []
    al.enable_threading(0)
    rates = sorted(p["reads_per_s"] for p in passes)
    n, m = len(index.keys), len(index.positions)
    out = {
        "metric": "gbp_scale_reads_per_sec",
        "tool": TOOL_VERSION,
        "card": card,
        "device": str(dev_t),
        "preset": PRESET,
        "genome_bp": model.n_bp,
        "n_contigs": model.n_contig,
        "genome_model": cache_spec(model, idx_opt)["model"],
        "seed": SEED,
        "positions": m,
        "keys": n,
        "key_ratio": n / max(m, 1),
        "hash_bits": dev.hash_bits,
        "device_index_bytes": nbytes,
        "build_s": {"genome": b.seconds["genome"],
                    "contig_sketch": b.seconds["sketch"],
                    "sort_unique": b.seconds["sort"],
                    "upload": tables["upload"],
                    "device_tables": tables["tables"],
                    "children_index_dir": start["index_dir_s"]},
        "cache": b.cache,
        "cache_hit": b.cache_hit,
        "sample_reads_s": sample_s,
        "reads_digest": digest,
        "spawn_s": start["spawn_s"],
        "warmup_s": start["warmup_s"],
        "procs": procs,
        "passes": passes,
        "reads_per_s": [p["reads_per_s"] for p in passes],
        "median_reads_per_s": rates[len(rates) // 2],
        "ms_per_batch_pipelined": 1e3 * probe[0] if probe else None,
        "counters": count,
        "unique_placed": sum(p["unique_placed"] for p in passes),
        "unique": sum(p["unique"] for p in passes),
        "placed": sum(p["placed"] for p in passes),
        "reads": sum(p["reads"] for p in passes),
        "host": {**host_ram(), "cpu_count": os.cpu_count(),
                 "tmp_free": shutil.disk_usage(tempfile.gettempdir()).free},
        "preflight": pre,
        "card_peak_allocated": (torch.cuda.max_memory_allocated(dev_t)
                                if dev_t.type == "cuda" else None),
        "seconds": time.perf_counter() - t_all,
    }
    return Run(out, al, b, reads, starts, unique)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mappy_rs_tpu_torch.tools.gbp_chip",
        description="Map 1 kb reads against a human-genome-scale index.")
    ap.add_argument("--gbp", type=float, default=3.1,
                    help="genome size in Gbp (contigs of 2^contig-bits)")
    ap.add_argument("--contig-bits", type=int, default=27)
    ap.add_argument("--procs", type=int, default=3,
                    help="device_owner post-chain children")
    ap.add_argument("--reads", type=int, default=8000, help="reads per pass")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--warm", type=int, default=256, help="warm-up reads")
    ap.add_argument("--probe", type=int, default=10,
                    help="probe_front_end re-dispatches (0: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=None,
                    help="directory of cached genomes and host indexes")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "gbp_chip.json"))
    a = ap.parse_args(argv)
    rec = run(GenomeModel.for_gbp(a.gbp, a.contig_bits), procs=a.procs,
              n_reads=a.reads, n_passes=a.passes, device=a.device,
              cache=a.cache, n_warm=a.warm, n_probe=a.probe).record
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
