"""Cross-engine concordance sweep of the port: its device front end
against its CPU front end, per preset.

    python -m mappy_rs_tpu_torch.tools.concordance [N] [--device cuda|cpu]
        [--out PATH]

The two front ends share no code: the device one is torch ops (sketch,
hash-probe seed lookup, anchor sort) feeding kernels K1 (chain DP) and
K2 (chain backtrack); the CPU one is the scalar C++ of
``native/src/front_end.cc`` (rolling sketch, lower_bound lookup,
minimap2-style chain DP).  Both feed the same host extension, so
agreement on full hit tuples (contig, coordinates, strand, CIGAR, NM,
mapq, primary flag) on a realistic workload is the stand-in for a
minimap2 oracle.  N reads per preset (default 1,000); the markdown
table is printed, and written only to ``--out``.

Preset notes:
  - asm5 is swept WITHOUT MM_F_RMQ: RMQ long-gap chaining routes both
    aligners through the native front end (``AlignmentEngine._map``),
    which would make the comparison self-vs-self.
  - splice runs on genomic (exon-only) reads here.

The workload (``PRESET_WORKLOADS``, ``mixed_genome``, ``simulate``) is
this package's own copy of the JAX package's sweep, so the same seed
gives the same genome and reads.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

#: preset -> (read lengths, error rates) matched to the preset's regime
PRESET_WORKLOADS = {
    "map-ont": ([420, 800, 1500], [0.0, 0.03, 0.08]),
    "map-hifi": ([800, 1500], [0.0, 0.01]),
    "sr": ([150, 250], [0.0, 0.01]),
    "asm5": ([800, 1500], [0.0, 0.02]),
    "splice": ([420, 800], [0.0, 0.03]),
}


def mixed_genome(rng, size=150_000, repeats=8):
    """Genome with an interspersed ~3%-diverged 1.2 kb repeat family, so
    some reads are repeat-dense: the hardest mapq/chain regime."""
    base = rng.choice(list("ACGT"), size=size)
    unit = rng.choice(list("ACGT"), size=1200)
    for c in range(repeats):
        start = 12_000 + c * ((size - 24_000) // max(repeats, 1))
        copy = unit.copy()
        muts = rng.integers(0, 1200, size=36)
        copy[muts] = [rng.choice(list("ACGT")) for _ in muts]
        base[start : start + 1200] = copy
    return "".join(base)


def simulate(rng, genome, n, lengths, errs):
    """n reads of a length and an error rate drawn per read (60/20/20
    substitutions / insertions / 2-base deletions), half of them
    reverse-complemented."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = []
    for _ in range(n):
        length = int(rng.choice(lengths))
        err = float(rng.choice(errs))
        start = int(rng.integers(0, len(genome) - length))
        s = []
        j = start
        while j < start + length:
            r = rng.random()
            if r < err * 0.6:
                s.append(rng.choice([c for c in "ACGT" if c != genome[j]]))
                j += 1
            elif r < err * 0.8:
                s.append(genome[j])
                s.append(str(rng.choice(list("ACGT"))))
                j += 1
            elif r < err:
                j += 2
            else:
                s.append(genome[j])
                j += 1
        read = "".join(s)
        if rng.random() < 0.5:
            read = "".join(comp[c] for c in reversed(read))
        reads.append(read)
    return reads


def workload(preset: str, n_reads: int, seed: int = 21):
    """(genome, reads) of one preset's sweep."""
    rng = np.random.default_rng(seed)
    genome = mixed_genome(rng)
    lengths, errs = PRESET_WORKLOADS[preset]
    return genome, simulate(rng, genome, n_reads, lengths, errs)


def _tuples(regs, idx):
    return [
        (r.rid, r.rs, r.re, r.qs, r.qe, r.rev, idx.seq_names[r.rid],
         tuple(np.asarray(r.cigar).tolist())
         if r.cigar is not None else (),
         r.nm, r.mapq, r.parent == r.id)
        for r in regs
    ]


def make_aligner(genome: str, preset: str, front_end: str, device: str):
    """An Aligner of the sweep: `front_end` "device" (torch ops + K1 +
    K2) or "cpu" (the native front end), the host extension, and asm5
    without MM_F_RMQ (see the module docstring)."""
    from ..api import Aligner
    from ..config import MM_F_RMQ

    al = Aligner(seq=genome, preset=preset, device=device)
    al._engine.cfg.front_end_backend = front_end
    al._engine.cfg.extension_backend = "host"
    if preset == "asm5":
        al._engine.opt.flag &= ~MM_F_RMQ
    return al


def run_preset(preset: str, n_reads: int, seed: int = 21,
               device: str = "cuda") -> dict:
    """Map n_reads through both front ends on `device`; a stats dict."""
    genome, reads = workload(preset, n_reads, seed)
    al_dev = make_aligner(genome, preset, "device", device)
    al_cpu = make_aligner(genome, preset, "cpu", device)
    idx = al_dev._engine.index
    out_dev = al_dev._engine.map_batch(reads)
    out_cpu = al_cpu._engine.map_batch(reads)

    full = coords = both = only_one = 0
    diffs = []
    for i, (rd, rc) in enumerate(zip(out_dev, out_cpu)):
        td, tc = _tuples(rd, idx), _tuples(rc, idx)
        if not td and not tc:
            continue
        if bool(td) != bool(tc):
            only_one += 1
            diffs.append((i, td[:1], tc[:1]))
            continue
        both += 1
        if td[0][:6] == tc[0][:6]:
            coords += 1
        if td == tc:
            full += 1
        else:
            diffs.append((i, td[:1], tc[:1]))
    return {
        "preset": preset,
        "n_reads": n_reads,
        "both_mapped": both,
        "one_side_only": only_one,
        "full": full,
        "coords": coords,
        "full_pct": 100.0 * full / max(both, 1),
        "coords_pct": 100.0 * coords / max(both, 1),
        "diffs": diffs[:5],
    }


def table(stats, device: str) -> str:
    """The sweep's markdown table."""
    n = max(s["n_reads"] for s in stats)
    rows = [
        "# Concordance of the port: device vs CPU front end, full hit "
        "tuples\n\n"
        f"Device front end (torch ops + K1 + K2) on {device} vs the native"
        " C++ front end;\na hit tuple is (ctg, r_st, r_en, q_st, q_en, "
        "strand, CIGAR, NM, mapq, primary).\nWorkload: 150 kb genome with"
        " an 8-copy ~3%-diverged 1.2 kb repeat family;\nread lengths and "
        "error rates per preset as in "
        "mappy_rs_tpu_torch/tools/concordance.py.\nRegenerate: `python -m "
        f"mappy_rs_tpu_torch.tools.concordance {n} --device {device}`.\n\n"
        "| preset | N | both mapped | one side only | coords eq | "
        "full tuple eq |\n|---|---|---|---|---|---|"
    ]
    for s in stats:
        rows.append(
            f"| {s['preset']} | {s['n_reads']} | {s['both_mapped']} | "
            f"{s['one_side_only']} | {s['coords']} "
            f"({s['coords_pct']:.1f}%) | {s['full']} "
            f"({s['full_pct']:.1f}%) |")
    return "\n".join(rows) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1000,
                    help="reads per preset")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the markdown table here")
    args = ap.parse_args(argv)
    stats = []
    for preset in PRESET_WORKLOADS:
        s = run_preset(preset, args.n, device=args.device)
        stats.append(s)
        print(f"{preset}: full {s['full']}/{s['both_mapped']} "
              f"({s['full_pct']:.2f}%), coords {s['coords_pct']:.2f}%, "
              f"one-side {s['one_side_only']}", flush=True)
    md = table(stats, args.device)
    print(md, end="")
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(md)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
