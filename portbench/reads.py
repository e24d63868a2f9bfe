"""The general read generator: every traffic mix is parameters for it.

Read lengths are drawn as the same multiset for every seed, in another
order (``read_lengths``), so that two seeds give the same work: a
``chunk`` mix takes readfish's chunks, ``chunk_bases`` x c bases with c
running over [lo, hi] in equal shares; a ``lognormal`` mix takes the
quantiles of a log-normal (``median``, ``sigma``) clipped to [min,
max] (or, with ``truncate``, cut to it and renormalized), stratified so that every block of ``strata`` consecutive reads
holds one read from each stratum, at points within the strata drawn
once for all seeds (``LENGTH_DRAW``).  ``random_share`` of the reads are
random sequence that maps nowhere.

``simulate`` is mappy_rs_tpu_torch/tools/gbp_chip.py's ``sample_reads``
(commit 112cabc5c64b), vectorized over groups of reads and with a
length per read: a template window from a uniform start (no read
straddles a contig end), 60/20/20 substitutions, insertions and
deletions at ``error``, half the reads reverse complemented; the truth
(contig, start, strand) travels beside it, as
mappy_rs_tpu_torch/utils/simulate.py ``simulate_with_truth`` keeps it.
Added: the truth also holds the least and the largest drift of the
read's path off its start diagonal (template offset less read offset,
in the template's orientation), which bounds the band the reference
searches.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .genome import Genome

_COMP = np.array([3, 2, 1, 0], np.uint8)
_BASES = np.frombuffer(b"ACGT", np.uint8)
#: the fixed draw of a lognormal mix's points within its strata: the
#: same lengths for every seed, which orders them
LENGTH_DRAW = 0x1E4A7


def _lognormal_cdf(x: float, median: float, sigma: float) -> float:
    return 0.5 * (1.0 + math.erf((math.log(x) - math.log(median))
                                 / (sigma * math.sqrt(2))))


def _lognormal_quantile(u: np.ndarray, median: float, sigma: float):
    """exp(ln(median) + sigma * Phi^-1(u)), Phi^-1 by bisection on erf
    (numpy has no inverse normal CDF)."""
    lo = np.full(u.shape, -10.0)
    hi = np.full(u.shape, 10.0)
    for _ in range(60):
        mid = (lo + hi) / 2
        below = 0.5 * (1.0 + np.vectorize(math.erf)(mid / math.sqrt(2))) < u
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return np.exp(math.log(median) + sigma * (lo + hi) / 2)


def read_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n read lengths of the mix `spec` (its "read" entry), int64."""
    kind = spec["kind"]
    if kind == "chunk":
        lo, hi = spec["chunks"]
        c = np.arange(n) % (hi - lo + 1) + lo
        return rng.permutation(c * int(spec["chunk_bases"])).astype(np.int64)
    if kind == "lognormal":
        S = int(spec["strata"])
        blocks = -(-n // S)
        jitter = np.random.default_rng(LENGTH_DRAW).random((blocks, S))
        u = (np.arange(S)[None, :] + jitter) / S
        med, sigma = float(spec["median"]), float(spec["sigma"])
        if spec.get("truncate"):
            # the strata span the distribution cut to [min, max]
            lo, hi = (_lognormal_cdf(float(spec[k]), med, sigma)
                      for k in ("min", "max"))
            u = lo + u * (hi - lo)
        lens = _lognormal_quantile(u, med, sigma)
        lens = np.clip(np.rint(lens), spec["min"], spec["max"])
        lens = np.stack([rng.permutation(row) for row in lens])
        return lens.reshape(-1)[:n].astype(np.int64)
    raise ValueError(f"unknown read kind {kind!r}")


def simulate(rng: np.random.Generator, genome: Genome, lens: np.ndarray,
             err: float, random_share: float, group: int = 1024):
    """Reads of the given lengths: (reads, truth), truth[i] = (contig,
    start, rev, least drift, largest drift) or None for a random read.
    Drawn `group` reads at a time as one flat template: per template
    base one uniform decides a substitution (rotated to another base),
    an insertion (a random base before it) or a deletion; each read is
    cut to its length."""
    n = len(lens)
    is_random = np.zeros(n, bool)
    is_random[rng.permutation(n)[:int(round(random_share * n))]] = True
    ctg = rng.integers(0, len(genome.names), n)
    rev = rng.random(n) < 0.5
    reads: List[str] = []
    truth: list = []
    for g0 in range(0, n, group):
        sl = slice(g0, min(g0 + group, n))
        L = lens[sl].astype(np.int64)
        W = L + 64 + L // 50  # deletions consume template
        c = ctg[sl]
        start = (rng.random(len(L)) * (genome.lens[c] - W)).astype(np.int64)
        at = genome.starts[c] + start
        tmpl = np.concatenate([genome.codes[a:a + w] for a, w in zip(at, W)])
        off = np.concatenate([[0], np.cumsum(W)])
        r = rng.random(len(tmpl), dtype=np.float32)
        sub = np.flatnonzero(r < err * 0.6)
        ins = np.flatnonzero((r >= err * 0.6) & (r < err * 0.8))
        dele = np.flatnonzero((r >= err * 0.8) & (r < err))
        tmpl[sub] = (tmpl[sub] + rng.integers(1, 4, len(sub), dtype=np.uint8)) & 3
        # a random base before each insertion position, then the deleted
        # positions out (the two sets are disjoint)
        out = np.insert(tmpl, ins, rng.integers(0, 4, len(ins), dtype=np.uint8))
        gone = dele + np.searchsorted(ins, dele, side="right")
        out = np.delete(out, gone)
        # each output base's template offset (an inserted base takes the
        # offset of the base it precedes)
        tpos = np.arange(len(tmpl), dtype=np.int64)
        tpos = np.delete(np.insert(tpos, ins, tpos[ins]), gone)
        begins = (off[:-1] + np.searchsorted(ins, off[:-1])
                  - np.searchsorted(dele, off[:-1]))
        for k in range(len(L)):
            i = g0 + k
            if is_random[i]:
                seq = rng.integers(0, 4, int(L[k]), dtype=np.uint8)
                truth.append(None)
            else:
                b0 = begins[k]
                seq = out[b0:b0 + int(L[k])]
                drift = tpos[b0:b0 + int(L[k])] - off[k] - np.arange(int(L[k]))
                if rev[i]:
                    seq = _COMP[seq[::-1]]
                truth.append((int(c[k]), int(start[k]), bool(rev[i]),
                              int(drift.min()), int(drift.max())))
            reads.append(_BASES[seq].tobytes().decode())
    return reads, truth


def edge_lengths(spec: dict) -> np.ndarray:
    """Lengths that span the mix (its "read" entry): every chunk size,
    or 16 points from min to max spaced evenly in log, both ends in, so
    that every length bucket that the mix's reads can fall in holds
    one."""
    if spec["kind"] == "chunk":
        lo, hi = spec["chunks"]
        return np.arange(lo, hi + 1, dtype=np.int64) * int(spec["chunk_bases"])
    return np.unique(np.rint(np.geomspace(spec["min"], spec["max"], 16))
                     ).astype(np.int64)


def edge_reads(mix: dict, genome: Genome, rng: np.random.Generator):
    """One read of each of the mix's edge lengths (for the warm-up)."""
    spec = mix["read"]
    return simulate(rng, genome, edge_lengths(spec), float(spec["error"]),
                    0.0)[0]


def make_reads(mix: dict, n: int, genome: Genome, rng: np.random.Generator):
    """n reads of the mix `mix` (a traffic file) from `genome`."""
    spec = mix["read"]
    lens = read_lengths(spec, n, rng)
    return simulate(rng, genome, lens, float(spec["error"]),
                    float(spec.get("random_share", 0.0)))
