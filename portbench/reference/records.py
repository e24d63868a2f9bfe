"""A record read against the sequences it names.

A record is the tuple ``run.program_record`` makes of a Mapping:
(qs, qe, strand "+"/"-", contig, contig length, ts, te, mlen, blen,
mapq, primary, CIGAR [(length, op)], NM, cs).  ``walk`` takes the
aligned query (read[qs:qe], reverse complemented on "-") and the target
(contig[ts:te]) along the CIGAR and works out, from minimap2's
definitions (minimap2.1 manual, "PAF" and "The cs optional tag";
``mm_update_extra``): mlen, the matching bases; blen, the columns of M,
I and D; NM = blen - mlen; the short cs string (":n" a run of matches,
"*xy" reference base x read as y, "+seq" inserted, "-seq" deleted, in
lower case); and the alignment's score under the preset's scoring: a
per match, -b per mismatch, a gap of l bases -min(q + l e, q2 + l e2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)
_LOWER = np.frombuffer(b"acgtnn", np.uint8)
_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _LUT[_c + 32] = _i

M, I, D = 0, 1, 2


def encode(s: str) -> np.ndarray:
    """Base codes 0..3 of A, C, G, T (either case), 4 for anything else."""
    return _LUT[np.frombuffer(s.encode(), np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes[::-1]]


@dataclasses.dataclass(frozen=True)
class Scoring:
    a: int
    b: int
    q: int
    e: int
    q2: int
    e2: int

    def gap(self, n: int) -> int:
        return min(self.q + n * self.e, self.q2 + n * self.e2)


def _lower(codes: np.ndarray) -> str:
    return _LOWER[codes].tobytes().decode()


def _cs_match(q: np.ndarray, t: np.ndarray) -> Tuple[str, int]:
    """cs of an M block and its matching bases."""
    diff = np.flatnonzero(q != t)
    parts, at = [], 0
    for x in diff.tolist():
        if x > at:
            parts.append(f":{x - at}")
        parts.append("*" + _lower(t[x:x + 1]) + _lower(q[x:x + 1]))
        at = x + 1
    if len(q) > at:
        parts.append(f":{len(q) - at}")
    return "".join(parts), len(q) - len(diff)


@dataclasses.dataclass
class Walk:
    why: Optional[str]  # None when every field agrees with the sequences
    score: int


def aligned_query(read: np.ndarray, qs: int, qe: int, strand: str):
    if strand == "+":
        return read[qs:qe]
    n = len(read)
    return revcomp(read)[n - qe:n - qs]


def fields(q: np.ndarray, t: np.ndarray, cigar, sc: Scoring):
    """(why the CIGAR does not walk q against t or None, score, mlen,
    blen, cs)."""
    qi = ti = score = n_match = n_cols = 0
    parts = []
    for n, op in cigar:
        if n <= 0:
            return "cigar", 0, 0, 0, ""
        if op == M:
            if qi + n > len(q) or ti + n > len(t):
                return "cigar span", 0, 0, 0, ""
            part, ok = _cs_match(q[qi:qi + n], t[ti:ti + n])
            parts.append(part)
            score += sc.a * ok - sc.b * (n - ok)
            n_match += ok
            qi, ti = qi + n, ti + n
        elif op == I:
            if qi + n > len(q):
                return "cigar span", 0, 0, 0, ""
            parts.append("+" + _lower(q[qi:qi + n]))
            score -= sc.gap(n)
            qi += n
        elif op == D:
            if ti + n > len(t):
                return "cigar span", 0, 0, 0, ""
            parts.append("-" + _lower(t[ti:ti + n]))
            score -= sc.gap(n)
            ti += n
        else:
            return f"cigar op {op}", 0, 0, 0, ""
        n_cols += n
    if qi != len(q) or ti != len(t):
        return "cigar span", 0, 0, 0, ""
    return None, score, n_match, n_cols, "".join(parts)


def walk(rec: Tuple, read: np.ndarray, contigs: dict, sc: Scoring) -> Walk:
    """Check one record against the read's codes and the contigs
    ({name: codes}); its score under `sc` (0 when it does not walk)."""
    (qs, qe, strand, name, tlen, ts, te, mlen, blen, mapq, _primary, cigar,
     nm, cs) = rec
    if name not in contigs or tlen != len(contigs[name]):
        return Walk("contig", 0)
    if not (0 <= qs < qe <= len(read) and 0 <= ts < te <= tlen):
        return Walk("coordinates", 0)
    if strand not in ("+", "-") or not 0 <= mapq <= 60:
        return Walk("strand or mapq", 0)
    why, score, n_match, n_cols, want_cs = fields(
        aligned_query(read, qs, qe, strand), contigs[name][ts:te], cigar, sc)
    if why is not None:
        return Walk(why, 0)
    if mlen != n_match or blen != n_cols or nm != n_cols - n_match:
        return Walk("mlen, blen or NM", score)
    if cs != want_cs:
        return Walk("cs", score)
    return Walk(None, score)


def make_record(read: np.ndarray, name: str, contig: np.ndarray,
                strand: str, qs: int, qe: int, ts: int, te: int, cigar,
                sc: Scoring) -> Tuple:
    """The record of an alignment (mapq 60, primary)."""
    _why, _score, n_match, n_cols, cs = fields(
        aligned_query(read, qs, qe, strand), contig[ts:te], cigar, sc)
    return (qs, qe, strand, name, len(contig), ts, te, n_match, n_cols, 60,
            True, [tuple(c) for c in cigar], n_cols - n_match, cs)


def judge_read(recs: Sequence[Tuple], read: np.ndarray, contigs: dict,
               sc: Scoring):
    """(why the first faulty record is wrong or None, the best score of
    the read's primary records, or None when it has none)."""
    best = None
    for r in recs:
        w = walk(r, read, contigs, sc)
        if w.why is not None:
            return w.why, None
        if r[10]:
            best = w.score if best is None else max(best, w.score)
    if recs and best is None:
        return "no primary record", None
    return None, best
