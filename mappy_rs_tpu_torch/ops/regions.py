"""Chain backtracking, region generation, primary marking, mapq.

Host-side O(result-size) stages between the device chaining DP and the
extension — the equivalents of the C core's
``mm_chain_backtrack`` (N9 tail), ``mm_gen_regs``/``mm_reg_set_coor``,
``mm_set_parent``/``mm_select_sub`` (N11) and ``mm_set_mapq``
(SURVEY.md §2b).  All are cheap linear walks over at most a few
hundred chains per read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import MapOptions


@dataclass
class Region:
    """One candidate mapping region (mm_reg1_t analogue)."""

    rev: int
    rid: int
    qs: int  # query start, read-forward coords
    qe: int
    rs: int  # target start, forward ref strand
    re: int
    score: int  # chain score
    cnt: int  # anchors in chain
    anchors_qpos: np.ndarray  # ascending, aligned-query coords
    anchors_rpos: np.ndarray
    id: int = -1
    parent: int = -1
    subsc: int = 0  # best child (secondary) chain score
    n_sub: int = 0
    # filled by extension:
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0  # best DP score among this primary's secondaries
    cigar: Optional[List[Tuple[int, int]]] = None
    q_st_a: int = 0  # aligned coords in aligned-query space
    q_en_a: int = 0
    r_st: int = 0
    r_en: int = 0
    mlen: int = 0
    blen: int = 0
    nm: int = 0
    mapq: int = 0
    cs: Optional[str] = None
    md: Optional[str] = None
    # splice mode: transcript sense that won the two-round alignment
    # (+1 = GT..AG on ref forward, -1 = CT..AC, 0 = no intron found)
    trans_strand: int = 0


def backtrack_chains(
    f: np.ndarray,
    p: np.ndarray,
    valid: np.ndarray,
    min_cnt: int,
    min_sc: int,
) -> List[Tuple[int, List[int]]]:
    """mm_chain_backtrack semantics: peak-sorted greedy backtracks.

    Returns [(score, [anchor indices ascending])], best first.
    Anchors of rejected partial chains stay consumed, as in the C code.
    """
    n = len(f)
    cand = np.nonzero((f >= min_sc) & valid)[0]
    if len(cand) == 0:
        return []
    # descending score, ties: larger index first (radix sort order)
    order = cand[np.lexsort((-cand, -f[cand]))]
    used = np.zeros(n, bool)
    chains: List[Tuple[int, List[int]]] = []
    for end in order:
        if used[end]:
            continue
        path = []
        i = int(end)
        while i >= 0 and not used[i]:
            path.append(i)
            used[i] = True
            i = int(p[i])
        if i < 0:
            sc = int(f[end])
        else:
            sc = int(f[end]) - int(f[i])
        if len(path) >= min_cnt and sc >= min_sc:
            chains.append((sc, path[::-1]))
    return chains


def gen_regions(
    chains: List[Tuple[int, List[int]]],
    anchors: dict,
    read_idx: int,
    qlen: int,
    span: int,
) -> List[Region]:
    """mm_gen_regs / mm_reg_set_coor semantics.  `span` is the default
    k-mer span; per-anchor spans (HPC) override it when present."""
    regions: List[Region] = []
    rev_a = anchors["rev"][read_idx]
    rid_a = anchors["rid"][read_idx]
    rpos_a = anchors["rpos"][read_idx]
    qpos_a = anchors["qpos"][read_idx]
    span_a = anchors.get("span")
    span_a = None if span_a is None else span_a[read_idx]
    for sc, path in chains:
        first, last = path[0], path[-1]
        sp_first = span if span_a is None else int(span_a[first])
        rev = int(rev_a[first])
        rid = int(rid_a[first])
        rs = max(int(rpos_a[first]) + 1 - sp_first, 0)
        re = int(rpos_a[last]) + 1
        q_first = int(qpos_a[first])
        q_last = int(qpos_a[last])
        if rev == 0:
            qs = q_first + 1 - sp_first
            qe = q_last + 1
        else:
            qs = qlen - (q_last + 1)
            qe = qlen - (q_first + 1 - sp_first)
        regions.append(
            Region(
                rev=rev,
                rid=rid,
                qs=qs,
                qe=qe,
                rs=rs,
                re=re,
                score=sc,
                cnt=len(path),
                anchors_qpos=np.asarray(qpos_a[path]),
                anchors_rpos=np.asarray(rpos_a[path]),
            )
        )
    return regions


def regions_from_compact(
    rows: np.ndarray, qlen: int, default_span: int
) -> List[Region]:
    """gen_regions over the device backtrack kernel's compact chain
    table (ops/backtrack_pallas.py field layout): one [K, 9+2*cuts]
    int32 block per read; empty slots have score < 0.  The sampled
    anchors (first, recorded cuts, last) are exactly what
    _mid_segments needs — interior cuts are >= SEG_LEN apart by
    construction."""
    regions: List[Region] = []
    # one C-speed conversion of the whole block to python ints beats
    # ~15 numpy-scalar __int__ calls per surviving row (hot: per read)
    for row in np.asarray(rows).tolist():
        sc = row[0]
        if sc < 0:
            continue
        sp = row[8] if row[8] > 0 else default_span
        rev = row[2]
        q_first, q_last = row[6], row[7]
        if rev == 0:
            qs = q_first + 1 - sp
            qe = q_last + 1
        else:
            qs = qlen - (q_last + 1)
            qe = qlen - (q_first + 1 - sp)
        # cut pairs are recorded end->start (descending qpos)
        cuts_q = [v for v in row[9::2] if v >= 0][::-1]
        cuts_r = [v for v in row[10::2] if v >= 0][::-1]
        regions.append(
            Region(
                rev=rev,
                rid=row[3],
                qs=qs,
                qe=qe,
                rs=max(row[4] + 1 - sp, 0),
                re=row[5] + 1,
                score=sc,
                cnt=row[1],
                anchors_qpos=np.asarray(
                    [q_first] + cuts_q + [q_last], np.int32
                ),
                anchors_rpos=np.asarray(
                    [row[4]] + cuts_r + [row[5]], np.int32
                ),
            )
        )
    return regions


def set_parent(
    regions: List[Region], mask_level: float, mask_len: int
) -> None:
    """mm_set_parent: greedy primary marking by query-interval overlap."""
    if not regions:
        return
    for i, r in enumerate(regions):
        r.id = i
    order = sorted(
        range(len(regions)), key=lambda i: (-regions[i].score, i)
    )
    primaries: List[int] = []
    for i in order:
        r = regions[i]
        assigned = False
        for j in primaries:
            pr = regions[j]
            # NB: the overlap rule is on the QUERY interval only — two
            # chains to different contigs still shadow each other
            s = max(r.qs, pr.qs)
            e = min(r.qe, pr.qe)
            ol = max(0, e - s)
            min_l = min(r.qe - r.qs, pr.qe - pr.qs)
            if ol > mask_level * min_l and min_l < mask_len:
                r.parent = pr.id
                if r.score > pr.subsc:
                    pr.subsc = r.score
                pr.n_sub += 1
                assigned = True
                break
        if not assigned:
            r.parent = r.id
            primaries.append(i)


def select_sub(
    regions: List[Region], pri_ratio: float, best_n: int
) -> List[Region]:
    """mm_select_sub: keep primaries + up to best_n good secondaries."""
    if pri_ratio <= 0.0:
        return regions
    out: List[Region] = []
    n_2nd = 0
    by_id = {r.id: r for r in regions}
    for r in sorted(regions, key=lambda r: (-r.score, r.id)):
        if r.parent == r.id:
            out.append(r)
        else:
            parent = by_id.get(r.parent)
            if (
                parent is not None
                and r.score >= parent.score * pri_ratio
                and n_2nd < best_n
            ):
                out.append(r)
                n_2nd += 1
    return out


def set_mapq(
    regions: List[Region],
    opt: MapOptions,
    rep_len: int = 0,
    is_sr: bool = False,
) -> None:
    """mm_set_mapq semantics (minimap2 map.c; behind
    /root/reference/src/lib.rs:493-509 via the C core).

    Structure mirrored from the C function:
      * uniq_ratio = sum(primary chain scores) / (sum + rep_len) —
        reads whose seeds fell in occ-filtered repeats get attenuated;
      * pen_s1 = (score>100 ? 1 : 0.01*score) * uniq_ratio,
        pen_cm = (cnt>10 ? 1 : 0.1*cnt), pen = min of the two;
      * DP branch (alignment available): mapq = identity * pen *
        40 * (1 - dp_max2/dp_max) * ln(score), identity = mlen/blen,
        dp_max2 = best DP score among this primary's secondaries;
      * chain-only branch: mapq = pen * 40 * (1 - subsc/score) *
        ln(score) with subsc floored at min_chain_score;
      * multi-secondary penalty: mapq -= 4.343*ln(n_sub+1)+0.499;
      * clamp [0, 60]; non-primaries get 0.
    No minimap2 oracle exists in this environment, so parity is
    structural (formula shape + inputs), asserted by unit tests on the
    monotonicity/attenuation properties rather than golden values.
    """
    q_coef = 40.0
    sum_sc = sum(r.score for r in regions if r.parent == r.id)
    uniq_ratio = (
        float(sum_sc) / float(sum_sc + rep_len) if sum_sc + rep_len > 0
        else 1.0
    )
    for r in regions:
        if r.parent != r.id or r.score <= 0:
            r.mapq = 0
            continue
        pen_s1 = (1.0 if r.score > 100 else 0.01 * r.score) * uniq_ratio
        pen_cm = 1.0 if r.cnt > 10 else 0.1 * r.cnt
        pen = min(pen_s1, pen_cm)
        subsc = max(r.subsc, opt.min_chain_score)
        log_sc = math.log(r.score) if r.score > 1 else 0.0
        if r.dp_max > 0 and r.dp_max2 > 0:
            identity = float(r.mlen) / r.blen if r.blen > 0 else 0.0
            x = min(float(r.dp_max2) / r.dp_max, 1.0)
            mapq = int(identity * pen * q_coef * (1.0 - x) * log_sc)
        elif r.dp_max > 0:
            identity = float(r.mlen) / r.blen if r.blen > 0 else 0.0
            x = float(subsc) / r.score
            mapq = int(identity * pen * q_coef * (1.0 - x) * log_sc)
        else:
            x = float(subsc) / r.score
            mapq = int(pen * q_coef * (1.0 - x) * log_sc)
        if r.n_sub > 0:
            mapq -= int(4.343 * math.log(r.n_sub + 1) + 0.499)
        mapq = max(0, min(60, mapq))
        if is_sr and r.score > subsc and mapq < 1:
            mapq = 1  # unique short-read hits never report 0
        r.mapq = mapq
