"""Traceback, CIGAR assembly, and cs/MD tag generation (host side).

The device kernel (ops/extend.py) emits packed per-cell direction bytes;
the O(path-length) sequential walk back through them lives here.  This
mirrors the labour split of the reference stack, where CIGAR bytes are
produced inside ksw2 but cs/MD strings are generated post-hoc from the
CIGAR + fetched reference subsequence (SURVEY.md §2b N12,
mm_gen_cs/mm_gen_MD).  A C++ fast path (native/) replaces these inner
loops when built; this numpy/python version is the always-available
fallback and the correctness oracle.

CIGAR op codes follow BAM: 0=M 1=I 2=D 3=N (I consumes query; D and N
consume reference; N marks introns from the splice engines and is
excluded from blen/NM, rendered as ``~`` runs in cs and skipped in MD,
matching minimap2's spliced-output conventions).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .extend import E1_CONT, E2_CONT, F1_CONT, F2_CONT, H_SRC_MASK, band_lo_host

BASES = "ACGTN"


def traceback_one(
    dirs: np.ndarray,  # [S, W] uint8 for one job
    qlen: int,
    tlen: int,
    W: int,
    start_i: int,
    start_j: int,
) -> List[Tuple[int, int]]:
    """Walk directions from (start_i, start_j) to the origin.

    Returns CIGAR as [(count, op)] from alignment START (leading gap
    runs from the virtual border included).
    """
    ops: List[Tuple[int, int]] = []  # appended in reverse order

    def emit(op: int, n: int = 1):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + n, op)
        else:
            ops.append((n, op))

    i, j = start_i, start_j
    state = 0  # 0=M 1=E1 2=E2 3=F1 4=F2
    while i >= 0 and j >= 0:
        s = i + j
        lo = band_lo_host(s, qlen, tlen, W)
        d = i - lo
        byte = int(dirs[s, d]) if 0 <= d < W else 0
        if state == 0:
            src = byte & H_SRC_MASK
            if src == 0:
                emit(0)
                i -= 1
                j -= 1
            else:
                state = src
        elif state in (1, 2):
            emit(2)  # D consumes ref
            cont = byte & (E1_CONT if state == 1 else E2_CONT)
            j -= 1
            if not cont:
                state = 0
        else:
            emit(1)  # I consumes query
            cont = byte & (F1_CONT if state == 3 else F2_CONT)
            i -= 1
            if not cont:
                state = 0
    if i >= 0:
        emit(1, i + 1)
    if j >= 0:
        emit(2, j + 1)
    ops.reverse()
    return ops


def merge_cigars(parts: List[List[Tuple[int, int]]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for part in parts:
        for n, op in part:
            if n <= 0:
                continue
            if out and out[-1][1] == op:
                out[-1] = (out[-1][0] + n, op)
            else:
                out.append((n, op))
    return out


def reverse_cigar(cig: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return list(reversed(cig))


def pack_ops(cig) -> np.ndarray:
    """[(n, op)] (or already-packed array) -> packed int32 n<<4|op
    array (the native/extension wire format; region parts stay packed
    end-to-end)."""
    if isinstance(cig, np.ndarray):
        return np.ascontiguousarray(cig, np.int32)
    return np.fromiter(
        ((n << 4) | op for n, op in cig), np.int32, count=len(cig)
    )


def unpack_ops(arr) -> List[Tuple[int, int]]:
    """Packed int32 n<<4|op array (or already-unpacked list) ->
    [(n, op)] tuples (the public Mapping.cigar format)."""
    if isinstance(arr, np.ndarray):
        # vectorized split + C-speed tolist() instead of per-element
        # python int conversion (hot: once per mapping)
        return list(zip((arr >> 4).tolist(), (arr & 0xF).tolist()))
    return arr


def cigar_spans(cig: List[Tuple[int, int]]) -> Tuple[int, int]:
    """(query_span, ref_span) consumed by the CIGAR."""
    q = sum(n for n, op in cig if op in (0, 1))
    t = sum(n for n, op in cig if op in (0, 2, 3))
    return q, t


def cigar_stats(
    cig: List[Tuple[int, int]], qcodes: np.ndarray, tcodes: np.ndarray
) -> Tuple[int, int, int]:
    """(mlen, blen, NM) by walking the CIGAR against both code arrays.

    mlen counts exact base matches (minimap2's mlen); blen = M+I+D;
    NM = mismatches + inserted + deleted bases (ambiguous bases are not
    counted as matches).  N (intron) ops consume reference but count
    toward neither blen nor NM, as in minimap2's spliced output.
    """
    qi = ti = 0
    mlen = blen = nm = 0
    for n, op in cig:
        if op == 3:
            ti += n
            continue
        blen += n
        if op == 0:
            qs = qcodes[qi : qi + n]
            ts = tcodes[ti : ti + n]
            eq = int(np.sum((qs == ts) & (qs < 4)))
            mlen += eq
            nm += n - eq
            qi += n
            ti += n
        elif op == 1:
            nm += n
            qi += n
        else:
            nm += n
            ti += n
    return mlen, blen, nm


def gen_cs(
    cig: List[Tuple[int, int]], qcodes: np.ndarray, tcodes: np.ndarray
) -> str:
    """cs tag (short form), minimap2 mm_gen_cs semantics."""
    out: List[str] = []
    qi = ti = 0
    for n, op in cig:
        if op == 0:
            run = 0
            for x in range(n):
                qc, tc = int(qcodes[qi + x]), int(tcodes[ti + x])
                if qc == tc and qc < 4:
                    run += 1
                else:
                    if run:
                        out.append(f":{run}")
                        run = 0
                    out.append(f"*{BASES[tc].lower()}{BASES[qc].lower()}")
            if run:
                out.append(f":{run}")
            qi += n
            ti += n
        elif op == 1:
            seg = "".join(BASES[int(c)].lower() for c in qcodes[qi : qi + n])
            out.append(f"+{seg}")
            qi += n
        elif op == 3:
            # intron: ~, donor dinucleotide, length, acceptor dinucleotide
            d0 = BASES[int(tcodes[ti])].lower() if n >= 1 else "n"
            d1 = BASES[int(tcodes[ti + 1])].lower() if n >= 2 else "n"
            a0 = BASES[int(tcodes[ti + n - 2])].lower() if n >= 2 else "n"
            a1 = BASES[int(tcodes[ti + n - 1])].lower() if n >= 1 else "n"
            out.append(f"~{d0}{d1}{n}{a0}{a1}")
            ti += n
        else:
            seg = "".join(BASES[int(c)].lower() for c in tcodes[ti : ti + n])
            out.append(f"-{seg}")
            ti += n
    return "".join(out)


def gen_md(
    cig: List[Tuple[int, int]], qcodes: np.ndarray, tcodes: np.ndarray
) -> str:
    """MD tag (SAM spec), minimap2 mm_gen_MD semantics."""
    out: List[str] = []
    qi = ti = 0
    run = 0
    for n, op in cig:
        if op == 0:
            for x in range(n):
                qc, tc = int(qcodes[qi + x]), int(tcodes[ti + x])
                if qc == tc and qc < 4:
                    run += 1
                else:
                    out.append(str(run))
                    out.append(BASES[tc])
                    run = 0
            qi += n
            ti += n
        elif op == 1:
            qi += n
        elif op == 3:
            ti += n  # introns are invisible to MD (match run continues)
        else:
            out.append(str(run))
            run = 0
            out.append("^" + "".join(BASES[int(c)] for c in tcodes[ti : ti + n]))
            ti += n
    out.append(str(run))
    return "".join(out)
