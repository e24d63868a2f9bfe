"""The best local alignment of each read near where it was drawn: a plain
banded Smith-Waterman-Gotoh DP with minimap2's two-piece affine gaps
(ksw2's scoring: a match a, a mismatch -b, a gap of l bases
-min(q + l e, q2 + l e2)), in plain torch, one query row at a time for a
block of reads at once.

Row i of a read covers the band of 2W + 1 target columns around its
start diagonal: band column c is target offset i + c of the read's
window, so the diagonal predecessor of (i, c) is (i - 1, c), the
vertical one (i - 1, c + 1) and the horizontal ones (i, c' < c).  A
row's horizontal gaps are a running maximum over the row:
E[c] = max_{c' < c} (H'[c'] + e c') - q - e c, with H' the row's cells
before horizontal gaps; a gap that follows another gap of its row is
never better than one gap over both, so H = max(H', E1, E2) is exact.

``best_local`` returns each read's best cell score; with ``rounding``
(the control) every row's H and F are passed through it, and with
``traceback`` the path of the best cell is walked back into a CIGAR.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .records import D, I, M, Scoring

NEG = -(1 << 28)
#: pad codes: a query row past the read's end, a target column outside
#: its contig (each mismatches everything)
Q_PAD, T_PAD = 5, 4


def best_local(queries: Sequence[np.ndarray], windows: Sequence[np.ndarray],
               W: int, sc: Scoring, device, rounding=None,
               traceback: bool = False):
    """queries[r]: codes of read r in the target's orientation;
    windows[r]: target codes of length len(queries[r]) + 2W + 1 (row i
    covers windows[r][i:i + 2W + 1]).  Returns (best scores int64 [B],
    and with `traceback` per read (query start, query end, window start,
    window end, CIGAR [(length, op)]) of its best path)."""
    dev = torch.device(device)
    B, C = len(queries), 2 * W + 1
    L = max(len(q) for q in queries)
    Q = torch.full((B, L), Q_PAD, dtype=torch.uint8)
    T = torch.full((B, L + C), T_PAD, dtype=torch.uint8)
    for r, (q, t) in enumerate(zip(queries, windows)):
        Q[r, :len(q)] = torch.from_numpy(np.ascontiguousarray(q))
        T[r, :len(t)] = torch.from_numpy(np.ascontiguousarray(t))
    Q, T = Q.to(dev), T.to(dev)
    dt = torch.int32 if rounding is None else torch.float32
    neg = torch.full((B, 1), NEG, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    col = torch.arange(C, dtype=dt, device=dev)
    ramp1, ramp2 = sc.e * col, sc.e2 * col
    H = torch.zeros((B, C), dtype=dt, device=dev)
    F1 = torch.full((B, C), NEG, dtype=dt, device=dev)
    F2 = F1.clone()
    best = torch.zeros(B, dtype=dt, device=dev)
    if traceback:
        tb = torch.empty((L, B, C), dtype=torch.uint8, device=dev)
        e1i = torch.empty((L, B, C), dtype=torch.int16, device=dev)
        e2i = torch.empty((L, B, C), dtype=torch.int16, device=dev)
        best_i = torch.full((B,), -1, dtype=torch.int64, device=dev)
        best_c = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(L):
        s = torch.where(Q[:, i:i + 1] == T[:, i:i + C], sc.a, -sc.b).to(dt)
        diag = H + s
        up = torch.cat([H[:, 1:], neg], 1)
        f1o, f1x = up - (sc.q + sc.e), torch.cat([F1[:, 1:], neg], 1) - sc.e
        f2o, f2x = up - (sc.q2 + sc.e2), torch.cat([F2[:, 1:], neg], 1) - sc.e2
        F1, F2 = torch.maximum(f1o, f1x), torch.maximum(f2o, f2x)
        Hp = torch.maximum(torch.maximum(diag, F1), torch.maximum(F2, zero))
        m1 = torch.cummax(Hp + ramp1, 1)
        m2 = torch.cummax(Hp + ramp2, 1)
        E1 = torch.cat([neg, m1.values[:, :-1]], 1) - sc.q - ramp1
        E2 = torch.cat([neg, m2.values[:, :-1]], 1) - sc.q2 - ramp2
        H = torch.maximum(Hp, torch.maximum(E1, E2))
        if traceback:
            hsrc = torch.where(Hp >= torch.maximum(E1, E2), 0,
                               torch.where(E1 >= E2, 1, 2))
            psrc = torch.where(Hp <= 0, 0, torch.where(
                diag == Hp, 1, torch.where(F1 == Hp, 2, 3)))
            tb[i] = (hsrc | (psrc << 2) | ((f1x > f1o).int() << 4)
                     | ((f2x > f2o).int() << 5)).to(torch.uint8)
            e1i[i, :, 1:] = m1.indices[:, :-1].to(torch.int16)
            e2i[i, :, 1:] = m2.indices[:, :-1].to(torch.int16)
        if rounding is not None:
            H, F1, F2 = rounding(H), rounding(F1), rounding(F2)
        row, at = H.max(1)
        if traceback:
            better = row > best
            best_i = torch.where(better, i, best_i)
            best_c = torch.where(better, at, best_c)
        best = torch.maximum(best, row)
    scores = best.to(torch.int64).cpu().numpy()
    if not traceback:
        return scores, None
    tb, e1i, e2i = tb.cpu().numpy(), e1i.cpu().numpy(), e2i.cpu().numpy()
    paths = [_walk_back(tb[:, r], e1i[:, r], e2i[:, r], int(best_i[r]),
                        int(best_c[r])) for r in range(B)]
    return scores, paths


def _walk_back(tb, e1i, e2i, i: int, c: int):
    """The path into cell (i, c): (query start, query end, window start,
    window end, CIGAR)."""
    if i < 0:
        return None
    qe, we = i + 1, i + c + 1
    ops: List[int] = []
    state = "H"
    while i >= 0:
        code = int(tb[i, c])
        if state == "H":
            h = code & 3
            if h:
                src = int((e1i if h == 1 else e2i)[i, c])
                ops.extend([D] * (c - src))
                c = src
            state = "P"
            continue
        if state == "P":
            p = (code >> 2) & 3
            if p == 0:
                break
            if p == 1:
                ops.append(M)
                i -= 1
                state = "H"
                continue
            state = "F1" if p == 2 else "F2"
        ext = (code >> (4 if state == "F1" else 5)) & 1
        ops.append(I)
        i, c = i - 1, c + 1
        if not ext:
            state = "H"
    qs, ws = i + 1, i + c + 1
    cigar: List[List[int]] = []
    for op in reversed(ops):
        if cigar and cigar[-1][1] == op:
            cigar[-1][0] += 1
        else:
            cigar.append([1, op])
    return qs, qe, ws, we, [tuple(x) for x in cigar]


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: scores kept in bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)


def windows_of(genome_codes: np.ndarray, lo: int, hi: int, start: int,
               n: int) -> np.ndarray:
    """Target codes [start, start + n) of the contig [lo, hi) of the
    flat genome, T_PAD outside it."""
    out = np.full(n, T_PAD, np.uint8)
    a, b = max(start, 0), min(start + n, hi - lo)
    if b > a:
        out[a - start:b - start] = genome_codes[lo + a:lo + b]
    return out


def band_of(drift_lo: int, drift_hi: int, margin: int):
    """(the diagonal offset of the band's centre, its half width W) for a
    read whose path drifts within [drift_lo, drift_hi] of its start."""
    return (drift_lo + drift_hi) // 2, (drift_hi - drift_lo + 1) // 2 + margin

