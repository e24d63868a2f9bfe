"""Banded dual-affine-gap extension DP (ksw2 class): the plain version
of kernel K3, plus the parameters and direction-byte layout.

Port of the JAX package's ops/extend.py ``extend_dp``.  The DP sweeps
ANTI-DIAGONALS: up/left come from diagonal s-1 and the diagonal
predecessor from s-2, so a whole band of W cells advances per step for
J jobs at once ([J, W] tensor ops per diagonal).  The band is static:
lane d of diagonal s is query row i = lo(s) + d with
lo(s) = max(s//2 - W//2 + 1, 0), so the W lanes cover j - i in
[-W, W-2].  Scoring is minimap2's: +a match, -b mismatch, -sc_ambi
against N (code 4), and the dual affine gap cost min(q + l*e, q2 + l*e2)
through two E (deletion) and two F (insertion) channels.

Each cell's traceback direction is one byte of ``dirs`` [S, J, W]
(S = QMAX + TMAX - 1): bits 0-2 the source of H (0 diag, 1 E1, 2 E2,
3 F1, 4 F2), then one continuation bit per gap channel.  Ties go
M > E1 > E2 > F1 > F2 (strict >).  Beside ``dirs`` the sweep keeps, per
job: the best cell anywhere (extension mode), the best cell of the last
query row (extension to the query end, for end_bonus) and the score of
the global end cell (qlen-1, tlen-1).

This module is the CPU path and the reference that kernel K3
(csrc/extend.cu, ops/extend_kernel.py) is held to on the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

NEG = -(1 << 28)


class ExtendParams(NamedTuple):
    a: int  # match score (>0)
    b: int  # mismatch penalty (>0)
    q: int
    e: int
    q2: int
    e2: int
    sc_ambi: int  # penalty vs ambiguous base (>0)


# direction byte layout
H_SRC_MASK = 0x07  # 0=diag 1=E1 2=E2 3=F1 4=F2
E1_CONT = 0x08
E2_CONT = 0x10
F1_CONT = 0x20
F2_CONT = 0x40

#: the six best-tracker columns of K3's [J, 6] output, in order
BEST_COLS = ("best_sc", "best_i", "best_j", "g_sc", "g_j", "end_sc")


def band_lo_host(s: int, qlen: int, tlen: int, W: int):
    """Host mirror of the in-kernel band placement (for traceback).
    qlen/tlen accepted for interface stability; the band is static."""
    return max(s // 2 - W // 2 + 1, 0)


def _gap_cost(l: torch.Tensor, p: ExtendParams) -> torch.Tensor:
    """min(q + l*e, q2 + l*e2) for l >= 1 (elementwise, int32)."""
    return torch.minimum(p.q + l * p.e, p.q2 + l * p.e2)


def _shift_back(x: torch.Tensor) -> torch.Tensor:  # out[d] = x[d-1]
    return torch.cat([torch.full_like(x[:, :1], NEG), x[:, :-1]], dim=1)


def _shift_fwd(x: torch.Tensor) -> torch.Tensor:  # out[d] = x[d+1]
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], NEG)], dim=1)


def extend_dp(
    q: torch.Tensor,  # uint8 [J, QMAX] base codes, padded
    t: torch.Tensor,  # uint8 [J, TMAX]
    qlen: torch.Tensor,  # int32 [J]
    tlen: torch.Tensor,  # int32 [J]
    W: int,
    params: ExtendParams,
) -> Dict[str, torch.Tensor]:
    """Run the banded DP for a batch of jobs on the device of `q`.

    Returns a dict: ``dirs`` uint8 [S, J, W] and the int32 [J] trackers
    ``best_sc, best_i, best_j`` (best cell anywhere), ``g_sc, g_j``
    (best cell of the row i == qlen-1) and ``end_sc`` (the cell
    (qlen-1, tlen-1)).  A job with qlen == 0 or tlen == 0 has no cell:
    its trackers stay NEG (scores) or 0 (coordinates), its dirs 0."""
    dev = q.device
    J, QMAX = q.shape
    TMAX = t.shape[1]
    S = QMAX + TMAX - 1
    p = params
    i32 = torch.int32
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]  # [1, W]
    qc = q.long()
    tc = t.long()
    qlen = qlen.to(device=dev, dtype=i32)[:, None]
    tlen = tlen.to(device=dev, dtype=i32)[:, None]
    s_last = (qlen + tlen - 2)[:, 0]

    z = torch.full((J, W), NEG, dtype=i32, device=dev)
    H1 = E1a = E2a = F1a = F2a = H2 = z
    best_sc = torch.full((J,), NEG, dtype=i32, device=dev)
    best_i = torch.zeros(J, dtype=i32, device=dev)
    best_j = torch.zeros(J, dtype=i32, device=dev)
    g_sc = best_sc.clone()
    g_j = best_i.clone()
    end_sc = best_sc.clone()
    # past the last job's end cell (diagonal qlen + tlen - 2) no lane is
    # a cell: the trackers stay, the direction bytes are 0
    S_run = min(S, max(int((qlen + tlen - 1).max()), 0)) if J else 0
    dirs = torch.zeros((S, J, W), dtype=torch.uint8, device=dev)
    lo1 = lo2 = 0  # band offsets of diagonals s-1 and s-2
    for s in range(S_run):
        lo = max(s // 2 - W // 2 + 1, 0)
        delta1 = lo - lo1  # 0/1: shift against diagonal s-1
        delta2 = lo - lo2  # 0/1/2: shift against diagonal s-2
        i = lo + lanes  # [1, W] query row of each lane
        j = s - i
        cell_ok = (i <= torch.clamp(qlen - 1, max=s)) & (j >= 0) & (j <= tlen - 1)
        qb = qc[:, i[0].clamp(0, QMAX - 1).long()]
        tb = tc[:, j[0].clamp(0, TMAX - 1).long()]
        ambi = (qb == 4) | (tb == 4)
        pair = torch.where(
            ambi, -p.sc_ambi, torch.where(qb == tb, p.a, -p.b)
        ).to(i32)

        # predecessors: up (i-1, j) and left (i, j-1) on s-1, diagonal
        # (i-1, j-1) on s-2; out-of-band neighbours read NEG
        if delta1 == 1:
            H_up, F1_up, F2_up = H1, F1a, F2a
            H_left = _shift_fwd(H1)
            E1_left, E2_left = _shift_fwd(E1a), _shift_fwd(E2a)
        else:
            H_up = _shift_back(H1)
            F1_up, F2_up = _shift_back(F1a), _shift_back(F2a)
            H_left, E1_left, E2_left = H1, E1a, E2a
        if delta2 == 2:
            H_diag = _shift_fwd(H2)
        elif delta2 == 1:
            H_diag = H2
        else:
            H_diag = _shift_back(H2)

        # borders: H(-1, j-1) = -gap(j), H(i-1, -1) = -gap(i).  Lane 0
        # is row 0 while lo == 0, and some lane is column 0 while
        # s - lo < W; past both (most diagonals) no lane is a border.
        if lo == 0 or s - lo < W:
            at_i0 = i == 0
            at_j0 = j == 0
            H_diag = torch.where(
                at_i0 & at_j0, 0,
                torch.where(at_i0, -_gap_cost(j, p),
                            torch.where(at_j0, -_gap_cost(i, p), H_diag)),
            )
            H_left = torch.where(at_j0, -_gap_cost(i + 1, p), H_left)
            E1_left = torch.where(at_j0, NEG, E1_left)
            E2_left = torch.where(at_j0, NEG, E2_left)
            H_up = torch.where(at_i0, -_gap_cost(j + 1, p), H_up)
            F1_up = torch.where(at_i0, NEG, F1_up)
            F2_up = torch.where(at_i0, NEG, F2_up)

        # gap channels; a continuation bit is set on strict >
        e1_open = H_left - p.q
        E1 = torch.maximum(E1_left, e1_open) - p.e
        e2_open = H_left - p.q2
        E2 = torch.maximum(E2_left, e2_open) - p.e2
        f1_open = H_up - p.q
        F1 = torch.maximum(F1_up, f1_open) - p.e
        f2_open = H_up - p.q2
        F2 = torch.maximum(F2_up, f2_open) - p.e2
        cont = (
            (E1_left > e1_open).to(i32) * E1_CONT
            | (E2_left > e2_open).to(i32) * E2_CONT
            | (F1_up > f1_open).to(i32) * F1_CONT
            | (F2_up > f2_open).to(i32) * F2_CONT
        )

        # precedence on ties: M > E1 > E2 > F1 > F2
        H = H_diag + pair
        src = torch.zeros_like(H)
        for val, code in ((E1, 1), (E2, 2), (F1, 3), (F2, 4)):
            better = val > H
            H = torch.where(better, val, H)
            src = torch.where(better, code, src)
        H = torch.where(cell_ok, H, NEG)
        E1 = torch.where(cell_ok, E1, NEG)
        E2 = torch.where(cell_ok, E2, NEG)
        F1 = torch.where(cell_ok, F1, NEG)
        F2 = torch.where(cell_ok, F2, NEG)
        dirs[s] = torch.where(cell_ok, src | cont, 0).to(torch.uint8)

        # best trackers: strictly greater only, at the lowest lane
        row_best = H.max(dim=1).values
        row_arg = torch.where(H == row_best[:, None], lanes, W).min(dim=1).values
        upd = row_best > best_sc
        best_sc = torch.where(upd, row_best, best_sc)
        best_i = torch.where(upd, lo + row_arg, best_i)
        best_j = torch.where(upd, s - (lo + row_arg), best_j)
        lastrow = torch.where((i == qlen - 1) & cell_ok, H, NEG)
        lr_best = lastrow.max(dim=1).values
        lr_arg = torch.where(lastrow == lr_best[:, None], lanes, W).min(dim=1).values
        updg = lr_best > g_sc
        g_sc = torch.where(updg, lr_best, g_sc)
        g_j = torch.where(updg, s - (lo + lr_arg), g_j)
        end_here = torch.where(
            (i == qlen - 1) & (j == tlen - 1), H, NEG
        ).max(dim=1).values
        end_sc = torch.where(s == s_last, torch.maximum(end_sc, end_here), end_sc)

        H2, H1, E1a, E2a, F1a, F2a = H1, H, E1, E2, F1, F2
        lo2, lo1 = lo1, lo
    return {
        "dirs": dirs,
        "best_sc": best_sc, "best_i": best_i, "best_j": best_j,
        "g_sc": g_sc, "g_j": g_j, "end_sc": end_sc,
    }
