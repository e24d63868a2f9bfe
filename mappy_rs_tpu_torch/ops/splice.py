"""Splice-aware alignment DP (intron state) — host oracle + tables.

A copy of the JAX package's ops/splice.py (numpy only; the port keeps
its own copy and imports nothing of that package).  The ksw_exts2
splice model behind minimap2's MM_F_SPLICE presets, which the reference
exposes through ``mm_set_opt("splice")``.  The scoring model:

  - match/mismatch ``a``/``-b`` (``-sc_ambi`` vs ambiguous bases);
  - ONE affine gap pair ``(q, e)`` for genuine indels (splice presets
    repurpose ``q2`` as the intron open cost and force ``e2 = 0``);
  - an INTRON state that consumes reference at zero per-base cost:
    opening costs ``q2 + don(j)`` and closing costs ``acc(j)``, where
    the donor/acceptor penalties score the splice signal under the
    chosen transcript sense:

      sense +1 (transcript == ref forward):  GT ... AG
      sense -1 (transcript == ref reverse):  CT ... AC

    With the MM_F_SPLICE_FLANK signal model the one-base flank joins
    the signal (GTR ... YAG and its reverse complement): full signal
    -> 0, bare dinucleotide -> noncan//2, else -> noncan.  Without it:
    dinucleotide -> 0, else noncan.

Intron runs are emitted as BAM op 3 (``N``); downstream cs uses the
``~`` notation and stats/MD skip intron bases (ops/cigar.py,
native/src/mappy_native.cc).

This module is the correctness oracle and the fallback when the host
library is absent; the production path is the C++ engine
(native/src/mappy_native.cc splice_align_batch), held bit-identical to
it in tests/test_torch_splice.py.
Left flanks run on REVERSED sequences (extension walks outward), so
the signal patterns mirror: ``reversed_seq=True`` matches the reversed
images of the same motifs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(1 << 28)

# direction byte layout (per DP cell)
H_SRC_MASK = 0x03  # 0=diag(M) 1=E(D) 2=F(I) 3=A-close(N)
E_CONT = 0x04
F_CONT = 0x08
A_CONT = 0x10


def splice_site_tables(
    t: np.ndarray,
    sense: int,
    flank: bool,
    noncan: int,
    reversed_seq: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position donor/acceptor penalties for target codes ``t``.

    don[j] = penalty to OPEN an intron whose first consumed base is
    t[j]; acc[j] = penalty to CLOSE an intron whose last consumed base
    is t[j].  Motifs by (sense, reversed_seq) — each reversed variant
    is the plain reversal (not complement) of the forward motif, since
    flank jobs reverse both sequences:

      sense +1 fwd: open GT(R)   close (Y)AG
      sense -1 fwd: open CT(R)   close (Y)AC
      sense +1 rev: open GA(Y)   close (R)TG
      sense -1 rev: open CA(Y)   close (R)TC
    """
    t = np.asarray(t, np.int32)
    T = len(t)
    if T == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy()
    pad = np.full(2, 4, np.int32)
    tp = np.concatenate([pad, t, pad])

    def at(off: int) -> np.ndarray:
        return tp[2 + off : 2 + off + T]

    A, C, G, Tb = 0, 1, 2, 3
    if not reversed_seq:
        o = (G, Tb) if sense > 0 else (C, Tb)
        of = (A, G)  # R
        c = (A, G) if sense > 0 else (A, C)
        cf = (C, Tb)  # Y
    else:
        o = (G, A) if sense > 0 else (C, A)
        of = (C, Tb)  # reversed flank = Y
        c = (Tb, G) if sense > 0 else (Tb, C)
        cf = (A, G)  # reversed flank = R
    open2 = (at(0) == o[0]) & (at(1) == o[1])
    close2 = (at(-1) == c[0]) & (at(0) == c[1])
    if flank:
        open_full = open2 & ((at(2) == of[0]) | (at(2) == of[1]))
        close_full = close2 & ((at(-2) == cf[0]) | (at(-2) == cf[1]))
        don = np.where(open_full, 0, np.where(open2, noncan // 2, noncan))
        acc = np.where(close_full, 0, np.where(close2, noncan // 2, noncan))
    else:
        don = np.where(open2, 0, noncan)
        acc = np.where(close2, 0, noncan)
    return don.astype(np.int32), acc.astype(np.int32)


def splice_align(
    q: np.ndarray,
    t: np.ndarray,
    a: int,
    b: int,
    gapo: int,
    gape: int,
    q2: int,
    noncan: int,
    sc_ambi: int,
    sense: int,
    flank: bool,
    mode: int,  # 2 = global (both ends pinned), 1 = extension
    end_bonus: int = 0,
    reversed_seq: bool = False,
) -> Tuple[np.ndarray, int, int, int]:
    """Full-matrix splice DP + traceback (scalar oracle).

    Returns (packed ops int32 (n<<4|op), score, q_consumed,
    t_consumed).  Tie rules (replicated exactly by the C++ engine):
    gap/intron CONTINUE wins ties over re-open; H source priority on
    ties is diag > E(D) > F(I) > A(N); extension best cell keeps the
    first (smallest i, then j) strict maximum, and the full-query row
    end is used when g_sc + end_bonus >= best_sc (g_sc > 0).
    """
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    Q, T = len(q), len(t)
    empty = np.empty(0, np.int32)
    if Q == 0 or T == 0:
        return empty, 0, 0, 0
    don, acc = splice_site_tables(t, sense, flank, noncan, reversed_seq)
    dirs = np.zeros((Q + 1, T + 1), np.uint8)
    H = np.full(T + 1, NEG, np.int64)
    E = np.full(T + 1, NEG, np.int64)
    Ai = np.full(T + 1, NEG, np.int64)
    Fp = np.full(T + 1, NEG, np.int64)  # F of previous row
    H[0] = 0
    # row 0: leading deletions / introns only
    for j in range(1, T + 1):
        e_open = H[j - 1] - gapo
        if E[j - 1] >= e_open:
            E[j] = E[j - 1] - gape
            dirs[0, j] |= E_CONT
        else:
            E[j] = e_open - gape
        a_open = H[j - 1] - q2 - int(don[j - 1])
        if Ai[j - 1] >= a_open:
            Ai[j] = Ai[j - 1]
            dirs[0, j] |= A_CONT
        else:
            Ai[j] = a_open
        h, src = E[j], 1
        ac = Ai[j] - int(acc[j - 1])
        if ac > h:
            h, src = ac, 3
        H[j] = h
        dirs[0, j] |= src
    best_sc, best_i, best_j = 0, 0, 0
    g_sc, g_j = NEG, 0
    Hp = H.copy()
    for i in range(1, Q + 1):
        qc = int(q[i - 1])
        E[:] = NEG
        Ai[:] = NEG
        # F column 0 and H column 0
        f_open = Hp[0] - gapo
        if Fp[0] >= f_open:
            F0 = Fp[0] - gape
            dirs[i, 0] |= F_CONT
        else:
            F0 = f_open - gape
        F = np.full(T + 1, NEG, np.int64)
        F[0] = F0
        H[0] = F0
        dirs[i, 0] |= 2
        for j in range(1, T + 1):
            tc = int(t[j - 1])
            pair = -sc_ambi if (qc == 4 or tc == 4) else (a if qc == tc else -b)
            e_open = H[j - 1] - gapo
            if E[j - 1] >= e_open:
                E[j] = E[j - 1] - gape
                dirs[i, j] |= E_CONT
            else:
                E[j] = e_open - gape
            f_open = Hp[j] - gapo
            if Fp[j] >= f_open:
                F[j] = Fp[j] - gape
                dirs[i, j] |= F_CONT
            else:
                F[j] = f_open - gape
            a_open = H[j - 1] - q2 - int(don[j - 1])
            if Ai[j - 1] >= a_open:
                Ai[j] = Ai[j - 1]
                dirs[i, j] |= A_CONT
            else:
                Ai[j] = a_open
            h, src = Hp[j - 1] + pair, 0
            if E[j] > h:
                h, src = E[j], 1
            if F[j] > h:
                h, src = F[j], 2
            ac = Ai[j] - int(acc[j - 1])
            if ac > h:
                h, src = ac, 3
            H[j] = h
            dirs[i, j] |= src
            if mode == 1 and h > best_sc:
                best_sc, best_i, best_j = int(h), i, j
        if mode == 1 and i == Q:
            jj = int(np.argmax(H))
            g_sc, g_j = int(H[jj]), jj
        Hp, H = H, Hp
        Fp, F = F, Fp
    # Hp now holds the final row
    if mode == 2:
        start_i, start_j, score = Q, T, int(Hp[T])
    else:
        if g_sc > NEG and g_sc > 0 and g_sc + end_bonus >= best_sc:
            start_i, start_j, score = Q, g_j, g_sc
        elif best_sc > 0:
            start_i, start_j, score = best_i, best_j, best_sc
        else:
            return empty, 0, 0, 0
    # traceback
    ops = []  # reversed (n, op)

    def emit(op: int, n: int = 1) -> None:
        if ops and ops[-1][1] == op:
            ops[-1][0] += n
        else:
            ops.append([n, op])

    i, j, state = start_i, start_j, 0
    while i > 0 or j > 0:
        d = int(dirs[i, j])
        if state == 0:
            src = d & H_SRC_MASK
            if src == 0:
                emit(0)
                i -= 1
                j -= 1
            else:
                state = src
        elif state == 1:
            emit(2)
            cont = d & E_CONT
            j -= 1
            if not cont:
                state = 0
        elif state == 2:
            emit(1)
            cont = d & F_CONT
            i -= 1
            if not cont:
                state = 0
        else:
            emit(3)
            cont = d & A_CONT
            j -= 1
            if not cont:
                state = 0
    ops.reverse()
    packed = np.fromiter(
        ((n << 4) | op for n, op in ops), np.int32, count=len(ops)
    )
    return packed, score, start_i, start_j
