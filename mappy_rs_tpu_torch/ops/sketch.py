"""Vectorized (k,w) canonical minimizer sketch on torch tensors.

The port of the JAX package's ops/sketch.py: the whole batch of reads
is sketched at once as dense [B, L] tensor ops (k static shifted views
build the k-mer integers, a cascade of w-1 shifted mins gives the
window minimum, and minimap2's ring-buffer emission rule is evaluated
as five position-based mask clauses).  See that module's docstring for
the derivation of the clauses; this file keeps its structure so the two
read side by side.

Hashes are int64 (utils/u64.py) for every k <= 28.  The invalid-slot
key is the JAX package's sentinel read as one integer: 0xFFFFFFFF
while 2k <= 32 (the JAX package's one-word case, where a real key can
equal it), else INF_WIDE, which stands above every 56-bit key as the
JAX package's (0xFFFFFFFF, 0xFFFFFFFF) does and gives the same probe
slot (ops/lookup.py).  Homopolymer-compressed (HPC) sketching runs the
same sketch on compressed codes (``compress_hpc``, ``hpc_spans``, host
numpy, as in the JAX package).  Every op on tensors here is a plain
tensor op with static shapes: no host sync.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import u64

AMBIG = 4  # base code for non-ACGT
INF = 0xFFFFFFFF  # invalid-slot key for 2k <= 32 (the JAX uint32 sentinel)
INF_WIDE = (1 << 63) - 1  # invalid-slot key for 2k > 32


def inf_key(k: int) -> int:
    """The invalid-slot key of a k-mer sketch (see the module docstring)."""
    return INF if 2 * k <= 32 else INF_WIDE


def _shifted_back(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[..., i-d] with `fill` for i-d < 0 (static d >= 0)."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _shifted_fwd(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[..., i+d] with `fill` past the end (static d >= 0)."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def compress_hpc(codes: np.ndarray, lengths: np.ndarray):
    """Homopolymer-compress a padded batch (host, vectorized numpy).

    Returns (ccodes [B, L] padded with 4, clens [B], run_end [B, L]
    uncompressed END position per compressed symbol, run_len [B, L]).
    Runs of the SAME valid base collapse to one symbol positioned at
    the run's last base; ambiguous bases stay one symbol each (they
    occupy window slots in the scalar algorithm)."""
    B, L = codes.shape
    prev = np.full((B, L), 5, codes.dtype)
    prev[:, 1:] = codes[:, :-1]
    pos = np.arange(L)
    in_len = pos[None, :] < lengths[:, None]
    keep = ((codes != prev) | (codes >= 4) | (prev >= 4)) & in_len
    ccodes = np.full((B, L), 4, np.uint8)
    run_end = np.zeros((B, L), np.int32)
    run_len = np.zeros((B, L), np.int32)
    clens = keep.sum(axis=1).astype(np.int32)
    for b in range(B):
        ks = np.nonzero(keep[b])[0]
        n = len(ks)
        if n == 0:
            continue
        ccodes[b, :n] = codes[b, ks]
        ends = np.empty(n, np.int64)
        ends[:-1] = ks[1:] - 1
        ends[-1] = int(lengths[b]) - 1
        run_end[b, :n] = ends
        run_len[b, :n] = ends - ks + 1
    return ccodes, clens, run_end, run_len


def hpc_spans(run_len: np.ndarray, k: int) -> np.ndarray:
    """span[j] = sum of run lengths of the k runs ending at j (garbage
    across N-breaks; the sketch's validity mask covers those)."""
    cs = np.cumsum(run_len.astype(np.int64), axis=1)
    shifted = np.zeros_like(cs)
    shifted[:, k:] = cs[:, :-k]
    return (cs - shifted).astype(np.int32)


def sketch(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
           force_inf: torch.Tensor | None = None):
    """Sketch a padded batch of reads.

    Args:
      codes: uint8/int [B, L] base codes 0..4; positions >= lengths[b]
        must be padded with AMBIG (4).
      lengths: int [B] true read lengths.
      k, w: sketch parameters (k <= 28, w < 256).
      force_inf: optional bool [B, L]; True positions never emit (HPC
        k-mers spanning 256 or more bases).

    Returns dict of [B, L] tensors, all aligned to k-mer END position i:
      minimizer: bool — position i emits a minimizer
      key: int64 — 2k-bit hash of the canonical k-mer (inf_key(k) if
        invalid)
      strand: uint8 — 0 forward / 1 reverse-canonical
    """
    inf = inf_key(k)
    dev = codes.device
    codes = codes.to(torch.int64)
    B, L = codes.shape
    lengths = lengths.to(torch.int64)
    valid_base = codes < AMBIG
    clean = torch.where(valid_base, codes, 0)

    # --- validity: all k bases ending at i are valid ------------------
    run_break = torch.cumsum((~valid_base).to(torch.int64), dim=-1)
    win_break = run_break - _shifted_back(run_break, k, 0)
    pos = torch.arange(L, dtype=torch.int64, device=dev).expand(B, L)
    kmer_ok = (win_break == 0) & (pos >= (k - 1))

    # --- forward / reverse k-mer integers -----------------------------
    kf = torch.zeros((B, L), dtype=torch.int64, device=dev)
    kr = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for d in range(k):
        b = _shifted_back(clean, d, 0)  # base at distance d back
        kf = kf | (b << (2 * d))  # forward: newest base in lowest bits
        kr = kr | ((b ^ 3) << (2 * (k - 1 - d)))  # reverse: highest bits

    # canonical strand: z=1 when reverse complement is smaller
    z = kr <= kf  # kf==kr -> z True (even-k only)
    h = u64.hash64(torch.where(z, kr, kf), k)

    emit_ok = kmer_ok if force_inf is None else kmer_ok & ~force_inf
    x = torch.where(emit_ok, h, inf)

    # run(t): consecutive valid BASES ending at t
    last_bad = torch.cummax(torch.where(valid_base, -1, pos), dim=1).values
    run = pos - last_bad

    # m(t), M(t): minimum value and LATEST-tie argmin over [t-w+1, t]
    m = x
    for d in range(1, w):
        m = torch.minimum(m, _shifted_back(x, d, inf))
    # latest tie = smallest lookback d with x[t-d] == m(t)
    M = torch.full((B, L), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(w):
        hit = (~found) & (_shifted_back(x, d, inf) == m)
        M = torch.where(hit, pos - d, M)
        found = found | hit

    m1 = _shifted_back(m, 1, inf)  # m(t-1)
    M1 = _shifted_back(M, 1, -2)  # M(t-1)

    condA = run == (w + k - 1)
    condB = (x <= m1) & (run >= (w + k))
    condCt = (M1 == pos - w) & (x > m1) & (run >= (w + k - 1))

    emitted = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(1, w + 1):
        M1_d = _shifted_fwd(M1, d, -2)
        emitted = emitted | (_shifted_fwd(condB, d, False) & (M1_d == pos))  # B
        if d < w:
            tA = _shifted_fwd(condA, d, False)
            tCt = _shifted_fwd(condCt, d, False)
            m1_d = _shifted_fwd(m1, d, inf)
            m_d = _shifted_fwd(m, d, inf)
            M_d = _shifted_fwd(M, d, -2)
            emitted = emitted | (tA & (x == m1_d) & (M1_d != pos))  # A
            emitted = emitted | (tCt & (x == m_d) & (M_d != pos))  # Ct
        else:
            emitted = emitted | (_shifted_fwd(condCt, w, False) & (M1_d == pos))  # Cp

    # D: final flush at each read's true end — emit M(len-1)
    at_end = pos == (lengths[:, None] - 1)
    M_end = torch.where(at_end, M, -1).amax(dim=-1, keepdim=True)
    emitted = emitted | (pos == M_end)

    emitted = emitted & emit_ok & (pos < lengths[:, None])
    return {"minimizer": emitted, "key": x, "strand": z.to(torch.uint8)}


def sketch_compact(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                   w: int, max_minimizers: int,
                   force_inf: torch.Tensor | None = None,
                   pos_map: torch.Tensor | None = None,
                   spans: torch.Tensor | None = None):
    """Sketch + on-device compaction into fixed-width [B, M] slot tensors.

    Returns dict n [B] and key (int64) / pos / strand / span [B, M];
    slots >= n are invalid (key = inf_key(k), pos = -1, strand = span =
    0).  Emitted minimizers past M are dropped: they scatter into an
    extra column M that is cut off (torch raises on out-of-range
    indices where jax's ``mode="drop"`` drops them).  For HPC sketching
    the caller passes compressed codes and lengths plus ``pos_map``
    (uncompressed END position per symbol), ``spans`` and ``force_inf``
    (span >= 256).
    """
    s = sketch(codes, lengths, k, w, force_inf)
    B, L = codes.shape
    M = max_minimizers
    dev = codes.device
    emitted = s["minimizer"]
    slot = torch.cumsum(emitted.to(torch.int64), dim=-1) - 1
    slot = torch.where(emitted & (slot < M), slot, M)  # overflow -> dropped
    n = torch.clamp(emitted.sum(dim=-1, dtype=torch.int32), max=M)

    def scatter(src: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((B, M + 1), fill, dtype=src.dtype, device=dev)
        return out.scatter_(1, slot, src)[:, :M]

    if pos_map is None:
        pos = torch.arange(L, dtype=torch.int64, device=dev).expand(B, L)
    else:
        pos = pos_map.to(torch.int64)
    pos_o = scatter(pos, -1)
    strand = scatter(s["strand"].to(torch.int64), 0)
    if spans is None:
        span = torch.where(pos_o >= 0, k, 0)
    else:
        span = scatter(spans.to(torch.int64), 0)
    return {
        "n": n,
        "key": scatter(s["key"], inf_key(k)),
        "pos": pos_o.to(torch.int32),
        "strand": strand.to(torch.uint8),
        "span": span.to(torch.int32),
    }
