"""A plain count of the seed anchors each read has: minimap2's minimizer
sketch of the genome and of the reads, in plain torch, and the genome's
count of each read minimizer, up to mid_occ.

From minimap2's definitions (Li 2018, "Minimap2: pairwise alignment for
nucleotide sequences", section 2.1; sketch.c ``hash64``, ``mm_sketch``;
index.c ``mm_idx_cal_max_occ``): a k-mer's key is the invertible hash of
the smaller of its 2-bit code and its reverse complement's; a position
is a minimizer when its key is the least of some window of w
consecutive k-mers within one sequence (every position that ties the
least is one); mid_occ is the genome's count of keys at the (1 - frac)
quantile of its distinct keys, plus one, clamped to [min, max]; a read
minimizer whose key occurs more often than mid_occ seeds nothing.  The
anchors of a read are the genome's occurrences of its minimizers' keys.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

#: genome positions sketched per step
CHUNK = 1 << 24
#: read bases sketched per step
READ_CHUNK = 1 << 23
_BIG = 1 << 62


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def minimizer_keys(codes: torch.Tensor, seq_id: torch.Tensor, k: int,
                   w: int):
    """(keys, positions, sequence ids) of the minimizers of sequences
    laid end to end (`seq_id` per base; a k-mer or a window may not
    span two)."""
    n = len(codes) - k + 1
    if n < w:
        empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return empty, empty, seq_id[:0]
    c = codes.to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[j:j + n]
        rev = rev | ((3 - c[j:j + n]) << (2 * j))
    ok = (seq_id[:n] == seq_id[k - 1:k - 1 + n]) & (fwd != rev)
    ok &= (c.unfold(0, k, 1) < 4).all(1)
    h = torch.where(ok, hash64(torch.minimum(fwd, rev), (1 << 2 * k) - 1),
                    torch.full_like(fwd, _BIG))
    nw = n - w + 1
    win_min = h.unfold(0, w, 1).min(1).values
    win_ok = seq_id[:nw] == seq_id[w - 1 + k - 1:w - 1 + k - 1 + nw]
    is_min = torch.zeros(n, dtype=torch.bool, device=codes.device)
    for j in range(w):
        is_min[j:j + nw] |= win_ok & (h[j:j + nw] == win_min) & ok[j:j + nw]
    pos = torch.nonzero(is_min).squeeze(1)
    return h[pos], pos, seq_id[pos]


def genome_counts(genome, k: int, w: int, device):
    """(sorted distinct minimizer keys of the genome, their counts).
    Each step sketches CHUNK positions with the w - 1 bases before them
    and the w + k after, and keeps the minimizers among its own."""
    dev = torch.device(device)
    keys = []
    for _name, codes in genome.contigs():
        L, start = len(codes), 0
        while start < L:
            lo, hi = max(start - w + 1, 0), min(start + CHUNK + w + k, L)
            part = torch.from_numpy(np.ascontiguousarray(codes[lo:hi]))
            kk, pos, _ = minimizer_keys(part.to(dev), torch.zeros(
                hi - lo, dtype=torch.int32, device=dev), k, w)
            mine = (pos + lo >= start) & (pos + lo < start + CHUNK)
            keys.append(kk[mine])
            start += CHUNK
    return torch.unique(torch.cat(keys), return_counts=True)


def mid_occ(counts: torch.Tensor, frac: float, lo: int, hi: int) -> int:
    n = len(counts)
    if frac <= 0 or n == 0:
        return hi
    srt = torch.sort(counts.cpu()).values
    thres = int(srt[min(int((1.0 - frac) * n), n - 1)]) + 1
    return max(lo, min(thres, hi))


def read_anchors(reads: Sequence[str], keys: torch.Tensor,
                 counts: torch.Tensor, occ: int, k: int, w: int,
                 device) -> np.ndarray:
    """Each read's anchor count (int64 [len(reads)])."""
    from .records import encode

    dev = torch.device(device)
    keys, counts = keys.to(dev), counts.to(dev)
    out = np.zeros(len(reads), np.int64)
    at = 0
    while at < len(reads):
        group: List[np.ndarray] = []
        n_bp = 0
        while at + len(group) < len(reads) and (not group
                                                 or n_bp < READ_CHUNK):
            group.append(encode(reads[at + len(group)]))
            n_bp += len(group[-1])
        codes = torch.from_numpy(np.concatenate(group)).to(dev)
        sid = torch.repeat_interleave(
            torch.arange(len(group), dtype=torch.int32),
            torch.tensor([len(g) for g in group])).to(dev)
        h, _pos, rid = minimizer_keys(codes, sid, k, w)
        pos = torch.searchsorted(keys, h).clamp(max=max(len(keys) - 1, 0))
        c = torch.where((keys[pos] == h) if len(keys) else
                        torch.zeros_like(h, dtype=torch.bool),
                        counts[pos], torch.zeros_like(h))
        c = torch.where(c <= occ, c, torch.zeros_like(c))
        per = torch.zeros(len(group), dtype=torch.int64, device=dev)
        per.index_add_(0, rid.to(torch.int64), c.to(torch.int64))
        out[at:at + len(group)] = per.cpu().numpy()
        at += len(group)
    return out


def anchors_by_read(reads: Sequence[str], genome, seeding: Dict,
                    device) -> np.ndarray:
    """Each read's anchors against the genome, under the preset's
    seeding (k, w, mid_occ_frac, min_mid_occ, max_mid_occ)."""
    k, w = int(seeding["k"]), int(seeding["w"])
    keys, counts = genome_counts(genome, k, w, device)
    occ = mid_occ(counts, float(seeding["mid_occ_frac"]),
                  int(seeding["min_mid_occ"]), int(seeding["max_mid_occ"]))
    return read_anchors(reads, keys, counts, occ, k, w, device)
