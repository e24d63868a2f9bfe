"""Kernel K2 — top-K chain extraction from the chaining DP.

Port of the JAX package's ops/backtrack_pallas.py
``backtrack_chains_pallas`` (minimap2's mm_chain_backtrack, K-pass
capped): ``backtrack_chains`` sends a CUDA tensor to the hand-written
kernel (csrc/backtrack.cu) and a CPU tensor to the plain version in
this module, ``backtrack_chains_plain``.  No fallback between the two.

Semantics (both versions): candidate ends are valid anchors with
f >= min_sc, taken best first, larger index on ties.  Each pass walks p
from its end marking anchors used, and stops at a used anchor (a join)
or a chain start.  score = f[end] - f[join] (0 without a join); the
chain is written to row k of [B, K, 9 + 2*seg_cuts] iff cnt >= min_cnt
and score >= min_sc, and a rejected walk still consumes its anchors.
Up to seg_cuts (qpos, rpos) pairs are recorded end->start, each at
least SEG_LEN query bases below the last.  Indices outside [0, A) read
as 0 and the walk is capped at A steps, as in the Pallas kernel.
Unwritten rows are all -1.
"""
from __future__ import annotations

import torch

from . import cuda_build

NEG = -(1 << 30)
SEG_LEN = 384  # query spacing between cuts (= pipeline SEG_LEN)
N_FIXED = 9
MAX_CUTS = 8  # the kernel's per-walk cut buffer

#: kernel launches since the last reset (plain-version calls not counted;
#: a call inside a CUDA-graph capture launches nothing and is not
#: counted, and each replay of the graph is credited with its launches)
launches = 0


def credit(n: int) -> None:
    """Count n launches made by replaying a captured CUDA graph."""
    global launches
    launches += n


_FIELDS = ("rev", "rid", "rpos", "qpos", "span")


def backtrack_chains_plain(anchors: dict, f: torch.Tensor, p: torch.Tensor,
                           K: int, seg_cuts: int, min_cnt: int, min_sc: int):
    """Plain torch version, vectorized over the batch like the Pallas
    body.  Returns int32 [B, K, 9 + 2*seg_cuts]."""
    B, A = f.shape
    dev = f.device
    FLD = N_FIXED + 2 * seg_cuts
    f = f.to(torch.int64)
    p = p.to(torch.int64)
    fields = {n: anchors[n].to(torch.int64) for n in _FIELDS}
    ok = anchors["valid"]
    lane = torch.arange(A, device=dev)
    used = torch.zeros((B, A), dtype=torch.int64, device=dev)
    out = torch.full((B, K, FLD), -1, dtype=torch.int64, device=dev)

    def col(v, idx):  # v[b, idx[b]], 0 where idx is outside [0, A)
        inr = (idx >= 0) & (idx < A)
        g = torch.gather(v, 1, idx.clamp(0, A - 1)[:, None])[:, 0]
        return torch.where(inr, g, 0)

    for kk in range(K):
        fc = torch.where(ok & (f >= min_sc) & (used == 0), f, NEG)
        best = fc.amax(dim=1)
        active0 = best > NEG
        if not bool(active0.any()):
            break  # no candidate now, none later (used only grows)
        endv = torch.where(fc == best[:, None], lane, -1).amax(dim=1)
        q_end = col(fields["qpos"], endv)
        cur = torch.where(active0, endv, -1)
        alive = active0.clone()
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        cnt, join_f, n_cuts = zero.clone(), zero.clone(), zero.clone()
        q_first, r_first, sp_first = zero.clone(), zero.clone(), zero.clone()
        next_cut = q_end - SEG_LEN
        # two spare columns take the writes of walks that do not cut
        cuts = torch.full((B, 2 * seg_cuts + 2), -1, dtype=torch.int64,
                          device=dev)
        for _ in range(A):
            if not bool(alive.any()):
                break
            used = torch.where(
                alive[:, None] & (lane[None, :] == cur[:, None]), 1, used
            )
            qp = col(fields["qpos"], cur)
            rp = col(fields["rpos"], cur)
            q_first = torch.where(alive, qp, q_first)
            r_first = torch.where(alive, rp, r_first)
            sp_first = torch.where(alive, col(fields["span"], cur), sp_first)
            cnt = cnt + alive.to(torch.int64)
            do_cut = alive & (qp <= next_cut) & (n_cuts < seg_cuts)
            slot = torch.where(do_cut, 2 * n_cuts, 2 * seg_cuts)
            cuts.scatter_(1, slot[:, None], qp[:, None])
            cuts.scatter_(1, slot[:, None] + 1, rp[:, None])
            n_cuts = n_cuts + do_cut.to(torch.int64)
            next_cut = torch.where(do_cut, qp - SEG_LEN, next_cut)
            nxt = col(p, cur)
            nxt_used = col(used, nxt) > 0
            join_f = torch.where(alive & (nxt >= 0) & nxt_used,
                                 col(f, nxt), join_f)
            alive = alive & (nxt >= 0) & ~nxt_used
            cur = torch.where(alive, nxt, -1)
        sc = col(f, endv) - join_f
        keep = active0 & (cnt >= min_cnt) & (sc >= min_sc)
        vals = torch.stack(
            [sc, cnt, col(fields["rev"], endv), col(fields["rid"], endv),
             r_first, col(fields["rpos"], endv), q_first, q_end, sp_first],
            dim=1,
        )
        vals = torch.cat([vals, cuts[:, : 2 * seg_cuts]], dim=1)
        out[:, kk] = torch.where(keep[:, None], vals, -1)
    return out.to(torch.int32)


#: anchors of one walk chunk (csrc/backtrack.cu CHUNK)
CHUNK = 32


def smem_bytes(A: int) -> int:
    """Shared memory the kernel needs: the `used` bitmask (one bit per
    anchor) and the walk's chunk buffer.  p is staged too when it fits
    (csrc/backtrack.cu)."""
    return ((A + 31) // 32 + CHUNK) * 4


def backtrack_fits(A: int) -> bool:
    """Whether the kernel takes A anchors per read: the bitmask and the
    chunk buffer fit a block's shared memory (A <= 1,858,560)."""
    return 0 <= A and smem_bytes(A) <= cuda_build.SMEM_LIMIT


def _check(anchors: dict, f: torch.Tensor, p: torch.Tensor, seg_cuts: int):
    if f.dim() != 2:
        raise ValueError(f"f must be [B, A], got {tuple(f.shape)}")
    if not 0 <= seg_cuts <= MAX_CUTS:
        raise ValueError(f"seg_cuts={seg_cuts} outside [0, {MAX_CUTS}]")
    named = {"f": f, "p": p, "valid": anchors["valid"]}
    named.update({n: anchors[n] for n in _FIELDS})
    for name, t in named.items():
        want = torch.bool if name == "valid" else torch.int32
        if t.dtype != want or t.shape != f.shape or t.device != f.device:
            raise ValueError(
                f"{name}: want {want} {tuple(f.shape)} on {f.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def backtrack_chains(anchors: dict, f: torch.Tensor, p: torch.Tensor,
                     K: int, seg_cuts: int, min_cnt: int, min_sc: int):
    """Top-K chains per read from the chain DP; int32 [B, K, 9+2*cuts]."""
    global launches
    _check(anchors, f, p, seg_cuts)
    cuda_build.note("backtrack_chains")
    dev = f.device
    if dev.type == "cpu":
        return backtrack_chains_plain(anchors, f, p, K, seg_cuts, min_cnt,
                                      min_sc)
    if dev.type != "cuda":
        raise ValueError(f"backtrack_chains: unsupported device {dev}")
    B, A = f.shape
    if not backtrack_fits(A):
        raise ValueError(
            f"backtrack_chains: A={A} anchors need {smem_bytes(A)} bytes of "
            f"shared memory, over the {cuda_build.SMEM_LIMIT} a block may use"
        )
    out = torch.empty((B, K, N_FIXED + 2 * seg_cuts), dtype=torch.int32,
                      device=dev)
    if B == 0 or A == 0 or K == 0:
        return out.fill_(-1)
    lib = cuda_build.load()
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = lib.backtrack_chains(
            f.data_ptr(), p.data_ptr(), anchors["valid"].data_ptr(),
            *(anchors[n].data_ptr()
              for n in ("rev", "rid", "rpos", "qpos", "span")),
            B, A, K, seg_cuts, int(min_cnt), int(min_sc),
            cuda_build.SMEM_LIMIT, out.data_ptr(),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check(err, "backtrack_chains")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out
