"""Anchor chaining DP (minimap2's ``mm_chain_dp``), plain torch version.

``chain_scores`` is the plain version of kernel K1
(ops/chain_kernel.py, csrc/chain.cu): the fixed-window recurrence of
the JAX package's ops/chain.py ``chain_scores`` / ops/chain_pallas.py
``chain_scores_pallas``, vectorized over the batch and stepping over
anchor slots in a Python loop.

  f[i] = max(span_i, max_j f[j] + sc(j, i)),  j in [i - H, i)

``sc`` is comput_sc: same strand and contig, 0 < dq <= max_dist,
0 < dr <= max_dist_x, |dr - dq| <= bw, gain min(dg, span_j) and a
float32 gap penalty with minimap2's bit-trick log2, truncated to int.
p[i] is the largest j attaining the max, set only when it beats span_i.

Float arithmetic is float32 with every operation rounded on its own
(torch runs each op as its own kernel, so nothing is fused into an
FMA); the CUDA kernel is compiled without contraction to match.

``chain_scores_block`` is the JAX package's block formulation of the
same recurrence (its ops/chain.py ``chain_scores_block``), which decision
mode (parallel/mesh.py ``build_sharded_map_step``) chains with: anchor
blocks of C, predecessors [1, 2C) back.  It is an XLA computation there,
not a Pallas kernel, so it stays plain torch here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -(1 << 30)


def f32(x: float) -> float:
    """The float32 rounding of a Python float (what JAX's weak typing
    uses for a Python constant in float32 arithmetic)."""
    return float(np.float32(x))


def mg_log2(x: torch.Tensor) -> torch.Tensor:
    """minimap2's approximate log2 (float bit trick) of float32 x >= 1."""
    z = x.to(torch.float32).view(torch.int32)
    log_2 = ((z >> 23) & 255) - 128
    zf = ((z & ~(255 << 23)) + (127 << 23)).view(torch.float32)
    return log_2.to(torch.float32) + (
        (f32(-0.34484843) * zf + f32(2.02466578)) * zf - f32(0.67487759)
    )


class ChainParams(NamedTuple):
    max_dist_x: int  # ref-gap bound (opt.max_gap / max_gap_ref)
    max_dist_y: int  # query-gap bound (opt.max_gap)
    bw: int
    q_span: int
    chn_pen_gap: float
    chn_pen_skip: float
    # comput_sc's is_cdna branch (MM_F_SPLICE): a reference gap larger
    # than the query gap costs min(lin_pen, log_pen)
    is_splice: int = 0


def _gap_pen(dr, dq, dd, dg, p: ChainParams) -> torch.Tensor:
    """comput_sc's gap penalty (int-truncated), incl. the splice branch."""
    lin_pen = f32(p.chn_pen_gap) * dd.to(torch.float32) + (
        f32(p.chn_pen_skip) * dg.to(torch.float32)
    )
    log_pen = torch.where(
        dd >= 1, mg_log2((dd + 1).to(torch.float32)), 0.0
    )
    pen = (lin_pen + 0.5 * log_pen).to(torch.int32)
    if p.is_splice:
        pen = torch.where(
            dr > dq, torch.minimum(lin_pen, log_pen).to(torch.int32), pen
        )
    return pen


def _pair_scores(ai: dict, aj: dict, p: ChainParams) -> torch.Tensor:
    """comput_sc for anchor pairs; ai fields [B, 1], aj fields [B, H]."""
    dq = ai["qpos"] - aj["qpos"]
    dr = ai["rpos"] - aj["rpos"]
    ok = (
        (ai["rev"] == aj["rev"])
        & (ai["rid"] == aj["rid"])
        & aj["valid"]
        & (dq > 0)
        & (dq <= p.max_dist_x)
        & (dq <= p.max_dist_y)
        & (dr > 0)
        & (dr <= p.max_dist_x)
    )
    dd = (dr - dq).abs()
    ok = ok & (dd <= p.bw)
    dg = torch.minimum(dr, dq)
    span_j = aj["span"]
    sc = torch.minimum(dg, span_j)
    pen = _gap_pen(dr, dq, dd, dg, p)
    sc = torch.where((dd != 0) | (dg > span_j), sc - pen, sc)
    return torch.where(ok, sc, NEG_INF)


def chain_scores(anchors: dict, params: ChainParams, window: int = 128):
    """Windowed chaining DP over sorted anchors (K1's plain version).

    anchors: dict of [B, A] tensors rev/rid/rpos/qpos/span (int) and
    valid (bool).  The predecessor window is the `window` anchors
    before each anchor.  Returns int32 f, p [B, A] (f = NEG_INF and
    p = -1 on invalid anchors)."""
    rpos = anchors["rpos"]
    B, A = rpos.shape
    H = window
    dev = rpos.device

    def pad(x, fill):
        x = x.to(torch.int32) if x.dtype != torch.bool else x
        return torch.cat(
            [torch.full((B, H), fill, dtype=x.dtype, device=dev), x], dim=1
        )

    prev = {
        "rev": pad(anchors["rev"], 0),
        "rid": pad(anchors["rid"], 0),
        "rpos": pad(anchors["rpos"], 0),
        "qpos": pad(anchors["qpos"], 0),
        "valid": pad(anchors["valid"], False),
        "span": pad(anchors["span"], 0),
    }
    f_pad = torch.full((B, A + H), NEG_INF, dtype=torch.int32, device=dev)
    p_out = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(H, dtype=torch.int32, device=dev)
    for i in range(A):
        # padded slots [i, i+H) = original predecessors [i-H, i)
        win = {k: v[:, i : i + H] for k, v in prev.items()}
        ai = {k: v[:, i + H : i + H + 1] for k, v in prev.items()}
        sc = _pair_scores(ai, win, params)
        f_win = f_pad[:, i : i + H]
        tot = torch.where(sc > NEG_INF, f_win + sc, NEG_INF)
        best = tot.amax(dim=1)
        # largest-j tie-break
        arg = torch.where(tot == best[:, None], lanes, -1).amax(dim=1)
        span_i = ai["span"][:, 0]
        valid_i = ai["valid"][:, 0]
        take = best > span_i  # strict: minimap2's `sc > max_f` vs init
        f_i = torch.where(take, best, span_i)
        f_pad[:, i + H] = torch.where(valid_i, f_i, NEG_INF)
        p_out[:, i] = torch.where(take & valid_i, i - H + arg, -1)
    return f_pad[:, H:].contiguous(), p_out


def _pair_scores_grid(cur: dict, win: dict, p: ChainParams) -> torch.Tensor:
    """comput_sc with broadcasting: cur fields [..., 1, C] against win
    fields [..., 2C, 1] (any mutually broadcastable shapes)."""
    dq = cur["qpos"] - win["qpos"]
    dr = cur["rpos"] - win["rpos"]
    ok = (
        (cur["rev"] == win["rev"])
        & (cur["rid"] == win["rid"])
        & win["valid"]
        & cur["valid"]
        & (dq > 0)
        & (dq <= p.max_dist_x)
        & (dq <= p.max_dist_y)
        & (dr > 0)
        & (dr <= p.max_dist_x)
    )
    dd = (dr - dq).abs()
    ok = ok & (dd <= p.bw)
    dg = torch.minimum(dr, dq)
    span_j = win["span"]
    sc = torch.minimum(dg, span_j)
    pen = _gap_pen(dr, dq, dd, dg, p)
    sc = torch.where((dd != 0) | (dg > span_j), sc - pen, sc)
    return torch.where(ok, sc, NEG_INF)


def chain_scores_block(anchors: dict, params: ChainParams, block: int = 32):
    """Block max-plus chaining DP over sorted [B, A] anchors.

    The sequential dimension is anchor blocks of C = `block`: every
    pairwise edge score of a block against its window (the previous
    block and itself, 2C anchors) is computed at once as a
    [n_blocks, B, 2C, C] grid; each block then takes the previous
    block's contribution as one max-plus product and closes its
    in-block dependencies with C-1 Bellman rounds.  p[i] is the
    largest j of the window with f[j] + sc(j, i) == f[i], -1 where
    f[i] is the anchor's own span.  Without a "span" field every
    anchor spans ``params.q_span``.  Returns int32 f, p [B, A]."""
    rpos = anchors["rpos"]
    B, A = rpos.shape
    dev = rpos.device
    C = block
    NB = (A + C - 1) // C
    A_pad = NB * C
    span = anchors.get("span")
    if span is None:
        span = torch.full_like(rpos, params.q_span)

    def blocks_of(x, fill):
        """[B, A] -> cur [NB, B, C] and win [NB, B, 2C] (the previous
        block, then the block itself)."""
        xp = torch.cat([
            torch.full((B, C), fill, dtype=x.dtype, device=dev), x,
            torch.full((B, A_pad - A), fill, dtype=x.dtype, device=dev),
        ], dim=1)
        cur = xp[:, C:].reshape(B, NB, C).movedim(1, 0)
        prev = xp[:, :A_pad].reshape(B, NB, C).movedim(1, 0)
        return cur, torch.cat([prev, cur], dim=2)

    cur_f, win_f = {}, {}
    for name, x in (("rev", anchors["rev"]), ("rid", anchors["rid"]),
                    ("rpos", rpos), ("qpos", anchors["qpos"]),
                    ("span", span)):
        cur_f[name], win_f[name] = blocks_of(x.to(torch.int32), 0)
    cur_f["valid"], win_f["valid"] = blocks_of(anchors["valid"], False)
    # edge grid [NB, B, 2C, C]: rows = window anchors, columns = block
    E = _pair_scores_grid(
        {k: v[:, :, None, :] for k, v in cur_f.items()},
        {k: v[:, :, :, None] for k, v in win_f.items()},
        params,
    )
    init = torch.where(cur_f["valid"], cur_f["span"], NEG_INF)
    rows = torch.arange(2 * C, dtype=torch.int32, device=dev)[None, :, None]
    f_prev = torch.full((B, C), NEG_INF, dtype=torch.int32, device=dev)
    f_blocks, p_blocks = [], []
    for b in range(NB):
        E_b = E[b]
        ok = E_b > NEG_INF
        prev_tot = torch.where(ok[:, :C], f_prev[:, :, None] + E_b[:, :C],
                               NEG_INF).amax(dim=1)
        F = torch.maximum(init[b], prev_tot)
        M, okM = E_b[:, C:], ok[:, C:]
        for _ in range(C - 1):
            hop = torch.where(okM, F[:, :, None] + M, NEG_INF).amax(dim=1)
            F = torch.maximum(F, hop)
        # predecessor: the largest window row reaching F
        f_win = torch.cat([f_prev, F], dim=1)
        tot = torch.where(ok, f_win[:, :, None] + E_b, NEG_INF)
        hit = (tot == F[:, None, :]) & (F[:, None, :] > cur_f["span"][b][:, None, :])
        r = torch.where(hit, rows, -1).amax(dim=1)
        p_blocks.append(torch.where(r >= 0, b * C - C + r, -1))
        f_blocks.append(F)
        f_prev = F
    f = torch.cat(f_blocks, dim=1)[:, :A]
    p = torch.cat(p_blocks, dim=1)[:, :A]
    valid = anchors["valid"]
    f = torch.where(valid, f, NEG_INF)
    p = torch.where(valid & (p < A), p, -1)
    return f.to(torch.int32), p.to(torch.int32)
