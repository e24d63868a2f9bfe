"""Kernel K4 — the traceback of K3's direction bytes on the device of the
direction tensor (csrc/traceback.cu), and its plain torch version.

Port of the JAX package's ops/traceback_pallas.py ``traceback_pallas``.
``traceback_plain`` is written as that kernel is: one backward sweep
over the anti-diagonals for all J jobs at once, where each job moves
when the sweep reaches its current cell (a match consumes two
diagonals, a gap op one, a gap-state entry none).  The CUDA kernel walks
each job in turn, which visits the same cells in the same order (a warp
per job, a run of matches or gap ops at a time, from slabs of diagonals
staged in shared memory).  A CUDA tensor goes to the kernel, a CPU
tensor to the plain version; there is no fallback between the two.

Outputs: ``ops`` int32 [J, OPS], runs ``len<<4|op`` (0 M, 1 I, 2 D) in
END->START order, -1 padded; ``info`` int32 [J, 8], columns n_ops,
final_i, final_j, score, started, overflow, start_i, start_j.  The
caller adds the leading border gaps (final_j+1 D, final_i+1 I) and
re-runs jobs whose overflow is set.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build
from .extend import NEG

OP_M, OP_I, OP_D = 0, 1, 2

#: kernel launches since the last reset (plain-version calls not counted;
#: a call inside a CUDA-graph capture launches nothing and is not
#: counted, and each replay of the graph is credited with its launches)
launches = 0


def credit(n: int) -> None:
    """Count n launches made by replaying a captured CUDA graph."""
    global launches
    launches += n

#: direction bytes per slab that K4 copies into shared memory for one
#: walk (csrc/traceback.cu); two slabs per job, TB_JOBS jobs per block.
#: 0 walks device memory directly (no slabs).
SLAB_BYTES = 16384
TB_JOBS = 4  # csrc/traceback.cu TB_JOBS


def slab_depth(W: int) -> int:
    """K4's diagonals per slab at band width W: about SLAB_BYTES, at
    least 2 (a walk step lowers i + j by at most 2, so no slab is
    skipped); 0 (walk device memory directly) when SLAB_BYTES is 0 or
    two slabs per job of a block do not fit in shared memory.  The kernel
    also walks device memory directly where W is no multiple of 16 (its
    slab copies move 16 bytes at a time; the pipeline's bands are
    multiples of 32)."""
    if SLAB_BYTES <= 0:
        return 0
    D = max(2, SLAB_BYTES // W)
    return D if TB_JOBS * 2 * D * W <= cuda_build.SMEM_LIMIT else 0


def start_cells(best: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
                mode: torch.Tensor, end_bonus: int):
    """Per-job start cell (i0, j0), score and active flag (the JAX
    pipeline's host rule).  Mode 0 (global, mid segments): the end cell
    (qlen-1, tlen-1) with end_sc, active when it was reached in the band.
    Mode 1 (extension, flanks): the last-row best (qlen-1, g_j) when
    g_sc + end_bonus >= best_sc and g_sc > 0, else the best cell, active
    when either score is positive."""
    best_sc, best_i, best_j, g_sc, g_j, end_sc = best.unbind(1)
    use_end = (g_sc > NEG // 2) & (g_sc + end_bonus >= best_sc) & (g_sc > 0)
    glob = mode == 0
    i0 = torch.where(glob | use_end, qlen - 1, best_i)
    j0 = torch.where(glob, tlen - 1, torch.where(use_end, g_j, best_j))
    sc0 = torch.where(glob, end_sc, torch.where(use_end, g_sc, best_sc))
    act = torch.where(glob, end_sc > NEG // 2, use_end | (best_sc > 0))
    return i0, j0, sc0, act


def traceback_plain(
    dirs: torch.Tensor,  # uint8 [S, J, >= W]
    best: torch.Tensor,  # int32 [J, 6] (K3's trackers, ops/extend.py BEST_COLS)
    qlen: torch.Tensor,  # int32 [J]
    tlen: torch.Tensor,  # int32 [J]
    mode: torch.Tensor,  # int32 [J]: 0 global, 1 extension
    W: int,
    OPS: int,
    end_bonus: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch traceback: returns (ops [J, OPS], info [J, 8])."""
    S, J, _ = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    i, jj, sc0, act = start_cells(best.to(i32), qlen.to(i32), tlen.to(i32),
                                  mode.to(i32), end_bonus)
    i0, j0 = i.clone(), jj.clone()
    st = torch.zeros(J, dtype=i32, device=dev)
    n_ops = torch.zeros_like(st)
    cur_op = torch.full_like(st, -1)
    cur_len = torch.zeros_like(st)
    ovf = torch.zeros_like(st)
    out = torch.full((J, OPS), -1, dtype=i32, device=dev)
    lane_o = torch.arange(OPS, device=dev)[None, :]
    rows = torch.arange(J, device=dev)

    def flush_runs(flush, n_ops, cur_op, cur_len, out, ovf):
        slot = torch.where(flush & (n_ops < OPS), n_ops, -1)
        out = torch.where(lane_o == slot[:, None],
                          ((cur_len << 4) | cur_op)[:, None], out)
        ovf = torch.where(flush & (n_ops >= OPS), 1, ovf)
        return n_ops + flush.to(i32), out, ovf

    def emit(op, mask, n_ops, cur_op, cur_len, out, ovf):
        same = mask & (cur_op == op)
        cur_len = torch.where(same, cur_len + 1, cur_len)
        new_run = mask & ~same
        n_ops, out, ovf = flush_runs(new_run & (cur_len > 0), n_ops, cur_op,
                                     cur_len, out, ovf)
        cur_op = torch.where(new_run, op, cur_op)
        cur_len = torch.where(new_run, 1, cur_len)
        return n_ops, cur_op, cur_len, out, ovf

    for s in range(S - 1, -1, -1):  # descending sweep
        lo = max(s // 2 - W // 2 + 1, 0)
        drow = dirs[s]

        def read_byte(i_cur):
            d = i_cur - lo
            inb = (d >= 0) & (d < W)
            v = drow[rows, d.clamp(0, W - 1).long()].to(i32)
            return torch.where(inb, v, 0)

        # substep 1: state H — a match move or a gap-state entry
        on = act & (i + jj == s)
        act1 = on & (st == 0)
        src = read_byte(i) & 7
        is_m = act1 & (src == 0)
        n_ops, cur_op, cur_len, out, ovf = emit(
            OP_M, is_m, n_ops, cur_op, cur_len, out, ovf)
        i = torch.where(is_m, i - 1, i)
        jj = torch.where(is_m, jj - 1, jj)
        st = torch.where(act1 & (src != 0), src, st)

        # substep 2: a gap state — one gap op on the current cell
        act2 = act & (i + jj == s) & (st != 0)
        byte = read_byte(i)
        is_e = act2 & (st <= 2) & (st >= 1)
        is_f = act2 & (st >= 3)
        n_ops, cur_op, cur_len, out, ovf = emit(
            OP_D, is_e, n_ops, cur_op, cur_len, out, ovf)
        n_ops, cur_op, cur_len, out, ovf = emit(
            OP_I, is_f, n_ops, cur_op, cur_len, out, ovf)
        e_bit = torch.where(st == 1, byte & 0x08, byte & 0x10)
        f_bit = torch.where(st == 3, byte & 0x20, byte & 0x40)
        jj = torch.where(is_e, jj - 1, jj)
        i = torch.where(is_f, i - 1, i)
        st = torch.where(is_e & (e_bit == 0), 0,
                         torch.where(is_f & (f_bit == 0), 0, st))
        act = act & (i >= 0) & (jj >= 0)

    n_ops, out, ovf = flush_runs(cur_len > 0, n_ops, cur_op, cur_len, out, ovf)
    started = (sc0 > NEG // 2) & (n_ops > 0)
    info = torch.stack([n_ops, i, jj, sc0, started.to(i32), ovf, i0, j0], 1)
    return out, info.to(i32)


def traceback_device(dirs, best, qlen, tlen, mode, W: int, OPS: int,
                     end_bonus: int):
    """K4 on the device of `dirs`: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (ops [J, OPS], info [J, 8])."""
    global launches
    S, J, Wd = dirs.shape
    dev = dirs.device
    if J:
        cuda_build.note("traceback")
    if dev.type == "cpu":
        return traceback_plain(dirs, best, qlen, tlen, mode, W, OPS, end_bonus)
    if dev.type != "cuda":
        raise ValueError(f"traceback_device: unsupported device {dev}")
    if dirs.dtype != torch.uint8 or Wd != W or not dirs.is_contiguous():
        raise ValueError(
            f"dirs must be contiguous uint8 [S, J, {W}], got {dirs.dtype} "
            f"{tuple(dirs.shape)}")
    if best.shape != (J, 6):
        raise ValueError(f"best must be [J, 6], got {tuple(best.shape)}")
    for name, x in (("best", best), ("qlen", qlen), ("tlen", tlen),
                    ("mode", mode)):
        if x.dtype != torch.int32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    if qlen.shape != (J,) or tlen.shape != (J,) or mode.shape != (J,):
        raise ValueError("qlen, tlen and mode must be [J]")
    ops = torch.empty((J, OPS), dtype=torch.int32, device=dev)
    info = torch.empty((J, 8), dtype=torch.int32, device=dev)
    if J == 0:
        return ops, info
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.traceback_walk(
            dirs.data_ptr(), best.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), mode.data_ptr(), S, J, W, OPS, int(end_bonus),
            slab_depth(W), ops.data_ptr(), info.data_ptr(),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check(err, "traceback_walk")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return ops, info
