"""Kernel K1 — the chaining DP on the card (csrc/chain.cu).

Port of the JAX package's ops/chain_pallas.py ``chain_scores_pallas``.
A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version, ops/chain.py ``chain_scores``.  There is no fallback
between the two: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .chain import ChainParams, chain_scores

C = 128  # window granule, as the Pallas kernel's 128-anchor blocks

#: kernel launches since the last reset (plain-version calls not counted;
#: a call inside a CUDA-graph capture launches nothing and is not
#: counted, and each replay of the graph is credited with its launches)
launches = 0


def credit(n: int) -> None:
    """Count n launches made by replaying a captured CUDA graph."""
    global launches
    launches += n


def window_of(window: int) -> int:
    """Predecessor window actually used: ceil(window/128)*128, >= 128."""
    return max(1, (window + C - 1) // C) * C


#: largest predecessor window the kernel takes: 32 slots of 32 anchors
#: (the consumer's register ring; the score tiles' 135 KB of shared memory)
MAX_WINDOW = 1024
#: largest A: anchor indices are int32 in the kernel
MAX_ANCHORS = (1 << 31) - 64


def chain_fits(A: int, window: int = C) -> bool:
    """Whether the kernel takes A anchors per read at this window.  It
    keeps only the window (f in registers, pair scores of 16 steps in
    shared memory), so A is bounded by int32 indexing alone, and the
    window by 1,024 anchors."""
    return 0 <= A <= MAX_ANCHORS and window_of(window) <= MAX_WINDOW


_FIELDS = ("rev", "rid", "rpos", "qpos", "span")


def _check(anchors: dict) -> tuple:
    rpos = anchors["rpos"]
    if rpos.dim() != 2:
        raise ValueError(f"anchors must be [B, A], got {tuple(rpos.shape)}")
    for name in _FIELDS + ("valid",):
        t = anchors[name]
        want = torch.bool if name == "valid" else torch.int32
        if t.dtype != want or t.shape != rpos.shape or t.device != rpos.device:
            raise ValueError(
                f"anchors[{name!r}]: want {want} {tuple(rpos.shape)} on "
                f"{rpos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"anchors[{name!r}] must be contiguous")
    return tuple(rpos.shape)


def chain_scores_kernel(anchors: dict, params: ChainParams, window: int = C):
    """Chain DP over sorted [B, A] anchors; returns int32 f, p [B, A].

    The predecessor window is ``window_of(window)`` anchors."""
    global launches
    H = window_of(window)
    B, A = _check(anchors)
    cuda_build.note("chain_dp")
    dev = anchors["rpos"].device
    if dev.type == "cpu":
        return chain_scores(anchors, params, H)
    if dev.type != "cuda":
        raise ValueError(f"chain_scores_kernel: unsupported device {dev}")
    if not chain_fits(A, H):
        raise ValueError(
            f"chain_scores_kernel: A={A}, window={H} outside what the kernel "
            f"takes (A <= {MAX_ANCHORS}, window <= {MAX_WINDOW})")
    f = torch.empty((B, A), dtype=torch.int32, device=dev)
    p = torch.empty((B, A), dtype=torch.int32, device=dev)
    if B == 0 or A == 0:
        return f, p
    lib = cuda_build.load()
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = lib.chain_dp(
            *(anchors[n].data_ptr()
              for n in ("rev", "rid", "rpos", "qpos", "valid", "span")),
            B, A, H, int(params.max_dist_x), int(params.max_dist_y),
            int(params.bw), float(params.chn_pen_gap),
            float(params.chn_pen_skip), int(params.is_splice),
            f.data_ptr(), p.data_ptr(), cuda_build.stream_handle(dev),
        )
    cuda_build.check(err, "chain_dp")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return f, p
