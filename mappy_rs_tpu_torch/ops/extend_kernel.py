"""Kernel K3 — the banded extension DP on the card (csrc/extend.cu) —
and the host wrappers of the device extension backends.

Port of the JAX package's ops/extend_pallas.py.  ``extend_dp_kernel``
sends a CUDA tensor to the hand-written kernel and a CPU tensor to the
plain version, ops/extend.py ``extend_dp``; there is no fallback between
the two.  The host wrappers take numpy job batches:

- ``extend_traceback_device`` (backend "device"): upload once, K3 then
  K4 on one stream with no sync between them, download only the packed
  CIGAR table and the info rows into pinned memory;
- ``extend_dp_device`` (backend "device_dl"): K3, then download the
  direction bytes and trackers for the host walk.

Each call waits on its own CUDA event, never on the whole device, so
the engine's worker threads overlap.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from .extend import BEST_COLS, ExtendParams, extend_dp
from .traceback import traceback_device

#: kernel launches since the last reset (plain-version calls not counted)
launches = 0
#: the same launches by shape (QMAX, TMAX, W, J), reset with ``launches``
shapes: collections.Counter = collections.Counter()

#: widest band of K3's warp kernel (a warp per job, W / 32 band lanes per
#: thread, at most csrc/extend.cu WARP_MAX_C = 8); wider bands, and bands
#: that are no multiple of 32 (the pipeline makes none), take the block
#: kernel.  The choice is by shape only (csrc/extend.cu says why 256).
WARP_MAX_W = 256
_ROWS = 11  # DP state rows of the block kernel per job (csrc/extend.cu ROWS)
# shared memory left for the rows beside the kernel's static variables
_ROW_SMEM = cuda_build.SMEM_LIMIT - 1024


def _check_inputs(q, t, qlen, tlen) -> Tuple[int, int, int]:
    J, QMAX = q.shape
    if t.dim() != 2 or t.shape[0] != J:
        raise ValueError(f"q {tuple(q.shape)} and t {tuple(t.shape)} disagree")
    for name, x, want in (("q", q, torch.uint8), ("t", t, torch.uint8),
                          ("qlen", qlen, torch.int32),
                          ("tlen", tlen, torch.int32)):
        if x.dtype != want or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want} on {q.device}")
    if qlen.shape != (J,) or tlen.shape != (J,):
        raise ValueError("qlen and tlen must be [J]")
    return J, QMAX, t.shape[1]


def extend_dp_kernel(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor, W: int, params: ExtendParams
                     ) -> Dict[str, torch.Tensor]:
    """K3 on the device of `q`; same signature and outputs as
    ops/extend.py ``extend_dp`` (dirs uint8 [S, J, W] and the six int32
    [J] trackers), plus the trackers as one [J, 6] tensor under the key
    ``best`` (columns BEST_COLS, the layout K4 reads)."""
    global launches
    dev = q.device
    if dev.type == "cpu":
        out = extend_dp(q, t, qlen, tlen, W, params)
        out["best"] = torch.stack([out[c] for c in BEST_COLS], 1)
        return out
    if dev.type != "cuda":
        raise ValueError(f"extend_dp_kernel: unsupported device {dev}")
    J, QMAX, TMAX = _check_inputs(q, t, qlen, tlen)
    if W <= 0 or QMAX <= 0 or TMAX <= 0:
        raise ValueError(f"extend_dp_kernel: bad shape W={W} Q={QMAX} T={TMAX}")
    S = QMAX + TMAX - 1
    dirs = torch.empty((S, J, W), dtype=torch.uint8, device=dev)
    best = torch.empty((J, 6), dtype=torch.int32, device=dev)
    if J:
        warp = W <= WARP_MAX_W and W % 32 == 0
        # the block kernel's rows beyond shared memory live in a global
        # scratch buffer
        scratch: Optional[torch.Tensor] = None
        if not warp and _ROWS * (W + 2) * 4 > _ROW_SMEM:
            scratch = torch.empty((J, _ROWS * (W + 2)), dtype=torch.int32,
                                  device=dev)
        lib = cuda_build.load()
        p = params
        with torch.cuda.device(dev):
            err = lib.extend_dp(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                J, QMAX, TMAX, W, p.a, p.b, p.q, p.e, p.q2, p.e2, p.sc_ambi,
                dirs.data_ptr(), best.data_ptr(),
                None if scratch is None else scratch.data_ptr(), int(warp),
                cuda_build.stream_handle(dev),
            )
        cuda_build.check(err, "extend_dp")
        launches += 1
        shapes[(QMAX, TMAX, W, J)] += 1
    out = {name: best[:, k] for k, name in enumerate(BEST_COLS)}
    out["dirs"] = dirs
    out["best"] = best
    return out


def _on(dev: torch.device):
    """Make `dev` the current CUDA device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _upload(arrays, device: torch.device):
    """numpy arrays -> tensors on `device` (through pinned memory on CUDA)."""
    out = []
    for a in arrays:
        h = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            h = h.pin_memory()
        out.append(h.to(device, non_blocking=True))
    return out


def _download(tensors, device: torch.device):
    """Tensors -> numpy: on CUDA into pinned memory, then wait on one
    event recorded after the copies (this call's work only)."""
    if device.type != "cuda":
        return [x.numpy() for x in tensors]
    hosts = []
    for x in tensors:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    done.synchronize()
    return [h.numpy() for h in hosts]


def extend_traceback_device(
    q: np.ndarray,  # uint8 [J, QMAX]
    t: np.ndarray,  # uint8 [J, TMAX]
    qlen: np.ndarray,
    tlen: np.ndarray,
    mode: np.ndarray,  # int32 [J]: 0 global (mid), 1 extension (flank)
    W: int,
    params: ExtendParams,
    end_bonus: int,
    max_ops: int = 128,
    device: torch.device = torch.device("cuda"),
) -> Dict[str, np.ndarray]:
    """The device-resident extension stage: K3 then K4 on `device`.

    Returns ``ops`` int32 [J, max_ops] (len<<4|op, END->START, -1
    padded) and ``info`` int32 [J, 8] (n_ops, final_i, final_j, score,
    started, overflow, start_i, start_j).  The table is max_ops wide
    exactly (the JAX package rounds it up to a multiple of 128 lanes; at
    the pipeline's 128 the two agree)."""
    dev = torch.device(device)
    with _on(dev):
        q_t, t_t, ql_t, tl_t, mode_t = _upload(
            (q, t, qlen.astype(np.int32), tlen.astype(np.int32),
             mode.astype(np.int32)), dev)
        res = extend_dp_kernel(q_t, t_t, ql_t, tl_t, W, params)
        ops, info = traceback_device(res["dirs"], res["best"], ql_t, tl_t,
                                     mode_t, W, int(max_ops), int(end_bonus))
        ops_h, info_h = _download((ops, info), dev)
    return {"ops": ops_h, "info": info_h}


def extend_dp_device(
    q: np.ndarray,
    t: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    W: int,
    params: ExtendParams,
    device: torch.device = torch.device("cuda"),
) -> Dict[str, np.ndarray]:
    """K3 on `device`, then the direction bytes (uint8 [S, J, W]) and the
    six trackers downloaded for the host walk (backend "device_dl")."""
    dev = torch.device(device)
    with _on(dev):
        q_t, t_t, ql_t, tl_t = _upload(
            (q, t, qlen.astype(np.int32), tlen.astype(np.int32)), dev)
        res = extend_dp_kernel(q_t, t_t, ql_t, tl_t, W, params)
        dirs, best = _download((res["dirs"], res["best"]), dev)
    out = {c: best[:, k] for k, c in enumerate(BEST_COLS)}
    out["dirs"] = dirs
    return out
