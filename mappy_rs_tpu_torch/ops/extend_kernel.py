"""Kernel K3 — the banded extension DP on the card (csrc/extend.cu) —
and the host wrappers of the device extension backends.

Port of the JAX package's ops/extend_pallas.py.  ``extend_dp_kernel``
sends a CUDA tensor to the hand-written kernel and a CPU tensor to the
plain version, ops/extend.py ``extend_dp``; there is no fallback between
the two.  The host wrappers take numpy job batches:

- ``extend_traceback_device`` (backend "device"): K3 then K4 on one
  stream with no sync between them, only the packed CIGAR table and the
  info rows downloaded into pinned memory;
- ``extend_dp_device`` (backend "device_dl"): K3, then the direction
  bytes and trackers downloaded for the host walk.

Given a graph cache (models/graphs.py; the engine's on the card), each
job-group shape is one CUDA graph, the counterpart of the JAX package's
``_extend_traceback_jit`` / ``_extend_pallas_device`` jits: the jobs are
copied from pinned memory into the graph's static inputs, one replay
runs K3 (+ K4), and the outputs are copied out, all under the graph's
lock; the direction bytes and K3's scratch live in the graph's memory
pool.  Without a cache the same ops run eagerly on fresh uploads.

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

#: kernel launches since the last reset (plain-version calls not counted;
#: a call inside a CUDA-graph capture launches nothing and is not
#: counted, and each replay of the graph is credited with its launches)
launches = 0
#: the same launches by shape (QMAX, TMAX, W, J), reset with ``launches``
shapes: collections.Counter = collections.Counter()


def credit(n: int, shape: Optional[tuple] = None) -> None:
    """Count n launches (at `shape`) made by replaying a captured CUDA
    graph."""
    global launches
    launches += n
    if shape is not None:
        shapes[shape] += n

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
    J, QMAX = q.shape
    if J:
        cuda_build.note("extend_dp", (QMAX, t.shape[-1], W, J))
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
        if not torch.cuda.is_current_stream_capturing():
            launches += 1
            shapes[(QMAX, TMAX, W, J)] += 1
    out = {name: best[:, k] for k, name in enumerate(BEST_COLS)}
    out["dirs"] = dirs
    out["best"] = best
    return out


def _on(dev: torch.device):
    """Make `dev` the current CUDA device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _stage(arrays: Dict[str, np.ndarray], device: torch.device):
    """numpy arrays -> host tensors, pinned for a CUDA upload."""
    out = {n: torch.from_numpy(np.ascontiguousarray(a))
           for n, a in arrays.items()}
    if device.type == "cuda":
        out = {n: h.pin_memory() for n, h in out.items()}
    return out


def _copy_out(tensors, device: torch.device):
    """Start copying tensors to the host: (host tensors, the event that
    marks the copies done; None on the CPU, whose copies are clones)."""
    if device.type != "cuda":
        return [x.clone() for x in tensors], None
    hosts = []
    for x in tensors:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return hosts, done


def _run(body, host: Dict[str, np.ndarray], device: torch.device, graphs,
         key: tuple, shape: dict):
    """body(**inputs) on `device` over the host arrays, its outputs as
    numpy: through `graphs` (one graph per `key`; copy-in, replay and
    copy-out under the graph's lock) when given, else eagerly on fresh
    uploads.  Waits on this call's event only."""
    staged = _stage(host, device)
    with _on(device):
        if graphs is None:
            ups = {n: h.to(device, non_blocking=True)
                   for n, h in staged.items()}
            hosts, done = _copy_out(body(**ups), device)
        else:
            g = graphs.get(key, shape, device, None, staged,
                           lambda inputs: lambda: body(**inputs))
            hosts, done = graphs.run(g, staged, device,
                                     lambda *outs: _copy_out(outs, device))
        if done is not None:
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
    graphs=None,
) -> Dict[str, np.ndarray]:
    """The device-resident extension stage: K3 then K4 on `device`,
    through `graphs` (a models/graphs.py GraphCache: one graph per
    (device, QMAX, TMAX, W, J, max_ops, end_bonus, params)) when given.

    Returns ``ops`` int32 [J, max_ops] (len<<4|op, END->START, -1
    padded) and ``info`` int32 [J, 8] (n_ops, final_i, final_j, score,
    started, overflow, start_i, start_j).  The table is max_ops wide
    exactly (the JAX package rounds it up to a multiple of 128 lanes; at
    the pipeline's 128 the two agree)."""
    dev = torch.device(device)
    OPS, bonus = int(max_ops), int(end_bonus)

    def body(q, t, qlen, tlen, mode):
        res = extend_dp_kernel(q, t, qlen, tlen, W, params)
        return traceback_device(res["dirs"], res["best"], qlen, tlen, mode,
                                W, OPS, bonus)

    J, QMAX = q.shape
    TMAX = t.shape[1]
    ops, info = _run(
        body, {"q": q, "t": t, "qlen": qlen.astype(np.int32),
               "tlen": tlen.astype(np.int32), "mode": mode.astype(np.int32)},
        dev, graphs,
        ("extend_traceback", str(dev), QMAX, TMAX, W, J, OPS, bonus, params),
        {"device": str(dev), "QMAX": QMAX, "TMAX": TMAX, "W": W, "J": J,
         "OPS": OPS})
    return {"ops": ops, "info": info}


def extend_dp_device(
    q: np.ndarray,
    t: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    W: int,
    params: ExtendParams,
    device: torch.device = torch.device("cuda"),
    graphs=None,
) -> Dict[str, np.ndarray]:
    """K3 on `device`, then the direction bytes (uint8 [S, J, W]) and the
    six trackers downloaded for the host walk (backend "device_dl");
    through `graphs` (one graph per (device, QMAX, TMAX, W, J, params))
    when given."""
    dev = torch.device(device)

    def body(q, t, qlen, tlen):
        res = extend_dp_kernel(q, t, qlen, tlen, W, params)
        return res["dirs"], res["best"]

    J, QMAX = q.shape
    TMAX = t.shape[1]
    dirs, best = _run(
        body, {"q": q, "t": t, "qlen": qlen.astype(np.int32),
               "tlen": tlen.astype(np.int32)},
        dev, graphs, ("extend_dp", str(dev), QMAX, TMAX, W, J, params),
        {"device": str(dev), "QMAX": QMAX, "TMAX": TMAX, "W": W, "J": J})
    out = {c: best[:, k] for k, c in enumerate(BEST_COLS)}
    out["dirs"] = dirs
    return out
