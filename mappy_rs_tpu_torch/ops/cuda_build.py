"""Build and load the port's CUDA kernels (csrc/*.cu).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, in the package's gitignored build
directory, on first use, and loaded with ctypes.  Nothing here runs at
import time: this module imports on machines without nvcc or a card.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the wrappers (ops/chain_kernel.py,
ops/backtrack.py, ops/extend_kernel.py, ops/traceback.py) raise when
that is not 0.

``recording()`` counts the calls that the four kernels' wrappers make
on one thread inside a block, on either device: the graph caches
(models/graphs.py) record what a capture launches, and credit each
replay with it.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("chain.cu", "backtrack.cu", "extend.cu", "traceback.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libmappy_kernels.so")
# -fmad=false: K1's float32 gap penalty must not be contracted into FMAs;
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# build_log
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
#: dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232448

_lib: Optional[ctypes.CDLL] = None
_mu = threading.Lock()
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: nvcc's messages of the last build (ptxas resource usage per kernel)
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    t = os.path.getmtime(_SO)
    return any(os.path.getmtime(os.path.join(CSRC, s)) > t for s in SOURCES)


def build() -> str:
    """Compile the kernels (if the library is missing or stale); returns
    the library path.  One nvcc per source, all started together, then
    one link.  Raises with nvcc's output on failure."""
    global build_seconds, build_log
    if not _stale():
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in SOURCES:
            obj = os.path.join(BUILD_DIR, f"{src}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        for cmd, _obj, proc in jobs:
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{out}\n{err}")
            logs.append(out + err)
        tmp = f"{_SO}.{tag}.tmp"
        cmd = [nvcc, *GENCODE, "-shared", "-o", tmp, *(o for _c, o, _p in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
    finally:
        for _cmd, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, _SO)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return _SO


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-safe)."""
    global _lib
    with _mu:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.chain_dp.restype = ci
            lib.chain_dp.argtypes = (
                [vp] * 6 + [ci] * 6 + [cf, cf, ci] + [vp, vp, vp]
            )
            lib.backtrack_chains.restype = ci
            lib.backtrack_chains.argtypes = [vp] * 8 + [ci] * 7 + [vp, vp]
            lib.extend_dp.restype = ci
            lib.extend_dp.argtypes = [vp] * 4 + [ci] * 11 + [vp] * 3 + [ci, vp]
            lib.traceback_walk.restype = ci
            lib.traceback_walk.argtypes = [vp] * 5 + [ci] * 6 + [vp] * 3
            _lib = lib
        return _lib


_rec = threading.local()


@contextlib.contextmanager
def recording():
    """A Counter of the kernel wrappers' calls (by kernel name) that this
    thread makes inside the block; blocks nest, the inner one counting
    alone."""
    prev = getattr(_rec, "counts", None)
    _rec.counts = collections.Counter()
    try:
        yield _rec.counts
    finally:
        _rec.counts = prev


def note(name: str, detail=None) -> None:
    """Count one call of kernel `name`'s wrapper in this thread's open
    recording, if any: under `name`, or under (name, detail) where the
    kernel's counts keep a detail (K3: its shape)."""
    counts = getattr(_rec, "counts", None)
    if counts is not None:
        counts[name if detail is None else (name, detail)] += 1


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
