"""ctypes loader for the C++ host runtime (with auto-build + fallback).

The library is compiled from this package's own copy of the JAX
package's host C++, ``native/src/{mappy_native,front_end,post_chain}.cc``,
with the JAX package's Makefile flags, into this package's gitignored
build directory on first use.  It supplies the host inner loops:
post-chain record emission, banded extension, CIGAR stats and cs/MD,
the contig sketcher and the CPU front end.  If it cannot be built,
callers fall back to the numpy/python implementations (same results,
slower).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SOURCES = ("mappy_native.cc", "front_end.cc", "post_chain.cc")
# the JAX package's native Makefile flags
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libmappy_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_mu = threading.Lock()


def _build() -> None:
    """Compile the shared C++ sources into BUILD_DIR.  Writes to a
    per-process temporary name and renames, so concurrent builders
    (test workers, threads) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
         *(os.path.join(_SRC_DIR, s) for s in _SOURCES)],
        check=True, capture_output=True, timeout=300,
    )
    os.replace(tmp, _SO)


def _load() -> Optional[ctypes.CDLL]:
    with _load_mu:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or any(
        os.path.getmtime(os.path.join(_SRC_DIR, s)) > os.path.getmtime(_SO)
        for s in _SOURCES
    ):
        try:
            _build()
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.encode_ascii.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.traceback_batch.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    lib.extend_small_batch.argtypes = (
        [np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")] * 2
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 2
        + [ctypes.c_int] * 12
        + [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
    )
    lib.splice_align_batch.argtypes = (
        [np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")] * 2
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 2
        + [ctypes.c_int] * 15
        + [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
    )
    lib.extend_set_force_scalar.argtypes = [ctypes.c_int]
    lib.sketch_contig.restype = ctypes.c_int64
    lib.sketch_contig.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.extend_banded_batch.argtypes = (
        [np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")] * 2
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 2
        + [ctypes.c_int] * 14
        + [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
    )
    lib.extend_jobs_batch.argtypes = (
        [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 4
        + [ctypes.c_int] * 10
        + [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
    )
    for fname in ("gen_cs_native", "gen_md_native"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
    lib.cigar_stats.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.front_end_batch.argtypes = [
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),  # keys
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),  # key_off
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),  # positions
        ctypes.c_int64,  # nk
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),  # reads
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),  # read_off
        ctypes.c_int32,  # R
        ctypes.c_int32,  # k
        ctypes.c_int32,  # w
        ctypes.c_int32,  # is_hpc
        ctypes.c_int32,  # mid_occ
        ctypes.c_int32,  # occ_dist
        ctypes.c_int32,  # max_max_occ
        ctypes.c_int32,  # max_dist_x
        ctypes.c_int32,  # max_dist_y
        ctypes.c_int32,  # bw
        ctypes.c_float,  # chn_pen_gap
        ctypes.c_float,  # chn_pen_skip
        ctypes.c_int32,  # max_iter
        ctypes.c_int32,  # bw_long
        ctypes.c_int32,  # use_rmq
        ctypes.c_int32,  # is_splice
        ctypes.c_int32,  # min_cnt
        ctypes.c_int32,  # min_sc
        ctypes.c_int32,  # K
        ctypes.c_int32,  # seg_cuts
        ctypes.c_int32,  # seg_len
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # chains
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # rep_len
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # n_anchors
    ]
    lib.backtrack_compact_batch.argtypes = (
        [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 5
        + [ctypes.c_int32] * 7
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    )
    lib.chain_dp_anchors.argtypes = (
        [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 5
        + [ctypes.c_int32] * 4  # n, max_dist_x, max_dist_y, bw
        + [ctypes.c_float] * 2  # chn_pen_gap, chn_pen_skip
        + [ctypes.c_int32] * 4  # max_iter, bw_long, use_rmq, is_splice
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 2
    )
    _i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    _i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.finalize_batch.argtypes = [
        _i32p, _i64p, _u8p, _i32p,          # ops_concat, part_off, part_rev, reg_part_off
        _u8p, _i64p, _u8p, _i64p,           # q_concat, q_off, ref, t_off
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # R, want_cs, want_md
        _i32p, _i32p, _i32p,                # out_ops, out_nops, out_stats
        ctypes.c_char_p, _i64p, _i64p,      # cs_buf, cs_off, cs_len
        ctypes.c_char_p, _i64p, _i64p,      # md_buf, md_off, md_len
    ]
    lib.post_chain_batch.argtypes = [
        _i32p,                              # chains [B,K,FLD]
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, K, FLD
        _u8p, _i64p,                        # codes, code_off
        _i32p,                              # rep_len
        _u8p, _i64p, _i64p,                 # ref, seq_off, seq_len
        _i32p,                              # ip
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # dp
        ctypes.c_int, ctypes.c_int,         # want_cs, want_md
        _i32p, _i32p, _i32p, _i32p,         # nreg, fields, cig, ncig
        ctypes.c_char_p, ctypes.c_int64, _i64p,  # cs_buf, cap, cs_len
        ctypes.c_char_p, ctypes.c_int64, _i64p,  # md_buf, cap, md_len
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),  # fallback
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # stats
    ]
    lib.fastx_scan.restype = ctypes.c_int64
    lib.fastx_scan.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.fastx_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ] * 4
    _lib = lib
    return _lib


def sketch_contig(
    codes: np.ndarray, k: int, w: int, is_hpc: bool = False
):
    """Native contig sketcher (index build).  Returns (keys u64[n],
    y u64[n]) with y = pos_end<<1|strand, or None if the lib is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    L = len(codes)
    # expected minimizer density is ~2/(w+1); 2x headroom on that is
    # ample for real sequence and the retry loop covers adversarial
    # inputs.  (The old L//3 cap allocated ~90M-slot buffers per
    # 256Mbp contig at w=64 — GBs of churn per thread.)
    cap = max(4 * L // (w + 1) + 1024, 1024)
    while True:
        out_key = np.empty(cap, np.uint64)
        out_y = np.empty(cap, np.uint64)
        n = lib.sketch_contig(codes, L, k, w, int(is_hpc), out_key, out_y, cap)
        if n == -1:
            cap *= 2
            continue
        if n < 0:
            return None
        return out_key[:n], out_y[:n]


def set_force_scalar_band(v: bool) -> None:
    """Test hook: force the scalar band fill in extend_banded_batch
    (the AVX-512/scalar equivalence tests flip this to compare)."""
    lib = _load()
    if lib is not None:
        lib.extend_set_force_scalar(int(v))


def available() -> bool:
    return _load() is not None


def encode(seq: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    raw = seq.encode("ascii", errors="replace")
    out = np.empty(len(raw), np.uint8)
    lib.encode_ascii(raw, len(raw), out)
    return out


def fastx_parse(data: bytes):
    """Parse a FASTA/FASTQ buffer natively.

    Returns (mode, names, comments, seqs, quals) where mode is 0 for
    FASTA / 1 for FASTQ / -1 for empty input and each of the four
    record fields is a (blob bytes, offsets int64[R+1]) pair, or None
    if the native library is unavailable.  Line and tokenization
    semantics are identical to the python fastx_read fallback."""
    lib = _load()
    if lib is None:
        return None
    n = len(data)
    totals = np.zeros(4, np.int64)
    mode = np.zeros(1, np.int32)
    r = int(lib.fastx_scan(data, n, totals, mode))
    blobs = [np.zeros(max(int(t), 1), np.uint8) for t in totals]
    offs = [np.zeros(r + 1, np.int64) for _ in range(4)]
    if r:
        lib.fastx_fill(
            data, n,
            blobs[0], offs[0], blobs[1], offs[1],
            blobs[2], offs[2], blobs[3], offs[3],
        )
    return (
        int(mode[0]),
        (blobs[0], offs[0]),
        (blobs[1], offs[1]),
        (blobs[2], offs[2]),
        (blobs[3], offs[3]),
    )


def backtrack_compact_batch(
    arr: np.ndarray,  # [5, B, A] int32: meta, rpos, qpos, f, p
    min_cnt: int,
    min_sc: int,
    K: int,
    seg_cuts: int,
    seg_len: int,
) -> Optional[np.ndarray]:
    """Greedy chain backtrack over downloaded f/p arrays (C++).

    Returns [B, K, 9+2*seg_cuts] compact chain rows (the
    backtrack_pallas layout), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    _, B, A = arr.shape
    FLD = 9 + 2 * seg_cuts
    out = np.empty((B, K, FLD), np.int32)
    a = np.ascontiguousarray(arr)
    lib.backtrack_compact_batch(
        a[0], a[1], a[2], a[3], a[4], B, A,
        int(min_cnt), int(min_sc), int(K), int(seg_cuts), int(seg_len),
        out.reshape(-1),
    )
    return out


def pack_ops(cig) -> np.ndarray:
    """[(n, op)] (or already-packed array) -> packed int32 n<<4|op."""
    if isinstance(cig, np.ndarray):
        return np.ascontiguousarray(cig, np.int32)
    return np.fromiter(
        ((n << 4) | op for n, op in cig), np.int32, count=len(cig)
    )


def gen_cs(cig, qcodes: np.ndarray, tcodes: np.ndarray) -> Optional[str]:
    """cs tag via C++; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ops = pack_ops(cig)
    blen = int((ops >> 4).sum())
    cap = 4 * blen + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.gen_cs_native(
        ops, len(ops), np.ascontiguousarray(qcodes, np.uint8),
        np.ascontiguousarray(tcodes, np.uint8), buf, cap,
    )
    if n < 0:
        return None
    return buf.raw[: int(n)].decode("ascii")


def gen_md(cig, qcodes: np.ndarray, tcodes: np.ndarray) -> Optional[str]:
    """MD tag via C++; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ops = pack_ops(cig)
    blen = int((ops >> 4).sum())
    cap = 4 * blen + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.gen_md_native(
        ops, len(ops), np.ascontiguousarray(qcodes, np.uint8),
        np.ascontiguousarray(tcodes, np.uint8), buf, cap,
    )
    if n < 0:
        return None
    return buf.raw[: int(n)].decode("ascii")


def cigar_stats(
    cig, qcodes: np.ndarray, tcodes: np.ndarray
) -> Optional[Tuple[int, int, int]]:
    """(mlen, blen, NM) via C++; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    ops = pack_ops(cig)
    out = np.zeros(3, np.int32)
    lib.cigar_stats(
        ops, len(ops), np.ascontiguousarray(qcodes, np.uint8),
        np.ascontiguousarray(tcodes, np.uint8), out,
    )
    return int(out[0]), int(out[1]), int(out[2])


def finalize_batch(
    parts: List[np.ndarray],   # packed int32 ops, all regions, in order
    part_rev: np.ndarray,      # uint8 [P]: iterate part reversed
    reg_part_off: np.ndarray,  # int32 [R+1] part ranges per region
    qsegs: List[np.ndarray],   # uint8 query segment per region
    ref_codes: np.ndarray,     # uint8 whole packed reference
    t_off: np.ndarray,         # int64 [R] absolute target start offsets
    t_len: np.ndarray,         # int64 [R] target segment lengths
    want_cs: bool,
    want_md: bool,
):
    """Batched region finalize (merge parts + stats + cs/MD) in ONE
    C++ call per device batch.  Returns (merged packed ops per region,
    stats [R,3] int32, cs list|None, md list|None), or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    R = len(t_off)
    P = len(parts)
    part_off = np.zeros(P + 1, np.int64)
    for i, p in enumerate(parts):
        part_off[i + 1] = part_off[i] + len(p)
    total = int(part_off[-1])
    ops_concat = (
        np.concatenate(parts).astype(np.int32, copy=False)
        if total else np.zeros(1, np.int32)
    )
    q_off = np.zeros(R + 1, np.int64)
    for i, q in enumerate(qsegs):
        q_off[i + 1] = q_off[i] + len(q)
    q_concat = (
        np.concatenate(qsegs) if int(q_off[-1]) else np.zeros(1, np.uint8)
    )
    out_ops = np.empty(max(total, 1), np.int32)
    out_nops = np.zeros(R, np.int32)
    out_stats = np.zeros(3 * R, np.int32)
    # cs/MD caps: worst case ~3 bytes/base + run numbers; 4*span+64 is
    # a safe bound, so the C side never reports truncation
    qlens = np.diff(q_off)
    caps = 4 * (qlens + t_len) + 64
    cs_off = np.zeros(R + 1, np.int64)
    md_off = np.zeros(R + 1, np.int64)
    if want_cs:
        np.cumsum(caps, out=cs_off[1:])
    if want_md:
        np.cumsum(caps, out=md_off[1:])
    cs_buf = ctypes.create_string_buffer(max(int(cs_off[-1]), 1))
    md_buf = ctypes.create_string_buffer(max(int(md_off[-1]), 1))
    cs_len = np.zeros(R, np.int64)
    md_len = np.zeros(R, np.int64)
    lib.finalize_batch(
        ops_concat, part_off,
        np.ascontiguousarray(part_rev, np.uint8),
        np.ascontiguousarray(reg_part_off, np.int32),
        q_concat, q_off, ref_codes,
        np.ascontiguousarray(t_off, np.int64),
        R, int(want_cs), int(want_md),
        out_ops, out_nops, out_stats,
        cs_buf, cs_off, cs_len, md_buf, md_off, md_len,
    )
    merged = []
    for i in range(R):
        s = int(part_off[reg_part_off[i]])
        merged.append(out_ops[s : s + int(out_nops[i])])
    cs_raw = cs_buf.raw if want_cs else b""
    md_raw = md_buf.raw if want_md else b""
    cs_strs = (
        [
            cs_raw[int(cs_off[i]) : int(cs_off[i]) + int(cs_len[i])].decode(
                "ascii"
            )
            for i in range(R)
        ]
        if want_cs else None
    )
    md_strs = (
        [
            md_raw[int(md_off[i]) : int(md_off[i]) + int(md_len[i])].decode(
                "ascii"
            )
            for i in range(R)
        ]
        if want_md else None
    )
    return merged, out_stats.reshape(R, 3), cs_strs, md_strs


#: post_chain_batch output field order (post_chain.cc F_* enum)
PC_FIELDS = (
    "rev", "rid", "qs", "qe", "rs", "re", "score", "cnt", "id",
    "parent", "subsc", "n_sub", "dp_score", "dp_max2", "mapq",
    "mlen", "blen", "nm",
)
PC_NF = len(PC_FIELDS)


def post_chain_batch(
    chains: np.ndarray,        # int32 [B, K, FLD] compact chain rows
    codes_list,                # list of uint8 read codes, batch order
    rep_len: np.ndarray,       # int32 [B]
    ref_codes: np.ndarray,     # uint8 whole reference
    seq_off: np.ndarray,       # int64 [n_seqs]
    seq_len: np.ndarray,       # int64 [n_seqs]
    ip: np.ndarray,            # int32 [IP_N] param block (pipeline)
    dp: np.ndarray,            # float64 [mask_level, pri_ratio]
    want_cs: bool,
    want_md: bool,
):
    """Fused post-chain record emission (post_chain.cc): ONE native
    call runs regions + parent/select + extension + finalize + mapq
    for a whole device batch.  Returns (nreg [B], fields [B,K,NF],
    cig [B,K,cap], ncig [B,K], cs_list, md_list, fallback [B],
    stats [cells, jobs, the call's thread CPU seconds in C++]) where
    cs_list/md_list are per-(read, slot) string getters, or None if the
    native lib is unavailable.
    Reads with fallback=1 (zdrop split, cap overflow) must be remapped
    by the Python path."""
    lib = _load()
    if lib is None:
        return None
    B, K, FLD = chains.shape
    code_off = np.zeros(B + 1, np.int64)
    for i, c in enumerate(codes_list):
        code_off[i + 1] = code_off[i] + len(c)
    codes = (
        np.concatenate(codes_list) if int(code_off[-1])
        else np.zeros(1, np.uint8)
    )
    max_q = int((code_off[1:] - code_off[:-1]).max(initial=1))
    cigcap = 4 * max_q + 64
    ip = np.asarray(ip, np.int32).copy()
    ip[20] = cigcap  # IP_CIGCAP
    nreg = np.zeros(B, np.int32)
    fields = np.empty((B, K, PC_NF), np.int32)
    cig = np.empty((B, K, cigcap), np.int32)
    ncig = np.zeros((B, K), np.int32)
    tag_cap = 8 * max_q + 128
    # numpy byte buffers: ctypes string buffers pay a full-buffer copy
    # on every .raw access
    cs_buf = np.empty(B * K * tag_cap if want_cs else 1, np.uint8)
    md_buf = np.empty(B * K * tag_cap if want_md else 1, np.uint8)
    cs_len = np.full((B, K), -1, np.int64)
    md_len = np.full((B, K), -1, np.int64)
    fallback = np.zeros(B, np.uint8)
    stats = np.zeros(3, np.float64)
    lib.post_chain_batch(
        np.ascontiguousarray(chains), B, K, FLD,
        codes, code_off, np.ascontiguousarray(rep_len, np.int32),
        ref_codes, np.ascontiguousarray(seq_off, np.int64),
        np.ascontiguousarray(seq_len, np.int64),
        ip, np.asarray(dp, np.float64), int(want_cs), int(want_md),
        nreg, fields.reshape(-1), cig.reshape(-1), ncig.reshape(-1),
        cs_buf.ctypes.data_as(ctypes.c_char_p), tag_cap,
        cs_len.reshape(-1),
        md_buf.ctypes.data_as(ctypes.c_char_p), tag_cap,
        md_len.reshape(-1),
        fallback, stats,
    )

    def _tag(buf, lens, bi, oi):
        v = int(lens[bi, oi])
        if v < 0:
            return None
        slot, n = v >> 32, v & 0xFFFFFFFF
        base = (bi * K + slot) * tag_cap
        return buf[base : base + n].tobytes().decode("ascii")

    cs_get = (lambda bi, oi: _tag(cs_buf, cs_len, bi, oi)) if want_cs else None
    md_get = (lambda bi, oi: _tag(md_buf, md_len, bi, oi)) if want_md else None
    # raw tag buffers: the packed-block fast path (runtime/pack.py
    # PackedSink) gathers tags vectorized instead of via the getters
    raw_tags = (cs_buf, cs_len, md_buf, md_len, tag_cap)
    return nreg, fields, cig, ncig, cs_get, md_get, fallback, stats, raw_tags


def chain_dp_anchors(
    rev: np.ndarray, rid: np.ndarray, rpos: np.ndarray,
    qpos: np.ndarray, span: np.ndarray,
    max_dist_x: int, max_dist_y: int, bw: int,
    chn_pen_gap: float, chn_pen_skip: float,
    max_iter: int, bw_long: int, use_rmq: int, is_splice: int = 0,
):
    """Chain a RAW anchor array (test hook; see front_end.cc
    chain_dp_anchors).  Anchors must be pre-sorted by
    (rev, rid, rpos, qpos).  Returns (f, p) int32 arrays or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(rev)
    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int32)
    lib.chain_dp_anchors(
        np.ascontiguousarray(rev, np.int32),
        np.ascontiguousarray(rid, np.int32),
        np.ascontiguousarray(rpos, np.int32),
        np.ascontiguousarray(qpos, np.int32),
        np.ascontiguousarray(span, np.int32),
        n, max_dist_x, max_dist_y, bw,
        ctypes.c_float(chn_pen_gap), ctypes.c_float(chn_pen_skip),
        max_iter, bw_long, use_rmq, is_splice, f, p,
    )
    return f, p


def front_end_batch(
    index,  # MinimizerIndex (host arrays)
    codes_list,  # list of uint8 code arrays
    mid_occ: int,
    chain_params,  # ops.chain.ChainParams
    max_iter: int,
    min_cnt: int,
    min_sc: int,
    K: int,
    seg_cuts: int,
    seg_len: int,
    occ_dist: int = 0,
    max_max_occ: int = 0,
    bw_long: int = 0,
    use_rmq: bool = False,
):
    """CPU front end: sketch+lookup+chain+backtrack for a read batch.

    Returns (chains [R, K, 9+2*seg_cuts] int32 in the
    backtrack_pallas layout, rep_len [R] int32, n_anchors [R] int32),
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    R = len(codes_list)
    read_off = np.zeros(R + 1, np.int64)
    for i, c in enumerate(codes_list):
        read_off[i + 1] = read_off[i] + len(c)
    reads = np.empty(int(read_off[-1]) if R else 1, np.uint8)
    for i, c in enumerate(codes_list):
        reads[read_off[i] : read_off[i + 1]] = c
    FLD = 9 + 2 * seg_cuts
    chains = np.empty((R, K, FLD), np.int32)
    rep_len = np.zeros(R, np.int32)
    n_anchors = np.zeros(R, np.int32)
    keys = np.ascontiguousarray(index.keys, np.uint64)
    key_off = np.ascontiguousarray(index.key_offsets, np.uint64)
    positions = np.ascontiguousarray(index.positions, np.uint64)
    lib.front_end_batch(
        keys, key_off, positions, len(keys),
        reads, read_off, R,
        index.k, index.w, int(bool(index.flag & 0x1)), int(mid_occ),
        int(occ_dist), int(max_max_occ),
        int(chain_params.max_dist_x), int(chain_params.max_dist_y),
        int(chain_params.bw), float(chain_params.chn_pen_gap),
        float(chain_params.chn_pen_skip), int(max_iter),
        int(bw_long), int(bool(use_rmq)),
        int(getattr(chain_params, "is_splice", 0)),
        int(min_cnt), int(min_sc), int(K), int(seg_cuts), int(seg_len),
        chains.reshape(-1), rep_len, n_anchors,
    )
    return chains, rep_len, n_anchors


def traceback_batch(
    dirs: np.ndarray,  # [S, J, W] uint8, C contiguous
    qlen: np.ndarray,
    tlen: np.ndarray,
    start_i: np.ndarray,
    start_j: np.ndarray,
    max_ops: int = 4096,
) -> Optional[List[List[Tuple[int, int]]]]:
    """Batched traceback; returns per-job [(count, op)] lists, or None
    if the native library is unavailable or any job overflowed."""
    lib = _load()
    if lib is None:
        return None
    S, J, W = dirs.shape
    dirs = np.ascontiguousarray(dirs)
    out_ops = np.zeros((J, max_ops), np.int32)
    out_n = np.zeros(J, np.int32)
    lib.traceback_batch(
        dirs, S, J, W,
        np.ascontiguousarray(qlen, np.int32),
        np.ascontiguousarray(tlen, np.int32),
        np.ascontiguousarray(start_i, np.int32),
        np.ascontiguousarray(start_j, np.int32),
        out_ops.reshape(-1), out_n, max_ops,
    )
    if (out_n < 0).any():
        return None
    return [out_ops[j, : out_n[j]].copy() for j in range(J)]


def extend_small_batch(
    q: np.ndarray,  # [J, QS] uint8, padded
    t: np.ndarray,  # [J, TS] uint8, padded
    qlen: np.ndarray,
    tlen: np.ndarray,
    params,  # ExtendParams
    end_bonus: int,
    mode: int,  # 0 global, 1 extension
    max_ops: int = 512,
):
    """Full (unbanded) dual-affine DP for small jobs on the host.
    Returns list of (ops, score, q_consumed, t_consumed) per job, or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    J, QS = q.shape
    TS = t.shape[1]
    out_ops = np.zeros((J, max_ops), np.int32)
    out_n = np.zeros(J, np.int32)
    out_info = np.zeros((J, 3), np.int32)
    lib.extend_small_batch(
        np.ascontiguousarray(q), np.ascontiguousarray(t),
        np.ascontiguousarray(qlen, np.int32),
        np.ascontiguousarray(tlen, np.int32),
        J, QS, TS,
        params.a, params.b, params.q, params.e, params.q2, params.e2,
        params.sc_ambi, end_bonus, mode,
        out_ops.reshape(-1), out_n, max_ops, out_info.reshape(-1),
    )
    res = []
    for j in range(J):
        n = int(out_n[j])
        if n < 0:
            return None  # overflow; caller falls back
        res.append((out_ops[j, :n].copy(), int(out_info[j, 0]),
                    int(out_info[j, 1]), int(out_info[j, 2])))
    return res


def splice_align_batch(
    q: np.ndarray,  # [J, QS] uint8, padded
    t: np.ndarray,  # [J, TS] uint8, padded
    qlen: np.ndarray,
    tlen: np.ndarray,
    a: int, b: int, gapo: int, gape: int, q2: int, noncan: int,
    sc_ambi: int,
    end_bonus: int,
    mode: int,  # 2 global, 1 extension (ops/splice.py semantics)
    sense: int,  # +1 GT..AG, -1 CT..AC
    flank: bool,
    reversed_seq: bool,
    max_ops: int = 0,
):
    """Splice-aware DP (intron state, N ops) on the host — the C++
    twin of ops/splice.splice_align, bit-identical.  Returns per-job
    (packed ops, score, q_consumed, t_consumed), or None if the
    native library is unavailable or a job overflowed max_ops."""
    lib = _load()
    if lib is None:
        return None
    J, QS = q.shape
    TS = t.shape[1]
    if max_ops <= 0:
        max_ops = 2 * (QS + TS) + 8
    out_ops = np.zeros((J, max_ops), np.int32)
    out_n = np.zeros(J, np.int32)
    out_info = np.zeros((J, 3), np.int32)
    lib.splice_align_batch(
        np.ascontiguousarray(q), np.ascontiguousarray(t),
        np.ascontiguousarray(qlen, np.int32),
        np.ascontiguousarray(tlen, np.int32),
        J, QS, TS,
        int(a), int(b), int(gapo), int(gape), int(q2), int(noncan),
        int(sc_ambi), int(end_bonus), int(mode), int(sense),
        int(bool(flank)), int(bool(reversed_seq)),
        out_ops.reshape(-1), out_n, max_ops, out_info.reshape(-1),
    )
    res = []
    for j in range(J):
        n = int(out_n[j])
        if n < 0:
            return None
        res.append(
            (out_ops[j, :n].copy(), int(out_info[j, 0]),
             int(out_info[j, 1]), int(out_info[j, 2]))
        )
    return res


def extend_jobs_batch(
    q_list,  # list of uint8 arrays (views OK; reversed views OK)
    t_list,
    Wv: np.ndarray,     # int32 [J] per-job band width
    modev: np.ndarray,  # int32 [J] per-job mode (0/1/2)
    params,
    end_bonus: int,
    zdrop: int = 0,
    max_ops: int = 0,
):
    """One C++ call for a whole heterogeneous job batch: per-job band
    width and mode over CONCATENATED buffers (no per-shape padded
    staging in numpy).
    Returns per-job (packed ops, score, q_consumed, t_consumed,
    zdropped), or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    J = len(q_list)
    qlen = np.fromiter((len(x) for x in q_list), np.int32, J)
    tlen = np.fromiter((len(x) for x in t_list), np.int32, J)
    q_off = np.zeros(J + 1, np.int64)
    np.cumsum(qlen, out=q_off[1:])
    t_off = np.zeros(J + 1, np.int64)
    np.cumsum(tlen, out=t_off[1:])
    q_concat = (
        np.concatenate(q_list) if int(q_off[-1]) else np.zeros(1, np.uint8)
    )
    t_concat = (
        np.concatenate(t_list) if int(t_off[-1]) else np.zeros(1, np.uint8)
    )
    if max_ops <= 0:
        max_ops = 2 * (int(qlen.max(initial=0)) + int(tlen.max(initial=0))) + 8
    out_ops = np.zeros((J, max_ops), np.int32)
    out_n = np.zeros(J, np.int32)
    out_info = np.zeros((J, 4), np.int32)
    lib.extend_jobs_batch(
        np.ascontiguousarray(q_concat), q_off,
        np.ascontiguousarray(t_concat), t_off,
        qlen, tlen,
        np.ascontiguousarray(Wv, np.int32),
        np.ascontiguousarray(modev, np.int32),
        J, params.a, params.b, params.q, params.e, params.q2, params.e2,
        params.sc_ambi, end_bonus, zdrop,
        out_ops.reshape(-1), out_n, max_ops, out_info.reshape(-1),
    )
    res = []
    for j in range(J):
        n = int(out_n[j])
        if n < 0:
            return None
        res.append(
            (out_ops[j, :n].copy(), int(out_info[j, 0]),
             int(out_info[j, 1]), int(out_info[j, 2]),
             int(out_info[j, 3]))
        )
    return res


def extend_banded_batch(
    q: np.ndarray,
    t: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    W: int,
    params,
    end_bonus: int,
    mode: int,
    zdrop: int = 0,
    max_ops: int = 0,
):
    """Banded dual-affine DP + traceback on host (same band/tie
    semantics as the device kernels).  Returns per-job
    (ops, score, q_consumed, t_consumed), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    J, QS = q.shape
    TS = t.shape[1]
    if max_ops <= 0:
        max_ops = 2 * (QS + TS) + 8
    out_ops = np.zeros((J, max_ops), np.int32)
    out_n = np.zeros(J, np.int32)
    out_info = np.zeros((J, 4), np.int32)
    lib.extend_banded_batch(
        np.ascontiguousarray(q), np.ascontiguousarray(t),
        np.ascontiguousarray(qlen, np.int32),
        np.ascontiguousarray(tlen, np.int32),
        J, QS, TS, W,
        params.a, params.b, params.q, params.e, params.q2, params.e2,
        params.sc_ambi, end_bonus, mode, zdrop,
        out_ops.reshape(-1), out_n, max_ops, out_info.reshape(-1),
    )
    res = []
    for j in range(J):
        n = int(out_n[j])
        if n < 0:
            return None
        # packed (len<<4|op) int32 array — stays packed end-to-end
        # through region parts and finalize_batch (no python tuples)
        res.append(
            (out_ops[j, :n].copy(), int(out_info[j, 0]),
             int(out_info[j, 1]), int(out_info[j, 2]),
             int(out_info[j, 3]))
        )
    return res
