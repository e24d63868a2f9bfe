"""Reference index builder: FASTA -> MinimizerIndex.

The port of the JAX package's index/build.py.  Contigs are sketched by
the native C++ contig sketcher when the host library builds (the same
emission engine as the CPU read path, bit-exact with the device
sketch), else by the torch sketch (ops/sketch.py) in fixed-size
overlapping chunks on the configured device; only the emitted
(key, pos, strand) triples return to the host.  The sort/unique pass
runs with torch on the device the index is built for.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import IndexOptions
from ..utils.seqcodes import encode, read_fasta_codes
from .index import MinimizerIndex, host_int64, resolve_device
from .mmi import load_mmi

# chunk size for device sketching of long contigs
_CHUNK = 1 << 20


def _sketch_contig_device(codes: np.ndarray, k: int, w: int,
                          device="cpu", is_hpc: bool = False) -> np.ndarray:
    """Sketch one contig with the torch sketch on `device`; returns
    [n, 3] uint64 rows (key, pos_end, strand).  With is_hpc the contig
    is homopolymer-compressed on the host first; emitted positions map
    back to uncompressed run-end coordinates."""
    from ..ops.sketch import compress_hpc, hpc_spans, sketch

    pos_map = force = None
    if is_hpc:
        cc, cl, run_end, run_len = compress_hpc(
            codes[None, :], np.asarray([len(codes)], np.int64))
        n_c = int(cl[0])
        pos_map = run_end[0][:n_c]
        force = hpc_spans(run_len, k)[0][:n_c] >= 256
        codes = cc[0][:n_c]
    L = len(codes)
    left, right = w + 2 * k, w + 1
    out_rows: List[np.ndarray] = []
    start = 0
    while start < L:
        keep_end = min(start + _CHUNK, L)
        lo = max(start - left, 0)
        hi = min(keep_end + right, L)
        chunk = codes[lo:hi]
        # true length: for the final chunk the final-flush clause fires
        # at the real contig end; for middle chunks the fake end lies in
        # the discarded right overlap (right > w-1)
        padded = torch.full((1, len(chunk)), 4, dtype=torch.uint8)
        padded[0] = torch.from_numpy(np.ascontiguousarray(chunk))
        force_inf = None
        if force is not None:
            force_inf = torch.from_numpy(force[None, lo:hi]).to(device)
        res = sketch(padded.to(device),
                     torch.tensor([len(chunk)], device=device), k, w,
                     force_inf)
        pos_all = np.nonzero(res["minimizer"][0].cpu().numpy())[0]
        keep_lo, keep_hi = start - lo, keep_end - lo
        pos = pos_all[(pos_all >= keep_lo) & (pos_all < keep_hi)]
        key = res["key"][0].cpu().numpy()[pos].astype(np.uint64)
        strand = res["strand"][0].cpu().numpy()[pos].astype(np.uint64)
        abs_pos = pos - keep_lo + start
        if pos_map is not None:  # compressed -> uncompressed position
            abs_pos = pos_map[abs_pos]
        out_rows.append(
            np.stack([key, abs_pos.astype(np.uint64), strand], axis=1))
        start = keep_end
    if not out_rows:
        return np.empty((0, 3), np.uint64)
    return np.concatenate(out_rows, axis=0)


def _sketch_contig_native(codes: np.ndarray, k: int, w: int, is_hpc: bool):
    """C++ contig sketcher (native/front_end.cc sketch_contig); None
    when the native lib is unavailable."""
    from .. import native

    res = native.sketch_contig(codes, k, w, is_hpc)
    if res is None:
        return None
    keys, y = res
    return np.stack([keys, y >> np.uint64(1), y & np.uint64(1)], axis=1)


def sort_positions(keys_all: np.ndarray, y_all: np.ndarray, device="cpu"):
    """(sorted unique keys, key offsets [n + 1], positions) of the
    sketched (key, y) pairs, all uint64, by one stable torch sort of the
    keys on `device` (the card for an index built for the card).  A
    stable sort by key alone == lexsort((y, key)): rows are appended in
    (rid, pos) order and a minimizer position holds one strand, so
    within equal keys insertion order IS y order.  Keys (< 2^62) and y
    (rid < 2^31) sort as int64.  Raises where the device cannot hold
    the sort: there is no other route."""
    dev = resolve_device(device)
    k_sorted, order = torch.sort(host_int64(keys_all, dev), stable=True)
    if len(k_sorted) and int(k_sorted[0]) < 0:
        raise ValueError("minimizer keys of 64 bits: at most 62 fit")
    positions = host_int64(y_all, dev)[order]
    del order
    first = torch.ones(len(k_sorted), dtype=torch.bool, device=dev)
    torch.ne(k_sorted[1:], k_sorted[:-1], out=first[1:])
    first = torch.nonzero(first).squeeze(1)
    uniq = k_sorted[first]
    del k_sorted
    offsets = torch.cat([first, first.new_tensor([len(keys_all)])])

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().view(np.uint64)

    return host(uniq), host(offsets), host(positions)


def build_index(
    seqs: Sequence[Tuple[str, str]],
    opts: IndexOptions | None = None,
    device="cpu",
    n_threads: int = 0,
) -> MinimizerIndex:
    """Build a MinimizerIndex from (name, sequence) pairs.

    ``n_threads`` parallelizes native contig sketching across host
    threads (the C call releases the GIL); 0 = one per CPU.  ``device``
    is where the positions are sorted (sort_positions), and where the
    torch sketch runs when the native sketcher is absent.  The index's
    build_seconds holds the seconds of the sketch and of the sort.
    """
    opts = opts or IndexOptions()
    is_hpc = bool(opts.flag & 0x1)  # MM_I_HPC
    k, w = opts.k, opts.w
    names: List[str] = []
    lens: List[int] = []
    all_codes: List[np.ndarray] = []
    jobs: List[Tuple[int, np.ndarray]] = []  # (rid, codes) to sketch
    for rid, (name, seq) in enumerate(seqs):
        codes = seq if isinstance(seq, np.ndarray) else encode(seq)
        names.append(name)
        lens.append(len(codes))
        all_codes.append(codes)
        if len(codes) >= k:
            jobs.append((rid, codes))

    def _sketch_one(job: Tuple[int, np.ndarray]):
        """(keys, y = rid << 32 | pos << 1 | strand) of one contig."""
        rid, codes = job
        rows = _sketch_contig_native(codes, k, w, is_hpc)
        if rows is None:
            rows = _sketch_contig_device(codes, k, w, device, is_hpc)
        return (np.ascontiguousarray(rows[:, 0]),
                (np.uint64(rid) << np.uint64(32))
                | (rows[:, 1] << np.uint64(1)) | rows[:, 2])

    from .. import native as _native

    t_sketch = time.perf_counter()
    if n_threads <= 0:
        import os

        n_threads = os.cpu_count() or 1
    if n_threads > 1 and len(jobs) > 1 and _native.available():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            parts = list(ex.map(_sketch_one, jobs))
    else:
        parts = [_sketch_one(j) for j in jobs]
    parts = [p for p in parts if len(p[0])]

    t_sort = time.perf_counter()
    if parts:
        keys_all = np.concatenate([p[0] for p in parts])
        y_all = np.concatenate([p[1] for p in parts])
        del parts
        uniq, offsets, positions = sort_positions(keys_all, y_all, device)
        del keys_all, y_all
    else:
        uniq = np.empty(0, np.uint64)
        offsets = np.zeros(1, np.uint64)
        positions = np.empty(0, np.uint64)
    t_end = time.perf_counter()

    return MinimizerIndex(
        k=k,
        w=w,
        bucket_bits=opts.bucket_bits,
        flag=opts.flag & 0x7,
        seq_names=names,
        seq_lens=np.asarray(lens, np.uint32),
        keys=uniq,
        key_offsets=offsets,
        positions=positions,
        ref_codes=np.concatenate(all_codes) if all_codes else np.empty(0, np.uint8),
        build_seconds={"sketch": t_sort - t_sketch, "sort": t_end - t_sort},
    )


def load_or_build(path: str, opts: IndexOptions | None = None,
                  device="cpu") -> MinimizerIndex:
    """Open a .mmi index or build one from FASTA/FASTQ — the behaviour
    of ``mm_idx_reader_open/read`` (lib.rs:395-413)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"MMI\x02":
        return MinimizerIndex.from_raw(load_mmi(path))
    return build_index(read_fasta_codes(path), opts, device=device)
