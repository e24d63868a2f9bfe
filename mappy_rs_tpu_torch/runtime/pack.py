"""Packed result blocks for the worker-process IPC boundary.

A chunk's results cross the process pipe as ONE tuple of flat numpy
arrays and two byte blobs instead of pickled per-read ``Mapping``
objects (one object tree per hit: a 16-field tuple, a CIGAR array and a
cs string); the parent rebuilds the ``Mapping`` objects with direct slot
writes.  Every Mapping field round-trips exactly, including None vs ""
for cs/MD and list-form CIGARs from the Python path
(tests/test_torch_runtime.py).

Layout (one block per mapped chunk of ``n`` unique reads):
  counts  int32 [n]        mappings per read, after the no_2nd filter
  F       int32 [t, 15]    qs qe rev rid rs re mlen blen mapq primary
                           nm trans_strand cig_len cs_len md_len
                           (cs_len/md_len are -1 when the tag is None)
  cig     int32 [sum cig]  packed (len<<4|op) ops, concatenated
  cs_blob bytes            cs tags, concatenated
  md_blob bytes            MD tags, concatenated

The JAX package has the same module (its runtime/pack.py); this is the
port's own copy.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_EMPTY_I32 = np.empty(0, np.int32)


def _gather_segments(buf: np.ndarray, starts, lens) -> np.ndarray:
    """Concatenate buf[starts[i] : starts[i]+lens[i]] for every i in one
    fancy-index gather."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return buf[:0]
    ends = np.cumsum(lens)
    # for each output position: its segment's cumulative start
    seg_base = np.repeat(ends - lens, lens)
    idx = np.repeat(np.asarray(starts, np.int64), lens) + (
        np.arange(total, dtype=np.int64) - seg_base
    )
    return buf[idx]


def _segment_offsets(rows: np.ndarray):
    """Per-row (length, offset) of the cig, cs and MD segments."""
    out = []
    for col in (12, 13, 14):
        n = np.where(rows[:, col] >= 0, rows[:, col], 0).astype(np.int64)
        out.append((n, np.cumsum(n) - n))
    return out


class PackedSink:
    """Collects a batch's results straight into the packed block,
    without Region objects for the reads that the native post-chain
    finishes: its flat output arrays are gathered into the block.

    Protocol: AlignmentEngine.map_batch_packed / post_chain_packed
    create the sink and pass it down; _post_chain_native calls
    add_native(chunk, ...) per batch instead of building Regions, and
    mark_python for its fallback reads, which the Python path finishes
    into `out` as before.  An anchor-overflow retry re-maps a read and
    overwrites its earlier rowset through `src`.  finish(out) merges the
    native rowsets with the Python-path reads into one block, in read
    order, equal to pack_regions_block over the Region path."""

    def __init__(self, n_reads: int, no_2nd: bool) -> None:
        self.no_2nd = no_2nd
        #: rowset that owns each read, -1 = the Python path
        self.src = np.full(n_reads, -1, np.int64)
        self.rowsets: List[tuple] = []

    def add_native(self, chunk, nreg, fields, cig, ncig,
                   raw_tags, fallback) -> None:
        """One batch's post_chain.cc output -> a compact rowset.
        chunk: the global read index of each batch row; fallback rows
        are skipped."""
        from ..native import PC_FIELDS

        F = {n: i for i, n in enumerate(PC_FIELDS)}
        cs_buf, cs_len, md_buf, md_len, tag_cap = raw_tags
        _B, K = ncig.shape
        chunk = np.asarray(chunk, np.int64)
        Bc = len(chunk)
        ok = ~fallback[:Bc].astype(bool)
        slot = np.arange(K)[None, :] < nreg[:Bc, None]
        mask = slot & ok[:, None]
        if self.no_2nd:
            mask &= (fields[:Bc, :, F["parent"]]
                     == fields[:Bc, :, F["id"]])
        bi, oi = np.nonzero(mask)  # row-major: read order, slot order
        rs_id = len(self.rowsets)
        # claim the reads first (overwrites an earlier rowset's claim)
        self.src[chunk[ok]] = rs_id
        rows = np.empty((len(bi), 15), np.int32)
        fb = fields[bi, oi]
        for col, name in enumerate(("qs", "qe", "rev", "rid", "rs", "re",
                                    "mlen", "blen", "mapq")):
            rows[:, col] = fb[:, F[name]]
        rows[:, 9] = fb[:, F["parent"]] == fb[:, F["id"]]
        rows[:, 10] = fb[:, F["nm"]]
        rows[:, 11] = 0  # trans_strand: the native path is non-splice
        nc = ncig[bi, oi].astype(np.int64)
        rows[:, 12] = nc
        cigcap = cig.shape[2]
        cig_blob = _gather_segments(
            cig.reshape(-1), (bi * K + oi) * cigcap, nc
        )

        def tag_blob(buf, lens_arr):
            v = lens_arr[bi, oi]
            have = v >= 0
            n = np.where(have, v & 0xFFFFFFFF, 0)
            starts = (bi * K + (v >> 32)) * tag_cap
            blob = _gather_segments(buf, starts[have], n[have])
            return blob, np.where(have, n, -1).astype(np.int32)

        cs_blob, rows[:, 13] = tag_blob(cs_buf, cs_len)
        md_blob, rows[:, 14] = tag_blob(md_buf, md_len)
        self.rowsets.append((chunk[bi], rows, cig_blob, cs_blob, md_blob))

    def mark_python(self, reads) -> None:
        """Reads whose results will come from the Python Region path;
        drops any native claim."""
        if len(reads):
            self.src[np.asarray(reads, np.int64)] = -1

    def finish(self, regs_lists) -> tuple:
        """Merge the native rowsets and the Python-path reads into one
        block, in read order."""
        n = len(regs_lists)
        py_reads = np.nonzero(self.src < 0)[0]
        parts = []  # (read_idx, rows, cig_blob, cs_blob, md_blob)
        for rs_id, (ridx, rows, cigb, csb, mdb) in enumerate(self.rowsets):
            keep = self.src[ridx] == rs_id
            if keep.all():
                parts.append((ridx, rows, cigb, csb, mdb))
                continue
            # a later retry re-mapped some of this rowset's reads: drop
            # their rows and their cig/cs/md segments
            (nc, coff), (csn, csoff), (mdn, mdoff) = _segment_offsets(rows)
            parts.append((
                ridx[keep], rows[keep],
                _gather_segments(cigb, coff[keep], nc[keep]),
                _gather_segments(csb, csoff[keep], csn[keep]),
                _gather_segments(mdb, mdoff[keep], mdn[keep]),
            ))
        if len(py_reads):
            cnts, F, cigb, csb, mdb = pack_regions_block(
                [regs_lists[i] for i in py_reads], self.no_2nd
            )
            parts.append((
                np.repeat(py_reads, cnts), F, cigb,
                np.frombuffer(csb, np.uint8), np.frombuffer(mdb, np.uint8),
            ))
        if not parts:
            return (np.zeros(n, np.int32), np.empty((0, 15), np.int32),
                    _EMPTY_I32, b"", b"")
        read_idx = np.concatenate([p[0] for p in parts])
        rows = np.vstack([p[1] for p in parts]).astype(np.int32, copy=False)
        cig_all = np.concatenate(
            [np.asarray(p[2], np.int32) for p in parts]
        )
        cs_all = np.concatenate([np.asarray(p[3], np.uint8) for p in parts])
        md_all = np.concatenate([np.asarray(p[4], np.uint8) for p in parts])
        order = np.argsort(read_idx, kind="stable")
        counts = np.bincount(read_idx, minlength=n).astype(np.int32)
        if not len(order) or bool((order[1:] > order[:-1]).all()):
            return (counts, rows, cig_all, cs_all.tobytes(),
                    md_all.tobytes())
        (nc, coff), (csn, csoff), (mdn, mdoff) = _segment_offsets(rows)
        return (
            counts,
            rows[order],
            _gather_segments(cig_all, coff[order], nc[order]),
            _gather_segments(cs_all, csoff[order], csn[order]).tobytes(),
            _gather_segments(md_all, mdoff[order], mdn[order]).tobytes(),
        )


def pack_regions_block(
    regs_lists, no_2nd: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bytes, bytes]:
    """Finished per-read Region lists -> one packed block.

    Mirrors api.regions_to_mappings field for field; regions with
    list-form CIGARs (the Python path) are packed through
    ops.cigar.pack_ops."""
    from ..ops.cigar import pack_ops

    counts = np.empty(len(regs_lists), np.int32)
    rows: List[tuple] = []
    cigs: List[np.ndarray] = []
    cs_parts: List[bytes] = []
    md_parts: List[bytes] = []
    for i, regs in enumerate(regs_lists):
        k = 0
        for r in regs:
            primary = r.parent == r.id
            if no_2nd and not primary:
                continue
            k += 1
            c = r.cigar
            if c is None:
                c = _EMPTY_I32
            elif type(c) is not np.ndarray:
                c = pack_ops(c)
            cigs.append(c)
            if r.cs is None:
                cs_len = -1
            else:
                b = r.cs.encode()
                cs_parts.append(b)
                cs_len = len(b)
            if r.md is None:
                md_len = -1
            else:
                b = r.md.encode()
                md_parts.append(b)
                md_len = len(b)
            rows.append((
                r.qs, r.qe, r.rev, r.rid, r.rs, r.re, r.mlen, r.blen,
                r.mapq, 1 if primary else 0, r.nm,
                getattr(r, "trans_strand", 0), len(c), cs_len, md_len,
            ))
        counts[i] = k
    F = (
        np.array(rows, np.int32)
        if rows else np.empty((0, 15), np.int32)
    )
    cig = np.concatenate(cigs) if cigs else _EMPTY_I32
    return counts, F, cig, b"".join(cs_parts), b"".join(md_parts)


def unpack_mappings_block(
    payload, seq_names, seq_lens
) -> List[list]:
    """Packed block -> per-read List[Mapping] lists (the parent side)."""
    from ..api import Mapping, Strand

    counts, F, cig, cs_blob, md_blob = payload
    rows = F.tolist()
    out: List[list] = []
    j = 0
    cig_off = 0
    cs_off = 0
    md_off = 0
    fwd, rev = Strand.Forward, Strand.Reverse
    new = Mapping.__new__
    for n in counts.tolist():
        ms = []
        for _ in range(n):
            (qs, qe, rv, rid, rs, re, mlen, blen, mapq, pri, nm, ts,
             ncig, ncs, nmd) = rows[j]
            j += 1
            m = new(Mapping)
            m.query_start = qs
            m.query_end = qe
            m._strand = fwd if rv == 0 else rev
            m.target_name = seq_names[rid]
            m.target_len = int(seq_lens[rid])
            m.target_start = rs
            m.target_end = re
            m.match_len = mlen
            m.block_len = blen
            m.mapq = mapq
            m.is_primary = bool(pri)
            m._cig = cig[cig_off:cig_off + ncig]
            cig_off += ncig
            if ncs >= 0:
                m.cs = cs_blob[cs_off:cs_off + ncs].decode()
                cs_off += ncs
            else:
                m.cs = None
            if nmd >= 0:
                m.MD = md_blob[md_off:md_off + nmd].decode()
                md_off += nmd
            else:
                m.MD = None
            m.NM = nm
            m.trans_strand = ts
            ms.append(m)
        out.append(ms)
    return out
