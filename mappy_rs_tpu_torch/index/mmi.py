"""Reader/writer for minimap2 ``.mmi`` index files.

Equivalent of ``mm_idx_reader_open/read/close`` +
``mm_idx_load`` used by the reference's constructor
(/root/reference/src/lib.rs:395-413, SURVEY.md §2b N2).  Instead of
reconstructing the C core's bucketed khash, the on-disk data is
flattened into sorted, packed numpy arrays ready for device upload
(SURVEY.md §2b N3 "packed arrays").

On-disk layout (little endian):

  magic   "MMI\\x02"
  uint32  w, k, bucket_bits(b), n_seq, flag
  per seq: uint8 name_len, name bytes, uint32 seq_len
  per bucket i in [0, 2^b):
    uint32  n_p                  # length of position array p
    uint64  p[n_p]               # values: rid<<32 | pos_end<<1 | strand
    uint32  n_hash_entries
    per entry: uint64 key, uint64 val
       key = (minimizer_hash >> b) << 1 | is_singleton
       val = position value directly (singleton)
             or offset<<32 | count into p (multi)
    full minimizer hash = (key >> 1) << b | bucket_index
  if !(flag & MM_I_NO_SEQ):
    uint32  S[(sum_len+7)/8]     # 4-bit packed bases, 8 per word,
                                 # codes 0..4, contigs concatenated
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MM_IDX_MAGIC = b"MMI\x02"


@dataclass
class RawIndexData:
    """Decoded .mmi payload in flat arrays (host, numpy)."""

    k: int
    w: int
    bucket_bits: int
    flag: int
    seq_names: List[str]
    seq_lens: np.ndarray  # uint32 [n_seq]
    # minimizer table, sorted by key ascending
    keys: np.ndarray  # uint64 [n_keys]   full 2k-bit hash values
    key_offsets: np.ndarray  # uint64 [n_keys+1] prefix offsets into positions
    positions: np.ndarray  # uint64 [n_pos]  rid<<32 | pos_end<<1 | strand
    # packed reference bases, 4 bits per base, 8 per uint32 word
    packed_seq: np.ndarray | None  # uint32 [(sum_len+7)//8]

    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    @property
    def seq_offsets(self) -> np.ndarray:
        """Start offset of each contig in the concatenated reference."""
        return np.concatenate([[0], np.cumsum(self.seq_lens.astype(np.uint64))])


def load_mmi(path: str) -> RawIndexData:
    """Parse a .mmi file into flat sorted arrays."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != MM_IDX_MAGIC:
        raise RuntimeError(f"{path}: not a minimap2 index (bad magic)")
    w, k, b, n_seq, flag = struct.unpack_from("<5I", data, 4)
    off = 24
    names: List[str] = []
    lens = np.empty(n_seq, dtype=np.uint32)
    for i in range(n_seq):
        l = data[off]
        off += 1
        names.append(data[off : off + l].decode("ascii"))
        off += l
        (lens[i],) = struct.unpack_from("<I", data, off)
        off += 4

    all_keys: List[np.ndarray] = []
    all_counts: List[np.ndarray] = []
    all_pos: List[np.ndarray] = []
    for bucket in range(1 << b):
        (n_p,) = struct.unpack_from("<I", data, off)
        off += 4
        p = np.frombuffer(data, dtype="<u8", count=n_p, offset=off)
        off += 8 * n_p
        (n_h,) = struct.unpack_from("<I", data, off)
        off += 4
        if n_h == 0:
            continue
        kv = np.frombuffer(data, dtype="<u8", count=2 * n_h, offset=off).reshape(
            n_h, 2
        )
        off += 16 * n_h
        hkey, hval = kv[:, 0], kv[:, 1]
        full_key = ((hkey >> np.uint64(1)) << np.uint64(b)) | np.uint64(bucket)
        single = (hkey & np.uint64(1)) != 0
        counts = np.where(single, np.uint64(1), hval & np.uint64(0xFFFFFFFF))
        # gather the per-key position lists in key order
        order = np.argsort(full_key, kind="stable")
        pos_chunks: List[np.ndarray] = []
        for idx in order:
            if single[idx]:
                pos_chunks.append(hval[idx : idx + 1])
            else:
                start = int(hval[idx] >> np.uint64(32))
                cnt = int(hval[idx] & np.uint64(0xFFFFFFFF))
                pos_chunks.append(p[start : start + cnt])
        all_keys.append(full_key[order])
        all_counts.append(counts[order])
        all_pos.append(
            np.concatenate(pos_chunks) if pos_chunks else np.empty(0, dtype=np.uint64)
        )

    if all_keys:
        keys_cat = np.concatenate(all_keys)
        counts_cat = np.concatenate(all_counts)
        pos_cat = np.concatenate(all_pos)
        order = np.argsort(keys_cat, kind="stable")
        keys = keys_cat[order]
        counts = counts_cat[order]
        # reorder position chunks to match sorted key order
        chunk_ends = np.cumsum(counts_cat)
        chunk_starts = chunk_ends - counts_cat
        pos_sorted = np.concatenate(
            [pos_cat[chunk_starts[i] : chunk_ends[i]] for i in order]
        ) if len(order) else np.empty(0, dtype=np.uint64)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
    else:
        keys = np.empty(0, dtype=np.uint64)
        offsets = np.zeros(1, dtype=np.uint64)
        pos_sorted = np.empty(0, dtype=np.uint64)

    packed = None
    if not (flag & 0x2):  # MM_I_NO_SEQ
        sum_len = int(lens.astype(np.uint64).sum())
        n_words = (sum_len + 7) // 8
        packed = np.frombuffer(data, dtype="<u4", count=n_words, offset=off).copy()
        off += 4 * n_words

    return RawIndexData(
        k=k,
        w=w,
        bucket_bits=b,
        flag=flag,
        seq_names=names,
        seq_lens=lens,
        keys=keys,
        key_offsets=offsets,
        positions=pos_sorted,
        packed_seq=packed,
    )


def save_mmi(path: str, idx: RawIndexData) -> None:
    """Serialise flat arrays back into minimap2's .mmi layout.

    The reference refuses ``fn_idx_out=`` with NotImplementedError
    (/root/reference/src/lib.rs:391-394); this build supports it.
    """
    b = idx.bucket_bits
    nbuckets = 1 << b
    keys = idx.keys
    counts = (idx.key_offsets[1:] - idx.key_offsets[:-1]).astype(np.uint64)
    bucket_of = (keys & np.uint64(nbuckets - 1)).astype(np.int64)
    out = bytearray()
    out += MM_IDX_MAGIC
    out += struct.pack("<5I", idx.w, idx.k, b, idx.n_seq, idx.flag)
    for name, ln in zip(idx.seq_names, idx.seq_lens):
        nb = name.encode("ascii")
        out += struct.pack("<B", len(nb)) + nb + struct.pack("<I", int(ln))
    order = np.argsort(bucket_of, kind="stable")
    ptr = 0
    # group keys by bucket
    by_bucket: List[List[int]] = [[] for _ in range(nbuckets)]
    for ki in range(len(keys)):
        by_bucket[int(bucket_of[ki])].append(ki)
    for bucket in range(nbuckets):
        kis = by_bucket[bucket]
        p_vals: List[int] = []
        entries: List[Tuple[int, int]] = []
        for ki in kis:
            cnt = int(counts[ki])
            start = int(idx.key_offsets[ki])
            hkey = (int(keys[ki]) >> b) << 1
            if cnt == 1:
                entries.append((hkey | 1, int(idx.positions[start])))
            else:
                entries.append((hkey, (len(p_vals) << 32) | cnt))
                p_vals.extend(int(x) for x in idx.positions[start : start + cnt])
        out += struct.pack("<I", len(p_vals))
        out += np.asarray(p_vals, dtype="<u8").tobytes()
        out += struct.pack("<I", len(entries))
        for hk, hv in entries:
            out += struct.pack("<2Q", hk, hv)
    if not (idx.flag & 0x2) and idx.packed_seq is not None:
        out += idx.packed_seq.astype("<u4").tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def unpack_seq(packed: np.ndarray, start: int, end: int) -> np.ndarray:
    """Extract base codes [start, end) from the 4-bit packed array."""
    idx = np.arange(start, end, dtype=np.int64)
    words = packed[idx >> 3]
    shifts = ((idx & 7) << 2).astype(np.uint32)
    return ((words >> shifts) & np.uint32(0xF)).astype(np.uint8)


def pack_seq(codes: np.ndarray) -> np.ndarray:
    """Pack 0..4 base codes into the 4-bit/uint32-word layout."""
    n = len(codes)
    n_words = (n + 7) // 8
    padded = np.zeros(n_words * 8, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(n_words, 8)
    shifts = (np.arange(8, dtype=np.uint32) << 2)[None, :]
    return (padded << shifts).astype(np.uint32).sum(axis=1, dtype=np.uint32)
