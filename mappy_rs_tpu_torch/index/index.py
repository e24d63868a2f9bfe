"""MinimizerIndex: host index arrays plus their device tensors.

Host side: the sorted unique minimizer keys, per-key position offsets
and the packed position array (numpy), exactly as the JAX package
keeps them.  Device side (``DeviceIndex``): the flat lookup tables the
front end gathers from, built by ``_build_device`` with torch on the
configured device from one upload of the host arrays.

Two hash-probe layouts, chosen by the widest key as in the JAX
package: one word (int32 slots) for keys of at most 31 bits, two words
(one int64 slot) for keys of 32 to 62 bits (k >= 16).  The JAX
package's bucketed binary search serves only an index with no keys
here: the one-word table answers that too (it finds nothing).

Also covers:
  N4 mm_mapopt_update  -> ``update_map_options`` (mid_occ quantile)
  N5 mm_idx_index_name -> ``name2id`` dict
  N6 mm_idx_getseq     -> ``get_seq`` (host) over the packed reference
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MapOptions
from .mmi import RawIndexData, pack_seq, unpack_seq

#: Fibonacci multiplier for the hash-probe bucket mix (golden-ratio
#: odd constant).  Device probes must use the same constant
#: (ops/lookup.py probe_index).
HASH_MIX = np.uint32(0x9E3779B1)
HASH_MIX2 = np.uint32(0x85EBCA6B)  # two-word probe: mixes the upper word


@dataclass
class DeviceIndex:
    """Device-side flat lookup tables (torch tensors on one device).

    Coordinate model: every device-side position is PER-CONTIG
    (pos_rp[:, 1] = pos_end<<1|strand within the contig, rid in
    pos_rp[:, 0]), so the device path supports references of any total
    length — only a single contig is bounded (< 2^31 bp, minimap2's own
    limit).

    Hash-probe layout: an ordered-linear-probing open-addressing table
    over the minimizer keys.  ``hash_rows`` holds the stored keys
    reshaped [T/128 + 1, 128] (-1 = empty: keys are non-negative, so
    the sentinel never collides) so a query's whole probe window (its
    slot plus <= 128 displacement) is ONE two-row gather; ``hash_val``
    maps the matched slot back to the sorted-key index (n_keys = empty)
    for ``offcnt``.  One word: int32 slots and slot = mix(key); two
    words: int64 slots and slot = mix(lo32 ^ mix2(key >> 31)), the JAX
    package's hash2 layout with its (fingerprint, upper) word pair kept
    as the one key it encodes."""

    offcnt: torch.Tensor  # int32 [n_keys_pad, 2] (start into positions, count)
    pos_rp: torch.Tensor  # int32 [n_pos, 2] (rid, bitcast(pos_end<<1|strand))
    hash_rows: torch.Tensor  # int32 or int64 [T/128 + 1, 128]
    hash_val: torch.Tensor  # int32 [T + 128]
    n_keys: int
    hash_bits: int  # T = 2^hash_bits
    hash_shift: int  # slot = mix(key) >> hash_shift

    @property
    def two_word(self) -> bool:
        """Whether the table holds keys wider than 31 bits (int64 slots)."""
        return self.hash_rows.dtype == torch.int64

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.offcnt, self.pos_rp, self.hash_rows, self.hash_val)
        )


def resolve_device(device) -> torch.device:
    """torch.device for an AlignerConfig.device value.  "cuda" without
    a usable card raises: the port never moves to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the front end on the CPU"
        )
    return dev


def mix32(key: torch.Tensor, two_word: bool) -> torch.Tensor:
    """The hash-probe tables' 32-bit mix of int64 keys, as int64 in
    [0, 2^32): fib_mix(lo32) for one word, fib_mix(lo32 ^
    mix2(key >> 31)) for two (the JAX package's uint32 arithmetic).
    The table's slot is mix32(key) >> hash_shift."""
    if two_word:
        up = (key >> 31) & 0xFFFFFFFF
        key = key ^ _mul32(up, int(HASH_MIX2))
    return _mul32(key & 0xFFFFFFFF, int(HASH_MIX))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the uint32 multiply,
    in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def host_int64(a: np.ndarray, device) -> torch.Tensor:
    """A host integer array (uint64 values under 2^63) as an int64
    tensor on `device`.  Read-only arrays (the memory maps of
    index/share.py) are taken as they are: the tensor is only read,
    copied to the card or by the ops that take it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int64))
    return t.to(device)


@dataclass
class MinimizerIndex:
    """Host+device minimizer index."""

    k: int
    w: int
    bucket_bits: int
    flag: int
    seq_names: List[str]
    seq_lens: np.ndarray
    keys: np.ndarray  # uint64 [n] sorted
    key_offsets: np.ndarray  # uint64 [n+1]
    positions: np.ndarray  # uint64 [m]: rid<<32 | pos_end<<1 | strand
    ref_codes: np.ndarray  # uint8 [sum_len] 0..4
    _devices: Dict[str, DeviceIndex] = field(default_factory=dict)
    #: seconds of this index's build steps: "sketch" and "sort" from
    #: build_index, "upload" and "tables" from the last device build
    build_seconds: Dict[str, float] = field(default_factory=dict)
    _name2id: Optional[Dict[str, int]] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    # -- introspection (reference parity) ------------------------------
    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    @property
    def seq_offsets(self) -> np.ndarray:
        # cached: hot per-read paths read this; seq_lens is immutable
        # after construction
        so = getattr(self, "_seq_offsets_cache", None)
        if so is None:
            so = np.concatenate(
                [[0], np.cumsum(self.seq_lens.astype(np.int64))]
            ).astype(np.int64)
            object.__setattr__(self, "_seq_offsets_cache", so)
        return so

    @property
    def name2id(self) -> Dict[str, int]:
        """mm_idx_index_name equivalent (lib.rs:416)."""
        if self._name2id is None:
            self._name2id = {n: i for i, n in enumerate(self.seq_names)}
        return self._name2id

    def get_seq(self, name: str, start: int = 0, end: int = 2147483647) -> str:
        """mm_idx_getseq equivalent with the reference's clamp semantics
        (lib.rs:706-766).  Raises on invalid input; the Python API layer
        converts errors to None."""
        if self.flag & 0x2:  # MM_I_NO_SEQ
            raise ValueError("No sequence in this index")
        rid = self.name2id.get(name, -1)
        if rid < 0 or rid >= self.n_seq:
            raise KeyError("Could not find reference in index")
        ref_len = int(self.seq_lens[rid])
        if start >= ref_len or start >= end:
            raise ValueError("Funky start and end coords")
        if end < 0 or end > ref_len:
            end = ref_len
        off = int(self.seq_offsets[rid])
        codes = self.ref_codes[off + start : off + end]
        if np.any(codes > 4):
            raise ValueError("Got an unknown char, not {ACGTN}")
        from ..utils.seqcodes import decode

        return decode(codes)

    # -- occurrence statistics (mm_mapopt_update / mm_idx_cal_max_occ) --
    def cal_max_occ(self, frac: float) -> int:
        """(1-frac) quantile of per-key occurrence counts, plus one."""
        if frac <= 0.0:
            return 2147483647
        counts = (self.key_offsets[1:] - self.key_offsets[:-1]).astype(np.int64)
        n = len(counts)
        if n == 0:
            return 2147483647
        kth = min(int((1.0 - frac) * n), n - 1)
        return int(np.partition(counts, kth)[kth]) + 1

    def update_map_options(self, opt: MapOptions) -> None:
        """mm_mapopt_update equivalent (lib.rs:414)."""
        if opt.mid_occ <= 0:
            opt.mid_occ = self.cal_max_occ(opt.mid_occ_frac)
            if opt.mid_occ < opt.min_mid_occ:
                opt.mid_occ = opt.min_mid_occ
            if opt.max_mid_occ > opt.min_mid_occ and opt.mid_occ > opt.max_mid_occ:
                opt.mid_occ = opt.max_mid_occ
        if opt.bw_long < opt.bw:
            opt.bw_long = opt.bw

    # -- device upload --------------------------------------------------
    def device_index(self, device) -> DeviceIndex:
        """The lookup tables on `device`, built and uploaded once per
        device (thread-safe)."""
        dev = resolve_device(device)
        with self._lock:
            d = self._devices.get(str(dev))
            if d is None:
                d = self._devices[str(dev)] = self._build_device(dev)
            return d

    def _build_device(self, device: torch.device) -> DeviceIndex:
        """The hash-probe tables, built with torch on `device` from the
        host arrays (uploaded once), with stable sorts: the card builds
        them when the index is for the card, the CPU in the tests.  The
        arrays equal the JAX package's DeviceIndex hash1 / hash2 layouts
        (index/index.py _build_device) array for array, with hash_rows
        as the int32 view of its uint32 words (one word) or as the key
        its two words encode (two words).  Records its seconds in
        build_seconds ("upload", "tables")."""
        n = len(self.keys)
        if len(self.seq_lens) and int(self.seq_lens.max()) >= 2**31:
            raise OverflowError(
                "a single contig exceeds 2^31 bp; per-contig device "
                "coordinates (and minimap2 itself) cap contigs at 2^31"
            )
        eff = int(self.keys[-1]).bit_length() if n else 1
        if eff > 62:
            raise ValueError(f"minimizer keys of {eff} bits: at most 62 "
                             "(k <= 31) fit the hash-probe tables")
        two_word = eff > 31
        t0 = time.perf_counter()
        keys = host_int64(self.keys, device)
        offs = host_int64(self.key_offsets, device)
        pos = host_int64(self.positions, device)
        t1 = time.perf_counter()
        n_pad = max(((n + 127) // 128) * 128, 128)
        offcnt = torch.zeros((n_pad, 2), dtype=torch.int32, device=device)
        offcnt[:n, 0] = offs[:n].to(torch.int32)
        offcnt[:n, 1] = (offs[1:] - offs[:-1]).to(torch.int32)
        del offs
        m = len(self.positions)
        pos_rp = torch.zeros((max(m, 8), 2), dtype=torch.int32, device=device)
        pos_rp[:m, 0] = (pos >> 32).to(torch.int32)
        lo = pos & 0xFFFFFFFF
        pos_rp[:m, 1] = (lo - ((lo >> 31) << 32)).to(torch.int32)  # bitcast
        del pos, lo
        # slot = fib_mix(key) >> (32 - t); keys are placed in mixed
        # order, the ordered-linear-probing layout is a prefix max, and
        # t grows until every displacement fits the 2-row window
        t = max(int(n / 0.75).bit_length(), 8)
        mixed = mix32(keys, two_word)
        i = torch.arange(n, device=device)
        order = slot = i
        while n:
            if t > 32:
                raise ValueError(f"{n} keys need a hash table of more "
                                 "than 2^32 slots")
            h, order = torch.sort(mixed >> (32 - t), stable=True)
            slot = i + torch.cummax(h - i, 0).values
            if int((slot - h).max()) <= 128:
                break
            t += 1
        del mixed, i
        T = 1 << t
        rows = T // 128 + 1
        hval = torch.full((rows * 128,), n, dtype=torch.int32, device=device)
        hval[slot] = order.to(torch.int32)  # sentinel idx = n
        hkeys = torch.full((rows * 128,), -1, device=device,
                           dtype=torch.int64 if two_word else torch.int32)
        hkeys[slot] = keys[order].to(hkeys.dtype)
        del keys, order, slot
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_seconds.update(upload=t1 - t0,
                                  tables=time.perf_counter() - t1)
        return DeviceIndex(
            offcnt=offcnt,
            pos_rp=pos_rp,
            hash_rows=hkeys.view(rows, 128),
            hash_val=hval[: T + 128],
            n_keys=n,
            hash_bits=t,
            hash_shift=32 - t,
        )

    # -- conversions ----------------------------------------------------
    @classmethod
    def from_raw(cls, raw: RawIndexData) -> "MinimizerIndex":
        if raw.packed_seq is not None:
            total = int(raw.seq_lens.astype(np.int64).sum())
            ref_codes = unpack_seq(raw.packed_seq, 0, total)
        else:
            ref_codes = np.empty(0, np.uint8)
        return cls(
            k=raw.k,
            w=raw.w,
            bucket_bits=raw.bucket_bits,
            flag=raw.flag,
            seq_names=list(raw.seq_names),
            seq_lens=raw.seq_lens.copy(),
            keys=raw.keys,
            key_offsets=raw.key_offsets,
            positions=raw.positions,
            ref_codes=ref_codes,
        )

    def to_raw(self) -> RawIndexData:
        return RawIndexData(
            k=self.k,
            w=self.w,
            bucket_bits=self.bucket_bits,
            flag=self.flag,
            seq_names=list(self.seq_names),
            seq_lens=self.seq_lens.astype(np.uint32),
            keys=self.keys,
            key_offsets=self.key_offsets,
            positions=self.positions,
            packed_seq=None if (self.flag & 0x2) else pack_seq(self.ref_codes),
        )


def index_from_jax(jax_index, device="cpu") -> MinimizerIndex:
    """Port MinimizerIndex from the JAX package's MinimizerIndex (or any
    object with the same host numpy arrays), with its lookup tables
    uploaded to `device`.  Reads attributes only: imports nothing of
    the JAX package."""
    idx = MinimizerIndex(
        k=jax_index.k,
        w=jax_index.w,
        bucket_bits=jax_index.bucket_bits,
        flag=jax_index.flag,
        seq_names=list(jax_index.seq_names),
        seq_lens=np.asarray(jax_index.seq_lens),
        keys=np.asarray(jax_index.keys),
        key_offsets=np.asarray(jax_index.key_offsets),
        positions=np.asarray(jax_index.positions),
        ref_codes=np.asarray(jax_index.ref_codes),
    )
    idx.device_index(device)
    return idx
