"""Base-code tables and FASTA/FASTQ helpers (host side).

Encoding convention matches the 2-bit nucleotide order used throughout
minimap2-style indexes: A=0, C=1, G=2, T/U=3, anything else=4 (ambiguous).
The reference decodes index sequence bytes the same way
(/root/reference/src/lib.rs:755-764).
"""
from __future__ import annotations

import gzip
from typing import Iterator, Tuple

import numpy as np

# ASCII -> 0..4 lookup (case-insensitive); 4 == ambiguous.
SEQ_NT4: np.ndarray = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4[ord(_c)] = _i
    SEQ_NT4[ord(_c.lower())] = _i
SEQ_NT4[ord("U")] = 3
SEQ_NT4[ord("u")] = 3

CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII sequence into 0..4 codes (uint8 ndarray)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return SEQ_NT4[raw]


def decode(codes: np.ndarray) -> str:
    """Decode 0..4 codes back to an ACGTN string."""
    return CODE_TO_BASE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (4/N maps to itself)."""
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1]


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta_codes(path: str):
    """Fast FASTA reader: returns [(name, codes ndarray)] with the whole
    file processed through vectorized numpy (≈memory-bandwidth speed —
    matters for GRCh38-scale index builds where a line-by-line python
    parse takes a minute).  Falls back to read_fastx for FASTQ/gzip.
    """
    with open(path, "rb") as fh:
        head = fh.read(1)
    if head != b">":
        return [(n, encode(s)) for n, s in read_fastx(path)]
    raw = np.fromfile(path, dtype=np.uint8)
    nl = np.nonzero(raw == 10)[0]
    line_starts = np.concatenate([[0], nl + 1])
    line_starts = line_starts[line_starts < len(raw)]
    hdr_starts = line_starts[raw[line_starts] == ord(">")]
    bounds = np.concatenate([hdr_starts, [len(raw)]])
    out = []
    for i in range(len(hdr_starts)):
        s, e = int(bounds[i]), int(bounds[i + 1])
        # header line = up to first newline
        nl_pos = s + int(np.argmax(raw[s : min(s + (1 << 16), e)] == 10))
        header = raw[s + 1 : nl_pos].tobytes().decode("ascii", "replace")
        name = header.split()[0] if header.split() else ""
        seg = raw[nl_pos + 1 : e]
        keep = (seg != 10) & (seg != 13)
        out.append((name, SEQ_NT4[seg[keep]]))
    return out


def read_fastx(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) from a FASTA or FASTQ file (optionally gzipped).

    Name is the first whitespace-delimited token of the header, matching
    how minimap2-built indexes record contig names (test.mmi drops the
    " plasmid"/" chromosome" suffixes of test.fa headers).
    """
    with _open_maybe_gz(path) as fh:
        mode = None
        name, chunks = None, []
        it = iter(fh)
        for line in it:
            line = line.rstrip("\n")
            if not line:
                continue
            if mode is None:
                mode = "fastq" if line[0] == "@" else "fasta"
            if mode == "fasta":
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(chunks)
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line)
            else:  # fastq: 4-line records
                rname = line[1:].split()[0] if len(line) > 1 else ""
                seq = next(it).rstrip("\n")
                next(it)  # '+'
                next(it)  # quals
                yield rname, seq
        if mode == "fasta" and name is not None:
            yield name, "".join(chunks)
