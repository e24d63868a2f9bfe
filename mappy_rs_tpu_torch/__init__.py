"""mappy_rs_tpu_torch — the PyTorch/CUDA port of mappy_rs_tpu.

The same mappy-rs drop-in surface as the JAX package (``Aligner``,
``Mapping``, ``Strand``, ``AlignmentBatchResultIter``, ``fastx_read``,
``revcomp``), with the device front end (sketch, seed lookup, chaining
DP, chain backtrack) on torch tensors and the chaining DP and chain
backtrack as hand-written CUDA kernels for Hopper (csrc/).  The host
post-chain (regions, extension, CIGAR, mapq) is the JAX package's C++,
built from the same sources.

    from mappy_rs_tpu_torch import Aligner
    al = Aligner(seq=genome)                 # device="cuda" by default
    hits = al.map("ACGT...")
    al.enable_threading(4)
    for mappings, data in al.map_batch(iterable_of_dicts):
        ...

This package imports torch and never jax or mappy_rs_tpu.
"""
from .api import Aligner, Mapping, Strand
from .runtime.batch import AlignmentBatchResultIter

__version__ = "0.1.0"
__all__ = [
    "Aligner",
    "Mapping",
    "Strand",
    "AlignmentBatchResultIter",
    "fastx_read",
    "revcomp",
]

_COMP = str.maketrans("ACGTUacgtu", "TGCAAtgcaa")


def revcomp(seq: str) -> str:
    """Reverse complement (mappy.revcomp drop-in)."""
    return seq.translate(_COMP)[::-1]


def _fastx_native_records(data: bytes, read_comment: bool):
    """Materialize (name, seq, qual[, comment]) records from the native
    parser's blob output; returns iter([]) if the library is absent."""
    from . import native

    parsed = native.fastx_parse(data)
    if parsed is None:
        return
    mode, names, comments, seqs, quals = parsed
    # decode each blob ONCE; per-record work is pure str slicing
    nb = names[0].tobytes().decode("ascii", "replace")
    cb = comments[0].tobytes().decode("ascii", "replace")
    sb = seqs[0].tobytes().decode("ascii", "replace")
    qb = quals[0].tobytes().decode("ascii", "replace")
    no = names[1].tolist()
    co = comments[1].tolist()
    so = seqs[1].tolist()
    qo = quals[1].tolist()
    for i in range(len(no) - 1):
        rec = (
            nb[no[i] : no[i + 1]],
            sb[so[i] : so[i + 1]],
            qb[qo[i] : qo[i + 1]] if mode == 1 else None,
        )
        if read_comment:
            rec += (
                cb[co[i] : co[i + 1]] if co[i + 1] > co[i] else None,
            )
        yield rec


def fastx_read(path: str, read_comment: bool = False):
    """Yield (name, seq, qual[, comment]) like mappy.fastx_read.

    qual is None for FASTA records; comment is the rest of the header
    line when read_comment=True.  FASTA files are parsed by the C++
    runtime when built (native.fastx_parse: one memchr scan + one fill
    pass, where the python loop pays a join per multi-line record);
    FASTQ stays on the python readline loop (each line of a strict
    4-line record is already exactly one output string)."""
    import gzip

    with open(path, "rb") as probe:
        magic = probe.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open

    from . import native

    if native.available():
        with opener(path, "rb") as fh:
            head = fh.read(1)
            if head == b">":  # FASTA: native parse wins
                data = head + fh.read()
                yield from _fastx_native_records(data, read_comment)
                return

    with opener(path, "rt") as fh:
        it = iter(fh)
        name = comment = None
        chunks = []
        mode = None
        for line in it:
            line = line.rstrip("\n")
            if not line:
                continue
            if mode is None:
                mode = "fastq" if line[0] == "@" else "fasta"
            if mode == "fasta":
                if line.startswith(">"):
                    if name is not None:
                        rec = (name, "".join(chunks), None)
                        yield rec + ((comment,) if read_comment else ())
                    parts = line[1:].split(None, 1)
                    name = parts[0] if parts else ""
                    comment = parts[1] if len(parts) > 1 else None
                    chunks = []
                else:
                    chunks.append(line)
            else:
                parts = line[1:].split(None, 1)
                rname = parts[0] if parts else ""
                rcomment = parts[1] if len(parts) > 1 else None
                seq = next(it).rstrip("\n")
                next(it)
                qual = next(it).rstrip("\n")
                rec = (rname, seq, qual)
                yield rec + ((rcomment,) if read_comment else ())
        if mode == "fasta" and name is not None:
            rec = (name, "".join(chunks), None)
            yield rec + ((comment,) if read_comment else ())
