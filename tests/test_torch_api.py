"""The port's API surface and .mmi path against the JAX package's.

On seeded data only (``torch_parity.write_genome``), the port on the
CPU: both packages write byte-identical .mmi files through
``fn_idx_out=`` and each loads the other's; the ``k`` / ``w`` /
``n_seq`` / ``seq_names`` properties and ``seq()``; ``str(Mapping)``
(PAF), ``revcomp`` and ``fastx_read``; empty, tiny and N-only reads and
references; and a duplicated contig mapped with the options that
change what is reported.  Mirrors tests/test_api.py and
tests/test_index.py, whose reference data this box does not have.
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

from torch_parity import fields, write_genome

# one intra-op thread per test process (the suite runs several workers)
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
PKGS = {"port": mappy_rs_tpu_torch, "jax": mappy_rs_tpu}


def aligner(pkg: str, *args, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKGS[pkg].Aligner(*args, **kw)


def mapped(al, reads, cs=True, md=True):
    """Every Mapping's fields and PAF line, per read."""
    return [[(fields(m), str(m)) for m in al.map(r, cs=cs, MD=md)]
            for r in reads]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    fa = str(d / "g.fa")
    ctgs = write_genome(fa, 71, lens=(60_000, 110_000, 35_000))
    rng = np.random.default_rng(72)
    reads = []
    for c in ctgs:
        reads += simulate(rng, c, 2, 1000, 0.05)[0]
    return d, fa, ctgs, reads


@pytest.fixture(scope="module")
def built(genome):
    """Each package's Aligner of the FASTA, writing its .mmi."""
    d, fa, _ctgs, _reads = genome
    out = {}
    for pkg in PKGS:
        path = str(d / f"{pkg}.mmi")
        out[pkg] = (aligner(pkg, fa, fn_idx_out=path), path)
    return out


def test_mmi_files_identical(built):
    (_, tp), (_, jp) = built["port"], built["jax"]
    with open(tp, "rb") as a, open(jp, "rb") as b:
        t, j = a.read(), b.read()
    assert len(t) > 1000 and t == j


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_mmi_loads_across_packages(genome, built, reader, writer):
    """A package reading either's .mmi maps as the other package's
    Aligner built from the FASTA."""
    _d, _fa, ctgs, reads = genome
    al = aligner(reader, built[writer][1])
    other = built["jax" if reader == "port" else "port"][0]
    assert (al.k, al.w, al.n_seq, al.seq_names) == \
        (15, 10, 3, ["c0", "c1", "c2"])
    assert [al.seq(n) for n in al.seq_names] == ctgs
    assert mapped(al, reads) == mapped(other, reads)


@pytest.mark.parametrize("prop", ["k", "w", "n_seq", "seq_names"])
def test_properties(built, prop):
    (tal, _), (jal, _) = built["port"], built["jax"]
    assert getattr(tal, prop) == getattr(jal, prop)
    assert bool(tal) is bool(jal) is True


SEQ_CASES = [("c0", 0, INT32_MAX), ("c1", 0, INT32_MAX), ("c2", 100, 200),
             ("c1", 109_990, 120_000), ("c0", 500, 500), ("c0", 600, 500),
             ("c2", 35_000, 35_010), ("c2", 34_999, INT32_MAX),
             ("c0", -5, 10), ("nope", 0, 10), ("c1", 0, 1), ("c0", 59_999,
                                                             60_000)]


@pytest.mark.parametrize("name,start,end", SEQ_CASES)
def test_seq(built, name, start, end):
    (tal, _), (jal, _) = built["port"], built["jax"]
    assert tal.seq(name, start, end) == jal.seq(name, start, end)


def test_mappings_and_paf(genome, built):
    """Mappings (cs, MD), and str(Mapping) as PAF, read for read."""
    reads = genome[3]
    got = mapped(built["port"][0], reads)
    assert got == mapped(built["jax"][0], reads)
    assert all(got)
    paf = got[0][0][1].split("\t")
    assert paf[3] == "c0" and paf[10] == "tp:A:P"
    assert paf[11].startswith("cg:Z:")


@pytest.mark.parametrize("s", ["ACGTN", "aacgt", "", "NNNN",
                               "ACGTUacgtuXYZ"])
def test_revcomp(s):
    assert mappy_rs_tpu_torch.revcomp(s) == mappy_rs_tpu.revcomp(s)


FASTX = {
    "fasta": ">r1 some comment\nACGT\nACGT\n>r2\nTTTT\n>r3  two  words\n"
             "GG\nCC\n\nAA\n",
    "fastq": "@q1\nACGT\n+\nIIII\n@q2 c2 more\nGGGG\n+\n!!!!\n",
}


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
@pytest.mark.parametrize("comment", [False, True])
def test_fastx_read(tmp_path, kind, comment):
    p = tmp_path / f"x.{kind}"
    p.write_text(FASTX[kind])
    got = list(mappy_rs_tpu_torch.fastx_read(str(p), read_comment=comment))
    assert got == list(mappy_rs_tpu.fastx_read(str(p), read_comment=comment))
    assert len(got) == (3 if kind == "fasta" else 2)


@pytest.mark.parametrize("read", ["", "A", "N" * 50, "ACGT" * 3,
                                  "ACGTN" * 40])
def test_degenerate_reads(built, read):
    (tal, _), (jal, _) = built["port"], built["jax"]
    assert mapped(tal, [read]) == mapped(jal, [read]) == [[]]


@pytest.mark.parametrize("ref", ["", ">tiny\nACGTACGT\n",
                                 ">n\n" + "N" * 500 + "\n"])
def test_degenerate_references(tmp_path, ref):
    p = tmp_path / "r.fa"
    p.write_text(ref)
    tal, jal = aligner("port", str(p)), aligner("jax", str(p))
    assert (tal.n_seq, tal.seq_names) == (jal.n_seq, jal.seq_names)
    reads = ["ACGT" * 30, "ACGTACGT", ""]
    assert mapped(tal, reads) == mapped(jal, reads)


@pytest.mark.parametrize("kw,n_hits", [
    ({}, [2, 2]), ({"extra_flags": 0x4000}, [1, 1]),
    ({"min_dp_score": 5000}, [0, 0]), ({"best_n": 1}, [2, 2])],
    ids=["default", "no_print_2nd", "min_dp_score", "best_n"])
def test_duplicated_contig(tmp_path, kw, n_hits):
    """Two copies of one contig: a primary and a secondary hit by
    default, and the options that drop them."""
    rng = np.random.default_rng(2)
    core = random_genome(rng, 2000)
    fa = tmp_path / "r.fa"
    fa.write_text(f">copyA\n{core}\n>copyB\n{core}\n")
    reads = [core[50:550], core[1000:1900]]
    tal, jal = aligner("port", str(fa), **kw), aligner("jax", str(fa), **kw)
    got = mapped(tal, reads)
    assert got == mapped(jal, reads)
    assert [len(ms) for ms in got] == n_hits
