"""The genome and the traffic are the same for a seed and differ across
seeds; every seed gets the same multiset of read lengths."""
import numpy as np

from portbench import reads, run, seeds
from portbench.genome import make_genome
from portbench.tests.tiny import cell_spec, tiny_spec

BIG = 2**31 + 12345


def _genome(cell, seed):
    return make_genome(tiny_spec(cell).cfg, seed, "cpu")


def test_genome_by_seed():
    a, b, c = (_genome("ont-hg38.readfish", s) for s in (BIG, BIG, BIG + 1))
    assert np.array_equal(a.codes, b.codes)
    assert not np.array_equal(a.codes, c.codes)
    assert abs(a.repeat_bp / len(a.codes) - 0.52) < 0.01
    e = _genome("ont-ecoli.wgs", BIG)
    assert e.repeat_bp == 7 * 5000


def test_reads_by_seed():
    spec = tiny_spec("ont-hg38.readfish")
    g = _genome("ont-hg38.readfish", BIG)
    one = run.open_batches(spec.mix, g, 6, seeds.READS, BIG)
    two = run.open_batches(spec.mix, g, 6, seeds.READS, BIG)
    other = run.open_batches(spec.mix, g, 6, seeds.READS, BIG + 1)
    assert one == two and one != other
    assert sorted(map(len, one)) == sorted(map(len, other))
    assert {len(r) for b in one for r in b} <= {180, 360, 540, 720}


def test_lengths_same_multiset_other_order():
    spec = cell_spec("ont-ecoli.wgs").mix["read"]
    a = reads.read_lengths(spec, 2048, seeds.rng(1, 2))
    b = reads.read_lengths(spec, 2048, seeds.rng(2, 2))
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    # stratified: each block of 64 holds the same lengths on every seed
    assert sorted(a[:64]) == sorted(b[:64])
    assert 4500 < np.median(a) < 5500 and a.min() >= 500 and a.max() <= 100000
    cut = cell_spec("ont-ecoli.wgs-8k").mix["read"]
    e = reads.read_lengths(cut, 2048, seeds.rng(1, 2))
    f = reads.read_lengths(cut, 2048, seeds.rng(2, 2))
    assert sorted(e) == sorted(f) and not np.array_equal(e, f)
    # cut to [500, 8000] and renormalized: no pile-up at the cut
    assert e.min() >= 500 and e.max() <= 8000 and (e == 8000).sum() <= 1
    fixed = cell_spec("ont-hg38.readfish").mix["read"]
    c = reads.read_lengths(fixed, 1000, seeds.rng(1, 2))
    d = reads.read_lengths(fixed, 1000, seeds.rng(2, 2))
    assert sorted(c) == sorted(d) and not np.array_equal(c, d)
