"""The port's multi-device entry points at the Aligner level, held
against its single device and against the JAX package.

Mirrors the cases of the JAX package's tests/test_parallel.py
(``enable_mesh`` Mappings, ``map_batch_positions`` decisions, the
readfish micro-batch stream) and tests/test_ultra_long.py's 20 kb
decision read, on seeded genomes of unique sequence (ROADMAP R3)
instead of the reference checkout's files.  The port's grids put every
cell on the CPU (``devices=["cpu"] * n``); the JAX package runs on
conftest.py's 8-device virtual CPU mesh.  Exact equality throughout.
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

from torch_parity import drain, fields, write_genome

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

_RC = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s[::-1].translate(_RC)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The FASTA of a seeded 4-contig genome, its contigs, 16 reads of
    1 kb at 5% error from them (plus one reverse complement), and the
    port's single-device Mappings of those reads (cs, no MD)."""
    fa = str(tmp_path_factory.mktemp("api") / "g.fa")
    ctgs = write_genome(fa, 17)
    rng = np.random.default_rng(4)
    reads = []
    for c in ctgs:
        reads += simulate(rng, c, 4, 1000, 0.05)[0]
    reads.append(_rc(reads[0]))
    al = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    single = [[fields(m) for m in al.map(r, cs=True)] for r in reads]
    assert sum(1 for s in single if s) == len(reads)
    return fa, ctgs, reads, single


@pytest.mark.parametrize("n_data,n_index", [(8, 1), (4, 2)])
def test_enable_mesh_matches_single_and_jax(genome, n_data, n_index):
    """enable_mesh through enable_threading + map_batch == the port's
    single device == the JAX package's enable_mesh (its device front
    end), field for field; sharded, the replicated tables are never
    built."""
    fa, _ctgs, reads, single = genome
    al = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    al.enable_mesh(n_data, n_index=n_index, devices=["cpu"] * (n_data * n_index))
    assert al._engine.mesh.shape == {"data": n_data, "index": n_index}
    al.enable_threading(2)
    try:
        out = drain(al, [{"i": i, "seq": s} for i, s in enumerate(reads)])
    finally:
        al.enable_threading(0)
    assert [out[i] for i in range(len(reads))] == single
    assert al._engine.metrics.snapshot()["fe_batches"] > 0
    if n_index > 1:
        assert al._engine.index._devices == {}

    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal._engine.cfg.front_end_backend = "device"
    jal.enable_mesh(n_data, n_index=n_index)
    assert [[fields(m) for m in jal.map(r, cs=True)] for r in reads] == single


def test_map_batch_positions_matches_jax(genome):
    """Decision mode at (4, 2): the port's dicts == the JAX package's;
    exact contig slices name their contig, strand and end."""
    fa, ctgs, _reads, _single = genome
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    with pytest.raises(RuntimeError, match=r"Sharding not enabled on this "
                       r"instance. Please call `.enable_sharding\(\)`"):
        tal.map_batch_positions(["ACGT" * 100])
    tal.enable_sharding(n_data=4, n_index=2, devices=["cpu"] * 8)
    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal.enable_sharding(n_data=4, n_index=2)
    rng = np.random.default_rng(8)
    want = []
    reads = []
    for i in range(9):
        ci = i % len(ctgs)
        ln = int(rng.integers(350, 450))
        s = int(rng.integers(0, len(ctgs[ci]) - ln))
        r = ctgs[ci][s:s + ln]
        strand = -1 if i % 3 == 0 else 1
        reads.append(_rc(r) if strand < 0 else r)
        want.append((f"c{ci}", strand, s + ln))
    reads.append("ACGT" * 30)
    got = tal.map_batch_positions(reads)
    assert got == jal.map_batch_positions(reads)
    for r, (ctg, strand, end) in zip(got, want):
        assert r is not None and r["ctg"] == ctg and r["strand"] == strand
        assert r["ctg_len"] == len(ctgs[int(ctg[1:])])
        assert r["chain_score"] > 300 and r["ext_score"] > 600
        if strand > 0:
            assert abs(r["r_en"] - end) < 20
    assert got[-1] is None  # the junk read


def test_readfish_microbatch_decisions(genome):
    """A stream of micro-batches of 350-450 bp read prefixes (1 to 8
    reads) == the JAX package's decisions, each on the right contig and
    strand, through one cached step (one L bucket)."""
    fa, ctgs, _reads, _single = genome
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    tal.enable_sharding(n_data=4, n_index=2, devices=["cpu"] * 8)
    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal.enable_sharding(n_data=4, n_index=2)
    rng = np.random.default_rng(3)
    for batch_size in (1, 2, 4, 3, 1, 8):
        chunk, want = [], []
        for _ in range(batch_size):
            ci = int(rng.integers(len(ctgs)))
            st = int(rng.integers(0, len(ctgs[ci]) - 2000))
            s = ctgs[ci][st:st + int(rng.integers(350, 450))]
            rev = rng.random() < 0.5
            chunk.append(_rc(s) if rev else s)
            want.append((f"c{ci}", -1 if rev else 1))
        res = tal.map_batch_positions(chunk)
        assert res == jal.map_batch_positions(chunk)
        for r, (ctg, strand) in zip(res, want):
            assert r is not None and r["ctg"] == ctg and r["strand"] == strand
            assert r["chain_score"] > 200
    assert len(tal._sharded_steps) == 1


def test_decision_mode_maps_20kb_read(tmp_path):
    """A 20 kb read and its reverse complement (the 32,768 bucket) in
    decision mode == the JAX package's; contig-range sharding caps no
    read length.  The port runs a (1, 2) grid, the JAX package its
    test's (4, 2): the decisions do not depend on the grid."""
    rng = np.random.default_rng(44)
    g = random_genome(rng, 200_000)
    fa = str(tmp_path / "chr.fa")
    with open(fa, "w") as fh:
        fh.write(f">chr\n{g}\n")
    st = 60_000
    read = g[st:st + 20_000]
    reads = [read, _rc(read)]
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    tal.enable_sharding(n_data=1, n_index=2, devices=["cpu"] * 2)
    res = tal.map_batch_positions(reads)
    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal.enable_sharding(n_data=4, n_index=2)
    assert res == jal.map_batch_positions(reads)
    assert res[0] is not None and res[0]["ctg"] == "chr"
    assert res[0]["strand"] == 1
    assert abs(res[0]["r_en"] - (st + 20_000)) < 200
    assert res[1] is not None and res[1]["strand"] == -1
