"""Homopolymer-compressed (HPC) sketching on the PyTorch port: map-pb.

The port's ``compress_hpc`` / ``hpc_spans`` and HPC ``sketch_compact``
(compressed codes plus pos_map, spans and force_inf) against the JAX
package's; the torch contig sketcher's HPC rows against the native
sketcher's; the map-pb front end (the batch compressed on the host) and
Mappings against the JAX package's, exactly.  Mirrors tests/test_hpc.py.
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu
from mappy_rs_tpu.ops.sketch import compress_hpc as jax_compress_hpc
from mappy_rs_tpu.ops.sketch import hpc_spans as jax_hpc_spans

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.index.build import (_sketch_contig_device,
                                            _sketch_contig_native)
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.ops.sketch import (compress_hpc, hpc_spans,
                                           sketch_compact)
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import simulate_hpc_noise

from torch_parity import (drain, fields, jax_front_end, jax_sketch, port_key,
                          read_batch)

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)


def _hp_genome(rng, n):
    """Runs of 1-5 equal bases: a genome where HPC compression bites."""
    runs = rng.integers(1, 6, n)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    return np.repeat(bases, runs)[:n].tobytes().decode()


def _batch(rng):
    """HPC-heavy reads with N bases, one read shorter than k and one
    homopolymer of 300 bases (k-mer spans >= 256: force_inf)."""
    B, L = 10, 640
    codes = np.full((B, L), 4, np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    lens[:3] = [L, L, 12]
    for b in range(B):
        codes[b, : lens[b]] = encode(_hp_genome(rng, int(lens[b])))
    codes[1, 100:400] = 2
    codes[4, 30:33] = 4
    return codes, lens


def test_compress_hpc_matches_jax():
    codes, lens = _batch(np.random.default_rng(1))
    got = compress_hpc(codes, lens)
    want = jax_compress_hpc(codes, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(hpc_spans(got[3], 19), jax_hpc_spans(want[3], 19))
    assert (hpc_spans(got[3], 19)[1] >= 256).any()


def test_hpc_sketch_compact_matches_jax():
    k, w, M = 19, 10, 128
    codes, lens = _batch(np.random.default_rng(2))
    cc, cl, run_end, run_len = compress_hpc(codes, lens)
    spans = hpc_spans(run_len, k)
    got = sketch_compact(
        torch.from_numpy(cc), torch.from_numpy(cl), k, w, M,
        force_inf=torch.from_numpy(spans >= 256),
        pos_map=torch.from_numpy(run_end), spans=torch.from_numpy(spans))
    want = jax_sketch(codes, lens, k, w, M, hpc=True)
    np.testing.assert_array_equal(got["key"].numpy(), port_key(want, k))
    for f in ("n", "pos", "strand", "span"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    n = got["n"].numpy()
    assert (got["span"].numpy()[0, : n[0]] > k).any()  # compressed runs


def test_hpc_contig_sketch_matches_native():
    """The torch contig sketcher (index building without the host
    library) gives the native sketch_contig(is_hpc=True) rows."""
    rng = np.random.default_rng(3)
    codes = encode(_hp_genome(rng, 20_000))
    codes[5000:5400] = 1  # a 400-base run: spans >= 256 are skipped
    codes[9000:9010] = 4
    want = _sketch_contig_native(codes, 19, 10, True)
    assert want is not None and len(want) > 500
    got = _sketch_contig_device(codes, 19, 10, "cpu", is_hpc=True)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pb_data():
    rng = np.random.default_rng(6)
    genome = _hp_genome(rng, 250_000)
    reads, starts = simulate_hpc_noise(rng, genome, 8, 1200, 0.02)
    return (genome, reads, starts,
            mappy_rs_tpu_torch.Aligner(seq=genome, preset="map-pb", device="cpu"),
            mappy_rs_tpu.Aligner(seq=genome, preset="map-pb"))


def test_front_end_matches_jax(pb_data):
    _genome, reads, _starts, tal, jal = pb_data
    eng = tal._engine
    assert eng.index.flag & 0x1 and eng.dev.two_word
    L = eng._bucket_len(max(len(r) for r in reads))
    B, M, A = eng.fe_shapes(L, b_real=len(reads))
    cuts = min(8, L // eng.SEG_LEN)
    codes, lens = read_batch(reads, B, L)
    cc, cl, run_end, run_len = compress_hpc(codes, lens)
    spans = hpc_spans(run_len, eng.index.k)
    chains, aux = front_end_bt(
        torch.from_numpy(cc), torch.from_numpy(lens), eng.dev,
        sk_lens=torch.from_numpy(cl), force_inf=torch.from_numpy(spans >= 256),
        pos_map=torch.from_numpy(run_end), spans=torch.from_numpy(spans),
        **eng._fe_kwargs(M, A, cuts))
    want, jaux = jax_front_end(jal._engine, codes, lens, M, A, cuts,
                               eng._chain_params)
    np.testing.assert_array_equal(chains.numpy(), want)
    np.testing.assert_array_equal(aux.numpy(), jaux)
    assert (chains.numpy()[: len(reads), 0, 0] >= 0).all()


def test_aligner_matches_jax(pb_data):
    """map-pb Mappings == the JAX package's, through map and through
    map_batch's threads (the batch staged, compressed, on the host);
    reads with run-length noise are placed."""
    _genome, reads, starts, tal, jal = pb_data
    want = [[fields(m) for m in jal.map(r, cs=True, MD=True)] for r in reads]
    got = [[fields(m) for m in tal.map(r, cs=True, MD=True)] for r in reads]
    assert got == want
    assert sum(bool(g) and abs(g[0][5] - s) < 120
               for g, s in zip(got, starts)) >= len(reads) - 1
    tal.enable_threading(2)
    try:
        out = drain(tal, [{"i": i, "seq": r} for i, r in enumerate(reads)])
    finally:
        tal.enable_threading(0)
    # the threaded path asks for cs and no MD (lib.rs:587-592)
    assert [out[i] for i in range(len(reads))] == [
        [fields(m) for m in jal.map(r, cs=True)] for r in reads]
    assert tal.metrics.get("calls_hpc_stage", 0) > 0
