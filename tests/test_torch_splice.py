"""The splice presets on the PyTorch port, held against the JAX package.

The port's intron-state DP oracle (ops/splice.py) against the JAX
package's and against the port's own native engine; K1's plain version
with the splice branch (``is_splice``: log-cost reference gaps) against
the JAX package's chain DP on anchors whose reference gaps sweep
0-200,000; the splice front end and Mappings (N ops, cs ``~``,
trans_strand) against the JAX package's, exactly.  Mirrors
tests/test_splice.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain import chain_scores as jax_chain_scores
from mappy_rs_tpu.ops.splice import splice_align as jax_splice_align
from mappy_rs_tpu.ops.splice import splice_site_tables as jax_site_tables

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.config import set_opt
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.ops.chain import ChainParams, chain_scores
from mappy_rs_tpu_torch.ops.splice import splice_align, splice_site_tables
from mappy_rs_tpu_torch.utils.simulate import (random_genome, splice_anchors,
                                               spliced_genes)

from torch_parity import drain, fields, jax_front_end, read_batch

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)


def _codes(seq):
    return np.asarray(["ACGT".index(c) for c in seq], np.uint8)


def _jobs(rng, n):
    """Random splice DP jobs: a third of them two exon halves of the
    query joined across a GT..AG intron, modes 2/1, both senses, with
    and without the flank model, some reversed, end bonuses -2..9."""
    for trial in range(n):
        Q = int(rng.integers(1, 50))
        q = rng.integers(0, 5, Q).astype(np.uint8)
        t = rng.integers(0, 5, int(rng.integers(1, 120))).astype(np.uint8)
        if trial % 3 == 0 and Q >= 20:
            mid = rng.integers(0, 4, int(rng.integers(4, 60)))
            t = np.concatenate([q[: Q // 2], [2, 3], mid, [0, 2],
                                q[Q // 2:]]).astype(np.uint8)
        yield (q, t, 2 if trial % 2 == 0 else 1, 1 if trial % 4 < 2 else -1,
               trial % 5 != 0, trial % 7 == 0, int(rng.integers(-2, 10)))


def test_oracle_matches_jax_oracle():
    rng = np.random.default_rng(42)
    for q, t, mode, sense, flank, rev, eb in _jobs(rng, 40):
        args = (1, 2, 2, 1, 32, 9, 1, sense, flank, mode, eb, rev)
        got, want = splice_align(q, t, *args), jax_splice_align(q, t, *args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    t = _codes("AGTACCTAGACTGGGAACA")
    for sense in (1, -1):
        for flank in (False, True):
            for rs in (False, True):
                for g, w in zip(splice_site_tables(t, sense, flank, 9, rs),
                                jax_site_tables(t, sense, flank, 9, rs)):
                    np.testing.assert_array_equal(g, w)


def test_native_matches_oracle():
    if not native.available():
        pytest.skip("host C++ library unavailable")
    rng = np.random.default_rng(43)
    for q, t, mode, sense, flank, rev, eb in _jobs(rng, 40):
        py = splice_align(q, t, 1, 2, 2, 1, 32, 9, 1, sense, flank, mode, eb, rev)
        ops, sc, qc, tc = native.splice_align_batch(
            q[None, :].copy(), t[None, :].copy(),
            np.array([len(q)], np.int32), np.array([len(t)], np.int32),
            1, 2, 2, 1, 32, 9, 1, eb, mode, sense, flank, rev)[0]
        np.testing.assert_array_equal(py[0], ops)
        assert py[1:] == (sc, qc, tc)


# ----------------------------------------------------- the chain branch
#: the splice presets' chaining parameters at k=15
CHAIN = dict(max_dist_x=200_000, max_dist_y=2000, bw=200_000, q_span=15,
             chn_pen_gap=0.8 * 0.01 * 15, chn_pen_skip=0.0, is_splice=1)


@pytest.mark.parametrize("window", [128, 256])
def test_splice_chain_plain_matches_jax_on_gap_sweep(window):
    """K1's plain version, splice branch, == the JAX package's chain DP
    on anchors whose reference gaps sweep 0-200,000 (intron-sized gaps
    included), where the float penalty runs far past K1's dd table."""
    an = splice_anchors(np.random.default_rng(window), 8, 512)
    f, p = chain_scores(an, ChainParams(**CHAIN), window)
    jf, jp = jax_chain_scores({k: jnp.asarray(v.numpy()) for k, v in an.items()},
                              JaxChainParams(**CHAIN), window)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    b, i = np.nonzero(p.numpy() >= 0)
    j = p.numpy()[b, i]
    gap = an["rpos"].numpy()[b, i] - an["rpos"].numpy()[b, j]
    assert (gap > 50_000).sum() > 0 and ((gap > 80) & (gap < 5000)).sum() > 0


def test_splice_chain_bridges_long_ref_gap():
    """Under is_splice a reference gap costs min(linear, log): anchors
    across an 8 kb intron chain; the linear penalty breaks them."""
    qpos = torch.tensor([[100, 115, 130, 200, 215]], dtype=torch.int32)
    an = {"rev": torch.zeros_like(qpos), "rid": torch.zeros_like(qpos),
          "qpos": qpos,
          "rpos": qpos + torch.tensor([[0, 0, 0, 8000, 8000]], dtype=torch.int32),
          "span": torch.full_like(qpos, 15),
          "valid": torch.ones(qpos.shape, dtype=torch.bool)}
    base = dict(CHAIN, chn_pen_gap=0.15)
    assert int(chain_scores(an, ChainParams(**base), 128)[1][0, 3]) == 2
    base["is_splice"] = 0
    assert int(chain_scores(an, ChainParams(**base), 128)[1][0, 3]) == -1


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def genes():
    rng = np.random.default_rng(7)
    g, reads, starts = spliced_genes(rng, random_genome(rng, 250_000), 8, 0.01)
    return (g, reads, starts,
            mappy_rs_tpu_torch.Aligner(seq=g, preset="splice", device="cpu"),
            mappy_rs_tpu.Aligner(seq=g, preset="splice"))


def test_front_end_matches_jax(genes):
    _g, reads, _starts, tal, jal = genes
    eng = tal._engine
    assert eng.is_splice and eng._chain_params.is_splice == 1
    L = eng._bucket_len(max(len(r) for r in reads))
    B, M, A = eng.fe_shapes(L, b_real=8, a_boost=4)  # w=5: dense anchors
    cuts = min(8, L // eng.SEG_LEN)
    codes, lens = read_batch(reads, B, L)
    chains, aux = front_end_bt(torch.from_numpy(codes), torch.from_numpy(lens),
                               eng.dev, **eng._fe_kwargs(M, A, cuts))
    want, jaux = jax_front_end(jal._engine, codes, lens, M, A, cuts,
                               eng._chain_params)
    np.testing.assert_array_equal(chains.numpy(), want)
    np.testing.assert_array_equal(aux.numpy(), jaux)
    assert (chains.numpy()[:8, 0, 0] >= 0).all()


def test_aligner_matches_jax(genes):
    """Spliced transcripts of both senses and strands: Mappings == the
    JAX package's (N ops, cs, MD, trans_strand), through map and
    through map_batch's threads, and each placed with an intron."""
    _g, reads, starts, tal, jal = genes
    got = [tal.map(r, cs=True, MD=True) for r in reads]
    assert [[fields(m) for m in ms] for ms in got] == [
        [fields(m) for m in jal.map(r, cs=True, MD=True)] for r in reads]
    for ms, s in zip(got, starts):
        assert abs(ms[0].target_start - s) < 100 and ms[0].trans_strand != 0
        assert any(op == 3 for _, op in ms[0].cigar)
    tal.enable_threading(2)
    try:
        out = drain(tal, [{"i": i, "seq": r} for i, r in enumerate(reads)])
    finally:
        tal.enable_threading(0)
    # the threaded path asks for cs and no MD (lib.rs:587-592)
    assert [out[i] for i in range(len(reads))] == [
        [fields(m) for m in jal.map(r, cs=True)] for r in reads]


def test_spliced_read_exact():
    """An error-free 3-exon transcript gives minimap2's spliced record:
    300M150N250M80N200M, cs with ~gt..ag, introns outside blen/NM/MD."""
    rng = np.random.default_rng(7)

    def s(n):
        return random_genome(rng, n)

    e1, e2, e3 = s(300), s(250), s(200)
    genome = (s(3000) + e1 + "GT" + s(146) + "AG" + e2 + "GT" + s(76) + "AG"
              + e3 + s(3000))
    al = mappy_rs_tpu_torch.Aligner(seq=genome, preset="splice", device="cpu")
    h = al.map(e1 + e2 + e3, cs=True, MD=True)[0]
    assert (h.r_st, h.r_en, h.strand, h.trans_strand) == (3000, 3980, 1, 1)
    assert h.cigar_str == "300M150N250M80N200M"
    assert h.cs == ":300~gt150ag:250~gt80ag:200" and h.MD == "750"
    assert (h.NM, h.blen, h.mlen, h.mapq) == (0, 750, 750, 60)


def test_splice_presets_scoring():
    for preset in ("splice", "splice:hq", "cdna"):
        io, mo = set_opt(preset)
        al = mappy_rs_tpu_torch.Aligner(seq="ACGT" * 500, preset=preset,
                                        device="cpu")
        eng = al._engine
        assert eng.is_splice and (io.k, io.w) == (15, 5)
        assert eng._chain_params.max_dist_x == eng._chain_params.bw == 200_000
        assert (eng._ext_params.b, eng._ext_params.q2) == (mo.b, mo.q2)
