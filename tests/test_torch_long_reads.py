"""The chain kernels' anchor budget and the large-A test data, on the CPU.

K1 (csrc/chain.cu) keeps only its window and K2 (csrc/backtrack.cu) one
bit per anchor, so both take every anchor budget that the pipeline's
``fe_shapes`` makes, up to A = 524,288 at the 131,072 bucket.  These
tests pin that down without a card (the predicates are plain Python),
check the tiled-anchor helper that chip_smoke.py and
tests/test_torch_cuda.py use for large-A checks, and hold the plain
versions against the JAX package's Pallas kernels (interpret mode) on
tiled and edge-case anchors.  The CUDA kernels themselves are compared
with the plain versions in tests/test_torch_cuda.py, on the card.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.ops.backtrack_pallas import backtrack_chains_pallas
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain_pallas import chain_scores_pallas

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.config import AlignerConfig
from mappy_rs_tpu_torch.models.pipeline import AlignmentEngine
from mappy_rs_tpu_torch.ops import backtrack as bt
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.ops.chain import ChainParams, chain_scores
from mappy_rs_tpu_torch.utils.simulate import (edge_anchors, random_genome,
                                               simulate, sweep_anchors,
                                               tile_anchors,
                                               tile_chain_result)

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

# map-ont chaining parameters at k=15
CHAIN = dict(max_dist_x=5000, max_dist_y=5000, bw=500, q_span=15,
             chn_pen_gap=0.8 * 0.01 * 15, chn_pen_skip=0.0)
JP, TP = JaxChainParams(**CHAIN), ChainParams(**CHAIN)
BUCKETS = AlignerConfig().length_buckets


def _engine(device: str):
    """fe_shapes, _chain_fits and _bt_enabled read only the index's w,
    the config, the device and the device grid (none here): an engine
    without an index is enough."""
    return SimpleNamespace(index=SimpleNamespace(w=10), cfg=AlignerConfig(),
                           device=torch.device(device), mesh=None)


def _to_jax(d):
    return {k: jnp.asarray(v.numpy()) for k, v in d.items()}


# ------------------------------------------------------- the A budget
@pytest.mark.parametrize("a_boost", [1, 4, 16])
@pytest.mark.parametrize("L", BUCKETS)
def test_every_anchor_budget_fits_both_kernels(L, a_boost):
    eng = _engine("cuda")
    B, _M, A = AlignmentEngine.fe_shapes(eng, L, a_boost=a_boost)
    assert ck.chain_fits(A, eng.cfg.pallas_chain_window)
    assert bt.backtrack_fits(A)
    # the gates in _map_bucket check exactly these on a card engine
    assert AlignmentEngine._chain_fits(eng, A)
    assert AlignmentEngine._bt_enabled(eng, A)
    if L == BUCKETS[-1]:
        assert (B, A) == (8, 32768 * a_boost)


def test_fit_predicates_at_their_bounds():
    assert ck.chain_fits(ck.MAX_ANCHORS) and not ck.chain_fits(ck.MAX_ANCHORS + 1)
    assert ck.chain_fits(256, ck.MAX_WINDOW)
    assert not ck.chain_fits(256, ck.MAX_WINDOW + 1)
    # K2: one bit per anchor plus a 32-entry walk buffer, 227 KB in all
    assert bt.backtrack_fits(1_858_560) and not bt.backtrack_fits(1_858_561)
    assert bt.smem_bytes(524_288) == (524_288 // 32 + 32) * 4


def test_kernel_gate_refuses_only_outside_the_predicates():
    eng = _engine("cuda")
    # over K2's bitmask: K1 still takes it, the host backtracks
    assert AlignmentEngine._chain_fits(eng, 2_000_000)
    assert not AlignmentEngine._bt_enabled(eng, 2_000_000)
    # the same routing on the CPU, whose plain K2 would take any shape
    assert not AlignmentEngine._bt_enabled(_engine("cpu"), 2_000_000)
    eng.cfg.device_backtrack = "off"
    assert not AlignmentEngine._bt_enabled(eng, 256)
    eng.cfg.pallas_chain_window = 2048  # over K1's 1,024-anchor window
    assert not AlignmentEngine._chain_fits(eng, 256)
    # the CPU's plain K1 takes any shape
    cpu = _engine("cpu")
    cpu.cfg.pallas_chain_window = 2048
    assert AlignmentEngine._chain_fits(cpu, 2_000_000)


# ---------------------------------------------------- tiled anchors
@pytest.mark.parametrize("window", [128, 512])
def test_tiled_anchors_chain_as_their_tile(window):
    rng = np.random.default_rng(window)
    tile = sweep_anchors(rng, 3, 256, CHAIN["bw"])
    f, p = chain_scores(tile, TP, window)
    big = tile_anchors(tile, 4)
    assert big["rpos"].shape == (3, 1024)
    # valid anchors are no longer a prefix of the row
    assert not bool(big["valid"][:, :768].all(dim=1).all())
    want_f, want_p = tile_chain_result(f, p, 4)
    got_f, got_p = chain_scores(big, TP, window)
    assert torch.equal(got_f, want_f) and torch.equal(got_p, want_p)
    assert int((got_p >= 256).sum()) > 0  # links inside later copies


def test_tiled_anchors_backtrack_stays_in_its_copy():
    tile = sweep_anchors(np.random.default_rng(5), 2, 128, CHAIN["bw"])
    big = tile_anchors(tile, 8)
    f, p = chain_scores(big, TP, 128)
    out = bt.backtrack_chains(big, f, p, 8, 2, 3, 40)
    kept = out[:, :, 0] >= 0
    assert int(kept.sum()) > 0
    # rid names the copy: chains are found in later copies too
    rid = out[:, :, 3][kept]
    assert int(rid.max()) >= 3


# --------------------------------------------- port == JAX package
@pytest.mark.parametrize("window", [128, 512])
def test_tiled_chain_plain_matches_pallas(window):
    tile = sweep_anchors(np.random.default_rng(11), 2, 96, CHAIN["bw"])
    big = tile_anchors(tile, 4)
    jf, jp = chain_scores_pallas(_to_jax(big), JP, window)
    f, p = chain_scores(big, TP, ck.window_of(window))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_tiled_backtrack_plain_matches_pallas():
    tile = sweep_anchors(np.random.default_rng(12), 2, 96, CHAIN["bw"])
    big = tile_anchors(tile, 4)
    f, p = chain_scores(big, TP, 128)
    want = np.asarray(backtrack_chains_pallas(
        _to_jax(big), jnp.asarray(f.numpy()), jnp.asarray(p.numpy()),
        8, 2, 3, 40))
    got = bt.backtrack_chains(big, f, p, 8, 2, 3, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :, 0] >= 0).sum() > 0


@pytest.mark.parametrize("window", [128, 512])
def test_edge_case_anchors_match_pallas(window):
    """Equal candidates (the largest j wins), a best total equal to
    span_i (no link), an empty read and a non-prefix valid mask."""
    e = edge_anchors(np.random.default_rng(3), 256)
    jf, jp = chain_scores_pallas(_to_jax(e), JP, window)
    f, p = ck.chain_scores_kernel(e, TP, window)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert p[0, 8:16].tolist() == [7] * 8  # ties: the last of the group
    assert f[1, 1::2].eq(30).all() and p[1].eq(-1).all()
    assert p[2].eq(-1).all() and f[2].eq(-(1 << 30)).all()
    want = np.asarray(backtrack_chains_pallas(
        _to_jax(e), jf, jp, 8, 2, 3, 40))
    np.testing.assert_array_equal(
        bt.backtrack_chains(e, f, p, 8, 2, 3, 40).numpy(), want)


# ------------------------------------------------ a long read, end to end
def _fields(m):
    return tuple(
        getattr(m, "cigar" if s == "_cig" else "strand" if s == "_strand" else s)
        for s in m.__slots__
    )


def test_long_read_maps_through_the_plain_kernels():
    """A 20 kb read goes to the 32,768 bucket (A = 8,192): the device
    front end's plain versions on the CPU place it, and give the JAX
    package's Mappings field for field."""
    rng = np.random.default_rng(20)
    genome = random_genome(rng, 400_000)
    reads, starts = simulate(rng, genome, 2, 20_000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    jal = mappy_rs_tpu.Aligner(seq=genome)
    eng = al._engine
    assert eng._bucket_len(len(reads[0])) == 32768
    assert eng.fe_shapes(32768, b_real=2)[2] == 8192
    for r, s in zip(reads, starts):
        hits = al.map(r, cs=True)
        assert hits and abs(hits[0].target_start - s) < 100
        assert [_fields(m) for m in hits] == \
            [_fields(m) for m in jal.map(r, cs=True)]
