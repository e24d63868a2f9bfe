"""Parity of the PyTorch port's front-end modules with the JAX package.

Each test makes its inputs from a seed with numpy, feeds the same
arrays to the JAX function and to its counterpart in
mappy_rs_tpu_torch, and asserts EXACT equality: the path is integer
arithmetic plus a float32 gap penalty that both sides round op by op.
Where the JAX path reaches a Pallas kernel (chain DP, backtrack) it runs
in interpret mode on the CPU, as the JAX package's own tests run it.
On the CPU the port's kernel wrappers run their plain torch versions;
tests/test_torch_cuda.py holds the CUDA kernels against those.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mappy_rs_tpu.config import IndexOptions
from mappy_rs_tpu.index.build import build_index as jax_build_index
from mappy_rs_tpu.ops.backtrack_pallas import backtrack_chains_pallas
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain import _gap_pen as jax_gap_pen
from mappy_rs_tpu.ops.chain_pallas import chain_scores_pallas
from mappy_rs_tpu.ops.lookup import collect_anchors_dev
from mappy_rs_tpu.ops.lookup import seed_select_keep as jax_seed_select_keep
from mappy_rs_tpu.ops.sketch import sketch_compact as jax_sketch_compact
from mappy_rs_tpu.utils import u64 as jax_u64
from mappy_rs_tpu.utils.seqcodes import encode

from mappy_rs_tpu_torch.index.build import build_index
from mappy_rs_tpu_torch.index.index import index_from_jax
from mappy_rs_tpu_torch.ops import backtrack as bt
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.ops.chain import ChainParams, _gap_pen, chain_scores
from mappy_rs_tpu_torch.ops.lookup import collect_anchors, seed_select_keep
from mappy_rs_tpu_torch.ops.sketch import sketch_compact
from mappy_rs_tpu_torch.utils import u64
from mappy_rs_tpu_torch.utils.simulate import random_genome, sweep_anchors

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

K, W = 15, 10
L = 1024
M = max(64, L // (W // 2))
# map-ont chaining parameters at k=15 (pipeline.AlignmentEngine)
CHAIN = dict(max_dist_x=5000, max_dist_y=5000, bw=500, q_span=K,
             chn_pen_gap=0.8 * 0.01 * K, chn_pen_skip=0.0)
JP, TP = JaxChainParams(**CHAIN), ChainParams(**CHAIN)


@pytest.fixture(scope="module")
def repeat_index():
    """A 90 kbp genome: random sequence with 40 copies of a 300 bp unit
    (high-occurrence seeds for the occurrence filters and the rescue)
    plus its reverse; the JAX index and the port's index of it."""
    rng = np.random.default_rng(1)
    unit = random_genome(rng, 300)
    g = "".join(random_genome(rng, 2000) + unit for _ in range(40))
    ji = jax_build_index([("g", encode(g)), ("h", encode(g[::-1]))],
                         IndexOptions(k=K, w=W))
    return g, ji, index_from_jax(ji, "cpu")


def _read_batch(rng, genome, B, lo=200, hi=1000):
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(genome) - n))
        r = encode(genome[s:s + n])
        codes[b, :n] = r
        lens[b] = n
    return codes, lens


def _to_jax(d):
    return {k: jnp.asarray(v.numpy()) for k, v in d.items()}


# ------------------------------------------------------------------ hash
@pytest.mark.parametrize("k", [11, 13, 15])
def test_hash64_matches_jax(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), 4096, dtype=np.int64)
    keys[:4] = [0, 1, (1 << (2 * k)) - 1, (1 << (2 * k)) - 2]
    want = np.asarray(jax_u64.hash32(
        jnp.asarray(keys.astype(np.uint32)),
        jnp.uint32(jax_u64.mask_bits(2 * k))))
    got = u64.hash64(torch.from_numpy(keys), k).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# ---------------------------------------------------------------- sketch
@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_compact_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 12
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4  # N-breaks
    codes[2, 100:260] = 1  # homopolymer: window-minimum ties
    codes[3, 50:400] = np.tile([0, 1], 175)  # dinucleotide repeat
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:4] = [L, L, L, 16]
    lens[4] = 3  # shorter than k
    for b in range(B):
        codes[b, lens[b]:] = 4
    # M below the emitted count of some reads: the overflow drops
    for m in (M, 48):
        want = jax_sketch_compact(jnp.asarray(codes), jnp.asarray(lens), K, W, m)
        got = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens),
                             K, W, m)
        np.testing.assert_array_equal(got["n"].numpy(), np.asarray(want["n"]))
        np.testing.assert_array_equal(
            got["key"].numpy(), np.asarray(want["key_lo"]).astype(np.int64))
        for f in ("pos", "strand", "span"):
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


# ----------------------------------------------------------------- index
def test_index_from_jax_round_trip(repeat_index):
    g, ji, ti = repeat_index
    jd, td = ji.device, ti.device_index("cpu")
    np.testing.assert_array_equal(
        td.hash_rows.numpy(), np.asarray(jd.hash_rows).view(np.int32))
    for name in ("hash_val", "offcnt", "pos_rp"):
        np.testing.assert_array_equal(
            getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    assert (td.n_keys, td.hash_bits, td.hash_shift) == (
        jd.n_keys, jd.hash_bits, jd.hash_shift)
    # the port's own builder gives the same host arrays
    own = build_index([("g", encode(g)), ("h", encode(g[::-1]))],
                      IndexOptions(k=K, w=W))
    for name in ("keys", "key_offsets", "positions", "seq_lens", "ref_codes"):
        np.testing.assert_array_equal(getattr(own, name), getattr(ji, name))


def test_torch_contig_sketch_matches_native(monkeypatch):
    """The builder's torch branch (no native library) gives the index
    the native contig sketcher gives."""
    from mappy_rs_tpu_torch import native

    rng = np.random.default_rng(5)
    g = random_genome(rng, 30_000)
    want = build_index([("g", g)], IndexOptions(k=K, w=W))
    monkeypatch.setattr(native, "sketch_contig", lambda *a, **k: None)
    got = build_index([("g", g)], IndexOptions(k=K, w=W))
    for name in ("keys", "key_offsets", "positions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


# ---------------------------------------------------------------- lookup
@pytest.mark.parametrize(
    "mid_occ,occ_dist,max_max_occ,q_occ_frac",
    [
        (2, 500, 4095, 0.01),  # map-ont filters, rescue live
        (1, 100, 40, 0.0),  # aggressive rescue, capped occurrence
        (50, 0, 0, 0.01),  # no rescue; anchor budget overflows
    ],
)
def test_collect_anchors_matches_jax(repeat_index, mid_occ, occ_dist,
                                     max_max_occ, q_occ_frac):
    g, ji, ti = repeat_index
    codes, lens = _read_batch(np.random.default_rng(mid_occ), g, 16)
    A = 256
    jm = jax_sketch_compact(jnp.asarray(codes), jnp.asarray(lens), K, W, M)
    want = collect_anchors_dev(ji.device, jm, jnp.asarray(lens), mid_occ, A,
                               K, q_occ_frac, occ_dist, max_max_occ)
    tm = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens), K, W, M)
    got = collect_anchors(tm, torch.from_numpy(lens), ti.device_index("cpu"),
                          mid_occ, A, K, q_occ_frac, occ_dist, max_max_occ)
    for f in ("n", "n_raw", "rep_len"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    # full-key ties occur only among invalid slots: compare valid ones
    for f in ("rev", "rid", "rpos", "qpos", "span"):
        np.testing.assert_array_equal(got[f].numpy()[valid],
                                      np.asarray(want[f])[valid])
    if mid_occ == 50:
        assert (np.asarray(want["n_raw"]) > A).any(), "no overflow exercised"


def test_seed_select_cnt_ties_in_one_gap():
    """Five high-occurrence seeds of EQUAL count in one 1000 bp gap get a
    budget of floor(1000/500 + 0.499) = 2: the first two by slot are
    rescued, in the JAX package and in the port."""
    pos = np.asarray([[0, 100, 200, 300, 400, 500, 1000]], np.int32)
    cnt = np.asarray([[3, 20, 20, 20, 20, 20, 3]], np.int32)
    found = np.ones_like(pos, bool)
    qlens = np.asarray([1100], np.int32)
    args = (10, 500, 4095)
    jk, jr = jax_seed_select_keep(jnp.asarray(pos), jnp.asarray(cnt),
                                  jnp.asarray(found), jnp.asarray(qlens), *args)
    tk, tr = seed_select_keep(torch.from_numpy(pos), torch.from_numpy(cnt),
                              torch.from_numpy(found), torch.from_numpy(qlens),
                              *args)
    want = np.asarray([[0, 1, 1, 0, 0, 0, 0]], bool)
    np.testing.assert_array_equal(tr.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jr), want)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_select_random_ties_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, Mm = 4, 200
    pos = np.sort(rng.choice(20000, (B, Mm)), axis=1).astype(np.int32)
    # few distinct counts: many ties within a gap, sparse low seeds
    cnt = rng.choice([3, 20, 20, 20, 30, 30, 50, 5000], (B, Mm)).astype(np.int32)
    found = rng.random((B, Mm)) < 0.95
    qlens = np.full(B, 20100, np.int32)
    args = (10, 500, 4095)
    jk, jr = jax_seed_select_keep(jnp.asarray(pos), jnp.asarray(cnt),
                                  jnp.asarray(found), jnp.asarray(qlens), *args)
    tk, tr = seed_select_keep(torch.from_numpy(pos), torch.from_numpy(cnt),
                              torch.from_numpy(found), torch.from_numpy(qlens),
                              *args)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tr.numpy().sum() > 0


# ----------------------------------------------------------- K1: chain DP
def test_gap_penalty_exhaustive_matches_jax():
    """Every dd in 0..bw+1 against a spread of dg: the float32 penalty
    truncates to the same int as JAX's (no FMA contraction)."""
    dd = np.arange(0, CHAIN["bw"] + 2, dtype=np.int32)
    dg = np.asarray([1, 2, 7, 15, 16, 100, 999, 2500, 4999, 5000], np.int32)
    ddg, dgg = np.meshgrid(dd, dg)
    dq = dgg
    dr = dgg + ddg
    for p_j, p_t in ((JP, TP), (JP._replace(chn_pen_skip=0.37 * 0.01 * K),
                                TP._replace(chn_pen_skip=0.37 * 0.01 * K))):
        want = np.asarray(jax_gap_pen(jnp.asarray(dr), jnp.asarray(dq),
                                      jnp.asarray(ddg), jnp.asarray(dgg), p_j))
        got = _gap_pen(torch.from_numpy(dr), torch.from_numpy(dq),
                       torch.from_numpy(ddg), torch.from_numpy(dgg), p_t)
        np.testing.assert_array_equal(got.numpy(), want)


def _front_end_anchors(repeat_index, B=8, A=512):
    g, _ji, ti = repeat_index
    codes, lens = _read_batch(np.random.default_rng(11), g, B, 600, 1000)
    tm = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens), K, W, M)
    a = collect_anchors(tm, torch.from_numpy(lens), ti.device_index("cpu"),
                        8, A, K, 0.01, 500, 4095)
    return {f: a[f] for f in ("rev", "rid", "rpos", "qpos", "span", "valid")}


@pytest.mark.parametrize("window", [128, 512])
def test_chain_plain_matches_pallas(repeat_index, window):
    rng = np.random.default_rng(window)
    for anchors in (sweep_anchors(rng, 4, 384, CHAIN["bw"]),
                    _front_end_anchors(repeat_index)):
        jf, jp = chain_scores_pallas(_to_jax(anchors), JP, window)
        launches = ck.launches
        f, p = ck.chain_scores_kernel(anchors, TP, window)
        assert ck.launches == launches  # CPU tensors take the plain version
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert (p.numpy() >= 0).sum() > 100


# ------------------------------------------------------- K2: backtrack
def _random_chain_dp(rng, B, A):
    """tests/test_backtrack.py's generator: random but structurally
    valid chain DP output (p[i] < i within one (rev, rid) group)."""
    f = np.zeros((B, A), np.int32)
    p = np.full((B, A), -1, np.int32)
    valid = np.zeros((B, A), bool)
    qpos = np.zeros((B, A), np.int32)
    rpos = np.zeros((B, A), np.int32)
    rev = np.zeros((B, A), np.int32)
    rid = np.zeros((B, A), np.int32)
    span = np.full((B, A), 15, np.int32)
    for b in range(B):
        n = int(rng.integers(10, A))
        valid[b, :n] = True
        qp = np.sort(rng.integers(0, 2000, n)).astype(np.int32)
        qpos[b, :n] = qp
        rpos[b, :n] = qp + rng.integers(-5, 6, n)
        rev[b, :n] = rng.integers(0, 2, n)
        rid[b, :n] = rng.integers(0, 3, n)
        for i in range(n):
            cands = [j for j in range(max(0, i - 8), i)
                     if rev[b, j] == rev[b, i] and rid[b, j] == rid[b, i]]
            if cands and rng.random() < 0.8:
                j = int(rng.choice(cands))
                p[b, i] = j
                f[b, i] = f[b, j] + int(rng.integers(5, 20))
            else:
                f[b, i] = int(rng.integers(5, 60))
    anchors = {n: torch.from_numpy(v) for n, v in (
        ("valid", valid), ("rev", rev), ("rid", rid), ("rpos", rpos),
        ("qpos", qpos), ("span", span))}
    return anchors, torch.from_numpy(f), torch.from_numpy(p)


def _check_backtrack(anchors, f, p, Kp, cuts, min_cnt, min_sc):
    want = np.asarray(backtrack_chains_pallas(
        _to_jax(anchors), jnp.asarray(f.numpy()), jnp.asarray(p.numpy()),
        Kp, cuts, min_cnt, min_sc))
    launches = bt.launches
    got = bt.backtrack_chains(anchors, f, p, Kp, cuts, min_cnt, min_sc)
    assert bt.launches == launches
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_backtrack_plain_matches_pallas_random_dp(seed):
    """The cases of tests/test_backtrack.py (B=8, A=128, K=6, 4 cuts)."""
    anchors, f, p = _random_chain_dp(np.random.default_rng(seed), 8, 128)
    out = _check_backtrack(anchors, f, p, 6, 4, 3, 40)
    assert (out[:, :, 0] >= 0).sum() > 0


def test_backtrack_plain_matches_pallas_chain_output(repeat_index):
    """On real chain DP output, with segmentation cuts and rejected
    walks (min_cnt 3, min_sc 40) at the main path's K=8, 2 cuts."""
    anchors = _front_end_anchors(repeat_index, B=8, A=512)
    f, p = chain_scores(anchors, TP, 128)
    out = _check_backtrack(anchors, f, p, 8, 2, 3, 40)
    assert (out[:, :, 0] >= 0).sum() > 0
    assert (out[:, :, 9] >= 0).sum() > 0  # some cuts recorded


def test_backtrack_edge_cases_match_pallas():
    """Joins (walk meets a used anchor: score = f[end] - f[join]),
    predecessors outside [0, A) (read as 0), a self loop, an empty read
    and a read whose chains all fail min_cnt."""
    A = 128
    anchors, f, p = _random_chain_dp(np.random.default_rng(9), 6, A)
    f, p = f.clone(), p.clone()
    p[1, 50] = 200  # beyond A
    p[1, 60] = 60  # self loop
    anchors["valid"][2] = False  # empty read
    f[3] = torch.where(f[3] > 0, 45, f[3])  # many equal-score candidates
    p[3] = -1  # every chain has one anchor: all rejected by min_cnt
    _check_backtrack(anchors, f, p, 8, 2, 3, 40)
    _check_backtrack(anchors, f, p, 8, 0, 1, 0)
