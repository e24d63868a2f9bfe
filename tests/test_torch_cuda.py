"""The port's CUDA kernels and device front end on the card.

Every test needs an NVIDIA card and skips without one (decided in the
``cuda`` fixture, never at import).  This file imports nothing of JAX,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(the suite's conftest.py configures JAX).  The CPU parity of each
kernel's plain version with the JAX package is in
tests/test_torch_front_end.py (K1, K2) and tests/test_torch_extend.py
(K3, K4).
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.models import pipeline
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.ops import backtrack as bt
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.ops import extend_kernel as ek
from mappy_rs_tpu_torch.ops import traceback as tb
from mappy_rs_tpu_torch.ops.chain import ChainParams, chain_scores
from mappy_rs_tpu_torch.ops.extend import BEST_COLS, ExtendParams, extend_dp
from mappy_rs_tpu_torch.ops.lookup import probe_index
from mappy_rs_tpu_torch.ops.sketch import compress_hpc, hpc_spans, sketch_compact
from mappy_rs_tpu_torch.utils import u64
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import (edge_anchors, random_genome,
                                               simulate, splice_anchors,
                                               spliced_genes, sweep_anchors,
                                               tile_anchors,
                                               tile_chain_result)

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

# map-ont chaining parameters at k=15
PARAMS = ChainParams(max_dist_x=5000, max_dist_y=5000, bw=500, q_span=15,
                     chn_pen_gap=0.8 * 0.01 * 15, chn_pen_skip=0.0)
# map-ont extension scoring
EXT = ExtendParams(a=2, b=4, q=4, e=2, q2=24, e2=1, sc_ambi=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("A,window,skip", [
    (256, 128, 0.0), (1024, 512, 0.0), (4096, 128, 0.0), (1024, 256, 0.0),
    (2048, 1024, 0.0), (1024, 128, 0.37), (1024, 512, 0.37)])
def test_kernels_match_plain(cuda, A, window, skip):
    """Every ring size of K1 (windows 128-1024) and both of its penalty
    paths: the dd table (skip scale 0) and the float path (skip > 0)."""
    rng = np.random.default_rng(A + window)
    params = PARAMS._replace(chn_pen_skip=skip * 0.01 * 15)
    anchors = sweep_anchors(rng, 64, A, PARAMS.bw, device=cuda)
    n1, n2 = ck.launches, bt.launches
    f, p = ck.chain_scores_kernel(anchors, params, window)
    fr, pr = chain_scores(anchors, params, ck.window_of(window))
    assert torch.equal(f, fr) and torch.equal(p, pr)
    assert (p >= 0).sum() > 0
    o = bt.backtrack_chains(anchors, f, p, 8, 2, 3, 40)
    r = bt.backtrack_chains_plain(anchors, f, p, 8, 2, 3, 40)
    assert torch.equal(o, r)
    assert (ck.launches, bt.launches) == (n1 + 1, n2 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("A,window", [(512, 128), (4096, 128), (1024, 512)])
def test_chain_kernel_splice_branch_matches_plain(cuda, A, window):
    """K1's splice branch (the float penalty path: the dd table is off
    under is_splice) at the splice presets' gates, on anchors whose
    reference gaps sweep 0-200,000 (intron-sized gaps included)."""
    params = ChainParams(max_dist_x=200_000, max_dist_y=2000, bw=200_000,
                         q_span=15, chn_pen_gap=0.8 * 0.01 * 15,
                         chn_pen_skip=0.0, is_splice=1)
    anchors = splice_anchors(np.random.default_rng(A + window), 32, A,
                             device=cuda)
    f, p = ck.chain_scores_kernel(anchors, params, window)
    fr, pr = chain_scores(anchors, params, ck.window_of(window))
    assert torch.equal(f, fr) and torch.equal(p, pr)
    b, i = torch.nonzero(p >= 0, as_tuple=True)
    gap = anchors["rpos"][b, i] - anchors["rpos"][b, p[b, i]]
    assert (gap > 50_000).sum() > 0 and (gap > 80).sum() > 0
    o = bt.backtrack_chains(anchors, f, p, 8, 2, 3, 40)
    assert torch.equal(o, bt.backtrack_chains_plain(anchors, f, p, 8, 2, 3, 40))


@pytest.mark.cuda
def test_hash64_wide_k_on_card(cuda):
    """int64 hash64 for k 16..28 (keys of 32..56 bits) wraps on the card
    as on the CPU: its shifts leave int64's range before the mask."""
    for k in range(16, 29):
        keys = np.random.default_rng(k).integers(0, 1 << (2 * k), 1 << 16,
                                                 dtype=np.int64)
        keys[:2] = [(1 << (2 * k)) - 1, (1 << 55) + 12345 if k == 28 else 0]
        want = u64.hash64(torch.from_numpy(keys), k)
        got = u64.hash64(torch.from_numpy(keys).to(cuda), k)
        assert torch.equal(got.cpu(), want), k


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["map-hifi", "sr"])
def test_two_word_probe_on_card(cuda, preset):
    """The two-word table's probe (k=19 / 21) on the card == on the CPU,
    sentinel slots included."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 300_000)
    reads, _ = simulate(rng, genome, 32, 700, 0.01)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset, device="cpu")
    idx = al._engine.index
    assert idx.device_index("cpu").two_word
    codes = np.full((32, 768), 4, np.uint8)
    lens = np.zeros(32, np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode(r)
        lens[i] = len(r)
    mins = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens),
                          idx.k, idx.w, 256)
    want = probe_index(mins, idx.device_index("cpu"))
    got = probe_index({k: v.to(cuda) for k, v in mins.items()},
                      idx.device_index(cuda))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert want[0].sum() > 0


@pytest.mark.cuda
def test_hpc_sketch_on_card(cuda):
    """The HPC sketch_compact (k=19, w=10) on the card == on the CPU."""
    rng = np.random.default_rng(8)
    B, L = 64, 1024
    runs = rng.integers(1, 6, (B, L))
    codes = np.stack([np.repeat(rng.integers(0, 4, L), r)[:L] for r in runs]
                     ).astype(np.uint8)
    lens = rng.integers(16, L + 1, B).astype(np.int32)
    for b in range(B):
        codes[b, lens[b]:] = 4
    codes[0, 200:500] = 3  # spans >= 256: force_inf
    cc, cl, run_end, run_len = compress_hpc(codes, lens)
    sp = hpc_spans(run_len, 19)
    args = [torch.from_numpy(x) for x in (cc, cl, sp >= 256, run_end, sp)]

    def run(dev):
        c, n, f, pm, s = (a.to(dev) for a in args)
        return sketch_compact(c, n, 19, 10, 256, force_inf=f, pos_map=pm,
                              spans=s)

    want, got = run("cpu"), run(cuda)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    assert want["n"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["map-hifi", "sr", "map-pb", "splice"])
def test_presets_on_card_match_cpu(cuda, preset):
    """Each new preset maps on the card as through the CPU plain
    versions, launching K1 and K2."""
    rng = np.random.default_rng(9)
    genome = random_genome(rng, 1_000_000)
    if preset == "splice":
        genome, reads, _ = spliced_genes(rng, genome, 8, 0.01)
    else:
        reads, _ = simulate(rng, genome, 8, 150 if preset == "sr" else 2000,
                            0.01)
    gpu = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset, device=cuda)
    cpu = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset, device="cpu")
    n1, n2 = ck.launches, bt.launches
    got = gpu._engine.map_batch(reads, cs=True, md=True)
    assert ck.launches > n1 and bt.launches > n2
    want = cpu._engine.map_batch(reads, cs=True, md=True)
    assert [gpu._to_mappings(r) for r in got] == [cpu._to_mappings(r) for r in want]
    assert all(got)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(15, 10), (19, 19)])
def test_index_build_on_card_matches_cpu(cuda, k, w):
    """build_index's sort and the device tables, built on the card, equal
    the CPU build's array for array on a repeat-rich genome (the
    genome-scale model at 3 x 2^20 bp: many positions per key), at a
    one-word (k = 15) and a two-word (k = 19) table."""
    from mappy_rs_tpu_torch.config import IndexOptions
    from mappy_rs_tpu_torch.index.build import build_index
    from mappy_rs_tpu_torch.tools import gbp_chip

    model = gbp_chip.GenomeModel(n_contig=3, contig_bits=20)
    buf, _, _ = gbp_chip.build_genome(np.random.default_rng(5), model)
    C = model.contig
    seqs = [(f"ctg{i:02d}", buf[i * C: (i + 1) * C])
            for i in range(model.n_contig)]
    c = build_index(seqs, IndexOptions(k=k, w=w), device="cpu")
    g = build_index(seqs, IndexOptions(k=k, w=w), device=cuda)
    for name in ("keys", "key_offsets", "positions"):
        np.testing.assert_array_equal(getattr(g, name), getattr(c, name))
    assert (np.diff(c.key_offsets.astype(np.int64)) > 1).sum() > 1000
    dc, dg = c.device_index("cpu"), g.device_index(cuda)
    for name in ("offcnt", "pos_rp", "hash_rows", "hash_val"):
        assert getattr(dg, name).device.type == "cuda"
        assert torch.equal(getattr(dg, name).cpu(), getattr(dc, name)), name
    assert (dg.n_keys, dg.hash_bits, dg.hash_shift, dg.two_word) == (
        dc.n_keys, dc.hash_bits, dc.hash_shift, dc.two_word)


@pytest.mark.cuda
@pytest.mark.parametrize("A,tile", [(32768, 0), (16384, 0), (131072, 256),
                                    (60000, 200)])
def test_kernels_match_plain_long_reads(cuda, A, tile):
    """The long-read buckets' shapes: B=8 at A=32,768 (the 131,072
    bucket), and A=131,072 from a tile of 256 anchors repeated, whose
    K1 result is the tile's, repeated.  K2 stages p in shared memory up
    to A=56,319: A=131,072 reads it from global memory, and A=60,000
    also reads its candidates one at a time (A is no multiple of 128)."""
    rng = np.random.default_rng(A)
    if tile:
        t = sweep_anchors(rng, 8, tile, PARAMS.bw, device=cuda)
        anchors = tile_anchors(t, A // tile)
        fr, pr = tile_chain_result(*chain_scores(t, PARAMS, 128), A // tile)
    else:
        anchors = sweep_anchors(rng, 8, A, PARAMS.bw, device=cuda)
        fr, pr = chain_scores(anchors, PARAMS, 128)
    f, p = ck.chain_scores_kernel(anchors, PARAMS, 128)
    assert torch.equal(f, fr) and torch.equal(p, pr)
    o = bt.backtrack_chains(anchors, f, p, 8, 8, 3, 40)
    r = bt.backtrack_chains_plain(anchors, f, p, 8, 8, 3, 40)
    assert torch.equal(o, r)
    assert (o[:, :, 0] >= 0).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [128, 512])
def test_kernels_match_plain_edge_cases(cuda, window):
    """All candidates equal (the largest j wins), a best total equal to
    span_i (p = -1), an all-invalid read, a non-prefix valid mask."""
    e = edge_anchors(np.random.default_rng(window), 512, device=cuda)
    f, p = ck.chain_scores_kernel(e, PARAMS, window)
    fr, pr = chain_scores(e, PARAMS, window)
    assert torch.equal(f, fr) and torch.equal(p, pr)
    assert p[0, 8:16].tolist() == [7] * 8 and p[1].eq(-1).all()
    assert p[2].eq(-1).all() and (p[3] >= 0).sum() > 0
    for K, cuts in ((8, 2), (4, 0)):
        o = bt.backtrack_chains(e, f, p, K, cuts, 1, 0)
        r = bt.backtrack_chains_plain(e, f, p, K, cuts, 1, 0)
        assert torch.equal(o, r)


@pytest.mark.cuda
def test_aligner_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 1_000_000)
    reads, starts = simulate(rng, genome, 16, 1000, 0.05)
    gpu = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    cpu = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    assert gpu._engine.dev.hash_rows.device.type == "cuda"
    for r, s in zip(reads, starts):
        got = gpu.map(r, cs=True)
        assert got == cpu.map(r, cs=True)
        assert abs(got[0].target_start - s) < 100

    # one front-end dispatch issues no host sync
    eng = gpu._engine
    B, M, A = eng.fe_shapes(1024)
    codes = np.full((B, 1024), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c = encode(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    codes_t, lens_t = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chains, _aux = front_end_bt(codes_t, lens_t, eng.dev,
                                    **eng._fe_kwargs(M, A, 2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (chains[: len(reads), 0, 0] >= 0).all()


def _ext_jobs(rng, J, QMAX, TMAX):
    """Query = the target window with 8% substitutions, insertions and
    deletions; a few N bases; every seventh job short (under 24 bases,
    shorter than one of K4's slabs), every eleventh with a query a third
    of its target (the end cell falls out of narrow bands); the last job
    empty (padding)."""
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for ji in range(J - 1):
        if ji % 7 == 3:
            tseq = rng.integers(0, 4, rng.integers(1, 24))
        else:
            tseq = rng.integers(0, 4, rng.integers(QMAX // 2, TMAX + 1))
        keep = rng.random(len(tseq)) > 0.03
        qseq = np.where(rng.random(len(tseq)) < 0.03,
                        rng.integers(0, 5, len(tseq)), tseq)[keep]
        ins = rng.random(len(qseq)) < 0.02
        qseq = np.insert(qseq, np.nonzero(ins)[0], rng.integers(0, 4, ins.sum()))
        if ji % 11 == 5:
            qseq = qseq[: max(1, len(qseq) // 3)]
        qseq = qseq[:QMAX]
        q[ji, : len(qseq)] = qseq
        t[ji, : len(tseq)] = tseq
        ql[ji], tl[ji] = len(qseq), len(tseq)
    return q, t, ql, tl


@pytest.fixture
def kernel_design(request, monkeypatch):
    """'shape': K3's warp or block kernel as W chooses it, K4's slabs at
    the default depth; 'block': K3's block kernel at every W; 'thin': K4
    with two diagonals per slab (a slab edge every step or two); 'direct':
    K4 walking device memory without slabs."""
    if request.param == "block":
        monkeypatch.setattr(ek, "WARP_MAX_W", 0)
    elif request.param == "thin":
        monkeypatch.setattr(tb, "SLAB_BYTES", 1)
    elif request.param == "direct":
        monkeypatch.setattr(tb, "SLAB_BYTES", 0)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_design", ["shape", "block", "thin", "direct"],
                         indirect=True)
@pytest.mark.parametrize("W", [32, 64, 72, 96, 128, 160, 256, 288])
def test_extension_kernels_match_plain(cuda, W, kernel_design):
    """K3 and K4 equal their plain versions at every band width the
    pipeline makes, on both sides of K3's warp/block switch (W = 256 /
    288) and at W = 72 (no multiple of 32 or 16: K3's block kernel, K4
    walking device memory without slabs), with J = 61 (no multiple of the jobs per block), a query and
    target of different lengths, short, out-of-band and empty jobs, and
    modes 0/1 mixed; K4 at OPS 128 and 4 (some walks overflow)."""
    rng = np.random.default_rng(W)
    J = 61
    q, t, ql, tl = (torch.from_numpy(x).to(cuda)
                    for x in _ext_jobs(rng, J, 256, 320))
    n3, n4 = ek.launches, tb.launches
    got = ek.extend_dp_kernel(q, t, ql, tl, W, EXT)
    want = extend_dp(q, t, ql, tl, W, EXT)
    for k in ("dirs",) + BEST_COLS:
        assert torch.equal(got[k], want[k]), k
    assert (want["end_sc"] > 0).sum() > 0
    assert ek.shapes[(256, 320, W, J)] > 0
    mode = (torch.arange(J, device=cuda) % 2).to(torch.int32)
    best = torch.stack([want[c] for c in BEST_COLS], 1)
    for ops_w in (128, 4):  # 4: some walks overflow the table
        o, i = tb.traceback_device(got["dirs"], got["best"], ql, tl, mode, W,
                                   ops_w, 10)
        o2, i2 = tb.traceback_plain(want["dirs"], best, ql, tl, mode, W,
                                    ops_w, 10)
        assert torch.equal(o, o2) and torch.equal(i, i2)
    assert i[:, 5].sum() > 0 and i[:, 4].sum() > 16
    assert (ek.launches, tb.launches) == (n3 + 1, n4 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["device", "device_dl"])
def test_device_extension_backend_on_card_matches_cpu(cuda, backend):
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 1_000_000)
    reads, starts = simulate(rng, genome, 16, 1000, 0.05)
    gpu = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    cpu = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    want = cpu._engine.map_batch(reads, cs=True, md=True)  # host backend
    n3, n4 = ek.launches, tb.launches
    gpu._engine.cfg.extension_backend = backend
    got = gpu._engine.map_batch(reads, cs=True, md=True)
    assert [gpu._to_mappings(r) for r in got] == [cpu._to_mappings(r) for r in want]
    assert ek.launches > n3
    assert (tb.launches > n4) == (backend == "device")
    for r, s in zip(got, starts):
        assert abs(r[0].rs - s) < 100


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2048, 6144])
def test_extension_kernel_wide_bands(cuda, W):
    """Bands of several lanes per thread (K3's block kernel): W=2048
    keeps the DP rows in (opt-in, > 48 KB) shared memory, W=6144 in the
    global scratch; K4's slabs hold few diagonals there (two at W=6144,
    98 KB of shared memory per block)."""
    rng = np.random.default_rng(W)
    q, t, ql, tl = (torch.from_numpy(x).to(cuda)
                    for x in _ext_jobs(rng, 4, 1024, 1024))
    got = ek.extend_dp_kernel(q, t, ql, tl, W, EXT)
    want = extend_dp(q, t, ql, tl, W, EXT)
    for k in ("dirs",) + BEST_COLS:
        assert torch.equal(got[k], want[k]), k
    assert (want["end_sc"] > 0).sum() == 3
    assert 2 <= tb.slab_depth(W) <= 8
    mode = torch.zeros(4, dtype=torch.int32, device=cuda)
    o, i = tb.traceback_device(got["dirs"], got["best"], ql, tl, mode, W,
                               128, 10)
    best = torch.stack([want[c] for c in BEST_COLS], 1)
    o2, i2 = tb.traceback_plain(want["dirs"], best, ql, tl, mode, W, 128, 10)
    assert torch.equal(o, o2) and torch.equal(i, i2)


@pytest.mark.cuda
def test_host_backtrack_on_card_matches_k2(cuda, monkeypatch):
    """A batch whose budget K2 refuses (backtrack_fits made to refuse
    every A) runs K1 and the host backtrack: the same Mappings, with K1
    launched and K2 not."""
    rng = np.random.default_rng(41)
    genome = random_genome(rng, 1_000_000)
    reads, starts = simulate(rng, genome, 64, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    eng = al._engine
    want = [al._to_mappings(r) for r in eng.map_batch(reads, cs=True, md=True)]
    monkeypatch.setattr(pipeline, "backtrack_fits", lambda A: False)
    n1, n2 = ck.launches, bt.launches
    got = [al._to_mappings(r) for r in eng.map_batch(reads, cs=True, md=True)]
    assert got == want
    assert ck.launches > n1 and bt.launches == n2
    assert al.metrics["host_bt_batches"] > 0
    for ms, s in zip(got, starts):
        assert abs(ms[0].target_start - s) < 100


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["device_owner", "classic"])
def test_process_runtime_on_card_matches_threads(cuda, topology):
    """2 worker processes under each topology map like the threads."""
    rng = np.random.default_rng(43)
    genome = random_genome(rng, 1_000_000)
    reads, _ = simulate(rng, genome, 512, 1000, 0.05)
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    al.enable_threading(2)
    want = {d["i"]: ms for ms, d in al.map_batch(payload)}
    al._config.worker_processes = 2
    al._config.topology = topology
    al.enable_threading(2)
    try:
        assert al._procs is not None, "worker processes failed to start"
        got = {d["i"]: ms for ms, d in al.map_batch(payload)}
        assert al.metrics["worker_procs"] == 2
    finally:
        al.enable_threading(0)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("n_data,n_index", [(4, 1), (2, 2)])
def test_mesh_on_card_matches_single_device(cuda, n_data, n_index):
    """enable_mesh on a grid whose cells all lie on the one card (data
    parallel, then with the key table sharded over 2 peers) == the single
    device's Mappings, with K1 launched; sharded, the replicated tables
    are never built."""
    rng = np.random.default_rng(45)
    genome = random_genome(rng, 1_000_000)
    reads, starts = simulate(rng, genome, 256, 1000, 0.05)
    single = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    want = [single._to_mappings(r)
            for r in single._engine.map_batch(reads, cs=True, md=True)]
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cuda")
    al.enable_mesh(n_data, n_index=n_index,
                   devices=["cuda:0"] * (n_data * n_index))
    n1 = ck.launches
    got = [al._to_mappings(r)
           for r in al._engine.map_batch(reads, cs=True, md=True)]
    assert got == want
    assert ck.launches > n1
    if n_index > 1:
        assert al._engine.index._devices == {}
    assert sum(1 for ms, s in zip(got, starts)
               if ms and abs(ms[0].target_start - s) < 100) >= 250


@pytest.mark.cuda
def test_decision_mode_on_card_matches_cpu(cuda, tmp_path):
    """enable_sharding(2, 2) with every cell on the card: K3 extends, and
    the decisions equal the port's on a grid of CPU cells."""
    rng = np.random.default_rng(47)
    ctgs = [random_genome(rng, n) for n in (300_000, 500_000, 200_000)]
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as fh:
        for i, c in enumerate(ctgs):
            fh.write(f">c{i}\n{c}\n")
    reads, want = [], []
    for i in range(96):
        ci = i % len(ctgs)
        r, (s,) = simulate(rng, ctgs[ci], 1, 1000, 0.05)
        reads.append(r[0])
        want.append(f"c{ci}")
    reads.append("ACGT" * 40)
    gpu = mappy_rs_tpu_torch.Aligner(fa, device="cuda")
    gpu.enable_sharding(2, 2, devices=["cuda:0"] * 4)
    cpu = mappy_rs_tpu_torch.Aligner(fa, device="cpu")
    cpu.enable_sharding(2, 2, devices=["cpu"] * 4)
    n3 = ek.launches
    got = gpu.map_batch_positions(reads)
    assert ek.launches > n3
    assert got == cpu.map_batch_positions(reads)
    assert sum(1 for r, c in zip(got, want) if r and r["ctg"] == c) >= 94
    assert got[-1] is None


@pytest.mark.cuda
def test_concordance_on_card_matches_cpu(cuda):
    """The sweep's device front end (K1 + K2) on the card gives the same
    counts as through their plain versions on the CPU, with K1 and K2
    launched."""
    from mappy_rs_tpu_torch.tools.concordance import run_preset

    ck.launches = bt.launches = 0
    card = run_preset("map-ont", 100, device="cuda")
    assert ck.launches > 0 and bt.launches > 0
    cpu = run_preset("map-ont", 100, device="cpu")
    assert card == cpu
    assert card["both_mapped"] >= 93
    assert card["full"] >= 0.95 * card["both_mapped"]


@pytest.mark.cuda
def test_trace_front_end_on_card(cuda):
    """The trace tool on the card: the profiler's device events hold K1's
    and K2's kernels, busy time under the traced wall, CUDA-event and
    CUDA-graph times."""
    from mappy_rs_tpu_torch.tools import trace_front_end as tfe

    rec = tfe.run("map-ont", 4, genome_len=2_000_000, n_reads=256)
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["profiler_device_events"] is True
    for kern in ("chain_dp_kernel", "backtrack_kernel"):
        assert any(kern in n for n in rec["op_names"]), kern
    assert 0 < rec["busy_ms_per_batch"] <= rec["span_ms_per_batch"]
    assert 0 < rec["duty"] <= 1
    assert rec["event_ms_per_batch"] > 0 and rec["graph_ms_per_batch"] > 0


@pytest.mark.cuda
def test_bench_on_card_matches_cpu(cuda, monkeypatch):
    """tools/bench.py's card-path Aligner maps a tiny workload on the card
    as on the CPU, and the tool runs end to end on the card: every read
    placed, K1 and K2 launched in this process during the passes, no
    baseline child on the card."""
    from mappy_rs_tpu_torch.tools import bench
    from mappy_rs_tpu_torch.tools.memory import _digest

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MAPPY_RS_TPU_PROCS", "2")
    wl = bench.workload(1, 64, 1, 64)
    card = bench.card_aligner(wl.genome, "cuda")
    cpu = bench.card_aligner(wl.genome, "cpu")
    got = [card.map(r, cs=True) for r in wl.reads]
    assert _digest(got) == _digest([cpu.map(r, cs=True) for r in wl.reads])
    rec = bench.run(genome_mb=1, n_reads=256, n_pass=2, n_reads_cpu=128,
                    device="cuda")
    assert [p["placed"] for p in rec["passes"]] == [256, 256]
    launches = rec["run"]["launches"]
    assert launches["chain_dp"] > 0 and launches["backtrack_chains"] > 0
    assert rec["baseline"]["children_on_card"] == 0
    assert rec["line"]["card"] and rec["line"]["vs_baseline"] > 0


@pytest.mark.cuda
def test_memory_soak_on_card(cuda):
    """The soak on the card: card memory (allocated, reserved) grows less
    than 200 MB after the warm-up and the Mappings never change."""
    from mappy_rs_tpu_torch.tools import memory

    rec = memory.run(cycles=12, threaded=True, device="cuda")
    assert rec["cuda_growth_mb"] is not None
    assert memory.check(rec) == [], rec
    assert rec["lines"][-1]["cuda_allocated_mb"] > 0


def _graph_vs_eager(al, reads):
    """The engine's Mappings of `reads` through its CUDA graphs (their
    keys captured by a first run) and eagerly (no graph cache): equal,
    every graph-run batch a replay with no capture, equal K1 / K2
    launches.  Returns the graph run's metrics."""
    eng = al._engine
    graphs = eng._fe_graphs
    assert graphs is not None, "the card engine runs no graphs"

    def run():
        eng.metrics.reset()
        n1, n2 = ck.launches, bt.launches
        out = [al._to_mappings(r)
               for r in eng.map_batch(reads, cs=True, md=True)]
        return out, (ck.launches - n1, bt.launches - n2), \
            eng.metrics.snapshot()

    run()
    got, l_graph, m = run()
    eng._fe_graphs = None
    try:
        want, l_eager, _ = run()
    finally:
        eng._fe_graphs = graphs
    assert got == want
    assert m["fe_graph_replays"] == m["fe_batches"] > 0
    assert m.get("fe_graph_captures", 0) == 0 and l_graph == l_eager
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("preset",
                         ["map-ont", "map-hifi", "sr", "map-pb", "splice"])
def test_fe_graphs_on_card_match_eager(cuda, preset):
    rng = np.random.default_rng(51)
    genome = random_genome(rng, 1_000_000)
    if preset == "splice":
        genome, reads, _ = spliced_genes(rng, genome, 8, 0.01)
    else:
        n = {"map-ont": 300, "sr": 300}.get(preset, 16)
        ln = {"map-ont": 1000, "sr": 150}.get(preset, 5000)
        reads, _ = simulate(rng, genome, n, ln, 0.01)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset, device=cuda)
    _graph_vs_eager(al, reads)
    assert all(r["pool_mb"] > 0 for r in al._engine._fe_graphs.stats())


@pytest.mark.cuda
@pytest.mark.parametrize("backtrack", ["auto", "off"])
def test_fe_graph_retries_and_host_backtrack_on_card(cuda, backtrack):
    """The anchor-budget retries (A x 4, x 16) and the host backtrack
    replay graphs of their own keys, as the eager path maps them."""
    rng = np.random.default_rng(31)
    seg = random_genome(rng, 600)
    g = random_genome(rng, 100_000) + seg * 40 + random_genome(rng, 100_000)
    reads, _ = simulate(rng, g[:100_000], 12, 1000, 0.05)
    reads += [seg, mappy_rs_tpu_torch.revcomp(seg)]
    al = mappy_rs_tpu_torch.Aligner(seq=g, device=cuda)
    al._engine.cfg.device_backtrack = backtrack
    m = _graph_vs_eager(al, reads)
    assert m["anchor_overflow_retries"] >= 2
    keys = al._engine._fe_graphs.stats()
    assert {1024, 4096} <= {r["A"] for r in keys}
    assert all(r["use_bt"] == (backtrack == "auto") for r in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("use_bt", [True, False])
def test_fe_graph_batches_in_flight_on_card(cuda, use_bt):
    """Two batches of one key submitted before either is collected: each
    collect gives its own batch's chains, as eagerly."""
    rng = np.random.default_rng(53)
    genome = random_genome(rng, 1_000_000)
    reads, _ = simulate(rng, genome, 512, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    eng = al._engine
    codes = [encode(r) for r in reads]
    B, M, A = eng.fe_shapes(1024)

    def both():
        t1 = eng._fe_submit_batch(codes[:256], 1024, B, M, A, use_bt, 2)[1]
        t2 = eng._fe_submit_batch(codes[256:], 1024, B, M, A, use_bt, 2)[1]
        return [eng._fe_collect(t) for t in (t1, t2)]

    got = both()
    graphs, eng._fe_graphs = eng._fe_graphs, None
    want = both()
    eng._fe_graphs = graphs
    for g_, w in zip(got, want):
        for a, b in zip(g_, w):
            np.testing.assert_array_equal(a, b)
    assert eng.metrics.counters["fe_graph_replays"] == 2


@pytest.mark.cuda
def test_fe_graphs_threads_on_card(cuda):
    """4 threads replaying shared graphs map as the eager engine, every
    batch a replay."""
    rng = np.random.default_rng(55)
    genome = random_genome(rng, 1_000_000)
    reads, _ = simulate(rng, genome, 1024, 1000, 0.05)
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    al._config.device_batch_size = 64
    al.enable_threading(4)
    try:
        eng = al._engine
        graphs, eng._fe_graphs = eng._fe_graphs, None
        want = {d["i"]: ms for ms, d in al.map_batch(payload)}
        eng._fe_graphs = graphs
        eng.metrics.reset()
        got = {d["i"]: ms for ms, d in al.map_batch(payload)}
        m = eng.metrics.snapshot()
    finally:
        al.enable_threading(0)
    assert got == want
    assert m["fe_graph_replays"] == m["fe_batches"] > 0


@pytest.mark.cuda
def test_fe_graph_capture_survives_garbage_collection(cuda, monkeypatch):
    """Another engine's graphs become garbage in a fresh reference cycle
    while a new engine captures, and the capturing thread then allocates
    enough to wake the collector: the capture must not run it (a graph
    destroyed during a capture voids the capture)."""
    import gc

    rng = np.random.default_rng(57)
    genome = random_genome(rng, 300_000)
    reads, _ = simulate(rng, genome, 16, 1000, 0.05)
    old = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    old._engine.map_batch(reads)
    assert old._engine._fe_graphs.stats()
    box = [old._engine._fe_graphs]  # the old graphs' only reference
    old._engine._fe_graphs = None
    del old
    real = pipeline.front_end_bt

    def dropping(*args, **kw):
        if box and torch.cuda.is_current_stream_capturing():
            cycle = [box.pop()]
            cycle.append(cycle)  # only the collector frees the graphs now
            del cycle
            _junk = [[i] for i in range(10_000)]  # wakes the collector
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "front_end_bt", dropping)
    cpu = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    want = cpu._engine.map_batch(reads, cs=True)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    threshold = gc.get_threshold()
    gc.set_threshold(1, *threshold[1:])
    try:
        got = al._engine.map_batch(reads, cs=True)
    finally:
        gc.set_threshold(*threshold)
    assert not box, "no capture ran"
    assert al.metrics["fe_graph_captures"] >= 1
    assert [al._to_mappings(r) for r in got] == \
        [cpu._to_mappings(r) for r in want]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["device", "device_dl"])
def test_ext_graphs_on_card_match_eager(cuda, backend):
    """Each job group one replay of the graph of its shape (K3 + K4, or
    K3): the same Mappings (cs, MD), K3 / K4 launches and K3 shapes as
    the eager groups, no capture once the keys are captured."""
    rng = np.random.default_rng(59)
    genome = random_genome(rng, 1_000_000)
    reads, _ = simulate(rng, genome, 300, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    eng = al._engine
    eng.cfg.extension_backend = backend
    graphs = eng._ext_graphs
    assert graphs is not None, "the card engine runs no extension graphs"

    def run():
        eng.metrics.reset()
        n3, n4, s0 = ek.launches, tb.launches, dict(ek.shapes)
        out = [al._to_mappings(r)
               for r in eng.map_batch(reads, cs=True, md=True)]
        shapes = {k: v - s0.get(k, 0) for k, v in ek.shapes.items()
                  if v - s0.get(k, 0)}
        return out, (ek.launches - n3, tb.launches - n4), shapes, \
            eng.metrics.snapshot()

    run()
    got, l_graph, s_graph, m = run()
    eng._ext_graphs = None
    try:
        want, l_eager, s_eager, _ = run()
    finally:
        eng._ext_graphs = graphs
    assert got == want
    assert m["ext_graph_replays"] == m["ext_groups"] > 0
    assert m.get("ext_graph_captures", 0) == 0
    assert l_graph == l_eager and s_graph == s_eager
    assert (l_graph[1] > 0) == (backend == "device")
    assert all(r["pool_mb"] > 0 for r in graphs.stats())


@pytest.mark.cuda
@pytest.mark.parametrize("n_data,n_index", [(2, 1), (2, 2)])
def test_grid_graphs_on_card_match_eager(cuda, n_data, n_index):
    """Grid rows of cuda:0 cells: each row's front end one replay, the
    Mappings and K1 launches those of the rows' eager ops."""
    rng = np.random.default_rng(61)
    genome = random_genome(rng, 1_000_000)
    reads, _ = simulate(rng, genome, 600, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    al.enable_mesh(n_data, n_index=n_index,
                   devices=["cuda:0"] * (n_data * n_index))
    eng = al._engine
    assert eng.mesh.graph_rows(eng._fe_graphs) == frozenset(range(n_data))

    def run():
        eng.metrics.reset()
        n1 = ck.launches
        out = [al._to_mappings(r) for r in eng.map_batch(reads, cs=True)]
        return out, ck.launches - n1, eng.metrics.snapshot()

    run()
    got, l_graph, m = run()
    graphs, eng._fe_graphs = eng._fe_graphs, None
    try:
        want, l_eager, _ = run()
    finally:
        eng._fe_graphs = graphs
    assert got == want and l_graph == l_eager > 0
    assert m["fe_graph_replays"] == m["fe_batches"] * n_data > 0
    assert m.get("fe_graph_captures", 0) == 0


@pytest.mark.cuda
def test_decision_graphs_on_card_match_eager(cuda):
    """map_batch_positions on a 2 x 2 grid of cuda:0 cells: each row of
    each batch one replay, decisions == the eager step's; one capture per
    row and B_pad, K3 credited once per peer and replay."""
    rng = np.random.default_rng(63)
    genome = random_genome(rng, 2_000_000)
    reads, _ = simulate(rng, genome, 600, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    al.enable_sharding(2, 2, devices=["cuda:0"] * 4)
    assert al._mesh.graph_rows(al._dec_graphs) == frozenset({0, 1})
    batches = [reads[:256], reads[256:512], reads[512:]]  # 256, 256, 88
    got = [al.map_batch_positions(b) for b in batches]
    n3 = ek.launches
    again = [al.map_batch_positions(b) for b in batches]
    assert ek.launches - n3 == 3 * 2 * 2
    c = al._engine.metrics.counters
    keys = set()
    for b in batches:
        L = 512
        while L < max(len(r) for r in b):
            L <<= 1
        keys.add((len(b) + len(b) % 2, L))
    assert c["dec_graph_captures"] == 2 * len(keys)
    assert c["dec_graph_replays"] == 2 * 2 * len(batches)
    assert all(r["pool_mb"] > 0 for r in al._dec_graphs.stats())
    al._dec_graphs, al._sharded_steps = None, {}
    want = [al.map_batch_positions(b) for b in batches]
    assert got == want == again
    assert sum(1 for b in want for d in b if d is not None) >= 0.99 * 600


@pytest.mark.cuda
def test_decision_stream_of_every_batch_size_within_budget(cuda):
    """map_batch_positions on a 2 x 2 grid of cuda:0 cells over every
    batch size from 1 to 512 reads of ~1 kb (L = 1,024): 256 B_pad, 512
    row keys, some 140 GB of pools if none left the cache.  The cached
    pools stay within DEC_GRAPH_BUDGET_MB and the key captured last; the
    card's peak reserved memory grows by at most the budget, the largest
    key's pool (captured before the eviction it causes), the eager
    512-read step's own peak (each capture first runs the step eagerly,
    on the one side stream whose blocks every warm-up reuses) and 64 MB
    (the allocator's 2 MB segments of small blocks, the call's own
    inputs and outputs); a size that comes back after its eviction
    captures again; every decision is the eager 512-read batch's."""
    from mappy_rs_tpu_torch.api import DEC_GRAPH_BUDGET_MB

    rng = np.random.default_rng(67)
    genome = random_genome(rng, 2_000_000)
    reads, _ = simulate(rng, genome, 512, 900, 0.05)
    assert max(len(r) for r in reads) <= 1024
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device=cuda)
    al.enable_sharding(2, 2, devices=["cuda:0"] * 4)
    graphs, al._dec_graphs = al._dec_graphs, None
    al.map_batch_positions(reads[:2])  # uploads the shards

    def peak_of(run):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_reserved() - base

    want, eager = peak_of(lambda: al.map_batch_positions(reads))
    al._dec_graphs, al._sharded_steps = graphs, {}
    sizes = list(range(1, 513)) + [1, 2]

    def stream():
        largest = 0.0
        for n in sizes:
            assert al.map_batch_positions(reads[:n]) == want[:n]
            newest = max(s["pool_mb"] for s in graphs.stats()
                         if s["B"] == (n + n % 2) // 2)
            assert graphs.pool_mb() <= DEC_GRAPH_BUDGET_MB + newest
            largest = max(largest, newest)
        return largest

    largest, grown = peak_of(stream)
    c = al._engine.metrics.counters
    print(f"decision stream of every size: {c['dec_graph_captures']:.0f} "
          f"captures, {c['dec_graph_evictions']:.0f} evictions, "
          f"{c['dec_graph_pool_mb']:.1f} MB of pools captured, "
          f"{graphs.pool_mb():.1f} MB cached at the end, the largest key "
          f"{largest:.1f} MB; peak reserved grew {grown / 2**20:.1f} MB, "
          f"the eager 512-read step's {eager / 2**20:.1f} MB")
    # B_row 1-256 once per row, then B_row 1 again (evicted by then)
    assert c["dec_graph_captures"] == 2 * (256 + 1)
    assert c["dec_graph_evictions"] > 0
    assert c["dec_graph_replays"] == 2 * len(sizes)
    assert grown <= (DEC_GRAPH_BUDGET_MB + largest + 64) * 2**20 + eager
