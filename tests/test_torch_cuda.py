"""The port's CUDA kernels and device front end on the card.

Every test needs an NVIDIA card and skips without one (decided in the
``cuda`` fixture, never at import).  This file imports nothing of JAX,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(the suite's conftest.py configures JAX).  The CPU parity of each
kernel's plain version with the JAX package is tests/test_torch_front_end.py.
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.ops import backtrack as bt
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.ops.chain import ChainParams, chain_scores
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate, sweep_anchors

# map-ont chaining parameters at k=15
PARAMS = ChainParams(max_dist_x=5000, max_dist_y=5000, bw=500, q_span=15,
                     chn_pen_gap=0.8 * 0.01 * 15, chn_pen_skip=0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("A,window", [(256, 128), (1024, 512), (4096, 128)])
def test_kernels_match_plain(cuda, A, window):
    rng = np.random.default_rng(A)
    anchors = sweep_anchors(rng, 64, A, PARAMS.bw, device=cuda)
    n1, n2 = ck.launches, bt.launches
    f, p = ck.chain_scores_kernel(anchors, PARAMS, window)
    fr, pr = chain_scores(anchors, PARAMS, ck.window_of(window))
    assert torch.equal(f, fr) and torch.equal(p, pr)
    assert (p >= 0).sum() > 0
    o = bt.backtrack_chains(anchors, f, p, 8, 2, 3, 40)
    r = bt.backtrack_chains_plain(anchors, f, p, 8, 2, 3, 40)
    assert torch.equal(o, r)
    assert (ck.launches, bt.launches) == (n1 + 1, n2 + 1)


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
