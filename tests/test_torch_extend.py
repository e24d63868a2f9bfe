"""The port's device extension backend, held against the JAX package.

On seeded inputs (made with numpy, handed to both packages): the plain
version of kernel K3 (``ops/extend.py`` ``extend_dp``) equals the JAX
package's XLA ``extend_dp`` exactly; the plain version of kernel K4
(``ops/traceback.py`` ``traceback_plain``) equals the JAX pipeline's
host walk (its start-cell rule plus ``cigar.traceback_one``); the
port's ``extend_traceback_device`` on the CPU equals the JAX package's
Pallas pair in interpret mode; the ops table overflows exactly when the
walk has more runs than it holds; and ``Aligner(device="cpu")`` with
``extension_backend`` "device" or "device_dl" gives the JAX Aligner's
Mappings field for field.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.ops import cigar as jcig
from mappy_rs_tpu.ops.extend import ExtendParams as JaxExtendParams
from mappy_rs_tpu.ops.extend import extend_dp as jax_extend_dp
from mappy_rs_tpu.ops.extend_pallas import (
    extend_traceback_device as jax_extend_traceback_device,
)

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.ops.extend import BEST_COLS, ExtendParams, extend_dp
from mappy_rs_tpu_torch.ops.extend_kernel import extend_traceback_device
from mappy_rs_tpu_torch.ops.traceback import traceback_plain
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

# map-ont extension scoring
P = dict(a=2, b=4, q=4, e=2, q2=24, e2=1, sc_ambi=1)
PARAMS = ExtendParams(**P)
JPARAMS = JaxExtendParams(**P)
END_BONUS = 10


def _mutate(rng, codes, err):
    """Substitutions, insertions and runs of deletions at rate `err`."""
    out = []
    i = 0
    while i < len(codes):
        r = rng.random()
        if r < err * 0.5:
            out.append((codes[i] + 1 + rng.integers(0, 3)) % 4)
            i += 1
        elif r < err * 0.75:
            out.append(codes[i])
            out.extend(rng.integers(0, 4, rng.integers(1, 4)))
            i += 1
        elif r < err:
            i += int(rng.integers(1, 5))
        else:
            out.append(codes[i])
            i += 1
    return np.asarray(out, np.uint8)


def _edge_jobs(rng, J=8, QMAX=96, TMAX=224):
    """The shapes the card kernels' warp designs are sensitive to, in one
    batch with QMAX != TMAX: two jobs of a few bases (shorter than one of
    K4's slabs), one whose end cell lies ~160 diagonals off the main one
    (out of narrow bands), an extension-like and a global-like job, an
    indel-dense job (more runs than a small ops table holds), and the
    jobs with qlen == 0 and tlen == 0."""
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    rows = []
    for n in (7, 1):
        tseq = rng.integers(0, 4, n).astype(np.uint8)
        rows.append((_mutate(rng, tseq, 0.1)[:QMAX] if n > 1 else tseq, tseq))
    tseq = rng.integers(0, 4, 200).astype(np.uint8)
    rows.append((_mutate(rng, tseq[:40], 0.05), tseq))
    tseq = rng.integers(0, 4, TMAX).astype(np.uint8)
    rows.append((_mutate(rng, tseq[:80], 0.08)[:QMAX], tseq))
    tseq = rng.integers(0, 4, 90).astype(np.uint8)
    rows.append((_mutate(rng, tseq, 0.08)[:QMAX], tseq))
    tseq = rng.integers(0, 4, 88).astype(np.uint8)
    rows.append((_mutate(rng, tseq, 0.4)[:QMAX], tseq))
    for ji, (qq, tt) in enumerate(rows):
        q[ji, : len(qq)] = qq
        t[ji, : len(tt)] = tt
        ql[ji], tl[ji] = len(qq), len(tt)
    ql[J - 2] = 0
    t[J - 2, :50] = rng.integers(0, 4, 50)
    tl[J - 2] = 50
    q[J - 1, :50] = rng.integers(0, 4, 50)
    ql[J - 1] = 50
    return q, t, ql, tl


def _jobs(seed, J=8, QMAX=192, TMAX=256, err=0.08):
    """J padded jobs: a target window and a mutated query from it —
    from the whole window (global-like, small drift) for even jobs, from
    a prefix (extension-like, qlen != tlen) for odd ones — with a few N
    bases, one job with qlen == 0 and one with tlen == 0.  Seed 2 gives
    the edge cases of ``_edge_jobs`` instead."""
    rng = np.random.default_rng(seed)
    if seed == 2:
        return _edge_jobs(rng)
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for ji in range(J):
        if ji % 2 == 0:
            tseq = rng.integers(0, 4, rng.integers(64, QMAX - 16)).astype(np.uint8)
            src = tseq
        else:
            tseq = rng.integers(0, 4, rng.integers(64, TMAX + 1)).astype(np.uint8)
            src = tseq[: rng.integers(48, min(QMAX, len(tseq)) + 1)]
        qseq = _mutate(rng, src, err)[:QMAX]
        qseq[rng.random(len(qseq)) < 0.01] = 4
        q[ji, : len(qseq)] = qseq
        t[ji, : len(tseq)] = tseq
        ql[ji], tl[ji] = len(qseq), len(tseq)
    ql[J - 2] = 0
    tl[J - 1] = 0
    return q, t, ql, tl


_CACHE = {}


def _port_dp(seed, W):
    key = (seed, W)
    if key not in _CACHE:
        q, t, ql, tl = _jobs(seed)
        res = extend_dp(torch.from_numpy(q), torch.from_numpy(t),
                        torch.from_numpy(ql), torch.from_numpy(tl), W, PARAMS)
        _CACHE[key] = ((q, t, ql, tl), res)
    return _CACHE[key]


#: band widths: the flank band (128), the mid bands _mid_band makes
#: (multiples of 32, most often 32; 96 and 160 are no powers of two)
WIDTHS = [32, 64, 96, 128, 160]
SEEDS = [0, 1, 2]


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_extend_dp_matches_jax(seed, W):
    (q, t, ql, tl), res = _port_dp(seed, W)
    want = jax_extend_dp(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                         jnp.asarray(tl), q.shape[1], t.shape[1], W, JPARAMS)
    assert res["dirs"].dtype == torch.uint8
    assert res["dirs"].shape == (q.shape[1] + t.shape[1] - 1, len(q), W)
    for k in ("dirs",) + BEST_COLS:
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the padded empty jobs: no cell, trackers NEG / 0, dirs 0
    assert (res["dirs"][:, -2:].numpy() == 0).all()
    assert (res["end_sc"][-2:] == -(1 << 28)).all()
    assert (res["end_sc"][:-2] > 0).any()


def _host_walk(dirs, best, ql, tl, W, mode):
    """The JAX pipeline's device_dl rule: start cell per mode, then the
    JAX package's host walk; None where no alignment starts."""
    NEGISH = -(1 << 27)
    best_sc, best_i, best_j, g_sc, g_j, end_sc = (int(v) for v in best)
    if mode == 0:
        if end_sc <= NEGISH:
            return None
        si, sj, sc = int(ql) - 1, int(tl) - 1, end_sc
    else:
        use_end = g_sc > NEGISH and g_sc + END_BONUS >= best_sc
        if use_end and g_sc > 0:
            si, sj, sc = int(ql) - 1, g_j, g_sc
        elif best_sc > 0:
            si, sj, sc = best_i, best_j, best_sc
        else:
            return None
    ops = jcig.traceback_one(dirs, int(ql), int(tl), W, si, sj)
    return ops, sc, si, sj


def _cigar_from_table(ops, info):
    """The port pipeline's reconstruction (_apply_fused_results)."""
    n_o, fi, fj = int(info[0]), int(info[1]), int(info[2])
    parts = []
    if fj >= 0:
        parts.append((fj + 1, 2))
    if fi >= 0:
        parts.append((fi + 1, 1))
    parts.extend((int(v) >> 4, int(v) & 0xF) for v in ops[:n_o][::-1])
    return jcig.merge_cigars([parts])


def _modes(kind, J):
    if kind == "mid":
        return np.zeros(J, np.int32)
    if kind == "flank":
        return np.ones(J, np.int32)
    return (np.arange(J) % 2).astype(np.int32)


@pytest.mark.parametrize("kind", ["mid", "flank", "mixed"])
def test_traceback_plain_matches_host_walk(kind):
    n_started = 0
    for seed in SEEDS:
        for W in WIDTHS:
            (_q, _t, ql, tl), res = _port_dp(seed, W)
            best = torch.stack([res[c] for c in BEST_COLS], 1)
            mode = _modes(kind, len(ql))
            ops, info = traceback_plain(res["dirs"], best, torch.from_numpy(ql),
                                        torch.from_numpy(tl),
                                        torch.from_numpy(mode), W, 128,
                                        END_BONUS)
            ops, info = ops.numpy(), info.numpy()
            dirs = res["dirs"].numpy()
            for ji in range(len(ql)):
                want = _host_walk(dirs[:, ji, :], best[ji].numpy(), ql[ji],
                                  tl[ji], W, mode[ji])
                if want is None:
                    assert info[ji, 4] == 0, (seed, W, ji, info[ji])
                    continue
                cig_w, sc, si, sj = want
                assert info[ji, 5] == 0 and info[ji, 4] == 1, info[ji]
                assert (info[ji, 3], info[ji, 6], info[ji, 7]) == (sc, si, sj)
                assert _cigar_from_table(ops[ji], info[ji]) == cig_w
                n_started += 1
    assert n_started >= 20


def test_extend_traceback_device_matches_pallas():
    """The one interpret-mode case: the JAX package's Pallas K3 + K4
    against the port's extend_traceback_device on the CPU."""
    rng = np.random.default_rng(12)
    J, QMAX, TMAX, W = 8, 128, 192, 128
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for ji in range(J):
        tseq = rng.integers(0, 4, rng.integers(80, TMAX)).astype(np.uint8)
        qseq = _mutate(rng, tseq[: rng.integers(60, min(QMAX, len(tseq)))],
                       0.08)[:QMAX]
        q[ji, : len(qseq)] = qseq
        t[ji, : len(tseq)] = tseq
        ql[ji], tl[ji] = len(qseq), len(tseq)
    mode = (np.arange(J) % 2).astype(np.int32)
    want = jax_extend_traceback_device(q, t, ql, tl, mode, W, JPARAMS,
                                       END_BONUS, max_ops=128)
    got = extend_traceback_device(q, t, ql, tl, mode, W, PARAMS, END_BONUS,
                                  max_ops=128, device=torch.device("cpu"))
    np.testing.assert_array_equal(got["ops"], np.asarray(want["ops"]))
    np.testing.assert_array_equal(got["info"], np.asarray(want["info"])[:, :8])
    assert got["info"][:, 4].sum() >= J - 1  # the walks started


def test_traceback_overflow_flag():
    """With OPS smaller than a walk's run count, overflow is set exactly
    for the walks whose in-band runs (the host walk's CIGAR less the
    leading border gaps) outnumber OPS; n_ops still counts them all.  On
    the seeded jobs at W=64 and on the edge cases at W=160."""
    OPS = 4
    for seed, W in ((1, 64), (2, 160)):
        (_q, _t, ql, tl), res = _port_dp(seed, W)
        best = torch.stack([res[c] for c in BEST_COLS], 1)
        mode = torch.zeros(len(ql), dtype=torch.int32)
        ops, info = traceback_plain(res["dirs"], best, torch.from_numpy(ql),
                                    torch.from_numpy(tl), mode, W, OPS,
                                    END_BONUS)
        wide, _ = traceback_plain(res["dirs"], best, torch.from_numpy(ql),
                                  torch.from_numpy(tl), mode, W, 1024,
                                  END_BONUS)
        dirs = res["dirs"].numpy()
        seen = set()
        for ji in range(len(ql)):
            want = _host_walk(dirs[:, ji, :], best[ji].numpy(), ql[ji],
                              tl[ji], W, 0)
            if want is None:
                continue
            cig_w = [list(x) for x in want[0]]
            fi, fj = int(info[ji, 1]), int(info[ji, 2])
            for n, op in ((fj + 1, 2), (fi + 1, 1)):  # strip the border gaps
                if n > 0:
                    assert cig_w[0][1] == op
                    cig_w[0][0] -= n
                    if cig_w[0][0] == 0:
                        cig_w.pop(0)
            runs = len(cig_w)
            assert int(info[ji, 0]) == runs
            assert int(info[ji, 5]) == int(runs > OPS)
            k = min(runs, OPS)
            assert (ops[ji, :k] == wide[ji, :k]).all()
            assert (ops[ji, k:] == -1).all()
            seen.add(runs > OPS)
        assert seen == {True, False}, (seed, W)


def _fields(m):
    return tuple(
        getattr(m, "cigar" if s == "_cig" else "strand" if s == "_strand" else s)
        for s in m.__slots__
    )


@pytest.fixture(scope="module")
def genome_reads():
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 2_000_000)
    reads, starts = simulate(rng, genome, 8, 1000, 0.05)
    return genome, reads, starts


@pytest.mark.parametrize("backend", ["device", "device_dl"])
def test_aligner_device_backend_matches_jax(genome_reads, backend):
    genome, reads, starts = genome_reads
    jal = mappy_rs_tpu.Aligner(seq=genome)
    want = [[_fields(m) for m in jal.map(r, cs=True, MD=True)] for r in reads]
    tal = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    eng = tal._engine
    eng.cfg.extension_backend = backend
    regs = eng.map_batch(reads, cs=True, md=True)  # one batch: shared groups
    got = [[_fields(m) for m in tal._to_mappings(r)] for r in regs]
    assert got == want
    assert tal.metrics["ext_groups"] >= 1
    for ms, s in zip(got, starts):
        assert ms and abs(ms[0][5] - s) < 100
