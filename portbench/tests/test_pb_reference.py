"""The plain reference: its DP against a full Smith-Waterman-Gotoh
recurrence written cell by cell, its traceback against its own score,
its sketch against a window-by-window scan, its record walk against
faulty records; and at a tiny genome the port's records pass it while
its control (the DP's scores in bfloat16) fails."""
import numpy as np
import pytest
import torch

from portbench import run, seeds
from portbench.genome import make_genome
from portbench.reads import make_reads
from portbench.reference import Reference, anchors, dp
from portbench.reference.records import Scoring, encode, fields, walk
from portbench.tests.tiny import tiny_spec

SC = Scoring(a=2, b=4, q=4, e=2, q2=24, e2=1)


def _naive_local(q, t, sc):
    """Gotoh's local recurrence with two gap pieces, cell by cell."""
    n, m = len(q), len(t)
    neg = -10**9
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((2, n + 1, m + 1), neg, np.int64)
    F = np.full((2, n + 1, m + 1), neg, np.int64)
    pieces = [(sc.q, sc.e), (sc.q2, sc.e2)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            for k, (o, e) in enumerate(pieces):
                E[k, i, j] = max(H[i, j - 1] - o - e, E[k, i, j - 1] - e)
                F[k, i, j] = max(H[i - 1, j] - o - e, F[k, i - 1, j] - e)
            s = sc.a if q[i - 1] == t[j - 1] else -sc.b
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[:, i, j].max(),
                          F[:, i, j].max())
    return int(H.max())


def _full_band(q, t, W=None):
    """A window and W whose band covers every cell of q against t."""
    n, m = len(q), len(t)
    W = W or n + m
    win = np.full(n + 2 * W + 1, dp.T_PAD, np.uint8)
    win[n:n + m] = t
    return win, W


def _similar(rng, n):
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = t.copy()
    q[rng.random(n) < 0.1] = rng.integers(0, 4)
    q = np.delete(q, np.flatnonzero(rng.random(n) < 0.05))
    q = np.insert(q, rng.integers(0, len(q), 4), 2)
    if rng.random() < 0.5:  # a long gap, for the second gap piece
        q = np.delete(q, np.arange(10, 10 + 30))
    return q.astype(np.uint8), t


@pytest.mark.parametrize("case", range(6))
def test_dp_equals_the_full_recurrence(case):
    rng = np.random.default_rng(case)
    q, t = _similar(rng, int(rng.integers(40, 90)))
    win, W = _full_band(q, t)
    got, _ = dp.best_local([q], [win], W, SC, "cpu")
    assert int(got[0]) == _naive_local(q, t, SC)


def test_traceback_scores_its_best():
    rng = np.random.default_rng(11)
    pairs = [_similar(rng, n) for n in (60, 75, 90)]
    W = max(len(q) + len(t) for q, t in pairs)  # one W for the block
    qs = [q for q, _ in pairs]
    wins = [_full_band(q, t, W)[0] for q, t in pairs]
    best, paths = dp.best_local(qs, wins, W, SC, "cpu", traceback=True)
    for q, w, b, (q0, q1, w0, w1, cig) in zip(qs, wins, best, paths):
        why, score, _, _, _ = fields(q[q0:q1], w[w0:w1], cig, SC)
        assert why is None and score == b


def test_sketch_equals_a_window_scan():
    rng = np.random.default_rng(5)
    k, w = 15, 10
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    keys, pos, _ = anchors.minimizer_keys(
        torch.from_numpy(codes), torch.zeros(3000, dtype=torch.int32), k, w)
    mask = (1 << 2 * k) - 1
    h = []
    for p in range(len(codes) - k + 1):
        f = r = 0
        for j in range(k):
            f = (f << 2) | int(codes[p + j])
            r |= (3 - int(codes[p + j])) << (2 * j)
        h.append(int(anchors.hash64(torch.tensor([min(f, r)]), mask)[0]))
    want = set()
    for s in range(len(h) - w + 1):
        m = min(h[s:s + w])
        want |= {s + j for j in range(w) if h[s + j] == m}
    assert sorted(want) == pos.tolist()
    assert [h[p] for p in sorted(want)] == keys.tolist()


def test_walk_finds_each_faulty_field():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 400).astype(np.uint8)
    read = t[100:300].copy()
    read[[10, 50]] = (read[[10, 50]] + 1) & 3
    read = np.delete(read, [120, 121])
    contigs = {"c": t}
    cig = [(118, 0), (2, 2), (80, 0)]
    _, _, mlen, blen, cs = fields(read, t[100:300], cig, SC)
    rec = (0, 198, "+", "c", 400, 100, 300, mlen, blen, 60, True, cig,
           blen - mlen, cs)
    assert walk(rec, read, contigs, SC).why is None
    for k, v in [(5, 101), (12, rec[12] + 1), (13, cs.replace(":", ":1", 1)),
                 (7, mlen - 1), (9, 61), (11, [(118, 0), (2, 2), (79, 0)])]:
        bad = list(rec)
        bad[k] = v
        assert walk(tuple(bad), read, contigs, SC).why is not None


@pytest.mark.parametrize("cell,n", [("ont-hg38.readfish", 48),
                                    ("ont-ecoli.wgs-8k", 8)])
def test_port_passes_and_control_fails(cell, n):
    spec = tiny_spec(cell)
    g = make_genome(spec.cfg, 2**31 + 7, "cpu")
    reads, truth = make_reads(spec.mix, n, g, seeds.rng(7, seeds.READS))
    sysm = run.setup_system(spec.cfg, g, "cpu")
    got = {}
    for ms, d in sysm.al.map_batch([{"i": i, "seq": s}
                                    for i, s in enumerate(reads)]):
        got[d["i"]] = [run.program_record(m) for m in ms]
    sysm.al.enable_threading(0)
    ref = Reference(g, spec.cfg)
    lim = spec.mix["limits"]
    j = ref.judge(reads, truth, [got[i] for i in range(n)])
    assert j["judged"] >= n // 2
    assert j["records_inconsistent"] == 0
    assert j["score_gap_pct"] <= lim["score_gap_pct"]
    c = ref.judge(reads, truth, ref.control_records(reads, truth))
    assert c["records_inconsistent"] == 0
    assert c["score_gap_pct"] > lim["score_gap_pct"]
