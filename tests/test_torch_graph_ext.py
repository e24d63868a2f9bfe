"""K3 + K4 as one CUDA graph per job-group shape, on the CPU.

On the card every "device" job group is one replay of the graph
captured for its shape (K3 then K4; ops/extend_kernel.py
``extend_traceback_device`` with the engine's extension graph cache),
and every "device_dl" group one replay of K3's graph
(``extend_dp_device``), the counterparts of the JAX package's
``_extend_traceback_jit`` and ``_extend_pallas_device`` jits.  Here the
cache is given tests/torch_parity.py ``stand_in``, whose replay re-runs
the captured ops on the static inputs into the same static outputs (a
real graph's aliasing), on the plain versions.  Every case holds the
graph run against the eager run (no cache) and the JAX package: the
main path's groups, the zdrop splits' and the inversion rescue's
(tests/test_torch_rare_paths.py's constructions), threads sharing
graphs, one key per static field, and the launch credits of K3 (with
its shapes) and K4.  The card's own cases are in tests/test_torch_cuda.py.
"""
import sys

import numpy as np
import pytest
import torch

import mappy_rs_tpu

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.models.graphs import GraphCache
from mappy_rs_tpu_torch.ops import extend_kernel as ek
from mappy_rs_tpu_torch.ops import traceback as tb
from mappy_rs_tpu_torch.ops.extend import ExtendParams
from mappy_rs_tpu_torch.utils.metrics import EngineMetrics
from mappy_rs_tpu_torch.utils.simulate import (inversion_case, random_genome,
                                               simulate, zdrop_case)

from torch_parity import (aligner_pair, drain, fields, rare_counters,
                          same_mappings, stand_in)

# one intra-op thread per test process (the suite runs several workers)
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the host post-chain needs the native "
    "library")

EXT = ExtendParams(a=2, b=4, q=4, e=2, q2=24, e2=1, sc_ambi=1)


def with_ext_graphs(al):
    eng = al._engine
    eng._ext_graphs = GraphCache(eng.metrics, "ext_graph", capture=stand_in)
    return eng


def engine_map(al, reads):
    return [[fields(m) for m in al._to_mappings(r)]
            for r in al._engine.map_batch(reads, cs=True, md=True)]


def graph_vs_eager(al, reads, run=engine_map):
    """(graph run, eager run, the graph run's metrics): the graphs'
    keys are captured by the first of two graph runs."""
    eng = with_ext_graphs(al)
    run(al, reads)
    eng.metrics.reset()
    got = run(al, reads)
    m = eng.metrics.snapshot()
    graphs, eng._ext_graphs = eng._ext_graphs, None
    want = run(al, reads)
    eng._ext_graphs = graphs
    return got, want, m


def check_replays(m, eng, captures: int = 0):
    """Every job group of the run one replay; `captures` new keys."""
    assert m["ext_groups"] > 0
    assert m["ext_graph_replays"] == m["ext_groups"]
    assert m.get("ext_graph_captures", 0) == captures
    assert all(s["replays"] > 0 for s in eng._ext_graphs.stats())


@pytest.fixture(scope="module")
def genome_reads():
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 1_000_000)
    reads, starts = simulate(rng, genome, 8, 1000, 0.05)
    return genome, reads, starts


@pytest.mark.parametrize("backend", ["device", "device_dl"])
def test_ext_graphs_match_eager_and_jax(genome_reads, backend):
    """The main path's job groups: graph == eager == the JAX package
    (its default host extension gives the device backends' Mappings on
    these reads), cs and MD included."""
    genome, reads, starts = genome_reads
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    al._engine.cfg.extension_backend = backend
    got, want, m = graph_vs_eager(al, reads)
    assert got == want
    check_replays(m, al._engine)
    jal = mappy_rs_tpu.Aligner(seq=genome)
    assert got == [[fields(x) for x in jal.map(r, cs=True, MD=True)]
                   for r in reads]
    for ms, s in zip(got, starts):
        assert ms and abs(ms[0][5] - s) < 100
    rows = al._engine._ext_graphs.stats()
    want_l = {"extend_dp": 1, "traceback": 1} if backend == "device" \
        else {"extend_dp": 1}
    assert rows and all(r["launches"] == want_l for r in rows)


def _map_reads(al, reads):
    return [[fields(m) for m in al.map(r, cs=True, MD=True)] for r in reads]


@pytest.mark.parametrize("backend", ["device", "device_dl"])
@pytest.mark.parametrize("case", ["zdrop", "inversion"])
def test_ext_graphs_on_rare_paths(case, backend):
    """The split rounds and the inversion rescue reach K3 / K4 through
    the same wrappers, so they ride the same graphs: graph == eager ==
    the JAX package (same backend), the rare-path counters too."""
    if case == "zdrop":
        genome, reads = zdrop_case("patch")
    else:
        genome, read = inversion_case("inversion")
        reads = [read]
    tal, jal = aligner_pair(seq=genome, backend=backend)
    eng = with_ext_graphs(tal)
    got = same_mappings(tal, jal, reads)
    c = rare_counters(tal)
    m = eng.metrics.snapshot()
    assert m["ext_graph_replays"] == m["ext_groups"] > 0
    graphs, eng._ext_graphs = eng._ext_graphs, None
    eng.metrics.reset()
    assert _map_reads(tal, reads) == got
    assert rare_counters(tal) == c
    if case == "inversion" and backend == "device":
        assert c["zdrop_splits"] == 1 and c["inv_rescues"] == 1
    eng._ext_graphs = graphs


def test_ext_graphs_threads(genome_reads):
    """4 threads replaying shared group graphs, the interpreter switching
    often: every read as the eager engine maps it, every group a
    replay."""
    genome, _, _ = genome_reads
    # 400 bp reads: the plain K3 / K4 take time by the diagonals
    reads, _ = simulate(np.random.default_rng(9), genome, 32, 400, 0.05)
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    al._config.device_batch_size = 8
    al._engine.cfg.extension_backend = "device"
    al.enable_threading(4)
    try:
        want = drain(al, payload)
        eng = with_ext_graphs(al)
        eng.metrics.reset()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            got = drain(al, payload)
        finally:
            sys.setswitchinterval(old)
    finally:
        al.enable_threading(0)
    assert got == want
    m = eng.metrics.snapshot()
    assert m["ext_graph_replays"] == m["ext_groups"] > 0
    assert m["ext_graph_captures"] == len(eng._ext_graphs.stats())


def _jobs(seed: int, J: int, QMAX: int, TMAX: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (J, QMAX)).astype(np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = rng.integers(QMAX // 2, QMAX + 1, J).astype(np.int32)
    tl = np.minimum(ql + rng.integers(0, 24, J), TMAX).astype(np.int32)
    for j in range(J):
        t[j, :tl[j]] = np.resize(q[j, :ql[j]], tl[j])
        t[j, rng.integers(0, tl[j], 3)] = rng.integers(0, 4, 3)
    mode = (np.arange(J) % 2).astype(np.int32)
    return q, t, ql, tl, mode


#: the device backend's static fields (J, QMAX, TMAX, W, OPS, end_bonus,
#: params); "device_dl" has no OPS or end_bonus
BASE = dict(J=8, QMAX=64, TMAX=96, W=32, OPS=128, end_bonus=10, params=EXT)
OTHER = dict(J=16, QMAX=128, TMAX=128, W=64, OPS=64, end_bonus=5,
             params=EXT._replace(q2=20))


def _call(graphs, dl: bool, J, QMAX, TMAX, W, OPS, end_bonus, params,
          seed: int = 1):
    q, t, ql, tl, mode = _jobs(seed, J, QMAX, TMAX)
    if dl:
        return ek.extend_dp_device(q, t, ql, tl, W, params, device="cpu",
                                   graphs=graphs)
    return ek.extend_traceback_device(q, t, ql, tl, mode, W, params,
                                      end_bonus, OPS, device="cpu",
                                      graphs=graphs)


@pytest.mark.parametrize("dl,field", [
    *((False, f) for f in BASE), *((True, f) for f in
                                   ("J", "QMAX", "TMAX", "W", "params"))])
def test_ext_key_per_static_field(dl, field):
    """A call that differs in one static field captures a graph of its
    own; the same fields on other jobs replay the first graph, and each
    equals the eager call on its jobs."""
    graphs = GraphCache(EngineMetrics(), "ext_graph", capture=stand_in)
    first = _call(graphs, dl, **BASE)
    again = _call(graphs, dl, **BASE, seed=2)
    assert len(graphs.stats()) == 1
    other = _call(graphs, dl, **{**BASE, field: OTHER[field]})
    assert len(graphs.stats()) == 2
    for res, kw, seed in ((first, BASE, 1), (again, BASE, 2),
                          (other, {**BASE, field: OTHER[field]}, 1)):
        want = _call(None, dl, **kw, seed=seed)
        assert set(res) == set(want)
        for k in want:
            np.testing.assert_array_equal(res[k], want[k], err_msg=k)
    assert not np.array_equal(first["dirs" if dl else "ops"],
                              again["dirs" if dl else "ops"])


@pytest.mark.parametrize("dl", [False, True])
def test_ext_replays_credit_launches_and_shapes(dl):
    """Each replay credits K3 (and its shape) and K4 with the calls its
    capture recorded; the plain versions count nothing themselves."""
    graphs = GraphCache(EngineMetrics(), "ext_graph", capture=stand_in)
    n3, n4 = ek.launches, tb.launches
    shape = (BASE["QMAX"], BASE["TMAX"], BASE["W"], BASE["J"])
    s0 = ek.shapes[shape]
    for seed in range(3):
        _call(graphs, dl, **BASE, seed=seed)
    assert ek.launches - n3 == 3 and ek.shapes[shape] - s0 == 3
    assert tb.launches - n4 == (0 if dl else 3)
    (row,) = graphs.stats()
    assert row["replays"] == 3
    assert row["launches"] == ({"extend_dp": 1} if dl else
                               {"extend_dp": 1, "traceback": 1})
    assert graphs.metrics.counters["ext_graph_captures"] == 1
    assert graphs.metrics.counters["ext_graph_replays"] == 3
    # the eager call credits nothing on the CPU
    _call(None, dl, **BASE)
    assert ek.launches - n3 == 3
