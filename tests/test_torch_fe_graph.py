"""The front end's graph cache (models/graphs.py) on the CPU.

On the card every single-device front-end batch is one replay of a CUDA
graph captured once per batch key.  The cache takes its capture
function as an argument; here it is given tests/torch_parity.py
``stand_in``, which runs the front end once into static outputs and
whose replay re-runs it on the static inputs and writes the results
into those same outputs: a real graph's aliasing (a replay overwrites
the last replay's outputs), on the plain versions.  Every Mapping must equal the eager engine's (and,
for map-ont, the JAX package's), on every branch the graphs take: the
presets (map-pb's HPC inputs, splice's K1 branch), the anchor-budget
retries at A x 4 and x 16, the host backtrack, batches of one key in
flight together, and threads.  The card's own cases are in
tests/test_torch_cuda.py.
"""
import sys

import numpy as np
import pytest
import torch

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.models.graphs import GraphCache
from mappy_rs_tpu_torch.ops import backtrack as bt
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import (random_genome, simulate,
                                               simulate_hpc_noise,
                                               spliced_genes)

from torch_parity import aligner_pair, drain, fields, same_mappings, stand_in

# one intra-op thread per test process (the suite runs several workers)
torch.set_num_threads(1)


def with_graphs(al):
    eng = al._engine
    eng._fe_graphs = GraphCache(eng.metrics, capture=stand_in)
    return eng


def engine_map(al, reads):
    return [[fields(m) for m in al._to_mappings(r)]
            for r in al._engine.map_batch(reads, cs=True, md=True)]


def graph_vs_eager(al, reads):
    """(graph Mappings, eager Mappings, the graph run's metrics)."""
    eng = with_graphs(al)
    eng.metrics.reset()
    got = engine_map(al, reads)
    m = eng.metrics.snapshot()
    graphs = eng._fe_graphs
    eng._fe_graphs = None
    want = engine_map(al, reads)
    eng._fe_graphs = graphs
    return got, want, m


def check_counters(m, eng):
    """Every batch a replay; one capture per key."""
    assert m["fe_batches"] > 0
    assert m["fe_graph_replays"] == m["fe_batches"]
    assert m["fe_graph_captures"] == len(eng._fe_graphs.stats())


def _preset_data(preset):
    rng = np.random.default_rng(61)
    genome = random_genome(rng, 400_000)
    if preset == "splice":
        genome, reads, _ = spliced_genes(rng, genome, 6, 0.01)
    elif preset == "map-pb":
        reads, _ = simulate_hpc_noise(rng, genome, 6, 2000, 0.02)
    else:
        reads, _ = simulate(rng, genome, 8, 150 if preset == "sr" else 1000,
                            0.02)
    return genome, reads


@pytest.mark.parametrize("preset", ["map-ont", "sr", "map-pb", "splice"])
def test_graph_matches_eager(preset):
    genome, reads = _preset_data(preset)
    al = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset, device="cpu")
    got, want, m = graph_vs_eager(al, reads)
    assert got == want
    assert sum(1 for ms in got if ms) >= len(reads) - 1
    check_counters(m, al._engine)
    if preset == "map-pb":  # the HPC inputs are static inputs too
        (g,) = al._engine._fe_graphs._graphs.values()
        assert {"sk_lens", "force_inf", "pos_map", "spans"} <= set(g.inputs)


def test_graph_matches_jax():
    """The slice as a whole: the graph path's Mappings == the JAX
    package's on the same seeded reads."""
    genome, reads = _preset_data("map-ont")
    al, jal = aligner_pair(seq=genome)
    with_graphs(al)
    same_mappings(al, jal, reads)
    assert al.metrics["fe_graph_replays"] == len(reads)


@pytest.fixture(scope="module")
def overflow_data():
    """Reads of unique sequence, a chimera, and a read of a segment
    repeated 40 times: it overflows A = 256 and 1,024 and is retried at
    4,096."""
    rng = np.random.default_rng(31)
    seg = random_genome(rng, 600)
    g = random_genome(rng, 100_000) + seg * 40 + random_genome(rng, 100_000)
    reads, _ = simulate(rng, g[:100_000], 12, 1000, 0.05)
    reads.append(g[5000:5600] + random_genome(rng, 400) + g[6000:6600])
    reads.append(seg)
    return g, reads


@pytest.mark.parametrize("backtrack", ["auto", "off"])
def test_retry_ladder_and_host_backtrack(overflow_data, backtrack):
    g, reads = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al._config.device_batch_size = 32
    al._engine.cfg.device_backtrack = backtrack
    got, want, m = graph_vs_eager(al, reads)
    assert got == want
    check_counters(m, al._engine)
    assert m["anchor_overflow_retries"] >= 2
    # the 1 kb bucket at A = 256 and its retries at x 4 and x 16 (the
    # chimera's 2,048 bucket at A = 512), each captured once
    As = sorted((s["L"], s["A"]) for s in al._engine._fe_graphs.stats())
    assert As == [(1024, 256), (1024, 1024), (1024, 4096), (2048, 512)]
    if backtrack == "off":
        assert m["host_bt_batches"] == m["fe_batches"]
        assert all(not s["use_bt"] for s in al._engine._fe_graphs.stats())
    else:
        assert m.get("host_bt_batches", 0) == 0


@pytest.mark.parametrize("use_bt", [True, False])
def test_batches_in_flight_keep_their_outputs(overflow_data, use_bt):
    """Two batches of one key submitted before either is collected: the
    second replay overwrites the static outputs, and each collect must
    still give its own batch's chains (== the eager engine's)."""
    g, reads = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    eng = al._engine
    codes = [encode(r) for r in reads[:12]]
    L = 1024
    B, M, A = eng.fe_shapes(L)
    B = 8

    def both():
        t1 = eng._fe_submit_batch(codes[:6], L, B, M, A, use_bt, 2)[1]
        t2 = eng._fe_submit_batch(codes[6:12], L, B, M, A, use_bt, 2)[1]
        return [eng._fe_collect(t) for t in (t1, t2)]

    eager = both()
    with_graphs(al)
    got = both()
    assert eng.metrics.counters["fe_graph_captures"] == 1
    assert eng.metrics.counters["fe_graph_replays"] == 2
    for g_, w in zip(got, eager):
        for a, b in zip(g_, w):
            np.testing.assert_array_equal(a, b)
    # the two batches' chains differ, so a shared output would show
    assert not np.array_equal(got[0][0][:6], got[1][0][:6])


@pytest.mark.parametrize("use_bt", [True, False])
def test_replays_credit_launches(overflow_data, use_bt):
    """Each replay adds the K1 / K2 calls its capture recorded to the
    kernels' launch counts (the plain versions count none themselves)."""
    g, reads = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    eng = with_graphs(al)
    codes = [encode(r) for r in reads[:8]]
    B, M, A = eng.fe_shapes(1024)
    n1, n2 = ck.launches, bt.launches
    for _ in range(3):
        eng._fe_collect(eng._fe_submit_batch(codes, 1024, 8, M, A, use_bt,
                                             2)[1])
    (row,) = eng._fe_graphs.stats()
    want = {"chain_dp": 1, "backtrack_chains": 1} if use_bt else \
        {"chain_dp": 1}
    assert row["launches"] == want and row["replays"] == 3
    assert ck.launches - n1 == 3
    assert bt.launches - n2 == (3 if use_bt else 0)
    eng.probe_front_end(2)  # probe replays launch too
    assert ck.launches - n1 == 3 + 4


def test_probe_replays_the_graph(overflow_data):
    g, reads = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    eng = with_graphs(al)
    eng.map_batch(reads[:4])
    (graph,) = eng._fe_graphs._graphs.values()
    assert eng._probe_dispatch == graph.probe
    assert eng._probe_eager is graph.fn
    assert len(eng.probe_front_end(2)) == 2


KEY_FIELDS = ["B", "L", "M", "A", "use_bt", "bt_cuts", "mid_occ", "window",
              "chain_params", "dev_index", "device", "hpc"]


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_key_differs_by_each_static_field(overflow_data, field):
    g, _ = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    eng = al._engine
    dev0 = eng.dev

    def key(B=256, L=1024, M=204, A=256, use_bt=True, bt_cuts=2, kw=None,
            dev=dev0):
        kw = kw or eng._fe_kwargs(M, A, bt_cuts)
        return eng._fe_key((B, L, M, A), use_bt, bt_cuts, kw, dev)

    base = key()
    assert key() == base  # a fresh kwargs dict of the same values hits
    kw = eng._fe_kwargs(204, 256, 2)
    if field in ("B", "L", "M", "A", "bt_cuts"):
        other = key(**{field: {"B": 8, "L": 2048, "M": 409, "A": 1024,
                               "bt_cuts": 1}[field]})
    elif field == "use_bt":
        other = key(use_bt=False)
    elif field in ("mid_occ", "window"):
        other = key(kw={**kw, field: kw[field] + 1})
    elif field == "chain_params":
        other = key(kw={**kw, field: kw[field]._replace(bw=kw[field].bw + 1)})
    elif field == "dev_index":
        eng.index._devices.clear()  # the tables re-uploaded
        other = key(dev=eng.dev)
    elif field == "device":
        eng.device = torch.device("cuda")
        other = key()
    else:
        eng.index.flag |= 0x1
        other = key()
    assert other != base


def test_rebuilt_index_drops_old_graphs(overflow_data):
    g, reads = overflow_data
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    eng = with_graphs(al)
    eng.map_batch(reads[:4])
    (old,) = eng._fe_graphs._graphs.values()
    eng.index._devices.clear()
    eng.map_batch(reads[:4])
    (new,) = eng._fe_graphs._graphs.values()
    assert new is not old and new.owner is eng.dev
    assert old.owner is not eng.dev


def test_threads_share_graphs(overflow_data):
    """4 threads, batches of 8 reads of one key replayed under its lock,
    with the interpreter switching threads often: every read as the
    eager engine maps it, every batch a replay."""
    g, reads = overflow_data
    rng = np.random.default_rng(5)
    more, _ = simulate(rng, g[:100_000], 36, 1000, 0.05)
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads[:12] + more)]
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al._config.device_batch_size = 8
    al.enable_threading(4)
    try:
        want = drain(al, payload)
        eng = with_graphs(al)
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
    check_counters(eng.metrics.snapshot(), eng)
