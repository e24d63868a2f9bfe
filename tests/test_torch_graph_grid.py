"""The device grid's rows and the decision step as CUDA graphs, on the CPU.

On the card each grid row whose cells sit on one device runs its front
end as one replay of the graph of its key (models/pipeline.py
``_fe_grid_batch``: ``make_dp_front_end`` rows of one device share a
graph, a ``make_sharded_front_end`` row has its own), and each row of
the decision step (parallel/mesh.py ``build_sharded_map_step``) runs a
batch as one replay per (row, B_row, L, static keywords, shards), the
counterparts of the JAX package's jitted ``shard_map`` wrappers.  Here
the caches are given tests/torch_parity.py ``stand_in`` (a replay
re-runs the captured ops into the same static outputs).  Every case
holds the graph run against the eager run and the JAX package (on
conftest.py's 8 virtual CPU devices): ``enable_mesh`` at (8, 1) and
(4, 2) with threads, the decision step at (4, 2) and (8, 1) with its
length-0 row and the reads another peer owns, ``map_batch_positions``
over readfish micro-batches of varying size (one capture per row and
B_pad), batches of one key from several threads, one key per static
field, K3's replay credits, and rows spanning two devices ("cpu" and
"cpu:0" are two devices of a grid), which stay eager.  The decision
cache's byte budget is held with a stand-in that reports 1 MB of pool
per read of a row: the least recently used keys leave, and a stream of
every batch size stays within the budget.
"""
import threading

import numpy as np
import pytest
import torch

import mappy_rs_tpu
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.extend import ExtendParams as JaxExtendParams
from mappy_rs_tpu.parallel import mesh as jmesh
from mappy_rs_tpu.parallel import multihost as jmh

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.models.graphs import GraphCache
from mappy_rs_tpu_torch.ops import chain_kernel as ck
from mappy_rs_tpu_torch.ops import extend_kernel as ek
from mappy_rs_tpu_torch.ops.chain import ChainParams
from mappy_rs_tpu_torch.ops.extend import ExtendParams
from mappy_rs_tpu_torch.parallel import mesh as tmesh
from mappy_rs_tpu_torch.parallel import multihost as tmh
from mappy_rs_tpu_torch.utils.metrics import EngineMetrics
from mappy_rs_tpu_torch.utils.simulate import simulate

from mappy_rs_tpu_torch.models.graphs import Captured
from torch_parity import drain, fields, read_batch, stand_in, write_genome

# one intra-op thread per test process (the suite runs several workers)
torch.set_num_threads(1)

_RC = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s[::-1].translate(_RC)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A seeded 4-contig FASTA, its contigs, 16 reads of 1 kb at 5%
    error (plus one reverse complement), and the port's single-device
    Mappings of those reads (cs)."""
    fa = str(tmp_path_factory.mktemp("grid") / "g.fa")
    ctgs = write_genome(fa, 17)
    rng = np.random.default_rng(4)
    reads = []
    for c in ctgs:
        reads += simulate(rng, c, 4, 1000, 0.05)[0]
    reads.append(_rc(reads[0]))
    al = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    single = [[fields(m) for m in al.map(r, cs=True)] for r in reads]
    assert sum(1 for s in single if s) == len(reads)
    return fa, ctgs, reads, single


def _threaded(al, reads):
    al.enable_threading(2)
    try:
        out = drain(al, [{"i": i, "seq": s} for i, s in enumerate(reads)])
    finally:
        al.enable_threading(0)
    return [out[i] for i in range(len(reads))]


def _grid_aligner(fa, n_data, n_index, devices=None):
    al = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    al.enable_mesh(n_data, n_index=n_index,
                   devices=devices or ["cpu"] * (n_data * n_index))
    eng = al._engine
    eng._fe_graphs = GraphCache(eng.metrics, capture=stand_in)
    return al, eng


# ------------------------------------------------------------ grid rows
@pytest.mark.parametrize("n_data,n_index", [(8, 1), (4, 2)])
def test_grid_graphs_match_eager_and_jax(genome, n_data, n_index):
    """enable_mesh through 2 threads: the rows' graphs == the rows' eager
    ops == the single device == the JAX package's enable_mesh; every row
    of every batch one replay; dp rows of one device share a key, a
    sharded row has its own."""
    fa, _ctgs, reads, single = genome
    al, eng = _grid_aligner(fa, n_data, n_index)
    assert eng.mesh.graph_rows(eng._fe_graphs) == frozenset(range(n_data))
    got = _threaded(al, reads)
    m = eng.metrics.snapshot()
    assert got == single
    assert m["fe_graph_replays"] == m["fe_batches"] * n_data > 0
    rows = {s["grid"][2] for s in eng._fe_graphs.stats()}
    assert rows == ({-1} if n_index == 1 else set(range(n_data)))
    graphs, eng._fe_graphs = eng._fe_graphs, None
    assert _threaded(al, reads) == got
    eng._fe_graphs = graphs
    if n_index > 1:
        assert eng.index._devices == {}

    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal._engine.cfg.front_end_backend = "device"
    jal.enable_mesh(n_data, n_index=n_index)
    assert [[fields(m) for m in jal.map(r, cs=True)] for r in reads] == got


@pytest.mark.parametrize("n_index", [1, 2])
def test_grid_probe_replays_rows_and_credits(genome, n_index):
    """probe_front_end replays each row's graph; every replay credits K1
    with the launches its capture recorded."""
    fa, _ctgs, reads, single = genome
    al, eng = _grid_aligner(fa, 2, n_index)
    assert [[fields(m) for m in al.map(r, cs=True)] for r in reads[:2]] \
        == single[:2]
    n1 = ck.launches
    probes = eng.probe_front_end(2)
    assert len(probes) == 2
    # a warm-up, two pipelined and one blocking dispatch of both rows
    assert ck.launches - n1 == 4 * 2
    assert eng._probe_eager is not eng._probe_dispatch


def test_rows_spanning_devices_stay_eager(genome):
    """A row whose cells sit on two devices ("cpu", "cpu:0") runs its ops
    eagerly, chosen by the layout at enable_mesh; a row of one device
    in the same grid replays its graph.  Both map as the single device."""
    fa, _ctgs, reads, single = genome
    al, eng = _grid_aligner(fa, 2, 2, ["cpu", "cpu", "cpu", "cpu:0"])
    assert eng.mesh.graph_rows(eng._fe_graphs) == frozenset({0})
    got = [[fields(m) for m in al.map(r, cs=True)] for r in reads[:6]]
    assert got == single[:6]
    m = eng.metrics.snapshot()
    assert m["fe_graph_replays"] == m["fe_batches"] > 0
    assert {s["grid"] for s in eng._fe_graphs.stats()} == {(2, 2, 0)}
    al2, eng2 = _grid_aligner(fa, 2, 2, ["cpu", "cpu:0"] * 2)
    assert eng2.mesh.graph_rows(eng2._fe_graphs) == frozenset()
    assert [[fields(m) for m in al2.map(r, cs=True)] for r in reads[:2]] \
        == single[:2]
    assert eng2.metrics.snapshot().get("fe_graph_replays", 0) == 0


def test_grid_key_fields(genome):
    """The grid's shape and a sharded row are part of the front end's
    key; dp rows of one device share one."""
    fa = genome[0]
    al = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    eng = al._engine
    kw = eng._fe_kwargs(204, 256, 2)
    dev = torch.device("cpu")

    def key(grid):
        return eng._fe_key((256, 1024, 204, 256), True, 2, kw, eng.dev, dev,
                           grid)

    keys = [key(()), key((2, 1, -1)), key((4, 1, -1)), key((2, 2, 0)),
            key((2, 2, 1))]
    assert len(set(keys)) == len(keys)
    assert key((2, 1, -1)) == key((2, 1, -1))


# -------------------------------------------------------- decision step
def _chain_params(opt, k: int):
    return (opt.max_gap_ref if opt.max_gap_ref >= 0 else opt.max_gap,
            opt.max_gap, opt.bw, k, opt.chain_gap_scale * 0.01 * k,
            opt.chain_skip_scale * 0.01 * k)


def _decision_reads(rng, ctgs, n: int):
    """Exact 350-450 bp contig slices, every third reverse-complemented,
    then one junk read."""
    reads = []
    for i in range(n):
        c = ctgs[i % len(ctgs)]
        ln = int(rng.integers(350, 450))
        s = int(rng.integers(0, len(c) - ln))
        r = c[s:s + ln]
        reads.append(_rc(r) if i % 3 == 0 else r)
    return reads + ["ACGT" * 30]


def _port_step(tal, mesh, graphs, **over):
    opt, ti = tal._map_opt, tal._index
    ep = (opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2, opt.sc_ambi)
    kw = dict(max_minimizers=64, max_anchors=128,
              chain_params=ChainParams(*_chain_params(opt, ti.k)),
              ext_params=ExtendParams(*ep), mid_occ=opt.mid_occ,
              chain_window=32, ext_window=128)
    kw.update(over)
    return tmesh.build_sharded_map_step(mesh, ti.k, ti.w, graphs=graphs, **kw)


def _place_shards(tal, mesh):
    return tmh.put_global_tree(
        tmesh.device_shards(tmesh.shard_index_by_key_range(
            tal._index, mesh.shape["index"])),
        mesh, tmh.shard_specs_for_index())


def _run_step(step, mesh, shards, codes, lens):
    return tmh.gather_results(step(
        tmh.put_global(codes, mesh, tmesh.P("data", None)),
        tmh.put_global(lens, mesh, tmesh.P("data")), shards))


@pytest.fixture(scope="module")
def dec_aligner(genome):
    fa = genome[0]
    return mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")


@pytest.mark.parametrize("n_data,n_index", [(4, 2), (8, 1)])
def test_decision_graphs_match_eager_and_jax(genome, dec_aligner, n_data,
                                             n_index):
    """build_sharded_map_step through its graphs == eagerly == the JAX
    package's, all six fields, on exact contig slices, a junk read and a
    padding row of length 0; at (4, 2) each peer owns some reads.  Each
    row of each batch is one replay, crediting K3 once per peer."""
    _fa, ctgs, _reads, _single = genome
    tal = dec_aligner
    opt, ti = tal._map_opt, tal._index
    reads = _decision_reads(np.random.default_rng(n_data), ctgs, 14)
    codes, lens = read_batch(reads, 16, 512)
    assert lens[15] == 0

    mesh = tmesh.make_mesh(n_data, n_index, ["cpu"] * (n_data * n_index))
    shards = _place_shards(tal, mesh)
    graphs = GraphCache(EngineMetrics(), "dec_graph", capture=stand_in)
    step = _port_step(tal, mesh, graphs)
    assert step.graphs is graphs
    first = _run_step(step, mesh, shards, codes, lens)
    n3 = ek.launches
    got = _run_step(step, mesh, shards, codes, lens)
    assert ek.launches - n3 == n_data * n_index
    c = graphs.metrics.counters
    assert c["dec_graph_captures"] == n_data and c["dec_graph_replays"] == \
        2 * n_data
    eager = _run_step(_port_step(tal, mesh, None), mesh, shards, codes, lens)

    jm = jmesh.make_mesh(n_data, n_index)
    cp = _chain_params(opt, ti.k)
    ep = (opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2, opt.sc_ambi)
    jal = mappy_rs_tpu.Aligner(_fa, preset="map-ont")
    jstep = jmesh.build_sharded_map_step(
        jm, ti.k, ti.w, 64, 128, JaxChainParams(*cp), JaxExtendParams(*ep),
        opt.mid_occ, 32, 128)
    want = jmh.gather_results(jstep(
        jmh.put_global(codes, jm, jmh.P("data", None)),
        jmh.put_global(lens, jm, jmh.P("data")),
        jmh.put_global_tree(jmesh.shard_index_by_key_range(jal._index,
                                                           n_index),
                            jm, jmh.shard_specs_for_index())))
    for name in tmesh.DECISION_FIELDS:
        for res in (first, eager):
            np.testing.assert_array_equal(got[name], res[name], err_msg=name)
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
    assert (got["chain_score"][:14] > 200).all()
    assert got["rev"][14] == 2 and got["ext_score"][15] < 0
    if n_index > 1:
        sh = tmesh.shard_index_by_key_range(ti, n_index)
        owners = set(sh["rid2shard"][got["rid"][:14]].tolist())
        assert owners == {0, 1}


def test_readfish_microbatch_graphs(genome):
    """map_batch_positions over readfish micro-batches of 1-8 reads: the
    graphs' decisions == the eager step's == the JAX package's; one
    capture per row and B_pad, one replay per row and batch."""
    fa, ctgs, _reads, _single = genome
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    tal.enable_sharding(n_data=4, n_index=2, devices=["cpu"] * 8)
    # no card: a CUDA graph captures on none of the CPU cells
    assert tal._mesh.graph_rows(tal._dec_graphs) == frozenset()
    metrics = tal._engine.metrics
    tal._dec_graphs = GraphCache(metrics, "dec_graph", capture=stand_in)
    ref = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    ref.enable_sharding(n_data=4, n_index=2, devices=["cpu"] * 8)
    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal.enable_sharding(n_data=4, n_index=2)
    rng = np.random.default_rng(3)
    sizes = (1, 3, 8, 2)
    for batch_size in sizes:
        chunk = []
        for _ in range(batch_size):
            ci = int(rng.integers(len(ctgs)))
            st = int(rng.integers(0, len(ctgs[ci]) - 2000))
            s = ctgs[ci][st:st + int(rng.integers(350, 450))]
            chunk.append(_rc(s) if rng.random() < 0.5 else s)
        res = tal.map_batch_positions(chunk)
        assert res == ref.map_batch_positions(chunk)
        assert res == jal.map_batch_positions(chunk)
        assert all(r is not None for r in res)
    c = metrics.counters
    # B_pad 4 (B_row 1) and 8 (B_row 2), per row
    assert c["dec_graph_captures"] == 4 * 2
    assert c["dec_graph_replays"] == 4 * len(sizes)
    assert sorted({(s["row"], s["B"]) for s in tal._dec_graphs.stats()}) \
        == [(r, b) for r in range(4) for b in (1, 2)]


def test_decision_threads_share_graphs(genome, dec_aligner):
    """3 threads each running the step on its own batch of one key: each
    gets its own batch's decisions (== the eager step's)."""
    _fa, ctgs, _reads, _single = genome
    tal = dec_aligner
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    shards = _place_shards(tal, mesh)
    graphs = GraphCache(EngineMetrics(), "dec_graph", capture=stand_in)
    step = _port_step(tal, mesh, graphs)
    eager = _port_step(tal, mesh, None)
    batches = [read_batch(_decision_reads(np.random.default_rng(20 + i),
                                          ctgs, 7), 8, 512)
               for i in range(3)]
    want = [_run_step(eager, mesh, shards, *b) for b in batches]
    got, errs = [None] * 3, []

    def work(i):
        try:
            got[i] = _run_step(step, mesh, shards, *batches[i])
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)

    ths = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    assert not errs and not any(th.is_alive() for th in ths)
    for g, w in zip(got, want):
        for name in tmesh.DECISION_FIELDS:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert graphs.metrics.counters["dec_graph_captures"] == 2
    assert graphs.metrics.counters["dec_graph_replays"] == 3 * 2


DEC_FIELDS = {"B": None, "L": None, "shards": None,
              "max_minimizers": 80, "max_anchors": 256, "mid_occ": 50,
              "chain_window": 16, "ext_window": 64,
              "chain_params": "bw", "ext_params": "q2"}


@pytest.mark.parametrize("field", list(DEC_FIELDS))
def test_decision_key_per_static_field(genome, dec_aligner, field):
    """A step that differs in one static field (the row's batch, L, a
    keyword, the placed shards) captures graphs of its own; re-placed
    shards drop the old ones."""
    _fa, ctgs, _reads, _single = genome
    tal = dec_aligner
    mesh = tmesh.make_mesh(1, 1, ["cpu"])
    shards = _place_shards(tal, mesh)
    graphs = GraphCache(EngineMetrics(), "dec_graph", capture=stand_in)
    reads = _decision_reads(np.random.default_rng(5), ctgs, 5)
    codes, lens = read_batch(reads, 8, 512)
    _run_step(_port_step(tal, mesh, graphs), mesh, shards, codes, lens)
    assert len(graphs.stats()) == 1
    over = {}
    if field == "B":
        codes, lens = read_batch(reads, 4, 512)
    elif field == "L":
        codes, lens = read_batch(reads, 8, 1024)
    elif field == "shards":
        shards = _place_shards(tal, mesh)
    elif field == "chain_params":
        cp = ChainParams(*_chain_params(tal._map_opt, tal._index.k))
        over = {field: cp._replace(bw=cp.bw + 1)}
    elif field == "ext_params":
        o = tal._map_opt
        ep = ExtendParams(o.a, o.b, o.q, o.e, o.q2, o.e2, o.sc_ambi)
        over = {field: ep._replace(q2=ep.q2 + 1)}
    else:
        over = {field: DEC_FIELDS[field]}
    got = _run_step(_port_step(tal, mesh, graphs, **over), mesh, shards,
                    codes, lens)
    assert len(graphs.stats()) == (1 if field == "shards" else 2)
    want = _run_step(_port_step(tal, mesh, None, **over), mesh, shards,
                     codes, lens)
    for name in tmesh.DECISION_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ------------------------------------------------ which rows, the budget
def test_graph_rows_by_layout_and_capture():
    """graph_rows: rows whose cells sit on one device the cache captures
    on; a CUDA graph captures on no CPU cell, the stand-in on any."""
    mesh = tmesh.make_mesh(3, 2, ["cpu", "cpu", "cpu", "cpu:0", "cpu:0",
                                  "cpu:0"])
    assert mesh.graph_rows(None) == frozenset()
    assert mesh.graph_rows(GraphCache(EngineMetrics())) == frozenset()
    assert mesh.graph_rows(GraphCache(EngineMetrics(), capture=stand_in)) \
        == frozenset({0, 2})
    mesh.local_rows = range(1, 3)
    assert mesh.graph_rows(GraphCache(EngineMetrics(), capture=stand_in)) \
        == frozenset({2})


def sized(fn, device):
    """stand_in, reporting 1 MB of pool per element of the first output
    (a decision row: 1 MB per read)."""
    c = stand_in(fn, device)
    return Captured(c.graph, c.outputs, c.outputs[0].numel() * 2**20,
                    c.launches)


def _doubler(cache, n: int):
    x = torch.arange(n, dtype=torch.int32)

    def make_fn(inputs):
        return lambda: (inputs["x"] * 2,)

    g = cache.get(("double", n), {"n": n}, torch.device("cpu"), None,
                  {"x": x}, make_fn)
    return cache.run(g, {"x": x}, torch.device("cpu"),
                     lambda y: y.clone())


def test_cache_budget_evicts_least_recent():
    """Past the budget, the least recently used captured keys leave the
    cache, never the key just captured; a key that comes back captures
    again and gives the same result."""
    cache = GraphCache(EngineMetrics(), "dec_graph", capture=sized,
                       budget_mb=5)
    for n in (1, 2):
        _doubler(cache, n)
    _doubler(cache, 1)  # 2 is now the least recent
    assert torch.equal(_doubler(cache, 3), 2 * torch.arange(3))
    c = cache.metrics.counters
    assert sorted(s["n"] for s in cache.stats()) == [1, 3]
    assert c["dec_graph_evictions"] == 1 and cache.pool_mb() == 4
    _doubler(cache, 8)  # over the budget alone: it stays, the rest go
    assert [s["n"] for s in cache.stats()] == [8]
    assert c["dec_graph_evictions"] == 3 and cache.pool_mb() == 8
    assert torch.equal(_doubler(cache, 2), 2 * torch.arange(2))
    assert c["dec_graph_captures"] == 5 and c["dec_graph_replays"] == 6
    assert [s["n"] for s in cache.stats()] == [2]
    unbounded = GraphCache(EngineMetrics(), "dec_graph", capture=sized)
    for n in range(1, 9):
        _doubler(unbounded, n)
    assert unbounded.pool_mb() == 36
    assert unbounded.metrics.counters.get("dec_graph_evictions", 0) == 0


def test_decision_stream_of_every_size_within_budget(genome):
    """map_batch_positions over every batch size 1-16 on a 2 x 1 grid
    and back down: one capture per row and new or evicted B_pad, the
    cached pools never over the budget by more than the key captured
    last, and every decision the eager step's (and the JAX package's)."""
    fa, ctgs, _reads, _single = genome
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    tal.enable_sharding(n_data=2, n_index=1, devices=["cpu"] * 2)
    budget = 20  # both rows' keys of the largest batch (2 x 8 MB) fit
    tal._dec_graphs = GraphCache(tal._engine.metrics, "dec_graph",
                                 capture=sized, budget_mb=budget)
    ref = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    ref.enable_sharding(n_data=2, n_index=1, devices=["cpu"] * 2)
    reads = _decision_reads(np.random.default_rng(9), ctgs, 16)
    want = ref.map_batch_positions(reads)
    jal = mappy_rs_tpu.Aligner(fa, preset="map-ont")
    jal.enable_sharding(n_data=2, n_index=1)
    assert jal.map_batch_positions(reads) == want
    sizes = list(range(1, 17)) + [2, 1]
    for n in sizes:
        assert tal.map_batch_positions(reads[:n]) == want[:n]
        last = max(s["pool_mb"] for s in tal._dec_graphs.stats()
                   if s["B"] == (n + n % 2) // 2)
        assert tal._dec_graphs.pool_mb() <= budget + last
    c = tal._engine.metrics.counters
    # B_row 1-8 once per row, then B_row 1 again (evicted by then)
    assert c["dec_graph_captures"] == 2 * (8 + 1)
    assert c["dec_graph_evictions"] == 2 * (8 + 1) - len(
        tal._dec_graphs.stats())
    assert c["dec_graph_replays"] == 2 * len(sizes)
