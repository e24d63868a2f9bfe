"""The port's process runtime (runtime/procpool.py "classic",
runtime/devowner.py "device_owner"), its packed IPC blocks
(runtime/pack.py), the index hand-off (index/share.py), the engine's
front-end probes, and the streaming runtime's edge cases.

Mappings through worker processes must equal the threaded path's and
the JAX package's on the same seeded data, for every read class: clean
forward and reverse reads, two length buckets (the chain-row width
merge of the device-owner parent), a zdrop-split chimera (the child's
Python fallback) and an anchor-overflow repeat (the boosted retries).
The children are spawned on the CPU (device="cpu"); each test makes its
data from a seed.
"""
import gc
import os
import pickle

import numpy as np
import pytest
import torch

import mappy_rs_tpu

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.api import regions_to_mappings
from mappy_rs_tpu_torch.index.share import load_index_dir, save_index_dir
from mappy_rs_tpu_torch.ops.cigar import pack_ops
from mappy_rs_tpu_torch.ops.regions import Region
from mappy_rs_tpu_torch.runtime.devowner import DevOwnerMapper
from mappy_rs_tpu_torch.runtime.pack import (pack_regions_block,
                                             unpack_mappings_block)
from mappy_rs_tpu_torch.runtime.procpool import ProcMapper
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

from torch_parity import drain, fields

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

TOPOLOGIES = ("device_owner", "classic")


@pytest.fixture(scope="module", autouse=True)
def one_thread_children():
    """Spawned children inherit the environment: one OpenMP thread each."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(21)
    seg = random_genome(rng, 600)
    # a 40-copy repeat in the middle: reads of it overflow the anchor budget
    return (random_genome(rng, 120_000) + seg * 40
            + random_genome(rng, 120_000)), seg


@pytest.fixture(scope="module")
def payload(genome):
    g, seg = genome
    rng = np.random.default_rng(22)
    # clean reads from the unique flanks, as the JAX package's
    # test_devowner.py draws them: inside the repeat, 40 copies score
    # alike and the copy a read's primary lands on depends on the chain
    # DP's predecessor window, which the JAX package's CPU engine sets
    # otherwise (its block DP) than the port and its TPU path (128)
    reads, _ = simulate(rng, g[:120_000], 32, 500, 0.05)  # 1,024 bucket
    long_reads, _ = simulate(rng, g[144_000:], 6, 2500, 0.05)  # 8,192
    reads += long_reads
    # zdrop-split chimera -> the Python fallback of the post-chain
    reads.append(g[2000:2600] + random_genome(rng, 500) + g[3100:3700])
    reads.append(seg)  # anchor overflow -> boosted retries
    return [{"i": i, "seq": s} for i, s in enumerate(reads)]


def _aligner(g, **cfg):
    """A port Aligner on the CPU; device batches of 32 reads keep the
    plain kernels' work small (a read's mappings do not depend on B)."""
    al = mappy_rs_tpu_torch.Aligner(seq=g, preset="map-ont", device="cpu")
    al._config.device_batch_size = 32
    for k, v in cfg.items():
        setattr(al._config, k, v)
    return al


@pytest.fixture(scope="module")
def threaded(genome, payload):
    al = _aligner(genome[0])
    al.enable_threading(2)
    try:
        out = drain(al, payload)
    finally:
        al.enable_threading(0)
    assert al.metrics.get("anchor_overflow_retries", 0) > 0
    return out


@pytest.fixture(scope="module")
def jax_ref(genome, payload):
    jal = mappy_rs_tpu.Aligner(seq=genome[0], preset="map-ont")
    jal._config.device_batch_size = 32
    regs = jal._engine.map_batch([d["seq"] for d in payload], cs=True,
                                 md=False)
    return {i: [fields(m) for m in jal._to_mappings(r)]
            for i, r in enumerate(regs)}


@pytest.fixture(scope="module")
def proc_aligners(genome):
    """One Aligner per topology, made on first use, whose
    enable_threading(4) proxies to 2 children."""
    made = {}

    def get(topology):
        if topology not in made:
            al = _aligner(genome[0], worker_processes=2, topology=topology,
                          proc_chunk=24)
            al.enable_threading(4)
            assert al._procs is not None, "worker processes failed to start"
            made[topology] = al
        return made[topology]

    yield get
    for al in made.values():
        al.enable_threading(0)
        assert al._procs is None


@pytest.fixture(params=TOPOLOGIES)
def proc_al(request, proc_aligners):
    return proc_aligners(request.param)


def test_threaded_port_matches_jax(threaded, jax_ref):
    assert threaded == jax_ref
    assert sum(1 for v in threaded.values() if v) >= len(threaded) - 1


def test_procs_identical_to_threads_and_jax(proc_al, payload, threaded,
                                            jax_ref):
    topology = proc_al._config.topology
    want = DevOwnerMapper if topology == "device_owner" else ProcMapper
    assert isinstance(proc_al._procs, want)
    proc_al.warmup([payload[0]["seq"]])
    proc_al.reset_metrics()
    got = drain(proc_al, payload)
    assert got == threaded
    assert got == jax_ref
    m = proc_al.metrics
    assert m["worker_procs"] == 2
    assert m.get("reads", 0) >= len(payload)
    assert m.get("anchor_overflow_retries", 0) > 0
    parent = proc_al._engine.metrics.snapshot()
    if topology == "device_owner":
        # the front end ran in the parent, the post-chain in the children
        assert parent.get("fe_batches", 0) > 0
        assert parent.get("reads", 0) == 0
    else:
        assert parent.get("fe_batches", 0) == 0
        assert m.get("fe_batches", 0) > 0
    # a second batch through the same pool (epoch barrier reuse)
    got2 = drain(proc_al, payload[:10])
    assert got2 == {i: threaded[i] for i in range(10)}


def test_procs_error_contract(proc_al):
    """Producer-side error texts are raised before any child work."""
    with pytest.raises(KeyError, match="AHHH Key"):
        for _ in proc_al.map_batch([{"id": 1}]):
            pass
    with pytest.raises(TypeError, match="Element in iterable is not a dictionary"):
        proc_al.map_batch(["ACGT"])


def test_procs_probe_front_end(proc_al, payload):
    # one batch through every child, so child 0 (the classic topology's
    # probe) has a last dispatch of this read's bucket
    proc_al.warmup([payload[0]["seq"]])
    got = proc_al.probe_front_end(1)
    assert len(got) == 2 and all(isinstance(t, float) and t > 0 for t in got)
    roof = proc_al.front_end_roofline()
    assert roof["L"] == 1024 and roof["window"] == 128 and roof["int_ops"] > 0


def test_unknown_topology_raises(genome):
    al = _aligner(genome[0][:20_000], worker_processes=1, topology="mesh")
    with pytest.raises(ValueError, match="topology"):
        al.enable_threading(1)
    assert al._procs is None


# ------------------------------------------- the engine's packed paths
def test_post_chain_packed_matches_map_batch_packed(genome, payload):
    """The device-owner step in one process: fe_submit / fe_collect, then
    post_chain_packed, equals map_batch_packed and the Region path."""
    al = _aligner(genome[0])
    eng = al._engine
    # short and long reads, the chimera and the overflow read
    seqs = [d["seq"] for d in payload[:4] + payload[-4:]]
    want = pack_regions_block(eng.map_batch(seqs, cs=True, md=True), False)
    assert all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
               for a, b in zip(eng.map_batch_packed(seqs, cs=True, md=True),
                               want))
    mapper = DevOwnerMapper.__new__(DevOwnerMapper)  # no children
    mapper.engine = eng
    codes = [native.encode(s) for s in seqs]
    eng.metrics.reset()
    chains, rep_len = mapper._front_end_chunk(codes)
    assert eng.metrics.snapshot().get("anchor_overflow_retries", 0) > 0
    got = eng.post_chain_packed(codes, chains, rep_len, cs=True, md=True)
    for a, b in zip(got, want):
        if isinstance(a, bytes):
            assert a == bytes(b)
        else:
            assert np.array_equal(a, b)


def test_fe_collect_slices_to_the_submitted_reads(genome, payload):
    eng = _aligner(genome[0])._engine
    codes = [native.encode(d["seq"]) for d in payload[:5]]
    chains, rep_len, n_raw = eng.fe_collect(eng.fe_submit(codes, 1024))
    B = eng.fe_shapes(1024)[0]
    assert B > 5
    assert chains.shape == (5, eng.cfg.backtrack_k, 9 + 2 * 2)
    assert rep_len.shape == n_raw.shape == (5,)
    assert (chains[:, 0, 0] >= 0).all()
    with pytest.raises(ValueError, match="batch"):
        eng.fe_submit(codes * B, 1024)


# ---------------------------------------------------- packed IPC blocks
NAMES = ["chr1", "chr2"]
LENS = np.array([1_000_000, 2_000_000], np.int64)


def _mk_region(i, *, rev=0, rid=0, primary=True, cig_list=False,
               cs=None, md=None, trans_strand=0):
    r = Region(
        rev=rev, rid=rid, qs=10 * i, qe=10 * i + 500,
        rs=1000 * i, re=1000 * i + 480, score=100 + i, cnt=20,
        anchors_qpos=np.empty(0, np.int32),
        anchors_rpos=np.empty(0, np.int32),
    )
    r.id = i
    r.parent = i if primary else 0
    r.mlen, r.blen, r.nm, r.mapq = 450 + i, 500, 17, 60 - i
    ops = [(100 + i, 0), (3, 1), (397, 0)]
    r.cigar = ops if cig_list else pack_ops(ops)
    r.cs = cs
    r.md = md
    r.trans_strand = trans_strand
    return r


def _assert_same(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        for attr in (
            "query_start", "query_end", "strand", "target_name",
            "target_len", "target_start", "target_end", "match_len",
            "block_len", "mapq", "is_primary", "NM", "MD", "cs",
            "trans_strand", "cigar", "cigar_str",
        ):
            assert getattr(ma, attr) == getattr(mb, attr), attr


def test_pack_roundtrip_matches_regions_to_mappings():
    regs_lists = [
        [
            _mk_region(0, cs=":450*ac:49", md="450A49"),
            _mk_region(1, rev=1, rid=1, primary=False, cig_list=True),
        ],
        [],
        [_mk_region(2, cs=None, md=None, trans_strand=-1)],
        [_mk_region(3, cs="", md="")],  # empty-string tags != None
    ]
    for no_2nd in (False, True):
        block = pack_regions_block(regs_lists, no_2nd)
        got = unpack_mappings_block(block, NAMES, LENS)
        for regs, g in zip(regs_lists, got):
            _assert_same(regions_to_mappings(regs, NAMES, LENS, no_2nd), g)


@pytest.mark.parametrize("front_end", ["cpu", "device"])
def test_packed_sink_parity(genome, front_end):
    """map_batch_packed (the PackedSink: no Region objects on the native
    path) gives the exact block pack_regions_block builds from the
    Region path, with a zdrop-split fallback read (the Python merge) and
    an anchor-overflow read (a rowset overwritten by its retry)."""
    g, seg = genome
    rng = np.random.default_rng(11)
    reads, _ = simulate(rng, g[:120_000], 12, 1000, 0.05)
    reads.append(g[2000:2600] + random_genome(rng, 500) + g[3100:3700])
    reads.append(seg)
    al = _aligner(g)
    eng = al._engine
    eng.cfg.front_end_backend = front_end
    regs = eng.map_batch(reads, cs=True, md=True)
    names, lens = al._index.seq_names, al._index.seq_lens
    for no_2nd in (False, True):
        want = pack_regions_block(regs, no_2nd)
        got = eng.map_batch_packed(reads, cs=True, md=True, no_2nd=no_2nd)
        for a, b, name in zip(want, got, ("counts", "F", "cig", "cs", "md")):
            if isinstance(a, bytes):
                assert a == bytes(b), (no_2nd, name)
            else:
                assert np.array_equal(a, b), (no_2nd, name)
        for r, ms in zip(regs, unpack_mappings_block(got, names, lens)):
            _assert_same(regions_to_mappings(r, names, lens, no_2nd), ms)
    m = eng.metrics.snapshot()
    assert m.get("post_chain_fallbacks", 0) > 0
    if front_end == "device":
        assert m.get("anchor_overflow_retries", 0) > 0


def test_block_pickles_flat():
    """The block pickles as a handful of buffers (no per-Mapping object
    trees on the pipe)."""
    regs_lists = [[_mk_region(i, cs=":500")] for i in range(64)]
    block = pack_regions_block(regs_lists, False)
    assert isinstance(block, tuple) and len(block) == 5
    got = unpack_mappings_block(pickle.loads(pickle.dumps(block)), NAMES, LENS)
    for regs, g in zip(regs_lists, got):
        _assert_same(regions_to_mappings(regs, NAMES, LENS, False), g)


# ------------------------------------------------------ index hand-off
def test_share_roundtrip(genome, payload, tmp_path):
    al = _aligner(genome[0])
    idx = al._index
    save_index_dir(idx, str(tmp_path))
    back = load_index_dir(str(tmp_path))
    for name in ("k", "w", "bucket_bits", "flag", "seq_names"):
        assert getattr(back, name) == getattr(idx, name)
    for name in ("seq_lens", "keys", "key_offsets", "positions", "ref_codes"):
        a = getattr(back, name)
        assert isinstance(a, np.memmap) and not a.flags.writeable
        np.testing.assert_array_equal(a, getattr(idx, name))
    from mappy_rs_tpu_torch.models.pipeline import AlignmentEngine

    eng = AlignmentEngine(back, al._map_opt, al._config)
    seqs = [d["seq"] for d in payload[:8]]
    assert ([[fields(m) for m in al._to_mappings(r)]
             for r in eng.map_batch(seqs, cs=True)]
            == [[fields(m) for m in al.map(s, cs=True)] for s in seqs])


# ------------------------------------------------------ front-end probes
def test_probe_front_end_before_and_after_a_batch(genome, payload):
    al = _aligner(genome[0][:60_000])
    assert al.probe_front_end() == []
    assert al.front_end_roofline() == {}
    al.map(payload[0]["seq"])
    got = al.probe_front_end(2)
    assert len(got) == 2 and all(isinstance(t, float) and t > 0 for t in got)


def test_front_end_roofline_equals_jax_formula(genome, payload):
    """The JAX package's cost model at the window the port's K1 chains
    with (the JAX engine off the TPU counts 2 * chain_window)."""
    import dataclasses

    al = _aligner(genome[0][:60_000])
    al.map(payload[0]["seq"])
    got = al.front_end_roofline()
    jal = mappy_rs_tpu.Aligner(seq=genome[0][:60_000], preset="map-ont")
    jeng = jal._engine
    jeng._probe_shape = (got["B"], got["L"], got["M"], got["A"])
    jeng.cfg = dataclasses.replace(jeng.cfg, chain_window=got["window"] // 2)
    assert got == jeng.front_end_roofline()
    assert (got["B"], got["L"], got["window"]) == (8, 1024, 128)


# ------------------------------- streaming runtime edge cases (mirrors)
@pytest.fixture(scope="module")
def small_payload(payload):
    seqs = [d["seq"] for d in payload[:4]]
    return [{"i": i, "seq": seqs[i % 4]} for i in range(200)]


@pytest.fixture(params=("threads",) + TOPOLOGIES)
def stream_al(request, genome, proc_aligners):
    """A threaded Aligner, or the module's process Aligner of a topology
    (its pool of 4 proxies is restored afterwards)."""
    if request.param == "threads":
        al = _aligner(genome[0])
        al.enable_threading(2)
        yield al
        al.enable_threading(0)
        return
    al = proc_aligners(request.param)
    yield al
    if al.n_threads != 4 or al._procs is None:
        al.enable_threading(4)
        assert al._procs is not None


def test_abandoned_iterator_does_not_wedge_pool(stream_al, small_payload):
    it = stream_al.map_batch(small_payload)
    next(it)  # consume one result, then abandon
    del it
    gc.collect()
    # the pool must recover and serve the next batch fully
    assert len(drain(stream_al, small_payload)) == len(small_payload)


def test_partially_consumed_then_new_batch(stream_al, small_payload):
    it1 = stream_al.map_batch(small_payload)
    got1 = [next(it1) for _ in range(5)]
    assert len(got1) == 5
    it1.close()  # explicit disconnect mid-stream
    del it1
    gc.collect()
    for _ in range(3):
        assert len(drain(stream_al, small_payload[:50])) == 50


def test_many_sequential_batches(stream_al, small_payload):
    for k in range(6):
        assert len(drain(stream_al, small_payload[: 20 + k])) == 20 + k


def test_pool_restart_between_batches(stream_al, small_payload):
    procs = stream_al._config.worker_processes > 0
    # ends at the 4 proxies the module's process Aligners keep
    for n_threads in (1, 3, 2, 4):
        stream_al.enable_threading(n_threads)
        assert (stream_al._procs is not None) == procs
        assert len(drain(stream_al, small_payload[:30])) == 30
