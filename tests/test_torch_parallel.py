"""Parity of the port's multi-device modules with the JAX package.

The port's parallel/mesh.py (grids, key-range shards, the decision
step), its sorted-key probe, its block chaining DP and its index-sharded
front end, each fed the same seeded inputs as the JAX package's
counterpart, which runs on conftest.py's 8-device virtual CPU mesh.
The port's grids put every cell on the CPU (``devices=["cpu"] * n``).
Every output is integer: the bar is exact equality.  The data are a
seeded multi-contig genome of unique sequence with reads drawn from it
(ROADMAP R3).  Aligner-level parity is in tests/test_torch_parallel_api.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.models.pipeline import make_sharded_front_end as jax_sharded_fe
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain import chain_scores as jax_chain_scores
from mappy_rs_tpu.ops.chain import chain_scores_block as jax_chain_scores_block
from mappy_rs_tpu.ops.extend import ExtendParams as JaxExtendParams
from mappy_rs_tpu.ops.lookup import probe_index as jax_probe_index
from mappy_rs_tpu.parallel import mesh as jmesh
from mappy_rs_tpu.parallel import multihost as jmh

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.ops.chain import ChainParams, chain_scores_block
from mappy_rs_tpu_torch.ops.extend import ExtendParams
from mappy_rs_tpu_torch.ops.lookup import probe_sorted
from mappy_rs_tpu_torch.ops.sketch import sketch_compact
from mappy_rs_tpu_torch.parallel import mesh as tmesh
from mappy_rs_tpu_torch.parallel import multihost as tmh
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import (random_genome, simulate,
                                               sweep_anchors)

from torch_parity import jax_sketch, port_key, read_batch, write_genome

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    fa = str(tmp_path_factory.mktemp("par") / "g.fa")
    ctgs = write_genome(fa, 5)
    return fa, ctgs, (mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu"),
                      mappy_rs_tpu.Aligner(fa, preset="map-ont"))


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
        if i % 3 == 0:
            r = r[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append(r)
    return reads + ["ACGT" * 30]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_index_matches_jax(genome, n_shards):
    _fa, _ctgs, (tal, jal) = genome
    got = tmesh.shard_index_by_key_range(tal._index, n_shards)
    want = jmesh.shard_index_by_key_range(jal._index, n_shards)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the device layout: one int64 key per slot, the padding above all keys
    keys = tmesh.device_shards(got, ("keys",))["keys"]
    for s in range(n_shards):
        n = int(got["n_keys"][s])
        np.testing.assert_array_equal(keys[s, :n].astype(np.uint64),
                                      tal._index.keys[sum(got["n_keys"][:s]):][:n])
        assert (keys[s, n:] == np.iinfo(np.int64).max).all()
        assert (np.diff(keys[s, :n]) > 0).all()


def test_shard_index_refuses_contig_over_int32(genome):
    """A single contig of 2^31 bp refuses, with the JAX package's error."""
    _fa, _ctgs, (tal, jal) = genome
    msgs = []
    for idx, fn in ((tal._index, tmesh.shard_index_by_key_range),
                    (jal._index, jmesh.shard_index_by_key_range)):
        saved = idx.seq_lens
        fake = saved.copy().astype(np.int64)
        fake[0] = 2**31
        object.__setattr__(idx, "seq_lens", fake)
        try:
            with pytest.raises(OverflowError) as exc:
                fn(idx, 2)
            msgs.append(str(exc.value))
        finally:
            object.__setattr__(idx, "seq_lens", saved)
    assert msgs[0] == msgs[1] and "2^31" in msgs[0]


@pytest.mark.parametrize("preset", ["map-ont", "map-hifi"])
def test_probe_sorted_matches_jax(tmp_path, preset):
    """The sorted-key probe of every key-range shard == the JAX package's
    probe_index(keys32=False), one-word (k=15) and wide (k=19) keys."""
    fa = str(tmp_path / "g.fa")
    ctgs = write_genome(fa, 9, (40_000, 25_000))
    tal = mappy_rs_tpu_torch.Aligner(fa, preset=preset, device="cpu")
    jal = mappy_rs_tpu.Aligner(fa, preset=preset)
    k, w = tal._index.k, tal._index.w
    rng = np.random.default_rng(3)
    reads, _ = simulate(rng, ctgs[0], 12, 900, 0.05)
    reads += ["ACGT" * 50, random_genome(rng, 700)]
    codes, lens = read_batch(reads, len(reads), 1024)
    M = 1024 // max(w // 2, 1)
    jm = jax_sketch(codes, lens, k, w, M, False)
    tm = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens), k, w, M)
    np.testing.assert_array_equal(tm["key"].numpy(), port_key(jm, k))
    sh = jmesh.shard_index_by_key_range(jal._index, 3)
    dsh = tmesh.device_shards(tmesh.shard_index_by_key_range(tal._index, 3))
    n_found = 0
    for s in range(3):
        jf, joc = jax_probe_index(
            jm, jnp.asarray(sh["key_hi"][s]), jnp.asarray(sh["key_lo"][s]),
            jnp.asarray(sh["offcnt"][s]), jnp.int32(sh["n_keys"][s]),
            keys32=False)
        tf, toc = probe_sorted(tm, torch.from_numpy(dsh["keys"][s]),
                               torch.from_numpy(dsh["offcnt"][s]),
                               int(dsh["n_keys"][s]))
        jf = np.asarray(jf)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(toc.numpy()[jf], np.asarray(joc)[jf])
        n_found += int(jf.sum())
    assert n_found > 20 * len(reads)


@pytest.mark.parametrize("skip,splice,block,span", [
    (0.0, 0, 32, True), (0.37, 0, 32, True), (0.0, 1, 32, True),
    (0.0, 0, 16, False), (0.0, 0, 32, False)])
def test_chain_scores_block_matches_jax(skip, splice, block, span):
    """Gate-sweep anchors (utils/simulate.py sweep_anchors), both penalty
    paths, the splice branch, two block sizes, with and without the
    span field (decision mode chains without it)."""
    params = (5000, 5000, 500, 15, 0.8 * 0.01 * 15, skip * 0.01 * 15, splice)
    rng = np.random.default_rng(int(skip * 100) + 7 * splice + block)
    an = sweep_anchors(rng, 12, 333, 500)
    names = ("rev", "rid", "rpos", "qpos", "valid") + (("span",) if span else ())
    an = {n: an[n] for n in names}
    f, p = chain_scores_block(an, ChainParams(*params), block)
    jf, jp = jax_chain_scores_block({n: jnp.asarray(v.numpy()) for n, v in an.items()},
                                    JaxChainParams(*params), block)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert (p >= 0).sum() > 1000


def _decode(stack):
    """A [5, B, A] front-end stack as anchor fields (numpy)."""
    meta = stack[0]
    return {"rev": (meta >> 30) & 1, "valid": ((meta >> 29) & 1).astype(bool),
            "span": (meta >> 21) & 255, "rid": meta & ((1 << 21) - 1),
            "rpos": stack[1], "qpos": stack[2], "f": stack[3], "p": stack[4]}


def test_sharded_front_end_matches_jax(genome):
    """make_sharded_front_end at (4, 2) == the JAX package's on one batch
    of 1 kb and 4 kb reads at A = 256 (A_loc = 128 per shard: the 4 kb
    reads overflow their shards' budgets): valid anchor columns and n,
    n_raw, rep_len exactly; f and p against the JAX package's window-128
    chain_scores (K1's reference) on its anchors."""
    fa, ctgs, (_tal, jal) = genome
    tal = mappy_rs_tpu_torch.Aligner(fa, preset="map-ont", device="cpu")
    rng = np.random.default_rng(21)
    reads = []
    for c, n, ln in ((ctgs[1], 10, 1000), (ctgs[3], 6, 4000)):
        reads += simulate(rng, c, n, ln, 0.05)[0]
    L, A = 4096, 256
    eng, jeng = tal._engine, jal._engine
    eng.enable_mesh(4, 2, devices=["cpu"] * 8)
    assert eng.index._devices == {}
    B, M, _A = eng.fe_shapes(L)
    B = 16
    codes_sel = [encode(r) for r in reads]
    _lens, handles = eng._fe_submit_batch(codes_sel, L, B, M, A, False, 2)
    assert isinstance(handles, list) and len(handles) == 4
    got = np.concatenate([h.out.numpy() for h in handles], axis=1)
    got_n = np.concatenate([h.aux.numpy() for h in handles], axis=1)
    assert eng.index._devices == {}, "the replicated tables were built"

    jm = jmesh.make_mesh(4, 2)
    od, mmo = jeng._seed_select_params()
    fe = jax_sharded_fe(
        jm, False, 2, k=15, w=10, M=M, A=A,
        chain_params=jeng._chain_params, chain_window=jeng.cfg.chain_window,
        use_pallas=False, q_occ_frac=float(jeng.opt.q_occ_frac),
        pallas_window=128, occ_dist=od, max_max_occ=mmo, packed=False)
    sh = jmesh.shard_index_by_key_range(jal._index, 2)
    specs = jmh.shard_specs_for_index()
    jsh = {n: jmh.put_global(sh[n], jm, specs[n])
           for n in ("key_hi", "key_lo", "offcnt", "pos_rp", "n_keys")}
    codes, lens = read_batch(reads, B, L)
    j_codes = jmh.put_global(codes, jm, jmh.P("data", None))
    j_lens = jmh.put_global(lens, jm, jmh.P("data"))
    stack, counts = fe(j_codes, j_lens, j_lens, None, None, None,
                       jsh["key_hi"], jsh["key_lo"], jsh["offcnt"],
                       jsh["pos_rp"], jsh["n_keys"], jnp.int32(jeng.opt.mid_occ))
    want, want_n = np.asarray(stack), np.asarray(counts)
    np.testing.assert_array_equal(got_n, want_n)
    assert (want_n[1] > A).any(), "no anchor-budget overflow exercised"
    assert (want_n[0] < np.minimum(want_n[1], A)).any(), "no shard overflowed"
    g, j = _decode(got), _decode(want)
    valid = j["valid"]
    np.testing.assert_array_equal(g["valid"], valid)
    assert (valid.sum(axis=1) == want_n[0]).all()
    for name in ("rev", "span", "rid", "rpos", "qpos"):
        np.testing.assert_array_equal(g[name][valid], j[name][valid], err_msg=name)
    ja = {n: jnp.asarray(j[n]) for n in ("rev", "rid", "rpos", "qpos", "span", "valid")}
    jf, jp = jax_chain_scores(ja, jeng._chain_params, 128)
    np.testing.assert_array_equal(g["f"][valid], np.asarray(jf)[valid])
    np.testing.assert_array_equal(g["p"][valid], np.asarray(jp)[valid])


@pytest.mark.parametrize("n_data,n_index", [(4, 2), (8, 1)])
def test_decision_step_matches_jax(genome, n_data, n_index):
    """build_sharded_map_step == the JAX package's, all six fields, on
    exact contig slices (forward and reverse), a junk read and a padding
    row of length 0."""
    _fa, ctgs, (tal, jal) = genome
    ti, opt = tal._index, tal._map_opt
    reads = _decision_reads(np.random.default_rng(n_data), ctgs, 14)
    codes, lens = read_batch(reads, 16, 512)
    cp = _chain_params(opt, ti.k)
    ep = (opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2, opt.sc_ambi)

    jm = jmesh.make_mesh(n_data, n_index)
    jstep = jmesh.build_sharded_map_step(
        jm, ti.k, ti.w, 64, 128, JaxChainParams(*cp), JaxExtendParams(*ep),
        opt.mid_occ, 32, 128)
    want = jmh.gather_results(jstep(
        jmh.put_global(codes, jm, jmh.P("data", None)),
        jmh.put_global(lens, jm, jmh.P("data")),
        jmh.put_global_tree(jmesh.shard_index_by_key_range(jal._index, n_index),
                            jm, jmh.shard_specs_for_index())))

    mesh = tmesh.make_mesh(n_data, n_index, ["cpu"] * (n_data * n_index))
    step = tmesh.build_sharded_map_step(
        mesh, ti.k, ti.w, 64, 128, ChainParams(*cp), ExtendParams(*ep),
        opt.mid_occ, 32, 128)
    shards = tmh.put_global_tree(
        tmesh.device_shards(tmesh.shard_index_by_key_range(ti, n_index)),
        mesh, tmh.shard_specs_for_index())
    got = tmh.gather_results(step(tmh.put_global(codes, mesh, tmesh.P("data", None)),
                                  tmh.put_global(lens, mesh, tmesh.P("data")),
                                  shards))
    assert set(got) == set(want)
    for name in tmesh.DECISION_FIELDS:
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    assert (got["chain_score"][:14] > 200).all()
    assert got["chain_score"][14] < 0 and got["rev"][14] == 2  # the junk read
    # the reads are exact: all of each read extends, less the gap of
    # W/2 = 64 reference bases before it in its window
    assert (got["ext_score"][:14] >= 2 * lens[:14] - 100).all()


def test_grid_layout_and_collectives():
    """make_mesh's row-major layout and its errors; the row collectives
    on peers that share a device and on peers that do not."""
    mesh = tmesh.make_mesh(2, 3, ["cpu"] * 6)
    assert mesh.shape == {"data": 2, "index": 3}
    assert mesh.axis_names == ("data", "index")
    assert mesh.devices.shape == (2, 3) and list(mesh.local_rows) == [0, 1]
    grp = mesh.group(1)
    assert grp.distinct == [torch.device("cpu")]
    xs = [torch.tensor([1, 5, -2]), torch.tensor([4, 0, 3]), torch.tensor([2, 2, 2])]
    cpu = torch.device("cpu")
    assert grp.psum(xs)[cpu].tolist() == [7, 7, 3]
    assert grp.pmax(xs)[cpu].tolist() == [4, 5, 3]
    assert grp.all_gather(xs)[cpu].tolist() == [x.tolist() for x in xs]
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(2, 3, ["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            tmesh.make_mesh(2, 1)
    # put_global: "data" splits over rows, "index" over peers, None whole
    arr = np.arange(24, dtype=np.int32).reshape(6, 4)
    pl = tmh.put_global(arr, mesh, tmesh.P("data", None))
    assert pl.blocks[(1, 2)].tolist() == arr[3:].tolist()
    assert pl.blocks[(1, 0)] is pl.blocks[(1, 2)]  # one tensor per device
    pi = tmh.put_global(arr[:3], mesh, tmesh.P("index", None))
    assert pi.blocks[(0, 2)].tolist() == arr[2:3].tolist()
    assert tmh.gather_results({"x": pl})["x"].tolist() == arr.tolist()
    with pytest.raises(ValueError, match="does not split"):
        tmh.put_global(arr[:5], mesh, tmesh.P("data", None))
    with pytest.raises(ValueError, match="n_index=4 must divide"):
        tmh.make_global_mesh(4, devices=["cpu"] * 6)


@pytest.mark.parametrize("n_data,n_index", [(2, 2), (4, 1)])
def test_grid_backtracks_per_row_when_on(n_data, n_index):
    """device_backtrack "on" under a grid: each row's front end runs
    the chain backtrack (K2's path, no host backtrack) and the Mappings
    are the single device's; "auto" under a grid backtracks on the
    host."""
    rng = np.random.default_rng(3)
    g = random_genome(rng, 300_000)
    reads, _ = simulate(rng, g, 12, 1000, 0.05)
    single = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    want = [single.map(r, cs=True) for r in reads]
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al.enable_mesh(n_data, n_index=n_index, devices=["cpu"] * (n_data * n_index))
    assert not al._engine._bt_enabled(256)
    al._engine.cfg.device_backtrack = "on"
    assert [al.map(r, cs=True) for r in reads] == want
    assert al.metrics.get("host_bt_batches", 0) == 0
