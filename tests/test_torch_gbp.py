"""The port's genome-scale run (mappy_rs_tpu_torch/tools/gbp_chip.py), the
index build's torch sorts and the device index budget (tools/hbm_budget.py),
held against the JAX package on the CPU at 3 contigs of 2^20 bp.

(a) the genome model and the reads draw the same bytes as the JAX
    package's tools/gbp_chip.py (loaded by path) for the same seed;
(b) build_index and the device tables, sorted with torch, equal the JAX
    package's arrays at k = 15 (one-word table) and k = 19 (two words),
    and hbm_budget.count equals DeviceIndex.nbytes();
(c) unique-origin reads map as through the JAX package's Aligner, field
    for field;
(d) the tool's main, run twice on one cache directory with 2
    "device_owner" children: the second run is a cache hit, draws the
    same reads and reports the first run's build timings; another
    preset or genome parameter names another directory.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import mappy_rs_tpu
from mappy_rs_tpu.config import IndexOptions as JaxIndexOptions
from mappy_rs_tpu.index.build import build_index as jax_build_index

from mappy_rs_tpu_torch.api import Aligner
from mappy_rs_tpu_torch.config import IndexOptions, set_opt
from mappy_rs_tpu_torch.index.build import build_index
from mappy_rs_tpu_torch.tools import gbp_chip, hbm_budget

from torch_parity import fields

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = gbp_chip.SEED  # 5, the JAX tool's seed
MODEL = gbp_chip.GenomeModel(n_contig=3, contig_bits=20)


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/gbp_chip.py, loaded by path, at 3 contigs
    of 2^20 bp."""
    spec = importlib.util.spec_from_file_location(
        "jax_gbp_chip", os.path.join(ROOT, "tools", "gbp_chip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CONTIG = 1 << 20
    mod.N_CONTIG = 3
    return mod


@pytest.fixture(scope="module")
def genome():
    return gbp_chip.build_genome(np.random.default_rng(SEED), MODEL)


def contigs(buf):
    C = MODEL.contig
    return [(f"ctg{i:02d}", buf[i * C: (i + 1) * C])
            for i in range(MODEL.n_contig)]


def test_genome_and_reads_match_the_jax_tool(jax_tool, genome):
    buf, rep_starts, rep_lens = genome
    want = jax_tool.build_genome(np.random.default_rng(SEED))
    assert buf.dtype == want[0].dtype and len(buf) == MODEL.n_bp
    np.testing.assert_array_equal(buf, want[0])
    np.testing.assert_array_equal(rep_starts, want[1])
    np.testing.assert_array_equal(rep_lens, want[2])
    assert 0.4 < rep_lens.sum() / MODEL.n_bp <= 0.52
    reads, starts, unique = gbp_chip.sample_reads(
        np.random.default_rng(7), buf, 48, rep_starts, rep_lens, MODEL)
    w_reads, w_starts, w_unique = jax_tool.sample_reads(
        np.random.default_rng(7), buf, 48, rep_starts, rep_lens)
    assert reads == w_reads
    np.testing.assert_array_equal(starts, w_starts)
    np.testing.assert_array_equal(unique, w_unique)
    assert 0 < unique.sum() < len(reads)
    # 3.1 Gbp in contigs of 2^27 bp is 23 contigs
    assert gbp_chip.GenomeModel.for_gbp(3.1).n_contig == 23


@pytest.mark.parametrize("k,w", [(15, 10), (19, 19)])
def test_torch_sorted_index_matches_jax(genome, k, w):
    seqs = contigs(genome[0])
    ji = jax_build_index(seqs, JaxIndexOptions(k=k, w=w))
    ti = build_index(seqs, IndexOptions(k=k, w=w), device="cpu")
    for name in ("keys", "key_offsets", "positions", "seq_lens", "ref_codes"):
        np.testing.assert_array_equal(getattr(ti, name), getattr(ji, name))
    assert set(ti.build_seconds) == {"sketch", "sort"}
    jd, td = ji.device, ti.device_index("cpu")
    assert td.two_word == (k > 15)
    if td.two_word:
        hk = np.asarray(jd.hash_rows).astype(np.int64)  # [rows, 128, 2]
        want = np.where(hk[..., 0] == 0xFFFFFFFF, -1,
                        (hk[..., 1] << 31) | hk[..., 0])
    else:
        want = np.asarray(jd.hash_rows).view(np.int32)
    np.testing.assert_array_equal(td.hash_rows.numpy(), want)
    for name in ("hash_val", "offcnt", "pos_rp"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    assert (td.n_keys, td.hash_bits, td.hash_shift) == (
        jd.n_keys, jd.hash_bits, jd.hash_shift)
    assert {"upload", "tables"} <= set(ti.build_seconds)
    # the budget's count is the device index's bytes, tensor by tensor
    got = hbm_budget.count(td.n_keys, len(ti.positions), td.hash_bits,
                           td.two_word)
    assert got == {**gbp_chip.device_index_bytes(td),
                   "total": td.nbytes()}
    # the estimate, at this genome's key ratio, sizes the same layout
    ratio = td.n_keys / len(ti.positions)
    est = hbm_budget.estimate(MODEL.n_bp, w, k, ratio)
    assert abs(est["positions"] / len(ti.positions) - 1) < 0.05
    assert est["hash_bits"] == hbm_budget.start_bits(est["keys"])
    assert abs(est["pos_rp"] / got["pos_rp"] - 1) < 0.05


def test_unique_origin_reads_map_as_the_jax_aligner(genome, tmp_path):
    buf, rep_starts, rep_lens = genome
    idx_opt, _ = set_opt("map-ont")
    b = gbp_chip.build(MODEL, idx_opt, "cpu")
    np.testing.assert_array_equal(b.buf, buf)
    al = Aligner._from_index(b.index, gbp_chip.PRESET, "cpu")
    fa = tmp_path / "g.fa"
    with open(fa, "w") as fh:
        for name, c in contigs(buf):
            fh.write(f">{name}\n{np.frombuffer(b'ACGT', np.uint8)[c].tobytes().decode()}\n")
    jal = mappy_rs_tpu.Aligner(str(fa), preset="map-ont")
    reads, starts, unique = gbp_chip.sample_reads(
        gbp_chip.reads_rng(), buf, 96, rep_starts, rep_lens, MODEL)
    sel = [i for i in range(len(reads)) if unique[i]][:24]
    assert len(sel) >= 16
    for i in sel:
        ms = al.map(reads[i], cs=True, MD=True)
        want = [fields(m) for m in jal.map(reads[i], cs=True, MD=True)]
        assert [fields(m) for m in ms] == want, i
        gs = int(starts[i])
        assert ms[0].ctg == f"ctg{gs // MODEL.contig:02d}"
        assert abs(ms[0].r_st - gs % MODEL.contig) < 100


def test_main_twice_on_one_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children inherit it
    cache = tmp_path / "cache"
    args = ["--gbp=0.0032", "--contig-bits=20", "--procs=2", "--reads=8",
            "--warm=8", "--passes=1", "--probe=0", "--device=cpu",
            f"--cache={cache}"]
    recs = []
    for n in (1, 2):
        out = tmp_path / f"r{n}.json"
        assert gbp_chip.main(args + [f"--out={out}"]) == 0
        with open(out) as fh:
            recs.append(json.load(fh))
    first, second = recs
    assert first["n_contigs"] == 3 and first["genome_bp"] == MODEL.n_bp
    assert not first["cache_hit"] and second["cache_hit"]
    assert first["cache"] == second["cache"]
    assert os.listdir(cache) == [os.path.basename(first["cache"])]
    assert first["reads_digest"] == second["reads_digest"]
    assert first["passes"][0]["placed"] == second["passes"][0]["placed"]
    for step in ("genome", "contig_sketch", "sort_unique"):
        assert first["build_s"][step] > 0
        assert second["build_s"][step] == first["build_s"][step]
    for rec in recs:
        assert rec["device_index_bytes"]["total"] == sum(
            rec["device_index_bytes"][n]
            for n in ("offcnt", "pos_rp", "hash_rows", "hash_val"))
        assert 0 < rec["key_ratio"] < 1
        assert rec["counters"]["fe_batches"] > 0
        assert rec["host"]["cpu_count"] == os.cpu_count()
    # everything that decides the content names another directory
    idx_opt, _ = set_opt(gbp_chip.PRESET)
    base = gbp_chip.cache_dir(str(cache), MODEL, idx_opt)
    assert base == first["cache"]
    others = [
        gbp_chip.cache_dir(str(cache), MODEL, set_opt("map-hifi")[0]),
        gbp_chip.cache_dir(str(cache), gbp_chip.GenomeModel(
            n_contig=4, contig_bits=20), idx_opt),
        gbp_chip.cache_dir(str(cache), gbp_chip.GenomeModel(
            n_contig=3, contig_bits=21), idx_opt),
    ]
    for name, value in (("SEED", SEED + 1), ("DIVERGENCE", 0.01),
                        ("LINE", (10, 5000)), ("SINE", (30, 250)),
                        ("REPEAT_SHARE", 0.5)):
        with monkeypatch.context() as mp:
            mp.setattr(gbp_chip, name, value)
            others.append(gbp_chip.cache_dir(str(cache), MODEL, idx_opt))
    assert len({base, *others}) == len(others) + 1


def test_preflight_names_the_shortfall():
    idx_opt, _ = set_opt("map-ont")
    pre = gbp_chip.preflight(MODEL, idx_opt, "cpu", 2)
    assert set(pre["need"]) >= {"host_ram", "tmp_disk", "card"}
    big = gbp_chip.GenomeModel(n_contig=1 << 20, contig_bits=27)
    with pytest.raises(RuntimeError, match="host_ram: need"):
        gbp_chip.preflight(big, idx_opt, "cpu", 2)
