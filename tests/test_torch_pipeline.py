"""The PyTorch port's slice as a whole, held against the JAX package.

On a 2 Mbp random genome made from a seed: the port's fused front end
(sketch -> lookup -> chain DP -> backtrack) gives the JAX package's
``_front_end_bt(..., use_pallas=True)`` chain table exactly (Pallas
kernels in interpret mode), and ``Aligner(seq=..., device="cpu")``
gives ``mappy_rs_tpu.Aligner(seq=...)``'s Mappings field for field.
Also: the reference's error strings, the explicit device (no silent
CPU fallback), the once-unported entry points (multi-device, the device
extension backend) mapping, and that importing the port leaves jax and
the JAX package unloaded.
"""
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.models.pipeline import _front_end_bt
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.config import AlignerConfig
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 2_000_000)
    reads, starts = simulate(rng, genome, 64, 1000, 0.05)
    return genome, reads, starts


@pytest.fixture(scope="module")
def aligners(data):
    genome = data[0]
    return (mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu"),
            mappy_rs_tpu.Aligner(seq=genome))


def _fields(m):
    """Every Mapping field (the strand by value: the two packages have
    their own Strand enums)."""
    return tuple(
        getattr(m, "cigar" if s == "_cig" else "strand" if s == "_strand" else s)
        for s in m.__slots__
    )


def test_front_end_chain_table_matches_jax(data, aligners):
    _genome, reads, _starts = data
    tal, jal = aligners
    eng, jeng = tal._engine, jal._engine
    B, M, A = eng.fe_shapes(1024, b_real=32)
    codes = np.full((B, 1024), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:32]):
        c = encode(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    kw = eng._fe_kwargs(M, A, 2)
    chains, aux = front_end_bt(torch.from_numpy(codes),
                               torch.from_numpy(lens), eng.dev, **kw)

    jd = jeng.dev
    od, mmo = jeng._seed_select_params()
    assert (od, mmo) == (kw["occ_dist"], kw["max_max_occ"]) == (500, 4095)
    jchains, jaux = _front_end_bt(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lens),
        None, None, None,
        jd.key_hi, jd.key_lo, jd.offcnt, jd.pos_rp, jd.bucket_start,
        jd.hash_rows, jd.hash_val, jnp.int32(jd.n_keys),
        jnp.int32(jeng.opt.mid_occ), 15, 10, M, A,
        JaxChainParams(*eng._chain_params), 32, True,
        float(jeng.opt.q_occ_frac), 8, 2, jeng.opt.min_cnt,
        jeng.opt.min_chain_score, pallas_window=128, occ_dist=od,
        max_max_occ=mmo, keys32=jd.keys32, hash_bits=jd.hash_bits,
        hash_shift=jd.hash_shift,
    )
    np.testing.assert_array_equal(chains.numpy(), np.asarray(jchains))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    assert (chains.numpy()[:32, 0, 0] >= 0).all()  # every read chained


def test_aligner_map_matches_jax(data, aligners):
    _genome, reads, starts = data
    tal, jal = aligners
    for r in reads[:6]:
        got = tal.map(r, cs=True, MD=True)
        want = jal.map(r, cs=True, MD=True)
        assert [_fields(m) for m in got] == [_fields(m) for m in want]
        assert got


def _drain(al, payload, timeout: float = 300.0) -> dict:
    """map_batch's results, consumed on a helper thread joined with a
    timeout: a worker that never finishes fails the test, not the run."""
    out, err = {}, []

    def run():
        try:
            for ms, d in al.map_batch(payload):
                out[d["i"]] = [_fields(m) for m in ms]
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            err.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"map_batch did not finish within {timeout} s"
    if err:
        raise err[0]
    return out


def test_map_batch_matches_jax_and_places_reads(data, aligners):
    _genome, reads, starts = data
    tal, jal = aligners
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    out = {}
    for name, al in (("port", tal), ("jax", jal)):
        al.enable_threading(2)
        try:
            out[name] = _drain(al, payload)
        finally:
            al.enable_threading(0)
    assert out["port"] == out["jax"]
    placed = sum(
        1 for i, s in enumerate(starts)
        if out["port"][i] and abs(out["port"][i][0][5] - s) < 100
    )
    assert placed == len(reads)


def test_anchor_overflow_retry_matches_wide_budget():
    """Reads from a 4-copy segmental duplication overflow the A=256
    anchor budget; the engine remaps them with a 4x budget, and the
    result equals mapping with that budget from the start."""
    rng = np.random.default_rng(3)
    unit = np.frombuffer(random_genome(rng, 3000).encode(), np.uint8)
    copies = []
    for _ in range(4):  # 1% substitutions per copy
        c = unit.copy()
        hit = rng.random(len(c)) < 0.01
        c[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, hit.sum())]
        copies.append(random_genome(rng, 5000) + c.tobytes().decode())
    genome = "".join(copies) + random_genome(rng, 5000)
    reads = [genome[5000 + 200 + 8000 * i: 5000 + 1200 + 8000 * i]
             for i in range(3)]
    al = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    wide = mappy_rs_tpu_torch.Aligner(seq=genome, device="cpu")
    wide._engine.cfg.anchors_per_base = 1.0  # A = 1024 for 1 kb reads
    got = [al.map(r, cs=True) for r in reads]
    assert al.metrics.get("anchor_overflow_retries", 0) >= len(reads)
    want = [wide.map(r, cs=True) for r in reads]
    assert wide.metrics.get("anchor_overflow_retries", 0) == 0
    assert [[_fields(m) for m in ms] for ms in got] == [
        [_fields(m) for m in ms] for ms in want]
    assert all(ms for ms in got)


def test_map_batch_error_strings(aligners):
    tal, _ = aligners
    with pytest.raises(RuntimeError, match="Multi threading not enabled"):
        tal.map_batch([{"seq": "ACGT"}])
    tal.enable_threading(1)
    try:
        with pytest.raises(KeyError) as ei:
            tal.map_batch([{"id": 1}])
        assert ei.value.args[0] == (
            "AHHH Key 🗝️  not found in iterated dictionary")
        with pytest.raises(TypeError, match="Element in iterable is not a dictionary"):
            tal.map_batch(["ACGT"])
        with pytest.raises(TypeError, match="Unsupported batch type"):
            tal.map_batch({"seq": "ACGT"})
    finally:
        tal.enable_threading(0)
    with pytest.raises(RuntimeError, match="Did not create or open an index"):
        mappy_rs_tpu_torch.Aligner(device="cpu")
    with pytest.raises(NotImplementedError, match="seq2"):
        tal.map("ACGT", seq2="ACGT")


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mappy_rs_tpu_torch.Aligner(seq="ACGT" * 100)  # device="cuda"
    assert AlignerConfig().device == "cuda"


def test_unported_entry_points_raise(data, aligners):
    """The entry points that raised NotImplementedError before their
    port now map: decision mode (enable_sharding + map_batch_positions)
    and the full-CIGAR grid (enable_mesh), each on a grid of CPU cells;
    and the device extension backend, as the host one."""
    genome = data[0]
    al = mappy_rs_tpu_torch.Aligner(seq=genome[:50_000], device="cpu")
    read = genome[1000:2000]
    host = [_fields(m) for m in al.map(read, cs=True)]
    with pytest.raises(RuntimeError, match="Sharding not enabled"):
        al.map_batch_positions([read])
    al.enable_sharding(2, 2, devices=["cpu"] * 4)
    (dec,) = al.map_batch_positions([read])
    assert dec["ctg"] == host[0][3] and dec["strand"] == 1
    assert abs(dec["r_en"] - 2000) < 20 and dec["ext_score"] > 1500
    grid = mappy_rs_tpu_torch.Aligner(seq=genome[:50_000], device="cpu")
    grid.enable_mesh(2, n_index=2, devices=["cpu"] * 4)
    assert [_fields(m) for m in grid.map(read, cs=True)] == host
    assert grid._engine.index._devices == {}
    # the device extension backend is ported: it maps, as the host one
    al._engine.cfg.extension_backend = "device"
    al._engine.cfg.post_chain_native = False
    assert [_fields(m) for m in al.map(read, cs=True)] == host
    assert host and host[0][5] == 1000


def test_import_leaves_jax_out():
    code = (
        "import sys, mappy_rs_tpu_torch, mappy_rs_tpu_torch.models.pipeline, "
        "mappy_rs_tpu_torch.ops.cuda_build, mappy_rs_tpu_torch.runtime.devowner, "
        "mappy_rs_tpu_torch.runtime.procpool, mappy_rs_tpu_torch.runtime.pack, "
        "mappy_rs_tpu_torch.index.share, mappy_rs_tpu_torch.parallel.mesh, "
        "mappy_rs_tpu_torch.parallel.multihost, mappy_rs_tpu_torch.entry, "
        "mappy_rs_tpu_torch.tools.gbp_chip, mappy_rs_tpu_torch.tools.hbm_budget, "
        "mappy_rs_tpu_torch.tools.concordance, "
        "mappy_rs_tpu_torch.tools.trace_front_end; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'mappy_rs_tpu' or m.startswith('mappy_rs_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax|mappy_rs_tpu)\b")
    # a path into the JAX package's tree: "mappy_rs_tpu/..." or a quoted
    # "mappy_rs_tpu" path component.  Naming the Pallas kernel a CUDA
    # kernel replaces (mappy_rs_tpu/ops/<name>_pallas.py) is allowed.
    path_pat = re.compile(
        r"\bmappy_rs_tpu(?:[/\\](?!ops/\w+_pallas\.py)|[\"'])")
    pkg = os.path.join(ROOT, "mappy_rs_tpu_torch")
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "chip_kernels.py")]
    for dirpath, _dirs, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cc", ".h"))]
    assert any(f.endswith(os.path.join("native", "src", "post_chain.cc"))
               for f in files)
    for path in files:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                if path.endswith(".py"):
                    assert not pat.match(line), (path, line)
                assert not path_pat.search(line), (path, line)
