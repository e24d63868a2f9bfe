"""The k > 15 presets on the PyTorch port, held against the JAX package.

map-hifi (k=19, w=19) and sr (k=21, w=11) key their minimizers by
hashes of 2k = 38 and 42 bits: the port's int64 ``hash64``, the wide
sketch sentinel and the two-word hash-probe table
(index/index.py, ops/lookup.py) against the JAX package's (hi, lo)
uint32 words and its hash2 layout, exactly.  k = 16 is the JAX
package's one-word sketch case whose keys (up to 32 bits) still take
the two-word table.  Every preset name of config.py builds an index
and maps an exact read.  Mirrors tests/test_hash2_probe.py and
tests/test_presets.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu.config import IndexOptions as JaxIndexOptions
from mappy_rs_tpu.index.build import build_index as jax_build_index
from mappy_rs_tpu.ops.lookup import probe_index as jax_probe_index
from mappy_rs_tpu.utils import u64 as jax_u64

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.config import IndexOptions
from mappy_rs_tpu_torch.index.build import build_index
from mappy_rs_tpu_torch.models.pipeline import front_end_bt
from mappy_rs_tpu_torch.ops.lookup import probe_index
from mappy_rs_tpu_torch.ops.sketch import INF_WIDE, sketch_compact
from mappy_rs_tpu_torch.utils import u64
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

from torch_parity import (fields, jax_front_end, jax_sketch, port_key,
                          read_batch)

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

#: every preset name of config.py's table
PRESETS = ["map-ont", "ont", "ava-ont", "map-pb", "pb", "ava-pb", "map-hifi",
           "hifi", "lr:hq", "short", "sr", "asm5", "asm10", "asm20",
           "splice", "splice:hq", "cdna"]


@pytest.fixture(scope="module")
def genome():
    return random_genome(np.random.default_rng(21), 250_000)


# ------------------------------------------------------------------ hash
@pytest.mark.parametrize("k", range(16, 29))
def test_hash64_matches_jax(k):
    """int64 hash64 == the JAX package's two-word hash64 for k 16..28
    (keys of 32..56 bits; the shifts wrap int64 before the mask)."""
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), 4096, dtype=np.int64)
    keys[:4] = [0, 1, (1 << (2 * k)) - 1, (1 << (2 * k)) - 2]
    hi, lo = jax_u64.hash64(
        (jnp.asarray((keys >> 32).astype(np.uint32)),
         jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))),
        jnp.uint32(jax_u64.mask_bits(max(2 * k - 32, 0))),
        jnp.uint32(jax_u64.mask_bits(min(2 * k, 32))))
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    np.testing.assert_array_equal(u64.hash64(torch.from_numpy(keys), k).numpy(),
                                  want)


def test_hash64_k16_matches_hash32():
    """k = 16 is the JAX sketch's one-word case (hash32 on uint32)."""
    rng = np.random.default_rng(16)
    keys = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    keys[:3] = [0, (1 << 32) - 1, (1 << 31)]
    want = jax_u64.hash32(jnp.asarray(keys.astype(np.uint32)),
                          jnp.uint32(0xFFFFFFFF))
    np.testing.assert_array_equal(
        u64.hash64(torch.from_numpy(keys), 16).numpy(),
        np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------- sketch
@pytest.mark.parametrize("k,w", [(19, 19), (21, 11), (16, 10)])
def test_sketch_compact_matches_jax(k, w):
    rng = np.random.default_rng(k * w)
    B, L = 12, 768
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4  # N-breaks
    codes[2, 100:260] = 1  # homopolymer: window-minimum ties
    codes[3, 50:400] = np.tile([0, 1], 175)  # dinucleotide repeat
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:4] = [L, L, L, k + 1]
    lens[4] = k - 1  # shorter than k
    for b in range(B):
        codes[b, lens[b]:] = 4
    # M = 96: full reads emit more (~2L/(w+1)), so theirs overflow and
    # drop, and the short ones' do not
    want = jax_sketch(codes, lens, k, w, 96, hpc=False)
    got = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens),
                         k, w, 96)
    np.testing.assert_array_equal(got["n"].numpy(), np.asarray(want["n"]))
    np.testing.assert_array_equal(got["key"].numpy(), port_key(want, k))
    for f in ("pos", "strand", "span"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    assert got["n"].max() == 96 and got["n"][4:].min() < 96


# ----------------------------------------------------------------- index
def _indexes(genome, k: int, w: int):
    seqs = [("g", encode(genome[:120_000])), ("h", encode(genome[120_000:]))]
    ji = jax_build_index(seqs, JaxIndexOptions(k=k, w=w))
    ti = build_index(seqs, IndexOptions(k=k, w=w))
    np.testing.assert_array_equal(ti.keys, ji.keys)
    np.testing.assert_array_equal(ti.positions, ji.positions)
    return ji, ti


@pytest.mark.parametrize("k,w", [(16, 10), (19, 19), (21, 11)])
def test_two_word_table_matches_jax(genome, k, w):
    """The two-word table: the same slots, hash_val and sizes as the JAX
    package's hash2 layout, each slot's int64 key the key its
    (fingerprint, upper) words encode, -1 where they mark an empty slot."""
    ji, ti = _indexes(genome, k, w)
    jd, td = ji.device, ti.device_index("cpu")
    assert int(ti.keys[-1]).bit_length() > 31 and td.two_word
    hk = np.asarray(jd.hash_rows).astype(np.int64)  # [rows, 128, 2]
    want = np.where(hk[..., 0] == 0xFFFFFFFF, -1, (hk[..., 1] << 31) | hk[..., 0])
    np.testing.assert_array_equal(td.hash_rows.numpy(), want)
    for name in ("hash_val", "offcnt", "pos_rp"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    assert (td.n_keys, td.hash_bits, td.hash_shift) == (
        jd.n_keys, jd.hash_bits, jd.hash_shift)


@pytest.mark.parametrize("k,w", [(16, 10), (19, 19)])
def test_probe_index_matches_jax(genome, k, w):
    """found and (offset, count) equal the JAX probe's on every slot of
    the same minimizers, the invalid (sentinel) slots included."""
    ji, ti = _indexes(genome, k, w)
    rng = np.random.default_rng(k)
    reads, _ = simulate(rng, genome, 16, 700, 0.01)
    codes, lens = read_batch(reads, 16, 768)
    codes[5, 100:130] = 4  # an N-run: invalid k-mers inside a read
    mins = sketch_compact(torch.from_numpy(codes), torch.from_numpy(lens),
                          k, w, 256)
    found, oc = probe_index(mins, ti.device_index("cpu"))
    key = mins["key"].numpy()
    if 2 * k > 32:
        key = np.where(key == INF_WIDE, -1, key)  # -1: the (ones, ones) words
    jmins = {"key_hi": jnp.asarray((key >> 32).astype(np.uint32)),
             "key_lo": jnp.asarray((key & 0xFFFFFFFF).astype(np.uint32)),
             "pos": jnp.asarray(mins["pos"].numpy())}
    jd = ji.device
    jfound, joc = jax_probe_index(
        jmins, jd.key_hi, jd.key_lo, jd.offcnt, jd.n_keys, jd.bucket_start,
        jd.bucket_bits, jd.bucket_rounds, jd.bucket_shift, jd.keys32,
        jd.hash_rows, jd.hash_val, jd.hash_bits, jd.hash_shift)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(oc.numpy(), np.asarray(joc))
    assert found.sum() > 0.3 * (mins["pos"] >= 0).sum()
    assert (mins["pos"] < 0).sum() > 0  # sentinel slots were probed


# ------------------------------------------------- the slice, per preset
@pytest.fixture(scope="module")
def aligners(genome):
    return {p: (mappy_rs_tpu_torch.Aligner(seq=genome, preset=p, device="cpu"),
                mappy_rs_tpu.Aligner(seq=genome, preset=p))
            for p in ("map-hifi", "sr")}


def _reads(genome, preset: str, seed: int):
    rng = np.random.default_rng(seed)
    if preset == "sr":
        return simulate(rng, genome, 8, 150, 0.01)
    return simulate(rng, genome, 6, 1500, 0.01)


@pytest.mark.parametrize("preset", ["map-hifi", "sr"])
def test_front_end_matches_jax(genome, aligners, preset):
    tal, jal = aligners[preset]
    eng = tal._engine
    assert eng.dev.two_word
    reads, _ = _reads(genome, preset, 1)
    L = eng._bucket_len(max(len(r) for r in reads))
    B, M, A = eng.fe_shapes(L, b_real=len(reads))
    cuts = min(8, L // eng.SEG_LEN)
    codes, lens = read_batch(reads, B, L)
    chains, aux = front_end_bt(torch.from_numpy(codes), torch.from_numpy(lens),
                               eng.dev, **eng._fe_kwargs(M, A, cuts))
    want, jaux = jax_front_end(jal._engine, codes, lens, M, A, cuts,
                               eng._chain_params)
    np.testing.assert_array_equal(chains.numpy(), want)
    np.testing.assert_array_equal(aux.numpy(), jaux)
    assert (chains.numpy()[: len(reads), 0, 0] >= 0).all()


@pytest.mark.parametrize("preset", ["map-hifi", "sr"])
def test_aligner_matches_jax(genome, aligners, preset):
    tal, jal = aligners[preset]
    reads, starts = _reads(genome, preset, 2)
    for r, s in zip(reads, starts):
        got = [fields(m) for m in tal.map(r, cs=True, MD=True)]
        assert got == [fields(m) for m in jal.map(r, cs=True, MD=True)]
        assert got and abs(got[0][5] - s) < 100


@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_maps_an_exact_read(genome, preset):
    al = mappy_rs_tpu_torch.Aligner(seq=genome[:100_000], preset=preset,
                                    device="cpu")
    length = 150 if preset in ("sr", "short") else 1200
    start = 30_000
    hits = al.map(genome[start: start + length], cs=True)
    assert hits, f"{preset}: exact read failed to map"
    m = hits[0]
    assert abs(m.target_start - start) < 25 and m.strand == 1 and m.NM == 0
