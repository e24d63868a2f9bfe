"""The port's rare reads, held against the JAX package (the second half
of tests/test_torch_rare_paths.py, in a file of its own so that the two
halves run on two test workers).

The constructions of test_rare_path_floor.py, test_mapq_adversarial.py
and test_anchor_overflow.py go through ``mappy_rs_tpu_torch.Aligner(...,
device="cpu")`` and ``mappy_rs_tpu.Aligner(...)`` on the same input:
equal Mappings field for field and equal rare-path engine counters
(``tests/torch_parity.py`` ``same_mappings``). The fallback-heavy batch
(zdrop chimeras and inversions, every read missing the fused C++
post-chain) streams through the port's ``map_batch`` equal to the JAX
package's per-read ``map``; the mapq families (a clean unique read,
exact and diverged copies, a rep_len-attenuated read, three graded
copies) run under both front ends of both packages; the read across a
40-copy motif overflows the A = 256 anchor budget and is retried with
the backtrack on and off. No case depends on a tie between repeat copies
(the JAX package's CPU chain window is 64, the port's 128).
"""
import numpy as np
import pytest
import torch

from mappy_rs_tpu import native as jax_native

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch import native

from mappy_rs_tpu_torch.utils.simulate import choice_bases, fallback_batch

from torch_parity import (aligner_pair, drain, fields, rare_counters,
                          same_mappings)

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="the rare paths need both packages' native libraries")

BASES = "ACGT"
TARGET_START, MAPQ = 5, 9  # positions in fields()


# ------------------------------------------------------- rare-path floor
def test_fallback_batch_matches_jax():
    """test_rare_path_floor.py's batch, every read engineered to miss the
    fused C++ post-chain (zdrop chimeras and inversions): the port's
    map_batch through 4 threads == the JAX package's per-read map(),
    counters included."""
    genome, reads = fallback_batch()
    tal, jal = aligner_pair(seq=genome, preset="map-ont")
    want = [[fields(m) for m in jal.map(r, cs=True)] for r in reads]
    tal.enable_threading(4)
    try:
        got = drain(tal, [{"i": i, "seq": r} for i, r in enumerate(reads)])
    finally:
        tal.enable_threading(0)
    assert [got[i] for i in range(len(reads))] == want
    assert rare_counters(tal) == rare_counters(jal)
    assert rare_counters(tal)["inv_rescues"] >= len(reads) // 2
    fb = tal._engine.metrics.counters.get("post_chain_fallbacks", 0)
    assert fb >= 0.9 * len(reads)


# ------------------------------------------------------- mapq adversarial
def _mapq_genomes(family):
    """(genomes, read, mid_occ pin) of each test_mapq_adversarial.py
    family, with its seed."""
    rng = np.random.default_rng({"unique": 31, "duplicates": 32,
                                 "diverged": 33, "rep_len": 34,
                                 "tiers": 35}[family])

    def r(n):
        return choice_bases(rng, n)

    def diverge(unit, n):
        d = list(unit)
        for p in rng.choice(len(d), size=n, replace=False):
            d[p] = BASES[(BASES.index(d[p]) + 1) % 4]
        return "".join(d)

    if family == "unique":
        g = r(60_000)
        return [g], g[20_000:20_800], None
    if family == "duplicates":
        unit = r(800)
        return [r(12_000) + unit + r(20_000) + unit + r(12_000)], unit, None
    if family == "diverged":
        unit = r(800)
        decoy = diverge(unit, 10)
        return [r(12_000) + unit + r(20_000) + decoy + r(12_000)], unit, None
    if family == "rep_len":
        sat, uniq = r(600), r(250)
        ga = sat * 600 + r(5_000) + sat + uniq + r(20_000)
        ctl = r(len(sat)) + uniq
        gb = r(5_000) + ctl + r(20_000)
        return [ga, gb], [sat + uniq, ctl], 50
    unit = r(800)
    d10 = diverge(unit, 10)
    two = r(10_000) + unit + r(15_000) + d10 + r(10_000)
    three = (r(10_000) + unit + r(15_000) + d10 + r(15_000) + diverge(unit, 14)
             + r(10_000))
    return [two, three], unit, None


@pytest.mark.parametrize("family", ["unique", "duplicates", "diverged",
                                    "rep_len", "tiers"])
def test_mapq_families_match_jax(family):
    """Each family's read under both front ends of both packages: equal
    Mappings (mapq included) per front end, and mapq equal across the
    two front ends, as the JAX test requires."""
    genomes, reads, mid_occ = _mapq_genomes(family)
    if isinstance(reads, str):
        reads = [reads] * len(genomes)
    mapqs = []
    for g, read in zip(genomes, reads):
        per_fe = []
        for fe in ("device", "cpu"):
            tal, jal = aligner_pair(seq=g, preset="map-ont",
                                    backend="host", front_end=fe)
            if mid_occ is not None:
                tal._engine.opt.mid_occ = jal._engine.opt.mid_occ = mid_occ
            (got,) = same_mappings(tal, jal, [read])
            assert got
            per_fe.append(got[0][MAPQ])
        assert per_fe[0] == per_fe[1]
        mapqs.append(per_fe[0])
    if family == "unique":
        assert mapqs == [60]
    elif family == "duplicates":
        assert mapqs == [0]
    elif family == "diverged":
        assert 0 < mapqs[0] < 60
    elif family == "rep_len":
        assert mapqs[0] < 60 == mapqs[1]
    else:
        assert mapqs[1] < mapqs[0]


# --------------------------------------------------------- anchor overflow
@pytest.fixture(scope="module")
def repeat_case(tmp_path_factory):
    """test_anchor_overflow.py's genome: 40 interspersed copies of a
    400 bp motif between unique flanks, and a read across the first
    copy (its seeds expand to far more than A = 256 anchors)."""
    rng = np.random.default_rng(5)
    motif = "".join(rng.choice(list("ACGT"), size=400))
    uniq_l = "".join(rng.choice(list("ACGT"), size=30_000))
    uniq_r = "".join(rng.choice(list("ACGT"), size=30_000))
    spacer = ["".join(rng.choice(list("ACGT"), size=97)) for _ in range(40)]
    genome = uniq_l + "".join(m + motif for m in spacer) + uniq_r
    start = 30_000 - 300 + 97
    read = genome[start - 97: start + 97 + 400 + 300]
    fa = tmp_path_factory.mktemp("ovf") / "g.fa"
    fa.write_text(f">chr\n{genome}\n")
    return str(fa), read, start - 97


@pytest.mark.parametrize("bt", ["on", "off"])
def test_anchor_overflow_matches_jax(repeat_case, bt):
    """The retry with a 4x budget: the port == the JAX package, counter
    included; the read maps end to end at its origin, as through the
    native front end."""
    fa, read, true_start = repeat_case
    tal, jal = aligner_pair(fa=fa)
    for al in (tal, jal):
        al._engine.cfg = al._engine.cfg.replace(device_backtrack=bt)
        al._map_opt.mid_occ = 10_000
    (got,) = same_mappings(tal, jal, [read])
    assert rare_counters(tal)["anchor_overflow_retries"] >= 1
    assert got[0][TARGET_START] == true_start
    cpu = mappy_rs_tpu_torch.Aligner(fa, device="cpu")
    cpu._engine.cfg.front_end_backend = "cpu"
    cpu._map_opt.mid_occ = 10_000
    c = cpu.map(read, cs=True, MD=True)[0]
    d = tal.map(read, cs=True, MD=True)[0]
    assert (d.target_start, d.target_end, d.cigar_str) == (
        c.target_start, c.target_end, c.cigar_str)
