"""The port's rare mapping paths, held against the JAX package.

The constructions of the JAX package's own tests of these paths
(test_zdrop_split.py, test_inversion.py, test_rmq_chain.py) go through
``mappy_rs_tpu_torch.Aligner(..., device="cpu")`` and
``mappy_rs_tpu.Aligner(...)`` on the same input: the Mappings must be
equal field for field (cs and MD included), and so must the engine
counters of the paths (``zdrop_splits``, ``inv_rescues``,
``anchor_overflow_retries``; ``tests/torch_parity.py``
``same_mappings``).  Each case also checks that its path ran (the
counter or the hit count its JAX test asserts).

The paths: zdrop splitting of a mid alignment into collinear parts and
its bounded re-splits (``AlignmentEngine._run_split_rounds``), the
inversion rescue across a split's gap (``_inversion_rescue``) under the
"host", "device" and "device_dl" extension backends, and RMQ long-gap
chaining (MM_F_RMQ presets route to the native front end, whose chains
and crafted DiagTree cases are also compared directly).  The rare reads
of test_rare_path_floor.py, test_mapq_adversarial.py and
test_anchor_overflow.py are in tests/test_torch_rare_reads.py.

Under "device_dl" neither package splits: its host walk of K3's
direction bytes reports no zdrop, so the inversion read maps as one
alignment, and the port keeps that.  Every genome here is random apart
from its crafted segments, so the JAX package's CPU chain window (64,
against the port's 128) decides nothing; the RMQ cases run the same
C++ front end on both sides.
"""
import numpy as np
import pytest
import torch

from mappy_rs_tpu import native as jax_native

from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.config import MM_F_RMQ
from mappy_rs_tpu_torch.utils.seqcodes import encode

from mappy_rs_tpu_torch.utils.simulate import (ZDROP_CASES, inversion_case,
                                               revcomp, rmq_case, zdrop_case)

from torch_parity import aligner_pair, rare_counters, same_mappings

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="the rare paths need both packages' native libraries")

STRAND = 2  # position in fields()


# ------------------------------------------------------------------ zdrop
#: per test_zdrop_split.py case: (least hits per read, zdrop splits)
ZDROP_EXPECT = {"patch": (2, 1), "short_patch": (1, 0),
                "long_deletion": (1, 0), "clean": (1, 0),
                "two_patches": (3, 2)}


@pytest.mark.parametrize("case", list(ZDROP_CASES))
def test_zdrop_split_matches_jax(case):
    genome, reads = zdrop_case(case)
    hits, splits = ZDROP_EXPECT[case]
    tal, jal = aligner_pair(seq=genome, preset="map-ont")
    got = same_mappings(tal, jal, reads)
    assert all(len(ms) >= hits for ms in got)
    if hits == 1:
        assert all(len(ms) == 1 for ms in got)
    assert rare_counters(tal)["zdrop_splits"] >= splits
    if splits == 0:
        assert rare_counters(tal)["zdrop_splits"] == 0


# -------------------------------------------------------------- inversion
@pytest.mark.parametrize("backend", ["host", "device", "device_dl"])
@pytest.mark.parametrize("case", ["forward", "reverse", "junk"])
def test_inversion_matches_jax(case, backend):
    """host and device: the read splits once and the inverted middle is
    rescued on the other strand (the junk gap splits, rescues nothing);
    device_dl: no split, one alignment, in both packages."""
    genome, read = inversion_case("junk" if case == "junk" else "inversion")
    if case == "reverse":
        read = revcomp(read)
    tal, jal = aligner_pair(seq=genome, backend=backend)
    (got,) = same_mappings(tal, jal, [read])
    c = rare_counters(tal)
    if backend == "device_dl":
        assert len(got) == 1 and c["zdrop_splits"] == 0
        return
    assert c["zdrop_splits"] == 1
    if case == "junk":
        assert c["inv_rescues"] == 0
        assert len({m[STRAND] for m in got}) == 1  # one strand
    else:
        assert c["inv_rescues"] == 1 and len(got) == 3
        assert len({m[STRAND] for m in got}) == 2


# -------------------------------------------------------------------- RMQ
@pytest.mark.parametrize("preset,rmq,case,hits", [
    ("asm5", False, "deletion", 1),      # bridged: one ~6000D mapping
    ("asm5", False, "insertion", 1),     # bridged: one ~3000I mapping
    ("map-ont", False, "deletion", 2),   # no long join: two mappings
    ("map-ont", True, "deletion", 1),    # extra_flags=MM_F_RMQ bridges it
    ("asm5", False, "junk", 2),          # diagonal-constant junk splits
])
def test_rmq_chaining_matches_jax(preset, rmq, case, hits):
    kw = {"extra_flags": MM_F_RMQ} if rmq else {}
    genome, read = rmq_case(case)
    tal, jal = aligner_pair(seq=genome, preset=preset, **kw)
    (got,) = same_mappings(tal, jal, [read])
    assert len(got) == hits if hits == 1 else len(got) >= hits


def test_rmq_chain_level_join_matches_jax():
    """The native front end without and with use_rmq: the port's chains
    equal the JAX package's (two chains, then one joined chain across
    the 6 kb deletion, scored below the two chains' sum)."""
    genome, read = rmq_case("deletion")
    tal, jal = aligner_pair(seq=genome, preset="asm5")
    codes = encode(read)
    joined = {}
    for rmq in (False, True):
        out = []
        for nat, eng in ((native, tal._engine), (jax_native, jal._engine)):
            chains, rep_len, n_an = nat.front_end_batch(
                eng.index, [codes], eng.opt.mid_occ, eng._chain_params,
                eng.cfg.cpu_chain_max_iter, eng.opt.min_cnt,
                eng.opt.min_chain_score, eng.cfg.backtrack_k, 8,
                eng.SEG_LEN, bw_long=eng.opt.bw_long, use_rmq=rmq)
            out.append((chains, rep_len, n_an))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        c = out[0][0][0]
        joined[rmq] = c[c[:, 0] > 0]
    assert len(joined[False]) == 2 and len(joined[True]) == 1
    s = joined[True][0]
    assert s[4] < 16_000 and s[5] > 22_000
    split = joined[False][:, 0]
    assert int(split.max()) < s[0] < int(split.sum())


def _shadow_anchors(case):
    """test_rmq_chain.py's crafted DiagTree anchors (rpos, qpos, span)."""
    if case == "cross_diagonal":
        return ([(990_100 + 15 * j, 100 + 15 * j, 15) for j in range(100)]
                + [(998_000 + 5100 + 15 * j, 5100 + 15 * j, 15)
                   for j in range(60)]
                + [(1_004_000, 5000, 15)])
    top = [(1_998_900 + 400 + 15 * j, 400 + 15 * j, 15) for j in range(5)]
    qs = (1050,) if case == "same_diagonal" else (1050, 1300, 1550)
    return (top + [(1_998_900 + q, q, 200) for q in qs]
            + [(2_000_000, 1000, 15)])


@pytest.mark.parametrize("case", ["cross_diagonal", "same_diagonal",
                                  "stacked_invalid"])
def test_rmq_shadowing_matches_jax(case):
    a = np.asarray(sorted(_shadow_anchors(case)), np.int32)
    z = np.zeros(len(a), np.int32)
    args = (z, z, a[:, 0], a[:, 1], a[:, 2], 5000, 5000, 500, 0.12, 0.0,
            5000, 100_000, 1)
    f, p = native.chain_dp_anchors(*args)
    jf, jp = jax_native.chain_dp_anchors(*args)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(p, jp)
    assert (p >= 0).sum() > 0
