"""The port's top-level entry points (mappy_rs_tpu_torch/entry.py) on the CPU:
entry()'s forward step against the JAX package's sketch_compact ->
collect_anchors -> chain_scores_block(..., 32) on the same seeded
workload, and dryrun_multichip over four CPU cells.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mappy_rs_tpu.config import IndexOptions as JaxIndexOptions
from mappy_rs_tpu.config import MapOptions as JaxMapOptions
from mappy_rs_tpu.index.build import build_index as jax_build_index
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain import chain_scores_block as jax_chain_scores_block
from mappy_rs_tpu.ops.lookup import collect_anchors as jax_collect_anchors
from mappy_rs_tpu.ops.sketch import sketch_compact as jax_sketch_compact

from mappy_rs_tpu_torch import entry as port_entry

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)


def test_entry_matches_jax_forward_step():
    fn, (codes, lens) = port_entry.entry("cpu")
    f, p, rpos, rev = fn(codes, lens)
    _idx, _opt, codes_np, lens_np, contigs, _reads = port_entry._workload()
    np.testing.assert_array_equal(codes.numpy(), codes_np)
    # the JAX package's step (its __graft_entry__.py entry) on the same
    # contigs and reads
    idx = jax_build_index([(f"c{i}", c) for i, c in enumerate(contigs)],
                          JaxIndexOptions())
    opt = JaxMapOptions()
    idx.update_map_options(opt)
    dev = idx.device
    cp = JaxChainParams(
        max_dist_x=opt.max_gap, max_dist_y=opt.max_gap, bw=opt.bw,
        q_span=idx.k, chn_pen_gap=opt.chain_gap_scale * 0.01 * idx.k,
        chn_pen_skip=0.0)
    mins = jax_sketch_compact(jnp.asarray(codes_np), jnp.asarray(lens_np),
                              idx.k, idx.w, 128)
    anchors = jax_collect_anchors(
        mins, jnp.asarray(lens_np), dev.key_hi, dev.key_lo, dev.offcnt,
        dev.pos_rp, jnp.int32(dev.n_keys), jnp.int32(opt.mid_occ), 256,
        idx.k, hash_rows=dev.hash_rows, hash_val=dev.hash_val,
        hash_bits=dev.hash_bits, hash_shift=dev.hash_shift)
    jf, jp = jax_chain_scores_block(anchors, cp, 32)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    # invalid slots' fields are the packages' own fillers: compare valid
    valid = np.asarray(anchors["valid"])
    assert valid.sum(axis=1).min() > 0
    for got, want in ((rpos, anchors["rpos"]), (rev, anchors["rev"])):
        np.testing.assert_array_equal(got.numpy()[valid],
                                      np.asarray(want)[valid])
    # every read is an exact contig slice: its best chain scores
    assert (f.amax(dim=1) > 40).all()


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        _fn, (codes, lens) = port_entry.entry()
        assert codes.device.type == lens.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_entry.entry()


def test_dryrun_multichip_on_cpu_cells(capsys):
    res = port_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert res["grid"] == (2, 2) and res["B"] == 8
    assert min(res["chain_scores"]) > 40 and min(res["ext_scores"]) > 0
    assert res["cigars"][0] == "400M"
    assert "dryrun_multichip ok" in capsys.readouterr().out
    # without devices= the grid wants four distinct cards
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="is_available|devices="):
            port_entry.dryrun_multichip(4)
