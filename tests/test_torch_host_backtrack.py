"""Batches whose anchor budget kernel K2 cannot hold: the front end runs
through K1 only, and the chains are backtracked on the host (native
backtrack_compact_batch) into the same chain table.

On the card K2 refuses A > 1,858,560 (its shared-memory bitmask,
ops/backtrack.py backtrack_fits); the engine's gate is the same on the
CPU, so these tests make backtrack_fits refuse at a small A, and the
mappings must equal both the K2 path's and the JAX package's.
``cfg.device_backtrack = "off"`` takes the host backtrack for every
batch.
"""
import numpy as np
import pytest
import torch

import mappy_rs_tpu

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.models import pipeline
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

from torch_parity import fields

# one intra-op thread per test process (the suite runs several workers)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    seg = random_genome(rng, 600)
    g = random_genome(rng, 100_000) + seg * 40 + random_genome(rng, 100_000)
    reads, _ = simulate(rng, g[:100_000], 12, 1000, 0.05)
    reads.append(g[5000:5600] + random_genome(rng, 400) + g[6000:6600])
    reads.append(seg)  # overflows A=256, then 1,024: retried at 4,096
    return g, reads


def _aligner(g):
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al._config.device_batch_size = 32
    return al


def _map(al, reads):
    return [[fields(m) for m in al._to_mappings(r)]
            for r in al._engine.map_batch(reads, cs=True, md=True)]


@pytest.fixture
def k2_calls(monkeypatch):
    """The anchor budget A of every K2 call the engine makes."""
    calls = []
    real = pipeline.backtrack_chains

    def spy(anchors, f, *args):
        calls.append(f.shape[1])
        return real(anchors, f, *args)

    monkeypatch.setattr(pipeline, "backtrack_chains", spy)
    return calls


@pytest.fixture(scope="module")
def k2_path(data):
    g, reads = data
    al = _aligner(g)
    out = _map(al, reads)
    m = al.metrics
    assert m.get("host_bt_batches", 0) == 0
    assert m.get("anchor_overflow_retries", 0) >= 2
    return out


def test_k2_path_matches_jax(data, k2_path):
    g, reads = data
    jal = mappy_rs_tpu.Aligner(seq=g)
    jal._config.device_batch_size = 32
    assert k2_path == _map(jal, reads)
    assert all(k2_path[:12])


def test_k2_refusal_maps_through_host_backtrack(data, k2_path, k2_calls,
                                                monkeypatch):
    """K2 refuses A >= 1,024: the overflow read's two retries (A = 1,024
    and 4,096) take K1 and the host backtrack, and no ValueError is
    raised while K1 takes the budget.  The first passes (the 1,024
    bucket at A = 256, the chimera's 2,048 bucket at A = 512) stay on
    K2."""
    monkeypatch.setattr(pipeline, "backtrack_fits", lambda A: A < 1024)
    g, reads = data
    al = _aligner(g)
    assert _map(al, reads) == k2_path
    m = al.metrics
    assert m["host_bt_batches"] == 2
    assert m["fe_batches"] == 4
    assert sorted(k2_calls) == [256, 512]


def test_device_backtrack_off_matches_auto(data, k2_path, k2_calls):
    g, reads = data
    al = _aligner(g)
    al._engine.cfg.device_backtrack = "off"
    assert _map(al, reads) == k2_path
    m = al.metrics
    assert m["host_bt_batches"] == m["fe_batches"] == 4
    assert k2_calls == []
    al._engine.cfg.device_backtrack = "sometimes"
    with pytest.raises(ValueError, match="device_backtrack"):
        al._engine.map_batch(reads[:1])


@pytest.mark.parametrize("a_boost", [1, 4])
def test_host_backtrack_chain_table_equals_k2(data, a_boost):
    """fe_submit / fe_collect: the host backtrack's chain table, from the
    anchors trimmed to the widest read's, equals K2's exactly."""
    assert native.available()
    g, reads = data
    eng = _aligner(g)._engine
    codes = [native.encode(r) for r in reads if len(r) <= 1024]
    assert len(codes) == len(reads) - 1  # all but the chimera
    got = {}
    for mode in ("on", "off"):
        eng.cfg.device_backtrack = mode
        got[mode] = eng.fe_collect(eng.fe_submit(codes, 1024, a_boost))
    for a, b in zip(got["on"], got["off"]):
        np.testing.assert_array_equal(a, b)
    chains = got["on"][0]
    assert chains.shape == (len(codes), 8, 9 + 2 * 2)
    assert (chains[:, 0, 0] >= 0).all()
