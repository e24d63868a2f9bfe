"""The port's concordance sweep (mappy_rs_tpu_torch/tools/concordance.py)
on the CPU, and its two front ends held against the JAX package.

The sweep maps each preset's workload through the port's two front ends
(torch ops + K1 + K2, and the native C++ of native/src/front_end.cc),
which share no code; full-hit-tuple agreement is the stand-in for a
minimap2 oracle.  The bars are tests/test_concordance.py's, at its N =
250 per preset.  Then, on 32 reads of each workload: the native front
end's Mappings equal the JAX package's (the same C++ behind both), and
the device front end's chain table on one [B, L] batch equals the JAX
package's window-128 reference (``tests/torch_parity.py``
``jax_front_end``).
"""
import numpy as np
import pytest
import torch

from mappy_rs_tpu import native as jax_native
from mappy_rs_tpu.config import MM_F_RMQ as JAX_MM_F_RMQ

from mappy_rs_tpu_torch import native
from mappy_rs_tpu_torch.config import MM_F_RMQ
from mappy_rs_tpu_torch.models.pipeline import front_end_bt, front_end_chain
from mappy_rs_tpu_torch.tools.concordance import (PRESET_WORKLOADS,
                                                  run_preset, workload)

from torch_parity import aligner_pair, jax_front_end, read_batch, same_mappings

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="the sweep's CPU front end is the native library")

N_PER_PRESET = 250
N_PARITY = 32


@pytest.mark.parametrize("preset", list(PRESET_WORKLOADS))
def test_front_end_concordance(preset):
    s = run_preset(preset, N_PER_PRESET, device="cpu")
    assert s["both_mapped"] >= 0.93 * N_PER_PRESET, s
    assert s["one_side_only"] <= 0.02 * N_PER_PRESET, s
    assert s["full"] >= 0.95 * s["both_mapped"], (
        f"{preset}: full-tuple {s['full']}/{s['both_mapped']}; "
        f"first diffs: {s['diffs'][:2]}")
    assert s["coords"] >= 0.98 * s["both_mapped"], (
        f"{preset}: coords {s['coords']}/{s['both_mapped']}; "
        f"first diffs: {s['diffs'][:2]}")


def _pair(preset, front_end):
    genome, reads = workload(preset, N_PARITY)
    tal, jal = aligner_pair(seq=genome, preset=preset, backend="host",
                            front_end=front_end)
    if preset == "asm5":  # as the sweep runs it
        tal._engine.opt.flag &= ~MM_F_RMQ
        jal._engine.opt.flag &= ~JAX_MM_F_RMQ
    return tal, jal, reads


@pytest.mark.parametrize("preset", list(PRESET_WORKLOADS))
def test_native_front_end_matches_jax(preset):
    tal, jal, reads = _pair(preset, "cpu")
    got = same_mappings(tal, jal, reads)
    assert sum(1 for ms in got if ms) >= 0.9 * len(reads)


@pytest.mark.parametrize("preset", list(PRESET_WORKLOADS))
def test_device_front_end_chain_table_matches_jax(preset):
    """K1 and the host backtrack (the port's path where K2 cannot hold a
    batch) give the JAX reference's chain table exactly.  K2 walks at
    most K candidate ends and writes each kept chain at its walk's row
    (a rejected walk leaves a -1 row), where the host backtrack walks on
    until K chains are kept, as the JAX package's Pallas K2 and its
    host backtrack differ; so K2's kept rows are the host table's
    first rows."""
    tal, jal, reads = _pair(preset, "device")
    eng = tal._engine
    L = eng._bucket_len(max(len(r) for r in reads))
    B, M, A = eng.fe_shapes(L, b_real=len(reads))
    cuts = min(8, L // eng.SEG_LEN)
    codes, lens = read_batch(reads, B, L)
    codes_t, lens_t = torch.from_numpy(codes), torch.from_numpy(lens)
    kw = eng._fe_kwargs(M, A, cuts)
    chains, aux = front_end_bt(codes_t, lens_t, eng.dev, **kw)
    bt = {n: kw.pop(n) for n in ("bt_k", "bt_cuts", "min_cnt", "min_sc")}
    stack, _ = front_end_chain(codes_t, lens_t, eng.dev, **kw)
    host = native.backtrack_compact_batch(
        stack.numpy(), bt["min_cnt"], bt["min_sc"], bt["bt_k"], cuts,
        eng.SEG_LEN)
    want, jaux = jax_front_end(jal._engine, codes, lens, M, A, cuts,
                               eng._chain_params)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(aux.numpy(), jaux)
    c = chains.numpy()
    for b in range(B):
        kept = c[b][c[b, :, 0] >= 0]
        np.testing.assert_array_equal(kept, host[b, : len(kept)])
    assert (c[: len(reads), 0, 0] >= 0).mean() >= 0.9
