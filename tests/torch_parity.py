"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

``jax_front_end`` runs the JAX package's front end through its plain
references, with no Pallas kernel: its sketch and seed lookup, its
windowed chain DP ``ops/chain.py chain_scores`` (K1's reference, window
128) and its host chain backtrack (native ``backtrack_compact_batch``,
the path its engine takes when the device backtrack is off), on the
packed anchor stack its ``_front_end`` downloads.  ``aligner_pair`` and
``same_mappings`` hold the two packages' Aligners against each other
read by read, with the engine counters of the rare paths.
``stand_in`` is the graph caches' capture on the CPU
(models/graphs.py).
"""
import threading

import numpy as np

import jax.numpy as jnp

import mappy_rs_tpu
from mappy_rs_tpu import native as jax_native
from mappy_rs_tpu.ops.chain import ChainParams as JaxChainParams
from mappy_rs_tpu.ops.chain import chain_scores as jax_chain_scores
from mappy_rs_tpu.ops.lookup import collect_anchors_dev
from mappy_rs_tpu.ops.sketch import compress_hpc as jax_compress_hpc
from mappy_rs_tpu.ops.sketch import hpc_spans as jax_hpc_spans
from mappy_rs_tpu.ops.sketch import sketch_compact as jax_sketch_compact

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.models.graphs import Captured
from mappy_rs_tpu_torch.ops import cuda_build
from mappy_rs_tpu_torch.ops.sketch import INF_WIDE
from mappy_rs_tpu_torch.utils.seqcodes import encode
from mappy_rs_tpu_torch.utils.simulate import random_genome


class ReplayInPlace:
    """Stands in for a captured CUDA graph: replay() re-runs the
    captured function on the static inputs and writes into the static
    outputs."""

    def __init__(self, fn, outputs):
        self.fn = fn
        self.outputs = outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)


def stand_in(fn, device):
    """A capture function for the CPU: the first run's results are the
    static outputs (a real graph's aliasing: each replay overwrites the
    last one's outputs), and its kernel calls are what a replay
    launches."""
    with cuda_build.recording() as launches:
        outputs = tuple(fn())
    return Captured(ReplayInPlace(fn, outputs), outputs, 0, dict(launches))


def fields(m):
    """Every Mapping field (the strand by value: the two packages have
    their own Strand enums)."""
    return tuple(
        getattr(m, "cigar" if s == "_cig" else "strand" if s == "_strand" else s)
        for s in m.__slots__
    )


#: engine counters of the rare paths (zdrop splits, inversion rescue,
#: anchor-budget retries)
RARE_COUNTERS = ("zdrop_splits", "inv_rescues", "anchor_overflow_retries")


def aligner_pair(seq=None, fa=None, backend="auto", front_end="device",
                 **kw):
    """(the port's Aligner on the CPU, the JAX package's Aligner) of one
    genome (`seq`, or the FASTA `fa`) with the same options, extension
    backend and front end."""
    src = {"seq": seq} if fa is None else {"fn_idx_in": fa}
    tal = mappy_rs_tpu_torch.Aligner(**src, device="cpu", **kw)
    jal = mappy_rs_tpu.Aligner(**src, **kw)
    for al in (tal, jal):
        al._engine.cfg.extension_backend = backend
        al._engine.cfg.front_end_backend = front_end
    return tal, jal


def rare_counters(al) -> dict:
    c = al._engine.metrics.counters
    return {k: c.get(k, 0.0) for k in RARE_COUNTERS}


def same_mappings(tal, jal, reads, md: bool = True) -> list:
    """Each read through both Aligners' map() (cs, and MD if `md`): equal
    Mappings, and equal rare-path counters after all reads; returns the
    port's fields per read."""
    got = [[fields(m) for m in tal.map(r, cs=True, MD=md)] for r in reads]
    want = [[fields(m) for m in jal.map(r, cs=True, MD=md)] for r in reads]
    assert got == want
    assert rare_counters(tal) == rare_counters(jal)
    return got


def drain(al, payload, timeout: float = 300.0) -> dict:
    """map_batch's results by payload "i", consumed on a helper thread
    joined with a timeout: a worker that never finishes fails the test,
    not the run."""
    out, err = {}, []

    def run():
        try:
            for ms, d in al.map_batch(payload):
                out[d["i"]] = [fields(m) for m in ms]
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            err.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"map_batch did not finish within {timeout} s"
    if err:
        raise err[0]
    return out


def write_genome(path, seed: int, lens=(60_000, 110_000, 35_000, 95_000)):
    """A FASTA of seeded random contigs c0, c1, ... (unique sequence);
    returns the contigs."""
    rng = np.random.default_rng(seed)
    ctgs = [random_genome(rng, n) for n in lens]
    with open(path, "w") as fh:
        for i, c in enumerate(ctgs):
            fh.write(f">c{i}\n{c}\n")
    return ctgs


def read_batch(reads, B: int, L: int):
    """[B, L] uint8 codes padded with 4, and int32 lengths."""
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:B]):
        c = encode(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens


def jax_sketch(codes, lens, k: int, w: int, M: int, hpc: bool):
    """The JAX package's sketch_compact, compressing first for HPC as
    its engine stages a batch."""
    if not hpc:
        return jax_sketch_compact(jnp.asarray(codes), jnp.asarray(lens),
                                  k, w, M)
    cc, cl, run_end, run_len = jax_compress_hpc(codes, lens)
    spans = jax_hpc_spans(run_len, k)
    return jax_sketch_compact(
        jnp.asarray(cc), jnp.asarray(cl), k, w, M,
        force_inf=jnp.asarray(spans >= 256), pos_map=jnp.asarray(run_end),
        spans=jnp.asarray(spans))


def port_key(jax_out, k: int) -> np.ndarray:
    """The JAX sketch's (hi, lo) key words as the port's int64 key: one
    word while 2k <= 32, else the wide key with the (0xFFFFFFFF,
    0xFFFFFFFF) sentinel as INF_WIDE."""
    hi = np.asarray(jax_out["key_hi"]).astype(np.int64)
    lo = np.asarray(jax_out["key_lo"]).astype(np.int64)
    key = (hi << 32) | lo
    if 2 * k > 32:
        key = np.where((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF), INF_WIDE, key)
    return key


def jax_front_end(jeng, codes, lens, M: int, A: int, bt_cuts: int,
                  chain_params):
    """(chains [B, 8, 9 + 2*bt_cuts], aux [2, B] = (rep_len, n_raw)) of
    the JAX package's engine `jeng` on one [B, L] batch."""
    k, w = jeng.index.k, jeng.index.w
    od, mmo = jeng._seed_select_params()
    mins = jax_sketch(codes, lens, k, w, M, bool(jeng.index.flag & 0x1))
    an = collect_anchors_dev(jeng.dev, mins, jnp.asarray(lens),
                             jeng.opt.mid_occ, A, k,
                             float(jeng.opt.q_occ_frac), od, mmo)
    f, p = jax_chain_scores(an, JaxChainParams(*chain_params), 128)
    meta = ((np.asarray(an["rev"]).astype(np.int32) << 30)
            | (np.asarray(an["valid"]).astype(np.int32) << 29)
            | (np.clip(np.asarray(an["span"]), 0, 255).astype(np.int32) << 21)
            | np.asarray(an["rid"]).astype(np.int32))
    arr = np.stack([meta, np.asarray(an["rpos"]), np.asarray(an["qpos"]),
                    np.asarray(f), np.asarray(p)]).astype(np.int32)
    chains = jax_native.backtrack_compact_batch(
        arr, jeng.opt.min_cnt, jeng.opt.min_chain_score,
        jeng.cfg.backtrack_k, bt_cuts, jeng.SEG_LEN)
    aux = np.stack([np.asarray(an["rep_len"]), np.asarray(an["n_raw"])])
    return chains, aux
