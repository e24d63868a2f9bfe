"""Device-owner topology: ONE front end on the card, in the parent
process, and N CUDA-free post-chain worker processes.

The parent owns the only CUDA context and the only copy of the index
tables on the card.  Its WorkerPool proxy threads stage and dispatch
every front-end batch of a chunk through the shared engine (fe_submit:
sketch, seed lookup, K1 and K2, or K1 and the host backtrack for a
batch K2 cannot hold), collect the compact chain tables (fe_collect),
retry the reads whose seed hits overflowed the anchor budget with a 4x
and then a 16x budget, and hand the chains to a child.  The children
run the host tail (native post-chain: regions, extension, CIGAR, cs/MD,
mapq; the Python path for its fallbacks) and answer with a packed block
(runtime/pack.py).  They build their engine on the CPU with the host
extension backend and never touch the card, so under this topology one
card holds one context and one index copy however many children run,
and the children scale the Python and C++ tail past the parent's
interpreter lock.

The mappings equal the threaded path's: the children run the same
post-chain over the same chain tables (tests/test_torch_runtime.py).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np

from .procpool import ChildPool, build_kernels, serve


def _post_chunk(eng, no_2nd: bool, blob, off, chains, rep_len, cs: bool,
                md: bool):
    """A post-chain child's work: compact chains -> packed block."""
    codes = [blob[off[i]: off[i + 1]] for i in range(len(off) - 1)]
    return eng.post_chain_packed(codes, chains, rep_len, cs=cs, md=md,
                                 no_2nd=no_2nd)


def _worker_main(conn, idx_dir: str, map_opt, cfg) -> None:
    """Entry point of a spawned post-chain worker process."""
    # no CUDA device is visible to this process: a stray CUDA call fails
    # instead of creating a second context on the parent's card
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    serve(conn, idx_dir, map_opt, cfg, _post_chunk)


class DevOwnerMapper(ChildPool):
    """The device-owner topology: the parent engine's front end, and N
    post-chain children behind per-proxy map_fns."""

    #: anchor-budget ladder (as _map_bucket's a_boost * 4 retries, to 16)
    _BOOSTS = (1, 4, 16)

    def __init__(self, n_procs: int, engine, index, map_opt, cfg) -> None:
        self.engine = engine
        child_cfg = cfg.replace(
            worker_processes=0,
            device="cpu",
            front_end_backend="cpu",
            extension_backend="host",
        )
        build_kernels(child_cfg)
        super().__init__(n_procs, _worker_main, index, (map_opt, child_cfg))

    def _front_end_chunk(self, codes: List[np.ndarray]):
        """The chunk's front end in the parent: bucket, submit every
        batch (queued on the card together), collect, retry the
        anchor-overflow reads with boosted budgets.  Returns (chains
        [n, K, W], rep_len [n]) in chunk order."""
        eng = self.engine
        n = len(codes)
        K = eng.cfg.backtrack_k
        buckets: Dict[int, List[int]] = {}
        for i, c in enumerate(codes):
            buckets.setdefault(eng._bucket_len(len(c)), []).append(i)
        # the row width depends on the bucket (bt_cuts = L // SEG_LEN,
        # at most 8): pad rows to the chunk's widest with -1, which the
        # post-chain reads as unused cut slots
        W = max((9 + 2 * min(8, L // eng.SEG_LEN) for L in buckets),
                default=9)
        chains = np.full((n, K, W), -1, np.int32)
        rep_len = np.zeros(n, np.int32)
        retry = buckets
        for boost in self._BOOSTS:
            pend = []
            for L, idxs in retry.items():
                if boost > 1:
                    eng.metrics.add("anchor_overflow_retries", len(idxs))
                B, _M, A = eng.fe_shapes(L, a_boost=boost)
                for s in range(0, len(idxs), B):
                    if boost > 1:
                        eng.metrics.add(f"fe_retry_batches_x{boost}", 1)
                    sel = np.asarray(idxs[s: s + B])
                    pend.append((sel, L, A, eng.fe_submit(
                        [codes[i] for i in sel], L, a_boost=boost)))
            nxt: Dict[int, List[int]] = {}
            for sel, L, A, ticket in pend:
                ch, rl, n_raw = eng.fe_collect(ticket)
                chains[sel, :, : ch.shape[-1]] = ch
                rep_len[sel] = rl
                ov = sel[n_raw > A]
                if len(ov) and boost < self._BOOSTS[-1]:
                    nxt.setdefault(L, []).extend(ov.tolist())
            if not nxt:
                break
            retry = nxt
        return chains, rep_len

    def map_fn(self, i: int) -> Callable:
        """A WorkerPool map_fn: the front end in the parent, then one
        post-chain round trip to child i % n_procs."""
        from ..utils.seqcodes import encode
        from .pack import unpack_mappings_block

        child = self._children[i % self.n_procs]
        names, lens_ = self._seq_names, self._seq_lens

        def fn(seqs, cs: bool = True, md: bool = False):
            key_ix: Dict[str, int] = {}
            for s in seqs:
                if s not in key_ix:
                    key_ix[s] = len(key_ix)
            codes = [encode(s) for s in key_ix]
            chains, rep_len = self._front_end_chunk(codes)
            off = np.zeros(len(codes) + 1, np.int64)
            off[1:] = np.cumsum([len(c) for c in codes])
            blob = (np.concatenate(codes) if codes
                    else np.empty(0, np.uint8))
            rid = self._next_rid()
            kind, payload = child.request(
                rid,
                ("post", rid, blob, off, chains, rep_len, cs, md),
            )
            if kind != "okp":
                raise RuntimeError(f"worker process failed: {payload}")
            tables = unpack_mappings_block(payload, names, lens_)
            if len(key_ix) == len(seqs):
                return tables
            return [tables[key_ix[s]] for s in seqs]

        return fn

    def probe_front_end(self, n: int = 10) -> list:
        return self.engine.probe_front_end(n)

    def front_end_roofline(self) -> dict:
        return self.engine.front_end_roofline()
