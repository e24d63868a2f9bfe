"""Public API of the port: the mappy-rs drop-in surface on torch.

Mirrors the reference module layer (SURVEY.md §2a; /root/reference/src/
lib.rs) class-for-class and message-for-message:

  Aligner                  lib.rs:287-671
  Mapping (+ all aliases)  lib.rs:106-285
  Strand                   lib.rs:24-74
  AlignmentBatchResultIter lib.rs:922-992 (runtime/batch.py)

Two reference NotImplementedErrors are implemented here instead
(capability superset): ``seq=`` (index from an in-memory sequence,
lib.rs:388-390) and ``fn_idx_out=`` (.mmi writing, lib.rs:391-394).
``seq2=`` remains NotImplementedError, matching lib.rs:477-480.

Same classes, constructor kwargs and error strings as the JAX package's
api.py, plus one kwarg: ``device`` (AlignerConfig.device, default
"cuda"), where the front end and the index tensors live.  "cuda"
without a card raises; the port never moves to the CPU quietly.  The
multi-device entry points ``enable_mesh`` and ``enable_sharding`` (which
``map_batch_positions`` needs) take one more keyword than the JAX
package's, ``devices=``: the device of each cell of the grid
(parallel/mesh.py ``make_mesh``; default n_data * n_index distinct
cards).
"""
from __future__ import annotations

import enum
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import (
    INT32_MAX,
    MM_F_CIGAR,
    MM_F_NO_PRINT_2ND,
    AlignerConfig,
    set_opt,
)
from .index.build import build_index, load_or_build
from .index.index import MinimizerIndex, resolve_device
from .index.mmi import save_mmi
from .models.pipeline import AlignmentEngine
from .ops.regions import Region
from .runtime.batch import AlignmentBatchResultIter, WorkerPool

CIGAR_CHARS = "MIDNSHP=X"
#: MB of CUDA-graph pools that decision mode keeps cached.  It captures
#: one graph per row and batch shape (about 2 MB per read of the row at
#: L = 1,024), and a readfish stream's batch sizes vary, so the least
#: recently used shapes leave the cache past this (models/graphs.py).
DEC_GRAPH_BUDGET_MB = 4096


class Strand(enum.Enum):
    """Forward/Reverse strand (lib.rs:24-74)."""

    Forward = 0
    Reverse = 1

    def __str__(self) -> str:
        return "+" if self is Strand.Forward else "-"


class Mapping:
    """One alignment hit, attribute-compatible with the reference's
    Mapping and (through the aliases) with mappy.Alignment."""

    __slots__ = (
        "query_start",
        "query_end",
        "_strand",
        "target_name",
        "target_len",
        "target_start",
        "target_end",
        "match_len",
        "block_len",
        "mapq",
        "is_primary",
        "_cig",
        "NM",
        "MD",
        "cs",
        "trans_strand",
    )

    def __init__(
        self,
        query_start: int,
        query_end: int,
        strand: Strand,
        target_name: str,
        target_len: int,
        target_start: int,
        target_end: int,
        match_len: int,
        block_len: int,
        mapq: int,
        is_primary: bool,
        cigar: List[Tuple[int, int]],
        NM: int,
        MD: Optional[str] = None,
        cs: Optional[str] = None,
        trans_strand: int = 0,
    ):
        self.query_start = query_start
        self.query_end = query_end
        self._strand = strand
        self.target_name = target_name
        self.target_len = target_len
        self.target_start = target_start
        self.target_end = target_end
        self.match_len = match_len
        self.block_len = block_len
        self.mapq = mapq
        self.is_primary = is_primary
        self._cig = cigar
        self.NM = NM
        self.MD = MD
        self.cs = cs
        # transcript strand from splice mode (+1/-1, 0 = none found).
        # mappy.Alignment exposes this field; the reference's Mapping
        # does not carry it, so it is a documented superset here.
        self.trans_strand = trans_strand

    @property
    def cigar(self) -> List[Tuple[int, int]]:
        """[(n, op)] list, unpacked lazily: the engine hands CIGARs
        over as packed int32 arrays (cheap to build, cheap to pickle
        across the worker-process pipe) and most consumers — PAF
        emitters, coordinate users — never touch per-op tuples."""
        c = self._cig
        if c is None:
            c = []
            self._cig = c
        elif isinstance(c, np.ndarray):
            # only packed int32 arrays unpack; any other iterable the
            # caller set (tuple of (n, op) pairs, generator output, …)
            # passes through as a list unchanged
            from .ops.cigar import unpack_ops

            c = unpack_ops(c)
            self._cig = c
        elif type(c) is not list:
            c = list(c)
            self._cig = c
        return c

    @cigar.setter
    def cigar(self, value) -> None:
        self._cig = value

    # --- mappy-compatible aliases (lib.rs:195-284) ---------------------
    @property
    def strand(self) -> int:
        return 1 if self._strand is Strand.Forward else -1

    @property
    def ctg(self) -> str:
        return self.target_name

    @property
    def ctg_len(self) -> int:
        return self.target_len

    @property
    def r_st(self) -> int:
        return self.target_start

    @property
    def r_en(self) -> int:
        return self.target_end

    @property
    def q_st(self) -> int:
        return self.query_start

    @property
    def q_en(self) -> int:
        return self.query_end

    @property
    def blen(self) -> int:
        return self.block_len

    @property
    def mlen(self) -> int:
        return self.match_len

    @property
    def cigar_str(self) -> str:
        out = []
        for n, op in self.cigar:
            if not 0 <= op < len(CIGAR_CHARS):
                raise ValueError(f"Invalid CIGAR code `{op}`")
            out.append(f"{n}{CIGAR_CHARS[op]}")
        return "".join(out)

    def __str__(self) -> str:
        # PAF-formatted record sans query name/len (lib.rs:156-180)
        tp = "tp:A:P" if self.is_primary else "tp:A:S"
        return (
            f"{self.query_start}\t{self.query_end}\t{self._strand}\t"
            f"{self.target_name}\t{self.target_len}\t{self.target_start}\t"
            f"{self.target_end}\t{self.match_len}\t{self.block_len}\t"
            f"{self.mapq}\t{tp}\tcg:Z:{self.cigar_str}"
        )

    def __repr__(self) -> str:
        return (
            f"Mapping {{ query_start: {self.query_start}, query_end: "
            f"{self.query_end}, strand: {self._strand.name}, target_name: "
            f"{self.target_name!r}, target_len: {self.target_len}, "
            f"target_start: {self.target_start}, target_end: "
            f"{self.target_end}, match_len: {self.match_len}, block_len: "
            f"{self.block_len}, mapq: {self.mapq}, is_primary: "
            f"{self.is_primary}, NM: {self.NM} }}"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Mapping):
            return NotImplemented
        return all(
            getattr(self, "cigar" if s == "_cig" else s)
            == getattr(other, "cigar" if s == "_cig" else s)
            for s in self.__slots__
        )

    def __reduce__(self):
        # flat-tuple pickling, cheaper than the default slots protocol
        # for Mappings crossing a process pipe once per hit.
        # The strand travels as its int value (enum members pickle by
        # costly name lookup).
        state = [getattr(self, s) for s in self.__slots__]
        v = state[_STRAND_IDX]
        state[_STRAND_IDX] = getattr(v, "value", v)
        return (_mk_mapping, tuple(state))


_STRAND_IDX = Mapping.__slots__.index("_strand")


def _mk_mapping(*state) -> "Mapping":
    m = Mapping.__new__(Mapping)
    for s, v in zip(Mapping.__slots__, state):
        setattr(m, s, v)
    m._strand = Strand(m._strand)
    return m


class Aligner:
    """minimap2-class aligner, mappy/mappy-rs constructor surface
    (lib.rs:307-436)."""

    def __init__(
        self,
        fn_idx_in: Optional[str] = None,
        preset: Optional[str] = None,
        k: Optional[int] = None,
        w: Optional[int] = None,
        min_cnt: Optional[int] = None,
        min_chain_score: Optional[int] = None,
        min_dp_score: Optional[int] = None,
        bw: Optional[int] = None,
        best_n: Optional[int] = None,
        n_threads: int = 3,
        fn_idx_out: Optional[str] = None,
        max_frag_len: Optional[int] = None,
        extra_flags: Optional[int] = None,
        seq: Optional[str] = None,
        scoring: Optional[Sequence[int]] = None,
        device: str = "cuda",
    ):
        resolve_device(device)  # fail before any index work
        idx_opt, map_opt = set_opt(preset)
        # drop-in mappy compatibility: always produce CIGARs (lib.rs:339)
        map_opt.flag |= MM_F_CIGAR
        if k is not None:
            idx_opt.k = k
        if w is not None:
            idx_opt.w = w
        if min_cnt is not None:
            map_opt.min_cnt = min_cnt
        if min_chain_score is not None:
            map_opt.min_chain_score = min_chain_score
        if min_dp_score is not None:
            map_opt.min_dp_max = min_dp_score
        if bw is not None:
            map_opt.bw = bw
        if best_n is not None:
            map_opt.best_n = best_n
        if max_frag_len is not None:
            map_opt.max_frag_len = max_frag_len
        if extra_flags is not None:
            map_opt.flag |= extra_flags
        if scoring is not None and len(scoring) >= 4:
            map_opt.a, map_opt.b = int(scoring[0]), int(scoring[1])
            map_opt.q = map_opt.q2 = int(scoring[2])
            map_opt.e = map_opt.e2 = int(scoring[3])
            if len(scoring) >= 6:
                map_opt.q2, map_opt.e2 = int(scoring[4]), int(scoring[5])
                if len(scoring) >= 7:
                    map_opt.sc_ambi = int(scoring[6])

        if seq is not None:
            index = build_index([("N/A", seq)], idx_opt, device=device)
        elif fn_idx_in is not None:
            if not os.path.exists(str(fn_idx_in)):
                raise RuntimeError("Did not create or open an index")
            index = load_or_build(str(fn_idx_in), idx_opt, device=device)
        else:
            raise RuntimeError("Did not create or open an index")
        if fn_idx_out is not None:
            save_mmi(str(fn_idx_out), index.to_raw())
        self._attach(index, idx_opt, map_opt, preset, device)

    @classmethod
    def _from_index(cls, index: MinimizerIndex, preset: Optional[str] = None,
                    device: str = "cuda") -> "Aligner":
        """An Aligner around a prebuilt index with the preset's options
        (a multi-Gbp genome through ``seq=`` would be one string)."""
        resolve_device(device)
        idx_opt, map_opt = set_opt(preset)
        map_opt.flag |= MM_F_CIGAR
        al = cls.__new__(cls)
        al._attach(index, idx_opt, map_opt, preset, device)
        return al

    def _attach(self, index, idx_opt, map_opt, preset, device) -> None:
        """The engine and runtime state around `index`: the constructor's
        last step, shared with _from_index."""
        index.update_map_options(map_opt)
        self._index = index
        self._map_opt = map_opt
        self._idx_opt = idx_opt
        self._config = AlignerConfig(
            idx_opt=idx_opt, map_opt=map_opt, preset=preset, device=device
        )
        self._engine = AlignmentEngine(index, map_opt, self._config)
        self._engine_lock = threading.Lock()
        self._pool: Optional[WorkerPool] = None
        self._procs = None
        self.n_threads = 0

    @property
    def metrics(self) -> Dict[str, float]:
        """Engine observability: counters (reads, DP cells, front-end
        batches, graph captures, the native post-chain's thread CPU
        seconds ``cpu_post_chain_s``, ...) and per-stage sums of thread
        seconds and calls (``time_<stage>_s``, ``calls_<stage>``;
        utils/metrics.py).  In multi-process mode the children's
        counters are summed into the parent's snapshot."""
        snap = self._engine.metrics.snapshot()
        if self._procs is not None:
            for child in self._procs.metrics():
                for k, v in child.items():
                    if isinstance(v, (int, float)):
                        snap[k] = snap.get(k, 0) + v
            # the stage times above are seconds summed over every process
            # and its threads, not wall time; the divisor for a
            # per-process view travels with the snapshot
            snap["worker_procs"] = self._procs.n_procs
        return snap

    def enable_timeline(self, on: bool = True) -> None:
        """Keep the threads' worker states (utils/metrics.py ``STATES``)
        on a timeline, each thread's last ``TIMELINE_RECORDS``, for
        span_events; False switches it off and drops the records.  Off
        by default; in multi-process mode the parent's threads only."""
        self._engine.metrics.set_timeline(on)

    def span_events(self, base_ns: int = 0) -> List[dict]:
        """The timeline's records as Chrome-trace events on
        torch.profiler's clock (utils/metrics.py
        ``EngineMetrics.span_events``): append them to a trace's
        ``traceEvents``, with `base_ns` its ``baseTimeNanoseconds``, to
        name what the host did in the card's idle gaps.  Empty while the
        timeline is off (enable_timeline)."""
        return self._engine.metrics.span_events(base_ns)

    def probe_front_end(self, n: int = 10) -> list:
        """Front-end seconds per batch from re-dispatching the last
        batch n times: [pipelined, blocking] (AlignmentEngine.
        probe_front_end).  In multi-process mode the engine that ran the
        front ends answers: the parent's under "device_owner", child
        0's under "classic".  [] before any batch."""
        if self._procs is not None:
            return self._procs.probe_front_end(n)
        return self._engine.probe_front_end(n)

    def front_end_roofline(self) -> dict:
        """Integer-op and memory-byte cost model of one front-end batch
        (AlignmentEngine.front_end_roofline), from the same engine as
        probe_front_end.  {} before any batch."""
        if self._procs is not None:
            return self._procs.front_end_roofline()
        return self._engine.front_end_roofline()

    def reset_metrics(self) -> None:
        """Zero all engine counters/timers, every worker process's too
        (call after warmup() so the metrics reflect steady-state mapping
        only)."""
        self._engine.metrics.reset()
        if self._procs is not None:
            self._procs.reset_metrics()

    # --- introspection (lib.rs:438-459, 650-670) -----------------------
    def __bool__(self) -> bool:
        return self._index is not None

    @property
    def k(self) -> int:
        return self._index.k

    @property
    def w(self) -> int:
        return self._index.w

    @property
    def n_seq(self) -> int:
        return self._index.n_seq

    @property
    def seq_names(self) -> List[str]:
        if self._index is None:
            raise RuntimeError("Index hasn't loaded")
        return list(self._index.seq_names)

    def seq(
        self, name: str, start: int = 0, end: int = INT32_MAX
    ) -> Optional[str]:
        """Subsequence fetch; None on any error (lib.rs:461-470)."""
        try:
            return self._index.get_seq(name, start, end)
        except Exception:  # noqa: BLE001 — reference maps all errors to None
            return None

    # --- single-read path (lib.rs:472-514) -----------------------------
    def map(
        self,
        seq: str,
        seq2: Optional[str] = None,
        cs: bool = False,
        MD: bool = False,
    ) -> List[Mapping]:
        if seq2 is not None:
            raise NotImplementedError("Using `seq2` is not implemented")
        regions = self._engine.map_batch([seq], cs=cs, md=MD)[0]
        return self._to_mappings(regions)

    def map_no_op(
        self,
        _seq: str,
        seq2: Optional[str] = None,
        _cs: bool = False,
        _MD: bool = False,
    ) -> List[Mapping]:
        """Diagnostic no-op path returning a fixed dummy Mapping —
        measures binding overhead without alignment (lib.rs:516-533)."""
        if seq2 is not None:
            raise NotImplementedError("Using `seq2` is not implemented")
        return [
            Mapping(
                query_start=0,
                query_end=1000,
                strand=Strand.Forward,
                target_name="Hello",
                target_len=101010,
                target_start=10,
                target_end=1010,
                match_len=1000,
                block_len=1000,
                mapq=60,
                is_primary=True,
                cigar=[],
                NM=0,
                MD=None,
                cs="Cigar string",
            )
        ]

    # --- threaded streaming path (lib.rs:535-648, 768-906) -------------
    def enable_threading(self, n_threads: int) -> None:
        """Spin up the persistent worker pool.

        With ``config.worker_processes > 0`` (or MAPPY_RS_TPU_PROCS) the
        pool's workers become proxies to that many spawned child
        processes (runtime/procpool.py "classic", runtime/devowner.py
        "device_owner", chosen by ``config.topology``): the same queueing
        contract, with the post-chain's Python and C++ scaling past the
        interpreter lock.  Falls back to in-process threads, with a line
        on stderr, if the children fail to start."""
        self.n_threads = n_threads
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._procs is not None:
            self._procs.shutdown()
            self._procs = None
        if n_threads <= 0:
            return
        n_procs = self._config.worker_processes
        if n_procs > 0:
            topology = self._config.topology
            if topology not in ("classic", "device_owner"):
                raise ValueError(f"unknown topology {topology!r}")
            procs = None
            try:
                if topology == "device_owner":
                    from .runtime.devowner import DevOwnerMapper

                    procs = DevOwnerMapper(n_procs, self._engine, self._index,
                                           self._map_opt, self._config)
                else:
                    from .runtime.procpool import ProcMapper

                    procs = ProcMapper(n_procs, self._index, self._map_opt,
                                       self._config)
                if not procs.wait_ready():
                    raise RuntimeError("a worker process failed to start")
            except Exception as exc:  # noqa: BLE001 — degrade, don't die
                print(
                    f"mappy_rs_tpu_torch: worker processes unavailable "
                    f"({exc}); falling back to threads",
                    file=sys.stderr,
                )
                if procs is not None:
                    procs.shutdown()
                procs = None
            if procs is not None:
                self._procs = procs
                self._pool = WorkerPool(
                    n_threads,
                    [procs.map_fn(i) for i in range(n_threads)],
                    batch_size=self._config.proc_chunk,
                    metrics=self._engine.metrics,
                )
                return
        self._pool = WorkerPool(
            n_threads,
            self._threaded_map,
            # one device chunk per drain
            batch_size=self._config.device_batch_size,
            metrics=self._engine.metrics,
        )

    def warmup(self, seqs: List[str]) -> None:
        """Pay one-time costs (kernel build, device index upload, and
        on the card the capture of the chunk's front-end CUDA graphs, one
        per batch shape it meets) up front by mapping a representative
        chunk; in multi-process mode through every worker process (the
        streaming queue alone would let one warm child take the whole
        chunk).  Optional: the first real batch of each shape triggers
        the same work lazily."""
        if self._procs is not None:
            self._procs.warmup(list(seqs))
        else:
            self._engine.map_batch(list(seqs), cs=True, md=False)

    def _threaded_map(self, seqs: List[str]) -> List[List[Mapping]]:
        # threaded path hard-codes cs=True, MD=False (lib.rs:587-592).
        # Identical reads within a device batch are mapped once and
        # fanned back out (adaptive-sampling streams re-see sequences).
        # NB: no engine-wide lock — the engine is stateless per call
        # (thread-safe metrics, a thread-safe cache of front-end CUDA
        # graphs with one lock per graph), so one worker's
        # host-side extension overlaps another's device front-end.
        uniq: Dict[str, List[Mapping]] = {}
        keys = [s for s in dict.fromkeys(seqs)]
        regs = self._engine.map_batch(keys, cs=True, md=False)
        for s, r in zip(keys, regs):
            uniq[s] = self._to_mappings(r)
        return [uniq[s] for s in seqs]

    # --- multi-device full pipeline (no reference analogue) -----------
    def enable_mesh(self, n_data: int = 0, n_index: int = 1,
                    devices=None) -> None:
        """Run the full-CIGAR `map`/`map_batch` pipeline data-parallel
        over `n_data` devices (default: all).  The device front end
        (sketch -> seed -> chain) runs on each "data" row's slice of a
        batch; with ``n_index > 1`` the key/position tables are
        additionally SHARDED into key ranges over an "index" axis
        (nothing reference-sized replicated), merged with an all_gather
        before chaining.  Host finalization is unchanged, so mappings
        are the single device's.  `devices` names the grid's devices
        (parallel/mesh.py make_mesh).  For key-range index sharding in
        decision mode see :meth:`enable_sharding`."""
        self._engine.enable_mesh(n_data, n_index, devices)

    # --- multi-device decision mode (no reference analogue) -----------
    def enable_sharding(self, n_data: int = 0, n_index: int = 1,
                        devices=None) -> None:
        """Shard this aligner across a device grid: reads run
        data-parallel over `n_data` rows while the minimizer key table
        is sharded by key range over `n_index` devices per row, with
        per-shard anchors merged by an all_gather before chaining.
        `devices` names the grid's devices (parallel/mesh.py make_mesh).

        Enables :meth:`map_batch_positions`, the device-only
        position/score fast path (readfish-style decisions without
        CIGARs).  On the card each row whose cells sit on one device
        runs a batch as one CUDA graph replay (one capture per row and
        batch shape, DEC_GRAPH_BUDGET_MB of them cached; engine counters
        ``dec_graph_*``); a row spanning several cards runs its ops
        eagerly."""
        from .models.graphs import GraphCache
        from .parallel.mesh import (device_shards, make_mesh, rows_of,
                                    shard_index_by_key_range)

        n_data = rows_of(n_data, n_index, devices)
        self._mesh = make_mesh(n_data, n_index, devices)
        # the decision steps' graphs, one per (row, B_row, L), for the
        # rows of self._mesh.graph_rows (none on the CPU), their pools
        # bounded by DEC_GRAPH_BUDGET_MB.  Private: a caller sets None
        # (before the first batch of an L) only to compare with the
        # eager path.
        self._dec_graphs = GraphCache(self._engine.metrics, "dec_graph",
                                      budget_mb=DEC_GRAPH_BUDGET_MB)
        self._shards_np = device_shards(
            shard_index_by_key_range(self._index, n_index))
        self._shards_dev = None
        self._sharded_steps: Dict[int, Any] = {}
        self._n_data = n_data
        self._n_index = n_index

    def map_batch_positions(self, seqs: Sequence[str]) -> List[Optional[dict]]:
        """Device-only mapping decisions for a batch of reads.

        Returns, per read, None (no confident chain) or a dict with
        ctg / ctg_len / strand (+1/-1) / r_en (approximate reference
        END of the best chain) / chain_score / ext_score.  Requires
        :meth:`enable_sharding` first."""
        from .ops.chain import ChainParams
        from .ops.extend import ExtendParams
        from .parallel.mesh import P, build_sharded_map_step
        from .parallel.multihost import (gather_results, put_global,
                                         put_global_tree,
                                         shard_specs_for_index)
        from .utils.seqcodes import encode

        if getattr(self, "_mesh", None) is None:
            raise RuntimeError(
                "Sharding not enabled on this instance. "
                "Please call `.enable_sharding()`"
            )
        codes_list = [encode(s) for s in seqs]
        max_len = max((len(c) for c in codes_list), default=1)
        L = 512
        while L < max_len:
            L <<= 1
        B = len(seqs)
        B_pad = max(((B + self._n_data - 1) // self._n_data) * self._n_data, self._n_data)
        batch = np.full((B_pad, L), 4, np.uint8)
        lens = np.zeros(B_pad, np.int32)
        for i, c in enumerate(codes_list):
            batch[i, : len(c)] = c
            lens[i] = len(c)

        step = self._sharded_steps.get(L)
        if step is None:
            opt = self._map_opt
            cp = ChainParams(
                max_dist_x=opt.max_gap_ref if opt.max_gap_ref >= 0 else opt.max_gap,
                max_dist_y=opt.max_gap,
                bw=opt.bw,
                q_span=self._index.k,
                chn_pen_gap=opt.chain_gap_scale * 0.01 * self._index.k,
                chn_pen_skip=opt.chain_skip_scale * 0.01 * self._index.k,
            )
            ep = ExtendParams(
                a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2, e2=opt.e2,
                sc_ambi=opt.sc_ambi,
            )
            step = build_sharded_map_step(
                self._mesh, self._index.k, self._index.w,
                max_minimizers=max(64, L // 5),
                max_anchors=max(128, L // 4),
                chain_params=cp, ext_params=ep, mid_occ=opt.mid_occ,
                chain_window=32, ext_window=128, graphs=self._dec_graphs,
            )
            self._sharded_steps[L] = step

        mesh = self._mesh
        if self._shards_dev is None:
            self._shards_dev = put_global_tree(
                self._shards_np, mesh, shard_specs_for_index())
        out = gather_results(step(
            put_global(batch, mesh, P("data", None)),
            put_global(lens, mesh, P("data")),
            self._shards_dev,
        ))
        cs = out["chain_score"]
        rid = out["rid"]
        rev = out["rev"]
        es = out["ext_score"]
        end_t = out["ext_end_t"]  # per-contig coordinate
        res: List[Optional[dict]] = []
        for i in range(B):
            if cs[i] < self._map_opt.min_chain_score:
                res.append(None)
                continue
            r = int(rid[i])
            res.append(
                {
                    "ctg": self._index.seq_names[r],
                    "ctg_len": int(self._index.seq_lens[r]),
                    "strand": 1 if rev[i] == 0 else -1,
                    "r_en": int(
                        min(max(end_t[i], 0), self._index.seq_lens[r])
                    ),
                    "chain_score": int(cs[i]),
                    "ext_score": int(es[i]),
                }
            )
        return res

    def setup_signal(self) -> None:
        """Install a SIGINT handler that stops the worker pool.

        Parity with the reference's ctrl-c handler (lib.rs:694-703),
        which is written but never wired up (the call at lib.rs:432 is
        commented out); here it actually works when opted into."""
        import signal

        def _handler(signum, frame):
            print("Signal intercepted")
            if self._pool is not None:
                self._pool.shutdown()
            raise KeyboardInterrupt

        signal.signal(signal.SIGINT, _handler)

    def map_batch(
        self, seqs: Any, back_off: bool = True
    ) -> AlignmentBatchResultIter:
        res = AlignmentBatchResultIter()
        res.set_n_threads(self.n_threads)
        if self.n_threads == 0 or self._pool is None:
            raise RuntimeError(
                "Multi threading not enabled on this instance. "
                "Please call `.enable_threading()`"
            )
        # the reference accepts list/tuple/iterator/sequence; a dict is
        # none of those (its PySequence extraction fails), while str is
        # a sequence whose CHAR elements then fail the dict check
        if isinstance(seqs, dict) or not (
            isinstance(seqs, (list, tuple, str, bytes))
            or hasattr(seqs, "__next__")
            or (hasattr(seqs, "__getitem__") and hasattr(seqs, "__len__"))
        ):
            raise TypeError(
                "Unsupported batch type, pass a list, iter, generator or tuple"
            )
        pool = self._pool
        # reads are pushed in blocks (one work-queue lock per run, not
        # per read); full-queue overflow falls back to the per-read
        # back-off path inside push_work_block, byte-identical.  The
        # FIRST block flushes small (64) so a slow/streaming producer
        # overlaps mapping immediately instead of idling the workers
        # until 1024 reads accumulate.
        block: List[str] = []
        start_id = 0
        flush_at = 64
        for id_num, item in enumerate(iter(seqs)):
            if not isinstance(item, dict):
                raise TypeError("Element in iterable is not a dictionary")
            res.data[id_num] = item
            if "seq" not in item:
                raise KeyError("AHHH Key 🗝️  not found in iterated dictionary")
            s = item["seq"]
            if not isinstance(s, str):
                raise ValueError("`seq` must be a string")
            block.append(s)
            if len(block) >= flush_at:
                pool.push_work_block(res, start_id, block, back_off)
                start_id = id_num + 1
                block = []
                flush_at = 1024
        if block:
            pool.push_work_block(res, start_id, block, back_off)
        pool.push_done_pills(res)
        return res

    # --- conversion -----------------------------------------------------
    def _to_mappings(self, regions: List[Region]) -> List[Mapping]:
        no_2nd = bool(self._map_opt.flag & MM_F_NO_PRINT_2ND)
        return regions_to_mappings(
            regions, self._index.seq_names, self._index.seq_lens, no_2nd
        )


def regions_to_mappings(
    regions: List[Region], seq_names, seq_lens, no_2nd: bool
) -> List[Mapping]:
    """Region -> Mapping conversion (module-level so multi-process
    worker children can produce finished Mapping objects without an
    Aligner instance)."""
    out = []
    for r in regions:
        primary = r.parent == r.id
        if no_2nd and not primary:
            continue
        out.append(
            Mapping(
                query_start=r.qs,
                query_end=r.qe,
                strand=Strand.Forward if r.rev == 0 else Strand.Reverse,
                target_name=seq_names[r.rid],
                target_len=int(seq_lens[r.rid]),
                target_start=r.rs,
                target_end=r.re,
                match_len=r.mlen,
                block_len=r.blen,
                mapq=r.mapq,
                is_primary=primary,
                # packed int32 array or [(n,op)] list — Mapping.cigar
                # unpacks lazily on first access.  List form is copied
                # so Region and Mapping never share one mutable list
                # (packed arrays are treated as immutable by every
                # consumer and skip the copy).
                cigar=(
                    list(r.cigar) if type(r.cigar) is list
                    else r.cigar if r.cigar is not None else []
                ),
                NM=r.nm,
                MD=r.md,
                cs=r.cs,
                trans_strand=getattr(r, "trans_strand", 0),
            )
        )
    return out
