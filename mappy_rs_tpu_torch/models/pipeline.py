"""End-to-end alignment pipeline on torch: the port's AlignmentEngine.

Drives the map path the reference reaches through
``minimap2::Aligner::map``: sketch -> seed lookup -> chaining DP ->
chain backtrack on the device (one fused front end per batch,
``front_end_bt``), then the host C++ post-chain (regions, banded
extension, CIGAR/cs/MD, mapq) on the downloaded chain table.  With
``cfg.extension_backend`` "device" or "device_dl" the banded extension
runs on the device instead (kernel K3, plus K4 for "device"), under the
Python post-chain (regions, jobs, split rounds, finalize).

Batching: reads are length-bucketed and padded so every device stage
runs on [B, L] tensors of a few static shapes.  Each bucket runs a
software pipeline of depth ``cfg.pipeline_depth``: up to depth-1 front
ends are enqueued on the card while the host finishes an earlier
batch.  A front end issues no host sync between its upload and the
download of its chain table; the download lands in pinned memory and a
CUDA event marks it complete.  An HPC index (map-pb, ava-pb) sketches
homopolymer-compressed reads: the batch is compressed on the host and
uploaded with the arrays that map it back.  Splice presets extend with
the host intron-state DP (``_run_jobs_splice``) after the same front
end, whose chain DP takes K1's splice branch.

A batch whose anchor budget kernel K2 cannot hold (and every batch
under ``cfg.device_backtrack = "off"``) runs the front end through K1
only (``front_end_chain``): the anchors with f and p are downloaded,
trimmed to the anchors present, and backtracked on the host (C++
``backtrack_compact_batch``) into the same chain table.

The process runtime (runtime/procpool.py, runtime/devowner.py) drives
the engine through ``map_batch_packed``, ``fe_submit`` / ``fe_collect``
and ``post_chain_packed``; the packed IPC block is built by a
``PackedSink`` (runtime/pack.py) that the native post-chain fills.

Over a device grid (``enable_mesh``, parallel/mesh.py) the front end
runs row by row, each data row on its slice of the batch:
``make_dp_front_end`` against the tables replicated on the row's device,
or, with the key table sharded by key range over the row's "index"
peers, ``make_sharded_front_end`` (count psum, per-shard expansion,
anchor all_gather and re-sort, K1).  Everything after the front end is
the single-device path's, so the Mappings are the same.

CUDA graphs (models/graphs.py), the JAX package's one executable per
static shape: on the card each front-end batch is one replay of the
graph of its key, and so is each grid row whose cells all sit on one
device (a row spanning several cards runs its ops eagerly: a graph
captures on one device; the layout decides at ``enable_mesh``).  Each
"device" / "device_dl" job group is one replay of the graph of its
group shape (K3 + K4, or K3).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MM_F_RMQ, MM_F_SPLICE, MM_F_SPLICE_FLANK
from ..config import MM_F_SPLICE_FOR as _MM_F_SPLICE_FOR
from ..config import MM_F_SPLICE_REV as _MM_F_SPLICE_REV
from ..config import MM_F_SR as _MM_F_SR
from ..config import AlignerConfig, MapOptions
from ..index.index import DeviceIndex, MinimizerIndex, resolve_device
from ..ops import cigar as cig
from ..ops.backtrack import backtrack_chains, backtrack_fits
from ..ops.chain import ChainParams
from ..ops.chain_kernel import chain_fits, chain_scores_kernel
from ..ops.extend import ExtendParams
from ..ops.extend_kernel import extend_dp_device, extend_traceback_device
from ..ops.lookup import (collect_anchors, expand_anchors, filter_counts,
                          probe_sorted, sort_merged)
from ..ops.regions import (
    Region,
    regions_from_compact,
    select_sub,
    set_mapq,
    set_parent,
)
from ..ops.sketch import compress_hpc, hpc_spans, sketch_compact
from ..utils.metrics import EngineMetrics
from ..utils.seqcodes import encode
from .graphs import GraphCache

# region part CIGARs are packed int32 (len<<4|op) arrays end-to-end
# (the extension engines' wire format); this is the canonical "empty"
_EMPTY_OPS = np.empty(0, np.int32)

#: bytes of K3's direction tensor one job group may hold on the device
#: (see _run_jobs)
DIRS_BUDGET = 64 << 20


def _pow2_at_least(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _pow2_at_most(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def _chained_anchors(
    codes: torch.Tensor, lens: torch.Tensor, dev: DeviceIndex, *,
    k: int, w: int, M: int, A: int, chain_params: ChainParams,
    window: int, mid_occ: int, q_occ_frac: float, occ_dist: int,
    max_max_occ: int,
    sk_lens: Optional[torch.Tensor] = None,
    force_inf: Optional[torch.Tensor] = None,
    pos_map: Optional[torch.Tensor] = None,
    spans: Optional[torch.Tensor] = None,
):
    """sketch -> seed lookup -> chain DP (kernel K1); (anchors, f, p)."""
    mins = sketch_compact(codes, lens if sk_lens is None else sk_lens, k, w,
                          M, force_inf=force_inf, pos_map=pos_map, spans=spans)
    anchors = collect_anchors(
        mins, lens, dev, mid_occ, A, k, q_occ_frac, occ_dist, max_max_occ,
    )
    f, p = chain_scores_kernel(anchors, chain_params, window)
    return anchors, f, p


def _backtracked(anchors: dict, f, p, *, bt_k: int, bt_cuts: int,
                 min_cnt: int, min_sc: int):
    """Chain backtrack (kernel K2) of a chained anchor set: (chains,
    aux = (rep_len, n_raw))."""
    chains = backtrack_chains(anchors, f, p, bt_k, bt_cuts, min_cnt, min_sc)
    return chains, torch.stack([anchors["rep_len"], anchors["n_raw"]])


def _anchor_stack(a: dict, f, p):
    """The anchors with f and p for the host backtrack: (stack [5, B, A],
    counts [3, B]); see front_end_chain."""
    meta = ((a["rev"] << 30) | (a["valid"].to(torch.int32) << 29)
            | (a["span"].clamp(0, 255) << 21) | a["rid"])
    return (torch.stack([meta, a["rpos"], a["qpos"], f, p]),
            torch.stack([a["n"], a["n_raw"], a["rep_len"]]))


def front_end_bt(codes: torch.Tensor, lens: torch.Tensor, dev: DeviceIndex,
                 *, bt_k: int, bt_cuts: int, min_cnt: int, min_sc: int,
                 **kw):
    """The fused device front end: sketch -> seed lookup -> chain DP
    (kernel K1) -> chain backtrack (kernel K2), all on the device of
    `codes` with no host sync.

    codes: uint8 [B, L] (padded with 4), lens: int32 [B].  For an HPC
    index `codes` are homopolymer-compressed, with `sk_lens` their
    lengths and `force_inf`, `pos_map`, `spans` [B, L] as
    ops/sketch.py's sketch_compact takes them; `lens` stays the
    uncompressed read lengths (the anchors' query coordinates need
    them).  `kw` are the keywords of ``_chained_anchors``.  Returns
    (chains int32 [B, bt_k, 9 + 2*bt_cuts], aux int32 [2, B] =
    (rep_len, n_raw)); n_raw > A marks reads whose seed hits
    overflowed the anchor budget."""
    return _backtracked(*_chained_anchors(codes, lens, dev, **kw), bt_k=bt_k,
                        bt_cuts=bt_cuts, min_cnt=min_cnt, min_sc=min_sc)


def front_end_chain(codes: torch.Tensor, lens: torch.Tensor,
                    dev: DeviceIndex, **kw):
    """The device front end without the backtrack (kernel K1 only), for
    batches that the host backtracks.  Same inputs as ``front_end_bt``
    less its backtrack keywords.  Returns (stack int32 [5, B, A] =
    meta, rpos, qpos, f, p with meta = rev<<30 | valid<<29 |
    min(span, 255)<<21 | rid, the layout native backtrack_compact_batch
    reads; counts int32 [3, B] = n, n_raw, rep_len).  Valid anchors
    come first in each row, so the first max(n) columns hold them all."""
    return _anchor_stack(*_chained_anchors(codes, lens, dev, **kw))


def _sketch_staged(up: dict, k: int, w: int, M: int) -> dict:
    """sketch_compact of one staged batch (stage_batch's arrays, on one
    device; HPC batches sketch their compressed codes)."""
    return sketch_compact(up["codes"], up.get("sk_lens", up["lens"]), k, w, M,
                          force_inf=up.get("force_inf"),
                          pos_map=up.get("pos_map"), spans=up.get("spans"))


def make_dp_front_end(mesh, index: MinimizerIndex):
    """Data-parallel front end over a grid of one index peer per row:
    fe(row, ups, **kw) runs ``front_end_chain`` (``front_end_bt`` when
    `kw` has the backtrack keywords) on the row's reads, against the
    lookup tables replicated on the row's device.  `ups` is {device:
    the row's staged arrays on it}; `kw` are _fe_kwargs'.  Each row
    computes exactly what the single-device front end computes on its
    reads."""

    def fe(row: int, ups: dict, **kw):
        dev = mesh.devices[row, 0]
        up = dict(ups[dev])
        codes, lens = up.pop("codes"), up.pop("lens")
        fn = front_end_bt if "bt_k" in kw else front_end_chain
        return fn(codes, lens, index.device_index(dev), **up, **kw)

    return fe


def make_sharded_front_end(mesh, shards: dict):
    """Full-CIGAR front end with the key table sharded by key range over
    each row's "index" peers (`shards`: parallel/mesh.py
    ``device_shards`` placed by ``put_global``; nothing of the index is
    replicated).  fe(row, ups, **kw) as make_dp_front_end's, per row:

    sketch; the sorted-key probe of each peer's shard; a psum of the raw
    counts (a key lies in one shard, so the sum is its global count);
    the occurrence, rescue and query-repeat filters on the global counts
    (identically on every peer); each peer's expansion of its own hits
    at a budget A_loc = max(A // n_index, 128); an all_gather of the
    anchors, n = min(psum n, A_loc * n_index), n_raw = psum n_raw; the
    re-sort (invalid slots last); kernel K1; then the anchor stack, or
    K2 with the backtrack keywords.  The merged anchors are the same on
    every peer, so the row chains them once, on its first device.  The
    anchor set is the single-device one but for tie order and the
    per-shard (not global) truncation when a read overflows its
    budget."""
    n_index = mesh.shape["index"]
    fields = ("rev", "rid", "rpos", "qpos", "span", "valid")

    def fe(row: int, ups: dict, *, k, w, M, A, chain_params, window,
           mid_occ, q_occ_frac, occ_dist, max_max_occ, **bt):
        grp = mesh.group(row)
        A_loc = max(A // n_index, 128)
        mins = {d: _sketch_staged(up, k, w, M) for d, up in ups.items()}
        sh = [{n: a.blocks[(row, c)][0] for n, a in shards.items()}
              for c in range(n_index)]
        probes = [probe_sorted(mins[d], s["keys"], s["offcnt"], s["n_keys"])
                  for d, s in zip(grp.devices, sh)]
        cnt_loc_raw = [torch.where(found, oc[..., 1].to(torch.int64), 0)
                       for found, oc in probes]
        cnt_raw = grp.psum(cnt_loc_raw)
        filt = {d: filter_counts(mins[d], ups[d]["lens"], cnt_raw[d] > 0,
                                 cnt_raw[d], mid_occ, k, q_occ_frac,
                                 occ_dist, max_max_occ)
                for d in grp.distinct}
        loc = []
        for c, d in enumerate(grp.devices):
            found, oc = probes[c]
            # kept minimizers keep their (single) owning shard's count
            cnt_loc = torch.where((filt[d][0] > 0) & found, cnt_loc_raw[c], 0)
            loc.append(expand_anchors(mins[d], ups[d]["lens"], cnt_loc,
                                      oc[..., 0], sh[c]["pos_rp"], A_loc))
        d0 = grp.devices[0]
        g = {n: grp.all_gather([a[n] for a in loc]) for n in fields}
        an = sort_merged({n: g[n][d0] for n in fields})
        an["n"] = torch.clamp(grp.psum([a["n"] for a in loc])[d0],
                              max=A_loc * n_index)
        an["n_raw"] = grp.psum([a["n_raw"] for a in loc])[d0]
        an["rep_len"] = filt[d0][1]
        f, p = chain_scores_kernel(an, chain_params, window)
        return _backtracked(an, f, p, **bt) if bt else _anchor_stack(an, f, p)

    return fe


@dataclass
class _ExtJob:
    region: Region
    kind: str  # 'left' | 'mid' | 'right'
    q: np.ndarray
    t: np.ndarray
    seg: int = 0  # segment index for multi-part mid alignments


@dataclass
class _FrontEndHandles:
    """One dispatched front end.  With K2 (`bt_cuts` None): the chain
    table and aux (rep_len, n_raw) already copied to the host (pinned
    on CUDA).  For the host backtrack: the anchor stack still on the
    device (a copy of a graph's static output, never the output
    itself), its counts (n, n_raw, rep_len) copied to the host, and the
    cuts the host backtrack records.  `done` marks the copies complete
    (None on CPU)."""

    out: torch.Tensor
    aux: torch.Tensor
    done: Optional[torch.cuda.Event]
    inputs: tuple  # staged uploads, kept alive until the batch is done
    bt_cuts: Optional[int] = None


class AlignmentEngine:
    """Batched aligner over one MinimizerIndex, front end on cfg.device."""

    def __init__(
        self,
        index: MinimizerIndex,
        opt: MapOptions,
        cfg: Optional[AlignerConfig] = None,
    ):
        self.index = index
        self.opt = opt
        self.cfg = cfg or AlignerConfig()
        self.device = resolve_device(self.cfg.device)
        self.is_splice = bool(opt.flag & MM_F_SPLICE)
        self._ext_params = ExtendParams(
            a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2, e2=opt.e2,
            sc_ambi=opt.sc_ambi,
        )
        # band width class for flank extensions
        self.flank_band = 128
        self.metrics = EngineMetrics()
        # the last front-end dispatch: (B, L, M, A), a closure that
        # re-runs it on its uploaded inputs as the path runs it
        # (probe_front_end: a graph replay on the card), and one that runs
        # its ops eagerly (tools/trace_front_end.py)
        self._probe_shape: Optional[Tuple[int, int, int, int]] = None
        self._probe_dispatch = None
        self._probe_eager = None
        # the front end's captured CUDA graphs, one per batch key (and
        # grid row), and the device extension's, one per job-group shape
        # (models/graphs.py); None runs the ops eagerly, as on the CPU.
        # Private: a caller sets None only to compare with the eager path.
        cuda = self.device.type == "cuda"
        self._fe_graphs = GraphCache(self.metrics) if cuda else None
        self._ext_graphs = (GraphCache(self.metrics, "ext_graph") if cuda
                            else None)
        # optional device grid (enable_mesh): the front end runs row by
        # row through _mesh_fe; everything downstream is unchanged
        self.mesh = None
        self._mesh_fe = None
        self._index_shards = None  # enable_mesh(n_index > 1)
        max_gap_ref = opt.max_gap_ref if opt.max_gap_ref >= 0 else opt.max_gap
        self._chain_params = ChainParams(
            max_dist_x=max_gap_ref,
            max_dist_y=opt.max_gap,
            bw=opt.bw,
            q_span=index.k,
            chn_pen_gap=opt.chain_gap_scale * 0.01 * index.k,
            chn_pen_skip=opt.chain_skip_scale * 0.01 * index.k,
            is_splice=int(self.is_splice),
        )

    # ------------------------------------------------------------------
    @property
    def dev(self) -> DeviceIndex:
        """Device index tensors, uploaded lazily on first device use."""
        return self.index.device_index(self.device)

    def map_batch(
        self, seqs: Sequence[str], cs: bool = False, md: bool = False
    ) -> List[List[Region]]:
        """Map a batch of reads; returns per-read region lists (aligned,
        mapq'd, primary-marked), best first."""
        return self._map(seqs, cs, md, None)

    def map_batch_packed(
        self, seqs: Sequence[str], cs: bool = False, md: bool = False,
        no_2nd: bool = False,
    ):
        """Map a batch straight into the packed IPC block
        (runtime/pack.py): reads that the native post-chain finishes go
        from its flat arrays into the block without Region objects.
        Equal to pack_regions_block(map_batch(seqs, cs, md), no_2nd)."""
        from ..runtime.pack import PackedSink

        sink = PackedSink(len(seqs), no_2nd)
        out = self._map(seqs, cs, md, sink)
        with self.metrics.span("finalize"):
            return sink.finish(out)

    def post_chain_packed(
        self,
        codes: List[np.ndarray],
        chains: np.ndarray,
        rep_len: np.ndarray,
        cs: bool = True,
        md: bool = False,
        no_2nd: bool = False,
    ):
        """The device-owner topology's child step: compact chains from the
        parent's front end (fe_collect) -> the finished packed block, all
        on the host (native post-chain, Python path for its fallbacks)."""
        from ..runtime.pack import PackedSink

        with self.metrics.span("map_batch"):
            self.metrics.add("reads", len(codes))
            sink = PackedSink(len(codes), no_2nd)
            out: List[List[Region]] = [[] for _ in codes]
            self._post_chain_tail(chains, rep_len, codes, out, cs, md, sink)
            with self.metrics.span("finalize"):
                return sink.finish(out)

    def _map(self, seqs: Sequence[str], cs: bool, md: bool, sink):
        out: List[List[Region]] = [[] for _ in seqs]
        with self.metrics.span("map_batch"):
            self.metrics.add("reads", len(seqs))
            with self.metrics.span("fe_stage"):
                codes = [encode(s) for s in seqs]
            # MM_F_RMQ presets need the long-gap chaining pass of the
            # native CPU front end (as in the JAX package)
            want_cpu = self.cfg.front_end_backend == "cpu" or bool(
                self.opt.flag & MM_F_RMQ
            )
            if want_cpu:
                from .. import native

                if native.available():
                    self._map_cpu(codes, out, cs, md, sink)
                    return out
            buckets = {}
            for i, c in enumerate(codes):
                buckets.setdefault(self._bucket_len(len(c)), []).append(i)
            for L, idxs in buckets.items():
                self._map_bucket(L, idxs, codes, out, cs, md, sink=sink)
        return out

    def _map_cpu(
        self,
        codes: List[np.ndarray],
        out: List[List[Region]],
        cs: bool,
        md: bool,
        sink=None,
    ) -> None:
        """Full-batch CPU mapping: native front end (sketch + lookup +
        chain + backtrack, native/front_end.cc) feeding the same
        extension/finalize pipeline.  No padding/bucketing needed —
        the scalar path is shape-free.  This is the reference-style
        CPU aligner (and the measured bench baseline)."""
        from .. import native

        od, mmo = self._seed_select_params()
        use_rmq = bool(self.opt.flag & MM_F_RMQ)
        with self.metrics.span("front_end"):
            chains, rep_len, _n_anchors = native.front_end_batch(
                self.index, codes, self.opt.mid_occ, self._chain_params,
                self.cfg.cpu_chain_max_iter, self.opt.min_cnt,
                self.opt.min_chain_score, self.cfg.backtrack_k,
                8, self.SEG_LEN, occ_dist=od, max_max_occ=mmo,
                bw_long=int(self.opt.bw_long), use_rmq=use_rmq,
            )
        self._post_chain_tail(chains, rep_len, codes, out, cs, md, sink)

    def _post_chain_tail(
        self,
        chains: np.ndarray,
        rep_len,
        codes: List[np.ndarray],
        out: List[List[Region]],
        cs: bool,
        md: bool,
        sink=None,
    ) -> None:
        """Everything after compact chains are known: fused native
        post-chain for the fast path, Python regions + extension +
        finalize for fallback reads.  Shared by _map_cpu and the
        device-owner topology's post-chain workers (post_chain_packed)."""
        fb = self._post_chain_native(
            list(range(len(codes))), chains,
            np.asarray(rep_len, np.int32), codes, out, cs, md, sink,
        )
        if fb is not None and not fb.any():
            return
        with self.metrics.span("post_chain_py"):
            self._post_chain_py(range(len(codes)), chains, rep_len, fb,
                                codes, out, cs, md)

    def _post_chain_py(self, chunk, chains, rep_len, fb,
                       codes: List[np.ndarray], out: List[List[Region]],
                       cs: bool, md: bool) -> None:
        """The Python post-chain of the reads of `chunk` (read indices;
        row i of chains and rep_len is chunk[i]) that the native one did
        not finish (`fb`: its fallback mask; None: every read): regions,
        extension jobs, zdrop splits and finalize."""
        k = self.index.k
        jobs: List[_ExtJob] = []
        read_regions: List[Tuple[int, List[Region], int]] = []
        for bi, ri in enumerate(chunk):
            if fb is not None and not fb[bi]:
                continue
            qlen = len(codes[ri])
            regions = regions_from_compact(chains[bi], qlen, k)
            set_parent(regions, self.opt.mask_level, self.opt.mask_len)
            regions = select_sub(regions, self.opt.pri_ratio, self.opt.best_n)
            read_regions.append((ri, regions, int(rep_len[bi])))
            jobs.extend(self._make_jobs(regions, codes[ri], qlen))
        self._run_jobs(jobs)
        self._run_split_rounds(read_regions, codes)
        self._finish_reads(read_regions, codes, out, cs, md)

    def _bucket_len(self, n: int) -> int:
        for b in self.cfg.length_buckets:
            if n <= b:
                return b
        return _pow2_at_least(n, self.cfg.length_buckets[-1])

    def _chain_fits(self, A: int) -> bool:
        """Whether kernel K1 takes A anchors per read at the configured
        window (the CPU's plain version takes any shape).  On the card
        K1 keeps only its window in shared memory, so every A that
        fe_shapes makes fits."""
        return self.device.type == "cpu" or chain_fits(
            A, self.cfg.pallas_chain_window)

    def _bt_enabled(self, A: int) -> bool:
        """Whether a batch of A anchors per read backtracks in kernel K2
        or on the host.  In the JAX package's order: a budget over what
        K2's shared memory holds (backtrack_fits, A <= 1,858,560) goes
        to the host; then "on" takes K2 and "off" the host; "auto" takes
        K2 except under a device grid, whose front ends hand their
        anchors to the host backtrack as the JAX package's do.  The gate
        is the same on the CPU, so the CPU runs the card's routing.  The
        JAX package's B*A > 256*1024 gate is a TPU VMEM limit and is not
        used."""
        mode = self.cfg.device_backtrack
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"unknown device_backtrack {mode!r}")
        if not backtrack_fits(A):
            return False
        if mode != "auto":
            return mode == "on"
        return self.mesh is None

    def enable_mesh(self, n_data: int = 0, n_index: int = 1,
                    devices=None) -> None:
        """Run the front end over a (n_data x n_index) device grid
        (parallel/mesh.py make_mesh; `devices` names the cells' devices,
        default n_data * n_index distinct cards).  Reads split over the
        "data" rows; with ``n_index > 1`` the key and position tables are
        sharded by key range over each row's "index" peers and the
        replicated tables are never built.  ``n_data <= 0`` takes every
        device (of `devices`, else every card) over n_index.  The host
        stages are unchanged, so the Mappings are the single device's
        (see make_sharded_front_end for the divergences under
        anchor-budget overflow)."""
        from ..parallel.mesh import (device_shards, make_mesh, rows_of,
                                     shard_index_by_key_range)
        from ..parallel.multihost import put_global_tree, shard_specs_for_index

        self.mesh = make_mesh(rows_of(n_data, n_index, devices), n_index,
                              devices)
        self._index_shards = None
        if n_index > 1:
            # the lookup tables only: the packed reference stays on the
            # host for the extension
            names = ("keys", "offcnt", "n_keys", "pos_rp")
            sh = device_shards(shard_index_by_key_range(self.index, n_index),
                               names)
            specs = shard_specs_for_index()
            self._index_shards = put_global_tree(
                sh, self.mesh, {n: specs[n] for n in names})
            self._mesh_fe = make_sharded_front_end(self.mesh,
                                                   self._index_shards)
        else:
            self._mesh_fe = make_dp_front_end(self.mesh, self.index)

    def fe_shapes(self, L: int, a_boost: int = 1, b_real: int = 0):
        """Static device-batch shapes for the L bucket: (B, M, A).
        Two batch shapes per bucket (tiny / full); full size scales
        down for long-read buckets so [B, L] tensors stay bounded."""
        w = self.index.w
        full_B = max(8, _pow2_at_least(
            max(self.cfg.device_batch_size * 1024 // L, 8)))
        full_B = min(full_B, self.cfg.device_batch_size)
        B = 8 if (
            0 < b_real <= 8 and not self.cfg.single_batch_shape
        ) else full_B
        if self.mesh is not None:  # the rows split B evenly
            nd = self.mesh.shape["data"]
            B = ((B + nd - 1) // nd) * nd
        M = max(64, L // max(w // 2, 1))
        A = max(256, int(L * self.cfg.anchors_per_base))
        A = _pow2_at_least(A) * a_boost
        return B, M, A

    def _fe_kwargs(self, M: int, A: int, bt_cuts: int) -> dict:
        od, mmo = self._seed_select_params()
        return dict(
            k=self.index.k, w=self.index.w, M=M, A=A,
            chain_params=self._chain_params,
            window=self.cfg.pallas_chain_window,
            mid_occ=int(self.opt.mid_occ),
            q_occ_frac=float(self.opt.q_occ_frac),
            occ_dist=od, max_max_occ=mmo,
            bt_k=self.cfg.backtrack_k, bt_cuts=bt_cuts,
            min_cnt=self.opt.min_cnt, min_sc=self.opt.min_chain_score,
        )

    def stage_batch(self, codes_sel, L: int, B: int) -> Dict[str, np.ndarray]:
        """The host arrays of one front-end batch (<= B reads of the L
        bucket), named as front_end_bt takes them: codes [B, L] padded
        with 4 and lens [B]; for an HPC index the codes compressed
        (compress_hpc) plus sk_lens, force_inf, pos_map and spans."""
        batch = np.full((B, L), 4, np.uint8)
        lens = np.zeros(B, np.int32)
        for bi, c in enumerate(codes_sel):
            batch[bi, : len(c)] = c
            lens[bi] = len(c)
        host = {"codes": batch, "lens": lens}
        if self.index.flag & 0x1:  # MM_I_HPC
            with self.metrics.span("hpc_stage"):
                cc, cl, run_end, run_len = compress_hpc(batch, lens)
                sp = hpc_spans(run_len, self.index.k)
                host.update(codes=cc, sk_lens=cl, force_inf=sp >= 256,
                            pos_map=run_end, spans=sp)
        return host

    def _fe_submit_batch(self, codes_sel, L: int, B: int, M: int, A: int,
                         use_bt: bool, bt_cuts: int):
        """Stage + dispatch ONE front end (<= B reads of the L bucket):
        the fused K1 + K2 front end when `use_bt`, else K1 only for the
        host backtrack.  Returns (lens, handles) without waiting for the
        device.  With a graph cache (the card's default) the batch is one
        replay of its key's captured graph (models/graphs.py), and under
        a grid each row whose cells sit on one device is one replay of
        its row's graph; else the front end's ops run eagerly.  On
        CUDA the upload comes from pinned memory, the chain table (or
        the anchor counts) is copied into pinned memory asynchronously,
        and an event recorded after the copy tells _fe_collect when it
        has landed."""
        with self.metrics.span("fe_stage"):
            host = self.stage_batch(codes_sel, L, B)
            kw = self._fe_kwargs(M, A, bt_cuts)
        lens = host["lens"]
        if not use_bt:
            for name in ("bt_k", "bt_cuts", "min_cnt", "min_sc"):
                del kw[name]
        self.metrics.add("fe_batches", 1)
        if not use_bt:
            self.metrics.add("host_bt_batches", 1)
        # chain DP cell updates this dispatch: B*A anchors x window
        self.metrics.add("chain_cells", float(B) * A * kw["window"])
        eager = None  # the front end's ops, where `run` replays a graph
        shape = (B, L, M, A)
        with self.metrics.span("front_end"):
            if self.mesh is None:
                fn = front_end_bt if use_bt else front_end_chain
                dev = self.dev

                def make_fn(up):
                    up = dict(up)
                    codes_d, lens_d = up.pop("codes"), up.pop("lens")
                    return lambda: fn(codes_d, lens_d, dev, **up, **kw)

                if self._fe_graphs is not None:
                    handles, run, eager = self._fe_graph_batch(
                        host, shape, use_bt, bt_cuts, kw, self.device, dev,
                        make_fn)
                else:
                    with self.metrics.span("fe_stage"):
                        staged, up = self._stage_upload(host, [self.device])
                    run = make_fn(up[self.device])
                    with self.metrics.span("fe_submit"):
                        handles = self._launch(self.device, *run(), use_bt,
                                               bt_cuts, staged)
            else:
                handles, run, eager = self._fe_grid_batch(
                    host, shape, use_bt, bt_cuts, kw)
        # the last dispatch, for probe_front_end / front_end_roofline
        self._probe_shape = shape
        self._probe_dispatch = run
        self._probe_eager = eager or run
        return lens, handles

    def _fe_key(self, shape, use_bt: bool, bt_cuts: int, kw: dict,
                owner, device: Optional[torch.device] = None,
                grid: tuple = ()) -> tuple:
        """The graph cache's key of one front-end batch: everything the
        JAX package's jit treats as static (the device, B, L, M, A, K2 or
        not, the cuts, an HPC index, every front-end keyword), the
        tables whose tensors the graph reads (`owner`: the DeviceIndex,
        or a grid's shards) and, for a grid row, the grid's shape and the
        row where the row reads blocks of its own (`grid`)."""
        return (str(device or self.device), *shape, use_bt, bt_cuts,
                bool(self.index.flag & 0x1), tuple(sorted(kw.items())),
                id(owner), *grid)

    def _fe_graph_batch(self, host, shape, use_bt: bool, bt_cuts: int,
                        kw: dict, device: torch.device, owner, make_fn,
                        grid: tuple = ()):
        """One front end (a batch, or a grid row's slice of it) on
        `device` as a replay of its key's captured graph, ``make_fn``
        giving the front end over the static inputs: (handles, the
        probe's replay, the front end run eagerly on the graph's
        inputs)."""
        B, L, M, A = shape
        with self.metrics.span("fe_stage"):
            staged = self._stage_host(host, device.type == "cuda")
        with self.metrics.span("fe_submit"):
            graph = self._fe_graphs.get(
                self._fe_key(shape, use_bt, bt_cuts, kw, owner, device,
                             grid),
                {"device": str(device), "B": len(host["lens"]), "L": L,
                 "M": M, "A": A, "use_bt": use_bt, "bt_cuts": bt_cuts,
                 **({"grid": grid} if grid else {})},
                device, owner, staged, make_fn)
            handles = self._fe_graphs.run(
                graph, staged, device,
                lambda out, aux: self._launch(device, out, aux, use_bt,
                                              bt_cuts, tuple(staged.values()),
                                              static=True))
        return handles, graph.probe, graph.fn

    def _fe_grid_batch(self, host, shape, use_bt: bool, bt_cuts: int,
                       kw: dict):
        """One front end over the grid, row by row, each data row on its
        slice of the batch: a replay of the row's graph where the row's
        cells sit on one device and the engine has a graph cache, else
        the row's ops on its devices.  make_dp_front_end rows of one
        device share a graph; a make_sharded_front_end row reads its own
        shard blocks, so its key holds the row.  (per-row handles, the
        probe's re-dispatch, the rows' ops run eagerly)."""
        nd, ni = self.mesh.shape["data"], self.mesh.shape["index"]
        Bp = shape[0] // nd
        handles, probes, eagers = [], [], []
        graph_rows = self.mesh.graph_rows(self._fe_graphs)
        for r in range(nd):
            part = {n: a[r * Bp:(r + 1) * Bp] for n, a in host.items()}
            dev = self.mesh.devices[r, 0]
            if r in graph_rows:
                sharded = self._index_shards is not None
                owner = (self._index_shards if sharded
                         else self.index.device_index(dev))

                def make_fn(inputs, r=r, dev=dev):
                    return lambda: self._mesh_fe(r, {dev: inputs}, **kw)

                h, probe, fn = self._fe_graph_batch(
                    part, shape, use_bt, bt_cuts, kw, dev, owner, make_fn,
                    (nd, ni, r if sharded else -1))
            else:
                with self.metrics.span("fe_stage"):
                    staged, ups = self._stage_upload(
                        part, self.mesh.group(r).distinct)
                fn = probe = (lambda r=r, ups=ups: self._mesh_fe(r, ups, **kw))
                with self.metrics.span("fe_submit"):
                    h = self._launch(dev, *fn(), use_bt, bt_cuts, staged)
            handles.append(h)
            probes.append(probe)
            eagers.append(fn)
        return (handles, lambda: [p() for p in probes],
                lambda: [f() for f in eagers])

    @staticmethod
    def _stage_host(host: Dict[str, np.ndarray], pin: bool):
        """Host arrays -> host tensors, pinned when `pin` (the source of
        a CUDA upload that does not wait)."""
        staged = {n: torch.from_numpy(np.ascontiguousarray(a))
                  for n, a in host.items()}
        if pin:
            staged = {n: t.pin_memory() for n, t in staged.items()}
        return staged

    @classmethod
    def _stage_upload(cls, host: Dict[str, np.ndarray], devices):
        """Host arrays -> (the staged host tensors, {device: uploads}); on
        CUDA from pinned memory, without waiting."""
        staged = cls._stage_host(host, any(d.type == "cuda" for d in devices))
        ups = {d: {n: t.to(d, non_blocking=True) for n, t in staged.items()}
               for d in devices}
        return tuple(staged.values()), ups

    @staticmethod
    def _launch(dev: torch.device, out, aux, use_bt: bool, bt_cuts: int,
                staged, static: bool = False) -> _FrontEndHandles:
        """Hand one front end's results on `dev` to _fe_collect: on CUDA
        start copying them (with K2: the chain table and aux; else the
        counts) into pinned memory behind an event, without waiting.
        `static` outputs (a graph's) are overwritten by its next replay,
        so the anchor stack that stays on the device is copied too."""
        done = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                aux_h = torch.empty(aux.shape, dtype=aux.dtype,
                                    pin_memory=True)
                aux_h.copy_(aux, non_blocking=True)
                if use_bt:
                    out_h = torch.empty(out.shape, dtype=out.dtype,
                                        pin_memory=True)
                    out_h.copy_(out, non_blocking=True)
                    out = out_h
                elif static:
                    out = out.clone()
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                aux = aux_h
        elif static:
            out, aux = out.clone(), aux.clone()
        return _FrontEndHandles(out, aux, done, staged,
                                None if use_bt else bt_cuts)

    def _fe_collect(self, handles):
        """Wait for a dispatched front end (its handles, or a grid's list
        of per-row handles, in row order); (chains [B, K, 9+2*cuts],
        rep_len [B], n_raw [B]) as numpy.  For the host backtrack, the
        anchor stack is downloaded trimmed to the widest read's anchors
        and walked by native backtrack_compact_batch, which gives K2's
        chain table."""
        parts = handles if isinstance(handles, list) else [handles]
        with self.metrics.span("fe_wait"):
            for h in parts:
                if h.done is not None:
                    h.done.synchronize()
        aux = np.concatenate([h.aux.numpy() for h in parts], axis=1)
        if parts[0].bt_cuts is None:
            return (np.concatenate([h.out.numpy() for h in parts]),
                    aux[0], aux[1])
        from .. import native

        n, n_raw, rep_len = aux
        A = parts[0].out.shape[2]
        A_used = min(_pow2_at_least(max(int(n.max(initial=0)), 1)), A)
        with self.metrics.span("fe_host_bt"):
            arr = np.concatenate(
                [h.out[:, :, :A_used].cpu().numpy() for h in parts], axis=1)
            chains = native.backtrack_compact_batch(
                arr, self.opt.min_cnt, self.opt.min_chain_score,
                self.cfg.backtrack_k, parts[0].bt_cuts, self.SEG_LEN,
            )
        if chains is None:
            raise RuntimeError(
                "the host chain backtrack needs the native library "
                "(backtrack_compact_batch)")
        return chains, rep_len, n_raw

    def _check_chain_fits(self, A: int) -> None:
        if not self._chain_fits(A):
            raise ValueError(
                f"anchor budget A={A} at window "
                f"{self.cfg.pallas_chain_window} is outside what the chain "
                "kernel takes (ops/chain_kernel.py chain_fits)"
            )

    def fe_submit(self, codes_sel, L: int, a_boost: int = 1):
        """Dispatch ONE front-end batch (<= B reads of the L bucket) at
        the full batch shape and return a ticket for fe_collect, without
        waiting for the device.  Thread-safe.  The device-owner topology
        (runtime/devowner.py) runs its front ends through this pair."""
        B, M, A = self.fe_shapes(L, a_boost=a_boost)
        if len(codes_sel) > B:
            raise ValueError(f"chunk of {len(codes_sel)} > batch {B}")
        self._check_chain_fits(A)
        bt_cuts = min(8, L // self.SEG_LEN)
        _lens, handles = self._fe_submit_batch(
            codes_sel, L, B, M, A, self._bt_enabled(A), bt_cuts)
        return handles, len(codes_sel)

    def fe_collect(self, ticket):
        """Wait for a fe_submit ticket; (chains [n, K, 9+2*cuts], rep_len
        [n], n_raw [n]) for the n submitted reads: the compact chain rows
        (regions_from_compact layout) that post_chain_packed takes."""
        handles, n = ticket
        with self.metrics.span("front_end"):
            chains, rep_len, n_raw = self._fe_collect(handles)
        return chains[:n], rep_len[:n], n_raw[:n]

    def probe_front_end(self, n: int = 10) -> List[float]:
        """Front-end seconds per batch from re-dispatching the last
        batch as the path dispatches it (on the card one replay of its
        captured graph): [0] = pipelined (n dispatches, one wait, / n),
        [1] = blocking (one dispatch and its wait).  The device work
        only: no staging, no download.  On CUDA each wait is
        torch.cuda.synchronize.  [] until a batch has run."""
        replay = self._probe_dispatch
        if replay is None:
            return []

        def wait():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        replay()  # warm
        wait()
        t0 = time.perf_counter()
        for _ in range(n):
            replay()
        wait()
        thr = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        replay()
        wait()
        return [thr, time.perf_counter() - t0]

    def front_end_roofline(self) -> dict:
        """The JAX package's cost model of ONE front-end batch, from the
        shapes of the last dispatch, at the window K1 chains with
        (cfg.pallas_chain_window): the integer operations and the device
        memory bytes the front end must move.  With probe_front_end's
        seconds per batch these give the shares of the card's int32 and
        memory rates.  Op counts are algorithmic minimums (each
        elementwise op once); bytes count the gather windows plus one
        write and read of ~30 [B, L] sketch intermediates.  {} until a
        batch has run."""
        shape = self._probe_shape
        if shape is None:
            return {}
        B, L, M, A = shape
        k, w = self.index.k, self.index.w
        W = self.cfg.pallas_chain_window
        log2A = max(A - 1, 1).bit_length()
        int_ops = (
            B * L * (6 * k + 14 * w + 46)   # sketch (single-word path)
            + B * M * 300                    # probe compare + argmax
            + B * M * 250                    # filters (sorts, cummax)
            + B * A * 40                     # slot expansion
            + B * A * 6 * log2A * log2A      # anchor lex sort (bitonic)
            + B * A * W * 12                 # chain window max-plus DP
        )
        hbm_bytes = (
            B * L * (1 + 30 * 4)             # codes in + sketch interm.
            + B * M * (256 * 4 + 4 + 8)      # hash rows + val + offcnt
            + B * A * (8 + 8)                # meta + pos gathers
            + B * A * 6 * 4 * 2              # anchor arrays r/w
            + B * A * 4 * 8                  # chain anchor re-reads
        )
        return {
            "B": B, "L": L, "M": M, "A": A, "window": W,
            "int_ops": float(int_ops),
            "hbm_bytes": float(hbm_bytes),
        }

    def _map_bucket(
        self,
        L: int,
        idxs: List[int],
        codes: List[np.ndarray],
        out: List[List[Region]],
        cs: bool,
        md: bool,
        a_boost: int = 1,
        sink=None,
    ) -> None:
        B, M, A = self.fe_shapes(L, a_boost=a_boost, b_real=len(idxs))
        self._check_chain_fits(A)
        use_bt = self._bt_enabled(A)
        overflow_reads: List[int] = []
        bt_cuts = min(8, L // self.SEG_LEN)

        def stage_dispatch(chunk):
            _lens, handles = self._fe_submit_batch(
                [codes[ri] for ri in chunk], L, B, M, A, use_bt, bt_cuts
            )
            return chunk, handles

        def stage_process(state):
            chunk, handles = state
            with self.metrics.span("front_end"):
                chains_np, rep_len, n_raw = self._fe_collect(handles)
            for bi in np.nonzero(n_raw[: len(chunk)] > A)[0]:
                overflow_reads.append(chunk[int(bi)])
            fb = self._post_chain_native(
                chunk, chains_np[: len(chunk)],
                np.asarray(rep_len[: len(chunk)], np.int32),
                codes, out, cs, md, sink,
            )
            if fb is not None and not fb.any():
                return
            with self.metrics.span("post_chain_py"):
                self._post_chain_py(chunk, chains_np, rep_len, fb, codes,
                                    out, cs, md)

        # software pipeline: up to depth-1 dispatched batches in flight
        # while one is processed on the host
        depth = self.cfg.pipeline_depth
        pending = deque()
        for chunk_start in range(0, len(idxs), B):
            pending.append(stage_dispatch(idxs[chunk_start : chunk_start + B]))
            if len(pending) >= depth:
                stage_process(pending.popleft())
        while pending:
            stage_process(pending.popleft())

        if overflow_reads and a_boost < 16:
            # reads whose seed hits overflowed the A budget were mapped
            # from a truncated anchor set (minimap2 has no such cap) —
            # remap them with a 4x budget, overwriting their results
            self.metrics.add("anchor_overflow_retries", len(overflow_reads))
            self._map_bucket(
                L, overflow_reads, codes, out, cs, md, a_boost * 4, sink
            )

    def _run_jobs(self, jobs: List[_ExtJob]) -> None:
        """Extension jobs through the configured backend: the host C++
        banded DP, or kernel K3 on the device with the walk on the host
        ("device_dl") or on the device too (kernel K4, "device")."""
        if not jobs:
            return
        if self.is_splice:
            self._run_jobs_splice(jobs)
            return
        from .. import native

        native_ok = native.available()
        backend = self.cfg.extension_backend
        if backend not in ("auto", "host", "device", "device_dl"):
            raise ValueError(f"unknown extension_backend {backend!r}")
        if backend == "auto":
            backend = "host" if native_ok else "device_dl"
        if backend == "host" and native_ok:
            self._run_jobs_host(jobs)
            return
        # small jobs (most flanks): full DP on host in C++ — cheaper
        # than a device dispatch and removes whole shape classes
        small: List[_ExtJob] = []
        rest: List[_ExtJob] = []
        for j in jobs:
            if native_ok and len(j.q) <= 64 and len(j.t) <= 160:
                small.append(j)
            else:
                rest.append(j)
        if small:
            self._run_small_jobs(small)
        # bucket by (QMAX, TMAX, W) size class
        groups: Dict[Tuple[int, int, int], List[_ExtJob]] = {}
        for j in rest:
            ql, tl = len(j.q), len(j.t)
            if ql == 0 or tl == 0:
                self._store_empty(j)
                continue
            QMAX = _pow2_at_least(ql, 64)
            TMAX = _pow2_at_least(tl, 64)
            # static band: lane d of diagonal s is i = band_lo(s)+d, so
            # the W lanes cover j-i in [-W, W-2].  A global job's end
            # cell sits at j-i = tlen-qlen, hence the drift term of
            # _mid_band; flank t-windows are deliberately longer than q
            # (ref overhang) and the band covers gaps up to ~W/2
            if j.kind == "mid":
                W = self._mid_band(abs(ql - tl))
            else:
                W = self.flank_band
            W = min(W, _pow2_at_least(QMAX + TMAX, 128))
            groups.setdefault((QMAX, TMAX, W), []).append(j)
        for (QMAX, TMAX, W), grp in groups.items():
            # J cap: K3 writes S*W direction bytes per job, and
            # device_dl copies them all into pinned host memory, so a
            # group holds at most DIRS_BUDGET bytes of them (the JAX
            # package's 256 is a TPU scoped-VMEM figure).  At the main
            # path's largest class (1024, 1024, 128) that is 256 jobs.
            # The grouping does not change results.
            S = QMAX + TMAX - 1
            cap = _pow2_at_most(max(DIRS_BUDGET // (S * W), 1))
            J = min(_pow2_at_least(len(grp), 8), cap)
            for s0 in range(0, len(grp), J):
                sub = grp[s0 : s0 + J]
                q = np.full((J, QMAX), 4, np.uint8)
                t = np.full((J, TMAX), 4, np.uint8)
                ql = np.zeros(J, np.int32)
                tl = np.zeros(J, np.int32)
                for ji, job in enumerate(sub):
                    q[ji, : len(job.q)] = job.q
                    t[ji, : len(job.t)] = job.t
                    ql[ji] = len(job.q)
                    tl[ji] = len(job.t)
                cells = float(len(sub)) * S * W
                if backend == "device":
                    self._run_group_device(sub, q, t, ql, tl, W, cells,
                                           native_ok)
                else:
                    self._run_group_device_dl(sub, q, t, ql, tl, W, cells)

    def _run_group_device(self, sub, q, t, ql, tl, W: int, cells: float,
                          native_ok: bool) -> None:
        """One job group fully on the device: K3 + K4 (one graph replay
        per group shape on the card), only the packed CIGAR table
        downloaded."""
        J = len(q)
        mode = np.asarray(
            [0 if j.kind == "mid" else 1 for j in sub] + [1] * (J - len(sub)),
            np.int32,
        )
        ops = self.cfg.traceback_max_ops
        with self.metrics.span("extend"):
            res = extend_traceback_device(
                q, t, ql, tl, mode, W, self._ext_params, self.opt.end_bonus,
                max_ops=ops, device=self.device, graphs=self._ext_graphs,
            )
            self.metrics.add("dp_cells", cells)
            self.metrics.add("ext_groups", 1)
            self.metrics.add("ext_download_bytes", float(J) * (ops + 8) * 4)
        retry = self._apply_fused_results(sub, res)
        if retry:
            # ops-table overflow (indel-dense outliers): re-run those
            # through the host engine
            if native_ok:
                self._run_jobs_host(retry)
            else:
                for job in retry:
                    self._store_empty(job)

    def _run_group_device_dl(self, sub, q, t, ql, tl, W: int,
                             cells: float) -> None:
        """One job group: K3 on the device (one graph replay per group
        shape on the card), the direction bytes downloaded and walked on
        the host."""
        QMAX, TMAX = q.shape[1], t.shape[1]
        with self.metrics.span("extend"):
            res = extend_dp_device(q, t, ql, tl, W, self._ext_params,
                                   device=self.device,
                                   graphs=self._ext_graphs)
            self.metrics.add("dp_cells", cells)
            self.metrics.add("ext_groups", 1)
            self.metrics.add("ext_download_bytes",
                             float(res["dirs"].nbytes) + 24.0 * len(q))
        dirs = res["dirs"]
        best_sc, best_i, best_j = res["best_sc"], res["best_i"], res["best_j"]
        g_sc, g_j, end_sc = res["g_sc"], res["g_j"], res["end_sc"]
        # decide per-job traceback start cell + score
        NEGISH = -(1 << 27)
        starts = []  # (job_idx, start_i, start_j, score)
        for ji, job in enumerate(sub):
            if job.kind == "mid":
                if int(end_sc[ji]) <= NEGISH:
                    # end cell unreachable within the band
                    self._store_empty(job)
                    continue
                starts.append((ji, int(ql[ji]) - 1, int(tl[ji]) - 1,
                               int(end_sc[ji])))
            else:
                use_end = (
                    int(g_sc[ji]) > NEGISH
                    and int(g_sc[ji]) + self.opt.end_bonus >= int(best_sc[ji])
                )
                if use_end and int(g_sc[ji]) > 0:
                    starts.append((ji, int(ql[ji]) - 1, int(g_j[ji]),
                                   int(g_sc[ji])))
                elif int(best_sc[ji]) > 0:
                    starts.append((ji, int(best_i[ji]), int(best_j[ji]),
                                   int(best_sc[ji])))
                else:
                    self._store_empty(job)
        if not starts:
            return
        from .. import native

        idxs = np.asarray([s[0] for s in starts], np.int32)
        cigs = native.traceback_batch(
            np.ascontiguousarray(dirs[:, idxs, :]), ql[idxs], tl[idxs],
            np.asarray([s[1] for s in starts], np.int32),
            np.asarray([s[2] for s in starts], np.int32),
            max_ops=2 * (QMAX + TMAX),
        )
        if cigs is None:  # no native library: the python walk
            cigs = [
                cig.pack_ops(cig.traceback_one(
                    dirs[:, ji, :], int(ql[ji]), int(tl[ji]), W, s_i, s_j))
                for (ji, s_i, s_j, _) in starts
            ]
        for (ji, s_i, s_j, sc), c in zip(starts, cigs):
            job = sub[ji]
            if job.kind == "mid":
                job.region._mid_parts[job.seg] = (c, sc)  # type: ignore[attr-defined]
            else:
                setattr(job.region, f"_{job.kind}", (c, sc, s_i + 1, s_j + 1))

    def _apply_fused_results(
        self, sub: List[_ExtJob], res: Dict[str, np.ndarray]
    ) -> List[_ExtJob]:
        """Store per-job results of the device-resident traceback;
        returns jobs whose CIGAR overflowed the [J, OPS] table (the
        caller re-runs them on the host engine)."""
        ops_tab = res["ops"]
        info = res["info"]
        retry: List[_ExtJob] = []
        for ji, job in enumerate(sub):
            n_o, fi, fj, sc, started, ovf, si0, sj0 = (
                int(v) for v in info[ji, :8])
            if ovf:
                retry.append(job)
                continue
            if not started:
                self._store_empty(job)
                continue
            parts: List[Tuple[int, int]] = []
            # leading border gaps (the host walk emits these after the
            # in-band walk and reverses; reversed order is D then I)
            if fj >= 0:
                parts.append((fj + 1, 2))
            if fi >= 0:
                parts.append((fi + 1, 1))
            raw = ops_tab[ji, :n_o][::-1]
            parts.extend((int(v) >> 4, int(v) & 0xF) for v in raw)
            c = cig.pack_ops(cig.merge_cigars([parts]))
            if job.kind == "mid":
                job.region._mid_parts[job.seg] = (c, sc)  # type: ignore[attr-defined]
            else:
                setattr(job.region, f"_{job.kind}", (c, sc, si0 + 1, sj0 + 1))
        return retry

    def _run_small_jobs(self, jobs: List[_ExtJob]) -> None:
        """Small jobs of the device backends: full (unbanded) DP in host
        C++ (native extend_small_batch), one call per mode."""
        from .. import native

        with self.metrics.span("extend_small"):
            for mode, kinds in ((0, ("mid",)), (1, ("left", "right"))):
                sel = [j for j in jobs if j.kind in kinds]
                if not sel:
                    continue
                QS = max(max(len(j.q) for j in sel), 1)
                TS = max(max(len(j.t) for j in sel), 1)
                q = np.full((len(sel), QS), 4, np.uint8)
                t = np.full((len(sel), TS), 4, np.uint8)
                ql = np.zeros(len(sel), np.int32)
                tl = np.zeros(len(sel), np.int32)
                for i, j in enumerate(sel):
                    q[i, : len(j.q)] = j.q
                    t[i, : len(j.t)] = j.t
                    ql[i], tl[i] = len(j.q), len(j.t)
                res = native.extend_small_batch(
                    q, t, ql, tl, self._ext_params, self.opt.end_bonus, mode
                )
                self.metrics.add("dp_cells", float((ql * tl).sum()))
                if res is None:  # native missing/overflow
                    for j in sel:
                        self._store_empty(j)
                    continue
                for j, (ops, sc, qc, tc) in zip(sel, res):
                    if mode == 0:
                        j.region._mid_parts[j.seg] = (ops, sc)  # type: ignore[attr-defined]
                    elif len(ops) or sc > 0:
                        setattr(j.region, f"_{j.kind}", (ops, sc, qc, tc))
                    else:
                        self._store_empty(j)

    def _seed_select_params(self):
        """Effective (occ_dist, max_max_occ) for seed thinning/rescue —
        the mm_collect_matches gate `dist > 0 && max_max_occ > max_occ`
        is resolved here on host (mid_occ is known after index load)
        so the device graphs stay static."""
        if (self.opt.occ_dist > 0
                and self.opt.max_max_occ > self.opt.mid_occ):
            return int(self.opt.occ_dist), int(self.opt.max_max_occ)
        return 0, 0

    MAX_SPLITS = 3

    def _run_split_rounds(
        self,
        read_regions: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
    ) -> None:
        """Resolve zdrop splits: regions whose mid alignment truncated
        re-enter extension as (head, remainder) pairs until no segment
        zdrops (bounded rounds); then attempt inversion rescue across
        each split's gap (mm_align1_inv)."""
        for _ in range(self.MAX_SPLITS + 1):
            extra = self._split_zdropped(read_regions, codes)
            if not extra:
                break
            self._run_jobs(extra)
        self._inversion_rescue(read_regions, codes)

    def _split_zdropped(
        self,
        read_regions: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
    ) -> List[_ExtJob]:
        """mm_align1's zdrop chimeric/SV splitting: when a mid
        segment's global DP fell more than zdrop below its running max
        (ksw2 KSW_EZ_APPROX_DROP; /root/reference behavior behind
        src/lib.rs:482 via the C core), the region ends at the max
        cell and the remainder becomes a NEW region, re-extended with
        its own left flank toward the break.  Returns the new
        regions' extension jobs (caller runs them; a remainder can
        itself split again, up to MAX_SPLITS rounds)."""
        new_jobs: List[_ExtJob] = []
        ref = self.index.ref_codes
        offs = self.index.seq_offsets
        for ri, regions, _rl in read_regions:
            qlen = len(codes[ri])
            add: List[Region] = []
            for r in regions:
                zd = getattr(r, "_mid_zdrop", None)
                if not zd:
                    continue
                si = min(zd.keys())
                qc, tc = zd[si]
                segs = r._segs  # type: ignore[attr-defined]
                q0, _q1, t0, _t1 = segs[si]
                orig_re = r.re
                orig_qe_a = r._qe_a  # type: ignore[attr-defined]
                orig_right = getattr(r, "_right", (_EMPTY_OPS, 0, 0, 0))
                part = r._mid_parts[si]  # type: ignore[attr-defined]
                self.metrics.add("zdrop_splits", 1)
                # --- head: truncate r at the max cell ---
                if part is not None and len(part[0]):
                    r._mid_parts = r._mid_parts[: si + 1]
                    r.re = t0 + tc
                    r._qe_a = q0 + qc
                else:
                    # dropped immediately: end at the segment boundary
                    r._mid_parts = (
                        r._mid_parts[:si] if si > 0 else [(_EMPTY_OPS, 0)]
                    )
                    r.re = t0
                    r._qe_a = q0
                r._segs = segs[: si + 1]
                r._mid_zdrop = {}
                r._right = (_EMPTY_OPS, 0, 0, 0)  # no extension past a drop
                # --- remainder: new region from the next segment on ---
                n_splits = getattr(r, "_n_splits", 0)
                if si + 1 >= len(segs) or n_splits >= self.MAX_SPLITS:
                    continue
                qB0, tB0 = segs[si + 1][0], segs[si + 1][2]
                if orig_qe_a <= qB0 or orig_re <= tB0:
                    continue
                frac = (orig_qe_a - qB0) / max(orig_qe_a - r._qs_a, 1)  # type: ignore[attr-defined]
                rB = Region(
                    rev=r.rev,
                    rid=r.rid,
                    qs=qB0 if r.rev == 0 else qlen - orig_qe_a,
                    qe=orig_qe_a if r.rev == 0 else qlen - qB0,
                    rs=tB0,
                    re=orig_re,
                    score=max(int(r.score * frac), 1),
                    cnt=max(int(r.cnt * frac), 1),
                    anchors_qpos=np.asarray([qB0, orig_qe_a - 1], np.int32),
                    anchors_rpos=np.asarray([tB0, orig_re - 1], np.int32),
                )
                rB._q_al = r._q_al  # type: ignore[attr-defined]
                rB._qs_a = qB0  # type: ignore[attr-defined]
                rB._qe_a = orig_qe_a  # type: ignore[attr-defined]
                rB._segs = segs[si + 1 :]  # type: ignore[attr-defined]
                rB._n_mid = len(rB._segs)  # type: ignore[attr-defined]
                rB._mid_parts = [None] * len(rB._segs)  # type: ignore[attr-defined]
                rB._mid_zdrop = {}  # type: ignore[attr-defined]
                rB._n_splits = n_splits + 1  # type: ignore[attr-defined]
                rB._right = orig_right  # type: ignore[attr-defined]
                rB._inv_prev = r  # type: ignore[attr-defined]
                roff = int(offs[r.rid])
                q_al = rB._q_al  # type: ignore[attr-defined]
                for sj, (sq0, sq1, st0, st1) in enumerate(rB._segs):  # type: ignore[attr-defined]
                    new_jobs.append(
                        _ExtJob(
                            rB, "mid",
                            q_al[sq0:sq1],
                            ref[roff + st0 : roff + st1],
                            seg=sj,
                        )
                    )
                # left flank back toward the break (bounded by the gap)
                gap_q0 = r._qe_a  # type: ignore[attr-defined]
                bw = min(self.opt.bw, self.flank_band // 2)
                if qB0 > gap_q0:
                    tl0 = min(tB0 - r.re, (qB0 - gap_q0) + bw)
                    tl0 = max(tl0, 0)
                    if tl0 > 0:
                        new_jobs.append(
                            _ExtJob(
                                rB, "left",
                                q_al[gap_q0:qB0][::-1],
                                ref[roff + tB0 - tl0 : roff + tB0][::-1],
                            )
                        )
                    else:
                        rB._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
                else:
                    rB._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
                add.append(rB)
            regions.extend(add)
        return new_jobs

    def _inversion_rescue(
        self,
        read_regions: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
    ) -> None:
        """mm_align1_inv semantics: for each zdrop-split (head,
        remainder) pair with a gap on BOTH the query and the target,
        align the reverse complement of the query gap against the
        target gap (extension DP, zdrop_inv) under both anchorings —
        gap-left against target-left, and both reversed — and, when
        the better one clears min_dp_max, emit a new region on the
        OPPOSITE strand covering the inverted segment.  This is the
        small-inversion behavior behind every reference ``.map()``
        (ksw path of /root/reference/src/lib.rs:482); only the host
        extension path produces zdrop splits, so rescue runs there."""
        from .. import native

        if self.is_splice or not native.available():
            return
        ref = self.index.ref_codes
        offs = self.index.seq_offsets

        def parts_ok(x) -> bool:
            return hasattr(x, "_mid_parts") and all(
                p is not None and len(p[0]) for p in x._mid_parts
            )

        cand = []
        for ri, regions, _rl in read_regions:
            qlen = len(codes[ri])
            for rB in regions:
                r = getattr(rB, "_inv_prev", None)
                if r is None or not (parts_ok(r) and parts_ok(rB)):
                    continue
                lq = lt = 0
                left = getattr(rB, "_left", None)
                if left is not None:
                    _, _, lq, lt = left
                qg0, qg1 = r._qe_a, rB._qs_a - lq  # type: ignore[attr-defined]
                tg0, tg1 = r.re, rB.rs - lt
                QG, TG = qg1 - qg0, tg1 - tg0
                if QG < 16 or TG < 16:
                    continue
                if QG > self.opt.max_gap or TG > self.opt.max_gap:
                    continue
                q_inv = _revcomp(np.asarray(r._q_al[qg0:qg1]))  # type: ignore[attr-defined]
                roff = int(offs[r.rid])
                tgap = np.asarray(ref[roff + tg0 : roff + tg1])
                cand.append(
                    (regions, r, qg0, qg1, tg0, tg1, q_inv, tgap, qlen)
                )
        if not cand:
            return
        with self.metrics.span("extend"):
            J = 2 * len(cand)
            QS = max(len(c[6]) for c in cand)
            TS = max(len(c[7]) for c in cand)
            qb = np.full((J, QS), 4, np.uint8)
            tb = np.full((J, TS), 4, np.uint8)
            ql = np.zeros(J, np.int32)
            tl = np.zeros(J, np.int32)
            for ci, c in enumerate(cand):
                q_inv, tgap = c[6], c[7]
                qb[2 * ci, : len(q_inv)] = q_inv
                qb[2 * ci + 1, : len(q_inv)] = q_inv[::-1]
                tb[2 * ci, : len(tgap)] = tgap
                tb[2 * ci + 1, : len(tgap)] = tgap[::-1]
                ql[2 * ci] = ql[2 * ci + 1] = len(q_inv)
                tl[2 * ci] = tl[2 * ci + 1] = len(tgap)
            res = native.extend_banded_batch(
                qb, tb, ql, tl, self.flank_band, self._ext_params,
                self.opt.end_bonus, 1, zdrop=self.opt.zdrop_inv,
            )
            self.metrics.add("dp_cells", float(J) * (QS + TS - 1) * self.flank_band)
        if res is None:
            return
        for ci, (regions, r, qg0, qg1, tg0, tg1, _qi, _tg, qlen) in enumerate(
            cand
        ):
            ra, rb_ = res[2 * ci], res[2 * ci + 1]
            use_b = rb_[1] > ra[1]
            ops, sc, qc, tc, _z = rb_ if use_b else ra
            if sc < self.opt.min_dp_max or qc < 16 or tc < 16:
                continue
            rev_i = 1 - r.rev
            if use_b:
                qs_a, qe_a = qlen - qg0 - qc, qlen - qg0
                rs_i, re_i = tg1 - tc, tg1
                ops = np.ascontiguousarray(ops[::-1])  # reversed DP frame
            else:
                qs_a, qe_a = qlen - qg1, qlen - qg1 + qc
                rs_i, re_i = tg0, tg0 + tc
            inv = Region(
                rev=rev_i,
                rid=r.rid,
                qs=qs_a if rev_i == 0 else qlen - qe_a,
                qe=qe_a if rev_i == 0 else qlen - qs_a,
                rs=rs_i,
                re=re_i,
                score=max(1, sc // max(self.opt.a, 1)),
                cnt=2,
                anchors_qpos=np.asarray([qs_a, qe_a - 1], np.int32),
                anchors_rpos=np.asarray([rs_i, re_i - 1], np.int32),
            )
            inv._q_al = _revcomp(np.asarray(r._q_al))  # type: ignore[attr-defined]
            inv._qs_a, inv._qe_a = qs_a, qe_a  # type: ignore[attr-defined]
            inv._segs = [(qs_a, qe_a, rs_i, re_i)]  # type: ignore[attr-defined]
            inv._n_mid = 1  # type: ignore[attr-defined]
            inv._mid_parts = [(ops, sc)]  # type: ignore[attr-defined]
            inv._mid_zdrop = {}  # type: ignore[attr-defined]
            inv._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
            inv._right = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
            regions.append(inv)
            self.metrics.add("inv_rescues", 1)

    def _finish_reads(
        self,
        read_regions: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
        out: List[List[Region]],
        cs: bool,
        md: bool,
    ) -> None:
        min_dp = self.opt.min_dp_max
        groups = []
        for ri, regions, rl in read_regions:
            # a region survives only if EVERY mid segment aligned
            # (an empty part would silently drop query/ref span)
            done = [
                r
                for r in regions
                if hasattr(r, "_mid_parts")
                and all(x is not None and len(x[0]) for x in r._mid_parts)
            ]
            groups.append((ri, done, rl))
        self._finalize_many(groups, codes, cs, md)
        for ri, done, rl in groups:
            # minimap2's min_dp_max: drop regions whose DP score is
            # below the floor (the `min_dp_score` ctor kwarg)
            done = [r for r in done if r.dp_score >= min_dp]
            done.sort(key=lambda r: (r.parent != r.id, -r.dp_score))
            out[ri] = done

    def _post_chain_params(self):
        """Cached (ip, dp) param blocks for native.post_chain_batch
        (post_chain.cc IP_* layout)."""
        blocks = getattr(self, "_pc_blocks", None)
        if blocks is None:
            p = self._ext_params
            ip = np.array(
                [
                    self.index.k,                       # IP_SPAN
                    self.opt.mask_len,
                    self.opt.best_n,
                    self.opt.min_dp_max,
                    p.a, p.b, p.q, p.e, p.q2, p.e2,
                    p.sc_ambi,
                    self.opt.end_bonus,
                    self.opt.zdrop,
                    self.opt.min_chain_score,
                    1 if (self.opt.flag & _MM_F_SR) else 0,
                    min(self.opt.bw, self.flank_band // 2),  # IP_BW
                    self.flank_band,
                    self.cfg.mid_band_floor,
                    self.cfg.mid_band_slack,
                    self.SEG_LEN,
                    0,                                  # IP_CIGCAP (wrapper)
                ],
                np.int32,
            )
            dp = np.array(
                [self.opt.mask_level, self.opt.pri_ratio], np.float64
            )
            blocks = self._pc_blocks = (ip, dp)
        return blocks

    def _post_chain_native(
        self,
        chunk,
        chains_np: np.ndarray,
        rep_len: np.ndarray,
        codes: List[np.ndarray],
        out: List[List[Region]],
        cs: bool,
        md: bool,
        sink=None,
    ):
        """Fused C++ post-chain (post_chain.cc): regions + selection +
        extension + finalize + mapq for the whole batch in ONE native
        call, writing finished Region lists into `out`, or, with a
        PackedSink (map_batch_packed, post_chain_packed), its flat
        arrays into the sink.  Returns the per-read fallback mask (reads
        the caller must remap through the Python path: zdrop splits ->
        inversion rescue, cap overflows), or None when the fast path
        does not apply (splice presets, a non-host extension backend,
        missing native lib)."""
        from .. import native

        if (
            self.is_splice
            or not self.cfg.post_chain_native
            or not native.available()
        ):
            return None
        backend = self.cfg.extension_backend
        if backend == "auto":
            backend = "host"
        if backend != "host":
            return None
        ip, dpar = self._post_chain_params()
        codes_list = [codes[ri] for ri in chunk]
        with self.metrics.span("extend"), self.metrics.span("post_chain"):
            res = native.post_chain_batch(
                chains_np, codes_list, rep_len,
                self.index.ref_codes,
                self.index.seq_offsets, self.index.seq_lens,
                ip, dpar, cs, md,
            )
        if res is None:
            return None
        (nreg, fields, cig, ncig, cs_get, md_get, fallback, stats,
         raw_tags) = res
        self.metrics.add("dp_cells", float(stats[0]))
        # thread CPU seconds inside the native call, beside the span's
        # time_post_chain_s (the interpreter lock released in between)
        self.metrics.add("cpu_post_chain_s", float(stats[2]))
        self.metrics.add("post_chain_fallbacks", float(fallback.sum()))
        if sink is not None:
            with self.metrics.span("finalize"):
                sink.add_native(chunk, nreg, fields, cig, ncig, raw_tags,
                                fallback)
                fb_idx = np.nonzero(fallback[: len(chunk)])[0]
                if len(fb_idx):
                    sink.mark_python(np.asarray(chunk, np.int64)[fb_idx])
            return fallback
        with self.metrics.span("finalize"):
            for bi, ri in enumerate(chunk):
                if fallback[bi]:
                    continue
                n = int(nreg[bi])
                regs: List[Region] = []
                if n:
                    rows = fields[bi, :n].tolist()
                    for oi, f in enumerate(rows):
                        r = Region(
                            rev=f[0], rid=f[1], qs=f[2], qe=f[3],
                            rs=f[4], re=f[5], score=f[6], cnt=f[7],
                            anchors_qpos=_EMPTY_OPS,
                            anchors_rpos=_EMPTY_OPS,
                        )
                        r.id = f[8]
                        r.parent = f[9]
                        r.subsc = f[10]
                        r.n_sub = f[11]
                        r.dp_score = r.dp_max = f[12]
                        r.dp_max2 = f[13]
                        r.mapq = f[14]
                        r.mlen = f[15]
                        r.blen = f[16]
                        r.nm = f[17]
                        r.cigar = cig[bi, oi, : ncig[bi, oi]].copy()
                        if cs:
                            r.cs = cs_get(bi, oi)
                        if md:
                            r.md = md_get(bi, oi)
                        regs.append(r)
                out[ri] = regs
        return fallback

    def _make_jobs(
        self, regions: List[Region], codes: np.ndarray, qlen: int
    ) -> List[_ExtJob]:
        """Build left/mid/right extension jobs per region (mm_align1
        structure, single global mid instead of per-anchor segments)."""
        jobs: List[_ExtJob] = []
        ref = self.index.ref_codes
        offs = self.index.seq_offsets
        # flank ref overhang: the static band covers gaps up to ~W/2,
        # so a wider ref window than q + W/2 is unreachable anyway
        bw = min(self.opt.bw, self.flank_band // 2)
        if self.is_splice:
            # splice flanks run the UNBANDED intron-state DP, so the
            # window is a cost knob, not a band: allow a terminal exon
            # across an intron up to max_gap (2000 for splice presets)
            bw = max(bw, self.opt.max_gap)
        for r in regions:
            q_al = codes if r.rev == 0 else _revcomp(codes)
            qs_a = r.qs if r.rev == 0 else qlen - r.qe
            qe_a = r.qe if r.rev == 0 else qlen - r.qs
            r._q_al = q_al  # type: ignore[attr-defined]
            r._qs_a, r._qe_a = qs_a, qe_a  # type: ignore[attr-defined]
            roff = int(offs[r.rid])
            rlen = int(self.index.seq_lens[r.rid])
            # middle: global over the chained span.  Long regions are
            # split at chain anchors (minimap2's per-segment alignment)
            # so the band stays narrow regardless of read length.
            segs = self._mid_segments(r, qs_a, qe_a)
            r._segs = segs  # type: ignore[attr-defined]
            r._n_mid = len(segs)  # type: ignore[attr-defined]
            r._mid_parts = [None] * len(segs)  # type: ignore[attr-defined]
            r._mid_zdrop = {}  # type: ignore[attr-defined]
            for si, (q0, q1, t0, t1) in enumerate(segs):
                jobs.append(
                    _ExtJob(
                        r, "mid",
                        q_al[q0:q1],
                        ref[roff + t0 : roff + t1],
                        seg=si,
                    )
                )
            # left flank: reversed extension toward query start
            if qs_a > 0:
                tl0 = min(r.rs, qs_a + bw)
                if tl0 > 0:
                    jobs.append(
                        _ExtJob(
                            r,
                            "left",
                            q_al[:qs_a][::-1],
                            ref[roff + r.rs - tl0 : roff + r.rs][::-1],
                        )
                    )
                else:
                    r._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
            else:
                r._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
            # right flank
            if qe_a < qlen:
                tl1 = min(rlen - r.re, (qlen - qe_a) + bw)
                if tl1 > 0:
                    jobs.append(
                        _ExtJob(
                            r, "right", q_al[qe_a:], ref[roff + r.re : roff + r.re + tl1]
                        )
                    )
                else:
                    r._right = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
            else:
                r._right = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
        return jobs

    SEG_LEN = 384  # target query length per mid segment

    def _mid_segments(self, r: Region, qs_a: int, qe_a: int):
        """Split the chained span at anchors every ~SEG_LEN query bases.

        Anchors are exact k-mer matches, so cutting the global DP at an
        anchor's end cell is lossless for any near-optimal alignment
        (mm_align1 aligns anchor-to-anchor the same way)."""
        span = qe_a - qs_a
        if span <= 2 * self.SEG_LEN or len(r.anchors_qpos) < 3:
            return [(qs_a, qe_a, r.rs, r.re)]
        segs = []
        q_prev, t_prev = qs_a, r.rs
        last_q = int(r.anchors_qpos[0])
        for aq, at_ in zip(r.anchors_qpos[1:-1], r.anchors_rpos[1:-1]):
            aq, at_ = int(aq), int(at_)
            if aq - last_q >= self.SEG_LEN and aq + 1 - q_prev > 0:
                # cut AFTER this anchor's end cell (inclusive)
                if aq + 1 > q_prev and at_ + 1 > t_prev:
                    segs.append((q_prev, aq + 1, t_prev, at_ + 1))
                    q_prev, t_prev = aq + 1, at_ + 1
                    last_q = aq
        segs.append((q_prev, qe_a, t_prev, r.re))
        return [s for s in segs if s[1] > s[0] and s[3] > s[2]]

    # ------------------------------------------------------------------
    def _mid_band(self, drift: int) -> int:
        """Band width for an anchored mid segment: the known diagonal
        drift plus wander slack, 32-lane quantized (see
        AlignerConfig.mid_band_floor/_slack)."""
        need = 32 * ((drift + self.cfg.mid_band_slack + 31) // 32)
        return max(self.cfg.mid_band_floor, need)

    def _run_jobs_splice(self, jobs: List[_ExtJob]) -> None:
        """Splice-mode extension: every job runs the intron-state DP
        (C++ splice_align_batch; ops/splice.py when the lib is absent).
        minimap2 aligns each region under both transcript senses when
        MM_F_SPLICE_FOR|REV are set and keeps the higher-scoring round
        (align.c's two-round splice loop); mirrored here per REGION so
        all segments share one sense.  The winning sense is recorded as
        trans_strand (+1/-1, 0 when no intron was found)."""
        with self.metrics.span("extend"):
            senses = []
            if self.opt.flag & _MM_F_SPLICE_FOR:
                senses.append(1)
            if self.opt.flag & _MM_F_SPLICE_REV:
                senses.append(-1)
            if not senses:
                senses = [1]
            flank_sig = bool(self.opt.flag & MM_F_SPLICE_FLANK)
            by_region: Dict[int, List[_ExtJob]] = {}
            for j in jobs:
                by_region.setdefault(id(j.region), []).append(j)
            for jl in by_region.values():
                region = jl[0].region
                # a second sense only matters if some segment can hold
                # an intron (ref span materially exceeds query span)
                may_intron = any(len(x.t) - len(x.q) >= 20 for x in jl)
                use = senses if (may_intron and len(senses) > 1) else senses[:1]
                best = None
                for sense in use:
                    results = [
                        self._splice_one(x, sense, flank_sig) for x in jl
                    ]
                    tot = sum(r[1] for r in results)
                    if best is None or tot > best[0]:
                        best = (tot, sense, results)
                _, sense, results = best
                has_n = any(
                    len(r[0]) and bool(((np.asarray(r[0]) & 0xF) == 3).any())
                    for r in results
                )
                region.trans_strand = sense if has_n else 0
                for x, (ops, sc, qc, tc) in zip(jl, results):
                    if x.kind == "mid":
                        x.region._mid_parts[x.seg] = (ops, sc)  # type: ignore[attr-defined]
                    elif len(ops) or sc > 0:
                        setattr(x.region, f"_{x.kind}", (ops, sc, qc, tc))
                    else:
                        self._store_empty(x)

    def _splice_one(self, job: _ExtJob, sense: int, flank_sig: bool):
        """One splice DP job -> (packed ops, score, q_used, t_used)."""
        q, t = job.q, job.t
        if len(q) == 0 or len(t) == 0:
            return (_EMPTY_OPS, 0, 0, 0)
        from .. import native

        mode = 2 if job.kind == "mid" else 1
        rev = job.kind == "left"  # left flanks walk outward (reversed)
        o = self.opt
        self.metrics.add("dp_cells", float(len(q)) * len(t))
        if native.available():
            res = native.splice_align_batch(
                np.ascontiguousarray(q)[None, :],
                np.ascontiguousarray(t)[None, :],
                np.asarray([len(q)], np.int32),
                np.asarray([len(t)], np.int32),
                o.a, o.b, o.q, o.e, o.q2, o.noncan, o.sc_ambi,
                o.end_bonus, mode, sense, flank_sig, rev,
            )
            if res is not None:
                return res[0]
        from ..ops.splice import splice_align

        return splice_align(
            np.asarray(q), np.asarray(t), o.a, o.b, o.q, o.e, o.q2,
            o.noncan, o.sc_ambi, sense, flank_sig, mode, o.end_bonus, rev,
        )

    def _run_jobs_host(self, jobs: List[_ExtJob]) -> None:
        """All extension jobs through the C++ banded DP: ONE native
        call per job batch, per-job band/mode over concatenated
        buffers (extend_jobs_batch)."""
        from .. import native

        with self.metrics.span("extend"):
            sel: List[_ExtJob] = []
            Wv: List[int] = []
            modev: List[int] = []
            cells = 0.0
            for j in jobs:
                ql, tl = len(j.q), len(j.t)
                if ql == 0 or tl == 0:
                    self._store_empty(j)
                    continue
                # same band rule as _run_jobs (see comment there)
                if j.kind == "mid":
                    W = self._mid_band(abs(ql - tl))
                    modev.append(2)
                else:
                    W = self.flank_band
                    modev.append(1)
                Wv.append(W)
                sel.append(j)
                cells += float(ql + tl - 1) * W
            if not sel:
                return
            res = native.extend_jobs_batch(
                [j.q for j in sel], [j.t for j in sel],
                np.asarray(Wv, np.int32), np.asarray(modev, np.int32),
                self._ext_params, self.opt.end_bonus,
                zdrop=self.opt.zdrop,
            )
            self.metrics.add("dp_cells", cells)
            if res is None:
                for j in sel:
                    self._store_empty(j)
                return
            for j, mode, (ops, sc, qc, tc, zflag) in zip(sel, modev, res):
                if mode == 2:
                    j.region._mid_parts[j.seg] = (ops, sc)  # type: ignore[attr-defined]
                    if zflag:
                        # alignment truncated at the running-max
                        # cell: record the consumed spans so the
                        # caller splits the region (mm_align1's
                        # zdrop chimeric-split semantics)
                        j.region._mid_zdrop[j.seg] = (qc, tc)  # type: ignore[attr-defined]
                elif len(ops) or sc > 0:
                    setattr(j.region, f"_{j.kind}", (ops, sc, qc, tc))
                else:
                    self._store_empty(j)

    def _store_empty(self, job: _ExtJob) -> None:
        r = job.region
        if job.kind == "mid":
            r._mid_parts[job.seg] = (_EMPTY_OPS, 0)  # type: ignore[attr-defined]
        elif job.kind == "left":
            r._left = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]
        else:
            r._right = (_EMPTY_OPS, 0, 0, 0)  # type: ignore[attr-defined]

    # ------------------------------------------------------------------
    def _finalize_many(
        self,
        groups: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
        cs: bool,
        md: bool,
    ) -> None:
        """Finalize every surviving region of a device batch at once:
        one python coordinate pass, ONE native finalize_batch call
        (CIGAR merge + stats + cs/MD for all regions of all reads),
        then the per-read set_parent/set_mapq tails.  Per-read native
        calls were the dominant host cost at high read rates (ctypes
        crossing + string buffer churn per read)."""
        with self.metrics.span("finalize"):
            self._finalize_many_impl(groups, codes, cs, md)

    def _finalize_many_impl(
        self,
        groups: List[Tuple[int, List[Region], int]],
        codes: List[np.ndarray],
        cs: bool,
        md: bool,
    ) -> None:
        from .. import native

        ref = self.index.ref_codes
        offs = self.index.seq_offsets
        # pass 1 (pure python, cheap): final coords + part lists.
        # Part CIGARs arrive packed (int32 len<<4|op) from the
        # extension engines; they stay packed into the native finalize.
        flat: List[Region] = []
        all_parts: List[np.ndarray] = []
        part_rev: List[int] = []
        reg_off: List[int] = [0]
        qsegs: List[np.ndarray] = []
        t_off_l: List[int] = []
        t_len_l: List[int] = []
        for ri, regions, _rl in groups:
            qlen = len(codes[ri])
            for r in regions:
                parts = getattr(r, "_mid_parts", [(_EMPTY_OPS, 0)])
                mid_sc = sum(sc for _, sc in parts)
                left = getattr(r, "_left", (_EMPTY_OPS, 0, 0, 0))
                right = getattr(r, "_right", (_EMPTY_OPS, 0, 0, 0))
                lc, lsc, lq, lt = left
                rc, rsc, rq, rt = right
                r.dp_score = mid_sc + lsc + rsc
                r.dp_max = r.dp_score
                qs_a, qe_a = r._qs_a, r._qe_a  # type: ignore[attr-defined]
                r.q_st_a = qs_a - lq
                r.q_en_a = qe_a + rq
                r.r_st = r.rs - lt
                r.r_en = r.re + rt
                all_parts.append(lc)
                part_rev.append(1)  # left flank was walked outward
                for c, _ in parts:
                    all_parts.append(c)
                    part_rev.append(0)
                all_parts.append(rc)
                part_rev.append(0)
                reg_off.append(len(all_parts))
                q_al = r._q_al  # type: ignore[attr-defined]
                roff = int(offs[r.rid])
                qsegs.append(q_al[r.q_st_a : r.q_en_a])
                t_off_l.append(roff + r.r_st)
                t_len_l.append(r.r_en - r.r_st)
                # read-forward query coords
                if r.rev == 0:
                    r.qs, r.qe = r.q_st_a, r.q_en_a
                else:
                    r.qs, r.qe = qlen - r.q_en_a, qlen - r.q_st_a
                r.rs, r.re = r.r_st, r.r_en
                flat.append(r)
        t_off = np.asarray(t_off_l, np.int64)
        t_len = np.asarray(t_len_l, np.int64)
        # pass 2: merge + stats + cs/MD for the whole region batch in
        # one native call (or the python oracle if the lib is absent)
        res = (
            native.finalize_batch(
                [cig.pack_ops(p) for p in all_parts],
                np.asarray(part_rev, np.uint8),
                np.asarray(reg_off, np.int32),
                qsegs, ref, t_off, t_len, cs, md,
            )
            if flat and native.available() else None
        )
        if res is not None:
            merged, stats, cs_strs, md_strs = res
            for gi, r in enumerate(flat):
                # keep the native merge's packed int32 ops: Mapping
                # unpacks lazily, and packed arrays cross the worker-
                # process pipe far cheaper than [(n,op)] tuple lists
                r.cigar = merged[gi]
                r.mlen, r.blen, r.nm = (
                    int(stats[gi, 0]), int(stats[gi, 1]), int(stats[gi, 2])
                )
                if cs:
                    r.cs = cs_strs[gi]
                if md:
                    r.md = md_strs[gi]
        else:
            for gi, r in enumerate(flat):
                parts_l = [
                    cig.unpack_ops(p)
                    for p in all_parts[reg_off[gi] : reg_off[gi + 1]]
                ]
                full = cig.merge_cigars(
                    [cig.reverse_cigar(parts_l[0])] + parts_l[1:]
                )
                r.cigar = full
                qseg = qsegs[gi]
                tseg = ref[int(t_off[gi]) : int(t_off[gi] + t_len[gi])]
                r.mlen, r.blen, r.nm = cig.cigar_stats(full, qseg, tseg)
                if cs:
                    r.cs = cig.gen_cs(full, qseg, tseg)
                if md:
                    r.md = cig.gen_md(full, qseg, tseg)
        for _ri, regions, rep_len in groups:
            # minimap2 re-runs mm_set_parent on ALIGNED coordinates
            # before mm_set_mapq (extension can shift qs/qe enough to
            # change the primary/secondary partition) — mirror that.
            set_parent(regions, self.opt.mask_level, self.opt.mask_len)
            # dp_max2: best DP score among each primary's secondaries —
            # the DP-branch discriminator in mm_set_mapq
            by_id = {r.id: r for r in regions}
            for r in regions:
                r.dp_max2 = 0
            for r in regions:
                if r.parent != r.id:
                    parent = by_id.get(r.parent)
                    if parent is not None and r.dp_score > parent.dp_max2:
                        parent.dp_max2 = r.dp_score
            set_mapq(
                regions, self.opt, rep_len=rep_len,
                is_sr=bool(self.opt.flag & _MM_F_SR),
            )


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes).astype(np.uint8)[::-1]
