"""Multi-device execution on torch: device grids, index sharding, the
collectives over a grid's "index" axis, and the decision step.

Port of the JAX package's parallel/mesh.py.  A grid (``make_mesh``) is
a [n_data, n_index] array of torch devices with two axes:

  "data"  — reads are data-parallel: each row maps its slice of a batch;
  "index" — the minimizer key table is sharded by sorted-key range
            (``shard_index_by_key_range``) over a row's devices, for
            references whose tables do not fit one device.

It plays the part of the JAX package's single-controller ``Mesh``: one
process drives every row it owns, one after the other, and each row's
work runs on its own devices.  A device may appear in several cells
(``["cuda:0"] * 4`` on a one-card machine, ``["cpu"] * 8`` in the
tests); each cell still holds its own blocks, so one card checks a
2 x 2 grid.

The three collectives that the JAX package's ``shard_map`` bodies use
over "index" are methods of ``IndexGroup`` (one data row's devices):
``all_gather``, ``psum`` and ``pmax``.  In one process they are tensor
moves and reductions across the row's devices.  "index" never leaves a
process (``make_mesh``'s layout rule; parallel/multihost.py), so they
never reach ``torch.distributed``.  A per-peer value is a list in peer
order; a collective's result is replicated: a dict with one tensor per
distinct device of the row, so work on it runs once per device, as
each device of the JAX mesh runs it once.

``build_sharded_map_step`` is the decision step (readfish-style: where
does a read map, on which strand, with what chain and extension
score): per row, the sketch, each shard's anchors, their all_gather and
re-sort, the block chaining DP, the best chain per read, and the
score-only banded extension of the whole read against the reference
block of the shard that owns its contig (kernel K3, run by every peer
over all of the row's reads, as the JAX body runs it), merged with a
pmax.  The step has no host sync, so on the card each row whose cells
sit on one device is one CUDA graph replay per batch shape
(models/graphs.py), the JAX package's one executable per shape; a row
spanning several cards runs its ops eagerly.  The full-CIGAR front ends
over a grid are models/pipeline.py's ``make_dp_front_end`` and
``make_sharded_front_end``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..index.index import resolve_device
from ..ops.chain import NEG_INF, ChainParams, chain_scores_block
from ..ops.extend import NEG as EXT_NEG
from ..ops.extend import ExtendParams
from ..ops.extend_kernel import extend_dp_kernel
from ..ops.lookup import KEY_MAX, collect_anchors_sorted, sort_merged
from ..ops.sketch import sketch_compact

AXES = ("data", "index")

#: the decision step's per-read outputs
DECISION_FIELDS = ("chain_score", "rev", "rid", "rpos", "ext_score",
                   "ext_end_t")


def P(*axes) -> tuple:
    """A partition spec: per array dimension "data", "index" or None
    (not split), as ``jax.sharding.PartitionSpec``; () = replicated."""
    return tuple(axes)


def _device(d) -> torch.device:
    """torch.device of `d`, a CUDA device with its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class IndexGroup:
    """The index peers of one data row and the row's collectives over
    "index".  Per-peer values are lists in peer order; results are
    replicated: {device: tensor}, one per distinct device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.distinct = list(dict.fromkeys(self.devices))

    def all_gather(self, xs: List[torch.Tensor]) -> Dict[torch.device, torch.Tensor]:
        """[n_index, *x.shape] on every device: the peers' values stacked."""
        return {d: torch.stack([x.to(d) for x in xs]) for d in self.distinct}

    def psum(self, xs: List[torch.Tensor]) -> Dict[torch.device, torch.Tensor]:
        out = {}
        for d in self.distinct:
            acc = xs[0].to(d)
            for x in xs[1:]:
                acc = acc + x.to(d)
            out[d] = acc
        return out

    def pmax(self, xs: List[torch.Tensor]) -> Dict[torch.device, torch.Tensor]:
        out = {}
        for d in self.distinct:
            acc = xs[0].to(d)
            for x in xs[1:]:
                acc = torch.maximum(acc, x.to(d))
            out[d] = acc
        return out


class DeviceMesh:
    """A [n_data, n_index] grid of torch devices with the axes ("data",
    "index").  ``devices`` is the numpy object array of the cells'
    devices; ``local_rows`` are the rows this process drives (every row,
    unless the grid spans processes: parallel/multihost.py, where the
    other processes' cells hold None)."""

    def __init__(self, devices: np.ndarray, local_rows: Optional[range] = None):
        self.devices = devices
        self.axis_names = AXES
        n_data, n_index = devices.shape
        self.shape = {"data": n_data, "index": n_index}
        self.local_rows = range(n_data) if local_rows is None else local_rows

    def group(self, row: int) -> IndexGroup:
        return IndexGroup(self.devices[row])

    def graph_rows(self, graphs) -> frozenset:
        """The local rows that run as graphs of `graphs` (a
        models/graphs.py GraphCache; None: no row): those whose cells
        all sit on one device that the cache captures on.  A CUDA graph
        captures on one device, so a row whose cells span several cards
        runs its ops eagerly: the layout decides, never a failed
        capture."""
        if graphs is None:
            return frozenset()
        return frozenset(
            r for r in self.local_rows
            if len(self.group(r).distinct) == 1
            and graphs.captures_on(self.devices[r, 0]))


def rows_of(n_data: int, n_index: int, devices=None) -> int:
    """n_data, or for n_data <= 0 every device (of `devices`, else every
    visible card) over n_index, at least 1: the entry points' default."""
    if n_data > 0:
        return n_data
    n_all = (len(devices) if devices is not None
             else torch.cuda.device_count() if torch.cuda.is_available() else 0)
    return max(n_all // max(n_index, 1), 1)


def make_mesh(n_data: int, n_index: int = 1, devices=None) -> DeviceMesh:
    """(data, index) grid over `devices`, row-major: consecutive devices
    share a row, so "index" peers are adjacent (the JAX package's
    layout rule: "index" stays inside a host, "data" may span hosts).

    Without `devices` the grid takes n_data * n_index distinct cards,
    cuda:0, cuda:1, ...; it raises if fewer are visible.  A caller may
    name one device several times to put several cells on it."""
    n = n_data * n_index
    if n_data < 1 or n_index < 1:
        raise ValueError(f"a {n_data} x {n_index} grid has no cell")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {n_data} x {n_index} grid needs {n} CUDA devices and "
                f"{have} are visible; pass devices= to name each cell's "
                f"device (e.g. devices=['cuda:0'] * {n} puts every cell "
                "on one card)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(
            f"a {n_data} x {n_index} grid needs {n} devices, got "
            f"{len(devices)}")
    cells = np.empty((n_data, n_index), object)
    for i, d in enumerate(devices[:n]):
        cells[i // n_index, i % n_index] = d
    return DeviceMesh(cells)


def shard_index_by_key_range(index, n_shards: int) -> dict:
    """Split the sorted key table into n contiguous range shards.

    Returns stacked host arrays with a leading shard axis, each shard
    padded to the same width with 0xFFFFFFFF key sentinels; position
    offsets are rebased per shard.  The JAX package's function, array
    for array, on the port's MinimizerIndex.
    """
    n = len(index.keys)
    bounds = [int(round(i * n / n_shards)) for i in range(n_shards + 1)]
    width = max(max(bounds[i + 1] - bounds[i] for i in range(n_shards)), 8)
    # pad to pow2 for the branchless binary search
    w2 = 1
    while w2 < width:
        w2 <<= 1
    width = w2
    key_hi = np.full((n_shards, width), 0xFFFFFFFF, np.uint32)
    key_lo = np.full((n_shards, width), 0xFFFFFFFF, np.uint32)
    offcnt = np.zeros((n_shards, width, 2), np.int32)
    n_keys = np.zeros((n_shards,), np.int32)
    pos_widths = []
    pos_shards = []
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        ks = index.keys[a:b]
        key_hi[s, : b - a] = (ks >> np.uint64(32)).astype(np.uint32)
        key_lo[s, : b - a] = (ks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pa = int(index.key_offsets[a])
        pb = int(index.key_offsets[b])
        offcnt[s, : b - a, 0] = (
            index.key_offsets[a:b].astype(np.int64) - pa
        ).astype(np.int32)
        offcnt[s, : b - a, 1] = (
            index.key_offsets[a + 1 : b + 1] - index.key_offsets[a:b]
        ).astype(np.int32)
        n_keys[s] = b - a
        pos = index.positions[pa:pb]
        rp = np.zeros((len(pos), 2), np.int32)
        rp[:, 0] = (pos >> np.uint64(32)).astype(np.int32)
        rp[:, 1] = (
            (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        )
        pos_shards.append(rp)
        pos_widths.append(pb - pa)
    pw = max(max(pos_widths), 8)
    pos_rp = np.zeros((n_shards, pw, 2), np.int32)
    for s in range(n_shards):
        pos_rp[s, : pos_widths[s]] = pos_shards[s]
    # the packed reference is sharded too, into CONTIG-RANGE blocks: each
    # shard owns a contiguous rid range, concatenated with per-shard
    # local offsets, so every device coordinate stays shard-local int32
    # and an extension window never crosses a shard boundary
    seq_lens = index.seq_lens.astype(np.int64)
    n_seq = len(seq_lens)
    if n_seq and int(seq_lens.max()) >= 2**31:
        raise OverflowError(
            "a single contig exceeds 2^31 bp; per-contig device "
            "coordinates (and minimap2 itself) cap contigs at 2^31"
        )
    # greedy contiguous partition of contigs into n_shards bins,
    # balanced by total length
    total_len = int(seq_lens.sum())
    target = total_len / max(n_shards, 1)
    rid_bounds = [0]
    acc = 0
    for rid in range(n_seq):
        acc += int(seq_lens[rid])
        if (acc >= target * len(rid_bounds)
                and len(rid_bounds) < n_shards):
            rid_bounds.append(rid + 1)
    while len(rid_bounds) < n_shards:
        rid_bounds.append(n_seq)
    rid_bounds.append(n_seq)
    rid2shard = np.zeros(max(n_seq, 1), np.int32)
    loc_off = np.zeros(max(n_seq, 1), np.int32)
    shard_lens = []
    for s in range(n_shards):
        a, b = rid_bounds[s], rid_bounds[s + 1]
        rid2shard[a:b] = s
        off = 0
        for rid in range(a, b):
            loc_off[rid] = off
            off += int(seq_lens[rid])
        shard_lens.append(off)
    blk = max((max(shard_lens) + 127) // 128 * 128 + 128, 256)
    if blk >= 2**31:
        raise OverflowError(
            "a contig-range shard exceeds 2^31 bp; use more index "
            "shards so each shard's contigs fit int32 offsets"
        )
    ref_blocks = np.full((n_shards, blk), 4, np.uint8)
    offs64 = index.seq_offsets  # int64 [n_seq+1], host only
    for s in range(n_shards):
        a, b = rid_bounds[s], rid_bounds[s + 1]
        if b > a:
            lo = int(offs64[a])
            hi = int(offs64[b])
            ref_blocks[s, : hi - lo] = index.ref_codes[lo:hi]
    return {
        "key_hi": key_hi,
        "key_lo": key_lo,
        "offcnt": offcnt,
        "n_keys": n_keys,
        "pos_rp": pos_rp,
        "ref_blocks": ref_blocks,  # [n_shards, blk] contig-range rows
        "rid2shard": rid2shard,    # int32 [n_seq] replicated
        "loc_off": loc_off,        # int32 [n_seq] shard-local offsets
    }


def device_shards(sh: dict, names: Sequence[str] = (
        "keys", "offcnt", "n_keys", "pos_rp", "ref_blocks", "rid2shard",
        "loc_off")) -> dict:
    """The arrays of ``shard_index_by_key_range`` that the device steps
    read (`names`), with the (key_hi, key_lo) words joined into one
    int64 ``keys`` [n_shards, width] whose all-ones padding becomes
    KEY_MAX (above every key of at most 62 bits), the sorted array that
    ops/lookup.py ``probe_sorted`` searches."""
    out = {}
    for name in names:
        if name == "keys":
            pad = (sh["key_hi"] == 0xFFFFFFFF) & (sh["key_lo"] == 0xFFFFFFFF)
            keys = (sh["key_hi"].astype(np.int64) << 32) | sh["key_lo"]
            out[name] = np.where(pad, KEY_MAX, keys)
        else:
            out[name] = sh[name]
    return out


class Placed:
    """A global array as one process holds it on a grid:
    ``blocks[(row, col)]`` is cell (row, col)'s block, on the cell's
    device, for the cells of the process's rows (parallel/multihost.py
    ``put_global``).  Cells that share a device and a block share one
    tensor."""

    def __init__(self, shape: tuple, spec: tuple, blocks: dict):
        self.shape = tuple(shape)
        self.spec = spec
        self.blocks = blocks

    def rows(self) -> List[int]:
        return sorted({r for r, _ in self.blocks})


def _revcomp_batch(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement within true length, padding stays 4."""
    B, L = codes.shape
    pos = torch.arange(L, device=codes.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - pos
    g = torch.gather(codes, 1, src.clamp(0, L - 1))
    comp = torch.where(g < 4, 3 - g, g)
    return torch.where(src >= 0, comp, 4).to(codes.dtype)


def _best_chains(an: dict, chain_params: ChainParams, chain_window: int) -> dict:
    """Block chain DP over one row's merged anchors, then each read's
    best-scoring anchor (the first of equals): its f and coordinates."""
    f, _p = chain_scores_block(an, chain_params, chain_window)
    fv = torch.where(an["valid"], f, NEG_INF)
    best = fv.argmax(dim=1, keepdim=True)
    out = {"chain_score": torch.gather(fv, 1, best)[:, 0]}
    for name in ("rev", "rid", "rpos", "qpos"):
        out[name] = torch.gather(an[name], 1, best)[:, 0]
    return out


def _extend_owned(peer: int, codes, lens, best: dict, sh: dict, W: int,
                  ext_params: ExtendParams):
    """One index peer's part of the decision extension, in the JAX
    body's static form: every read of the row extended score-only over
    a window of this peer's reference block on its best chain's diagonal
    (kernel K3, W band lanes, J = the row's B), kept where the chain's
    contig lies in this peer's block.  Returns the per-read (score, end
    on the contig) with -2^30 where another peer owns the read; a read
    of length 0 has no DP cell, so it keeps (EXT_NEG, the window's start
    + 1)."""
    B, L = codes.shape
    ref_block = sh["ref_blocks"][0]  # [blk] this shard's contigs
    TWIN = L + W
    blk = ref_block.shape[0]
    rid = best["rid"].to(torch.int64)
    loc_off = sh["loc_off"][rid]
    # shard-local offset of query position 0 on the best diagonal
    diag_start = loc_off + best["rpos"] - best["qpos"]
    start = torch.clamp(diag_start - W // 2, 0, blk - TWIN)
    mine = sh["rid2shard"][rid] == peer
    twin = ref_block[start[:, None].to(torch.int64)
                     + torch.arange(TWIN, device=codes.device)]
    q_al = torch.where(best["rev"][:, None] == 1,
                       _revcomp_batch(codes, lens), codes)
    ext = extend_dp_kernel(
        q_al.contiguous(), twin.contiguous(), lens.to(torch.int32),
        torch.clamp(lens + W, max=TWIN).to(torch.int32), W, ext_params)
    has = lens > 0
    neg = torch.full((B,), -(1 << 30), dtype=torch.int32, device=codes.device)
    score = torch.where(mine, torch.where(has, ext["best_sc"], EXT_NEG), neg)
    end = torch.where(has, start + ext["best_j"], start) + 1 - loc_off
    return score, torch.where(mine, end, neg)


def _decision_row(grp: IndexGroup, codes: dict, lens: dict, shards: list, *,
                  k, w, M, A_loc, chain_params, ext_params, mid_occ,
                  chain_window, ext_window) -> dict:
    """The decision step of one data row.  codes / lens: {device:
    tensor}, the row's reads on each of its devices; shards: per peer,
    the peer's blocks (leading shard axis of 1).  Returns {device:
    {field: [B] int32}}."""
    L = next(iter(codes.values())).shape[1]
    TWIN = L + ext_window
    blk = shards[0]["ref_blocks"].shape[1]
    if TWIN > blk:
        raise ValueError(
            f"extension window {TWIN} exceeds the reference shard "
            f"width {blk}"
        )
    mins = {d: sketch_compact(codes[d], lens[d], k, w, M) for d in grp.distinct}
    loc = [
        collect_anchors_sorted(
            mins[d], lens[d],
            {n: sh[n][0] for n in ("keys", "offcnt", "n_keys", "pos_rp")},
            mid_occ, A_loc, k)
        for d, sh in zip(grp.devices, shards)
    ]
    # merge the shards' anchors: all_gather over "index", then re-sort
    g = {n: grp.all_gather([a[n] for a in loc])
         for n in ("rev", "rid", "rpos", "qpos", "valid")}
    best = {d: _best_chains(sort_merged({n: g[n][d] for n in g}),
                            chain_params, chain_window)
            for d in grp.distinct}
    # the best chain is the same on every peer; the peer whose contig
    # range holds it extends it, and the scalars merge with a pmax
    parts = [_extend_owned(c, codes[d], lens[d], best[d], sh, ext_window,
                           ext_params)
             for c, (d, sh) in enumerate(zip(grp.devices, shards))]
    ext_sc = grp.pmax([s for s, _ in parts])
    ext_end = grp.pmax([e for _, e in parts])
    return {d: {"chain_score": best[d]["chain_score"], "rev": best[d]["rev"],
                "rid": best[d]["rid"], "rpos": best[d]["rpos"],
                "ext_score": ext_sc[d], "ext_end_t": ext_end[d]}
            for d in grp.distinct}


def build_sharded_map_step(
    mesh: DeviceMesh,
    k: int,
    w: int,
    max_minimizers: int,
    max_anchors: int,
    chain_params: ChainParams,
    ext_params: ExtendParams,
    mid_occ: int,
    chain_window: int = 16,
    ext_window: int = 64,
    graphs=None,
):
    """The decision step over a (data, index) grid.

    step(codes, lens, shards) takes Placed arrays (parallel/multihost.py
    ``put_global``): codes uint8 [B, L] and lens int32 [B] split over
    "data" (P("data", None), P("data")), and the ``device_shards``
    arrays as ``shard_specs_for_index`` places them.  It returns
    {field: Placed int32 [B] over "data"} for DECISION_FIELDS: per read
    the best chain's score, strand (2 where no anchor), contig and
    reference position, and the score-only banded extension's score
    and end on the contig.  ``gather_results`` brings them to numpy.

    The reference is sharded into contig-range blocks over "index"; the
    shard owning a read's contig keeps its extension and the two scalars
    merge with a pmax, so nothing reference-sized is replicated, and
    every device coordinate is shard-local int32.

    `graphs`: a models/graphs.py GraphCache through which each of this
    process's ``mesh.graph_rows(graphs)`` (rows whose cells sit on one
    card) runs as one CUDA graph per (row, B_row, L, the static
    keywords, the shards' identity), copy-in, replay and copy-out under
    the graph's lock; the other rows, and every row when `graphs` is
    None, run their ops eagerly.  ``step.graphs`` is the cache.
    """
    n_index = mesh.shape["index"]
    kw = dict(k=k, w=w, M=max_minimizers, A_loc=max_anchors,
              chain_params=chain_params, ext_params=ext_params,
              mid_occ=mid_occ, chain_window=chain_window,
              ext_window=ext_window)
    rows = mesh.graph_rows(graphs)
    static = tuple(sorted(kw.items()))

    def run_row(row: int, grp: IndexGroup, codes: Placed, lens: Placed,
                sh: Dict[str, Placed]) -> dict:
        cells = [(row, c) for c in range(n_index)]
        shards = [{n: a.blocks[cell] for n, a in sh.items()}
                  for cell in cells]
        if row not in rows:
            return _decision_row(
                grp,
                {grp.devices[c]: codes.blocks[cell]
                 for c, cell in enumerate(cells)},
                {grp.devices[c]: lens.blocks[cell]
                 for c, cell in enumerate(cells)},
                shards, **kw)
        # the row's cells share one device, and so one block of the reads
        dev = grp.distinct[0]
        like = {"codes": codes.blocks[cells[0]], "lens": lens.blocks[cells[0]]}
        B_row, L = like["codes"].shape

        def make_fn(inputs):
            def fn():
                res = _decision_row(grp, {dev: inputs["codes"]},
                                    {dev: inputs["lens"]}, shards, **kw)[dev]
                return tuple(res[n] for n in DECISION_FIELDS)
            return fn

        g = graphs.get(("decision", str(dev), row, B_row, L, static, id(sh)),
                       {"device": str(dev), "row": row, "B": B_row, "L": L},
                       dev, sh, like, make_fn)
        out = graphs.run(g, like, dev, lambda *o: [x.clone() for x in o])
        return {dev: dict(zip(DECISION_FIELDS, out))}

    def step(codes: Placed, lens: Placed, sh: Dict[str, Placed]) -> dict:
        blocks = {n: {} for n in DECISION_FIELDS}
        for row in mesh.local_rows:
            grp = mesh.group(row)
            res = run_row(row, grp, codes, lens, sh)
            for n in DECISION_FIELDS:
                for c in range(n_index):
                    blocks[n][(row, c)] = res[grp.devices[c]][n]
        return {n: Placed((codes.shape[0],), P("data"), b)
                for n, b in blocks.items()}

    step.graphs = graphs
    return step
