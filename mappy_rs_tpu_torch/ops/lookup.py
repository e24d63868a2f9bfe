"""Seed lookup + anchor collection as torch tensor ops.

The port of the JAX package's ops/lookup.py (``mm_idx_get`` +
``collect_seed_hits``): query minimizers are matched against the
index's hash-probe table with one two-row window gather, occurrence
filters and the seed rescue thin the hits, and the surviving hit runs
are expanded into a fixed per-read anchor budget with a prefix-sum slot
assignment and sorted per read.

Anchor convention (matches minimap2's seed records so the chaining
scores are comparable):
  rev   = query strand XOR reference strand
  rpos  = position of the k-mer's LAST base on the forward ref strand
  qpos  = k-mer END on the query if rev==0,
          else qlen-1 - (end+1-span) (END in reversed-query coords)
Anchors are sorted per read by (rev, rid, rpos, qpos).

Torch has no multi-key sort, so multi-key orders are built from stable
single-key sorts, least significant key first.  Ties the JAX package's
``lax.sort`` leaves to the backend are broken by slot index here.

Both hash-probe layouts of index/index.py are probed: one word (keys
of at most 31 bits) and two words (keys of 32 to 62 bits, k >= 16).
Everything runs as static-shape tensor ops: no host sync between the
upload and the chain table's download.

A key-range shard of the multi-device paths (parallel/mesh.py) is no
hash table but a sorted key array padded with KEY_MAX: ``probe_sorted``
binary-searches it (the JAX package's ``probe_index(..., keys32=False)``
over its two-word sorted layout), and ``sort_merged`` re-sorts the
anchors that the shards of one data row gathered.
"""
from __future__ import annotations

import torch

from ..index.index import DeviceIndex, mix32

#: mm_seed_select's MAX_MAX_HIGH_OCC — cap on rescued seeds per gap
MAX_HIGH_OCC_PER_GAP = 128
_BIG = 0x7FFFFFFF
#: above every key and every invalid-slot key; pads key-range shards
KEY_MAX = (1 << 63) - 1


def _excl_cummax(x: torch.Tensor) -> torch.Tensor:
    """[0, cummax(x)[:, :-1]] along dim 1."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([zero, torch.cummax(x, dim=1).values[:, :-1]], dim=1)


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Per-row permutation sorting by `keys` (most significant first),
    ties by position: stable sorts, least significant key first."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, 1, perm)
        o = torch.sort(k, dim=1, stable=True).indices
        perm = o if perm is None else torch.gather(perm, 1, o)
    return perm


def probe_index(mins: dict, dev: DeviceIndex):
    """Match query minimizers against the hash-probe table.

    slot h = mix(key) >> hash_shift (the build's mix for the table's
    layout); a present key lies in [h, h+128], fully inside rows h>>7
    and h>>7 + 1, which one gather fetches.  Returns (found [B, M]
    bool, oc [B, M, 2] int32 (offset, count)); oc rows are garbage where
    ~found, and equal the JAX probe's there too."""
    key = mins["key"]  # int64, the sketch's inf_key on invalid slots
    B, M = key.shape
    n_rows = dev.hash_rows.shape[0]
    n_pad = dev.offcnt.shape[0]
    # two words: the JAX package mixes (lo32, key >> 31) as uint32
    # words; for the wide sentinel 2^63-1 both are 0xFFFFFFFF, as for
    # its (0xFFFFFFFF, 0xFFFFFFFF), so even invalid slots probe alike
    mixed = mix32(key, dev.two_word)
    if dev.two_word:
        q = key
    else:
        # the table stores uint32 words as int32: the sentinel key
        # compares as -1, i.e. like the JAX probe it matches empty
        # slots, whose hash_val is the n_keys sentinel
        q = torch.where(key == 0xFFFFFFFF, -1, key).to(torch.int32)
    h = mixed >> dev.hash_shift
    # invalid slots carry the sentinel key: clamp the row so the window
    # gather stays in bounds (they match nothing real)
    r = torch.clamp(h >> 7, max=n_rows - 2)
    win = dev.hash_rows[r[:, :, None] + torch.arange(2, device=key.device)]
    match = win.reshape(B, M, 256) == q[:, :, None]
    lane = match.to(torch.uint8).argmax(dim=-1)  # first True
    idx = dev.hash_val[(r << 7) + lane].to(torch.int64)
    idx_c = torch.clamp(idx, max=n_pad - 1)
    found = match.any(dim=-1) & (idx < dev.n_keys) & (mins["pos"] >= 0)
    return found, dev.offcnt[idx_c]


def seed_select_keep(pos, cnt, found, qlens, mid_occ, occ_dist, max_max_occ):
    """Seed occurrence thinning / rescue (minimap2's ``mm_seed_select``).

    Seeds with occurrence > mid_occ are dropped, except that each
    maximal run of high-occurrence seeds between two low-occurrence
    seeds (query positions ps..pe; 0 / qlen at the ends) gets up to
    ``floor((pe-ps)/occ_dist + 0.499)`` (capped at 128) of its
    lowest-occurrence members rescued, provided their occurrence is
    <= max_max_occ.  Members tied on occurrence rank by slot (query
    position) order.

    [B, M] inputs except qlens [B] and the scalars; ``pos`` ascends over
    valid slots.  Returns (keep, rescued) bool masks."""
    B, M = pos.shape
    pos = pos.to(torch.int64)
    cnt = cnt.to(torch.int64)
    is_low = found & (cnt <= mid_occ)
    is_high = found & (cnt > mid_occ)
    # ps: position of the last low-occ seed strictly before each slot
    ps = _excl_cummax(torch.where(is_low, pos, 0))
    # pe: position of the first low-occ seed strictly after (qlen if none)
    low_pos_r = torch.where(is_low, pos, _BIG)
    suffix_min = torch.flip(
        torch.cummin(torch.flip(low_pos_r, [1]), dim=1).values, [1]
    )
    pe = torch.cat([suffix_min[:, 1:], torch.full_like(pos[:, :1], _BIG)], 1)
    pe = torch.minimum(pe, qlens.to(torch.int64)[:, None])
    # budget per gap: floor(gap/dist + 0.499) in exact integer arithmetic
    gap = torch.clamp(pe - ps, min=0)
    max_high = torch.clamp(
        (gap * 1000 + 499 * occ_dist) // (1000 * occ_dist),
        max=MAX_HIGH_OCC_PER_GAP,
    )
    # rank eligible high-occ seeds within their gap by (occurrence, slot)
    gap_id = torch.cumsum(is_low.to(torch.int64), dim=1)
    elig = is_high & (cnt <= max_max_occ)
    g_key = torch.where(elig, gap_id, _BIG)
    order = _stable_order(g_key, cnt)
    s_g = torch.gather(g_key, 1, order)
    iota = torch.arange(M, device=pos.device).expand(B, M)
    first = torch.cat(
        [torch.ones_like(s_g[:, :1], dtype=torch.bool), s_g[:, 1:] != s_g[:, :-1]],
        dim=1,
    )
    seg_start = torch.cummax(torch.where(first, iota, 0), dim=1).values
    rank = torch.empty_like(iota).scatter_(1, order, iota - seg_start)
    rescued = elig & (rank < max_high)
    return is_low | rescued, rescued


def _slot_sources(prefix: torch.Tensor, cnt: torch.Tensor, n_slots: int):
    """For each anchor slot a in [0, n_slots): the index m of the
    minimizer whose hit range [prefix[m], prefix[m+1]) contains a.
    Scatter each nonempty minimizer's index at its START slot (starts
    past the budget go to a dropped extra column), then a running max
    fills its range."""
    B, M = cnt.shape
    starts = torch.clamp(prefix[:, :-1], max=n_slots)
    m_iota = torch.arange(M, device=cnt.device).expand(B, M)
    grid = torch.full((B, n_slots + 1), -1, dtype=torch.int64, device=cnt.device)
    grid.scatter_reduce_(1, starts, torch.where(cnt > 0, m_iota, -1), "amax")
    return torch.clamp(torch.cummax(grid[:, :n_slots], dim=1).values, min=0)


def filter_counts(mins, qlens, found, cnt_raw, mid_occ, span,
                  q_occ_frac=0.0, occ_dist=0, max_max_occ=0):
    """Occurrence thinning / seed rescue / query-repeat filtering.
    Returns (cnt [B, M] post-filter counts int64, rep_len [B] int32)."""
    pos = mins["pos"].to(torch.int64)
    B, M = pos.shape
    if occ_dist > 0 and max_max_occ > 0:
        keep, rescued = seed_select_keep(
            pos, cnt_raw, found, qlens, mid_occ, occ_dist, max_max_occ
        )
        cnt = torch.where(keep, cnt_raw, 0)
    else:
        rescued = None
        cnt = torch.where(cnt_raw > mid_occ, 0, cnt_raw)
    # rep_len: union length of query intervals covered by occ-filtered
    # seeds (mm_collect_matches' rep_st/rep_en accounting); slots are in
    # ascending end-position order, so the union is an exclusive cummax
    filt = found & (cnt_raw > mid_occ)
    if rescued is not None:
        filt = filt & ~rescued
    en_f = torch.where(filt, pos + 1, 0)
    st_f = pos + 1 - mins["span"].to(torch.int64)
    contrib = torch.clamp(en_f - torch.maximum(st_f, _excl_cummax(en_f)), min=0)
    rep_len = torch.where(filt, contrib, 0).sum(dim=1).to(torch.int32)
    if q_occ_frac > 0.0:
        # query-side repeat filter: drop minimizers over-represented
        # WITHIN the read — sort keys per read, measure each equal run,
        # scatter the run lengths back to slot order
        slot_valid = pos >= 0
        iota = torch.arange(M, device=pos.device).expand(B, M)
        # invalid slots sort last, apart from every key (a 32-bit key
        # can equal the narrow sentinel), as the JAX package's
        # (0xFFFFFFFF, 0xFFFFFFFF) does
        vkey = torch.where(slot_valid, mins["key"], KEY_MAX)
        s_key, s_idx = torch.sort(vkey, dim=1, stable=True)
        first = torch.cat(
            [torch.ones_like(s_key[:, :1], dtype=torch.bool),
             s_key[:, 1:] != s_key[:, :-1]], dim=1,
        )
        last = torch.cat([first[:, 1:], torch.ones_like(first[:, :1])], dim=1)
        seg_start = torch.cummax(torch.where(first, iota, 0), dim=1).values
        seg_end = torch.flip(
            torch.cummin(
                torch.flip(torch.where(last, iota + 1, M), [1]), dim=1
            ).values, [1],
        )
        q_cnt = torch.empty_like(iota).scatter_(1, s_idx, seg_end - seg_start)
        n_mins = slot_valid.sum(dim=1, keepdim=True)
        # float32 product truncated, as the JAX package computes it
        q_thresh = torch.clamp(
            (n_mins.to(torch.float32) * q_occ_frac).to(torch.int64), min=10
        )
        cnt = torch.where(q_cnt > q_thresh, 0, cnt)
    return cnt, rep_len


def expand_anchors(mins, qlens, cnt, off, pos_rp, max_anchors):
    """Expand per-minimizer hit runs into the sorted [B, A] anchor
    tensors (int32 rev/rid/rpos/qpos/span, bool valid)."""
    B, M = cnt.shape
    A = max_anchors
    dev = cnt.device
    prefix = torch.cat(
        [torch.zeros_like(cnt[:, :1]), torch.cumsum(cnt, dim=1)], dim=1
    )
    n_anchors = torch.clamp(prefix[:, -1], max=A)
    slots = torch.arange(A, device=dev).expand(B, A)
    src = _slot_sources(prefix, cnt, A)  # minimizer slot per anchor
    a_valid = slots < n_anchors[:, None]
    doff = off.to(torch.int64) - prefix[:, :-1]
    pos_idx = torch.where(a_valid, slots + torch.gather(doff, 1, src), 0)
    rp = pos_rp[pos_idx]  # [B, A, 2]: rid AND pos in one gather
    rid = rp[..., 0].to(torch.int64)
    ps = rp[..., 1].to(torch.int64) & 0xFFFFFFFF  # uint32 bits, logical shift
    rpos = ps >> 1
    q_pos = torch.gather(mins["pos"].to(torch.int64), 1, src)
    q_strand = torch.gather(mins["strand"].to(torch.int64), 1, src)
    q_span = torch.gather(mins["span"].to(torch.int64), 1, src)
    rev = q_strand ^ (ps & 1)
    qpos = torch.where(
        rev == 0, q_pos, qlens.to(torch.int64)[:, None] - (q_pos + 1 - q_span) - 1
    )
    # sort per read by (valid-last, rev, rid, rpos, qpos): two stable
    # passes, qpos then the packed (sort_first, rid, rpos) word.  Full
    # ties occur only among invalid slots.
    sort_first = torch.where(a_valid, rev, 2)
    packed = (sort_first << 61) | (rid << 31) | rpos
    order = _stable_order(packed, qpos)

    def srt(x):
        return torch.gather(x, 1, order).to(torch.int32)

    return {
        "rev": srt(rev),
        "rid": srt(rid),
        "rpos": srt(rpos),
        "qpos": srt(qpos),
        "valid": torch.gather(a_valid, 1, order),
        "span": srt(q_span),
        "n": n_anchors.to(torch.int32),
        # pre-truncation hit total: reads whose hits overflowed the A
        # budget are remapped with a boosted budget by the engine
        "n_raw": prefix[:, -1].to(torch.int32),
    }


def _collect(mins, qlens, found, oc, pos_rp, mid_occ, max_anchors, span,
             q_occ_frac, occ_dist, max_max_occ):
    """filter_counts -> expand_anchors on a probe's (found, oc)."""
    cnt_raw = torch.where(found, oc[..., 1].to(torch.int64), 0)
    cnt, rep_len = filter_counts(
        mins, qlens, found, cnt_raw, mid_occ, span,
        q_occ_frac, occ_dist, max_max_occ,
    )
    out = expand_anchors(mins, qlens, cnt, oc[..., 0], pos_rp, max_anchors)
    out["rep_len"] = rep_len
    return out


def collect_anchors(mins: dict, qlens: torch.Tensor, dev: DeviceIndex,
                    mid_occ: int, max_anchors: int, span: int,
                    q_occ_frac: float = 0.0, occ_dist: int = 0,
                    max_max_occ: int = 0):
    """Expand query minimizers (sketch_compact output) into sorted
    anchors: probe_index -> filter_counts -> expand_anchors.

    Returns dict with [B, A] rev/rid/rpos/qpos/span (int32), valid
    (bool), and n / n_raw / rep_len [B] int32."""
    return _collect(mins, qlens, *probe_index(mins, dev), dev.pos_rp, mid_occ,
                    max_anchors, span, q_occ_frac, occ_dist, max_max_occ)


def probe_sorted(mins: dict, keys: torch.Tensor, offcnt: torch.Tensor,
                 n_keys):
    """Match query minimizers against a sorted key array: a key-range
    shard's int64 `keys` [n_pad] (ascending, padded with KEY_MAX), its
    `offcnt` [n_pad, 2] and its key count `n_keys`.  A lower-bound
    binary search per minimizer, as the JAX package's
    ``_lower_bound_2key``; returns (found [B, M] bool, oc [B, M, 2]) as
    ``probe_index`` does (oc rows are garbage where ~found)."""
    q = mins["key"]
    n_pad = keys.shape[0]
    idx = torch.searchsorted(keys, q.contiguous())
    idx_c = torch.clamp(idx, max=n_pad - 1)
    found = (idx < n_keys) & (keys[idx_c] == q) & (mins["pos"] >= 0)
    return found, offcnt[idx_c]


def collect_anchors_sorted(mins: dict, qlens: torch.Tensor, shard: dict,
                           mid_occ: int, max_anchors: int, span: int):
    """collect_anchors against one key-range shard (``keys``,
    ``offcnt``, ``n_keys``, ``pos_rp`` of parallel/mesh.py
    ``device_shards``): probe_sorted -> filter_counts on the shard's own
    counts (a minimizer's key lies in one shard only) -> expand_anchors
    into shard-local positions."""
    found, oc = probe_sorted(mins, shard["keys"], shard["offcnt"],
                             shard["n_keys"])
    return _collect(mins, qlens, found, oc, shard["pos_rp"], mid_occ,
                    max_anchors, span, 0.0, 0, 0)


def sort_merged(gathered: dict) -> dict:
    """One data row's anchors gathered from its key-range shards
    ([n_index, B, A_loc] per field: rev, rid, rpos, qpos, valid and
    optionally span) as one [B, n_index * A_loc] set, each read's
    shards in order, re-sorted by (valid-last, rev, rid, rpos, qpos).
    As in the JAX package, ``rev`` comes back as the sort key: 2 on
    invalid slots."""
    flat = {k: v.movedim(0, 1).reshape(v.shape[1], -1)
            for k, v in gathered.items()}
    valid = flat["valid"]
    sort_first = torch.where(valid, flat["rev"], 2).to(torch.int64)
    packed = ((sort_first << 61) | (flat["rid"].to(torch.int64) << 31)
              | flat["rpos"].to(torch.int64))
    order = _stable_order(packed, flat["qpos"])
    out = {k: torch.gather(v, 1, order) for k, v in flat.items()}
    out["rev"] = torch.gather(sort_first.to(torch.int32), 1, order)
    return out
