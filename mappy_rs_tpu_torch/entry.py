"""Top-level entry points of the port: a one-device forward step and a
multi-device dry run.

entry(device)                -> (fn, example_args): the front end's
                                forward step (sketch, seed lookup,
                                block chaining DP) on one device.
dryrun_multichip(n, devices) -> runs the decision step over an n-device
                                (data x index) grid (data-parallel reads,
                                the key table sharded by key range, an
                                all_gather anchor merge), then the
                                full-CIGAR map over a data-parallel grid
                                and over a sharded one, and checks them.

The counterparts of the JAX package's __graft_entry__.py.  Their
workload is a seeded multi-contig genome (utils/simulate.py) with 8
reads that are exact copies of contig slices, so every chain scores.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

#: the workload: contig lengths, and the [B, L] read batch
CONTIG_LENS = (50_000, 40_000, 30_000, 20_000)
B, L = 8, 512
SEED = 20261017


def _workload(device="cpu"):
    """(index on `device`, map options, codes [B, L] uint8, lens [B]
    int32, contigs, reads): read 0 is contig 0's first 400 bases, the
    others slices of 300-512 bases of contig i % 4."""
    from .config import IndexOptions, MapOptions
    from .index.build import build_index
    from .utils.seqcodes import encode
    from .utils.simulate import random_genome

    rng = np.random.default_rng(SEED)
    contigs = [random_genome(rng, n) for n in CONTIG_LENS]
    reads = [contigs[0][:400]]
    for i in range(1, B):
        c = contigs[i % len(contigs)]
        n = int(rng.integers(300, L + 1))
        s = int(rng.integers(0, len(c) - n))
        reads.append(c[s: s + n])
    idx = build_index([(f"c{i}", c) for i, c in enumerate(contigs)],
                      IndexOptions(), device=device)
    opt = MapOptions()
    idx.update_map_options(opt)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode(r)
        lens[i] = len(r)
    return idx, opt, codes, lens, contigs, reads


def _chain_params(idx, opt):
    from .ops.chain import ChainParams

    return ChainParams(
        max_dist_x=opt.max_gap,
        max_dist_y=opt.max_gap,
        bw=opt.bw,
        q_span=idx.k,
        chn_pen_gap=opt.chain_gap_scale * 0.01 * idx.k,
        chn_pen_skip=0.0,
    )


def entry(device="cuda"):
    """The one-device forward step: fn(codes, lens) -> (f, p, rpos, rev)
    of the block chaining DP (block 32) over the anchors of the
    workload's reads, and its example arguments on `device`."""
    import torch

    from .index.index import resolve_device
    from .ops.chain import chain_scores_block
    from .ops.lookup import collect_anchors
    from .ops.sketch import sketch_compact

    dev_t = resolve_device(device)
    idx, opt, codes, lens, _contigs, _reads = _workload(dev_t)
    dev = idx.device_index(dev_t)
    cp = _chain_params(idx, opt)

    def fwd(codes, lens):
        mins = sketch_compact(codes, lens, idx.k, idx.w, 128)
        anchors = collect_anchors(mins, lens, dev, int(opt.mid_occ), 256,
                                  idx.k)
        f, p = chain_scores_block(anchors, cp, 32)
        return f, p, anchors["rpos"], anchors["rev"]

    return fwd, (torch.from_numpy(codes).to(dev_t),
                 torch.from_numpy(lens).to(dev_t))


def _hit_fields(hits) -> list:
    return [(m[0].ctg, m[0].r_st, m[0].r_en, m[0].cigar_str, m[0].cs)
            for m in hits]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the decision step on an n-device grid, then map the workload's
    reads with full CIGARs over a data-parallel grid and over a sharded
    one; raises unless every chain scores > 40, every extension > 0, the
    two grids give the same Mappings and the sharded Aligner built no
    replicated tables.  `devices` names each cell's device (e.g.
    ["cuda:0"] * 4 on one card); by default n distinct cards."""
    from .api import Aligner
    from .index.index import resolve_device
    from .models.graphs import GraphCache
    from .ops.extend import ExtendParams
    from .parallel.mesh import (P, build_sharded_map_step, device_shards,
                                make_mesh, shard_index_by_key_range)
    from .parallel.multihost import (gather_results, put_global,
                                     put_global_tree, shard_specs_for_index)
    from .utils.metrics import EngineMetrics

    al_device = str(resolve_device(devices[0] if devices else "cuda"))
    idx, opt, codes, lens, contigs, reads = _workload("cpu")
    # 2-D grid: data-parallel reads x key-range-sharded index
    n_index = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_index
    mesh = make_mesh(n_data, n_index, devices)
    shards = put_global_tree(
        device_shards(shard_index_by_key_range(idx, n_index)), mesh,
        shard_specs_for_index())
    ep = ExtendParams(a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2,
                      e2=opt.e2, sc_ambi=opt.sc_ambi)
    step = build_sharded_map_step(
        mesh, idx.k, idx.w, max_minimizers=64, max_anchors=128,
        chain_params=_chain_params(idx, opt), ext_params=ep,
        mid_occ=int(opt.mid_occ), chain_window=16, ext_window=64,
        graphs=GraphCache(EngineMetrics(), "dec_graph"))
    nb = max(n_data * 2, 8)
    codes_b = np.tile(codes, (nb // B + 1, 1))[:nb]
    lens_b = np.tile(lens, nb // B + 1)[:nb]
    out = gather_results(step(put_global(codes_b, mesh, P("data", None)),
                              put_global(lens_b, mesh, P("data")), shards))
    cs, es = out["chain_score"], out["ext_score"]
    # the workload's reads are exact contig copies: every chain scores
    if cs.shape != (nb,) or not (cs > 40).all():
        raise AssertionError(f"chain scores wrong: {cs}")
    if not (es > 0).all():
        raise AssertionError(f"extension scores wrong: {es}")

    # the full-CIGAR map over a data-parallel grid of every device, and
    # with the key table sharded: identical Mappings, and nothing
    # reference-sized replicated
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "workload.fa")
        with open(fa, "w") as fh:
            for i, c in enumerate(contigs):
                fh.write(f">c{i}\n{c}\n")
        al = Aligner(fa, device=al_device)
        al.enable_mesh(n_devices, devices=devices)
        hits = [al.map(s, cs=True) for s in reads]
        if not all(h and h[0].cigar_str for h in hits):
            raise AssertionError(f"reads without a CIGAR: {hits}")
        if hits[0][0].r_st != 0 or hits[0][0].cs != ":400":
            raise AssertionError(f"read 0 (contig 0's first 400 bases): "
                                 f"{hits[0]}")
        al_sh = Aligner(fa, device=al_device)
        al_sh.enable_mesh(n_data, n_index=max(n_index, 2), devices=devices)
        hits_sh = [al_sh.map(s, cs=True) for s in reads]
    if _hit_fields(hits_sh) != _hit_fields(hits):
        raise AssertionError(f"sharded {hits_sh} != data-parallel {hits}")
    if al_sh._engine.index._devices:
        raise AssertionError("the sharded grid built replicated tables: "
                             f"{list(al_sh._engine.index._devices)}")
    res = {"grid": (n_data, n_index), "B": nb,
           "chain_scores": cs.tolist(), "ext_scores": es.tolist(),
           "cigars": [h[0].cigar_str for h in hits]}
    print(f"dryrun_multichip ok: grid (data={n_data}, index={n_index}), "
          f"B={nb}, chain_scores={res['chain_scores']}; full-CIGAR map over "
          f"{n_devices} data-parallel cells and over (data={n_data}, "
          f"index={max(n_index, 2)}) sharded cells: identical mappings, "
          "no replicated device tables")
    return res
