"""Simulated test data: a random genome and nanopore-like reads.

``simulate`` is a copy of the JAX package's bench.py ``simulate`` (numpy
only), so the port's tests and chip_smoke.py make their data from a
seed without anything outside this package.  ``zdrop_case``,
``inversion_case``, ``rmq_case`` and ``fallback_batch`` copy the
constructions of the JAX package's rare-path tests, draw for draw.
"""
from __future__ import annotations

import numpy as np


def random_genome(rng, n: int) -> str:
    """n uniformly random ACGT bases."""
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()


def simulate(rng, genome: str, n: int, length: int, err: float):
    """Nanopore-like reads: i.i.d. substitutions / insertions /
    deletions at `err` (60/20/20 split), half the reads
    reverse-complemented.  Vectorized (numpy) so large N stays cheap.
    Returns (reads, starts): each read's origin on the genome."""
    reads, starts, _ends, _rev = simulate_with_truth(rng, genome, n, length, err)
    return reads, starts


def simulate_with_truth(rng, genome: str, n: int, length: int, err: float):
    """``simulate``, with the rest of each read's truth: (reads, starts,
    ends, rev), where [start, end) is the genome span the read covers
    and rev marks the reverse-complemented reads.  The same draws as
    ``simulate``: the reads are the same for the same rng state."""
    g = np.frombuffer(genome.encode(), np.uint8)
    W = length + 64  # template window: deletions consume extra chars
    starts = rng.integers(0, len(genome) - W, n)
    tmpl = g[starts[:, None] + np.arange(W)]  # [n, W] ASCII
    r = rng.random((n, W))
    # substitutions: rotate within ACGT so the base always changes
    code = np.zeros(256, np.uint8)
    code[ord("C")], code[ord("G")], code[ord("T")] = 1, 2, 3
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sub = r < err * 0.6
    rot = rng.integers(1, 4, (n, W), dtype=np.uint8)
    subbed = np.where(sub, acgt[(code[tmpl] + rot) & 3], tmpl)
    ins = (r >= err * 0.6) & (r < err * 0.8)
    dele = (r >= err * 0.8) & (r < err)
    ins_char = acgt[rng.integers(0, 4, (n, W), dtype=np.uint8)]
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = rng.random(n) < 0.5
    reads, ends = [], []
    cap = length + 24  # keep every read in one device bucket
    for i in range(n):
        keep = ~dele[i]  # ins implies keep (bands are disjoint)
        base = subbed[i][keep]
        insertions = ins_char[i][ins[i]]
        if insertions.size:
            # np.insert indexes the PRE-insertion array: the slot
            # after kept char j is cumsum(keep)[j]
            at = np.cumsum(keep)[ins[i]]
            out = np.insert(base, at, insertions)
        else:
            at = np.zeros(0, np.int64)
            out = base
        out = out[:cap]
        # the last kept template char inside the cap: kept char r lands
        # at r + (insertions before it)
        where = np.arange(len(base)) + np.searchsorted(at, np.arange(len(base)),
                                                       side="right")
        last = int(np.nonzero(where < cap)[0][-1]) if len(base) else -1
        ends.append(int(starts[i]) + int(np.nonzero(keep)[0][last]) + 1
                    if last >= 0 else int(starts[i]))
        if rc[i]:
            out = comp[out[::-1]]
        reads.append(out.tobytes().decode())
    return reads, [int(s) for s in starts], ends, [bool(x) for x in rc]


def simulate_hpc_noise(rng, genome: str, n: int, length: int, sub: float):
    """PacBio-like reads: each homopolymer run of two or more bases in
    the template becomes, with probability 0.35, one base shorter, as
    long or one base longer (the run-length noise HPC sketching
    ignores), then substitutions at `sub`; half the reads are
    reverse-complemented.  Returns (reads, template starts)."""
    g = np.frombuffer(genome.encode(), np.uint8)
    starts = rng.integers(0, len(g) - length, n)
    code = np.zeros(256, np.uint8)
    code[ord("C")], code[ord("G")], code[ord("T")] = 1, 2, 3
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    reads = []
    for s in starts:
        t = g[s: s + length]
        first = np.concatenate([[0], np.flatnonzero(t[1:] != t[:-1]) + 1])
        runs = np.diff(np.concatenate([first, [len(t)]]))
        noisy = (rng.random(len(runs)) < 0.35) & (runs > 1)
        runs = runs + np.where(noisy, rng.integers(-1, 2, len(runs)), 0)
        r = np.repeat(t[first], runs)
        hit = rng.random(len(r)) < sub
        r[hit] = acgt[(code[r[hit]] + rng.integers(1, 4, int(hit.sum()))) & 3]
        if rng.random() < 0.5:
            r = comp[r[::-1]]
        reads.append(r.tobytes().decode())
    return reads, [int(s) for s in starts]


def spliced_genes(rng, genome: str, n: int, err: float,
                  exons=(3, 8), exon_len=(100, 300), intron_len=(80, 5000)):
    """Spliced transcripts: n genes of 3-8 exons (100-300 bp) whose
    introns (log-uniform 80-5,000 bp) are written into a copy of
    `genome`, half with GT..AG ends and half in the reverse sense
    (CT..AC), placed one after another 1-3 kb apart from a random
    start.  Each transcript is its exons joined, with `err` errors as
    ``simulate`` makes them (60/20/20 sub/ins/del), and half are
    reverse-complemented.  Returns (the genome with the introns, the
    transcripts, their first exons' starts)."""
    g = np.frombuffer(genome.encode(), np.uint8).copy()
    genes = []
    for _ in range(n):
        ne = int(rng.integers(exons[0], exons[1] + 1))
        el = rng.integers(exon_len[0], exon_len[1] + 1, ne)
        il = np.exp(rng.uniform(np.log(intron_len[0]), np.log(intron_len[1]),
                                ne - 1)).astype(np.int64)
        genes.append((el, il))
    total = sum(int(el.sum() + il.sum()) + 3000 for el, il in genes)
    if total > len(g):
        raise ValueError(f"{n} genes need {total} bp, the genome has {len(g)}")
    pos = int(rng.integers(0, len(g) - total + 1))
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    reads, starts = [], []
    for gi, (el, il) in enumerate(genes):
        pos += int(rng.integers(1000, 3001))
        sense = b"GT", b"AG"
        if gi % 2:
            sense = b"CT", b"AC"
        parts = []
        starts.append(pos)
        for ei, e in enumerate(el):
            parts.append(g[pos: pos + int(e)])
            pos += int(e)
            if ei < len(il):
                L = int(il[ei])
                g[pos: pos + 2] = np.frombuffer(sense[0], np.uint8)
                g[pos + L - 2: pos + L] = np.frombuffer(sense[1], np.uint8)
                pos += L
        t = np.concatenate(parts)
        r = rng.random(len(t))
        sub = r < err * 0.6
        ins = (r >= err * 0.6) & (r < err * 0.8)
        keep = ~((r >= err * 0.8) & (r < err))
        acgt = np.frombuffer(b"ACGT", np.uint8)
        t = np.where(sub, acgt[rng.integers(0, 4, len(t))], t)
        ins_at = np.nonzero(ins & keep)[0]
        t = np.insert(t, ins_at, acgt[rng.integers(0, 4, len(ins_at))])
        keep = np.insert(keep, ins_at, True)
        t = t[keep]
        if rng.random() < 0.5:
            t = comp[t[::-1]]
        reads.append(t.tobytes().decode())
    return g.tobytes().decode(), reads, starts


def rand_bases(rng, n: int) -> str:
    """n random bases, drawn one index at a time (the draw of the JAX
    package's inversion and rare-path-floor tests)."""
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def choice_bases(rng, n: int) -> str:
    """n random bases by ``rng.choice`` (the draw of the JAX package's
    zdrop, RMQ, mapq and overflow tests)."""
    return "".join(rng.choice(list("ACGT"), size=n))


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _invert_mutated(seg: str) -> str:
    """The reverse complement of seg with every 12th base (from the 6th)
    changed, so that no k = 15 window of it seeds a chain."""
    b = list(revcomp(seg))
    for i in range(5, len(b), 12):
        b[i] = "ACGT"[("ACGT".index(b[i]) + 1) % 4]
    return "".join(b)


#: the zdrop-split constructions of the JAX package's test_zdrop_split.py:
#: name -> its generator's seed
ZDROP_CASES = {"patch": 8, "short_patch": 11, "long_deletion": 12,
               "clean": 9, "two_patches": 10}


def zdrop_case(name: str):
    """(genome, reads) of a ZDROP_CASES construction on a 10 kb genome:
    a 500 bp patch replacing reference (splits in two), a 250 bp patch
    (absorbed as a long indel), a 450 bp deletion (aligns through), 5
    clean 800 bp reads, and two 500 bp patches (splits in three)."""
    rng = np.random.default_rng(ZDROP_CASES[name])
    g = choice_bases(rng, 10_000)
    if name == "patch":
        return g, [g[2000:2600] + choice_bases(rng, 500) + g[3100:3700]]
    if name == "short_patch":
        return g, [g[2000:2600] + choice_bases(rng, 250) + g[2850:3450]]
    if name == "long_deletion":
        return g, [g[2000:2600] + g[3050:3650]]
    if name == "clean":
        starts = [int(rng.integers(0, len(g) - 800)) for _ in range(5)]
        return g, [g[s:s + 800] for s in starts]
    g1, g2 = choice_bases(rng, 500), choice_bases(rng, 500)
    return g, [g[4000:4600] + g1 + g[5100:5700] + g2 + g[6200:6800]]


def inversion_case(kind: str = "inversion"):
    """(genome, read) of the JAX package's test_inversion.py: an 800 bp
    segment between two 500 bp flanks, inverted and mutated in the read
    (``kind`` "inversion"), or replaced by 800 bp of junk ("junk")."""
    if kind == "inversion":
        rng = np.random.default_rng(3)
        a, b = rand_bases(rng, 500), rand_bases(rng, 800)
        c = rand_bases(rng, 500)
        genome = rand_bases(rng, 3000) + a + b + c + rand_bases(rng, 3000)
        return genome, a + _invert_mutated(b) + c
    rng = np.random.default_rng(9)
    a, c = rand_bases(rng, 500), rand_bases(rng, 500)
    genome = (rand_bases(rng, 2000) + a + rand_bases(rng, 800) + c
              + rand_bases(rng, 2000))
    return genome, a + rand_bases(rng, 800) + c


def rmq_case(case: str):
    """(genome, read) of the JAX package's test_rmq_chain.py on its 60 kb
    genome: a 6 kb deletion ("deletion"), a 3 kb insertion
    ("insertion"), or 2 kb of junk replacing reference ("junk")."""
    g = choice_bases(np.random.default_rng(5), 60_000)
    if case == "insertion":
        ins = choice_bases(np.random.default_rng(7), 3000)
        return g, g[30_000:36_000] + ins + g[36_000:42_000]
    if case == "junk":
        junk = choice_bases(np.random.default_rng(13), 2000)
        return g, g[10_000:16_000] + junk + g[18_000:24_000]
    return g, g[10_000:16_000] + g[22_000:28_000]


def fallback_batch(n: int = 64):
    """(genome, reads) of the JAX package's test_rare_path_floor.py: a
    400 kb genome and n reads that all miss the fused C++ post-chain,
    alternately zdrop chimeras (600 + 500 junk + 600 bp) and inversions
    (500 + 800 inverted, mutated + 500 bp)."""
    rng = np.random.default_rng(17)
    g = rand_bases(rng, 400_000)
    reads = []
    for i in range(n):
        s = int(rng.integers(1000, len(g) - 3000))
        if i % 2 == 0:
            reads.append(g[s:s + 600] + rand_bases(rng, 500)
                         + g[s + 1100:s + 1700])
        else:
            reads.append(g[s:s + 500] + _invert_mutated(g[s + 500:s + 1300])
                         + g[s + 1300:s + 1800])
    return g, reads


def sweep_anchors(rng, B: int, A: int, bw: int, span: int = 15,
                  device="cpu") -> dict:
    """Sorted synthetic chaining anchors [B, A] whose pair gaps sweep
    the chain DP's gates: dense diagonal runs whose offsets jump by up
    to bw+2 (so |dr-dq| covers 0..bw and just past it), reference steps
    that now and then exceed the 5 kb distance gate, two strands, three
    contigs, spans mostly `span` (some 10..20), and a ragged invalid
    tail.  Returns int32 rev/rid/rpos/qpos/span and bool valid."""
    import torch

    n_valid = rng.integers(A // 2, A + 1, B)
    n_valid[0] = A
    valid = np.arange(A)[None, :] < n_valid[:, None]
    rev = rng.integers(0, 2, (B, A))
    rid = rng.integers(0, 3, (B, A))
    step = np.where(rng.random((B, A)) < 0.97, rng.integers(0, 40, (B, A)),
                    rng.integers(0, 6000, (B, A)))
    rpos = np.cumsum(step, axis=1)
    jump = np.where(rng.random((B, A)) < 0.05,
                    rng.integers(-(bw + 2), bw + 3, (B, A)), 0)
    qpos = rpos + np.cumsum(jump, axis=1) + rng.integers(-3, 4, (B, A))
    spans = np.where(rng.random((B, A)) < 0.9, span,
                     rng.integers(10, 21, (B, A)))
    for b in range(B):
        o = np.lexsort((qpos[b], rpos[b], rid[b], rev[b]))
        rev[b], rid[b], rpos[b], qpos[b] = rev[b][o], rid[b][o], rpos[b][o], qpos[b][o]
    out = {n: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
           for n, v in (("rev", rev), ("rid", rid), ("rpos", rpos),
                        ("qpos", qpos), ("span", spans))}
    out["valid"] = torch.from_numpy(valid).to(device)
    return out


def splice_anchors(rng, B: int, A: int, span: int = 15,
                   max_intron: int = 200_000, device="cpu") -> dict:
    """Sorted synthetic anchors [B, A] of spliced transcripts, for K1's
    splice branch: exon runs along a diagonal (query steps of 1-40,
    reference steps within 3 of them) broken by introns whose reference
    gaps are drawn log-uniformly from 1..max_intron (so 80-5,000 bp
    introns and gaps up to the splice presets' bw = 200,000 all occur,
    some just past it), now and then a query gap instead (dr < dq, the
    branch's other side; some past max_gap = 2,000), two strands, two
    contigs, spans mostly `span`, and a ragged invalid tail.  Returns
    int32 rev/rid/rpos/qpos/span and bool valid."""
    import torch

    n_valid = rng.integers(A // 2, A + 1, B)
    n_valid[0] = A
    valid = np.arange(A)[None, :] < n_valid[:, None]
    rev = rng.integers(0, 2, (B, A))
    rid = rng.integers(0, 2, (B, A))
    qstep = rng.integers(1, 41, (B, A))
    rstep = np.maximum(qstep + rng.integers(-3, 4, (B, A)), 0)
    u = rng.random((B, A))
    intron = np.exp(rng.uniform(0, np.log(max_intron * 1.01), (B, A)))
    rstep = np.where(u < 0.08, rstep + intron.astype(np.int64), rstep)
    qstep = np.where(u > 0.98, qstep + rng.integers(0, 3000, (B, A)), qstep)
    rpos = np.cumsum(rstep, axis=1)
    qpos = np.cumsum(qstep, axis=1)
    spans = np.where(rng.random((B, A)) < 0.9, span,
                     rng.integers(10, 21, (B, A)))
    for b in range(B):
        o = np.lexsort((qpos[b], rpos[b], rid[b], rev[b]))
        rev[b], rid[b], rpos[b], qpos[b] = rev[b][o], rid[b][o], rpos[b][o], qpos[b][o]
    out = {n: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
           for n, v in (("rev", rev), ("rid", rid), ("rpos", rpos),
                        ("qpos", qpos), ("span", spans))}
    out["valid"] = torch.from_numpy(valid).to(device)
    return out


def tile_anchors(tile: dict, reps: int) -> dict:
    """A [B, T] anchor set repeated `reps` times along A: [B, reps*T].
    Copy t's contig ids are shifted by t * (max rid + 1), so no chaining
    pair crosses two copies and the chain DP of the whole is the tile's,
    repeated (``tile_chain_result``).  Each copy keeps the tile's
    invalid tail, so valid anchors are not a prefix of the row."""
    import torch

    out = {n: tile[n].repeat(1, reps).contiguous()
           for n in ("rev", "rpos", "qpos", "span", "valid")}
    T = tile["rid"].shape[1]
    step = int(tile["rid"].max()) + 1 if tile["rid"].numel() else 1
    shift = torch.arange(reps, dtype=torch.int32,
                         device=tile["rid"].device).repeat_interleave(T) * step
    out["rid"] = (tile["rid"].repeat(1, reps) + shift[None, :]).contiguous()
    return out


def tile_chain_result(f, p, reps: int):
    """The chain DP (f, p) of ``tile_anchors(tile, reps)`` from the
    tile's own (f, p): f repeated, p shifted by each copy's start."""
    import torch

    T = f.shape[1]
    start = torch.arange(reps, dtype=torch.int32,
                         device=f.device).repeat_interleave(T) * T
    pt = p.repeat(1, reps)
    return (f.repeat(1, reps).contiguous(),
            torch.where(pt >= 0, pt + start[None, :], pt).contiguous())


def edge_anchors(rng, A: int, device="cpu") -> dict:
    """Four [A]-anchor rows of the chain DP's edge cases, as [4, A]:
    0. ties: groups of 8 identical anchors stepping along one diagonal,
       so every anchor of a group is an equal candidate for the next
       group (the largest j must win);
    1. best == span_i: pairs (span 15, then span 30 twenty bases further
       on the diagonal) whose only link totals exactly span_i (p must
       stay -1), pairs 6 kb apart;
    2. no valid anchor;
    3. gate-sweep anchors under a random, non-prefix valid mask."""
    import torch

    i = np.arange(A)
    pos0 = 100 + 10 * (i // 8)
    pair, second = i // 2, i % 2
    pos1 = 6000 * pair + 20 * second
    sw = sweep_anchors(rng, 1, A, 500)
    rows = {
        "rev": [np.zeros(A), np.zeros(A), np.zeros(A), sw["rev"][0].numpy()],
        "rid": [np.zeros(A), np.zeros(A), np.zeros(A), sw["rid"][0].numpy()],
        "rpos": [pos0, pos1, pos0, sw["rpos"][0].numpy()],
        "qpos": [pos0, pos1, pos0, sw["qpos"][0].numpy()],
        "span": [np.full(A, 15), np.where(second == 1, 30, 15),
                 np.full(A, 15), sw["span"][0].numpy()],
    }
    out = {n: torch.from_numpy(np.ascontiguousarray(np.stack(v), np.int32))
           .to(device) for n, v in rows.items()}
    valid = np.ones((4, A), bool)
    valid[2] = False
    valid[3] = rng.random(A) < 0.5
    out["valid"] = torch.from_numpy(valid).to(device)
    return out
