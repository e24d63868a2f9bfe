"""Time the chain kernels K1 (chain DP) and K2 (chain backtrack) of this
checkout against those of another checkout, on one NVIDIA card.

    python3 chip_kernels.py [--other DIR] [--reps N] [--probes]

Each measurement runs in its own process (the two checkouts' packages
share a name), in turns: other, this, this, other, ... (--reps rounds).
A process builds its checkout's kernels, makes the same inputs from the
same seed (a 32 Mbp random genome; the front end's anchors of 256
simulated 1 kb reads at A=256; B=8 x A=32,768 gate-sweep anchors; the
front end's anchors of 8 simulated 100 kb reads at 5% error in the
131,072 bucket, B=8 x A=32,768, as chip_smoke.py's phase 8 makes them),
and times each kernel two ways with chip_smoke.py's helpers: CUDA
events around 200 (20) eager wrapper calls (cuda_ms), and CUDA events
around the replay of a CUDA graph of the same calls (graph_ms), which
leaves out the host's launch cost.

--probes adds, in this checkout's processes, device times (graph_ms)
of code paths that the default inputs do not take:
  - K1 with a skip scale of 1e-30: the same f and p (checked), through
    whatever the kernel does when the skip scale is not 0;
  - K2 with its shared memory capped at the `used` bitmask plus 0, 1, 2
    and 4 rows of A int32 (what each staging level of the kernel may
    take), and with f and valid at addresses that are not 16- or
    4-byte aligned (copies at an offset of one element).
Prints one JSON line per process and a summary line; writes
chiprun_out/chip_kernels.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 20261016
SHAPES = ("256x256", "8x32768", "8x32768real")
ROOT = os.path.dirname(os.path.abspath(__file__))


def measure(cs, probes: bool) -> dict:
    """The child process: time K1 and K2 of the package on sys.path."""
    import numpy as np
    import torch

    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops import cuda_build
    from mappy_rs_tpu_torch.ops.lookup import collect_anchors
    from mappy_rs_tpu_torch.ops.sketch import sketch_compact
    from mappy_rs_tpu_torch.utils.seqcodes import encode
    from mappy_rs_tpu_torch.utils.simulate import (random_genome, simulate,
                                                   sweep_anchors)

    cuda_build.load()
    rng = np.random.default_rng(SEED)
    genome = random_genome(rng, 32_000_000)
    reads, _ = simulate(rng, genome, 256, 1000, 0.05)
    al = mappy_rs_tpu_torch.Aligner(seq=genome)
    eng = al._engine

    def front_end(reads, L, A, cuts):
        B, M, _A = eng.fe_shapes(L)
        batch = np.full((B, L), 4, np.uint8)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(reads[:B]):
            c = encode(r)
            batch[i, : len(c)] = c
            lens[i] = len(c)
        lens_t = torch.from_numpy(lens).cuda()
        kw = eng._fe_kwargs(M, A, cuts)
        mins = sketch_compact(torch.from_numpy(batch).cuda(), lens_t,
                              kw["k"], kw["w"], M)
        return collect_anchors(mins, lens_t, eng.dev, kw["mid_occ"], A,
                               kw["k"], kw["q_occ_frac"], kw["occ_dist"],
                               kw["max_max_occ"])

    main = front_end(reads, 1024, 256, 2)
    long = sweep_anchors(np.random.default_rng(SEED + 1), 8, 32768,
                         eng._chain_params.bw, device="cuda")
    long_reads, _ = simulate(np.random.default_rng(SEED + 8), genome, 8,
                             100_000, 0.05)
    real = front_end(long_reads, 131072, 32768, 8)
    params = eng._chain_params
    mc, ms = eng.opt.min_cnt, eng.opt.min_chain_score
    out = {"card": torch.cuda.get_device_name(0)}
    for label, an, cuts, n in (("256x256", main, 2, 200),
                               ("8x32768", long, 8, 20),
                               ("8x32768real", real, 8, 20)):
        f, p = ck.chain_scores_kernel(an, params, 128)
        k1 = lambda: ck.chain_scores_kernel(an, params, 128)  # noqa: E731
        k2 = lambda: bt.backtrack_chains(an, f, p, 8, cuts, mc, ms)  # noqa: E731
        rec = {"K1_eager_ms": cs.cuda_ms(k1, n),
               "K1_graph_ms": cs.graph_ms(k1, n),
               "K2_eager_ms": cs.cuda_ms(k2, n),
               "K2_graph_ms": cs.graph_ms(k2, n)}
        if probes:
            rec.update(probe(cs, an, f, p, params, cuts, mc, ms, n))
        out[label] = rec
    return out


def probe(cs, an, f, p, params, cuts, mc, ms, n) -> dict:
    """Device times of K1 and K2 on the code paths --probes names."""
    import torch

    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops import cuda_build

    rec = {}
    skip = params._replace(chn_pen_skip=1e-30)
    f2, p2 = ck.chain_scores_kernel(an, skip, 128)
    if not (torch.equal(f, f2) and torch.equal(p, p2)):
        raise AssertionError("K1 with skip scale 1e-30 changed f or p")
    rec["K1_skip_graph_ms"] = cs.graph_ms(
        lambda: ck.chain_scores_kernel(an, skip, 128), n)

    want = bt.backtrack_chains(an, f, p, 8, cuts, mc, ms)
    B, A = f.shape
    limit = cuda_build.SMEM_LIMIT
    try:
        for rows in (0, 1, 2, 4):
            cap = bt.smem_bytes(A) + rows * A * 4
            if cap > limit:
                continue
            cuda_build.SMEM_LIMIT = cap
            if not torch.equal(bt.backtrack_chains(an, f, p, 8, cuts, mc, ms),
                               want):
                raise AssertionError(f"K2 capped at {cap} B differs")
            rec[f"K2_rows{rows}_graph_ms"] = cs.graph_ms(
                lambda: bt.backtrack_chains(an, f, p, 8, cuts, mc, ms), n)
    finally:
        cuda_build.SMEM_LIMIT = limit

    def shifted(t):  # a contiguous copy one element past an aligned start
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    fu = shifted(f)
    au = dict(an, valid=shifted(an["valid"]))
    if not torch.equal(bt.backtrack_chains(au, fu, p, 8, cuts, mc, ms), want):
        raise AssertionError("K2 on unaligned f/valid differs")
    rec["K2_unaligned_graph_ms"] = cs.graph_ms(
        lambda: bt.backtrack_chains(au, fu, p, 8, cuts, mc, ms), n)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of another checkout to compare")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        import chip_smoke as cs  # this checkout's helpers, before sys.path moves

        sys.path[0] = args.child  # import the package of ROOT
        probes = args.probes and os.path.abspath(args.child) == ROOT
        print(json.dumps(measure(cs, probes)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_kernels: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    roots = [("this", ROOT)]
    if args.other:
        roots = [("other", os.path.abspath(args.other))] + roots
    order = []
    for _ in range(args.reps):
        order += roots + roots[::-1] if len(roots) > 1 else roots * 2
    runs = []
    for name, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        res = subprocess.run(cmd + ["--probes"] * args.probes, cwd=root,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["checkout"] = name
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for name, _root in roots:
        mine = [r for r in runs if r["checkout"] == name]
        summary[name] = {
            shape: {k: [r[shape][k] for r in mine] for k in mine[0][shape]}
            for shape in SHAPES}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_kernels.json"), "w") as fh:
        json.dump({"runs": runs, "summary": summary}, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
