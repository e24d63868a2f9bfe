"""Time the kernels K1 (chain DP), K2 (chain backtrack), K3 (banded
extension DP) and K4 (traceback) of this checkout against those of
another checkout, on one NVIDIA card.

    python3 chip_kernels.py [--other DIR] [--reps N] [--probes]
                            [--ext-shapes QxTxWxJ,...]

Each measurement runs in its own process (the two checkouts' packages
share a name), in turns: other, this, this, other, ... (--reps rounds).
A process builds its checkout's kernels, makes the same inputs from the
same seed (a 32 Mbp random genome; the front end's anchors of 256
simulated 1 kb reads at A=256; B=8 x A=32,768 gate-sweep anchors; the
front end's anchors of 8 simulated 100 kb reads at 5% error in the
131,072 bucket, B=8 x A=32,768, as chip_smoke.py's phase 8 makes them;
for K3/K4 the extension jobs of the 256 reads: chip_smoke.py's J=256,
(1024, 1024) batch, timed at W=64, and batches of real jobs at each
group shape of --ext-shapes, by default the two that chip_smoke.py's
phase 7 logs as launched most under extension_backend "device"), and
times each kernel two ways with chip_smoke.py's helpers: CUDA events
around 200 (20) eager wrapper calls (cuda_ms), and CUDA events around
the replay of a CUDA graph of the same calls (graph_ms), which leaves
out the host's launch cost.  K3/K4 also give µs per serial step and the
bound (chip_smoke.py time_ext).

--probes adds, in this checkout's processes, device times (graph_ms)
of code paths that the default inputs do not take:
  - K1 with a skip scale of 1e-30: the same f and p (checked), through
    whatever the kernel does when the skip scale is not 0;
  - K2 with its shared memory capped at the `used` bitmask plus 0, 1, 2
    and 4 rows of A int32 (what each staging level of the kernel may
    take), and with f and valid at addresses that are not 16- or
    4-byte aligned (copies at an offset of one element);
  - K1's and K2's plain versions, once each, on the real 100 kb anchors;
  - K3's block kernel against its warp kernel (the same outputs,
    checked) at W = 64, 128, 160, 192 and 256 (the switch), on the J=256
    batch;
  - K4 by slab size (SLAB_BYTES 0 = no slabs, 1 = two diagonals per
    slab, 2,048 ... 24,576), the same outputs checked, on every K3/K4
    batch.
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
#: K3/K4 shapes (QMAX x TMAX x W x J): the main timing batch, then the
#: two group shapes launched most under "device" (chip_smoke.py phase 7)
EXT_MAIN = "1024x1024x64x256"
EXT_REAL = "512x512x32x512,1024x1024x32x256"
ROOT = os.path.dirname(os.path.abspath(__file__))


def measure(cs, probes: bool, ext_shapes) -> dict:
    """The child process: time K1-K4 of the package on sys.path."""
    import numpy as np
    import torch

    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops import cuda_build
    from mappy_rs_tpu_torch.ops.chain import chain_scores
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
               "K2_graph_ms": cs.graph_ms(k2, n),
               "K1_bound_ms": cs.k1_bound(an, ck.window_of(128))["bound_ms"],
               "K2_bound_ms": cs.k2_bound(an, f, p, 8, cuts, ms)["bound_ms"]}
        if probes:
            rec.update(probe(cs, an, f, p, params, cuts, mc, ms, n))
            if label == "8x32768real":  # the plain versions, once each
                rec["K1_plain_ms"] = cs.cuda_ms(
                    lambda: chain_scores(an, params, 128), 1, warm=False)
                rec["K2_plain_ms"] = cs.cuda_ms(
                    lambda: bt.backtrack_chains_plain(an, f, p, 8, cuts, mc,
                                                      ms), 1, warm=False)
        out[label] = rec
    out.update(measure_ext(cs, al, reads, probes, ext_shapes))
    return out


def measure_ext(cs, al, reads, probes: bool, ext_shapes) -> dict:
    """K3 and K4 at the main batch and the real group shapes."""
    import numpy as np

    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb
    from mappy_rs_tpu_torch.ops.extend import extend_dp

    eng = al._engine
    params, end_bonus = eng._ext_params, eng.opt.end_bonus
    OPS = eng.cfg.traceback_max_ops
    jobs = cs.real_ext_jobs(al, reads)
    out = {}
    for label in ext_shapes:
        QMAX, TMAX, W, J = (int(x) for x in label.split("x"))
        if label == EXT_MAIN:
            b = cs.ext_batch(jobs, np.random.default_rng(SEED + 5), J, QMAX,
                             TMAX)
        else:
            b = cs.class_batch(eng, jobs, QMAX, TMAX, W, J)
        n = 20 if J * QMAX >= 256 * 1024 else 200
        tm = cs.time_ext(ek, tb, extend_dp, b, W, params, end_bonus, OPS, n,
                         0, plain=False)
        rec = {}
        for key, name in (("K3", "extend_dp"), ("K4", "traceback")):
            r = tm[name]
            rec.update({f"{key}_eager_ms": r["ms"], f"{key}_graph_ms": r["graph_ms"],
                        f"{key}_us_per_step": r["us_per_step"],
                        f"{key}_steps": r["steps"], f"{key}_bound_ms": r["bound_ms"]})
        if probes:
            rec.update(probe_ext(cs, b, W, params, end_bonus, OPS, n,
                                 label == EXT_MAIN))
        out["ext:" + label] = rec
    return out


def probe_ext(cs, b, W, params, end_bonus, OPS, n, main: bool) -> dict:
    """Device times of K3's block kernel against its warp kernel (on the
    main batch, at W and at W=256) and of K4 by slab size."""
    import torch

    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb

    q, t, ql, tl, mode = (torch.from_numpy(b[k]).cuda()
                          for k in ("q", "t", "ql", "tl", "mode"))
    rec = {}
    if main:
        for w in sorted({W, 128, 160, 192, 256}):
            want = ek.extend_dp_kernel(q, t, ql, tl, w, params)
            warp_max = ek.WARP_MAX_W
            try:
                for name, lim in (("warp", warp_max), ("block", 0)):
                    ek.WARP_MAX_W = lim
                    got = ek.extend_dp_kernel(q, t, ql, tl, w, params)
                    if not (torch.equal(got["dirs"], want["dirs"])
                            and torch.equal(got["best"], want["best"])):
                        raise AssertionError(f"K3 {name} kernel differs, W={w}")
                    rec[f"K3_{name}_W{w}_graph_ms"] = cs.graph_ms(
                        lambda: ek.extend_dp_kernel(q, t, ql, tl, w, params), n)
            finally:
                ek.WARP_MAX_W = warp_max
    got = ek.extend_dp_kernel(q, t, ql, tl, W, params)
    walk = lambda: tb.traceback_device(got["dirs"], got["best"], ql, tl,  # noqa: E731
                                       mode, W, OPS, end_bonus)
    want = walk()
    slab = tb.SLAB_BYTES
    try:
        for nbytes in (0, 1, 2048, 4096, 8192, 16384, 24576):
            tb.SLAB_BYTES = nbytes
            o, i = walk()
            if not (torch.equal(o, want[0]) and torch.equal(i, want[1])):
                raise AssertionError(f"K4 at SLAB_BYTES={nbytes} differs")
            rec[f"K4_slab{nbytes}_D{tb.slab_depth(W)}_graph_ms"] = \
                cs.graph_ms(walk, n)
    finally:
        tb.SLAB_BYTES = slab
    return rec


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
    ap.add_argument("--ext-shapes", default=EXT_REAL,
                    help="K3/K4 group shapes QMAXxTMAXxWxJ, comma-separated")
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        import chip_smoke as cs  # this checkout's helpers, before sys.path moves

        sys.path[0] = args.child  # import the package of ROOT
        probes = args.probes and os.path.abspath(args.child) == ROOT
        ext = [EXT_MAIN] + [x for x in args.ext_shapes.split(",") if x]
        print(json.dumps(measure(cs, probes, ext)), flush=True)
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
        cmd += ["--ext-shapes", args.ext_shapes] + ["--probes"] * args.probes
        res = subprocess.run(cmd, cwd=root,
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
            for shape in mine[0] if shape in SHAPES or shape.startswith("ext:")}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_kernels.json"), "w") as fh:
        json.dump({"runs": runs, "summary": summary}, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
