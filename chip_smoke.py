"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. card, power limit, torch/CUDA versions; build the CUDA kernels
     (nvcc, sm_90a) and the host C++ library from the checkout.
  2. K1 (chain DP): kernel == plain torch version, exactly, at the main
     path's shape (B=256, A=256, window 128), at window 512 and at the
     anchor-overflow retry's A=4096, on anchors from the real front end
     and on synthetic anchors whose gaps sweep the whole gate range.
  3. K2 (chain backtrack): kernel == plain version, exactly, at
     B=256, A=256, K=8, cuts=2 and at A=4096.
  4. the slice at users' size: Aligner(seq=<32 Mbp random genome>) on
     the card, 8,192 simulated 1 kb reads at 5% error through
     enable_threading(4) + map_batch; at least 99% must map within
     100 bp of their origin, both kernels must have launched, the index
     tensors must be on the card, one front-end dispatch must run under
     torch.cuda.set_sync_debug_mode("error"), and 64 reads must map
     identically on the card and through the CPU plain versions.
  5. K3 (banded extension DP): kernel == plain version, exactly (dirs
     and the six trackers), at J=256, (QMAX, TMAX) in {(512, 512),
     (1024, 1024)} and W in {32, 64, 128}, on the extension jobs that
     the pipeline builds for 256 of phase 4's reads plus seeded
     synthetic jobs (8% error with indel runs, N bases, drift, padded
     empty jobs, one indel-dense job).
  6. K4 (traceback): kernel == plain version, exactly, on phase 5's
     direction bytes for modes 0, 1 and mixed; the indel-dense job
     must overflow the 128-run table.
  7. the device extension backends at users' size: phase 4's reads
     through enable_threading(4) + map_batch with extension_backend
     "host", "device" and "device_dl"; each device backend must place
     >= 99% within 100 bp and give the host backend's Mappings field
     for field (cs and MD too, through the engine's batch call); K3 and
     K4 must launch under "device", K4 never under "device_dl".
Prints per-kernel times (CUDA events) beside the plain versions' and
each kernel's bound (the larger of its bytes over 3.35 TB/s and its
int32 operations over 16.7 Top/s), the kernels' JSON line, the card
line, and last the result line.  Exits non-zero without a result when
no card is visible.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

GENOME_LEN = 32_000_000
N_READS = 8192
READ_LEN = 1000
ERR = 0.05
SEED = 20261016


# H100 SXM peaks for the bounds (NVIDIA data sheet / Hopper white
# paper): HBM3 bandwidth, and int32 throughput = 64 INT32 lanes per SM
# x 132 SMs x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations counted per unit of work (the recurrence's own
# arithmetic, not its addressing): K1 per (anchor, predecessor) pair —
# the distance gates and the gap penalty; K2 per candidate per pass —
# valid/used/threshold tests and the max; K3 per band cell — gap opens,
# extends and maxes of four channels, continuation compares, the pair
# score, the max chain over five sources, the direction byte; K4 per
# walk step — band offset, byte read, state tests, run update
OPS_PER_PAIR_K1 = 16
OPS_PER_CAND_K2 = 3
OPS_PER_CELL_K3 = 32
OPS_PER_STEP_K4 = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the int32 operations over the int32 rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "ops": nops}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of fn() over n launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def timed_pair(kernel, plain, n_kernel: int, n_plain: int):
    """(kernel_ms, plain_ms), interleaved plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, n_plain)
    k1 = cuda_ms(kernel, n_kernel)
    k2 = cuda_ms(kernel, n_kernel)
    p2 = cuda_ms(plain, n_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------- phase 1
def phase_build() -> dict:
    import torch

    from mappy_rs_tpu_torch import native
    from mappy_rs_tpu_torch.ops import cuda_build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.load()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("host C++ library failed to build")
    t_native = time.perf_counter() - t0
    log(f"build: CUDA kernels {t_cuda:.1f} s (nvcc {cuda_build.build_seconds:.1f} s), "
        f"host C++ {t_native:.1f} s")
    for line in cuda_build.build_log.splitlines():  # ptxas, per kernel
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            log("  " + line.strip())
    return {"card": card}


# ------------------------------------------------------------- test data
def front_end_anchors(al, reads, A: int) -> dict:
    """Anchors of one real [256, 1024] batch through the port's sketch
    and seed lookup on the card."""
    import torch

    from mappy_rs_tpu_torch.ops.lookup import collect_anchors
    from mappy_rs_tpu_torch.ops.sketch import sketch_compact
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    eng = al._engine
    B, M, _ = eng.fe_shapes(1024)
    batch = np.full((B, 1024), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:B]):
        c = encode(r)
        batch[i, : len(c)] = c
        lens[i] = len(c)
    codes_t = torch.from_numpy(batch).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = eng._fe_kwargs(M, A, 2)
    mins = sketch_compact(codes_t, lens_t, kw["k"], kw["w"], M)
    return collect_anchors(mins, lens_t, eng.dev, kw["mid_occ"], A, kw["k"],
                           kw["q_occ_frac"], kw["occ_dist"], kw["max_max_occ"])


# ---------------------------------------------------------- phases 2 + 3
def max_err(a, b) -> int:
    """Largest |a - b| of two integer tensors of one shape."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def phase_kernels(al, reads, rng) -> dict:
    import torch

    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops.chain import chain_scores
    from mappy_rs_tpu_torch.utils.simulate import sweep_anchors

    eng = al._engine
    params = eng._chain_params
    res = {"chain_dp": {"max_abs_err": 0}, "backtrack_chains": {"max_abs_err": 0}}

    def k1_check(anchors, window, label):
        f, p = ck.chain_scores_kernel(anchors, params, window)
        fr, pr = chain_scores(anchors, params, ck.window_of(window))
        torch.cuda.synchronize()
        err = max(max_err(f, fr), max_err(p, pr))
        B, A = f.shape
        n_link = int((p >= 0).sum())
        log(f"K1 {label}: B={B} A={A} window={ck.window_of(window)} "
            f"links={n_link} max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K1 kernel != plain version ({label})")
        res["chain_dp"]["max_abs_err"] = max(res["chain_dp"]["max_abs_err"], err)
        return f, p

    def k2_check(anchors, f, p, label, K=8, cuts=2):
        o = bt.backtrack_chains(anchors, f, p, K, cuts, eng.opt.min_cnt,
                                eng.opt.min_chain_score)
        r = bt.backtrack_chains_plain(anchors, f, p, K, cuts, eng.opt.min_cnt,
                                      eng.opt.min_chain_score)
        torch.cuda.synchronize()
        err = max_err(o, r)
        n_chain = int((o[:, :, 0] >= 0).sum())
        log(f"K2 {label}: B={f.shape[0]} A={f.shape[1]} K={K} cuts={cuts} "
            f"chains={n_chain} max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K2 kernel != plain version ({label})")
        res["backtrack_chains"]["max_abs_err"] = max(
            res["backtrack_chains"]["max_abs_err"], err)
        return o

    bw = params.bw
    real = front_end_anchors(al, reads, 256)
    syn = sweep_anchors(rng, 256, 256, bw, device="cuda")
    f_real, p_real = k1_check(real, 128, "front-end anchors")
    f_syn, p_syn = k1_check(syn, 128, "gate sweep")
    syn_w = sweep_anchors(rng, 256, 1024, bw, device="cuda")
    k1_check(syn_w, 512, "gate sweep, R=4")
    syn_big = sweep_anchors(rng, 256, 4096, bw, device="cuda")
    f_big, p_big = k1_check(syn_big, 128, "gate sweep, A=4096")
    real_big = front_end_anchors(al, reads, 4096)
    k1_check(real_big, 128, "front-end anchors, A=4096")

    k2_check(real, f_real, p_real, "front-end anchors")
    k2_check(syn, f_syn, p_syn, "gate sweep")
    k2_check(syn_big, f_big, p_big, "gate sweep, A=4096")

    # times at the main path's shape (B=256, A=256)
    k, pl = timed_pair(
        lambda: ck.chain_scores_kernel(real, params, 128),
        lambda: chain_scores(real, params, 128), 200, 3)
    res["chain_dp"].update(ms=k, plain_ms=pl)
    log(f"K1 time at B=256 A=256: kernel {k:.4f} ms, plain {pl:.3f} ms")
    mc, ms = eng.opt.min_cnt, eng.opt.min_chain_score
    k, pl = timed_pair(
        lambda: bt.backtrack_chains(real, f_real, p_real, 8, 2, mc, ms),
        lambda: bt.backtrack_chains_plain(real, f_real, p_real, 8, 2, mc, ms),
        200, 3)
    res["backtrack_chains"].update(ms=k, plain_ms=pl)
    log(f"K2 time at B=256 A=256 K=8: kernel {k:.4f} ms, plain {pl:.3f} ms")

    # bounds at that shape, from this batch's anchors: every anchor's
    # fields read once, f/p (K1) and the chain table (K2) written once;
    # K1 scores each valid anchor against min(index, H) predecessors
    B, A = f_real.shape
    valid = real["valid"]
    idx = torch.arange(A, device=valid.device)
    pairs = float((valid * idx.clamp(max=ck.window_of(128))).sum())
    n_valid = float(valid.sum())
    res["chain_dp"].update(bound(B * A * (5 * 4 + 1) + B * A * 8,
                                 pairs * OPS_PER_PAIR_K1))
    FLD = 9 + 2 * 2
    res["backtrack_chains"].update(bound(
        B * A * (7 * 4 + 1) + B * 8 * FLD * 4,
        8 * n_valid * OPS_PER_CAND_K2))
    for name in ("chain_dp", "backtrack_chains"):
        r = res[name]
        log(f"{name} bound: {r['bound_ms']:.5f} ms ({r['bound_by']}; "
            f"{r['bytes']:.0f} B, {r['ops']:.0f} int32 ops)")
    return res


# --------------------------------------------------------------- phase 4
def phase_slice(al, reads, starts, genome) -> dict:
    import torch

    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.models.pipeline import front_end_bt
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    eng = al._engine
    dev = eng.dev
    for name in ("offcnt", "pos_rp", "hash_rows", "hash_val"):
        t = getattr(dev, name)
        if t.device.type != "cuda":
            raise AssertionError(f"index tensor {name} is on {t.device}")
    log(f"index on card: {dev.nbytes() / 1e6:.1f} MB, {dev.n_keys} keys")

    # one front-end dispatch with every host sync turned into an error
    B, M, A = eng.fe_shapes(1024)
    batch = np.full((B, 1024), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:B]):
        c = encode(r)
        batch[i, : len(c)] = c
        lens[i] = len(c)
    codes_t = torch.from_numpy(batch).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = eng._fe_kwargs(M, A, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chains, aux = front_end_bt(codes_t, lens_t, dev, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"front end under sync_debug_mode='error': ok, chains {tuple(chains.shape)}")
    fe_ms = cuda_ms(lambda: front_end_bt(codes_t, lens_t, dev, **kw), 20)
    log(f"front end: {fe_ms:.3f} ms per [256, 1024] batch (CUDA events)")

    # warm the threaded path (first-call allocations), then the run
    al.enable_threading(4)
    list(al.map_batch([{"i": i, "seq": s} for i, s in enumerate(reads[:512])]))
    al.reset_metrics()
    ck.launches = 0
    bt.launches = 0
    t0 = time.perf_counter()
    n_hit = n_ok = 0
    for mappings, data in al.map_batch(
        [{"i": i, "seq": s} for i, s in enumerate(reads)]
    ):
        if mappings:
            n_hit += 1
            if abs(mappings[0].target_start - starts[data["i"]]) < 100:
                n_ok += 1
    wall = time.perf_counter() - t0
    launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
    al.enable_threading(0)
    rate = len(reads) / wall
    log(f"map_batch: {len(reads)} reads in {wall:.3f} s = {rate:.1f} reads/s "
        f"(4 threads); mapped {n_hit}, within 100 bp {n_ok} "
        f"({100.0 * n_ok / len(reads):.2f}%)")
    log(f"kernel launches in the run: {launches}")
    m = al.metrics
    log("engine metrics: " + json.dumps(
        {k: m[k] for k in sorted(m) if k.startswith(("time_", "calls_", "fe_"))}))
    if n_ok < 0.99 * len(reads):
        raise AssertionError(f"only {n_ok}/{len(reads)} reads placed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # the card's mappings == the CPU plain versions', on a small input
    rng = np.random.default_rng(SEED + 1)
    small = genome[:2_000_000]
    from mappy_rs_tpu_torch.utils.simulate import simulate

    sreads, _ = simulate(rng, small, 64, READ_LEN, ERR)
    gpu = mappy_rs_tpu_torch.Aligner(seq=small, device="cuda")
    cpu = mappy_rs_tpu_torch.Aligner(seq=small, device="cpu")
    for r in sreads:
        a, b = gpu.map(r, cs=True, MD=True), cpu.map(r, cs=True, MD=True)
        if a != b:
            raise AssertionError(f"card and CPU mappings differ: {a} vs {b}")
    log("64 reads: card mappings == CPU plain-version mappings")
    return {"reads_per_s": rate, "fe_ms": fe_ms, "launches": launches,
            "placed": n_ok, "wall_s": wall}


# ----------------------------------------------------------- phases 5 + 6
def real_ext_jobs(al, reads) -> list:
    """The extension jobs the pipeline builds (_make_jobs) for the first
    256 of phase 4's reads: front end on the card, regions on the host."""
    import torch

    from mappy_rs_tpu_torch.models.pipeline import front_end_bt
    from mappy_rs_tpu_torch.ops.regions import (regions_from_compact,
                                                select_sub, set_parent)
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    eng = al._engine
    B, M, A = eng.fe_shapes(1024)
    codes = [encode(r) for r in reads[:B]]
    batch = np.full((B, 1024), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, c in enumerate(codes):
        batch[i, : len(c)] = c
        lens[i] = len(c)
    chains, _aux = front_end_bt(torch.from_numpy(batch).cuda(),
                                torch.from_numpy(lens).cuda(), eng.dev,
                                **eng._fe_kwargs(M, A, 2))
    chains = chains.cpu().numpy()
    jobs = []
    for bi, c in enumerate(codes):
        regions = regions_from_compact(chains[bi], len(c), eng.index.k)
        set_parent(regions, eng.opt.mask_level, eng.opt.mask_len)
        regions = select_sub(regions, eng.opt.pri_ratio, eng.opt.best_n)
        jobs.extend(eng._make_jobs(regions, c, len(c)))
    return jobs


def mutate(rng, codes: np.ndarray, err: float, indel_run: int = 4) -> np.ndarray:
    """Substitutions, insertions and deletion runs (1..indel_run-1
    bases) at rate `err`; 1% of the result becomes N."""
    out = []
    i = 0
    while i < len(codes):
        r = rng.random()
        if r < err * 0.5:
            out.append((int(codes[i]) + 1 + int(rng.integers(0, 3))) % 4)
            i += 1
        elif r < err * 0.75:
            out.append(int(codes[i]))
            out.extend(rng.integers(0, 4, rng.integers(1, indel_run)).tolist())
            i += 1
        elif r < err:
            i += int(rng.integers(1, indel_run))
        else:
            out.append(int(codes[i]))
            i += 1
    q = np.asarray(out, np.uint8)
    q[rng.random(len(q)) < 0.01] = 4
    return q


def ext_batch(jobs, rng, J: int, QMAX: int, TMAX: int) -> dict:
    """One [J] job batch at (QMAX, TMAX): real jobs of that size class
    (largest first), 24 seeded synthetic jobs (8% error, indel runs, N,
    drift up to 64), at (1024, 1024) one indel-dense job, and at least 8
    padded empty jobs.  mode: 0 for mid jobs, 1 for flanks, alternating
    for the synthetic ones."""
    fit = sorted((j for j in jobs if 0 < len(j.q) <= QMAX and 0 < len(j.t) <= TMAX),
                 key=lambda j: -(len(j.q) + len(j.t)))
    n_syn = 24
    dense = QMAX >= 1024
    real = fit[: J - 8 - n_syn - int(dense)]
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    mode = np.ones(J, np.int32)
    rows = [(j.q, j.t, 0 if j.kind == "mid" else 1) for j in real]
    for k in range(n_syn):
        tseq = rng.integers(0, 4, int(rng.integers(TMAX // 4, TMAX - 64)))
        qseq = mutate(rng, tseq[: len(tseq) - int(rng.integers(0, 64))], 0.08)
        rows.append((qseq[:QMAX], tseq, k % 2))
    if dense:  # ~1 indel per 6 bases: far more than 128 runs
        tseq = rng.integers(0, 4, QMAX - 64)
        rows.append((mutate(rng, tseq, 0.35, indel_run=2)[:QMAX], tseq, 0))
    for ji, (qq, tt, m) in enumerate(rows):
        q[ji, : len(qq)] = qq
        t[ji, : len(tt)] = tt
        ql[ji], tl[ji], mode[ji] = len(qq), len(tt), m
    return {"q": q, "t": t, "ql": ql, "tl": tl, "mode": mode,
            "n_real": len(real), "n_dense": int(dense)}


def band_cells(ql: np.ndarray, tl: np.ndarray, W: int, S: int) -> int:
    """Band cells inside each job (cell_ok), summed over the batch."""
    s = np.arange(S)[:, None]
    lo = np.maximum(s // 2 - W // 2 + 1, 0)
    i_lo = np.maximum(lo, s - tl[None, :] + 1)
    i_hi = np.minimum(np.minimum(lo + W - 1, s), ql[None, :] - 1)
    return int(np.clip(i_hi - i_lo + 1, 0, None).sum())


def phase_ext_kernels(al, reads, rng) -> dict:
    import torch

    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb
    from mappy_rs_tpu_torch.ops.extend import BEST_COLS, extend_dp

    eng = al._engine
    params, end_bonus = eng._ext_params, eng.opt.end_bonus
    OPS = eng.cfg.traceback_max_ops
    jobs = real_ext_jobs(al, reads)
    log(f"extension jobs of 256 reads: {len(jobs)} "
        f"({sum(j.kind == 'mid' for j in jobs)} mid)")
    res = {"extend_dp": {"max_abs_err": 0}, "traceback": {"max_abs_err": 0}}
    timing_batch = None
    n_ovf = 0
    for QMAX, TMAX in ((512, 512), (1024, 1024)):
        b = ext_batch(jobs, rng, 256, QMAX, TMAX)
        q, t, ql, tl, mode = (torch.from_numpy(b[k]).cuda()
                              for k in ("q", "t", "ql", "tl", "mode"))
        for W in (32, 64, 128):
            got = ek.extend_dp_kernel(q, t, ql, tl, W, params)
            want = extend_dp(q, t, ql, tl, W, params)
            torch.cuda.synchronize()
            err = max(max_err(got[k], want[k]) for k in ("dirs",) + BEST_COLS)
            n_end = int((want["end_sc"] > 0).sum())
            log(f"K3 J=256 ({QMAX}, {TMAX}) W={W}: {b['n_real']} real jobs, "
                f"{n_end} end cells reached, max_abs_err={err}")
            if err != 0:
                raise AssertionError(f"K3 kernel != plain ({QMAX}, {W})")
            res["extend_dp"]["max_abs_err"] = max(res["extend_dp"]["max_abs_err"], err)
            best = torch.stack([want[c] for c in BEST_COLS], 1)
            for mname, m in (("0", torch.zeros_like(mode)),
                             ("1", torch.ones_like(mode)), ("mixed", mode)):
                o, i = tb.traceback_device(got["dirs"], got["best"], ql, tl, m,
                                           W, OPS, end_bonus)
                o2, i2 = tb.traceback_plain(want["dirs"], best, ql, tl, m, W,
                                            OPS, end_bonus)
                torch.cuda.synchronize()
                err = max(max_err(o, o2), max_err(i, i2))
                started, ovf = int(i[:, 4].sum()), int(i[:, 5].sum())
                log(f"K4 ({QMAX}, {TMAX}) W={W} mode {mname}: started "
                    f"{started}, overflowed {ovf}, max_abs_err={err}")
                if err != 0:
                    raise AssertionError(f"K4 kernel != plain ({QMAX}, {W}, {mname})")
                res["traceback"]["max_abs_err"] = max(res["traceback"]["max_abs_err"], err)
                if b["n_dense"] and mname == "0":
                    # the indel-dense job sits right after the real and
                    # synthetic ones
                    n_ovf += int(i[b["n_real"] + 24, 5])
            if (QMAX, W) == (1024, 64):
                timing_batch = (b, q, t, ql, tl, mode, got, best)
    if n_ovf == 0:
        raise AssertionError("the indel-dense job never overflowed OPS")

    # times and bounds at J=256, (1024, 1024), W=64
    b, q, t, ql, tl, mode, got, best = timing_batch
    W, S = 64, 2047
    k, pl = timed_pair(lambda: ek.extend_dp_kernel(q, t, ql, tl, W, params),
                       lambda: extend_dp(q, t, ql, tl, W, params), 20, 1)
    res["extend_dp"].update(ms=k, plain_ms=pl)
    log(f"K3 time at J=256 (1024, 1024) W=64: kernel {k:.4f} ms, plain {pl:.3f} ms")
    k, pl = timed_pair(
        lambda: tb.traceback_device(got["dirs"], got["best"], ql, tl, mode, W,
                                    OPS, end_bonus),
        lambda: tb.traceback_plain(got["dirs"], best, ql, tl, mode, W, OPS,
                                   end_bonus), 50, 1)
    res["traceback"].update(ms=k, plain_ms=pl)
    log(f"K4 time at J=256 (1024, 1024) W=64 mixed modes: kernel {k:.4f} ms, "
        f"plain {pl:.3f} ms")
    J = 256
    cells = band_cells(b["ql"], b["tl"], W, S)
    res["extend_dp"].update(bound(J * (1024 + 1024) + 8 * J + S * J * W + 24 * J,
                                  cells * OPS_PER_CELL_K3))
    o, i = tb.traceback_device(got["dirs"], got["best"], ql, tl, mode, W, OPS,
                               end_bonus)
    i = i.cpu().numpy()
    on = i[:, 4] == 1
    # a walk from (i0, j0) to (fi, fj) visits at least max(di, dj) cells
    steps = int(np.maximum(i[on, 6] - i[on, 1], i[on, 7] - i[on, 2]).sum())
    res["traceback"].update(bound(steps + 24 * J + 12 * J + J * (OPS + 8) * 4,
                                  steps * OPS_PER_STEP_K4))
    log(f"band cells {cells}, walk steps >= {steps}")
    for name in ("extend_dp", "traceback"):
        r = res[name]
        log(f"{name} bound: {r['bound_ms']:.5f} ms ({r['bound_by']}; "
            f"{r['bytes']:.0f} B, {r['ops']:.0f} int32 ops)")
    return res


# --------------------------------------------------------------- phase 7
def mapping_fields(m) -> tuple:
    return tuple(
        getattr(m, "cigar" if s == "_cig" else "strand" if s == "_strand" else s)
        for s in m.__slots__
    )


def phase_ext_slice(al, reads, starts) -> dict:
    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb

    eng = al._engine
    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    runs = {}
    for backend in ("host", "device", "device_dl"):
        eng.cfg.extension_backend = backend
        al.enable_threading(4)
        list(al.map_batch(payload[:512]))  # warm the path
        al.reset_metrics()
        ek.launches = 0
        tb.launches = 0
        t0 = time.perf_counter()
        out = {d["i"]: [mapping_fields(m) for m in ms]
               for ms, d in al.map_batch(payload)}
        wall = time.perf_counter() - t0
        launches = {"extend_dp": ek.launches, "traceback": tb.launches}
        al.enable_threading(0)
        m = dict(al.metrics)
        placed = sum(1 for i, s in enumerate(starts)
                     if out[i] and abs(out[i][0][5] - s) < 100)
        groups = m.get("ext_groups", 0)
        per_group = m.get("ext_download_bytes", 0) / groups if groups else 0.0
        runs[backend] = {"out": out, "wall_s": wall,
                         "reads_per_s": len(reads) / wall, "placed": placed,
                         "launches": launches, "groups": groups,
                         "dl_bytes_per_group": per_group,
                         "metrics": {k: m[k] for k in m if k.startswith("time_")}}
        log(f"{backend}: {len(reads)} reads in {wall:.3f} s = "
            f"{len(reads) / wall:.1f} reads/s (4 threads); within 100 bp "
            f"{placed} ({100.0 * placed / len(reads):.2f}%); launches "
            f"{launches}; job groups {groups:.0f}, downloaded "
            f"{per_group:.0f} B per group")
        log(f"{backend} engine metrics: " + json.dumps(
            {k: m[k] for k in sorted(m) if k.startswith(("time_", "calls_"))}))
    eng.cfg.extension_backend = "auto"
    host = runs["host"]["out"]
    for backend in ("device", "device_dl"):
        r = runs[backend]
        n_diff = sum(1 for i in host if r["out"][i] != host[i])
        log(f"{backend}: {n_diff} reads map differently from the host backend")
        if n_diff:
            raise AssertionError(f"{backend}: {n_diff} reads differ from host")
        if r["placed"] < 0.99 * len(reads):
            raise AssertionError(f"{backend}: only {r['placed']} reads placed")
    if runs["device"]["launches"]["extend_dp"] <= 0 or \
            runs["device"]["launches"]["traceback"] <= 0:
        raise AssertionError("K3/K4 never launched under 'device'")
    if runs["device_dl"]["launches"]["extend_dp"] <= 0 or \
            runs["device_dl"]["launches"]["traceback"] != 0:
        raise AssertionError("'device_dl' must launch K3 and never K4")

    # cs and MD: the engine's batch call (map_batch's threads ask for cs
    # only), all reads, each device backend against the host backend
    def engine_fields(backend):
        eng.cfg.extension_backend = backend
        out = []
        for c0 in range(0, len(reads), 1024):
            regs = eng.map_batch(reads[c0:c0 + 1024], cs=True, md=True)
            out.extend([mapping_fields(m) for m in al._to_mappings(r)]
                       for r in regs)
        return out

    t0 = time.perf_counter()
    want = engine_fields("host")
    for backend in ("device", "device_dl"):
        n_diff = sum(1 for a, b in zip(engine_fields(backend), want) if a != b)
        log(f"{backend}: cs + MD on {len(reads)} reads, {n_diff} differ from host")
        if n_diff:
            raise AssertionError(f"{backend}: cs/MD differ on {n_diff} reads")
    eng.cfg.extension_backend = "auto"
    log(f"cs + MD comparison: {time.perf_counter() - t0:.1f} s")
    for r in runs.values():
        del r["out"]
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

    t_start = time.perf_counter()
    info = phase_build()

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    genome = random_genome(rng, GENOME_LEN)
    reads, starts = simulate(rng, genome, N_READS, READ_LEN, ERR)
    log(f"data: {GENOME_LEN / 1e6:.0f} Mbp genome, {len(reads)} reads "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    al = mappy_rs_tpu_torch.Aligner(seq=genome)  # device="cuda"
    _ = al._engine.dev
    log(f"index: built and uploaded in {time.perf_counter() - t0:.1f} s")

    kern = phase_kernels(al, reads, rng)
    sl = phase_slice(al, reads, starts, genome)
    kern.update(phase_ext_kernels(al, reads, rng))
    ext = phase_ext_slice(al, reads, starts)
    launches = dict(sl["launches"], **ext["device"]["launches"])

    kernels = []
    for name, src, repl in (
        ("chain_dp", "mappy_rs_tpu_torch/csrc/chain.cu",
         "mappy_rs_tpu/ops/chain_pallas.py:165"),
        ("backtrack_chains", "mappy_rs_tpu_torch/csrc/backtrack.cu",
         "mappy_rs_tpu/ops/backtrack_pallas.py:191"),
        ("extend_dp", "mappy_rs_tpu_torch/csrc/extend.cu",
         "mappy_rs_tpu/ops/extend_pallas.py:300"),
        ("traceback", "mappy_rs_tpu_torch/csrc/traceback.cu",
         "mappy_rs_tpu/ops/traceback_pallas.py:268"),
    ):
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no single PyTorch call computes any of these four functions
            "library_ms": None,
        })
    record = {"card": info["card"], "kernels": kernels,
              "reads_per_s": sl["reads_per_s"], "front_end_ms": sl["fe_ms"],
              "placed": sl["placed"], "n_reads": N_READS,
              "extension_backends": ext,
              "seconds": time.perf_counter() - t_start}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
