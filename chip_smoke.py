"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. card, power limit, torch/CUDA versions; build the CUDA kernels
     (nvcc, sm_90a) and the host C++ library from the checkout.
  2. K1 (chain DP): kernel == plain torch version, exactly, at the main
     path's shape (B=256, A=256, window 128), at windows 256, 512 and
     1024, with a nonzero skip scale (the float penalty path), at the
     anchor-overflow retry's A=4096, on anchors from the real front end
     and on synthetic anchors whose gaps sweep the whole gate range, on
     edge cases (equal candidates, best == span_i, an empty read, a
     non-prefix valid mask), with the splice presets' parameters (K1's
     splice branch, on its float penalty path) on anchors whose
     reference gaps sweep 0-200,000 (utils/simulate.py splice_anchors)
     at (256, 256) and (64, 4096), and at the long-read shapes B=8, A in
     {32,768, 131,072, 524,288}: a tile of 256 sweep anchors repeated
     (utils/simulate.py tile_anchors), whose expected result is the
     tile's plain result, repeated.
  3. K2 (chain backtrack): kernel == plain version, exactly, at
     B=256, A=256, K=8, cuts=2, at A=4096, on the edge cases and at the
     three long-read shapes (K=8, cuts=8).  K1 and K2 are timed (plain,
     kernel, kernel, plain) at (256, 256) and (8, 32,768).
  4. the slice at users' size: Aligner(seq=<32 Mbp random genome>) on
     the card, 8,192 simulated 1 kb reads at 5% error through
     enable_threading(4) + map_batch; at least 99% must map within
     100 bp of their origin, both kernels must have launched, the index
     tensors must be on the card, one front-end dispatch must run under
     torch.cuda.set_sync_debug_mode("error"), and 64 reads must map
     identically on the card and through the CPU plain versions.  Then
     the front-end probes on a [256, 1024] batch: probe_front_end()
     (pipelined and blocking seconds per batch) and front_end_roofline()
     (int ops and bytes), with the bytes and ops as shares of 3.35 TB/s
     and of the int32 rate that bound() uses.
  5. K3 (banded extension DP): kernel == plain version, exactly (dirs
     and the six trackers), at J=253, (512, 512), W in {32, 64, 72, 96,
     128, 160, 256, 288} (both sides of the warp/block switch at 256; 72
     no multiple of 32), and
     J=256, (1024, 1024), W in {32, 64, 128}, on the extension jobs that
     the pipeline builds for 256 of phase 4's reads plus seeded
     synthetic jobs (8% error with indel runs, N bases, drift, padded
     empty jobs, one indel-dense job); at W = 1536 and 6144 (the block
     kernel, rows in global scratch at 6144) on 8 synthetic jobs; and at
     the two group shapes (QMAX, TMAX, W, J) that "device" launches most
     for 2,048 of phase 4's reads, on real jobs of that class.
  6. K4 (traceback): kernel == plain version, exactly, on phase 5's
     direction bytes for modes 0, 1 and mixed (mixed only at the extra
     widths); the indel-dense job must overflow the 128-run table.  K3
     and K4 are timed (eager, graph replay, plain; µs per serial step;
     bound) at J=256, (1024, 1024), W=64 and at the two real shapes.
  7. the device extension backends at users' size: phase 4's reads
     through enable_threading(4) + map_batch with extension_backend
     "host", "device" and "device_dl"; each device backend must place
     >= 99% within 100 bp and give the host backend's Mappings field
     for field (cs and MD too, through the engine's batch call); K3 and
     K4 must launch under "device", K4 never under "device_dl"; the
     histogram of K3's launch shapes is logged per backend.
  8. long reads: 64 simulated 100 kb reads at 5% error against phase
     4's genome through enable_threading(4) + map_batch at the default
     config (131,072 bucket, B=8, A=32,768); >= 99% placed (the
     leftmost primary part within 100 bp of the origin: z-drop splits
     some alignments into collinear parts), K1 and K2 launched, and 8
     of the reads map identically on the card and through the CPU
     plain versions.
  9. presets at users' size, each with its own index of phase 4's
     genome on the card: map-hifi (512 x 15 kb reads, 0.5% error),
     sr (8,192 x 150 bp, 1%), map-pb (512 x 10 kb with PacBio-like
     homopolymer run-length noise plus 2% substitutions; the index and
     the reads homopolymer-compressed) and splice (1,024 transcripts of
     3-8 exons joined across 80-5,000 bp introns written into a copy of
     the genome, half GT..AG and half CT..AC, 1% error), each through
     enable_threading(4) + map_batch.  Placed (within 100 bp; splice:
     with an N op too): >= 99%, splice >= 90%.  K1 and K2 must launch
     for every preset; on one real batch of each at its most common
     launched shape K1 and K2 == plain (splice: K1's splice branch) and
     are timed; 16 reads of each map identically on the card and
     through the CPU plain versions; and on 256 map-hifi reads the
     "device" extension backend (K3 + K4 at a=1, b=4, q=6, e=2, q2=26,
     e2=1) gives the host backend's Mappings, cs and MD included.
 10. the process runtime at users' size: phase 4's index and reads
     through enable_threading(4) with worker_processes = 4, first under
     topology "device_owner" (the front end in this process, 4 CUDA-free
     post-chain children), then "classic" (4 children, each with the
     whole pipeline, its own CUDA context and index copy on the card).
     Each must start its children (_procs set: the fallback to threads
     fails the phase), give phase 4's threaded Mappings for all 8,192
     reads (every field, cs too), place >= 99%, and hold the card from
     the right processes (nvidia-smi's compute apps: no child under
     "device_owner", every child under "classic").  Then the host
     backtrack on the card: backtrack_fits made to refuse every A
     in-process, 256 of phase 4's reads and 8 of phase 8's 100 kb reads
     map through K1 and the host backtrack exactly as through K2, with
     K1 launched and K2 not.
 11. multi-device on one card, every grid cell on cuda:0: (a) a fresh
     Aligner(seq=<phase 4's genome>) with enable_mesh(2, n_index=2) (the
     key table sharded by key range over 2 peers per row) and phase 4's
     Aligner with enable_mesh(4) (data-parallel, tables replicated),
     each through enable_threading(4) + map_batch on phase 4's 8,192
     reads: 0 reads may differ from phase 4's Mappings, K1 launched, K2
     not (the host backtrack, as under the JAX package's mesh), and the
     sharded Aligner never builds the replicated tables; (b) decision
     mode, enable_sharding(2, 2) + map_batch_positions over the 8,192
     reads in batches of 512: >= 99% on the read's strand with r_en
     within 100 bp of its true end, K3 launched, K3 == plain at the
     batch's shape (J=256, 1024, 1152, W=128; timed eagerly and as a
     CUDA-graph replay), and 256 reads decided as
     through the port on a grid of CPU cells; (c) two spawned processes
     on cuda:0, each with a 2 x 2 grid, joined over Gloo
     (parallel/multihost.py), run the decision step on 512 reads: the
     gathered results == a one-process 4 x 2 grid's, array for array.
 12. genome scale: the port's mappy_rs_tpu_torch/tools/gbp_chip.py run at
     23 contigs of 2^27 bp (3.09 Gbp, the hg38-like model: 52% covered by
     copies of a 40-element repeat library), built fresh: build_index
     with its sort on the card, the device tables built there, an
     Aligner around the index under "device_owner" with 3 CUDA-free
     children, a warm-up, then 2 passes of 8,000 1 kb reads through
     map_batch.  It raises unless the card's build (sort and tables)
     equals the CPU build array for array at k = 15 and 19 on 3 x 2^20 bp
     of the model, (key, y) strictly increases over the genome-scale
     index the card sorted, and (a) every index tensor is on the card
     with tools/hbm_budget.py's count of bytes, (b) K1 and K2 launched in
     this process during the passes, (c) >= 99% of unique-origin reads
     are placed (the origin's contig, within 100 bp), (d) 32
     unique-origin reads map identically through the card engine and a
     CPU engine on the same tables (the plain K1 / K2), and (e) the host
     RAM, free temporary space and card memory it needs are there before
     it starts.  Phase 11 also runs (d) the top-level entry points,
     entry() and dryrun_multichip(4) with every cell on cuda:0.
 13. the last tools and the rare paths: (a) the concordance sweep
     (mappy_rs_tpu_torch/tools/concordance.py) of map-ont, map-hifi,
     sr, asm5 and splice at N = 1,000 reads each on the card, the device
     front end (K1 + K2) against the native C++ one: both mapped >= 93%,
     one side only <= 2%, full hit tuples >= 95% and coordinates >= 98%
     of both mapped, K1 and K2 launched for each preset; (b) the
     rare-path constructions (utils/simulate.py: the inversion read and
     its reverse complement, a junk gap, the five zdrop-split cases, the
     five RMQ reads, the 64-read fallback batch) through a card Aligner
     and a CPU Aligner under "host", "device" and "device_dl" (the CPU
     side in 6 worker processes meanwhile): equal Mappings (cs, MD) and
     zdrop_splits / inv_rescues; the inversion read split and rescued
     once, but not under "device_dl" (as the JAX package); under
     "device" K3 and K4 launched inside the split rounds, on the
     remainders; (c) tools/trace_front_end.py on a fresh map-ont Aligner
     of phase 4's genome ([256, 1024], 20 replays) and on 8 map-hifi
     15 kb reads ([8, 32,768]): busy ms per batch from torch.profiler
     and from CUDA events, duty, the top device ops, with K1's and K2's
     kernels among the traced ops.
 14. the measurement tools: (a) mappy_rs_tpu_torch/tools/bench.py at its
     full workload (32 Mbp, 6 passes of 8,000 1 kb reads, "device_owner"
     with 3 children and 9 proxies) with the CPU baseline measured on this
     host (the native CPU path on device="cpu", the better of n_cores
     threads and n_cores processes): its JSON line printed, >= 99% of
     every pass within 100 bp, K1 and K2 launched in this process during
     the passes, no baseline child on the card (nvidia-smi's compute apps
     no more while the children run than before); (b) tools/thread_bench.py
     at its defaults (400 reads, 0.5 Mbp): four rows, equal mapped counts,
     >= 99% mapped; (c) tools/memory.py --threaded --cycles 50 on the card
     in its own process: its RSS and card memory (allocated, reserved)
     each grown <= 200 MB after cycle 2, the Mappings the same in every
     cycle; (d) tools/microbench.py: dispatch, transfer and front-end
     times, all > 0.
Prints per-kernel times (CUDA events around eager calls, the JSON
line's `ms`; also as CUDA-graph replays, `graph_ms`, which leave out
the host's launch cost) beside the plain versions' and each
kernel's bound (the larger of the bytes this run's data needs over
3.35 TB/s and its int32 operations over 16.7 Top/s), the kernels' JSON
line, the card line, and last the result line.  Exits non-zero without
a result when no card is visible.
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
LONG_READS = 64
LONG_LEN = 100_000
LONG_SHAPES = (32768, 131072, 524288)  # A at B=8: the 131,072 bucket's budgets


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


def cuda_ms(fn, n: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() over n launches (CUDA events)."""
    import torch

    if warm:
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


def graph_ms(fn, n: int) -> float:
    """Mean milliseconds of fn() on the device: n calls captured in one
    CUDA graph, replayed between CUDA events, so the host's launch cost
    (the wrapper's checks, ctypes) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def timed_pair(kernel, plain, n_kernel: int, n_plain: int,
               warm_plain: bool = True):
    """(kernel_ms, plain_ms), interleaved plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, n_plain, warm_plain)
    k1 = cuda_ms(kernel, n_kernel)
    k2 = cuda_ms(kernel, n_kernel)
    p2 = cuda_ms(plain, n_plain, warm_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def k1_bound(anchors, H: int) -> dict:
    """K1's bound from these anchors: the valid mask and the five fields
    of each valid anchor read once, f/p written once; each valid anchor
    scored against the valid anchors of its window of H."""
    import torch

    valid = anchors["valid"]
    B, A = valid.shape
    cs = torch.nn.functional.pad(valid.long().cumsum(1), (1, 0))
    idx = torch.arange(A, device=valid.device)
    in_window = cs[:, idx] - cs[:, (idx - H).clamp(min=0)]
    pairs = float((valid * in_window).sum())
    n_valid = float(valid.sum())
    return bound(n_valid * 5 * 4 + B * A * (1 + 8), pairs * OPS_PER_PAIR_K1)


def k2_walk(anchors, f, p, K: int, min_sc: int) -> tuple:
    """(walk steps, passes that found an end) of K2 on these inputs,
    summed over the reads: each pass takes the best unused candidate
    (valid, f >= min_sc) and walks p until a used anchor or a start,
    kept chains and rejected ones alike (ops/backtrack.py semantics)."""
    fv = f.cpu().numpy().astype(np.int64)
    pv = p.cpu().numpy()
    ok = anchors["valid"].cpu().numpy() & (fv >= min_sc)
    B, A = fv.shape
    steps = ends = 0
    for b in range(B):
        used = np.zeros(A, bool)
        fc = np.where(ok[b], fv[b], -(1 << 40))
        for _ in range(K):
            cand = np.where(used, -(1 << 40), fc)
            best = cand.max()
            if best <= -(1 << 40):
                break
            cur = int(np.flatnonzero(cand == best)[-1])
            ends += 1
            for _ in range(A):
                used[cur] = True
                steps += 1
                cur = int(pv[b, cur])
                if cur < 0 or used[cur]:
                    break
    return steps, ends


def k2_bound(anchors, f, p, K: int, cuts: int, min_sc: int) -> dict:
    """K2's bound from this run's walks: f and valid read once for the
    candidate scan, p/qpos/rpos once per walk step, the end's rev, rid,
    rpos and qpos, f at the join and span at the start once per pass,
    the chain table written once; K passes over the valid candidates."""
    valid = anchors["valid"]
    B, A = valid.shape
    steps, ends = k2_walk(anchors, f, p, K, min_sc)
    n_valid = float(valid.sum())
    return {**bound(B * A * (4 + 1) + 12 * steps + 24 * ends
                    + B * K * (9 + 2 * cuts) * 4,
                    K * n_valid * OPS_PER_CAND_K2),
            "walk_steps_all": steps, "walk_ends": ends}


def serial_steps(anchors) -> int:
    """K1's serial steps: the largest (last valid index + 1) of a row."""
    import torch

    valid = anchors["valid"]
    A = valid.shape[1]
    idx = torch.arange(1, A + 1, device=valid.device)
    return int((valid * idx).amax())


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
    from mappy_rs_tpu_torch.utils.simulate import (edge_anchors,
                                                   splice_anchors,
                                                   sweep_anchors,
                                                   tile_anchors,
                                                   tile_chain_result)

    eng = al._engine
    params = eng._chain_params
    splice_prm = params._replace(max_dist_x=200_000, max_dist_y=2000,
                                   bw=200_000, is_splice=1)
    res = {"chain_dp": {"max_abs_err": 0}, "backtrack_chains": {"max_abs_err": 0}}

    def k1_check(anchors, window, label, prm=params):
        f, p = ck.chain_scores_kernel(anchors, prm, window)
        fr, pr = chain_scores(anchors, prm, ck.window_of(window))
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
    k1_check(syn_w, 256, "gate sweep, R=2")
    k1_check(sweep_anchors(rng, 64, 2048, bw, device="cuda"), 1024,
             "gate sweep, R=8")
    # a nonzero skip scale takes K1's float penalty path, not its table
    k1_check(syn, 128, "gate sweep, skip scale 0.37",
             params._replace(chn_pen_skip=0.37 * 0.01 * al._engine.index.k))
    syn_big = sweep_anchors(rng, 256, 4096, bw, device="cuda")
    f_big, p_big = k1_check(syn_big, 128, "gate sweep, A=4096")
    real_big = front_end_anchors(al, reads, 4096)
    k1_check(real_big, 128, "front-end anchors, A=4096")
    edge = edge_anchors(rng, 512, device="cuda")
    for window in (128, 512):
        f_e, p_e = k1_check(edge, window, "edge cases")
        k2_check(edge, f_e, p_e, "edge cases")
    # K1's splice branch: the float penalty path at the splice presets'
    # gates, reference gaps swept 0-200,000
    for B, A in ((64, 4096), (256, 256)):
        an = splice_anchors(rng, B, A, device="cuda")
        f_s, p_s = k1_check(an, 128, "splice gap sweep", splice_prm)
        k2_check(an, f_s, p_s, "splice gap sweep")
    # timed at the main path's shape, beside the table path's row
    k, pl = timed_pair(lambda: ck.chain_scores_kernel(an, splice_prm, 128),
                       lambda: chain_scores(an, splice_prm, 128), 50, 1)
    kg = graph_ms(lambda: ck.chain_scores_kernel(an, splice_prm, 128), 50)
    res["chain_dp"]["splice_sweep"] = {
        "ms": k, "graph_ms": kg, "plain_ms": pl, "shape": [B, A],
        **k1_bound(an, 128)}
    log(f"K1 time, splice gap sweep at B={B} A={A}: kernel {k:.4f} ms per "
        f"eager call, {kg:.4f} ms on the device, plain {pl:.3f} ms; bound "
        f"{res['chain_dp']['splice_sweep']['bound_ms']:.5f} ms")

    k2_check(real, f_real, p_real, "front-end anchors")
    k2_check(syn, f_syn, p_syn, "gate sweep")
    k2_check(syn_big, f_big, p_big, "gate sweep, A=4096")

    # the long-read shapes: B=8, one tile of 256 anchors repeated
    tile = sweep_anchors(rng, 8, 256, bw, device="cuda")
    f_t, p_t = chain_scores(tile, params, 128)
    long_in = None
    for A in LONG_SHAPES:
        reps = A // 256
        big = tile_anchors(tile, reps)
        f, p = ck.chain_scores_kernel(big, params, 128)
        fr, pr = tile_chain_result(f_t, p_t, reps)
        torch.cuda.synchronize()
        err = max(max_err(f, fr), max_err(p, pr))
        log(f"K1 tiled: B=8 A={A} links={int((p >= 0).sum())} "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K1 kernel != tiled plain result (A={A})")
        k2_check(big, f, p, f"tiled, A={A}", K=8, cuts=8)
        if long_in is None:
            long_in = (big, f, p)
        del big, f, p, fr, pr

    # times at the main path's shape (B=256, A=256) and at (8, 32,768)
    mc, ms = eng.opt.min_cnt, eng.opt.min_chain_score
    for label, an, f, p, n_k, n_p, warm, cuts in (
        ("main", real, f_real, p_real, 200, 3, True, 2),
        ("long", *long_in, 20, 1, False, 8),
    ):
        B, A = an["valid"].shape
        k, pl = timed_pair(
            lambda: ck.chain_scores_kernel(an, params, 128),
            lambda: chain_scores(an, params, 128), n_k, n_p, warm)
        kg = graph_ms(lambda: ck.chain_scores_kernel(an, params, 128), n_k)
        steps = serial_steps(an)
        # ms: per eager call, as the main path launches it; graph_ms: the
        # device time alone, which the per-step figure divides
        k1 = {"ms": k, "graph_ms": kg, "plain_ms": pl,
              "us_per_step": 1e3 * kg / steps, "steps": steps,
              **k1_bound(an, ck.window_of(128))}
        log(f"K1 time at B={B} A={A}: kernel {k:.4f} ms per eager call, "
            f"{kg:.4f} ms on the device (graph replay), plain {pl:.3f} ms; "
            f"{steps} serial steps, {k1['us_per_step']:.4f} us per step")
        k, pl = timed_pair(
            lambda: bt.backtrack_chains(an, f, p, 8, cuts, mc, ms),
            lambda: bt.backtrack_chains_plain(an, f, p, 8, cuts, mc, ms),
            n_k, n_p, warm)
        kg = graph_ms(lambda: bt.backtrack_chains(an, f, p, 8, cuts, mc, ms),
                      n_k)
        o = bt.backtrack_chains(an, f, p, 8, cuts, mc, ms)
        cnt = torch.where(o[:, :, 1] > 0, o[:, :, 1], 0).sum(dim=1)
        walk = int(cnt.max())
        k2 = {"ms": k, "graph_ms": kg, "plain_ms": pl, "walk_steps": walk,
              "walk_steps_total": int(cnt.sum()),
              **k2_bound(an, f, p, 8, cuts, ms)}
        log(f"K2 time at B={B} A={A} K=8: kernel {k:.4f} ms per eager "
            f"call, {kg:.4f} ms on the device (graph replay), plain "
            f"{pl:.3f} ms; kept chains' walk steps: {walk} in the longest "
            f"read, {k2['walk_steps_total']} in all; every walk: "
            f"{k2['walk_steps_all']} steps from {k2['walk_ends']} ends")
        for name, r in (("chain_dp", k1), ("backtrack_chains", k2)):
            log(f"{name} bound at B={B} A={A}: {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}; {r['bytes']:.0f} B, {r['ops']:.0f} "
                f"int32 ops)")
            if label == "main":
                res[name].update(r)
            else:
                res[name]["long"] = r
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
    out = {}
    for mappings, data in al.map_batch(
        [{"i": i, "seq": s} for i, s in enumerate(reads)]
    ):
        out[data["i"]] = [mapping_fields(m) for m in mappings]
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
    probes = front_end_probes(al, reads)
    return {"reads_per_s": rate, "fe_ms": fe_ms, "launches": launches,
            "placed": n_ok, "wall_s": wall, "out": out, "probes": probes}


def front_end_probes(al, reads) -> dict:
    """probe_front_end() and front_end_roofline() after one [256, 1024]
    batch, and the roofline's bytes and int ops per pipelined batch as
    shares of the memory rate and the int32 rate of bound()."""
    al._engine.map_batch(reads[:256], cs=True)  # the batch they re-dispatch
    probe = al.probe_front_end()
    roof = al.front_end_roofline()
    if len(probe) != 2 or min(probe) <= 0 or not roof:
        raise AssertionError(f"front-end probes: {probe}, {roof}")
    thr = probe[0]
    shares = {"bytes_share": roof["hbm_bytes"] / thr / HBM_BYTES_PER_S,
              "int_ops_share": roof["int_ops"] / thr / INT32_OPS_PER_S}
    log(f"probe_front_end(): pipelined {1e3 * probe[0]:.3f} ms, blocking "
        f"{1e3 * probe[1]:.3f} ms per batch; front_end_roofline(): "
        f"{json.dumps(roof)}; per pipelined batch "
        f"{100 * shares['bytes_share']:.3f}% of {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s, {100 * shares['int_ops_share']:.3f}% of "
        f"{INT32_OPS_PER_S / 1e12:.2f} Top/s int32")
    return {"probe_s": probe, "roofline": roof, **shares}


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


def pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def ext_class(eng, job):
    """The (QMAX, TMAX, W) group that the device backends' _run_jobs
    (models/pipeline.py) gives a job, or None for a job they leave to the
    host (empty, or small: q <= 64 and t <= 160 bases)."""
    ql, tl = len(job.q), len(job.t)
    if ql == 0 or tl == 0 or (ql <= 64 and tl <= 160):
        return None
    QMAX, TMAX = pow2_at_least(ql, 64), pow2_at_least(tl, 64)
    W = eng._mid_band(abs(ql - tl)) if job.kind == "mid" else eng.flank_band
    return QMAX, TMAX, min(W, pow2_at_least(QMAX + TMAX, 128))


def class_batch(eng, jobs, QMAX: int, TMAX: int, W: int, J: int) -> dict:
    """J jobs of one real group shape: the real jobs of that class, in
    turn (repeated when there are fewer than J); mode 0 for mid jobs, 1
    for flanks."""
    fit = [j for j in jobs if ext_class(eng, j) == (QMAX, TMAX, W)]
    if not fit:
        raise AssertionError(f"no real job of class {(QMAX, TMAX, W)}")
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    mode = np.ones(J, np.int32)
    for ji in range(J):
        j = fit[ji % len(fit)]
        q[ji, : len(j.q)] = j.q
        t[ji, : len(j.t)] = j.t
        ql[ji], tl[ji] = len(j.q), len(j.t)
        mode[ji] = 0 if j.kind == "mid" else 1
    return {"q": q, "t": t, "ql": ql, "tl": tl, "mode": mode,
            "n_real": len(fit)}


def launched_shapes(al, payload, backend: str) -> dict:
    """K3's launches by (QMAX, TMAX, W, J) while map_batch runs `payload`
    through enable_threading(4) under `backend`."""
    from mappy_rs_tpu_torch.ops import extend_kernel as ek

    eng = al._engine
    eng.cfg.extension_backend = backend
    al.enable_threading(4)
    ek.shapes.clear()
    list(al.map_batch(payload))
    al.enable_threading(0)
    eng.cfg.extension_backend = "auto"
    return dict(ek.shapes)


def walk_steps(tb, dirs, best, ql, tl, mode, W: int, end_bonus: int):
    """Each job's K4 walk steps (one byte read and one op each), from
    the kernel's runs with a table wide enough for every walk."""
    import torch

    o, i = tb.traceback_device(dirs, best, ql, tl, mode, W, 4096, end_bonus)
    if int(i[:, 5].sum()):
        raise AssertionError("a walk overflowed 4,096 runs")
    return torch.where(o >= 0, o >> 4, 0).sum(dim=1)


def time_ext(ek, tb, extend_dp, b: dict, W: int, params, end_bonus: int,
             OPS: int, n_k: int, n_p: int, plain: bool = True) -> dict:
    """K3 and K4 of the given modules on one batch: per eager call
    (`ms`, CUDA events), on the device (`graph_ms`, CUDA-graph replay),
    the plain versions (`plain_ms`, when `plain`), µs per serial step
    (K3: per diagonal of the longest job, qlen + tlen - 1 of them; K4: per
    step of the longest walk) and the bound of this batch's work."""
    import torch

    from mappy_rs_tpu_torch.ops.traceback import traceback_plain

    q, t, ql, tl, mode = (torch.from_numpy(b[k]).cuda()
                          for k in ("q", "t", "ql", "tl", "mode"))
    J, QMAX = b["q"].shape
    TMAX = b["t"].shape[1]
    S = QMAX + TMAX - 1
    got = ek.extend_dp_kernel(q, t, ql, tl, W, params)
    best = got["best"]
    k3_fn = lambda: ek.extend_dp_kernel(q, t, ql, tl, W, params)  # noqa: E731
    k4_fn = lambda: tb.traceback_device(  # noqa: E731
        got["dirs"], best, ql, tl, mode, W, OPS, end_bonus)
    out = {}
    for name, fn, pl in (
        ("extend_dp", k3_fn, lambda: extend_dp(q, t, ql, tl, W, params)),
        ("traceback", k4_fn, lambda: traceback_plain(
            got["dirs"], best, ql, tl, mode, W, OPS, end_bonus)),
    ):
        if plain:
            k, p = timed_pair(fn, pl, n_k, n_p)
        else:
            k, p = (cuda_ms(fn, n_k) + cuda_ms(fn, n_k)) / 2, None
        out[name] = {"ms": k, "graph_ms": graph_ms(fn, n_k), "plain_ms": p}
    lens = b["ql"].astype(np.int64) + b["tl"]
    diags = int(np.where((b["ql"] > 0) & (b["tl"] > 0), lens - 1, 0).max())
    cells = band_cells(b["ql"], b["tl"], W, S)
    out["extend_dp"].update(
        steps=diags, us_per_step=1e3 * out["extend_dp"]["graph_ms"] / diags,
        **bound(J * (QMAX + TMAX) + 8 * J + S * J * W + 24 * J,
                cells * OPS_PER_CELL_K3))
    steps = walk_steps(tb, got["dirs"], best, ql, tl, mode, W, end_bonus)
    longest, total = int(steps.max()), int(steps.sum())
    out["traceback"].update(
        steps=longest, steps_total=total,
        us_per_step=1e3 * out["traceback"]["graph_ms"] / max(longest, 1),
        **bound(total + 24 * J + 12 * J + J * (OPS + 8) * 4,
                total * OPS_PER_STEP_K4))
    return out


def check_ext(ek, tb, extend_dp, b: dict, W: int, params, end_bonus: int,
              OPS: int, modes, label: str, res: dict) -> None:
    """K3 and K4 == their plain versions, exactly, on one batch."""
    import torch

    from mappy_rs_tpu_torch.ops.extend import BEST_COLS

    q, t, ql, tl, mode = (torch.from_numpy(b[k]).cuda()
                          for k in ("q", "t", "ql", "tl", "mode"))
    got = ek.extend_dp_kernel(q, t, ql, tl, W, params)
    want = extend_dp(q, t, ql, tl, W, params)
    torch.cuda.synchronize()
    err = max(max_err(got[k], want[k]) for k in ("dirs",) + BEST_COLS)
    n_end = int((want["end_sc"] > 0).sum())
    log(f"K3 {label} W={W}: {n_end} end cells reached, max_abs_err={err}")
    if err != 0:
        raise AssertionError(f"K3 kernel != plain ({label}, W={W})")
    res["extend_dp"]["max_abs_err"] = max(res["extend_dp"]["max_abs_err"], err)
    best = torch.stack([want[c] for c in BEST_COLS], 1)
    for mname in modes:
        m = {"0": torch.zeros_like(mode), "1": torch.ones_like(mode),
             "mixed": mode}[mname]
        o, i = tb.traceback_device(got["dirs"], got["best"], ql, tl, m, W,
                                   OPS, end_bonus)
        o2, i2 = tb.traceback_plain(want["dirs"], best, ql, tl, m, W, OPS,
                                    end_bonus)
        torch.cuda.synchronize()
        err = max(max_err(o, o2), max_err(i, i2))
        log(f"K4 {label} W={W} mode {mname}: started {int(i[:, 4].sum())}, "
            f"overflowed {int(i[:, 5].sum())}, max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K4 kernel != plain ({label}, W={W}, {mname})")
        res["traceback"]["max_abs_err"] = max(res["traceback"]["max_abs_err"], err)
        if b.get("n_dense") and mname == "0":
            # the indel-dense job sits right after the real and synthetic ones
            res["n_ovf"] += int(i[b["n_real"] + 24, 5])


def phase_ext_kernels(al, reads, rng) -> dict:
    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb
    from mappy_rs_tpu_torch.ops.extend import extend_dp

    eng = al._engine
    params, end_bonus = eng._ext_params, eng.opt.end_bonus
    OPS = eng.cfg.traceback_max_ops
    jobs = real_ext_jobs(al, reads)
    log(f"extension jobs of 256 reads: {len(jobs)} "
        f"({sum(j.kind == 'mid' for j in jobs)} mid)")
    res = {"extend_dp": {"max_abs_err": 0}, "traceback": {"max_abs_err": 0},
           "n_ovf": 0}
    # J=256 and 253 (no multiple of the 4 jobs per block of K3's and K4's
    # warp kernels); W on both sides of K3's warp/block switch (256/288),
    # and 72 (no multiple of 32 or 16: K3's block kernel, K4 without slabs)
    for QMAX, TMAX, J, Ws in ((512, 512, 253, (32, 64, 72, 96, 128, 160, 256, 288)),
                              (1024, 1024, 256, (32, 64, 128))):
        b = ext_batch(jobs, rng, J, QMAX, TMAX)
        log(f"batch J={J} ({QMAX}, {TMAX}): {b['n_real']} real jobs")
        for W in Ws:
            modes = ("0", "1", "mixed") if W in (32, 64, 128) else ("mixed",)
            check_ext(ek, tb, extend_dp, b, W, params, end_bonus, OPS, modes,
                      f"J={J} ({QMAX}, {TMAX})", res)
        if QMAX == 1024:
            timing_batch = b
    if res.pop("n_ovf") == 0:
        raise AssertionError("the indel-dense job never overflowed OPS")
    # bands past 1,024 lanes (K3's block kernel; W=6144 keeps its rows in
    # the global scratch) on a few seeded jobs
    wide = ext_batch([], rng, 32, 1024, 1024)  # 24 synthetic jobs first
    wide = {k: (v[16:24] if isinstance(v, np.ndarray) else 0)
            for k, v in wide.items()}
    for W in (1536, 6144):
        check_ext(ek, tb, extend_dp, wide, W, params, end_bonus, OPS,
                  ("mixed",), "J=8 (1024, 1024)", res)

    # the group shapes the device backend launches most (2,048 of phase
    # 4's reads), checked and timed at real jobs of their class
    shapes = launched_shapes(al, [{"i": i, "seq": s} for i, s in
                                  enumerate(reads[:2048])], "device")
    top = sorted(shapes.items(), key=lambda kv: (-kv[1], kv[0]))[:2]
    log(f"K3 launches by (QMAX, TMAX, W, J), 2,048 reads under 'device': "
        f"{sorted(shapes.items(), key=lambda kv: -kv[1])}")
    runs = {"main": (timing_batch, 64, 20, 1)}
    for (QMAX, TMAX, W, J), n in top:
        b = class_batch(eng, jobs, QMAX, TMAX, W, J)
        check_ext(ek, tb, extend_dp, b, W, params, end_bonus, OPS,
                  ("0", "1", "mixed"), f"real group J={J} ({QMAX}, {TMAX})",
                  res)
        runs[f"{QMAX}x{TMAX}x{W}x{J}"] = (b, W, 200, 3)
    for label, (b, W, n_k, n_p) in runs.items():
        tm = time_ext(ek, tb, extend_dp, b, W, params, end_bonus, OPS, n_k, n_p)
        J, QMAX = b["q"].shape
        for name, r in tm.items():
            log(f"{name} at J={J} ({QMAX}, {b['t'].shape[1]}) W={W}: "
                f"{r['ms']:.4f} ms per eager call, {r['graph_ms']:.4f} ms on "
                f"the device (graph replay), plain {r['plain_ms']:.3f} ms; "
                f"{r['steps']} serial steps, {r['us_per_step']:.4f} us per "
                f"step; bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
                f"{r['bytes']:.0f} B, {r['ops']:.0f} int32 ops)")
            if label == "main":
                res[name].update(r)
            else:
                res[name].setdefault("real", {})[label] = dict(
                    r, launches_per_2048_reads=shapes[tuple(
                        int(x) for x in label.split("x"))])
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
        ek.shapes.clear()
        tb.launches = 0
        t0 = time.perf_counter()
        out = {d["i"]: [mapping_fields(m) for m in ms]
               for ms, d in al.map_batch(payload)}
        wall = time.perf_counter() - t0
        launches = {"extend_dp": ek.launches, "traceback": tb.launches}
        shapes = sorted(ek.shapes.items(), key=lambda kv: (-kv[1], kv[0]))
        al.enable_threading(0)
        m = dict(al.metrics)
        placed = sum(1 for i, s in enumerate(starts)
                     if out[i] and abs(out[i][0][5] - s) < 100)
        groups = m.get("ext_groups", 0)
        per_group = m.get("ext_download_bytes", 0) / groups if groups else 0.0
        runs[backend] = {"out": out, "wall_s": wall,
                         "reads_per_s": len(reads) / wall, "placed": placed,
                         "launches": launches, "groups": groups,
                         "k3_shapes": [[*k, n] for k, n in shapes],
                         "dl_bytes_per_group": per_group,
                         "metrics": {k: m[k] for k in m if k.startswith("time_")}}
        log(f"{backend}: {len(reads)} reads in {wall:.3f} s = "
            f"{len(reads) / wall:.1f} reads/s (4 threads); within 100 bp "
            f"{placed} ({100.0 * placed / len(reads):.2f}%); launches "
            f"{launches}; job groups {groups:.0f}, downloaded "
            f"{per_group:.0f} B per group")
        if shapes:
            log(f"{backend}: K3 launches by (QMAX, TMAX, W, J): {shapes}")
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


# --------------------------------------------------------------- phase 8
def phase_long_reads(al, genome) -> dict:
    import dataclasses

    import torch

    from mappy_rs_tpu_torch.models.pipeline import (AlignmentEngine,
                                                    front_end_bt)
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.utils.seqcodes import encode
    from mappy_rs_tpu_torch.utils.simulate import simulate

    eng = al._engine
    rng = np.random.default_rng(SEED + 8)
    t0 = time.perf_counter()
    reads, starts = simulate(rng, genome, LONG_READS, LONG_LEN, ERR)
    L = eng._bucket_len(max(len(r) for r in reads))
    B, M, A = eng.fe_shapes(L)
    log(f"long reads: {len(reads)} x {LONG_LEN} bp at {ERR:.0%} error "
        f"({time.perf_counter() - t0:.1f} s); bucket L={L}, B={B}, A={A}")

    # the front end alone on one [B, L] batch (CUDA events)
    batch = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:B]):
        c = encode(r)
        batch[i, : len(c)] = c
        lens[i] = len(c)
    codes_t = torch.from_numpy(batch).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = eng._fe_kwargs(M, A, min(8, L // eng.SEG_LEN))
    fe_ms = cuda_ms(lambda: front_end_bt(codes_t, lens_t, eng.dev, **kw), 5)
    log(f"long-read front end: {fe_ms:.3f} ms per [{B}, {L}] batch "
        "(CUDA events)")

    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    al.enable_threading(4)
    list(al.map_batch(payload[:B]))  # warm the bucket's shapes
    al.reset_metrics()
    ck.launches = 0
    bt.launches = 0
    t0 = time.perf_counter()
    placed = split = 0
    for mappings, data in al.map_batch(payload):
        # z-drop may split a 100 kb alignment into collinear primary
        # parts; the read is placed when its leftmost part starts at
        # the origin
        prim = [m for m in mappings if m.is_primary]
        split += len(prim) > 1
        if prim and abs(min(m.target_start for m in prim)
                        - starts[data["i"]]) < 100:
            placed += 1
    wall = time.perf_counter() - t0
    launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
    al.enable_threading(0)
    m = al.metrics
    batches = m.get("fe_batches", 0)
    fe_thread_ms = 1e3 * m.get("time_front_end_s", 0.0) / max(batches, 1)
    log(f"long reads: {len(reads)} in {wall:.3f} s = {len(reads) / wall:.2f} "
        f"reads/s (4 threads); within 100 bp {placed} "
        f"({100.0 * placed / len(reads):.2f}%), {split} split into several "
        f"primary parts; launches {launches}; "
        f"{batches:.0f} front-end batches, {fe_thread_ms:.1f} thread-ms "
        "of front end per batch (submit + collect)")
    log("long-read engine metrics: " + json.dumps(
        {k: m[k] for k in sorted(m) if k.startswith(("time_", "calls_", "fe_",
                                                     "anchor_"))}))
    if placed < 0.99 * len(reads):
        raise AssertionError(f"long reads: only {placed}/{len(reads)} placed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"long reads: kernel {name} never launched")

    # 8 reads in one batch: the card == the CPU plain versions
    cpu = AlignmentEngine(eng.index, eng.opt,
                          dataclasses.replace(eng.cfg, device="cpu"))
    t0 = time.perf_counter()
    sel = reads[:8]
    got = [al._to_mappings(r) for r in eng.map_batch(sel, cs=True)]
    want = [al._to_mappings(r) for r in cpu.map_batch(sel, cs=True)]
    n_diff = sum(1 for a, b in zip(got, want) if a != b)
    log(f"long reads: 8 reads on the card vs the CPU plain versions: "
        f"{n_diff} differ ({time.perf_counter() - t0:.1f} s)")
    if n_diff:
        raise AssertionError(f"long reads: {n_diff} of 8 differ card vs CPU")
    return {"reads_per_s": len(reads) / wall, "wall_s": wall,
            "placed": placed, "split": split, "n_reads": len(reads),
            "launches": launches,
            "fe_ms": fe_ms, "fe_thread_ms_per_batch": fe_thread_ms,
            "shape": [B, L, A], "sel": sel, "got": got}


# --------------------------------------------------------------- phase 9
#: phase 9: (preset, reads, read length, error, share to place); splice
#: transcripts are 3-8 exons of 100-300 bp (utils/simulate.py)
#: (read counts halved from 1,024 / 1,024 / 2,048, and N_CARD_VS_CPU from
#: 32, to keep the script with phase 12 well inside its time limit)
PRESET_RUNS = (
    ("map-hifi", 512, 15_000, 0.005, 0.99),
    ("sr", 8192, 150, 0.01, 0.99),
    ("map-pb", 512, 10_000, 0.02, 0.99),
    ("splice", 1024, 0, 0.01, 0.90),
)
N_CARD_VS_CPU = 16
N_HIFI_DEVICE = 256


def preset_data(preset: str, rng, genome: str, n: int, length: int,
                err: float):
    """(the genome to index, reads, origins) of one phase 9 preset."""
    from mappy_rs_tpu_torch.utils.simulate import (simulate,
                                                   simulate_hpc_noise,
                                                   spliced_genes)

    if preset == "splice":
        return spliced_genes(rng, genome, n, err)
    if preset == "map-pb":
        return (genome, *simulate_hpc_noise(rng, genome, n, length, err))
    return (genome, *simulate(rng, genome, n, length, err))


def preset_batch(eng, reads, L: int) -> tuple:
    """One real [B, L] batch of these reads at the shape the pipeline
    launches for the L bucket, staged as _fe_submit_batch stages it
    (HPC compression included) and uploaded; returns (inputs of
    front_end_bt, its keyword arguments, the anchors of the port's
    sketch and seed lookup on the card)."""
    import torch

    from mappy_rs_tpu_torch.ops.lookup import collect_anchors
    from mappy_rs_tpu_torch.ops.sketch import sketch_compact
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    B, M, A = eng.fe_shapes(L)
    sel = [encode(r) for r in reads if eng._bucket_len(len(r)) == L][:B]
    up = {n: torch.from_numpy(a).cuda()
          for n, a in eng.stage_batch(sel, L, B).items()}
    kw = eng._fe_kwargs(M, A, min(8, L // eng.SEG_LEN))
    mins = sketch_compact(up["codes"], up.get("sk_lens", up["lens"]), kw["k"],
                          kw["w"], M, force_inf=up.get("force_inf"),
                          pos_map=up.get("pos_map"), spans=up.get("spans"))
    an = collect_anchors(mins, up["lens"], eng.dev, kw["mid_occ"], A,
                         kw["k"], kw["q_occ_frac"], kw["occ_dist"],
                         kw["max_max_occ"])
    return up, kw, an


def preset_kernels(eng, an, kw, label: str) -> dict:
    """K1 and K2 == their plain versions on these anchors, then timed
    (eager, graph replay, plain) with their bounds."""
    import torch

    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops.chain import chain_scores

    prm, H = eng._chain_params, ck.window_of(kw["window"])
    K, cuts, mc, ms = kw["bt_k"], kw["bt_cuts"], kw["min_cnt"], kw["min_sc"]
    f, p = ck.chain_scores_kernel(an, prm, H)
    fr, pr = chain_scores(an, prm, H)
    o = bt.backtrack_chains(an, f, p, K, cuts, mc, ms)
    r = bt.backtrack_chains_plain(an, f, p, K, cuts, mc, ms)
    torch.cuda.synchronize()
    e1, e2 = max(max_err(f, fr), max_err(p, pr)), max_err(o, r)
    B, A = f.shape
    log(f"{label}: K1 on real anchors B={B} A={A} window={H} "
        f"is_splice={prm.is_splice} links={int((p >= 0).sum())} "
        f"max_abs_err={e1}; K2 K={K} cuts={cuts} "
        f"chains={int((o[:, :, 0] >= 0).sum())} max_abs_err={e2}")
    if e1 or e2:
        raise AssertionError(f"{label}: K1/K2 kernel != plain version")
    out = {}
    for name, kern, plain, bnd in (
        ("chain_dp", lambda: ck.chain_scores_kernel(an, prm, H),
         lambda: chain_scores(an, prm, H), lambda: k1_bound(an, H)),
        ("backtrack_chains", lambda: bt.backtrack_chains(an, f, p, K, cuts, mc, ms),
         lambda: bt.backtrack_chains_plain(an, f, p, K, cuts, mc, ms),
         lambda: k2_bound(an, f, p, K, cuts, ms)),
    ):
        k, pl = timed_pair(kern, plain, 20, 1, warm_plain=False)
        out[name] = {"ms": k, "graph_ms": graph_ms(kern, 20), "plain_ms": pl,
                     "shape": [B, A], "max_abs_err": 0, **bnd()}
        r = out[name]
        log(f"{label}: {name} at B={B} A={A}: kernel {k:.4f} ms per eager "
            f"call, {r['graph_ms']:.4f} ms on the device, plain {pl:.2f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


def phase_presets(genome: str) -> dict:
    import dataclasses

    import torch

    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.models.pipeline import (AlignmentEngine,
                                                    front_end_bt)
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb

    rng = np.random.default_rng(SEED + 9)
    results = {}
    for preset, n, length, err, need in PRESET_RUNS:
        t_preset = time.perf_counter()
        t0 = time.perf_counter()
        g, reads, starts = preset_data(preset, rng, genome, n, length, err)
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        al = mappy_rs_tpu_torch.Aligner(seq=g, preset=preset)  # device="cuda"
        eng = al._engine
        dev = eng.dev
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        if dev.hash_rows.device.type != "cuda":
            raise AssertionError(f"{preset}: index tensors on {dev.hash_rows.device}")
        log(f"{preset}: k={eng.index.k} w={eng.index.w} "
            f"hpc={bool(eng.index.flag & 1)} splice={eng.is_splice}; "
            f"{len(reads)} reads ({t_data:.1f} s to make); index built and "
            f"uploaded in {t_index:.1f} s, {dev.nbytes() / 1e6:.1f} MB of "
            f"tensors on the card, {dev.n_keys} keys, "
            f"{'two' if dev.two_word else 'one'}-word table")
        buckets = {}
        for r in reads:
            L = eng._bucket_len(len(r))
            buckets[L] = buckets.get(L, 0) + 1
        shapes = {}
        for L in sorted(buckets):
            B, M, A = eng.fe_shapes(L)
            fits = eng._chain_fits(A) and eng._bt_enabled(A)
            shapes[L] = {"reads": buckets[L], "B": B, "M": M, "A": A,
                         "kernels_fit": fits}
            if not fits:
                raise AssertionError(f"{preset}: A={A} outside K1/K2")
        log(f"{preset}: launched shapes by bucket L: {shapes}")

        # K1 and K2 on one real batch of the most common bucket
        L = max(buckets, key=lambda x: (buckets[x], x))
        up, kw, an = preset_batch(eng, reads, L)
        kern = preset_kernels(eng, an, kw, preset)
        fe_in = dict(up)
        codes_t, lens_t = fe_in.pop("codes"), fe_in.pop("lens")
        fe_ms = cuda_ms(lambda: front_end_bt(codes_t, lens_t, dev, **fe_in,
                                             **kw), 5)
        log(f"{preset}: front end {fe_ms:.3f} ms per [{kw['M']}-minimizer, "
            f"A={kw['A']}] batch of L={L} (CUDA events)")
        del up, an, fe_in, codes_t, lens_t

        # the preset's main path: enable_threading(4) + map_batch
        payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
        al.enable_threading(4)
        list(al.map_batch(payload[:64]))  # warm the path
        al.reset_metrics()
        ck.launches = 0
        bt.launches = 0
        t0 = time.perf_counter()
        placed = with_n = 0
        for mappings, data in al.map_batch(payload):
            prim = [m for m in mappings if m.is_primary]
            if not prim:
                continue
            first = min(prim, key=lambda m: m.target_start)
            ok = abs(first.target_start - starts[data["i"]]) < 100
            if preset == "splice":
                has_n = any(op == 3 for _, op in first.cigar)
                with_n += has_n
                ok = ok and has_n
            placed += ok
        wall = time.perf_counter() - t0
        launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
        al.enable_threading(0)
        m = al.metrics
        batches = m.get("fe_batches", 0)
        fe_thread_ms = 1e3 * m.get("time_front_end_s", 0.0) / max(batches, 1)
        hpc_calls = m.get("calls_hpc_stage", 0)
        hpc_ms = 1e3 * m.get("time_hpc_stage_s", 0.0) / max(hpc_calls, 1)
        log(f"{preset}: {len(reads)} reads in {wall:.3f} s = "
            f"{len(reads) / wall:.1f} reads/s (4 threads); placed {placed} "
            f"({100.0 * placed / len(reads):.2f}%"
            + (f"; with an N op {with_n}" if preset == "splice" else "")
            + f"); launches {launches}; {batches:.0f} front-end batches, "
            f"{fe_thread_ms:.1f} thread-ms of front end per batch (submit + "
            "collect)"
            + (f", HPC staging {hpc_ms:.2f} ms per batch ({hpc_calls:.0f} "
               "batches)" if hpc_calls else ""))
        log(f"{preset} engine metrics: " + json.dumps(
            {k: m[k] for k in sorted(m) if k.startswith(
                ("time_", "calls_", "fe_", "anchor_"))}))
        if placed < need * len(reads):
            raise AssertionError(f"{preset}: only {placed}/{len(reads)} placed")
        for name, c in launches.items():
            if c <= 0:
                raise AssertionError(f"{preset}: kernel {name} never launched")

        # the card == the CPU plain versions, on N_CARD_VS_CPU reads
        cpu = AlignmentEngine(eng.index, eng.opt,
                              dataclasses.replace(eng.cfg, device="cpu"))
        t0 = time.perf_counter()
        sel = reads[:N_CARD_VS_CPU]
        got = [al._to_mappings(r) for r in eng.map_batch(sel, cs=True)]
        want = [al._to_mappings(r) for r in cpu.map_batch(sel, cs=True)]
        n_diff = sum(1 for a, b in zip(got, want) if a != b)
        log(f"{preset}: {len(sel)} reads on the card vs the CPU plain "
            f"versions: {n_diff} differ ({time.perf_counter() - t0:.1f} s)")
        if n_diff:
            raise AssertionError(f"{preset}: {n_diff} reads differ card vs CPU")
        res = {"reads": len(reads), "wall_s": wall,
               "reads_per_s": len(reads) / wall, "placed": placed,
               "with_n": with_n, "launches": launches, "shapes": shapes,
               "kernels": kern, "fe_ms": fe_ms, "fe_bucket": L,
               "fe_thread_ms_per_batch": fe_thread_ms, "fe_batches": batches,
               "hpc_stage_ms_per_batch": hpc_ms if hpc_calls else None,
               "index_s": t_index, "index_bytes": dev.nbytes(),
               "index_keys": dev.n_keys, "card_vs_cpu_diff": n_diff}

        if preset == "map-hifi":
            # K3 + K4 at the hifi scoring: "device" == "host", cs and MD
            t0 = time.perf_counter()
            sel = reads[:N_HIFI_DEVICE]
            eng.cfg.extension_backend = "host"
            want = [al._to_mappings(r)
                    for r in eng.map_batch(sel, cs=True, md=True)]
            ek.launches = 0
            tb.launches = 0
            eng.cfg.extension_backend = "device"
            got = [al._to_mappings(r)
                   for r in eng.map_batch(sel, cs=True, md=True)]
            eng.cfg.extension_backend = "auto"
            ext_l = {"extend_dp": ek.launches, "traceback": tb.launches}
            n_diff = sum(1 for a, b in zip(got, want) if a != b)
            log(f"map-hifi: {len(sel)} reads, 'device' vs 'host' with cs "
                f"and MD: {n_diff} differ; launches {ext_l} "
                f"({time.perf_counter() - t0:.1f} s)")
            if n_diff:
                raise AssertionError(f"map-hifi: {n_diff} reads differ "
                                     "between 'device' and 'host'")
            if min(ext_l.values()) <= 0:
                raise AssertionError("map-hifi: K3/K4 never launched")
            res.update(device_vs_host_diff=n_diff, device_launches=ext_l)
        res["seconds"] = time.perf_counter() - t_preset
        log(f"{preset}: phase 9 part done in {res['seconds']:.1f} s")
        results[preset] = res
        del al, eng, dev, cpu
    return results

# -------------------------------------------------------------- phase 11
DEC_BATCH = 512    # reads per map_batch_positions call (a readfish batch)
N_DEC_CPU = 256    # decisions held against the port on CPU cells
N_MH_READS = 512   # reads of the two-process decision step
MH_TIMEOUT = 300   # seconds a two-process child may take


def mesh_run(al, reads, threaded: dict, label: str) -> dict:
    """Phase 4's reads through `al` (a grid set) with 4 threads."""
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck

    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    al.enable_threading(4)
    list(al.map_batch(payload[:512]))  # warm
    al.reset_metrics()
    ck.launches = 0
    bt.launches = 0
    t0 = time.perf_counter()
    out = {d["i"]: [mapping_fields(m) for m in ms]
           for ms, d in al.map_batch(payload)}
    wall = time.perf_counter() - t0
    launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
    al.enable_threading(0)
    n_diff = sum(1 for i in threaded if out.get(i) != threaded[i])
    host_bt = al.metrics.get("host_bt_batches", 0)
    rate = len(reads) / wall
    log(f"{label}: {len(reads)} reads in {wall:.3f} s = {rate:.1f} reads/s "
        f"(4 threads); {n_diff} reads differ from phase 4; launches "
        f"{launches}; host-backtrack batches {host_bt:.0f}")
    if n_diff:
        raise AssertionError(f"{label}: {n_diff} reads differ from phase 4")
    if launches["chain_dp"] <= 0 or launches["backtrack_chains"] != 0 \
            or host_bt <= 0:
        raise AssertionError(f"{label}: launches {launches}, host "
                             f"backtrack batches {host_bt}")
    return {"reads_per_s": rate, "wall_s": wall, "differ": n_diff,
            "launches": launches, "host_bt_batches": host_bt}


def phase_mesh(al, genome, reads, threaded: dict, rate4: float) -> dict:
    """11a: enable_mesh(2, n_index=2) and enable_mesh(4) on cuda:0 cells."""
    import torch

    import mappy_rs_tpu_torch

    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    al_s = mappy_rs_tpu_torch.Aligner(seq=genome)  # device="cuda"
    al_s.enable_mesh(2, n_index=2, devices=["cuda:0"] * 4)
    t_build = time.perf_counter() - t0
    shards = {id(t): t for a in al_s._engine._index_shards.values()
              for t in a.blocks.values()}
    shard_mb = sum(t.numel() * t.element_size() for t in shards.values()) / 1e6
    torch.cuda.synchronize()
    grown = (torch.cuda.memory_allocated() - alloc0) / 1e6
    replicated_mb = al._engine.dev.nbytes() / 1e6
    log(f"enable_mesh(2, n_index=2): index built and sharded in "
        f"{t_build:.1f} s; {len(shards)} shard tensors on the card, "
        f"{shard_mb:.1f} MB (the replicated tables: {replicated_mb:.1f} MB); "
        f"memory allocated on the card grew {grown:.1f} MB")
    sharded = mesh_run(al_s, reads, threaded, "enable_mesh(2, n_index=2)")
    if al_s._engine.index._devices:
        raise AssertionError("the sharded grid built the replicated tables: "
                             f"{list(al_s._engine.index._devices)}")
    del al_s, shards
    al.enable_mesh(4, devices=["cuda:0"] * 4)
    dp = mesh_run(al, reads, threaded, "enable_mesh(4)")
    log(f"phase 4's threads: {rate4:.1f} reads/s")
    return {"sharded": dict(sharded, shard_mb=shard_mb, card_mb_grown=grown,
                            build_s=t_build),
            "data_parallel": dp, "replicated_mb": replicated_mb}


def phase_decisions(al, reads, ends, rev) -> dict:
    """11b: decision mode over phase 4's reads on cuda:0 cells."""
    import torch

    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops.extend import BEST_COLS, extend_dp
    from mappy_rs_tpu_torch.parallel import mesh as pm

    al.enable_sharding(2, 2, devices=["cuda:0"] * 4)
    # the first batch uploads the shards; keep its K3 inputs
    captured = []
    k3 = pm.extend_dp_kernel
    pm.extend_dp_kernel = lambda *a: captured.append(a) or k3(*a)
    try:
        al.map_batch_positions(reads[:DEC_BATCH])
    finally:
        pm.extend_dp_kernel = k3
    torch.cuda.synchronize()
    ek.launches = 0
    t0 = time.perf_counter()
    dec = []
    for s in range(0, len(reads), DEC_BATCH):
        dec += al.map_batch_positions(reads[s:s + DEC_BATCH])
    wall = time.perf_counter() - t0
    launches = ek.launches
    right = sum(1 for d, e, rv in zip(dec, ends, rev)
                if d is not None and d["strand"] == (-1 if rv else 1)
                and abs(d["r_en"] - e) < 100)
    rate = len(reads) / wall
    log(f"decision mode: {len(reads)} reads in {wall:.3f} s = {rate:.1f} "
        f"decisions/s (batches of {DEC_BATCH}, grid 2 x 2); right strand "
        f"and end within 100 bp {right} ({100.0 * right / len(reads):.2f}%); "
        f"K3 launches {launches}")
    if right < 0.99 * len(reads) or launches <= 0:
        raise AssertionError(f"decision mode: {right} right, K3 {launches}")

    # K3 == plain at decision mode's shape, on the captured jobs
    q, t, ql, tl, W, params = captured[0]
    J, QMAX = q.shape
    TMAX = t.shape[1]
    S = QMAX + TMAX - 1
    got = ek.extend_dp_kernel(q, t, ql, tl, W, params)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = extend_dp(q, t, ql, tl, W, params)
    e1.record()
    torch.cuda.synchronize()
    err = max(max_err(got[k], want[k]) for k in ("dirs",) + BEST_COLS)
    k_ms = cuda_ms(lambda: ek.extend_dp_kernel(q, t, ql, tl, W, params), 20)
    g_ms = graph_ms(lambda: ek.extend_dp_kernel(q, t, ql, tl, W, params), 20)
    b = bound(J * (QMAX + TMAX) + 8 * J + S * J * W + 24 * J,
              band_cells(ql.cpu().numpy(), tl.cpu().numpy(), W, S)
              * OPS_PER_CELL_K3)
    shape = {"J": J, "QMAX": QMAX, "TMAX": TMAX, "W": W, "max_abs_err": err,
             "ms": k_ms, "graph_ms": g_ms, "plain_ms": e0.elapsed_time(e1),
             **b}
    log(f"K3 at decision mode's shape (J={J}, {QMAX}, {TMAX}, W={W}): "
        f"max_abs_err={err}; {k_ms:.4f} ms eager, {g_ms:.4f} ms on the "
        f"device (graph replay), plain "
        f"{shape['plain_ms']:.1f} ms, bound {b['bound_ms']:.5f} ms "
        f"({b['bound_by']})")
    if err != 0:
        raise AssertionError("K3 kernel != plain at decision mode's shape")

    # the card's decisions == the port's on a grid of CPU cells
    t0 = time.perf_counter()
    al.enable_sharding(2, 2, devices=["cpu"] * 4)
    cpu = al.map_batch_positions(reads[:N_DEC_CPU])
    n_diff = sum(1 for a, c in zip(dec[:N_DEC_CPU], cpu) if a != c)
    log(f"decision mode: {N_DEC_CPU} reads on CPU cells in "
        f"{time.perf_counter() - t0:.1f} s; {n_diff} differ from the card")
    if n_diff:
        raise AssertionError(f"decision mode: {n_diff} reads differ card vs CPU")
    return {"decisions_per_s": rate, "wall_s": wall, "right": right,
            "k3_launches": launches, "k3_decision_shape": shape,
            "cpu_differ": n_diff}


def run_decision_step(mesh, index, opt, codes, lens) -> dict:
    """map_batch_positions' step for codes' L bucket on `mesh`, on the
    shards of `index` placed there: the gathered results."""
    from mappy_rs_tpu_torch.ops.chain import ChainParams
    from mappy_rs_tpu_torch.ops.extend import ExtendParams
    from mappy_rs_tpu_torch.parallel.mesh import (P, build_sharded_map_step,
                                                  device_shards,
                                                  shard_index_by_key_range)
    from mappy_rs_tpu_torch.parallel.multihost import (gather_results,
                                                       put_global,
                                                       put_global_tree,
                                                       shard_specs_for_index)

    k, L = index.k, codes.shape[1]
    cp = ChainParams(
        max_dist_x=opt.max_gap_ref if opt.max_gap_ref >= 0 else opt.max_gap,
        max_dist_y=opt.max_gap, bw=opt.bw, q_span=k,
        chn_pen_gap=opt.chain_gap_scale * 0.01 * k,
        chn_pen_skip=opt.chain_skip_scale * 0.01 * k)
    ep = ExtendParams(a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2,
                      e2=opt.e2, sc_ambi=opt.sc_ambi)
    step = build_sharded_map_step(
        mesh, k, index.w, max_minimizers=max(64, L // 5),
        max_anchors=max(128, L // 4), chain_params=cp, ext_params=ep,
        mid_occ=opt.mid_occ, chain_window=32, ext_window=128)
    shards = put_global_tree(
        device_shards(shard_index_by_key_range(index, mesh.shape["index"])),
        mesh, shard_specs_for_index())
    return gather_results(step(put_global(codes, mesh, P("data", None)),
                               put_global(lens, mesh, P("data")), shards))


def _mh_child(rank: int, world: int, port: int, idx_dir: str, opt,
              batch_path: str, out_path: str) -> None:
    """One rank of 11c: a 2 x 2 grid of cuda:0 cells."""
    import torch

    from mappy_rs_tpu_torch.index.share import load_index_dir
    from mappy_rs_tpu_torch.parallel.multihost import (init_distributed,
                                                       make_global_mesh)

    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_global_mesh(2, devices=["cuda:0"] * 4)
    b = np.load(batch_path)
    res = run_decision_step(mesh, load_index_dir(idx_dir), opt,
                            b["codes"], b["lens"])
    if rank == 0:
        np.savez(out_path, **res)
    torch.distributed.destroy_process_group()
    print(f"[rank {rank}/{world}] rows {list(mesh.local_rows)} ok", flush=True)


def phase_two_processes(al, reads) -> dict:
    """11c: 2 ranks x (2 x 2) cuda:0 cells over Gloo == one 4 x 2 grid."""
    import multiprocessing as mp
    import socket
    import tempfile

    from mappy_rs_tpu_torch.index.share import save_index_dir
    from mappy_rs_tpu_torch.parallel.mesh import make_mesh
    from mappy_rs_tpu_torch.utils.seqcodes import encode

    L = 1024
    codes = np.full((N_MH_READS, L), 4, np.uint8)
    lens = np.zeros(N_MH_READS, np.int32)
    for i, r in enumerate(reads[:N_MH_READS]):
        c = encode(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    t0 = time.perf_counter()
    one = run_decision_step(make_mesh(4, 2, ["cuda:0"] * 8), al._index,
                            al._map_opt, codes, lens)
    t_one = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as d:
        idx_dir = os.path.join(d, "idx")
        batch_path = os.path.join(d, "batch.npz")
        out_path = os.path.join(d, "two.npz")
        save_index_dir(al._index, idx_dir)
        np.savez(batch_path, codes=codes, lens=lens)
        sock = socket.socket()
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mh_child, args=(
            r, 2, port, idx_dir, al._map_opt, batch_path, out_path))
            for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(MH_TIMEOUT)
        finally:
            hung = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        t_two = time.perf_counter() - t0
        exits = [p.exitcode for p in procs]
        if hung or any(c != 0 for c in exits):
            raise AssertionError(f"two-process run: exit codes {exits}, "
                                 f"killed after {MH_TIMEOUT} s: {hung}")
        two = dict(np.load(out_path))
    diff = sorted(k for k in set(one) | set(two)
                  if k not in one or k not in two
                  or not np.array_equal(one[k], two[k]))
    log(f"two processes (Gloo, 2 x (2 x 2) cuda:0 cells): {N_MH_READS} "
        f"reads in {t_two:.1f} s with start-up; one process (4 x 2): "
        f"{t_one:.1f} s; fields differing: {diff}")
    if diff:
        raise AssertionError(f"two-process results differ: {diff}")
    return {"reads": N_MH_READS, "two_process_s": t_two, "one_process_s": t_one,
            "differ": diff}


def phase_entry() -> dict:
    """11d: the top-level entry points on cuda:0: entry()'s forward step and
    dryrun_multichip(4) with every cell on cuda:0."""
    from mappy_rs_tpu_torch.entry import dryrun_multichip, entry

    t0 = time.perf_counter()
    fn, args = entry()
    f, _p, _rpos, _rev = fn(*args)
    if f.device.type != "cuda" or not bool((f.amax(dim=1) > 40).all()):
        raise AssertionError(f"entry(): chain scores {f.amax(dim=1)}")
    res = dryrun_multichip(4, devices=["cuda:0"] * 4)
    res["seconds"] = time.perf_counter() - t0
    log(f"entry() and dryrun_multichip(4) on cuda:0: {res['seconds']:.1f} s")
    return res


# -------------------------------------------------------------- phase 10
def card_pids() -> list:
    """PIDs of the processes holding a context on the card, one per
    process (where this process runs in another PID namespace than
    nvidia-smi sees, it prints other PIDs, e.g. 1 for every process)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [int(x) for x in res.stdout.split() if x.strip().isdigit()]


def phase_procs(al, reads, starts, threaded: dict, rate4: float) -> dict:
    """Phase 4's reads through worker_processes = 4 under each topology."""
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck

    import torch

    payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
    runs = {}
    for topology in ("device_owner", "classic"):
        al._config.worker_processes = 4
        al._config.topology = topology
        free0, total = torch.cuda.mem_get_info()
        t0 = time.perf_counter()
        al.enable_threading(4)
        if al._procs is None:
            raise AssertionError(f"{topology}: worker processes did not start")
        t_start = time.perf_counter() - t0
        t0 = time.perf_counter()
        al.warmup(reads[:512])  # each child's first chunk (classic: upload)
        t_warm = time.perf_counter() - t0
        al.reset_metrics()
        ck.launches = 0
        bt.launches = 0
        t0 = time.perf_counter()
        out = {d["i"]: [mapping_fields(m) for m in ms]
               for ms, d in al.map_batch(payload)}
        wall = time.perf_counter() - t0
        launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
        m = al.metrics
        children = al._procs.pids
        on_card = card_pids()
        grown = (free0 - torch.cuda.mem_get_info()[0]) / 1e6
        al.enable_threading(0)
        n_diff = sum(1 for i in threaded if out.get(i) != threaded[i])
        placed = sum(1 for i, s in enumerate(starts)
                     if out[i] and abs(out[i][0][5] - s) < 100)
        if os.getpid() in on_card:
            held = [p for p in children if p in on_card]
            how = "by PID"
        else:
            # PIDs of another namespace: nvidia-smi lists one line per
            # process with a context, this process's among them
            held = children[: len(on_card) - 1]
            how = (f"by count: nvidia-smi's PIDs {on_card} are not this "
                   f"namespace's ({os.getpid()}), one per process")
        rate = len(reads) / wall
        log(f"{topology}: 4 processes started in {t_start:.1f} s, warmed in "
            f"{t_warm:.1f} s; {len(reads)} reads in {wall:.3f} s = "
            f"{rate:.1f} reads/s (4 proxies; phase 4's threads "
            f"{rate4:.1f}; os.cpu_count() {os.cpu_count()}); {n_diff} "
            f"reads differ from phase 4's threads; within 100 bp {placed} "
            f"({100.0 * placed / len(reads):.2f}%); this process's K1/K2 "
            f"launches {launches}; compute apps on the card {on_card} "
            f"(this process {os.getpid()}, children {children}): children "
            f"holding the card {len(held)}, {how}; device memory in use "
            f"grew {grown:.1f} MB; front-end batches "
            f"{m.get('fe_batches', 0):.0f}")
        log(f"{topology} metrics (summed over the processes): " + json.dumps(
            {k: m[k] for k in sorted(m) if k.startswith(
                ("time_", "calls_", "fe_", "anchor_", "worker_"))}))
        if n_diff:
            raise AssertionError(f"{topology}: {n_diff} reads differ from threads")
        if placed < 0.99 * len(reads):
            raise AssertionError(f"{topology}: only {placed} reads placed")
        if topology == "device_owner":
            if held or not on_card:
                raise AssertionError(
                    f"device_owner: compute apps {on_card}, this process "
                    f"{os.getpid()}, children {children}")
            if min(launches.values()) <= 0:
                raise AssertionError("device_owner: K1/K2 never launched "
                                     "in the parent")
        elif (len(held) != len(children) or len(on_card) != len(children) + 1
              or m.get("fe_batches", 0) <= 0):
            raise AssertionError(f"classic: children {children}, compute "
                                 f"apps {on_card}, front-end batches "
                                 f"{m.get('fe_batches', 0)}")
        runs[topology] = {"reads_per_s": rate, "wall_s": wall,
                          "start_s": t_start, "warmup_s": t_warm,
                          "placed": placed, "differ": n_diff,
                          "launches": launches, "children": children,
                          "compute_apps": on_card, "children_on_card":
                          len(held), "card_mb_grown": grown,
                          "fe_batches": m.get("fe_batches", 0)}
    al._config.worker_processes = 0
    al._config.topology = "classic"
    return runs


def phase_host_backtrack(al, reads, threaded: dict, long_sel,
                         long_got) -> dict:
    """K2 refused at every A: K1 and the host backtrack, == the K2 path."""
    from mappy_rs_tpu_torch.models import pipeline
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck

    eng = al._engine
    fits = pipeline.backtrack_fits
    pipeline.backtrack_fits = lambda A: False
    try:
        res = {}
        for name, sel, want in (
            ("phase 4", reads[:256], [threaded[i] for i in range(256)]),
            ("phase 8", long_sel, [[mapping_fields(m) for m in ms]
                                   for ms in long_got]),
        ):
            eng.metrics.reset()
            ck.launches = 0
            bt.launches = 0
            t0 = time.perf_counter()
            got = [[mapping_fields(m) for m in al._to_mappings(r)]
                   for r in eng.map_batch(sel, cs=True)]
            wall = time.perf_counter() - t0
            launches = {"chain_dp": ck.launches,
                        "backtrack_chains": bt.launches}
            n_diff = sum(1 for a, b in zip(got, want) if a != b)
            host_bt = eng.metrics.snapshot().get("host_bt_batches", 0)
            log(f"host backtrack, {name}: {len(sel)} reads, {n_diff} differ "
                f"from the K2 path; launches {launches}; {host_bt:.0f} "
                f"host-backtrack batches; {wall:.1f} s")
            if n_diff or launches["chain_dp"] <= 0 or \
                    launches["backtrack_chains"] != 0 or host_bt <= 0:
                raise AssertionError(f"host backtrack, {name}: {n_diff} "
                                     f"differ, launches {launches}")
            res[name] = {"reads": len(sel), "differ": n_diff,
                         "launches": launches, "wall_s": wall}
    finally:
        pipeline.backtrack_fits = fits
    return res


# -------------------------------------------------------------- phase 12
GBP_CONTIGS = 23   # contigs of 2^27 bp: 3.09 Gbp, the hg38-like genome model
GBP_PROCS = 3      # "device_owner" post-chain children
GBP_READS = 8000   # reads per timed pass
GBP_PASSES = 2
GBP_WARM = 256
N_GBP_CPU = 32     # unique-origin reads held card vs CPU


def check_build_card_vs_cpu() -> dict:
    """The index build's sort and device tables on the card == the CPU
    build's, array for array, at k = 15 (one-word table) and k = 19 (two
    words), on 3 contigs of 2^20 bp of the genome model (repeat-rich:
    many positions per key)."""
    import torch

    from mappy_rs_tpu_torch.config import IndexOptions
    from mappy_rs_tpu_torch.index.build import build_index
    from mappy_rs_tpu_torch.tools import gbp_chip as gc

    model = gc.GenomeModel(n_contig=3, contig_bits=20)
    buf, _, _ = gc.build_genome(np.random.default_rng(gc.SEED), model)
    C = model.contig
    seqs = [(f"ctg{i:02d}", buf[i * C: (i + 1) * C])
            for i in range(model.n_contig)]
    out = {}
    for k, w in ((15, 10), (19, 19)):
        c = build_index(seqs, IndexOptions(k=k, w=w), device="cpu")
        g = build_index(seqs, IndexOptions(k=k, w=w), device="cuda")
        for name in ("keys", "key_offsets", "positions"):
            if not np.array_equal(getattr(g, name), getattr(c, name)):
                raise AssertionError(f"card build, k = {k}: {name} != the "
                                     "CPU build's")
        dc, dg = c.device_index("cpu"), g.device_index("cuda")
        for name in ("offcnt", "pos_rp", "hash_rows", "hash_val"):
            if not torch.equal(getattr(dg, name).cpu(), getattr(dc, name)):
                raise AssertionError(f"card tables, k = {k}: {name} != the "
                                     "CPU build's")
        if ((dg.n_keys, dg.hash_bits, dg.hash_shift, dg.two_word)
                != (dc.n_keys, dc.hash_bits, dc.hash_shift, dc.two_word)):
            raise AssertionError(f"card tables, k = {k}: sizes differ")
        per_key = np.diff(c.key_offsets.astype(np.int64))
        out[f"k{k}"] = {"positions": len(c.positions), "keys": len(c.keys),
                        "keys_with_repeats": int((per_key > 1).sum()),
                        "max_per_key": int(per_key.max())}
    log(f"genome scale: card build == CPU build, array for array: {out}")
    return out


def check_sorted_on_card(index) -> None:
    """O(n) on the card over the host index the card sorted: keys and
    offsets strictly increase, offsets run from 0 to m, and (key, y)
    strictly increases across all m positions, so each key's positions
    are in y order (the stable sort's order) and no position is
    doubled."""
    import torch

    from mappy_rs_tpu_torch.index.index import host_int64

    m = len(index.positions)
    keys = host_int64(index.keys, "cuda")
    off = host_int64(index.key_offsets, "cuda")
    if len(off) != len(keys) + 1 or int(off[0]) != 0 or int(off[-1]) != m:
        raise AssertionError(f"offsets run {int(off[0])}..{int(off[-1])} "
                             f"over {len(keys)} keys, m = {m}")
    if not bool((keys[1:] > keys[:-1]).all()):
        raise AssertionError("keys do not strictly increase")
    counts = off[1:] - off[:-1]
    del off
    if not bool((counts > 0).all()):
        raise AssertionError("a key holds no position")
    key_of = torch.repeat_interleave(keys, counts, output_size=m)
    del keys, counts
    y = host_int64(index.positions, "cuda")
    ok = (key_of[1:] > key_of[:-1]) | ((key_of[1:] == key_of[:-1])
                                       & (y[1:] > y[:-1]))
    n_bad = int((~ok).sum())
    del key_of, y, ok
    torch.cuda.empty_cache()
    if n_bad:
        raise AssertionError(f"(key, y) does not increase at {n_bad} of "
                             f"{m} positions")


def phase_genome_scale(n_contig: int = GBP_CONTIGS) -> dict:
    """12: map against a human-genome-scale index on the card: the run of
    mappy_rs_tpu_torch/tools/gbp_chip.py, built fresh (no cache)."""
    import torch

    from mappy_rs_tpu_torch.api import Aligner
    from mappy_rs_tpu_torch.index.index import DeviceIndex
    from mappy_rs_tpu_torch.tools import gbp_chip as gc
    from mappy_rs_tpu_torch.tools import hbm_budget

    t_phase = time.perf_counter()
    build_check = check_build_card_vs_cpu()
    torch.cuda.empty_cache()
    # (e) is the run's preflight: it raises, naming the shortfall, unless
    # the host RAM, free temporary space and card memory are there
    r = gc.run(gc.GenomeModel(n_contig=n_contig), procs=GBP_PROCS,
               n_reads=GBP_READS, n_passes=GBP_PASSES, device="cuda",
               n_warm=GBP_WARM)
    rec = r.record
    rec["build_card_vs_cpu"] = build_check
    t0 = time.perf_counter()
    check_sorted_on_card(r.build.index)
    log(f"genome scale: (key, y) strictly increases over the card-sorted "
        f"index ({time.perf_counter() - t0:.1f} s)")
    pre = rec["preflight"]
    log(f"genome scale: {n_contig} x 2^{rec['genome_model']['contig_bits']} "
        f"bp = {rec['genome_bp'] / 1e9:.3f} "
        f"Gbp; needs (GB) "
        f"{ {k: round(v / 1e9, 2) for k, v in pre['need'].items()} }, "
        f"there (GB) { {k: round(v / 1e9, 2) for k, v in pre['have'].items()} }")
    index, al = r.build.index, r.al
    dev = al._engine.dev
    # (a) every device table on the card, at hbm_budget's count
    for name in ("offcnt", "pos_rp", "hash_rows", "hash_val"):
        t = getattr(dev, name)
        if t.device.type != "cuda":
            raise AssertionError(f"index tensor {name} is on {t.device}")
    m = rec["positions"]
    want = hbm_budget.count(dev.n_keys, m, dev.hash_bits, dev.two_word)
    log(f"genome scale: {m} positions, {dev.n_keys} keys (ratio "
        f"{rec['key_ratio']:.4f}), T = 2^{dev.hash_bits}; device index "
        f"{ {k: round(v / 1e9, 3) for k, v in rec['device_index_bytes'].items()} }"
        f" GB; build seconds "
        f"{ {k: round(v, 1) for k, v in rec['build_s'].items()} }; reads "
        f"sampled in {rec['sample_reads_s']:.1f} s, spawn "
        f"{rec['spawn_s']:.1f} s, warm-up {rec['warmup_s']:.1f} s; card peak "
        f"allocated {rec['card_peak_allocated'] / 1e9:.2f} GB")
    if rec["device_index_bytes"] != want:
        raise AssertionError(f"device index bytes {rec['device_index_bytes']}"
                             f" != hbm_budget {want}")
    count = rec["counters"]
    log(f"genome scale: {[round(x, 1) for x in rec['reads_per_s']]} reads/s "
        f"({GBP_PROCS} children, {2 * GBP_PROCS} proxies); unique-origin "
        f"{rec['unique_placed']}/{rec['unique']} placed, overall "
        f"{rec['placed']}/{rec['reads']}; front end "
        f"{rec['ms_per_batch_pipelined']:.3f} ms per batch pipelined; "
        f"counters {count}")
    # (b) K1 and K2 in this process during the passes
    if count["chain_dp"] <= 0 or count["backtrack_chains"] <= 0:
        raise AssertionError(f"genome scale: K1/K2 launches {count}")
    # (c) unique-origin reads placed
    if rec["unique_placed"] < 0.99 * rec["unique"]:
        raise AssertionError(f"genome scale: {rec['unique_placed']}/"
                             f"{rec['unique']} unique-origin reads placed")
    # (d) the card engine == a CPU engine (the plain K1 / K2) on the same
    # index: the card's tables copied to the host
    t0 = time.perf_counter()
    index._devices["cpu"] = DeviceIndex(
        offcnt=dev.offcnt.cpu(), pos_rp=dev.pos_rp.cpu(),
        hash_rows=dev.hash_rows.cpu(), hash_val=dev.hash_val.cpu(),
        n_keys=dev.n_keys, hash_bits=dev.hash_bits,
        hash_shift=dev.hash_shift)
    cpu_al = Aligner._from_index(index, gc.PRESET, "cpu")
    sel = [i for i in range(rec["reads"]) if r.unique[i]][:N_GBP_CPU]
    n_diff = 0
    for i in sel:
        a = [mapping_fields(x) for x in al.map(r.reads[i], cs=True, MD=True)]
        c = [mapping_fields(x)
             for x in cpu_al.map(r.reads[i], cs=True, MD=True)]
        n_diff += a != c
    del index._devices["cpu"], cpu_al
    log(f"genome scale: {len(sel)} unique-origin reads, {n_diff} differ "
        f"card vs CPU ({time.perf_counter() - t0:.1f} s)")
    if n_diff or len(sel) < N_GBP_CPU:
        raise AssertionError(f"genome scale: {n_diff} of {len(sel)} reads "
                             "differ card vs CPU")
    rec["card_vs_cpu_differ"] = n_diff
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 12: {rec['phase_seconds']:.1f} s")
    return rec


# -------------------------------------------------------------- phase 13
N_CONCORDANCE = 1000  # CONCORDANCE.md's N
TRACE_REPLAYS = 20
HIFI_TRACE = (15_000, 0.005)  # map-hifi reads of the [8, 32,768] bucket
RARE_BACKENDS = ("host", "device", "device_dl")


def phase_concordance() -> dict:
    """13a: the port's concordance sweep on the card, with the bars of
    tests/test_concordance.py; K1 and K2 must launch for every preset."""
    from mappy_rs_tpu_torch.ops import backtrack as bt
    from mappy_rs_tpu_torch.ops import chain_kernel as ck
    from mappy_rs_tpu_torch.tools.concordance import (PRESET_WORKLOADS,
                                                      run_preset)

    out = {}
    n = N_CONCORDANCE
    for preset in PRESET_WORKLOADS:
        ck.launches = 0
        bt.launches = 0
        t0 = time.perf_counter()
        s = run_preset(preset, n, device="cuda")
        launches = {"chain_dp": ck.launches, "backtrack_chains": bt.launches}
        diffs = s.pop("diffs")
        s.update(launches=launches, seconds=time.perf_counter() - t0)
        log(f"concordance {preset}: N={n} both mapped {s['both_mapped']}, "
            f"one side only {s['one_side_only']}, coords eq {s['coords']} "
            f"({s['coords_pct']:.1f}%), full tuple eq {s['full']} "
            f"({s['full_pct']:.1f}%); launches {launches}; "
            f"{s['seconds']:.1f} s")
        if diffs:
            log(f"  first diff: {diffs[0]}")
        if not (s["both_mapped"] >= 0.93 * n and s["one_side_only"] <= 0.02 * n
                and s["full"] >= 0.95 * s["both_mapped"]
                and s["coords"] >= 0.98 * s["both_mapped"]):
            raise AssertionError(f"concordance {preset} below its bars: {s}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"concordance {preset}: launches {launches}")
        out[preset] = s
    return out


def rare_constructions() -> list:
    """(label, preset, extra_flags, genome, reads) of the rare-path reads
    of tests/test_torch_rare_paths.py and test_torch_rare_reads.py."""
    from mappy_rs_tpu_torch.config import MM_F_RMQ
    from mappy_rs_tpu_torch.utils import simulate as sim

    g, r = sim.inversion_case("inversion")
    jg, jr = sim.inversion_case("junk")
    out = [("inversion", "map-ont", None, g, [r]),
           ("inversion_rc", "map-ont", None, g, [sim.revcomp(r)]),
           ("junk_gap", "map-ont", None, jg, [jr])]
    for name in sim.ZDROP_CASES:
        out.append((f"zdrop_{name}", "map-ont", None, *sim.zdrop_case(name)))
    for preset, flags, case in (("asm5", None, "deletion"),
                                ("asm5", None, "insertion"),
                                ("map-ont", None, "deletion"),
                                ("map-ont", MM_F_RMQ, "deletion"),
                                ("asm5", None, "junk")):
        g, r = sim.rmq_case(case)
        tag = "+MM_F_RMQ" if flags else ""
        out.append((f"rmq_{preset}{tag}_{case}", preset, flags, g, [r]))
    out.append(("fallback_batch", "map-ont", None, *sim.fallback_batch()))
    return out


def rare_map(genome, reads, preset, flags, backend: str, device: str):
    """The reads in one engine batch (cs and MD): their Mapping fields,
    the rare-path counters, and the K3 / K4 launches (with K3's shapes)
    made inside the zdrop split rounds, which extend the remainders."""
    import collections

    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.ops import extend_kernel as ek
    from mappy_rs_tpu_torch.ops import traceback as tb

    al = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset,
                                    extra_flags=flags, device=device)
    eng = al._engine
    eng.cfg.extension_backend = backend
    split = {"extend_dp": 0, "traceback": 0, "shapes": collections.Counter()}
    rounds = eng._run_split_rounds

    def counted(read_regions, codes):
        k3, k4, shapes = ek.launches, tb.launches, collections.Counter(ek.shapes)
        rounds(read_regions, codes)
        split["extend_dp"] += ek.launches - k3
        split["traceback"] += tb.launches - k4
        split["shapes"] += ek.shapes - shapes

    eng._run_split_rounds = counted
    regs = eng.map_batch(reads, cs=True, md=True)
    c = eng.metrics.counters
    return ([[mapping_fields(m) for m in al._to_mappings(r)] for r in regs],
            {k: c.get(k, 0.0) for k in ("zdrop_splits", "inv_rescues")},
            split)


def _one_thread() -> None:
    import torch

    torch.set_num_threads(1)


def submit_rare_cpu(pool, cases) -> dict:
    """The CPU side of 13b in `pool`, futures by (label, backend): the
    CPU plain K3 / K4 take tens of seconds on a 12-14 kb RMQ read, so
    they run in worker processes beside the card's work, longest first."""
    order = sorted(((len(max(c[4], key=len)), c, b) for c in cases
                    for b in RARE_BACKENDS), key=lambda x: -x[0])
    return {(c[0], b): pool.submit(rare_map, c[3], c[4], c[1], c[2], b, "cpu")
            for _, c, b in order}


def phase_rare_paths(cases, cpu_futures) -> dict:
    """13b: the rare-path reads through a card Aligner and a CPU Aligner
    under each extension backend: equal Mappings and counters; under
    "device" K3 and K4 launch on the split remainders; the inversion
    read splits once and is rescued once, except under "device_dl",
    which splits nothing (as the JAX package)."""
    import collections

    t0 = time.perf_counter()
    out = {}
    split_total = {"extend_dp": 0, "traceback": 0,
                   "shapes": collections.Counter()}
    for label, preset, flags, genome, reads in cases:
        for backend in RARE_BACKENDS:
            t1 = time.perf_counter()
            card, c_card, split = rare_map(genome, reads, preset, flags,
                                           backend, "cuda")
            t_card = time.perf_counter() - t1
            cpu, c_cpu, _ = cpu_futures[(label, backend)].result()
            n_diff = sum(a != b for a, b in zip(card, cpu))
            hits = sum(len(ms) for ms in card)
            log(f"rare {label} [{backend}]: {len(reads)} reads, {hits} hits, "
                f"{n_diff} differ card vs CPU; card {c_card}, CPU {c_cpu}; "
                f"in split rounds K3 {split['extend_dp']}, K4 "
                f"{split['traceback']}, K3 shapes {dict(split['shapes'])}; "
                f"card {t_card:.2f} s")
            if n_diff or len(card) != len(cpu) or c_card != c_cpu:
                raise AssertionError(f"rare {label} [{backend}]: card != CPU")
            if label.startswith("inversion"):
                want = ({"zdrop_splits": 0.0, "inv_rescues": 0.0}
                        if backend == "device_dl" else
                        {"zdrop_splits": 1.0, "inv_rescues": 1.0})
                if c_card != want:
                    raise AssertionError(f"rare {label} [{backend}]: {c_card}")
                if backend == "device" and not (split["extend_dp"] > 0
                                                and split["traceback"] > 0):
                    raise AssertionError(
                        f"rare {label}: K3 / K4 did not launch on the split "
                        f"remainders: {split}")
            if backend == "device":
                for k in ("extend_dp", "traceback", "shapes"):
                    split_total[k] += split[k]
            out[f"{label}/{backend}"] = {"hits": hits, "counters": c_card,
                                         "split_k3": split["extend_dp"],
                                         "split_k4": split["traceback"],
                                         "card_s": t_card}
    split_total["shapes"] = {"x".join(map(str, k)): v
                             for k, v in split_total["shapes"].items()}
    seconds = time.perf_counter() - t0
    log(f"rare paths: every case card == CPU under {RARE_BACKENDS}; under "
        f"\"device\" the split rounds launched K3 {split_total['extend_dp']} "
        f"and K4 {split_total['traceback']} times, K3 shapes (QMAX x TMAX x "
        f"W x J) {split_total['shapes']}; {seconds:.1f} s")
    return {"cases": out, "device_split_launches": split_total,
            "seconds": seconds}


def phase_13(genome: str, reads) -> dict:
    """Phase 13: the concordance sweep and the rare paths (their CPU side
    in 6 worker processes meanwhile), then the trace."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    cases = rare_constructions()
    with ProcessPoolExecutor(6, multiprocessing.get_context("spawn"),
                             initializer=_one_thread) as pool:
        futures = submit_rare_cpu(pool, cases)
        rec = {"concordance": phase_concordance(),
               "rare_paths": phase_rare_paths(cases, futures)}
    rec["trace"] = phase_trace(genome, reads)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {rec['seconds']:.1f} s")
    return rec


def phase_trace(genome: str, reads) -> dict:
    """13c: tools/trace_front_end.py on the card: a fresh map-ont Aligner
    of phase 4's genome at [256, 1024] (phase 11 left grids on phase 4's
    Aligner) and a map-hifi one at [8, 32,768]; where the profiler saw
    device events, K1's and K2's kernels must be among them."""
    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.tools import trace_front_end as tfe
    from mappy_rs_tpu_torch.utils.simulate import simulate

    hifi_len, hifi_err = HIFI_TRACE
    hifi_reads, _ = simulate(np.random.default_rng(SEED + 13), genome, 8,
                             hifi_len, hifi_err)
    out = {}
    for name, preset, rs in (("map-ont", "map-ont", reads[:512]),
                             ("map-hifi", "map-hifi", hifi_reads)):
        al = mappy_rs_tpu_torch.Aligner(seq=genome, preset=preset)
        rec = tfe.run(preset, TRACE_REPLAYS, al=al, reads=rs)
        tfe.report(rec)
        if rec["profiler_device_events"]:
            names = rec["op_names"]
            for kern in ("chain_dp_kernel", "backtrack_kernel"):
                if not any(kern in n for n in names):
                    raise AssertionError(f"trace {name}: no {kern} among "
                                         f"the device ops {names}")
        if rec["event_ms_per_batch"] is None or rec["event_ms_per_batch"] <= 0:
            raise AssertionError(f"trace {name}: no CUDA-event time: {rec}")
        out[name] = rec
    return out


# -------------------------------------------------------------- phase 14
MEMORY_CYCLES = 50
MEMORY_TIMEOUT = 300  # seconds the soak's process may take


def phase_bench() -> dict:
    """14a: tools/bench.py at its full workload on the card, the CPU
    baseline measured on this host; raises unless every pass places >=
    99% within 100 bp, K1 and K2 launched in this process during the
    passes, and the baseline's children opened no context on the card."""
    from mappy_rs_tpu_torch.tools import bench

    t0 = time.perf_counter()
    rec = bench.run(device="cuda")
    bench.report(rec)  # the JSON line on stdout, bench.py's lines on stderr
    launches = rec["run"]["launches"]
    base = rec["baseline"]
    placed = [p["placed"] for p in rec["passes"]]
    rec["phase_s"] = time.perf_counter() - t0
    log(f"bench: median {rec['line']['median']} reads/s over "
        f"{len(placed)} passes of {rec['n_reads']} "
        f"({rec['line']['passes']}), vs_baseline "
        f"{rec['line']['vs_baseline']} (baseline {base['value']} reads/s on "
        f"{base['n_cores']} cores, modes {base['modes']}); placed per pass "
        f"{placed}; this process's launches during the passes "
        f"{launches}; compute apps on the card before the baseline "
        f"{base['compute_apps_before']}, while its children ran "
        f"{base['compute_apps_during']}; {rec['phase_s']:.1f} s")
    if min(placed) < 0.99 * rec["n_reads"]:
        raise AssertionError(f"bench: placed per pass {placed}")
    if launches["chain_dp"] <= 0 or launches["backtrack_chains"] <= 0:
        raise AssertionError(f"bench: K1/K2 launches {launches}")
    if base["children_on_card"] != 0:
        raise AssertionError(
            f"bench: the baseline's children held the card: apps "
            f"{base['compute_apps_before']} -> {base['compute_apps_during']}")
    if not rec["line"]["card"]:
        raise AssertionError(f"bench: no card line: {rec['line']}")
    return rec


def phase_thread_bench() -> dict:
    """14b: tools/thread_bench.py at its defaults on the card: four rows,
    equal mapped counts, >= 99% of the reads mapped."""
    from mappy_rs_tpu_torch.tools import thread_bench

    t0 = time.perf_counter()
    rec = thread_bench.run()
    thread_bench.report(rec)
    mapped = {n for _name, _dt, n in rec["rows"]}
    rec["phase_s"] = time.perf_counter() - t0
    log(f"thread_bench: {rec['phase_s']:.1f} s")
    if len(rec["rows"]) != 4 or len(mapped) != 1 or \
            min(mapped) < 0.99 * rec["n_reads"]:
        raise AssertionError(f"thread_bench: rows {rec['rows']}")
    return rec


def phase_memory() -> dict:
    """14c: tools/memory.py --threaded on the card in its own process:
    exit 0, its resident set and card memory (allocated, reserved) each
    grown <= 200 MB after the warm-up (its peak RSS is this process's,
    which Linux hands on across fork and exec, so it cannot grow)."""
    t0 = time.perf_counter()
    out = os.path.abspath(os.path.join("chiprun_out", "memory.json"))
    res = subprocess.run(
        [sys.executable, "-m", "mappy_rs_tpu_torch.tools.memory",
         "--threaded", f"--cycles={MEMORY_CYCLES}", "--device=cuda",
         f"--out={out}"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=MEMORY_TIMEOUT)
    log(res.stdout.rstrip())
    if res.returncode != 0:
        raise AssertionError(f"memory soak exit {res.returncode}: "
                             f"{res.stderr[-4000:]}")
    with open(out) as fh:
        rec = json.load(fh)
    g = rec["cuda_growth_mb"]
    if (g is None or rec["rss_growth_mb"] is None or rec["failed"]
            or max(rec["rss_growth_mb"], rec["max_rss_growth_mb"],
                   *g.values()) > 200):
        raise AssertionError(f"memory soak: {rec}")
    rec["phase_s"] = time.perf_counter() - t0
    log(f"memory soak: {MEMORY_CYCLES} threaded cycles, RSS grew "
        f"{rec['rss_growth_mb']:.1f} MB (peak RSS "
        f"{rec['max_rss_growth_mb']:.1f} MB: inherited from this process, "
        f"so blind here), card allocated "
        f"{g['allocated']:.1f} MB, reserved {g['reserved']:.1f} MB after "
        f"cycle 2; {rec['phase_s']:.1f} s")
    return rec


def phase_microbench() -> dict:
    """14d: tools/microbench.py on the card: every time and rate > 0."""
    from mappy_rs_tpu_torch.tools import microbench

    t0 = time.perf_counter()
    rec = microbench.run("cuda")
    fe = rec["front_end"]
    values = [rec["dispatch_ms"]["med"], rec["upload_4096kb"]["mb_per_s"],
              fe["compute_only_ms"]["med"], fe["compute_download_ms"]["med"]]
    values += [r["mb_per_s"] for row in rec["download"].values()
               for r in row.values()]
    rec["phase_s"] = time.perf_counter() - t0
    log(f"microbench: {rec['phase_s']:.1f} s")
    if not all(np.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"microbench: {rec}")
    return rec


def phase_14() -> dict:
    """Phase 14: the measurement tools on the card."""
    t0 = time.perf_counter()
    rec = {"bench": phase_bench(), "thread_bench": phase_thread_bench(),
           "memory": phase_memory(), "microbench": phase_microbench()}
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 14: {rec['seconds']:.1f} s (bench "
        f"{rec['bench']['phase_s']:.1f}, thread_bench "
        f"{rec['thread_bench']['phase_s']:.1f}, memory "
        f"{rec['memory']['phase_s']:.1f}, microbench "
        f"{rec['microbench']['phase_s']:.1f})")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import mappy_rs_tpu_torch
    from mappy_rs_tpu_torch.utils.simulate import (random_genome,
                                                   simulate_with_truth)

    t_start = time.perf_counter()
    info = phase_build()

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    genome = random_genome(rng, GENOME_LEN)
    reads, starts, ends, rev = simulate_with_truth(rng, genome, N_READS,
                                                   READ_LEN, ERR)
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
    long_reads = phase_long_reads(al, genome)
    launches = dict(sl["launches"], **ext["device"]["launches"])
    t0 = time.perf_counter()
    presets = phase_presets(genome)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    procs = phase_procs(al, reads, starts, sl["out"], sl["reads_per_s"])
    host_bt = phase_host_backtrack(al, reads, sl["out"],
                                   long_reads.pop("sel"),
                                   long_reads.pop("got"))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multi = {"mesh": phase_mesh(al, genome, reads, sl.pop("out"),
                                sl["reads_per_s"]),
             "decisions": phase_decisions(al, reads, ends, rev),
             "two_processes": phase_two_processes(al, reads),
             "entry": phase_entry()}
    multi["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {multi['seconds']:.1f} s")
    gbp = phase_genome_scale()
    p13 = phase_13(genome, reads)
    p14 = phase_14()
    # the main path's launches include phase 11's (K1 under both grids,
    # K3 in decision mode; K2 and K4 do not run there), phase 12's, and
    # phase 13's (K1 / K2 in the concordance sweep, K3 / K4 on the
    # zdrop-split remainders under "device")
    launches["chain_dp"] += sum(multi["mesh"][g]["launches"]["chain_dp"]
                                for g in ("sharded", "data_parallel"))
    launches["extend_dp"] += multi["decisions"]["k3_launches"]
    for name in ("chain_dp", "backtrack_chains"):
        launches[name] += gbp["counters"][name]
        launches[name] += sum(c["launches"][name]
                              for c in p13["concordance"].values())
    # and phase 14's (K1 / K2 in the parent during the bench's passes)
    for name in ("chain_dp", "backtrack_chains"):
        launches[name] += p14["bench"]["run"]["launches"][name]
    split = p13["rare_paths"]["device_split_launches"]
    launches["extend_dp"] += split["extend_dp"]
    launches["traceback"] += split["traceback"]

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
            # the device time alone (CUDA-graph replay)
            "graph_ms": k["graph_ms"],
        })
    record = {"card": info["card"], "kernels": kernels,
              "reads_per_s": sl["reads_per_s"], "front_end_ms": sl["fe_ms"],
              "placed": sl["placed"], "n_reads": N_READS,
              "extension_backends": ext, "long_reads": long_reads,
              "long_kernels": {n: kern[n].get("long") for n in
                               ("chain_dp", "backtrack_chains")},
              "ext_real_shapes": {n: kern[n].get("real") for n in
                                  ("extend_dp", "traceback")},
              "splice_sweep": kern["chain_dp"].get("splice_sweep"),
              "presets": presets,
              "front_end_probes": sl["probes"],
              "process_runtime": procs, "host_backtrack": host_bt,
              "multi_device": multi, "genome_scale": gbp,
              "concordance": p13["concordance"],
              "rare_paths": p13["rare_paths"],
              "trace": {k: {n: v for n, v in r.items() if n != "op_names"}
                        for k, r in p13["trace"].items()},
              "measurement_tools": p14,
              "cpu_count": os.cpu_count(),
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
