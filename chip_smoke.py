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
Prints per-kernel times (CUDA events) beside the plain versions', the
kernels' JSON line, the card line, and last the result line.  Exits
non-zero without a result when no card is visible.
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


def log(msg: str) -> None:
    print(msg, flush=True)


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

    kernels = []
    for name, src, repl in (
        ("chain_dp", "mappy_rs_tpu_torch/csrc/chain.cu",
         "mappy_rs_tpu/ops/chain_pallas.py:165"),
        ("backtrack_chains", "mappy_rs_tpu_torch/csrc/backtrack.cu",
         "mappy_rs_tpu/ops/backtrack_pallas.py:191"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": sl["launches"][name],
            "max_abs_err": kern[name]["max_abs_err"],
            "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
        })
    record = {"card": info["card"], "kernels": kernels,
              "reads_per_s": sl["reads_per_s"], "front_end_ms": sl["fe_ms"],
              "placed": sl["placed"], "n_reads": N_READS,
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
