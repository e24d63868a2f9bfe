"""Configuration: index & mapping options with minimap2-compatible presets.

Equivalent of the reference's option plumbing
(``/root/reference/src/lib.rs:331-385`` forwarding to minimap2's
``mm_set_opt`` / ``mm_idxopt_init`` / ``mm_mapopt_init``).  The reference
exposes every field of the C option structs to Python as constructor
kwargs; here the option structs are plain dataclasses so the whole
configuration surface is introspectable and serialisable.

Preset tables mirror minimap2 2.26 semantics for the presets the
reference supports through ``mm_set_opt(preset, ...)``.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Flag constants (minimap2 mapopt.flag bits).  The reference ORs raw bits from
# Python through `extra_flags` (/root/reference/src/lib.rs:366-368), so the
# numeric values must match minimap2's.
# ---------------------------------------------------------------------------
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_LONG_CIGAR = 0x10000
MM_F_INDEPEND_SEG = 0x20000
MM_F_SPLICE_FLANK = 0x40000
MM_F_SOFTCLIP = 0x80000
MM_F_FOR_ONLY = 0x100000
MM_F_REV_ONLY = 0x200000
MM_F_HEAP_SORT = 0x400000
MM_F_ALL_CHAINS = 0x800000
MM_F_OUT_MD = 0x1000000
MM_F_COPY_COMMENT = 0x2000000
MM_F_EQX = 0x4000000
MM_F_PAF_NO_HIT = 0x8000000
MM_F_NO_END_FLT = 0x10000000
MM_F_HARD_MLEVEL = 0x20000000
MM_F_SAM_HIT_ONLY = 0x40000000
MM_F_RMQ = 1 << 38  # use RMQ (long-gap) chaining

# Index flag bits (mm_idxopt.flag / mm_idx_t.flag).
MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

INT32_MAX = 2147483647


@dataclass
class IndexOptions:
    """Minimizer-index construction options (minimap2 ``mm_idxopt_t``)."""

    k: int = 15
    w: int = 10
    bucket_bits: int = 14
    flag: int = 0
    mini_batch_size: int = 50_000_000
    batch_size: int = 0x7FFFFFFFFFFFFFFF  # single-part index (lib.rs:340)


@dataclass
class MapOptions:
    """Mapping options (minimap2 ``mm_mapopt_t``), defaults = map-ont."""

    flag: int = 0
    seed: int = 11
    # seeding
    mid_occ_frac: float = 2e-4
    min_mid_occ: int = 10
    max_mid_occ: int = 1_000_000
    mid_occ: int = 0  # computed at index load by mapopt_update()
    max_occ: int = 0
    max_max_occ: int = 4095
    occ_dist: int = 500
    q_occ_frac: float = 0.01
    # chaining
    bw: int = 500
    bw_long: int = 20000
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    min_cnt: int = 3
    min_chain_score: int = 40
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0
    rmq_size_cap: int = 100_000
    rmq_inner_dist: int = 1000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1
    # secondary-alignment selection
    mask_level: float = 0.5
    mask_len: int = INT32_MAX
    pri_ratio: float = 0.8
    best_n: int = 5
    # alignment scoring (a=match, b=mismatch, q/e + q2/e2 = dual affine gaps)
    a: int = 2
    b: int = 4
    q: int = 4
    e: int = 2
    q2: int = 24
    e2: int = 1
    sc_ambi: int = 1
    transition: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    # splice-mode scoring (minimap2 mm_mapopt_t noncan/junc_bonus):
    # noncan = extra open/close cost for non-GT..AG (non-CT..AC) introns;
    # junc_bonus applies only with a junction BED annotation, which this
    # build (like the reference surface) does not load — kept for option
    # -struct parity.
    noncan: int = 0
    junc_bonus: int = 9
    end_bonus: int = -1
    min_dp_max: int = 80  # = min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0
    rank_min_len: int = 500
    rank_frac: float = 0.9
    # misc
    pe_ori: int = 0
    pe_bonus: int = 33
    mini_batch_size: int = 500_000_000
    max_sw_mat: int = 100_000_000
    cap_kalloc: int = 1_000_000_000


def _apply_preset(preset: str, io: IndexOptions, mo: MapOptions) -> None:
    """Mutate option structs per minimap2 2.26 preset semantics."""
    if preset in ("map-ont", "ont"):
        pass  # map-ont IS the default configuration
    elif preset in ("ava-ont",):
        io.flag = 0
        io.k, io.w = 15, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.bw = 100, 2000
        mo.occ_dist = 0
    elif preset in ("map-pb", "pb"):
        io.flag = MM_I_HPC
        io.k = 19
    elif preset in ("ava-pb",):
        io.flag = MM_I_HPC
        io.k = 19
        io.w = 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score = 100
    elif preset in ("map-hifi", "hifi", "lr:hq"):
        io.flag = 0
        io.k, io.w = 19, 19
        mo.max_gap = 10000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 4, 6, 2, 26, 1
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
    elif preset in ("short", "sr"):
        io.flag = 0
        io.k, io.w = 21, 11
        mo.flag |= (
            MM_F_SR
            | MM_F_FRAG_MODE
            | MM_F_NO_PRINT_2ND
            | MM_F_2_IO_THREADS
            | MM_F_HEAP_SORT
        )
        mo.pri_ratio = 0.5
        mo.min_cnt = 2
        mo.min_chain_score = 25
        mo.min_dp_max = 40
        mo.best_n = 20
        mo.max_gap = 100
        mo.bw = mo.bw_long = 100
        mo.max_frag_len = 800
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop, mo.zdrop_inv = 100, 10
        mo.end_bonus = 10
        mo.mid_occ_frac = 1e-3
    elif preset in ("asm5", "asm10", "asm20"):
        io.flag = 0
        io.k, io.w = 19, 19
        mo.bw = 1000
        mo.bw_long = 100000
        mo.max_gap = 10000
        mo.flag |= MM_F_RMQ
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
        mo.best_n = 50
        if preset == "asm5":
            mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 19, 39, 3, 81, 1
            mo.zdrop, mo.zdrop_inv = 200, 200
        elif preset == "asm10":
            mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 9, 16, 2, 41, 1
            mo.zdrop, mo.zdrop_inv = 200, 200
        else:
            mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 4, 6, 2, 26, 1
            mo.zdrop, mo.zdrop_inv = 200, 200
    elif preset in ("splice", "splice:hq", "cdna"):
        # minimap2 2.26 options.c splice table: spliced (RNA) mapping —
        # log-cost reference gaps in chaining, intron-state extension
        # with GT..AG/CT..AC signal scoring (N CIGAR ops, cs `~`).
        io.flag = 0
        io.k, io.w = 15, 5
        mo.flag |= (
            MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV
            | MM_F_SPLICE_FLANK
        )
        mo.max_sw_mat = 0  # no DP-matrix size cap: introns are long
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = mo.bw_long = 200000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.junc_bonus = 5
            mo.b, mo.q, mo.e, mo.q2 = 4, 6, 2, 24
    else:
        raise ValueError(f"Unknown preset: {preset!r}")


def set_opt(preset: str | None = None) -> tuple[IndexOptions, MapOptions]:
    """Equivalent of ``mm_set_opt`` (lib.rs:333-337).

    ``None`` returns default options; a preset string layers the preset
    table on top of the defaults, as the C call does.
    """
    io, mo = IndexOptions(), MapOptions()
    if preset is not None:
        _apply_preset(preset, io, mo)
    return io, mo


@dataclass
class AlignerConfig:
    """Bundled, resolved configuration for one Aligner instance."""

    idx_opt: IndexOptions = field(default_factory=IndexOptions)
    map_opt: MapOptions = field(default_factory=MapOptions)
    preset: str | None = None

    # --- runtime knobs (no analogue in the reference) ----------------
    # max reads per device batch in the streaming map_batch pipeline
    # (overridable with MAPPY_RS_TPU_BATCH for deployment tuning)
    device_batch_size: int = field(
        default_factory=lambda: int(
            os.environ.get("MAPPY_RS_TPU_BATCH", "256")
        )
    )
    # length buckets for padding variable-length reads (powers-of-two-ish)
    length_buckets: tuple[int, ...] = (512, 1024, 2048, 8192, 32768, 131072)
    # per-read anchor capacity per bucket (scaled with length)
    anchors_per_base: float = 0.25
    # chain DP predecessor window (rounded up to a multiple of 128),
    # minimap2's max_chain_iter analogue; repeat-dense references can
    # need more than 128 (tests/test_chain_window.py).  The name is the
    # JAX package's, whose Pallas kernel takes the same window.
    pallas_chain_window: int = 128
    # extension engine: "auto" | "host" | "device" | "device_dl".
    #   host      — C++ banded DP + walk (identical results to the kernels)
    #   device    — fully on cfg.device: DP kernel K3 (csrc/extend.cu) then
    #               traceback kernel K4 (csrc/traceback.cu); only the packed
    #               CIGAR table comes back to the host
    #   device_dl — K3 on cfg.device, the direction bytes downloaded and
    #               walked on the host (C++ traceback_batch)
    #   auto      — host when the native lib is built, else device_dl
    # Overridable per-process with MAPPY_RS_TPU_EXTENSION.
    extension_backend: str = field(
        default_factory=lambda: os.environ.get(
            "MAPPY_RS_TPU_EXTENSION", "auto"
        )
    )
    # [J, OPS] CIGAR table width of the device traceback (jobs whose
    # run-length CIGAR overflows re-run on the host engine)
    traceback_max_ops: int = 128
    # chain backtrack: "auto" | "on" | "off".  "auto" and "on" run kernel
    # K2 (csrc/backtrack.cu) wherever its shared memory takes the batch's
    # anchor budget (ops/backtrack.py backtrack_fits), so only the compact
    # [B, K, 9+2*cuts] chain table is downloaded; a batch K2 cannot hold,
    # and every batch under "off", downloads K1's anchors with f and p and
    # backtracks on the host (C++ backtrack_compact_batch), with the same
    # chains.  The names are the JAX package's, where "auto" decides by
    # platform.
    device_backtrack: str = "auto"
    # fused C++ post-chain record emission (native/post_chain.cc):
    # regions + selection + extension + finalize + mapq in one native
    # call per batch.  False forces the stage-by-stage Python path
    # (the parity oracle; rare reads — zdrop splits, cap overflows —
    # always fall back to it regardless).
    post_chain_native: bool = field(
        default_factory=lambda: os.environ.get(
            "MAPPY_RS_TPU_POST_CHAIN", "1"
        ) != "0"
    )
    # top-K chain candidate ends processed per read by the device
    # backtrack (select_sub keeps at most best_n secondaries, so
    # best_n + 3 loses nothing in practice)
    backtrack_k: int = 8
    # front end: "device" (sketch/lookup/chain on cfg.device) or "cpu"
    # (native C++ scalar path, native/front_end.cc — the reference-style
    # CPU aligner).  Overridable with MAPPY_RS_TPU_FRONT_END.
    front_end_backend: str = field(
        default_factory=lambda: os.environ.get(
            "MAPPY_RS_TPU_FRONT_END", "device"
        )
    )
    # CPU chaining predecessor cap (minimap2 max_chain_iter)
    cpu_chain_max_iter: int = 5000
    # multi-process execution (runtime/procpool.py, runtime/devowner.py):
    # enable_threading's workers become proxies to this many spawned child
    # processes, each with its own interpreter lock, so the Python and C++
    # post-chain scale past the GIL.  0 = in-process threads.  Overridable
    # with MAPPY_RS_TPU_PROCS.
    worker_processes: int = field(
        default_factory=lambda: int(
            os.environ.get("MAPPY_RS_TPU_PROCS", "0")
        )
    )
    # multi-process topology: "classic" = every child runs the whole
    # pipeline on cfg.device (its own CUDA context and index upload);
    # "device_owner" = the parent owns the only CUDA context and index
    # copy and runs every front end, and the children are CUDA-free
    # post-chain workers.  Overridable with MAPPY_RS_TPU_TOPOLOGY.
    topology: str = field(
        default_factory=lambda: os.environ.get(
            "MAPPY_RS_TPU_TOPOLOGY", "classic"
        )
    )
    # reads drained per proxy dispatch in multi-process mode (2x the
    # device batch, so a child's software pipeline has batches to
    # overlap).  Overridable with MAPPY_RS_TPU_PROC_CHUNK.
    proc_chunk: int = field(
        default_factory=lambda: int(
            os.environ.get("MAPPY_RS_TPU_PROC_CHUNK", "512")
        )
    )
    # pad every device batch to the one full [B, L] shape instead of
    # also using a tiny [8, L] shape for small batches
    single_batch_shape: bool = False
    # in-engine software-pipeline depth: up to depth-1 dispatched
    # device batches in flight while one is processed on the host
    # (overridable with MAPPY_RS_TPU_DEPTH)
    pipeline_depth: int = field(
        default_factory=lambda: int(
            os.environ.get("MAPPY_RS_TPU_DEPTH", "4")
        )
    )
    # mid-segment band sizing: W = max(floor, 32*ceil((drift+slack)/32))
    # where drift = |qlen - tlen| is KNOWN from the anchors at both
    # segment ends.  The floor/slack trade DP cells (the dominant host
    # cost) against path-wander coverage; consecutive band lanes step
    # j-i by 2, so W lanes cover a 2W-wide j-i corridor.  Values must
    # keep W a multiple of 32 (AVX-512 lane granularity).  Big
    # in-segment indels stay covered because drift is part of the
    # formula, and the zdrop-split path catches what the corridor misses.
    mid_band_floor: int = 32
    mid_band_slack: int = 2
    # torch device of the front end and its index tensors: "cuda"
    # (default) or "cpu".  Explicit by design: with "cuda" and no card
    # the engine raises instead of quietly running on the CPU.
    device: str = "cuda"

    def replace(self, **kw) -> "AlignerConfig":
        return dataclasses.replace(self, **kw)
