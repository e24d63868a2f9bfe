// K1 — anchor chaining DP (minimap2's mm_chain_dp with a fixed window).
//
// Replaces: mappy_rs_tpu/ops/chain_pallas.py chain_scores_pallas (the
// Pallas TPU kernel built by _make_kernel).  Plain version:
// mappy_rs_tpu_torch/ops/chain.py chain_scores; wrapper:
// mappy_rs_tpu_torch/ops/chain_kernel.py.
//
//   f[i] = max(span_i, max_{j in [i-H, i)} f[j] + sc(j, i)),  H <= 1024
//   p[i] = largest j attaining the max, only when it beats span_i
//
// What bounds it on the card: the serial dependence along each read's
// anchors.  f[i] needs every f[j] of its window, so a read is a chain of
// A dependent steps; the work (B*A*H pair scores) and the bytes (~6
// int32 fields per anchor) are small.  Latency of one step, not FLOPs
// or bandwidth, sets the time.
//
// Design: one block per read: one consumer warp runs the serial chain,
// P producer warps (3 for H <= 256, else 7) score the pairs ahead of it.
//  - Pair scores do not depend on f, so they are off the chain: for
//    each tile of 16 steps the producers write sc(j, i+1) of every step
//    i's candidates to a double-buffered shared-memory block
//    [16][H/32 + 1][32] (one barrier per tile; the producers fill tile
//    t+1 while the consumer runs tile t).  Nothing grows with A.
//  - The consumer keeps the window's f in registers: lane l holds f of
//    anchors j = l (mod 32) of the last H/32 blocks of 32 anchors (a
//    ring shifted once every 32 steps), plus the current block.  While
//    step i reduces, the lanes fold f[j] + sc(j, i+1) of every candidate
//    of anchor i+1 except j = i into a per-lane partial argmax (f[j] for
//    j < i is known).  The serial part of step i is then: add f[i-1] to
//    the one new candidate's score, fold it in, two 32-bit
//    __reduce_max_sync (redux.sync: the max value, then the largest j
//    holding it — the larger j wins ties as in minimap2), and the select
//    against span_i.
//  - The gap penalty depends on dd = |dr - dq| <= bw alone when the
//    skip scale is 0 (every preset; minimap2's default) and the splice
//    branch is off: the block builds pen[0..bw] once in shared memory
//    with the same float operations, so a pair score is integer gates
//    plus one table load, with no int<->float conversion (a quarter-
//    rate instruction on the card).  Other parameters use the float
//    path inline.
//  - Fields are loaded coalesced a block of 32 anchors (the consumer's
//    span/valid) or a tile (the producers') ahead of their use; no
//    global load sits on the serial chain.
//  - Early end: each read's loop stops at its last valid anchor; the
//    tail is filled with NEG_INF / -1 in one coalesced pass.  Invalid
//    anchors before it are stepped over as in the plain version, so any
//    valid mask is exact.
//
// "No candidate" is INT_MIN.  A real candidate's value f[j] + sc is an
// int32 sum as in the plain version, never INT_MIN for anchors the
// pipeline makes (f >= span >= 0, |sc| < 2^30); the plain version's
// NEG_INF fill of gated slots never beats span_i, so dropping them from
// the max leaves f and p unchanged.
//
// Exactness: the gap penalty is float32 arithmetic truncated to int.
// Every multiply and add is an explicit round-to-nearest intrinsic and
// the file is compiled with -fmad=false, so no FMA contraction can flip
// a truncated score; float -> int truncates toward zero (__float2int_rz).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int NONE = INT_MIN;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 16;      // steps per scored tile (divides 32)
constexpr int MAX_SLOTS = 32;  // H <= 32 * 32
constexpr int MAX_TAB = 8192;  // penalty table entries (32 KB)

struct Params {
  int max_dist_x, max_dist_y, bw, is_splice;
  float pen_gap, pen_skip;
};

struct Anchor {
  int rev, rid, rp, qp, sp;
  bool ok;
};

__device__ __forceinline__ float mg_log2f(float x) {
  int z = __float_as_int(x);
  const int log2i = ((z >> 23) & 255) - 128;
  z = (z & ~(255 << 23)) + (127 << 23);
  const float zf = __int_as_float(z);
  float poly = __fadd_rn(__fmul_rn(-0.34484843f, zf), 2.02466578f);
  poly = __fsub_rn(__fmul_rn(poly, zf), 0.67487759f);
  return __fadd_rn(__int2float_rn(log2i), poly);
}

// comput_sc(j, i), or NONE when j is no candidate (ok false or a gate
// fails).  Branch-free: every lane evaluates every slot.  With TAB the
// penalty is read from the block's table pen_tab[dd] (dd <= bw once the
// gates pass), built with the same float operations (see chain_dp).
template <bool TAB>
__device__ __forceinline__ int pair_score(const Params& P, bool ok,
                                          const Anchor& j, const Anchor& i,
                                          const int* pen_tab) {
  const int dq = i.qp - j.qp;
  const int dr = i.rp - j.rp;
  const int dd = dr > dq ? dr - dq : dq - dr;
  ok = ok && j.rev == i.rev && j.rid == i.rid && dq > 0 &&
       dq <= P.max_dist_x && dq <= P.max_dist_y && dr > 0 &&
       dr <= P.max_dist_x && dd <= P.bw;
  const int dg = dr < dq ? dr : dq;
  int sc = dg < j.sp ? dg : j.sp;
  int pen;
  if (TAB) {
    pen = pen_tab[min(max(dd, 0), P.bw)];
  } else {
    const float lin = __fadd_rn(__fmul_rn(P.pen_gap, __int2float_rn(dd)),
                                __fmul_rn(P.pen_skip, __int2float_rn(dg)));
    const float logp = dd >= 1 ? mg_log2f(__int2float_rn(dd + 1)) : 0.f;
    pen = __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
    if (P.is_splice && dr > dq) pen = __float2int_rz(fminf(lin, logp));
  }
  if (dd != 0 || dg > j.sp) sc -= pen;
  return ok ? sc : NONE;
}

struct Row {
  const int *rev, *rid, *rpos, *qpos, *span;
  const uint8_t* valid;
};

__device__ __forceinline__ Anchor load_anchor(const Row& r, int idx, int n) {
  Anchor a{0, 0, 0, 0, 0, false};
  if (idx < n) {
    a.rev = __ldg(r.rev + idx);
    a.rid = __ldg(r.rid + idx);
    a.rp = __ldg(r.rpos + idx);
    a.qp = __ldg(r.qpos + idx);
    a.sp = __ldg(r.span + idx);
    a.ok = __ldg(r.valid + idx) != 0;
  }
  return a;
}

// Lane src's anchor, to every lane.
__device__ __forceinline__ Anchor shfl_anchor(const Anchor& a, int src) {
  Anchor o;
  o.rev = __shfl_sync(FULL, a.rev, src);
  o.rid = __shfl_sync(FULL, a.rid, src);
  o.rp = __shfl_sync(FULL, a.rp, src);
  o.qp = __shfl_sync(FULL, a.qp, src);
  o.sp = __shfl_sync(FULL, a.sp, src);
  o.ok = __shfl_sync(FULL, (int)a.ok, src) != 0;
  return o;
}

// Index of the last valid anchor of a row, or -1 (warp-uniform).
__device__ int last_valid(const uint8_t* valid, int A, int lane) {
  int last = -1;
  if ((A & 15) == 0 && (reinterpret_cast<uintptr_t>(valid) & 15) == 0) {
    const uint4* v4 = reinterpret_cast<const uint4*>(valid);
    for (int c = lane; c < (A >> 4); c += 32) {
      const uint4 w = __ldg(v4 + c);
      const unsigned top = w.w ? w.w : w.z ? w.z : w.y ? w.y : w.x;
      const int word = w.w ? 3 : w.z ? 2 : w.y ? 1 : 0;
      if (top) last = 16 * c + 4 * word + ((31 - __clz(top)) >> 3);
    }
  } else {
    for (int a = lane; a < A; a += 32)
      if (valid[a]) last = a;
  }
  return __reduce_max_sync(FULL, last);
}

// NS: ring slots of 32 predecessors each, 32 * NS >= H.  P: producer
// warps.  TAB: the gap penalty comes from a table of bw + 1 entries.
template <int NS, int P, bool TAB>
__global__ void __launch_bounds__((P + 1) * 32)
    chain_dp_kernel(Row r, int A, int H, Params prm,
                    int* __restrict__ f_out, int* __restrict__ p_out) {
  constexpr int SLOTS = NS + 1;               // ring slots + current block
  constexpr int MINE = (SLOTS + P - 1) / P;  // slots per producer warp
  extern __shared__ int smem[];
  int* pen_tab = smem;  // [bw + 1] when TAB
  // [2][TILE][SLOTS][32]: sc(j, i+1) for the steps i of a tile
  int* sc_buf = smem + (TAB ? (prm.bw + 4) & ~3 : 0);
  if (TAB) {
    // pen(dd) as pair_score computes it; the skip term is a signed zero
    // (pen_skip == 0, dg > 0 on every pair that passes the gates)
    for (int d = threadIdx.x; d <= prm.bw; d += blockDim.x) {
      const float lin = __fadd_rn(__fmul_rn(prm.pen_gap, __int2float_rn(d)),
                                  __fmul_rn(prm.pen_skip, 1.0f));
      const float logp = d >= 1 ? mg_log2f(__int2float_rn(d + 1)) : 0.f;
      pen_tab[d] = __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * A;
  r.rev += base;
  r.rid += base;
  r.rpos += base;
  r.qpos += base;
  r.span += base;
  r.valid += base;
  f_out += base;
  p_out += base;
  const int n = last_valid(r.valid, A, lane) + 1;  // every warp
  if (warp == 0) {
    for (int a = n + lane; a < A; a += 32) {
      f_out[a] = NEG_INF;
      p_out[a] = -1;
    }
  }
  if (n == 0) return;  // the whole block
  const int tiles = (n + TILE - 1) / TILE;

  // producer warp w (1..P) scores, for every step i of a tile, its slots
  // k = w-1, w-1+P, ... against anchor i+1: slot k < NS holds candidate
  // j = 32*(ib-1-k) + lane (in the window iff d >= 32(k+1)), slot NS
  // j = 32*ib + lane (the consumer keeps lanes < ii, and lane ii as the
  // next step's new candidate).  Within a tile ib is fixed, so each
  // lane loads its candidates once per tile.
  auto produce = [&](int t) {
    int* buf = sc_buf + (t & 1) * (TILE * SLOTS * 32);
    const int i0 = t * TILE, ib = i0 >> 5;
    const Anchor tg_l = load_anchor(r, i0 + 1 + lane, n);  // lanes < TILE
    Anchor J[MINE];
#pragma unroll
    for (int m = 0; m < MINE; ++m) {
      const int k = warp - 1 + m * P;
      const int j = k < NS ? 32 * (ib - 1 - k) + lane : 32 * ib + lane;
      J[m] = (k < SLOTS && j >= 0) ? load_anchor(r, j, n)
                                   : Anchor{0, 0, 0, 0, 0, false};
    }
#pragma unroll 4
    for (int s = 0; s < TILE; ++s) {
      const Anchor tg = shfl_anchor(tg_l, s);  // anchor i+1
      const int d = H + lane - ((i0 + s) & 31) - 1;
#pragma unroll
      for (int m = 0; m < MINE; ++m) {
        const int k = warp - 1 + m * P;
        if (k < SLOTS) {
          const bool in = J[m].ok && (k == NS || d >= 32 * (k + 1));
          buf[(s * SLOTS + k) * 32 + lane] =
              pair_score<TAB>(prm, in, J[m], tg, pen_tab);
        }
      }
    }
  };

  // the consumer's state (warp 0): f of the ring slots and of the
  // current block, span/valid of the current and next blocks
  int ring_f[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) ring_f[k] = NEG_INF;
  Anchor cur = load_anchor(r, lane, n);       // block ib
  Anchor nxt = load_anchor(r, 32 + lane, n);  // block ib + 1
  int cur_f = NEG_INF, cur_p = -1;            // f, p of anchor 32*ib + lane
  // span and valid of anchors i and i+1 (warp-uniform); each step
  // fetches i+2
  int ai_sp = __shfl_sync(FULL, cur.sp, 0), aq_sp = __shfl_sync(FULL, cur.sp, 1);
  bool ai_ok = __shfl_sync(FULL, (int)cur.ok, 0) != 0;
  bool aq_ok = __shfl_sync(FULL, (int)cur.ok, 1) != 0;
  int pv = NONE, pj = -1;  // partial argmax of anchor i: all j but i-1
  int nsc = NONE;          // sc(i-1, i), on lane (i-1) & 31
  int f_prev = NEG_INF;    // f[i-1] (warp-uniform)

  if (warp > 0) produce(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    if (warp > 0) {
      if (t + 1 < tiles) produce(t + 1);
    } else {
      const int* buf = sc_buf + (t & 1) * (TILE * SLOTS * 32) + lane;
      const int i_end = min(n, (t + 1) * TILE);
      int S[SLOTS];  // this step's scores, loaded a step ahead
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) S[k] = buf[k * 32];
      for (int i = t * TILE; i < i_end; ++i) {
        const int ii = i & 31, ib = i >> 5;

        // the serial part of step i
        int v = pv, vj = pj;
        if (lane == ((i - 1) & 31) && nsc != NONE && f_prev + nsc >= v) {
          v = f_prev + nsc;
          vj = i - 1;
        }
        const int best = __reduce_max_sync(FULL, v);
        const int bj = __reduce_max_sync(FULL, v == best ? vj : -1);
        const bool take = ai_ok && best > ai_sp;
        const int fi = take ? best : ai_ok ? ai_sp : NEG_INF;
        const int pi = take ? bj : -1;

        // off the chain (after the serial part in program order, so its
        // instructions fill the reductions' latency): span/valid of
        // anchor i+2, anchor i+1's partial argmax over j in [i+1-H, i-1],
        // and the next step's scores
        const int src = (ii + 2) & 31;
        const int an_sp = __shfl_sync(FULL, ii < 30 ? cur.sp : nxt.sp, src);
        const bool an_ok =
            __shfl_sync(FULL, (int)(ii < 30 ? cur.ok : nxt.ok), src) != 0;
        int qv = NONE, qj = -1;
#pragma unroll
        for (int k = NS - 1; k >= 0; --k) {  // increasing j
          const int tk = ring_f[k] + S[k];
          if (S[k] != NONE && tk >= qv) {
            qv = tk;
            qj = 32 * (ib - 1 - k) + lane;
          }
        }
        const int cs = S[NS];
        if (lane < ii && cs != NONE && cur_f + cs >= qv) {
          qv = cur_f + cs;
          qj = 32 * ib + lane;
        }
        if (i + 1 < i_end) {
          const int* nsc_row = buf + (i + 1 - t * TILE) * SLOTS * 32;
#pragma unroll
          for (int k = 0; k < SLOTS; ++k) S[k] = nsc_row[k * 32];
        }

        if (lane == ii) {
          cur_f = fi;
          cur_p = pi;
        }
        f_prev = fi;
        pv = qv;
        pj = qj;
        nsc = cs;
        ai_sp = aq_sp;
        ai_ok = aq_ok;
        aq_sp = an_sp;
        aq_ok = an_ok;
        if (ii == 31 || i + 1 == n) {
          const int idx = 32 * ib + lane;
          if (idx < n) {
            f_out[idx] = cur_f;
            p_out[idx] = cur_p;
          }
          if (ii == 31) {  // shift the ring by one block
#pragma unroll
            for (int k = NS - 1; k > 0; --k) ring_f[k] = ring_f[k - 1];
            ring_f[0] = cur_f;
            cur = nxt;
            nxt = load_anchor(r, 32 * (ib + 2) + lane, n);
            cur_f = NEG_INF;
            cur_p = -1;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int NS, int P, bool TAB>
cudaError_t launch(int B, const Row& r, int A, int H, const Params& prm,
                   int* f, int* p, cudaStream_t s) {
  const size_t tab = TAB ? (size_t)((prm.bw + 4) & ~3) : 0;
  const size_t smem = (tab + 2 * TILE * (NS + 1) * 32) * sizeof(int);
  auto kernel = chain_dp_kernel<NS, P, TAB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, (P + 1) * 32, smem, s>>>(r, A, H, prm, f, p);
  return cudaGetLastError();
}

template <int NS, int P>
cudaError_t launch_tab(bool tab, int B, const Row& r, int A, int H,
                       const Params& prm, int* f, int* p, cudaStream_t s) {
  return tab ? launch<NS, P, true>(B, r, A, H, prm, f, p, s)
             : launch<NS, P, false>(B, r, A, H, prm, f, p, s);
}

}  // namespace

extern "C" int chain_dp(const void* rev, const void* rid, const void* rpos,
                        const void* qpos, const void* valid, const void* span,
                        int B, int A, int H, int max_dist_x, int max_dist_y,
                        int bw, float pen_gap, float pen_skip, int is_splice,
                        void* f_out, void* p_out, void* stream) {
  if (H <= 0 || H % 32 != 0 || H > 32 * MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  const Row r{(const int*)rev,  (const int*)rid,  (const int*)rpos,
              (const int*)qpos, (const int*)span, (const uint8_t*)valid};
  const Params prm{max_dist_x, max_dist_y, bw, is_splice, pen_gap, pen_skip};
  const cudaStream_t s = (cudaStream_t)stream;
  int* f = (int*)f_out;
  int* p = (int*)p_out;
  // the table holds pen(dd) for dd in [0, bw]; it is exact when the
  // skip term is a zero and the splice branch is off
  const bool tab = pen_skip == 0.0f && !is_splice && bw >= 0 && bw < MAX_TAB;
  const int slots = H / 32;
  cudaError_t e;
  if (slots <= 4)
    e = launch_tab<4, 3>(tab, B, r, A, H, prm, f, p, s);
  else if (slots <= 8)
    e = launch_tab<8, 3>(tab, B, r, A, H, prm, f, p, s);
  else if (slots <= 16)
    e = launch_tab<16, 7>(tab, B, r, A, H, prm, f, p, s);
  else
    e = launch_tab<32, 7>(tab, B, r, A, H, prm, f, p, s);
  return (int)e;
}
