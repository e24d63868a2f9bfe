// K2 — top-K chain extraction from the chaining DP (mm_chain_backtrack).
//
// Replaces: mappy_rs_tpu/ops/backtrack_pallas.py backtrack_chains_pallas
// (the Pallas TPU kernel built by _make_kernel).  Plain version and
// wrapper: mappy_rs_tpu_torch/ops/backtrack.py.
//
// Per read, K passes: take the best unused candidate end (valid, f >=
// min_sc; ties to the larger index), walk p[] from it marking anchors
// used until the walk reaches a used anchor (join) or a chain start.
// score = f[end] - f[join] (join_f stays 0 without a join); the chain
// is written to slot k iff cnt >= min_cnt and score >= min_sc, but a
// rejected walk still consumes its anchors.  Up to seg_cuts (qpos, rpos)
// cut pairs are recorded end->start at SEG_LEN query spacing.  Output
// row: score, cnt, rev, rid, rpos_first, rpos_last, qpos_first,
// qpos_last, span_first, then the cuts; -1 where nothing was written.
// Indices outside [0, A) read as 0, as the Pallas kernel's masked lane
// reduction does, and the walk is capped at A steps.
//
// What bounds it on the card: the pointer walk, a chain of dependent
// loads per read (a chain is tens of anchors at 1 kb, thousands at
// 100 kb), and K serial argmax passes.  Bytes and operations are tiny:
// latency bound.
//
// Design: one warp per read, one read per block.
//  - `used` is a bitmask in shared memory (A/8 bytes; 64 KB at A =
//    524,288), kept across the K passes.
//  - p, the walk's dependent chain, is staged in shared memory when it
//    fits (A <= 56,319), else read from global memory (L2) through the
//    same pointer.  Staging the candidate values or qpos/rpos as well
//    gained nothing measurable (PERF.md), so they are read from global.
//  - Each pass's argmax is two 32-bit __reduce_max_sync: the max value
//    over the lanes' strided candidates, then the largest index at it.
//    Candidates are read 4 anchors per lane per load (16-byte f, 4-byte
//    valid) where A and the rows' addresses allow, else one at a time.
//  - Lane 0 walks in chunks of up to 32 steps.  Each step stores cur's
//    used bit and issues the two loads of the next anchor, its used word
//    and its p, together, so one load latency sits on the chain per
//    step.  The chunk's anchors go to a 32-entry buffer; the warp then
//    reads their qpos/rpos in parallel and applies the greedy cut rule
//    with one ballot per cut (each lane keeps one cut value: lane c the
//    c-th cut column).  The end's fields, f[join] and span_first are
//    read by the lanes in parallel after the walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG_LEN = 384;
constexpr int N_FIXED = 9;
constexpr int MAX_CUTS = 8;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 32;  // walk steps per chunk (one per lane)

__device__ __forceinline__ int col(const int* v, int idx, int A) {
  return (idx >= 0 && idx < A) ? v[idx] : 0;
}

__global__ void __launch_bounds__(32)
    backtrack_kernel(const int* __restrict__ f, const int* __restrict__ p,
                     const uint8_t* __restrict__ valid,
                     const int* __restrict__ rev, const int* __restrict__ rid,
                     const int* __restrict__ rpos,
                     const int* __restrict__ qpos,
                     const int* __restrict__ span, int A, int K,
                     int seg_cuts, int min_cnt, int min_sc, bool stage_p,
                     int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x;
  const int nw = (A + 31) >> 5;
  unsigned* used = smem;          // [nw] bit a: anchor a used
  int* path = (int*)(smem + nw);  // [CHUNK] the walk's chunk
  int* p_s = path + CHUNK;        // [A] p (stage_p)
  const size_t base = (size_t)blockIdx.x * A;
  const int FLD = N_FIXED + 2 * seg_cuts;
  f += base;
  p += base;
  valid += base;
  rev += base;
  rid += base;
  rpos += base;
  qpos += base;
  span += base;
  int* o = out + (size_t)blockIdx.x * K * FLD;
  for (int w = lane; w < nw; w += 32) used[w] = 0;
  const int* pw = p;
  if (stage_p) {
#pragma unroll 4
    for (int a = lane; a < A; a += 32) p_s[a] = __ldg(p + a);
    pw = p_s;
  }
  // candidates are read 4 anchors at a time where aligned
  const bool vec4 = (A & 127) == 0 &&
                    (reinterpret_cast<uintptr_t>(f) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  for (int t = lane; t < K * FLD; t += 32) o[t] = -1;
  __syncwarp();

  for (int kk = 0; kk < K; ++kk) {
    // best unused candidate end; the lane keeps the larger index on ties
    int lv = NEG, la = -1;
    auto consider = [&](int fc, int a) {
      if (fc >= lv) {
        lv = fc;
        la = a;
      }
    };
    if (vec4) {  // 4 consecutive anchors a lane, 16-byte loads
#pragma unroll 4
      for (int c = lane; c < (A >> 2); c += 32) {
        const int4 fa = __ldg(reinterpret_cast<const int4*>(f) + c);
        const uchar4 va = __ldg(reinterpret_cast<const uchar4*>(valid) + c);
        const unsigned ub = used[c >> 3] >> ((c & 7) * 4);
        consider(va.x && fa.x >= min_sc && !(ub & 1u) ? fa.x : NEG, 4 * c);
        consider(va.y && fa.y >= min_sc && !(ub & 2u) ? fa.y : NEG, 4 * c + 1);
        consider(va.z && fa.z >= min_sc && !(ub & 4u) ? fa.z : NEG, 4 * c + 2);
        consider(va.w && fa.w >= min_sc && !(ub & 8u) ? fa.w : NEG, 4 * c + 3);
      }
    } else {
#pragma unroll 4
      for (int a = lane; a < A; a += 32) {
        const int fa = __ldg(f + a);
        const bool c = __ldg(valid + a) && fa >= min_sc &&
                       !((used[a >> 5] >> (a & 31)) & 1u);
        consider(c ? fa : NEG, a);
      }
    }
    const int best = __reduce_max_sync(FULL, lv);  // = f[end]
    // no candidate: none in later passes either (used only grows)
    if (best <= NEG) break;
    const int endv = __reduce_max_sync(FULL, lv == best ? la : -1);

    // the end's row fields, loaded now and used after the walk
    const int q_end = __ldg(qpos + endv), rpos_end = __ldg(rpos + endv);
    const int rev_end = __ldg(rev + endv), rid_end = __ldg(rid + endv);
    int next_cut = q_end - SEG_LEN, n_cuts = 0, my_cut = -1;
    int cur = endv, steps = 0, join = -1, last = endv;
    int q_first = 0, r_first = 0;
    bool stop = false;
    while (!stop) {
      int m = 0;
      if (lane == 0) {
        const bool in0 = cur >= 0 && cur < A;
        unsigned wc = in0 ? used[cur >> 5] : 0u;
        int pc = in0 ? pw[cur] : 0;  // p[cur], 0 outside [0, A)
        while (m < CHUNK && steps < A) {
          path[m++] = cur;
          ++steps;
          if (cur >= 0 && cur < A) used[cur >> 5] = wc | (1u << (cur & 31));
          const int nx = pc;
          const bool nin = nx >= 0 && nx < A;
          unsigned wn = 0u;
          int pn = 0;
          if (nin) {  // both loads of the next anchor at once
            wn = used[nx >> 5];
            pn = pw[nx];
          }
          const bool nu = nin && ((wn >> (nx & 31)) & 1u);
          if (nx < 0 || nu) {
            stop = true;
            if (nu) join = nx;
            break;
          }
          cur = nx;
          wc = wn;
          pc = pn;
        }
        if (steps >= A) stop = true;
      }
      m = __shfl_sync(FULL, m, 0);
      stop = __shfl_sync(FULL, (int)stop, 0) != 0;
      cur = __shfl_sync(FULL, cur, 0);
      steps = __shfl_sync(FULL, steps, 0);
      join = __shfl_sync(FULL, join, 0);
      __syncwarp();  // path[] written by lane 0
      const int idx = lane < m ? path[lane] : -1;
      const int qp = col(qpos, idx, A), rp = col(rpos, idx, A);
      // greedy cuts in walk order: the first step at or below next_cut
      for (int from = 0; n_cuts < seg_cuts;) {
        const unsigned hit =
            __ballot_sync(FULL, lane < m && lane >= from && qp <= next_cut);
        if (!hit) break;
        const int s_at = __ffs(hit) - 1;
        const int q = __shfl_sync(FULL, qp, s_at);
        const int rr = __shfl_sync(FULL, rp, s_at);
        if (lane == 2 * n_cuts) my_cut = q;
        if (lane == 2 * n_cuts + 1) my_cut = rr;
        ++n_cuts;
        next_cut = q - SEG_LEN;
        from = s_at + 1;
      }
      last = __shfl_sync(FULL, idx, m - 1);
      q_first = __shfl_sync(FULL, qp, m - 1);
      r_first = __shfl_sync(FULL, rp, m - 1);
      __syncwarp();  // before lane 0 refills path[]
    }

    const int join_f = join >= 0 ? __ldg(f + join) : 0;
    const int sc = best - join_f;
    if (steps >= min_cnt && sc >= min_sc) {
      int* row = o + kk * FLD;
      if (lane < N_FIXED) {
        int val;
        switch (lane) {
          case 0: val = sc; break;
          case 1: val = steps; break;
          case 2: val = rev_end; break;
          case 3: val = rid_end; break;
          case 4: val = r_first; break;
          case 5: val = rpos_end; break;
          case 6: val = q_first; break;
          case 7: val = q_end; break;
          default: val = col(span, last, A); break;
        }
        row[lane] = val;
      }
      if (lane < 2 * seg_cuts) row[N_FIXED + lane] = my_cut;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int backtrack_chains(const void* f, const void* p,
                                const void* valid, const void* rev,
                                const void* rid, const void* rpos,
                                const void* qpos, const void* span, int B,
                                int A, int K, int seg_cuts, int min_cnt,
                                int min_sc, int smem_limit, void* out,
                                void* stream) {
  if (seg_cuts < 0 || seg_cuts > MAX_CUTS) return (int)cudaErrorInvalidValue;
  const size_t fixed = ((size_t)(A + 31) / 32 + CHUNK) * 4;
  const size_t row = (size_t)A * 4;
  const size_t lim = (size_t)smem_limit;
  // p (the walk's dependent chain) is staged when it fits
  const bool stage_p = fixed + row <= lim;
  const size_t smem = fixed + (stage_p ? row : 0);
  if (smem > lim) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  backtrack_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int*)f, (const int*)p, (const uint8_t*)valid, (const int*)rev,
      (const int*)rid, (const int*)rpos, (const int*)qpos, (const int*)span,
      A, K, seg_cuts, min_cnt, min_sc, stage_p, (int*)out);
  return (int)cudaGetLastError();
}
