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
//
// What bounds it on the card: the pointer walk, a chain of dependent
// loads per read (a chain is typically tens of anchors), and K serial
// argmax passes.  Bytes and operations are tiny: latency bound.
//
// Design: one warp per read, one read per block.  The lanes share each
// pass's argmax over the A candidates (a __shfl_xor_sync max of the
// packed int64 f*2^32 + index); the `used` flags sit in shared memory
// (A bytes) and persist across the K passes; lane 0 walks.  Indices
// outside [0, A) read as 0, as the Pallas kernel's masked lane
// reduction does, and the walk is capped at A steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG_LEN = 384;
constexpr int N_FIXED = 9;
constexpr int MAX_CUTS = 8;
constexpr long long NONE = -0x7fffffffffffffffLL - 1;
constexpr long long TWO32 = 1LL << 32;

__device__ __forceinline__ int col(const int* v, int idx, int A) {
  return (idx >= 0 && idx < A) ? v[idx] : 0;
}

__global__ void backtrack_kernel(const int* __restrict__ f,
                                 const int* __restrict__ p,
                                 const uint8_t* __restrict__ valid,
                                 const int* __restrict__ rev,
                                 const int* __restrict__ rid,
                                 const int* __restrict__ rpos,
                                 const int* __restrict__ qpos,
                                 const int* __restrict__ span, int A, int K,
                                 int seg_cuts, int min_cnt, int min_sc,
                                 int* __restrict__ out) {
  extern __shared__ uint8_t used[];  // [A]
  const int lane = threadIdx.x;
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
  for (int a = lane; a < A; a += 32) used[a] = 0;
  for (int t = lane; t < K * FLD; t += 32) o[t] = -1;
  __syncwarp();
  for (int kk = 0; kk < K; ++kk) {
    long long best = NONE;
    for (int a = lane; a < A; a += 32) {
      if (valid[a] && f[a] >= min_sc && !used[a]) {
        const long long cand = (long long)f[a] * TWO32 + a;
        best = cand > best ? cand : best;
      }
    }
    for (int s = 16; s > 0; s >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, best, s);
      best = other > best ? other : best;
    }
    // no candidate: none in later passes either (used only grows)
    if (best == NONE) break;
    if (lane == 0) {
      const int endv = (int)(best & 0xffffffffLL);
      const int q_end = qpos[endv];
      int next_cut = q_end - SEG_LEN;
      int cur = endv, cnt = 0, join_f = 0, n_cuts = 0;
      int q_first = 0, r_first = 0, sp_first = 0;
      int cuts[2 * MAX_CUTS];
      for (int c = 0; c < 2 * MAX_CUTS; ++c) cuts[c] = -1;
      for (int it = 0; it < A; ++it) {
        if (cur >= 0 && cur < A) used[cur] = 1;
        const int qp = col(qpos, cur, A), rp = col(rpos, cur, A);
        q_first = qp;
        r_first = rp;
        sp_first = col(span, cur, A);
        ++cnt;
        if (qp <= next_cut && n_cuts < seg_cuts) {
          cuts[2 * n_cuts] = qp;
          cuts[2 * n_cuts + 1] = rp;
          ++n_cuts;
          next_cut = qp - SEG_LEN;
        }
        const int nxt = col(p, cur, A);
        const bool nxt_used = nxt >= 0 && nxt < A && used[nxt];
        if (nxt >= 0 && nxt_used) join_f = col(f, nxt, A);
        if (nxt < 0 || nxt_used) break;
        cur = nxt;
      }
      const int sc = f[endv] - join_f;
      if (cnt >= min_cnt && sc >= min_sc) {
        int* row = o + kk * FLD;
        row[0] = sc;
        row[1] = cnt;
        row[2] = rev[endv];
        row[3] = rid[endv];
        row[4] = r_first;
        row[5] = rpos[endv];
        row[6] = q_first;
        row[7] = q_end;
        row[8] = sp_first;
        for (int c = 0; c < 2 * seg_cuts; ++c) row[N_FIXED + c] = cuts[c];
      }
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
                                int min_sc, void* out, void* stream) {
  if (seg_cuts < 0 || seg_cuts > MAX_CUTS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  backtrack_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int*)f, (const int*)p, (const uint8_t*)valid, (const int*)rev,
      (const int*)rid, (const int*)rpos, (const int*)qpos, (const int*)span,
      A, K, seg_cuts, min_cnt, min_sc, (int*)out);
  return (int)cudaGetLastError();
}
