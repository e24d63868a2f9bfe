// K1 — anchor chaining DP (minimap2's mm_chain_dp with a fixed window).
//
// Replaces: mappy_rs_tpu/ops/chain_pallas.py chain_scores_pallas (the
// Pallas TPU kernel built by _make_kernel).  Plain version:
// mappy_rs_tpu_torch/ops/chain.py chain_scores; wrapper:
// mappy_rs_tpu_torch/ops/chain_kernel.py.
//
//   f[i] = max(span_i, max_{j in [i-H, i)} f[j] + sc(j, i)),  H = R*128
//   p[i] = largest j attaining the max, only when it beats span_i
//
// What bounds it on the card: the serial dependence along each read's
// anchors.  f[i] needs every f[j] of its window, so a read is a chain of
// A dependent steps; the work (B*A*H pair scores, ~8.4M at B=256, A=256,
// H=128) and the bytes (~6 int32 fields per anchor) are small.  Latency
// of one step, not FLOPs or bandwidth, sets the time.
//
// Design: one warp per read, one read per block.  The read's f values
// live in dynamic shared memory (A ints; opt-in above 48 KB).  For
// anchor i the 32 lanes score the H predecessors, H/32 each, and the
// per-anchor max/argmax is a __shfl_xor_sync reduction on a packed
// int64 score*2^32 + j, so the larger j wins ties as in minimap2.  The
// anchor fields are read through the L1 cache; consecutive windows
// overlap in all but one anchor.
//
// Exactness: the gap penalty is float32 arithmetic truncated to int.
// Every multiply and add is an explicit round-to-nearest intrinsic and
// the file is compiled with -fmad=false, so no FMA contraction can flip
// a truncated score; float -> int truncates toward zero (__float2int_rz).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr long long NONE = -0x7fffffffffffffffLL - 1;
constexpr long long TWO32 = 1LL << 32;

__device__ __forceinline__ float mg_log2f(float x) {
  int z = __float_as_int(x);
  const int log2i = ((z >> 23) & 255) - 128;
  z = (z & ~(255 << 23)) + (127 << 23);
  const float zf = __int_as_float(z);
  float poly = __fadd_rn(__fmul_rn(-0.34484843f, zf), 2.02466578f);
  poly = __fsub_rn(__fmul_rn(poly, zf), 0.67487759f);
  return __fadd_rn(__int2float_rn(log2i), poly);
}

__global__ void chain_dp_kernel(const int* __restrict__ rev,
                                const int* __restrict__ rid,
                                const int* __restrict__ rpos,
                                const int* __restrict__ qpos,
                                const uint8_t* __restrict__ valid,
                                const int* __restrict__ span, int A, int H,
                                int max_dist_x, int max_dist_y, int bw,
                                float pen_gap, float pen_skip, int is_splice,
                                int* __restrict__ f_out,
                                int* __restrict__ p_out) {
  extern __shared__ int f_s[];  // [A] chain scores of this read
  const int lane = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * A;
  rev += base;
  rid += base;
  rpos += base;
  qpos += base;
  valid += base;
  span += base;
  for (int i = 0; i < A; ++i) {
    const bool cv = valid[i] != 0;
    long long best = NONE;
    if (cv) {
      const int c_rev = rev[i], c_rid = rid[i];
      const int cq = qpos[i], cr = rpos[i];
      for (int t = lane; t < H; t += 32) {
        const int j = i - 1 - t;
        if (j < 0) break;
        if (!valid[j] || rev[j] != c_rev || rid[j] != c_rid) continue;
        const int dq = cq - qpos[j];
        const int dr = cr - rpos[j];
        if (dq <= 0 || dq > max_dist_x || dq > max_dist_y || dr <= 0 ||
            dr > max_dist_x)
          continue;
        const int dd = dr > dq ? dr - dq : dq - dr;
        if (dd > bw) continue;
        const int dg = dr < dq ? dr : dq;
        const int sj = span[j];
        int sc = dg < sj ? dg : sj;
        if (dd != 0 || dg > sj) {
          const float lin =
              __fadd_rn(__fmul_rn(pen_gap, __int2float_rn(dd)),
                        __fmul_rn(pen_skip, __int2float_rn(dg)));
          const float logp = dd >= 1 ? mg_log2f(__int2float_rn(dd + 1)) : 0.f;
          int pen = __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
          if (is_splice && dr > dq) pen = __float2int_rz(fminf(lin, logp));
          sc -= pen;
        }
        const long long cand = (long long)(f_s[j] + sc) * TWO32 + j;
        best = cand > best ? cand : best;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, best, o);
      best = other > best ? other : best;
    }
    if (lane == 0) {
      int fi = NEG_INF, pi = -1;
      if (cv) {
        fi = span[i];
        if (best != NONE) {
          const int j = (int)(best & 0xffffffffLL);
          const int tot = (int)((best - j) / TWO32);
          if (tot > fi) {
            fi = tot;
            pi = j;
          }
        }
      }
      f_s[i] = fi;
      f_out[base + i] = fi;
      p_out[base + i] = pi;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int chain_dp(const void* rev, const void* rid, const void* rpos,
                        const void* qpos, const void* valid, const void* span,
                        int B, int A, int H, int max_dist_x, int max_dist_y,
                        int bw, float pen_gap, float pen_skip, int is_splice,
                        void* f_out, void* p_out, void* stream) {
  const size_t smem = (size_t)A * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_dp_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int*)rev, (const int*)rid, (const int*)rpos, (const int*)qpos,
      (const uint8_t*)valid, (const int*)span, A, H, max_dist_x, max_dist_y,
      bw, pen_gap, pen_skip, is_splice, (int*)f_out, (int*)p_out);
  return (int)cudaGetLastError();
}
