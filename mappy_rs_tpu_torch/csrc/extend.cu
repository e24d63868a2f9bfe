// K3 — banded dual-affine-gap extension DP (ksw2 class) over
// anti-diagonals, emitting one direction byte per band cell.
//
// Replaces: mappy_rs_tpu/ops/extend_pallas.py _extend_pallas_device (the
// Pallas TPU kernel built by _make_kernel; wrappers extend_dp_pallas and
// extend_traceback_device).  Plain version: mappy_rs_tpu_torch/ops/extend.py
// extend_dp; wrapper: mappy_rs_tpu_torch/ops/extend_kernel.py.
//
// Semantics (all copied from the plain version): lane d of diagonal s is
// cell (i, j) = (lo + d, s - lo - d), lo = max(s/2 - W/2 + 1, 0) (s >= 0,
// so C division floors as Python's does); up/left come from diagonal s-1,
// the diagonal predecessor from s-2, each aligned by the change of lo;
// out-of-band neighbours read NEG; border rows H(-1, j-1) = -gap(j),
// H(i, -1) = -gap(i+1); ties M > E1 > E2 > F1 > F2 and continuation bits
// on strict >; cells outside the job (qlen == 0 or tlen == 0 for padded
// jobs) hold NEG and direction 0.  Trackers, output [J, 6]: best_sc,
// best_i, best_j (best cell: first diagonal, then lowest lane, strictly
// greater only), g_sc, g_j (same on the row i == qlen-1), end_sc (the
// cell (qlen-1, tlen-1)).
//
// What bounds it on the card: the chain of S = QMAX + TMAX - 1 dependent
// diagonals per job, one block barrier each.  The work (~40 integer ops
// per band cell) and the bytes (S*J*W direction bytes written) are small
// beside that chain at the main path's shapes: latency of one diagonal
// step, not bandwidth or ALU rate, sets the time.
//
// Design: one block per job, one thread per band lane (min(W, 1024)
// threads; above 1024 lanes a thread takes lanes d, d+T, ...).  The six
// state rows (H of s-1 and s-2, E1, E2, F1, F2 of s-1) live in shared
// memory with a NEG guard cell at each end, so the shifted neighbour reads
// need no branches; H rotates over three buffers and E/F over two, so one
// __syncthreads per diagonal suffices.  Where a W makes the rows larger
// than shared memory, the same rows live in a global scratch buffer the
// wrapper allocates (slower, but every W is taken).  Direction bytes go
// out per diagonal as W contiguous bytes (coalesced).  The last-row and
// end-cell trackers have at most one cell per diagonal, so the one thread
// that owns it updates them in shared memory; the best cell is tracked
// per thread and merged by one block reduction at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int ROWS = 11;  // 3 H buffers + 2 each for E1, E2, F1, F2

struct Params {
  int a, b, q, e, q2, e2, sc_ambi;
};

__device__ __forceinline__ int gap_cost(int l, const Params& p) {
  return min(p.q + l * p.e, p.q2 + l * p.e2);
}

// (value, diagonal, row) ordering of the best-cell tracker
struct Best {
  int v, s, i;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  if (x.v != y.v) return x.v > y.v;
  if (x.s != y.s) return x.s < y.s;
  return x.i < y.i;
}

__global__ void extend_kernel(const uint8_t* __restrict__ q,
                              const uint8_t* __restrict__ t,
                              const int* __restrict__ qlen_a,
                              const int* __restrict__ tlen_a, int J, int QMAX,
                              int TMAX, int W, Params p,
                              uint8_t* __restrict__ dirs,
                              int* __restrict__ best,
                              int* __restrict__ scratch) {
  extern __shared__ int dyn[];
  __shared__ int g_sc, g_j, end_sc;
  __shared__ Best wbest[32];
  const int job = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int WS = W + 2;
  int* rows = scratch ? scratch + (size_t)job * ROWS * WS : dyn;
  const int qlen = qlen_a[job], tlen = tlen_a[job];
  const int S = QMAX + TMAX - 1;
  const uint8_t* qj = q + (size_t)job * QMAX;
  const uint8_t* tj = t + (size_t)job * TMAX;
  for (int x = tid; x < ROWS * WS; x += T) rows[x] = NEG;
  if (tid == 0) {
    g_sc = NEG;
    g_j = 0;
    end_sc = NEG;
  }
  __syncthreads();

  Best mine = {NEG, 0, 0};
  bool have = false;
  int lo1 = 0, lo2 = 0;
  for (int s = 0; s < S; ++s) {
    const int lo = max(s / 2 - W / 2 + 1, 0);
    const int d1 = lo - lo1, d2 = lo - lo2;
    // +1: index -1 and W are the NEG guard cells
    const int* Hp = rows + ((s + 2) % 3) * WS + 1;   // H of s-1
    const int* Hpp = rows + ((s + 1) % 3) * WS + 1;  // H of s-2
    int* Hn = rows + (s % 3) * WS + 1;
    const int pg = (s + 1) & 1, ng = s & 1;
    int* Eb = rows + 3 * WS;
    const int* E1p = Eb + (0 + pg) * WS + 1;
    const int* E2p = Eb + (2 + pg) * WS + 1;
    const int* F1p = Eb + (4 + pg) * WS + 1;
    const int* F2p = Eb + (6 + pg) * WS + 1;
    int* E1n = Eb + (0 + ng) * WS + 1;
    int* E2n = Eb + (2 + ng) * WS + 1;
    int* F1n = Eb + (4 + ng) * WS + 1;
    int* F2n = Eb + (6 + ng) * WS + 1;
    uint8_t* drow = dirs + ((size_t)s * J + job) * W;
    for (int d = tid; d < W; d += T) {
      const int i = lo + d, j = s - i;
      const bool ok = i <= min(s, qlen - 1) && j >= 0 && j <= tlen - 1;
      int H = NEG, E1 = NEG, E2 = NEG, F1 = NEG, F2 = NEG;
      int dir = 0;
      if (ok) {
        const int qb = qj[min(i, QMAX - 1)], tb = tj[min(j, TMAX - 1)];
        const int pair =
            (qb == 4 || tb == 4) ? -p.sc_ambi : (qb == tb ? p.a : -p.b);
        int H_up, F1_up, F2_up, H_left, E1_left, E2_left, H_diag;
        if (d1 == 1) {
          H_up = Hp[d];
          F1_up = F1p[d];
          F2_up = F2p[d];
          H_left = Hp[d + 1];
          E1_left = E1p[d + 1];
          E2_left = E2p[d + 1];
        } else {
          H_up = Hp[d - 1];
          F1_up = F1p[d - 1];
          F2_up = F2p[d - 1];
          H_left = Hp[d];
          E1_left = E1p[d];
          E2_left = E2p[d];
        }
        H_diag = d2 == 2 ? Hpp[d + 1] : (d2 == 1 ? Hpp[d] : Hpp[d - 1]);
        const bool i0 = i == 0, j0 = j == 0;
        if (i0 && j0)
          H_diag = 0;
        else if (i0)
          H_diag = -gap_cost(j, p);
        else if (j0)
          H_diag = -gap_cost(i, p);
        if (j0) {
          H_left = -gap_cost(i + 1, p);
          E1_left = NEG;
          E2_left = NEG;
        }
        if (i0) {
          H_up = -gap_cost(j + 1, p);
          F1_up = NEG;
          F2_up = NEG;
        }
        const int e1o = H_left - p.q, e2o = H_left - p.q2;
        const int f1o = H_up - p.q, f2o = H_up - p.q2;
        E1 = max(E1_left, e1o) - p.e;
        E2 = max(E2_left, e2o) - p.e2;
        F1 = max(F1_up, f1o) - p.e;
        F2 = max(F2_up, f2o) - p.e2;
        dir = (E1_left > e1o ? 0x08 : 0) | (E2_left > e2o ? 0x10 : 0) |
              (F1_up > f1o ? 0x20 : 0) | (F2_up > f2o ? 0x40 : 0);
        H = H_diag + pair;
        int src = 0;
        if (E1 > H) { H = E1; src = 1; }
        if (E2 > H) { H = E2; src = 2; }
        if (F1 > H) { H = F1; src = 3; }
        if (F2 > H) { H = F2; src = 4; }
        dir |= src;
        if (H > mine.v) {
          mine.v = H;
          mine.s = s;
          mine.i = i;
          have = true;
        }
        if (i == qlen - 1) {
          if (H > g_sc) {
            g_sc = H;
            g_j = j;
          }
          if (j == tlen - 1) end_sc = max(end_sc, H);
        }
      }
      Hn[d] = H;
      E1n[d] = E1;
      E2n[d] = E2;
      F1n[d] = F1;
      F2n[d] = F2;
      drow[d] = (uint8_t)dir;
    }
    lo2 = lo1;
    lo1 = lo;
    __syncthreads();
  }

  // block-wide best cell: warp shuffles, then one warp over the leaders
  if (!have) mine = Best{NEG, 0x7fffffff, 0x7fffffff};
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(0xffffffffu, mine.v, off);
    o.s = __shfl_down_sync(0xffffffffu, mine.s, off);
    o.i = __shfl_down_sync(0xffffffffu, mine.i, off);
    if (better(o, mine)) mine = o;
  }
  if ((tid & 31) == 0) wbest[tid >> 5] = mine;
  __syncthreads();
  if (tid == 0) {
    Best b = wbest[0];
    for (int w = 1; w < (T + 31) / 32; ++w)
      if (better(wbest[w], b)) b = wbest[w];
    int* o = best + (size_t)job * 6;
    const bool upd = b.v > NEG;
    o[0] = upd ? b.v : NEG;
    o[1] = upd ? b.i : 0;
    o[2] = upd ? b.s - b.i : 0;
    o[3] = g_sc;
    o[4] = g_j;
    o[5] = end_sc;
  }
}

}  // namespace

extern "C" int extend_dp(const void* q, const void* t, const void* qlen,
                         const void* tlen, int J, int QMAX, int TMAX, int W,
                         int a, int b, int gap_q, int gap_e, int gap_q2,
                         int gap_e2, int sc_ambi, void* dirs, void* best,
                         void* scratch, void* stream) {
  if (J <= 0) return 0;
  if (W <= 0 || QMAX <= 0 || TMAX <= 0) return (int)cudaErrorInvalidValue;
  const int lanes32 = ((W + 31) / 32) * 32;
  const int threads = lanes32 < 1024 ? lanes32 : 1024;
  const size_t smem = scratch ? 0 : (size_t)ROWS * (W + 2) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Params p = {a, b, gap_q, gap_e, gap_q2, gap_e2, sc_ambi};
  extend_kernel<<<J, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen,
      (const int*)tlen, J, QMAX, TMAX, W, p, (uint8_t*)dirs, (int*)best,
      (int*)scratch);
  return (int)cudaGetLastError();
}
