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
// What bounds it on the card: the chain of dependent diagonals per job
// (S = QMAX + TMAX - 1 of them).  The work (~40 integer ops per band
// cell) and the bytes (S*J*W direction bytes written) are small beside
// that chain at the main path's shapes: the latency of one diagonal
// step, not bandwidth or ALU rate, sets the time.
//
// Two designs, chosen by W in the wrapper (ops/extend_kernel.py
// WARP_MAX_W; the flag `warp` of the C entry):
//
// Warp kernel (W = 32 * C up to 256: every band the pipeline makes): one
// warp per job, WARP_JOBS jobs per block, lane L owning the C consecutive
// band lanes d = L*C .. L*C+C-1.  The state of diagonal s-1 (H, E1, E2,
// F1, F2) and the H of s-2 stay in registers; the up/left neighbours of
// a lane's edge cell come from the next lane by one __shfl_sync per row
// (the direction is the change of lo, uniform across the warp), NEG at
// lane 0 / lane 31.  No block barrier runs in the diagonal loop.  Past the
// first ~W diagonals no cell is on row 0 or column 0 and lo rises by one
// on every even diagonal: there the loop runs two diagonals a turn with
// the shuffle directions and neighbour lanes fixed at compile time and
// no border code.  A band cell outside the job keeps what it computed
// (no job cell reads it), so only its direction byte and the trackers
// test it.  The job's bases are staged once into shared memory (global
// memory where WARP_JOBS * (QMAX + TMAX) passes BASES_SMEM) and the pair
// scores of diagonal s+1 are read while diagonal s computes, so no load
// sits on the serial chain.  Each lane stores its C direction bytes in
// one store where C is a power of two.  The trackers live in registers
// per lane and are merged by warp shuffles at the end.
// Diagonals past the job's last cell (qlen + tlen - 2) hold no cell: they
// are written as zeros without the DP.  A diagonal costs one warp about
// C * ~50 integer instructions: the serial issue of one warp, not memory,
// is the limit.  Past 8 lanes per thread that and the 6*C state registers
// grow beyond what one warp should carry, hence the switch at W = 256.
//
// Block kernel (any other W): one block per job, one thread per band lane
// (min(W, 1024) threads; above 1024 lanes a thread takes lanes d, d+T,
// ...).  The six state rows live in shared memory with a NEG guard cell
// at each end; H rotates over three buffers and E/F over two, so one
// __syncthreads per diagonal suffices.  Where a W makes the rows larger
// than shared memory, the same rows live in a global scratch buffer the
// wrapper allocates (slower, but every W is taken).  The last-row and
// end-cell trackers have at most one cell per diagonal, so the one
// thread that owns it updates them in shared memory; the best cell is
// tracked per thread and merged by one block reduction at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int ROWS = 11;  // block kernel: 3 H buffers + 2 each for E1, E2, F1, F2
constexpr int WARP_JOBS = 4;           // warp kernel: jobs (warps) per block
constexpr int WARP_MAX_C = 8;          // warp kernel: band lanes per thread
constexpr int BASES_SMEM = 48 * 1024;  // warp kernel: staged bases per block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int a, b, q, e, q2, e2, sc_ambi;
};

__device__ __forceinline__ int gap_cost(int l, const Params& p) {
  return min(p.q + l * p.e, p.q2 + l * p.e2);
}

__device__ __forceinline__ int band_lo(int s, int W) {
  return max(s / 2 - W / 2 + 1, 0);
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

// ------------------------------------------------------------ warp kernel

// pair scores of a lane's C cells on diagonal s (indices clamped: a cell
// outside the job is masked by its own test, whatever its bases)
template <int C>
__device__ __forceinline__ void pair_scores(const uint8_t* qs,
                                            const uint8_t* ts, int s, int d0,
                                            int W, int QMAX, int TMAX,
                                            const Params& p, int (&out)[C]) {
  const int lo = band_lo(s, W);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = lo + d0 + k, j = s - i;
    const int qb = qs[min(i, QMAX - 1)];
    const int tb = ts[min(max(j, 0), TMAX - 1)];
    out[k] = (qb == 4 || tb == 4) ? -p.sc_ambi : (qb == tb ? p.a : -p.b);
  }
}

// a lane's C direction bytes of one diagonal row: one store where C is a
// power of two (the row, W = 32 * C bytes, then starts C-aligned), else
// bytes
template <int C>
__device__ __forceinline__ void store_dirs(uint8_t* row, int d0,
                                           const int (&dir)[C]) {
  if constexpr ((C & (C - 1)) == 0) {
    if constexpr (C == 1) {
      row[d0] = (uint8_t)dir[0];
    } else if constexpr (C == 2) {
      *reinterpret_cast<uint16_t*>(row + d0) =
          (uint16_t)(dir[0] | (dir[1] << 8));
    } else if constexpr (C == 4) {
      *reinterpret_cast<uint32_t*>(row + d0) =
          (uint32_t)dir[0] | (uint32_t)dir[1] << 8 | (uint32_t)dir[2] << 16 |
          (uint32_t)dir[3] << 24;
    } else if constexpr (C == 8) {
      uint2 v;
      v.x = (uint32_t)dir[0] | (uint32_t)dir[1] << 8 |
            (uint32_t)dir[2] << 16 | (uint32_t)dir[3] << 24;
      v.y = (uint32_t)dir[4] | (uint32_t)dir[5] << 8 |
            (uint32_t)dir[6] << 16 | (uint32_t)dir[7] << 24;
      *reinterpret_cast<uint2*>(row + d0) = v;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) row[d0 + k] = (uint8_t)dir[k];
}

// copy n bytes into shared memory with the whole warp: 16 bytes a lane
// where both ends are 16-byte aligned, else one byte a lane; loads are
// issued four at a time ahead of their stores
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src, int n,
                                      int lane) {
  if (((uintptr_t)src & 15) == 0 && ((uintptr_t)dst & 15) == 0 &&
      (n & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int x = lane; x < n / 16; x += 32) d4[x] = s4[x];
  } else {
#pragma unroll 4
    for (int x = lane; x < n; x += 32) dst[x] = src[x];
  }
}

// The state a lane carries from diagonal to diagonal: H of s-1 and s-2,
// E1, E2, F1, F2 of s-1 for its C cells, and its trackers.
template <int C>
struct Lane {
  int H1[C], H2[C], E1[C], E2[C], F1[C], F2[C];
  int bv, bs, bi;  // best cell: value, diagonal, row
  int gv, gs;      // best cell of the row qlen-1: value, diagonal
};

// One diagonal of a lane's C cells.  MODE 0: any diagonal (the change of
// lo against s-1 and s-2 and the border rows read at run time); MODE 1 /
// 2: a diagonal with no border cell whose lo rose by one against s-1
// (1) or stayed (2), and by one against s-2 (both): the steady state
// past the first W diagonals, where the shuffles' direction and the
// neighbours' lanes are known when the kernel is compiled.
template <int C, int MODE>
__device__ __forceinline__ void diagonal(Lane<C>& L, const int (&pr)[C],
                                         int s, int lo, int lo1, int lo2,
                                         int lane, int d0, int qlen,
                                         int tlen, const Params& p,
                                         int (&dir)[C]) {
  const bool fw = MODE == 1 || (MODE == 0 && lo != lo1);
  const int dl2 = MODE == 0 ? lo - lo2 : 1;
  // lo rose by 1 against s-1: up is the same lane d, left is d+1 (from
  // the next thread at the lane edge); else up is d-1, left is d
  const int src = (fw ? lane + 1 : lane - 1) & 31;
  const bool edge = fw ? lane == 31 : lane == 0;
  int nH = __shfl_sync(FULL, fw ? L.H1[0] : L.H1[C - 1], src);
  int nA = __shfl_sync(FULL, fw ? L.E1[0] : L.F1[C - 1], src);
  int nB = __shfl_sync(FULL, fw ? L.E2[0] : L.F2[C - 1], src);
  nH = edge ? NEG : nH;
  nA = edge ? NEG : nA;
  nB = edge ? NEG : nB;
  // the diagonal predecessor on s-2: d-1, d or d+1 by the change of lo
  int nD = NEG;
  if (MODE == 0 && dl2 != 1) {  // warp-uniform
    const bool fw2 = dl2 == 2;
    nD = __shfl_sync(FULL, fw2 ? L.H2[0] : L.H2[C - 1],
                     (fw2 ? lane + 1 : lane - 1) & 31);
    nD = (fw2 ? lane == 31 : lane == 0) ? NEG : nD;
  }
  int Hn[C], E1n[C], E2n[C], F1n[C], F2n[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int km = k > 0 ? k - 1 : 0, kp = k < C - 1 ? k + 1 : C - 1;
    const int i = lo + d0 + k, j = s - i;
    // inside the job: i >= lo >= 0, and i <= s is j >= 0
    const bool ok = i < qlen && (unsigned)j < (unsigned)tlen;
    int H_up = fw ? L.H1[k] : (k > 0 ? L.H1[km] : nH);
    int F1_up = fw ? L.F1[k] : (k > 0 ? L.F1[km] : nA);
    int F2_up = fw ? L.F2[k] : (k > 0 ? L.F2[km] : nB);
    int H_left = fw ? (k < C - 1 ? L.H1[kp] : nH) : L.H1[k];
    int E1_left = fw ? (k < C - 1 ? L.E1[kp] : nA) : L.E1[k];
    int E2_left = fw ? (k < C - 1 ? L.E2[kp] : nB) : L.E2[k];
    int H_diag = dl2 == 1 ? L.H2[k]
                 : dl2 == 2 ? (k < C - 1 ? L.H2[kp] : nD)
                            : (k > 0 ? L.H2[km] : nD);
    if (MODE == 0) {  // border rows: H(-1, j-1) = -gap(j), H(i, -1) = -gap(i+1)
      const bool i0 = i == 0, j0 = j == 0;
      H_diag = i0 && j0 ? 0
               : i0     ? -gap_cost(j, p)
               : j0     ? -gap_cost(i, p)
                        : H_diag;
      H_left = j0 ? -gap_cost(i + 1, p) : H_left;
      E1_left = j0 ? NEG : E1_left;
      E2_left = j0 ? NEG : E2_left;
      H_up = i0 ? -gap_cost(j + 1, p) : H_up;
      F1_up = i0 ? NEG : F1_up;
      F2_up = i0 ? NEG : F2_up;
    }
    const int e1o = H_left - p.q, e2o = H_left - p.q2;
    const int f1o = H_up - p.q, f2o = H_up - p.q2;
    const int e1 = max(E1_left, e1o) - p.e;
    const int e2 = max(E2_left, e2o) - p.e2;
    const int f1 = max(F1_up, f1o) - p.e;
    const int f2 = max(F2_up, f2o) - p.e2;
    const int h0 = H_diag + pr[k];
    const int H = max(max(h0, e1), max(e2, max(f1, f2)));
    // the source: the first of M, E1, E2, F1, F2 that reaches H (ties
    // go M > E1 > E2 > F1 > F2, as strict > updates in that order give)
    const int srcb = h0 == H ? 0 : e1 == H ? 1 : e2 == H ? 2 : f1 == H ? 3 : 4;
    const int cont = (E1_left > e1o ? 0x08 : 0) | (E2_left > e2o ? 0x10 : 0) |
                     (F1_up > f1o ? 0x20 : 0) | (F2_up > f2o ? 0x40 : 0);
    // A band cell outside the job keeps what it computed: no cell of the
    // job reads it (up, left and diagonal neighbours of a job cell are
    // job cells, border rows or out of the band), so only its direction
    // byte and the trackers need the test.
    Hn[k] = H;
    E1n[k] = e1;
    E2n[k] = e2;
    F1n[k] = f1;
    F2n[k] = f2;
    dir[k] = ok ? (srcb | cont) : 0;
    // a lane sees its cells diagonal by diagonal, rows ascending: strict
    // > keeps the first diagonal, then the lowest row
    const bool ub = ok && H > L.bv;
    L.bv = ub ? H : L.bv;
    L.bs = ub ? s : L.bs;
    L.bi = ub ? i : L.bi;
    const bool ug = ok && i == qlen - 1 && H > L.gv;
    L.gv = ug ? H : L.gv;
    L.gs = ug ? s : L.gs;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    L.H2[k] = L.H1[k];
    L.H1[k] = Hn[k];
    L.E1[k] = E1n[k];
    L.E2[k] = E2n[k];
    L.F1[k] = F1n[k];
    L.F2[k] = F2n[k];
  }
}

// W == 32 * C.  SMEM: the bases staged in shared memory (read with
// shared-memory loads)
template <int C, bool SMEM>
__global__ void __launch_bounds__(WARP_JOBS * 32)
    extend_warp_kernel(const uint8_t* __restrict__ q,
                       const uint8_t* __restrict__ t,
                       const int* __restrict__ qlen_a,
                       const int* __restrict__ tlen_a, int J, int QMAX,
                       int TMAX, int W, Params p, uint8_t* __restrict__ dirs,
                       int* __restrict__ best) {
  extern __shared__ __align__(16) uint8_t bases[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int job = blockIdx.x * WARP_JOBS + wib;
  if (job >= J) return;  // whole warps only: no block barrier follows
  const int qlen = qlen_a[job], tlen = tlen_a[job];
  const int S = QMAX + TMAX - 1;
  const uint8_t* qs = q + (size_t)job * QMAX;
  const uint8_t* ts = t + (size_t)job * TMAX;
  if (SMEM) {
    uint8_t* mine = bases + (size_t)wib * (QMAX + TMAX);
    stage(mine, qs, QMAX, lane);
    stage(mine + QMAX, ts, TMAX, lane);
    __syncwarp();
    qs = mine;
    ts = mine + QMAX;
  }
  // the last diagonal that holds a cell of the job is qlen + tlen - 2
  const int s_end = (qlen > 0 && tlen > 0) ? min(S, qlen + tlen - 1) : 0;
  const int d0 = lane * C;
  const size_t row_step = (size_t)J * W;
  uint8_t* row = dirs + (size_t)job * W;  // diagonal s's bytes of this job
  Lane<C> L;
#pragma unroll
  for (int k = 0; k < C; ++k)
    L.H1[k] = L.H2[k] = L.E1[k] = L.E2[k] = L.F1[k] = L.F2[k] = NEG;
  L.bv = NEG;
  L.bs = L.bi = 0;
  L.gv = NEG;
  L.gs = 0;
  int pr[C], prn[C], dir[C];
  int lo1 = 0, lo2 = 0, s = 0;
  if (s_end > 0) pair_scores<C>(qs, ts, 0, d0, W, QMAX, TMAX, p, pr);
  // the first diagonals: row 0 or column 0 in the band, or lo not yet
  // one above that of s-2
  for (; s < s_end; ++s) {
    const int lo = band_lo(s, W);
    if (lo > 0 && s - lo >= W && lo - lo2 == 1) break;
    // the next diagonal's bases, off the serial chain
    pair_scores<C>(qs, ts, s + 1, d0, W, QMAX, TMAX, p, prn);
    diagonal<C, 0>(L, pr, s, lo, lo1, lo2, lane, d0, qlen, tlen, p, dir);
    store_dirs<C>(row, d0, dir);
    row += row_step;
#pragma unroll
    for (int k = 0; k < C; ++k) pr[k] = prn[k];
    lo2 = lo1;
    lo1 = lo;
  }
  // the steady state, for good: lo rises by one on every even diagonal
  // (mode 1) and stays on every odd one (mode 2); two diagonals a turn
  // keep the state and the bases in the same registers
  auto even = [&](int s, const int (&a)[C], int (&b)[C]) {
    pair_scores<C>(qs, ts, s + 1, d0, W, QMAX, TMAX, p, b);
    diagonal<C, 1>(L, a, s, band_lo(s, W), 0, 0, lane, d0, qlen, tlen, p,
                   dir);
    store_dirs<C>(row, d0, dir);
    row += row_step;
  };
  auto odd = [&](int s, const int (&a)[C], int (&b)[C]) {
    pair_scores<C>(qs, ts, s + 1, d0, W, QMAX, TMAX, p, b);
    diagonal<C, 2>(L, a, s, band_lo(s, W), 0, 0, lane, d0, qlen, tlen, p,
                   dir);
    store_dirs<C>(row, d0, dir);
    row += row_step;
  };
  if (s < s_end && (s & 1)) {
    odd(s, pr, prn);
#pragma unroll
    for (int k = 0; k < C; ++k) pr[k] = prn[k];
    ++s;
  }
  for (; s + 1 < s_end; s += 2) {
    even(s, pr, prn);
    odd(s + 1, prn, pr);
  }
  if (s < s_end) even(s, pr, prn);
  // the end cell (qlen-1, tlen-1) lies on the last diagonal computed,
  // s_end - 1, whose H the lanes still hold
  int ev = NEG;
  if (s_end > 0) {
    const int dend = qlen - 1 - band_lo(s_end - 1, W);
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (d0 + k == dend) ev = max(ev, L.H1[k]);
  }
  // diagonals without a cell of the job: direction 0
#pragma unroll
  for (int k = 0; k < C; ++k) dir[k] = 0;
  for (int s = s_end; s < S; ++s, row += row_step) store_dirs<C>(row, d0, dir);

  // merge the lanes' trackers: best (value desc, diagonal asc, row asc),
  // last row (value desc, diagonal asc), end cell (max); a lane that
  // never updated holds NEG and loses every comparison that matters
  Best mine = {L.bv, L.bs, L.bi};
  int gv = L.gv, gs = L.gs;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(FULL, mine.v, off);
    o.s = __shfl_xor_sync(FULL, mine.s, off);
    o.i = __shfl_xor_sync(FULL, mine.i, off);
    if (better(o, mine)) mine = o;
    const int ov = __shfl_xor_sync(FULL, gv, off);
    const int os = __shfl_xor_sync(FULL, gs, off);
    if (ov > gv || (ov == gv && os < gs)) {
      gv = ov;
      gs = os;
    }
    ev = max(ev, __shfl_xor_sync(FULL, ev, off));
  }
  if (lane == 0) {
    int* o = best + (size_t)job * 6;
    const bool upd = mine.v > NEG;
    o[0] = upd ? mine.v : NEG;
    o[1] = upd ? mine.i : 0;
    o[2] = upd ? mine.s - mine.i : 0;
    o[3] = gv;
    o[4] = gv > NEG ? gs - (qlen - 1) : 0;
    o[5] = ev;
  }
}

// W == 32 * C; the staged bases where they fit, else device memory
template <int C>
cudaError_t launch_warp(const uint8_t* q, const uint8_t* t, const int* qlen,
                        const int* tlen, int J, int QMAX, int TMAX, int W,
                        const Params& p, uint8_t* dirs, int* best,
                        cudaStream_t stream) {
  const int blocks = (J + WARP_JOBS - 1) / WARP_JOBS, threads = WARP_JOBS * 32;
  const size_t bases = (size_t)WARP_JOBS * (QMAX + TMAX);
  if (bases <= (size_t)BASES_SMEM)
    extend_warp_kernel<C, true><<<blocks, threads, bases, stream>>>(
        q, t, qlen, tlen, J, QMAX, TMAX, W, p, dirs, best);
  else
    extend_warp_kernel<C, false><<<blocks, threads, 0, stream>>>(
        q, t, qlen, tlen, J, QMAX, TMAX, W, p, dirs, best);
  return cudaGetLastError();
}

// ----------------------------------------------------------- block kernel

__global__ void extend_block_kernel(const uint8_t* __restrict__ q,
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

// warp = 1: the warp kernel (W = 32 * C, C <= WARP_MAX_C); warp = 0: the
// block kernel (any W; scratch != null keeps its rows in global memory)
extern "C" int extend_dp(const void* q, const void* t, const void* qlen,
                         const void* tlen, int J, int QMAX, int TMAX, int W,
                         int a, int b, int gap_q, int gap_e, int gap_q2,
                         int gap_e2, int sc_ambi, void* dirs, void* best,
                         void* scratch, int warp, void* stream) {
  if (J <= 0) return 0;
  if (W <= 0 || QMAX <= 0 || TMAX <= 0) return (int)cudaErrorInvalidValue;
  const Params p = {a, b, gap_q, gap_e, gap_q2, gap_e2, sc_ambi};
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* qq = (const uint8_t*)q;
  const uint8_t* tt = (const uint8_t*)t;
  const int* ql = (const int*)qlen;
  const int* tl = (const int*)tlen;
  uint8_t* dd = (uint8_t*)dirs;
  int* bb = (int*)best;
  if (warp) {
    if (W % 32 != 0 || W / 32 > WARP_MAX_C) return (int)cudaErrorInvalidValue;
    switch (W / 32) {
      case 1: return (int)launch_warp<1>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 2: return (int)launch_warp<2>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 3: return (int)launch_warp<3>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 4: return (int)launch_warp<4>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 5: return (int)launch_warp<5>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 6: return (int)launch_warp<6>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 7: return (int)launch_warp<7>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      case 8: return (int)launch_warp<8>(qq, tt, ql, tl, J, QMAX, TMAX, W, p, dd, bb, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int lanes32 = ((W + 31) / 32) * 32;
  const int threads = lanes32 < 1024 ? lanes32 : 1024;
  const size_t smem = scratch ? 0 : (size_t)ROWS * (W + 2) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        extend_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  extend_block_kernel<<<J, threads, smem, st>>>(qq, tt, ql, tl, J, QMAX,
                                               TMAX, W, p, dd, bb,
                                               (int*)scratch);
  return (int)cudaGetLastError();
}
