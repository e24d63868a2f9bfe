// K4 — on-card traceback of K3's direction bytes into a run-length CIGAR.
//
// Replaces: mappy_rs_tpu/ops/traceback_pallas.py traceback_pallas (the
// Pallas TPU kernel built by _make_kernel).  Plain version and wrapper:
// mappy_rs_tpu_torch/ops/traceback.py.
//
// Per job: pick the start cell (mode 0, global: (qlen-1, tlen-1) with
// end_sc, active when end_sc > NEG/2; mode 1, extension: the last-row
// best (qlen-1, g_j) when g_sc > NEG/2, g_sc + end_bonus >= best_sc and
// g_sc > 0, else the best cell when best_sc > 0), then walk the direction
// bytes back until i < 0 or j < 0.  In state H a byte's source 0 is a
// match move (i-1, j-1), any other source enters that gap state on the
// same cell; in a gap state each step emits one D (E1/E2, j-1) or I
// (F1/F2, i-1) and leaves the state when the cell's continuation bit is
// clear.  A byte outside the band [0, W) reads 0.  Ops are run-length
// coded len<<4|op (0 M, 1 I, 2 D) in END->START order; a closed run past
// the table's OPS slots sets overflow and is dropped, the final open run
// is flushed the same way.  Info row: n_ops, final i, final j, score,
// started (score > NEG/2 and n_ops > 0), overflow, start i, start j.
//
// The Pallas kernel sweeps the diagonals backward for all jobs at once
// and moves each job when the sweep reaches its cell; a walk visits the
// same cells in the same order, since every step lowers i + j or changes
// the state once on a cell, so a plain per-job loop gives the same result.
//
// What bounds it on the card: each job's walk is a chain of dependent
// one-byte reads (qlen + tlen steps at most, ~1,000-2,000 on the main
// path).  Bytes and ops are tiny; the latency of one step sets the time.
//
// Design: one warp per job, TB_JOBS jobs per block, the walk's state
// held alike by every lane.  A step lowers s = i + j by at most 2, so the
// D diagonals at and below the current one hold the next D/2 steps or
// more.  The warp copies such a slab (D rows of the job's W bytes,
// contiguous in [S, J, W]) from device memory into shared memory with
// 16-byte cp.async while it walks the slab before (two buffers per
// warp).  The walk goes a run at a time: in state H lane k reads the
// cell k matches ahead (i-k, j-k), in a gap state the cell k gap ops
// ahead, and one ballot finds where the run ends (the first non-match,
// or the first cleared continuation bit); a cell not held in the slab
// or off the matrix ends the batch early.  So a step costs a share of
// one shared-memory read and one ballot, not a dependent load from
// device memory.  The wrapper picks D from W (ops/traceback.py
// slab_depth: about SLAB_BYTES per slab, D >= 2); D = 0 (bands too wide
// for two slabs per warp in shared memory, or rows that do not start
// 16-byte aligned, which the 16-byte copies need) reads device memory
// directly in the same batches.  The -1 pre-fill of the ops row is
// one warp-wide store sweep; lane 0 writes runs as they close.  The
// direction tensor stays where K3 wrote it, on the same stream: nothing
// is copied between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
constexpr int TB_JOBS = 4;  // jobs (warps) per block
constexpr unsigned FULL = 0xffffffffu;

// The run-length coder.  Every lane of the warp keeps the same copy (the
// walk is warp-uniform); lane 0 alone stores.
struct Runs {
  int* out;
  int OPS;
  bool store;
  int n_ops = 0, cur_op = -1, cur_len = 0, ovf = 0;

  __device__ __forceinline__ void flush() {
    if (cur_len > 0) {
      if (n_ops < OPS) {
        if (store) out[n_ops] = (cur_len << 4) | cur_op;
      } else {
        ovf = 1;
      }
      ++n_ops;
    }
  }
  // n >= 1 ops `op` in a row
  __device__ __forceinline__ void emit(int op, int n) {
    if (cur_op != op) {
      flush();
      cur_op = op;
      cur_len = 0;
    }
    cur_len += n;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the warp copies diagonals [max(lo, 0), lo + D) of this job into buf
// (row s - lo) by 16-byte cp.async (W % 16 == 0), committed as one group
__device__ __forceinline__ void load_slab(uint8_t* buf,
                                          const uint8_t* __restrict__ dirs,
                                          int lo, int D, int J, int job,
                                          int W, int lane) {
  const int s0 = max(lo, 0);
  const int rows = lo + D - s0;
  if (rows <= 0) return;
  uint8_t* dst = buf + (size_t)(s0 - lo) * W;
  const int per_row = W >> 4;
  for (int x = lane; x < rows * per_row; x += 32) {
    const int r = x / per_row, c = (x - r * per_row) << 4;
    cp_async16(dst + r * W + c, dirs + ((size_t)(s0 + r) * J + job) * W + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(TB_JOBS * 32)
    traceback_kernel(const uint8_t* __restrict__ dirs,
                     const int* __restrict__ best,
                     const int* __restrict__ qlen_a,
                     const int* __restrict__ tlen_a,
                     const int* __restrict__ mode_a, int S, int J, int W,
                     int OPS, int end_bonus, int D, int* __restrict__ ops,
                     int* __restrict__ info) {
  extern __shared__ __align__(16) uint8_t slabs[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int job = blockIdx.x * TB_JOBS + wib;
  if (job >= J) return;  // whole warps only
  const int* b = best + (size_t)job * 6;
  const int best_sc = b[0], best_i = b[1], best_j = b[2];
  const int g_sc = b[3], g_j = b[4], end_sc = b[5];
  const int qlen = qlen_a[job], tlen = tlen_a[job];
  int i0, j0, sc0;
  bool act;
  if (mode_a[job] == 0) {
    i0 = qlen - 1;
    j0 = tlen - 1;
    sc0 = end_sc;
    act = end_sc > NEG / 2;
  } else {
    const bool use_end =
        g_sc > NEG / 2 && g_sc + end_bonus >= best_sc && g_sc > 0;
    i0 = use_end ? qlen - 1 : best_i;
    j0 = use_end ? g_j : best_j;
    sc0 = use_end ? g_sc : best_sc;
    act = use_end || best_sc > 0;
  }
  int* out = ops + (size_t)job * OPS;
  for (int k = lane; k < OPS; k += 32) out[k] = -1;
  __syncwarp();  // the pre-fill lands before lane 0's runs
  Runs r;
  r.out = out;
  r.OPS = OPS;
  r.store = lane == 0;
  int i = i0, j = j0, st = 0;
  // a walk that starts outside [0, S) stops there, as the sweep does
  bool walking = act && i + j >= 0 && i + j < S;
  const int half = W / 2;
  const bool direct = D == 0;
  uint8_t* cur = slabs + (size_t)wib * 2 * D * W;
  uint8_t* nxt = cur + (size_t)D * W;
  // first diagonal of the current slab (direct: every diagonal is held)
  int slo = direct ? 0 : i + j - D + 1;
  if (walking && !direct) {
    load_slab(cur, dirs, slo, D, J, job, W, lane);
    cp_async_wait_all();
    __syncwarp();
    load_slab(nxt, dirs, slo - D, D, J, job, W, lane);
  }
  // byte of cell (ci, cs - ci) on diagonal cs, held in the slab or (direct)
  // read from device memory; outside the band it reads 0
  auto byte_at = [&](int ci, int cs) {
    const int d = ci - max((cs >> 1) - half + 1, 0);
    if (d < 0 || d >= W) return 0;
    return (int)(direct ? dirs[((size_t)cs * J + job) * W + d]
                        : cur[(size_t)(cs - slo) * W + d]);
  };
  while (walking) {  // warp-uniform: every lane holds the same walk state
    const int s = i + j;
    if (s < slo) {  // below the slab: the next one is in (or in flight)
      cp_async_wait_all();
      __syncwarp();  // every lane is done with the old slab
      uint8_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
      slo -= D;
      load_slab(nxt, dirs, slo - D, D, J, job, W, lane);
      continue;
    }
    if (st == 0) {
      // a run of matches: lane k reads cell (i-k, j-k) on diagonal s-2k;
      // the first lane whose cell is not held, off the matrix, or no
      // match ends the run
      const int ik = i - lane, jk = j - lane, sk = s - 2 * lane;
      const bool held = sk >= slo && ik >= 0 && jk >= 0;
      const int byte = held ? byte_at(ik, sk) : 0;
      const unsigned stop = __ballot_sync(FULL, !held || (byte & 7));
      const int n = stop ? __ffs(stop) - 1 : 32;
      if (n > 0) {
        r.emit(OP_M, n);
        i -= n;
        j -= n;
        walking = i >= 0 && j >= 0;
        continue;
      }
      st = __shfl_sync(FULL, byte, 0) & 7;  // enter the gap state here
    }
    // a gap run in state st: D (E1/E2) moves j-1, I (F1/F2 and above)
    // i-1; lane k reads the k-th cell from here on diagonal s-k.  Each
    // cell emits one op; the state stays while the cell's continuation
    // bit is set.
    const bool del = (unsigned)(st - 1) < 2u;
    const int ik = del ? i : i - lane, jk = del ? j - lane : j;
    const int sk = s - lane;
    const bool held = sk >= slo && ik >= 0 && jk >= 0;
    const int byte = held ? byte_at(ik, sk) : 0;
    const bool cont = byte & (0x04 << min(st, 4));
    const unsigned stop = __ballot_sync(FULL, !held || !cont);
    const int f = stop ? __ffs(stop) - 1 : 32;
    // cell f held: its bit is clear, it emits the run's last op and the
    // walk leaves the gap state; not held: the run goes on from there
    const bool closes = f < 32 && __shfl_sync(FULL, (int)held, f & 31);
    const int n = closes ? f + 1 : f;
    r.emit(del ? OP_D : OP_I, n);
    j -= del ? n : 0;
    i -= del ? 0 : n;
    st = closes ? 0 : st;
    walking = i >= 0 && j >= 0;
  }
  if (!direct) cp_async_wait_all();  // nothing in flight past the exit
  if (lane == 0) {
    r.flush();
    int* o = info + (size_t)job * 8;
    o[0] = r.n_ops;
    o[1] = i;
    o[2] = j;
    o[3] = sc0;
    o[4] = (sc0 > NEG / 2 && r.n_ops > 0) ? 1 : 0;
    o[5] = r.ovf;
    o[6] = i0;
    o[7] = j0;
  }
}

}  // namespace

// D: diagonals per slab (>= 2), or 0 to walk device memory directly (also
// taken where a row of W bytes does not start 16-byte aligned)
extern "C" int traceback_walk(const void* dirs, const void* best,
                              const void* qlen, const void* tlen,
                              const void* mode, int S, int J, int W, int OPS,
                              int end_bonus, int D, void* ops, void* info,
                              void* stream) {
  if (J <= 0) return 0;
  if (S <= 0 || W <= 0 || OPS <= 0 || D < 0 || D == 1)
    return (int)cudaErrorInvalidValue;
  if (W % 16 != 0 || ((uintptr_t)dirs & 15) != 0) D = 0;
  const size_t smem = (size_t)TB_JOBS * 2 * D * W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  traceback_kernel<<<(J + TB_JOBS - 1) / TB_JOBS, TB_JOBS * 32, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int*)best, (const int*)qlen,
      (const int*)tlen, (const int*)mode, S, J, W, OPS, end_bonus, D,
      (int*)ops, (int*)info);
  return (int)cudaGetLastError();
}
