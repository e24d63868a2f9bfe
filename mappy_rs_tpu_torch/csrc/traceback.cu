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
// one-byte loads from the direction tensor (qlen + tlen steps at most,
// ~1,000-2,000 on the main path).  Bytes and ops are tiny; latency of one
// step sets the time.
//
// Design: one thread per job (32 jobs per block), no shared memory; the
// ops row is written in place as runs close.  The direction tensor stays
// where K3 wrote it, on the same stream: nothing is copied between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;

struct Runs {
  int* out;
  int OPS;
  int n_ops = 0, cur_op = -1, cur_len = 0, ovf = 0;

  __device__ void flush() {
    if (cur_len > 0) {
      if (n_ops < OPS)
        out[n_ops] = (cur_len << 4) | cur_op;
      else
        ovf = 1;
      ++n_ops;
    }
  }
  __device__ void emit(int op) {
    if (cur_op == op) {
      ++cur_len;
      return;
    }
    flush();
    cur_op = op;
    cur_len = 1;
  }
};

__global__ void traceback_kernel(const uint8_t* __restrict__ dirs,
                                 const int* __restrict__ best,
                                 const int* __restrict__ qlen_a,
                                 const int* __restrict__ tlen_a,
                                 const int* __restrict__ mode_a, int S, int J,
                                 int W, int OPS, int end_bonus,
                                 int* __restrict__ ops, int* __restrict__ info) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= J) return;
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
  Runs r;
  r.out = ops + (size_t)job * OPS;
  r.OPS = OPS;
  for (int k = 0; k < OPS; ++k) r.out[k] = -1;

  int i = i0, j = j0, st = 0;
  while (act) {
    const int s = i + j;
    if (s < 0 || s >= S) break;  // never swept by the Pallas kernel either
    const int lo = max(s / 2 - W / 2 + 1, 0);
    const int d = i - lo;
    const int byte =
        (d >= 0 && d < W) ? dirs[((size_t)s * J + job) * W + d] : 0;
    bool moved = false;
    if (st == 0) {
      const int src = byte & 7;
      if (src == 0) {
        r.emit(OP_M);
        --i;
        --j;
        moved = true;
      } else {
        st = src;
      }
    }
    if (!moved) {  // gap state: one op on this cell, same byte
      if (st <= 2) {
        r.emit(OP_D);
        --j;
        if (!(byte & (st == 1 ? 0x08 : 0x10))) st = 0;
      } else {
        r.emit(OP_I);
        --i;
        if (!(byte & (st == 3 ? 0x20 : 0x40))) st = 0;
      }
    }
    if (i < 0 || j < 0) act = false;
  }
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

}  // namespace

extern "C" int traceback_walk(const void* dirs, const void* best,
                              const void* qlen, const void* tlen,
                              const void* mode, int S, int J, int W, int OPS,
                              int end_bonus, void* ops, void* info,
                              void* stream) {
  if (J <= 0) return 0;
  if (S <= 0 || W <= 0 || OPS <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  traceback_kernel<<<(J + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int*)best, (const int*)qlen,
      (const int*)tlen, (const int*)mode, S, J, W, OPS, end_bonus, (int*)ops,
      (int*)info);
  return (int)cudaGetLastError();
}
