// Native host-side inner loops for mappy_rs_tpu_torch (a copy of the
// JAX package's native/mappy_native.cc; the two stay identical in
// behaviour).
//
// TPU-native counterpart of the native runtime the reference gets from
// Rust/C (SURVEY.md §2b): the device produces packed traceback
// direction bytes (ops/extend.py); the strictly-sequential O(path)
// walks, base encoding and tag generation run here instead of Python.
// Loaded via ctypes (native/__init__.py) with a pure-numpy fallback.
//
// Build: built at first use by mappy_rs_tpu_torch/native/__init__.py
// (g++ -O3 -march=native -fPIC -shared -std=c++17) into _build/.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#if defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define MAPPY_AVX512 1
#endif

namespace {

// direction byte layout (must match ops/extend.py)
constexpr uint8_t H_SRC_MASK = 0x07;
constexpr uint8_t E1_CONT = 0x08;
constexpr uint8_t E2_CONT = 0x10;
constexpr uint8_t F1_CONT = 0x20;
constexpr uint8_t F2_CONT = 0x40;

inline int band_lo(int s, int qlen, int tlen, int W) {
  // static anti-diagonal band; must match ops/extend.py band_lo_host
  (void)qlen;
  (void)tlen;
  long lo = (long)(s / 2) - W / 2 + 1;
  return lo < 0 ? 0 : (int)lo;
}

}  // namespace

extern "C" {

// ASCII -> 0..4 base codes
void encode_ascii(const char* s, int64_t n, uint8_t* out) {
  static uint8_t table[256];
  static bool init = false;
  if (!init) {
    memset(table, 4, sizeof(table));
    table['A'] = table['a'] = 0;
    table['C'] = table['c'] = 1;
    table['G'] = table['g'] = 2;
    table['T'] = table['t'] = 3;
    table['U'] = table['u'] = 3;
    init = true;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = table[(uint8_t)s[i]];
}

// Walk packed traceback directions for a batch of DP jobs.
//   dirs:   [S, J, W] uint8 (diag-major, job, band-lane)
//   out_ops: per job, up to max_ops (len, op) pairs packed len<<4|op,
//            written from alignment START; out_n = count (-1 overflow)
void traceback_batch(const uint8_t* dirs, int S, int J, int W,
                     const int32_t* qlen, const int32_t* tlen,
                     const int32_t* start_i, const int32_t* start_j,
                     int32_t* out_ops, int32_t* out_n, int max_ops) {
  for (int job = 0; job < J; ++job) {
    int32_t* ops = out_ops + (int64_t)job * max_ops;
    int n_ops = 0;
    bool overflow = false;
    int ql = qlen[job], tl = tlen[job];
    int i = start_i[job], j = start_j[job];
    int state = 0;  // 0=M 1=E1 2=E2 3=F1 4=F2
    auto emit = [&](int op, int cnt) {
      if (n_ops > 0 && (ops[n_ops - 1] & 0xF) == op) {
        ops[n_ops - 1] += cnt << 4;
      } else if (n_ops < max_ops) {
        ops[n_ops++] = (cnt << 4) | op;
      } else {
        overflow = true;
      }
    };
    while (i >= 0 && j >= 0 && !overflow) {
      int s = i + j;
      int d = i - band_lo(s, ql, tl, W);
      uint8_t byte = 0;
      if (d >= 0 && d < W && s < S)
        byte = dirs[((int64_t)s * J + job) * W + d];
      if (state == 0) {
        int src = byte & H_SRC_MASK;
        if (src == 0) {
          emit(0, 1);
          --i;
          --j;
        } else {
          state = src;
        }
      } else if (state == 1 || state == 2) {
        emit(2, 1);  // D consumes ref
        bool cont = byte & (state == 1 ? E1_CONT : E2_CONT);
        --j;
        if (!cont) state = 0;
      } else {
        emit(1, 1);  // I consumes query
        bool cont = byte & (state == 3 ? F1_CONT : F2_CONT);
        --i;
        if (!cont) state = 0;
      }
    }
    if (i >= 0) emit(1, i + 1);
    if (j >= 0) emit(2, j + 1);
    // reverse to alignment-start order
    for (int a = 0, b = n_ops - 1; a < b; ++a, --b)
      std::swap(ops[a], ops[b]);
    out_n[job] = overflow ? -1 : n_ops;
  }
}

// Small-job dual-affine DP, host-side (flank extensions are typically
// a few dozen bases; a full O(Q*T) DP here beats a device dispatch).
// Scoring/precedence/tie rules replicate ops/extend.py exactly:
// H = max(M, E1, E2, F1, F2) with strictly-greater updates in that
// order; gap-continue flags use strict '>'; extension trackers scan
// anti-diagonals ascending with lowest-i tie break per diagonal and
// strictly-greater across diagonals.
//   mode 0 = global (traceback from (qlen-1, tlen-1))
//   mode 1 = extension (end_bonus rule picks the cell)
// out per job: n_ops ops packed len<<4|op (start order), then
// [score, q_consumed, t_consumed] in out_info[3*job..].
void extend_small_batch(const uint8_t* qs, const uint8_t* ts,
                        const int32_t* qlen, const int32_t* tlen,
                        int J, int QSTRIDE, int TSTRIDE,
                        int a, int b, int gq, int ge, int gq2, int ge2,
                        int sc_ambi, int end_bonus, int mode,
                        int32_t* out_ops, int32_t* out_n, int max_ops,
                        int32_t* out_info) {
  const int NEGI = -(1 << 28);
  for (int job = 0; job < J; ++job) {
    int Q = qlen[job], T = tlen[job];
    const uint8_t* q = qs + (int64_t)job * QSTRIDE;
    const uint8_t* t = ts + (int64_t)job * TSTRIDE;
    int32_t* ops = out_ops + (int64_t)job * max_ops;
    int32_t* info = out_info + (int64_t)job * 3;
    out_n[job] = 0;
    info[0] = info[1] = info[2] = 0;
    if (Q <= 0 || T <= 0) continue;
    // dense DP with direction bytes
    std::vector<int32_t> H((Q + 1) * (T + 1), NEGI), E1v = H, E2v = H,
        F1v = H, F2v = H;
    std::vector<uint8_t> dir((int64_t)Q * T, 0);
    auto gap = [&](long l) {
      long g1 = gq + l * ge, g2 = gq2 + l * ge2;
      return (int32_t)(g1 < g2 ? g1 : g2);
    };
    auto at = [&](std::vector<int32_t>& m, int i, int j) -> int32_t& {
      return m[(int64_t)i * (T + 1) + j];
    };
    H[0] = 0;
    for (int j = 1; j <= T; ++j) at(H, 0, j) = -gap(j);
    for (int i = 1; i <= Q; ++i) at(H, i, 0) = -gap(i);
    for (int i = 1; i <= Q; ++i) {
      for (int j = 1; j <= T; ++j) {
        int32_t e1o = at(H, i, j - 1) - gq;
        int32_t e1p = at(E1v, i, j - 1);
        int32_t e1 = (e1p > e1o ? e1p : e1o) - ge;
        uint8_t e1c = e1p > e1o ? E1_CONT : 0;
        int32_t e2o = at(H, i, j - 1) - gq2;
        int32_t e2p = at(E2v, i, j - 1);
        int32_t e2 = (e2p > e2o ? e2p : e2o) - ge2;
        uint8_t e2c = e2p > e2o ? E2_CONT : 0;
        int32_t f1o = at(H, i - 1, j) - gq;
        int32_t f1p = at(F1v, i - 1, j);
        int32_t f1 = (f1p > f1o ? f1p : f1o) - ge;
        uint8_t f1c = f1p > f1o ? F1_CONT : 0;
        int32_t f2o = at(H, i - 1, j) - gq2;
        int32_t f2p = at(F2v, i - 1, j);
        int32_t f2 = (f2p > f2o ? f2p : f2o) - ge2;
        uint8_t f2c = f2p > f2o ? F2_CONT : 0;
        int qc = q[i - 1], tc = t[j - 1];
        int32_t pair = (qc == 4 || tc == 4) ? -sc_ambi : (qc == tc ? a : -b);
        int32_t h = at(H, i - 1, j - 1) + pair;
        uint8_t src = 0;
        if (e1 > h) { h = e1; src = 1; }
        if (e2 > h) { h = e2; src = 2; }
        if (f1 > h) { h = f1; src = 3; }
        if (f2 > h) { h = f2; src = 4; }
        at(H, i, j) = h;
        at(E1v, i, j) = e1;
        at(E2v, i, j) = e2;
        at(F1v, i, j) = f1;
        at(F2v, i, j) = f2;
        dir[(int64_t)(i - 1) * T + (j - 1)] = src | e1c | e2c | f1c | f2c;
      }
    }
    // trackers in (diagonal asc, i asc) order to match the device tie rules
    int32_t best_sc = NEGI, best_i = 0, best_j = 0, g_sc = NEGI, g_j = 0;
    for (int s = 0; s < Q + T - 1; ++s) {
      int ilo = s - (T - 1) > 0 ? s - (T - 1) : 0;
      int ihi = s < Q - 1 ? s : Q - 1;
      for (int i = ilo; i <= ihi; ++i) {
        int j = s - i;
        int32_t h = at(H, i + 1, j + 1);
        if (h > best_sc) { best_sc = h; best_i = i; best_j = j; }
        if (i == Q - 1 && h > g_sc) { g_sc = h; g_j = j; }
      }
    }
    int32_t end_sc = at(H, Q, T);
    // pick traceback cell
    int si, sj, sc;
    if (mode == 0) {
      si = Q - 1; sj = T - 1; sc = end_sc;
    } else {
      bool use_end = g_sc > NEGI / 2 && g_sc + end_bonus >= best_sc;
      if (use_end && g_sc > 0) { si = Q - 1; sj = g_j; sc = g_sc; }
      else if (best_sc > 0) { si = best_i; sj = best_j; sc = best_sc; }
      else { continue; }  // no positive extension
    }
    // traceback (same state machine as traceback_batch)
    int n_ops = 0;
    bool overflow = false;
    auto emit = [&](int op, int cnt) {
      if (n_ops > 0 && (ops[n_ops - 1] & 0xF) == op) ops[n_ops - 1] += cnt << 4;
      else if (n_ops < max_ops) ops[n_ops++] = (cnt << 4) | op;
      else overflow = true;
    };
    int i = si, j = sj, state = 0;
    while (i >= 0 && j >= 0 && !overflow) {
      uint8_t byte = dir[(int64_t)i * T + j];
      if (state == 0) {
        int src = byte & H_SRC_MASK;
        if (src == 0) { emit(0, 1); --i; --j; }
        else state = src;
      } else if (state == 1 || state == 2) {
        emit(2, 1);
        bool cont = byte & (state == 1 ? E1_CONT : E2_CONT);
        --j;
        if (!cont) state = 0;
      } else {
        emit(1, 1);
        bool cont = byte & (state == 3 ? F1_CONT : F2_CONT);
        --i;
        if (!cont) state = 0;
      }
    }
    if (i >= 0) emit(1, i + 1);
    if (j >= 0) emit(2, j + 1);
    for (int x = 0, y = n_ops - 1; x < y; ++x, --y) std::swap(ops[x], ops[y]);
    out_n[job] = overflow ? -1 : n_ops;
    info[0] = sc;
    info[1] = si + 1;
    info[2] = sj + 1;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Splice-aware DP (ksw_exts2-class): match/mismatch + one affine gap
// pair + an intron state (open q2 + donor penalty, zero per-base,
// close + acceptor penalty) emitting BAM N ops.  Scoring model, signal
// motifs, and every tie rule are EXACTLY ops/splice.py's (the python
// oracle); tests/test_splice.py asserts bit-identical output.

namespace {

// per-position donor/acceptor penalties (ops/splice.py
// splice_site_tables): sense +1 = GT..AG, -1 = CT..AC; reversed_seq
// matches the reversed images (left flanks run on reversed sequences).
void splice_tables(const uint8_t* t, int T, int sense, int flank,
                   int noncan, int reversed_seq, std::vector<int32_t>& don,
                   std::vector<int32_t>& acc) {
  don.assign(T, noncan);
  acc.assign(T, noncan);
  int o0, o1, of0, of1, c0, c1, cf0, cf1;
  if (!reversed_seq) {
    o0 = sense > 0 ? 2 : 1; o1 = 3; of0 = 0; of1 = 2;   // GT(R) / CT(R)
    c0 = 0; c1 = sense > 0 ? 2 : 1; cf0 = 1; cf1 = 3;   // (Y)AG / (Y)AC
  } else {
    o0 = sense > 0 ? 2 : 1; o1 = 0; of0 = 1; of1 = 3;   // GA(Y) / CA(Y)
    c0 = 3; c1 = sense > 0 ? 2 : 1; cf0 = 0; cf1 = 2;   // (R)TG / (R)TC
  }
  auto at = [&](int j) -> int { return (j < 0 || j >= T) ? 4 : t[j]; };
  for (int j = 0; j < T; ++j) {
    bool open2 = at(j) == o0 && at(j + 1) == o1;
    bool close2 = at(j - 1) == c0 && at(j) == c1;
    if (flank) {
      bool ofull = open2 && (at(j + 2) == of0 || at(j + 2) == of1);
      bool cfull = close2 && (at(j - 2) == cf0 || at(j - 2) == cf1);
      don[j] = ofull ? 0 : (open2 ? noncan / 2 : noncan);
      acc[j] = cfull ? 0 : (close2 ? noncan / 2 : noncan);
    } else {
      don[j] = open2 ? 0 : noncan;
      acc[j] = close2 ? 0 : noncan;
    }
  }
}

// direction byte layout (ops/splice.py)
constexpr uint8_t SPL_SRC_MASK = 0x03;  // 0=M 1=E(D) 2=F(I) 3=A(N)
constexpr uint8_t SPL_E_CONT = 0x04;
constexpr uint8_t SPL_F_CONT = 0x08;
constexpr uint8_t SPL_A_CONT = 0x10;

}  // namespace

extern "C" {

// mode 2 = global (both ends pinned), 1 = extension (best cell with
// the end-bonus full-query rule).  out_info[3*job..] = [score,
// q_consumed, t_consumed]; out_n = -1 on ops overflow.
void splice_align_batch(const uint8_t* qs, const uint8_t* ts,
                        const int32_t* qlen, const int32_t* tlen, int J,
                        int QSTRIDE, int TSTRIDE, int a, int b, int gapo,
                        int gape, int q2, int noncan, int sc_ambi,
                        int end_bonus, int mode, int sense, int flank,
                        int reversed_seq, int32_t* out_ops, int32_t* out_n,
                        int max_ops, int32_t* out_info) {
  const int32_t NEGI = -(1 << 28);
  std::vector<int32_t> don, acc, H, Hp, E, Ai, F, Fp;
  std::vector<uint8_t> dirs;
  for (int job = 0; job < J; ++job) {
    int Q = qlen[job], T = tlen[job];
    const uint8_t* q = qs + (int64_t)job * QSTRIDE;
    const uint8_t* t = ts + (int64_t)job * TSTRIDE;
    int32_t* ops = out_ops + (int64_t)job * max_ops;
    int32_t* info = out_info + (int64_t)job * 3;
    out_n[job] = 0;
    info[0] = info[1] = info[2] = 0;
    if (Q <= 0 || T <= 0) continue;
    splice_tables(t, T, sense, flank, noncan, reversed_seq, don, acc);
    dirs.assign((int64_t)(Q + 1) * (T + 1), 0);
    H.assign(T + 1, NEGI);
    E.assign(T + 1, NEGI);
    Ai.assign(T + 1, NEGI);
    Fp.assign(T + 1, NEGI);
    F.assign(T + 1, NEGI);
    Hp.assign(T + 1, NEGI);
    H[0] = 0;
    // row 0: leading deletions / introns only
    for (int j = 1; j <= T; ++j) {
      uint8_t d = 0;
      int32_t e_open = H[j - 1] - gapo;
      if (E[j - 1] >= e_open) { E[j] = E[j - 1] - gape; d |= SPL_E_CONT; }
      else E[j] = e_open - gape;
      int32_t a_open = H[j - 1] - q2 - don[j - 1];
      if (Ai[j - 1] >= a_open) { Ai[j] = Ai[j - 1]; d |= SPL_A_CONT; }
      else Ai[j] = a_open;
      int32_t h = E[j];
      uint8_t src = 1;
      int32_t ac = Ai[j] - acc[j - 1];
      if (ac > h) { h = ac; src = 3; }
      H[j] = h;
      dirs[j] = d | src;
    }
    int32_t best_sc = 0, best_i = 0, best_j = 0, g_sc = NEGI, g_j = 0;
    Hp = H;
    for (int i = 1; i <= Q; ++i) {
      int qc = q[i - 1];
      std::fill(E.begin(), E.end(), NEGI);
      std::fill(Ai.begin(), Ai.end(), NEGI);
      uint8_t* drow = dirs.data() + (int64_t)i * (T + 1);
      // F / H column 0
      {
        int32_t f_open = Hp[0] - gapo;
        uint8_t d = 2;
        if (Fp[0] >= f_open) { F[0] = Fp[0] - gape; d |= SPL_F_CONT; }
        else F[0] = f_open - gape;
        H[0] = F[0];
        drow[0] = d;
      }
      for (int j = 1; j <= T; ++j) {
        int tc = t[j - 1];
        int32_t pair =
            (qc == 4 || tc == 4) ? -sc_ambi : (qc == tc ? a : -b);
        uint8_t d = 0;
        int32_t e_open = H[j - 1] - gapo;
        if (E[j - 1] >= e_open) { E[j] = E[j - 1] - gape; d |= SPL_E_CONT; }
        else E[j] = e_open - gape;
        int32_t f_open = Hp[j] - gapo;
        if (Fp[j] >= f_open) { F[j] = Fp[j] - gape; d |= SPL_F_CONT; }
        else F[j] = f_open - gape;
        int32_t a_open = H[j - 1] - q2 - don[j - 1];
        if (Ai[j - 1] >= a_open) { Ai[j] = Ai[j - 1]; d |= SPL_A_CONT; }
        else Ai[j] = a_open;
        int32_t h = Hp[j - 1] + pair;
        uint8_t src = 0;
        if (E[j] > h) { h = E[j]; src = 1; }
        if (F[j] > h) { h = F[j]; src = 2; }
        int32_t ac = Ai[j] - acc[j - 1];
        if (ac > h) { h = ac; src = 3; }
        H[j] = h;
        drow[j] = d | src;
        if (mode == 1 && h > best_sc) { best_sc = h; best_i = i; best_j = j; }
      }
      if (mode == 1 && i == Q) {
        g_sc = H[0]; g_j = 0;
        for (int j = 1; j <= T; ++j)
          if (H[j] > g_sc) { g_sc = H[j]; g_j = j; }
      }
      std::swap(Hp, H);
      std::swap(Fp, F);
    }
    // Hp holds the final row
    int si, sj;
    int32_t sc;
    if (mode == 2) {
      si = Q; sj = T; sc = Hp[T];
    } else {
      if (g_sc > NEGI && g_sc > 0 && g_sc + end_bonus >= best_sc) {
        si = Q; sj = g_j; sc = g_sc;
      } else if (best_sc > 0) {
        si = best_i; sj = best_j; sc = best_sc;
      } else {
        continue;  // no positive extension
      }
    }
    // traceback (prefix coordinates; ops/splice.py state machine)
    int n_ops = 0;
    bool overflow = false;
    auto emit = [&](int op) {
      if (n_ops > 0 && (ops[n_ops - 1] & 0xF) == op) ops[n_ops - 1] += 1 << 4;
      else if (n_ops < max_ops) ops[n_ops++] = (1 << 4) | op;
      else overflow = true;
    };
    int i = si, j = sj, state = 0;
    while ((i > 0 || j > 0) && !overflow) {
      uint8_t d = dirs[(int64_t)i * (T + 1) + j];
      if (state == 0) {
        int src = d & SPL_SRC_MASK;
        if (src == 0) { emit(0); --i; --j; }
        else state = src;
      } else if (state == 1) {
        emit(2);
        bool cont = d & SPL_E_CONT;
        --j;
        if (!cont) state = 0;
      } else if (state == 2) {
        emit(1);
        bool cont = d & SPL_F_CONT;
        --i;
        if (!cont) state = 0;
      } else {
        emit(3);
        bool cont = d & SPL_A_CONT;
        --j;
        if (!cont) state = 0;
      }
    }
    for (int x = 0, y = n_ops - 1; x < y; ++x, --y) std::swap(ops[x], ops[y]);
    out_n[job] = overflow ? -1 : n_ops;
    info[0] = sc;
    info[1] = si;
    info[2] = sj;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Banded dual-affine band fill: scalar reference + AVX-512 fast path.
// Both produce byte-identical `dir` rows and identical tracker values
// for every observable (real) cell; the SIMD path is selected per job
// when the score range provably fits int16 (see simd_fits).

namespace {

struct Trackers {
  int32_t best_sc, best_i, best_j, g_sc, g_j, end_sc;
};

constexpr int32_t NEGI_BAND = -(1 << 28);

// Scalar band fill (the reference implementation; also the fallback
// for hosts without AVX-512BW and for jobs whose score range exceeds
// the int16 domain of the SIMD path).
void band_fill_scalar(const uint8_t* q, const uint8_t* t, int Q, int T,
                      int W, int a, int b, int gq, int ge, int gq2,
                      int ge2, int sc_ambi, int mode, int zdrop,
                      uint8_t* dir_out, Trackers* tk) {
  const int32_t NEGI = NEGI_BAND;
  int S = Q + T - 1;
  // band state with 2-lane sentinel padding on both sides so the
  // du/dl/dd_ accesses never branch (lane d lives at index d+2);
  // separate allocations so __restrict__ holds for vectorization
  const int PW = W + 4;
    std::vector<int32_t> vH1(PW, NEGI), vE1(PW, NEGI), vE2(PW, NEGI),
        vF1(PW, NEGI), vF2(PW, NEGI), vH2(PW, NEGI), vH1n(PW, NEGI),
        vE1n(PW, NEGI), vE2n(PW, NEGI), vF1n(PW, NEGI), vF2n(PW, NEGI);
    int32_t *H1 = vH1.data() + 2, *E1v = vE1.data() + 2,
            *E2v = vE2.data() + 2, *F1v = vF1.data() + 2,
            *F2v = vF2.data() + 2, *H2 = vH2.data() + 2,
            *H1n = vH1n.data() + 2, *E1n = vE1n.data() + 2,
            *E2n = vE2n.data() + 2, *F1n = vF1n.data() + 2,
            *F2n = vF2n.data() + 2;
    auto reset_sentinels = [&](int32_t* base) {
      base[-2] = base[-1] = base[W] = base[W + 1] = NEGI;
    };
    auto gap = [&](long l) {
      long g1 = gq + l * ge, g2 = gq2 + l * ge2;
      return (int32_t)(g1 < g2 ? g1 : g2);
    };
    int32_t best_sc = NEGI, best_i = 0, best_j = 0;
    int32_t g_sc = NEGI, g_j = 0, end_sc = NEGI;
    int lo1 = 0, lo2 = 0;
    for (int s = 0; s < S; ++s) {
      int lo = band_lo(s, Q, T, W);
      int d1 = lo - lo1;  // 0/1
      int d2 = lo - lo2;  // 0/1/2
      // exact in-band lane range: i in [max(lo, s-T+1), min(s, Q-1)]
      int i_min = s - (T - 1) > lo ? s - (T - 1) : lo;
      int i_max = s < Q - 1 ? s : Q - 1;
      int d_lo = i_min - lo, d_hi = i_max - lo;
      if (d_lo < 0) d_lo = 0;
      if (d_hi > W - 1) d_hi = W - 1;
      for (int d = 0; d < d_lo && d < W; ++d)
        H1n[d] = E1n[d] = E2n[d] = F1n[d] = F2n[d] = NEGI;
      for (int d = (d_hi < -1 ? 0 : d_hi + 1); d < W; ++d)
        H1n[d] = E1n[d] = E2n[d] = F1n[d] = F2n[d] = NEGI;
      const int ou = d1 - 1, ol = d1, od = d2 - 1;
      uint8_t* drow = dir_out + (int64_t)s * W;
      const uint8_t* trow = t + (s - lo);  // t[j] = trow[-d]
      const uint8_t* qrow = q + lo;
      // branch-free interior sweep (auto-vectorizable)
      const int32_t* __restrict pH1 = H1;
      const int32_t* __restrict pE1 = E1v;
      const int32_t* __restrict pE2 = E2v;
      const int32_t* __restrict pF1 = F1v;
      const int32_t* __restrict pF2 = F2v;
      const int32_t* __restrict pH2 = H2;
      int32_t* __restrict oH = H1n;
      int32_t* __restrict oE1 = E1n;
      int32_t* __restrict oE2 = E2n;
      int32_t* __restrict oF1 = F1n;
      int32_t* __restrict oF2 = F2n;
#pragma GCC ivdep
      for (int d = d_lo; d <= d_hi; ++d) {
        int32_t H_up = pH1[d + ou], F1_up = pF1[d + ou], F2_up = pF2[d + ou];
        int32_t H_left = pH1[d + ol], E1_left = pE1[d + ol],
                E2_left = pE2[d + ol];
        int32_t H_diag = pH2[d + od];
        int32_t e1o = H_left - gq;
        int32_t e1 = (E1_left > e1o ? E1_left : e1o) - ge;
        uint8_t e1c = E1_left > e1o ? E1_CONT : 0;
        int32_t e2o = H_left - gq2;
        int32_t e2 = (E2_left > e2o ? E2_left : e2o) - ge2;
        uint8_t e2c = E2_left > e2o ? E2_CONT : 0;
        int32_t f1o = H_up - gq;
        int32_t f1 = (F1_up > f1o ? F1_up : f1o) - ge;
        uint8_t f1c = F1_up > f1o ? F1_CONT : 0;
        int32_t f2o = H_up - gq2;
        int32_t f2 = (F2_up > f2o ? F2_up : f2o) - ge2;
        uint8_t f2c = F2_up > f2o ? F2_CONT : 0;
        int qc = qrow[d], tc = trow[-d];
        int32_t pair = (qc == 4 || tc == 4) ? -sc_ambi : (qc == tc ? a : -b);
        int32_t h = H_diag + pair;
        uint8_t src = 0;
        if (e1 > h) { h = e1; src = 1; }
        if (e2 > h) { h = e2; src = 2; }
        if (f1 > h) { h = f1; src = 3; }
        if (f2 > h) { h = f2; src = 4; }
        oH[d] = h;
        oE1[d] = e1;
        oE2[d] = e2;
        oF1[d] = f1;
        oF2[d] = f2;
        drow[d] = src | e1c | e2c | f1c | f2c;
      }
      // border fixups: i==0 only at lane -lo (lo==0), j==0 only at
      // lane s-lo; recompute those (<=2) lanes with border values
      for (int pass = 0; pass < 2; ++pass) {
        int d = pass == 0 ? -lo : s - lo;
        if (d < d_lo || d > d_hi) continue;
        if (pass == 1 && lo == 0 && s - lo == 0) continue;  // same lane
        int i = lo + d, j = s - i;
        if ((pass == 0 && i != 0) || (pass == 1 && j != 0)) continue;
        int32_t H_up = H1[d + ou], F1_up = F1v[d + ou], F2_up = F2v[d + ou];
        int32_t H_left = H1[d + ol], E1_left = E1v[d + ol],
                E2_left = E2v[d + ol];
        int32_t H_diag = H2[d + od];
        if (i == 0 && j == 0) H_diag = 0;
        else if (i == 0) H_diag = -gap(j);
        else if (j == 0) H_diag = -gap(i);
        if (j == 0) { H_left = -gap(i + 1); E1_left = NEGI; E2_left = NEGI; }
        if (i == 0) { H_up = -gap(j + 1); F1_up = NEGI; F2_up = NEGI; }
        int32_t e1o = H_left - gq;
        int32_t e1 = (E1_left > e1o ? E1_left : e1o) - ge;
        uint8_t e1c = E1_left > e1o ? E1_CONT : 0;
        int32_t e2o = H_left - gq2;
        int32_t e2 = (E2_left > e2o ? E2_left : e2o) - ge2;
        uint8_t e2c = E2_left > e2o ? E2_CONT : 0;
        int32_t f1o = H_up - gq;
        int32_t f1 = (F1_up > f1o ? F1_up : f1o) - ge;
        uint8_t f1c = F1_up > f1o ? F1_CONT : 0;
        int32_t f2o = H_up - gq2;
        int32_t f2 = (F2_up > f2o ? F2_up : f2o) - ge2;
        uint8_t f2c = F2_up > f2o ? F2_CONT : 0;
        int qc = q[i], tc = t[j];
        int32_t pair = (qc == 4 || tc == 4) ? -sc_ambi : (qc == tc ? a : -b);
        int32_t h = H_diag + pair;
        uint8_t src = 0;
        if (e1 > h) { h = e1; src = 1; }
        if (e2 > h) { h = e2; src = 2; }
        if (f1 > h) { h = f1; src = 3; }
        if (f2 > h) { h = f2; src = 4; }
        H1n[d] = h;
        E1n[d] = e1;
        E2n[d] = e2;
        F1n[d] = f1;
        F2n[d] = f2;
        drow[d] = src | e1c | e2c | f1c | f2c;
      }
      // tracker pass in device order (s asc, lane asc, strict '>')
      {
        for (int d = d_lo; d <= d_hi; ++d) {
          int32_t h = H1n[d];
          if (h > best_sc) {
            best_sc = h;
            best_i = lo + d;
            best_j = s - (lo + d);
          }
        }
        // zdrop (ksw2 semantics): the allowed drop below the running
        // max grows with the DIAGONAL offset from the max cell at the
        // long-gap extension slope, so long indels within the band
        // never trip it (margin: gq2 <= zdrop) while substitution
        // runs (diagonal-constant) still die at exactly zdrop.  A
        // diagonal survives if ANY in-band lane is within allowance.
        bool zdead = false;
        if (mode != 0 && zdrop > 0 && best_sc > NEGI / 2) {
          int32_t e_adj = (gq2 > 0 && ge2 < ge) ? ge2 : ge;
          int32_t bd = best_i - best_j;
          zdead = true;
          for (int d = d_lo; d <= d_hi; ++d) {
            int32_t off = 2 * (lo + d) - s - bd;
            if (off < 0) off = -off;
            if (H1n[d] >= best_sc - zdrop - e_adj * off) {
              zdead = false;
              break;
            }
          }
        }
        int d_last = (Q - 1) - lo;  // lane of the last query row
        if (d_last >= d_lo && d_last <= d_hi) {
          int32_t h = H1n[d_last];
          if (h > g_sc) { g_sc = h; g_j = s - (Q - 1); }
          if (s == S - 1) end_sc = h;
        }
        std::swap(H1, H2);
        std::swap(H1, H1n);
        std::swap(E1v, E1n);
        std::swap(E2v, E2n);
        std::swap(F1v, F1n);
        std::swap(F2v, F2n);
        for (int32_t* base : {H1, E1v, E2v, F1v, F2v, H2, H1n, E1n, E2n, F1n, F2n})
          reset_sentinels(base);
        lo2 = lo1;
        lo1 = lo;
        // zdrop early termination: applies to extension (mode 1) and
        // split-enabled global (mode 2) — in mode 2 the unreached end
        // cell marks the job dropped and the caller splits the region
        // at the max cell
        if (zdead) break;
      }
    }
  tk->best_sc = best_sc;
  tk->best_i = best_i;
  tk->best_j = best_j;
  tk->g_sc = g_sc;
  tk->g_j = g_j;
  tk->end_sc = end_sc;
}

#if defined(MAPPY_AVX512)

// int16 score-domain guard for the AVX-512 fill.  All junk
// (band-edge sentinel descendant) values evolve EXACTLY offset from
// the int32 engine's (same max/add ops, constant initial offset), so
// every comparison decides identically as long as (a) no int16
// saturation occurs anywhere and (b) real scores never dip into the
// junk range.  Junk H stays within [NEG16 - 6*S, NEG16 + 2*S]; real H
// is bounded below by -(mismatch diag + one gap) and above by
// a*min(Q,T)+end_bonus.  The JUNK_CUT threshold separates the two.
constexpr int16_t NEG16 = -16000;
constexpr int32_t JUNK_CUT16 = -12000;

inline bool simd_fits(int Q, int T, int W, int a, int b, int gq, int ge,
                      int gq2, int ge2, int sc_ambi, int end_bonus) {
  if (W % 32 != 0 || W <= 0) return false;
  long qt = (long)Q + T;
  if (qt > 3500) return false;  // junk drift + real range headroom
  long mm = (long)(b > sc_ambi ? b : sc_ambi);
  long gap1 = (long)gq + (long)ge * qt;
  long gap2 = (long)gq2 + (long)ge2 * qt;
  long worst = mm * (Q < T ? Q : T) + (gap1 > gap2 ? gap1 : gap2);
  long best = (long)a * (Q < T ? Q : T) + end_bonus;
  // real H in (-worst, best); E/F extend at most one more full gap
  // below real H.  Require real H > JUNK_CUT16 with margin and all
  // magnitudes far from int16 saturation.
  return worst < 10000 && best < 14000;
}

inline int16_t reduce_max_epi16(__m512i v) {
  // log2 shuffle reduction (the stored 32-iteration scalar loop this
  // replaces was a per-diagonal cost on the band fill's serial path)
  __m256i a = _mm256_max_epi16(_mm512_castsi512_si256(v),
                               _mm512_extracti64x4_epi64(v, 1));
  __m128i b = _mm_max_epi16(_mm256_castsi256_si128(a),
                            _mm256_extracti128_si256(a, 1));
  b = _mm_max_epi16(b, _mm_shuffle_epi32(b, 0x4E));      // swap 64s
  b = _mm_max_epi16(b, _mm_shuffle_epi32(b, 0xB1));      // swap 32s
  b = _mm_max_epi16(b, _mm_shufflelo_epi16(b, 0xB1));    // swap 16s
  return (int16_t)_mm_extract_epi16(b, 0);
}

// Broadcast scoring constants shared by every job of one aligner (the
// job mix varies only Q/T/W/mode; a..sc_ambi are the preset's).
struct Band512Consts {
  __m512i vNEG, vgq, vge, vgq2, vge2, va, vnb, vnambi, v4, v1, v2, v3,
      vsrc4, vE1C, vE2C, vF1C, vF2C, viota;
  void init(int a, int b, int gq, int ge, int gq2, int ge2, int sc_ambi) {
    vNEG = _mm512_set1_epi16(NEG16);
    vgq = _mm512_set1_epi16((int16_t)gq);
    vge = _mm512_set1_epi16((int16_t)ge);
    vgq2 = _mm512_set1_epi16((int16_t)gq2);
    vge2 = _mm512_set1_epi16((int16_t)ge2);
    va = _mm512_set1_epi16((int16_t)a);
    vnb = _mm512_set1_epi16((int16_t)-b);
    vnambi = _mm512_set1_epi16((int16_t)-sc_ambi);
    v4 = _mm512_set1_epi16(4);
    v1 = _mm512_set1_epi16(1);
    v2 = _mm512_set1_epi16(2);
    v3 = _mm512_set1_epi16(3);
    vsrc4 = _mm512_set1_epi16(4);
    vE1C = _mm512_set1_epi16(E1_CONT);
    vE2C = _mm512_set1_epi16(E2_CONT);
    vF1C = _mm512_set1_epi16(F1_CONT);
    vF2C = _mm512_set1_epi16(F2_CONT);
    alignas(64) int16_t iota_arr[32];
    for (int i = 0; i < 32; ++i) iota_arr[i] = (int16_t)i;
    viota = _mm512_load_si512((const __m512i*)iota_arr);
  }
};

// AVX-512BW band fill: 32 int16 lanes per vector, bit-identical
// observable outputs to band_fill_scalar (dir bytes for all in-band
// lanes, trackers over real cells; junk-valued trackers are mapped
// back to the NEGI "unreachable" domain at the end).
//
// Factored as init()/step()/finish() so TWO independent jobs can run
// with their anti-diagonal loops interleaved (band_fill_avx512_pair):
// each diagonal depends serially on the previous one, so a single job
// leaves the core's OoO window half idle at W=32 — two independent
// dependency chains in one loop hide that latency.  step() computes
// exactly one diagonal and makes exactly the decisions the single-job
// loop made, so pairing cannot change any output.
struct BandFill512 {
  const uint8_t *q0, *t0;
  int Q, T, W, mode, zdrop;
  int a, b, gq, ge, gq2, ge2, sc_ambi;
  uint8_t* dir_out;
  int S;
  uint8_t* qb;
  uint8_t* trv;
  int16_t *H1, *E1v, *E2v, *F1v, *F2v, *H2, *H1n, *E1n, *E2n, *F1n, *F2n;
  int16_t best16, end16, g16;
  int32_t best_i, best_j, g_j;
  bool best_real, g_real, end_real;
  int lo1, lo2;
  // register-resident W=32 state (step32): at W=32 every row is ONE
  // vector, so the memory round-trip per diagonal (store five rows,
  // reload them at ±1-lane offsets next diagonal — a partial-overlap
  // store-forward stall per load) is replaced by register moves and
  // vpermw lane shifts.  Values are identical to the memory rows.
  bool reg_on;
  __m512i rH1, rH2, rE1, rE2, rF1, rF2;

  int32_t gap(long l) const {
    long g1 = gq + l * ge, g2 = gq2 + l * ge2;
    return (int32_t)(g1 < g2 ? g1 : g2);
  }

  void init(const uint8_t* q0_, const uint8_t* t0_, int Q_, int T_,
            int W_, int a_, int b_, int gq_, int ge_, int gq2_, int ge2_,
            int sc_ambi_, int mode_, int zdrop_, uint8_t* dir, int slot) {
    q0 = q0_; t0 = t0_; Q = Q_; T = T_; W = W_;
    a = a_; b = b_; gq = gq_; ge = ge_; gq2 = gq2_; ge2 = ge2_;
    sc_ambi = sc_ambi_; mode = mode_; zdrop = zdrop_; dir_out = dir;
    S = Q + T - 1;
    // padded sequences: q read at lo+d (d<W) -> [0, Q+W); t read via a
    // reversed copy so the anti-diagonal access t[s-lo-d] is forward in
    // d: trev[T-1-j], index = (T-1-s+lo) + d which can wander +-W for
    // out-of-band lanes -> W+64 slack of 'N' (4) on both sides.
    // Scratch is slot-indexed so a pair of in-flight jobs never share.
    thread_local std::vector<uint8_t> qb_s[2], tr_s[2];
    thread_local std::vector<int16_t> buf_s[2];
    auto& qbv = qb_s[slot];
    auto& trr = tr_s[slot];
    auto& buf = buf_s[slot];
    qbv.assign(Q + W + 64, 4);
    trr.assign(T + 2 * (W + 64), 4);
    memcpy(qbv.data(), q0, Q);
    qb = qbv.data();
    trv = trr.data() + W + 64;
    for (int j = 0; j < T; ++j) trv[j] = t0[T - 1 - j];
    // state rows (int16) with 32-lane pads both sides; pads hold NEG16
    // forever (stores only touch [0, W)), so edge loads at d-1/d+1 read
    // the same sentinel the scalar engine keeps
    const int PW = W + 64;
    buf.assign((size_t)11 * PW, NEG16);
    int16_t* rows[11];
    for (int r = 0; r < 11; ++r) rows[r] = buf.data() + (size_t)r * PW + 32;
    H1 = rows[0]; E1v = rows[1]; E2v = rows[2]; F1v = rows[3];
    F2v = rows[4]; H2 = rows[5]; H1n = rows[6]; E1n = rows[7];
    E2n = rows[8]; F1n = rows[9]; F2n = rows[10];
    best16 = NEG16; end16 = NEG16; g16 = NEG16;
    best_i = 0; best_j = 0; g_j = 0;
    best_real = false; g_real = false; end_real = false;
    lo1 = 0; lo2 = 0;
    reg_on = false;
  }

  // lane l <- x[l-1] (lane 0 <- NEG16) / lane l <- x[l+1] (lane 31 <-
  // NEG16): the register forms of the memory path's ±1-lane offset
  // loads, which read the NEG16 pad lanes at the row edges.
  static inline __m512i shr1(__m512i x, const __m512i& vNEG) {
    alignas(64) static const int16_t IDXM1[32] = {
        0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30};
    __m512i idx = _mm512_load_si512((const __m512i*)IDXM1);
    return _mm512_mask_mov_epi16(_mm512_permutexvar_epi16(idx, x),
                                 (__mmask32)1u, vNEG);
  }
  static inline __m512i shl1(__m512i x, const __m512i& vNEG) {
    alignas(64) static const int16_t IDXP1[32] = {
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
        18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 31};
    __m512i idx = _mm512_load_si512((const __m512i*)IDXP1);
    return _mm512_mask_mov_epi16(_mm512_permutexvar_epi16(idx, x),
                                 (__mmask32)0x80000000u, vNEG);
  }

  void enter_reg() {
    rH1 = _mm512_loadu_si512((const __m512i*)H1);
    rH2 = _mm512_loadu_si512((const __m512i*)H2);
    rE1 = _mm512_loadu_si512((const __m512i*)E1v);
    rE2 = _mm512_loadu_si512((const __m512i*)E2v);
    rF1 = _mm512_loadu_si512((const __m512i*)F1v);
    rF2 = _mm512_loadu_si512((const __m512i*)F2v);
    reg_on = true;
  }

  // One anti-diagonal, W=32 register-resident.  Same decisions, same
  // dir bytes, same tracker updates as step(); only the row storage
  // differs.  Callable once s >= 34 (border fixups impossible: at
  // W=32 the i==0 / j==0 lanes leave the band by s=33) and d2 == 1
  // (band_lo advances by exactly 1 per two diagonals past the clamp).
  // Rows are passed by reference so the callers can keep them in
  // LOCALS across the whole loop — always_inline makes them live in
  // zmm registers instead of bouncing through the struct every call.
  __attribute__((always_inline)) inline bool step32r(
      int s, const Band512Consts& C, __m512i& rH1, __m512i& rH2,
      __m512i& rE1, __m512i& rE2, __m512i& rF1, __m512i& rF2) {
    const __m512i vNEG = C.vNEG;
    int lo = band_lo(s, Q, T, 32);
    int d1 = lo - lo1;
    int i_min = s - (T - 1) > lo ? s - (T - 1) : lo;
    int i_max = s < Q - 1 ? s : Q - 1;
    int d_lo = i_min - lo, d_hi = i_max - lo;
    if (d_lo < 0) d_lo = 0;
    if (d_hi > 31) d_hi = 31;
    uint8_t* drow = dir_out + (int64_t)s * 32;
    if (d_lo > d_hi) {
      rH2 = rH1;
      rH1 = vNEG; rE1 = vNEG; rE2 = vNEG; rF1 = vNEG; rF2 = vNEG;
      lo2 = lo1;
      lo1 = lo;
      return mode != 0 && zdrop > 0 && best16 > JUNK_CUT16 &&
             NEG16 < best16 - zdrop;
    }
    // operand rows via lane shifts (ou = d1-1, ol = d1, od = d2-1 = 0)
    __m512i H_up, F1_up, F2_up, H_left, E1_left, E2_left;
    if (d1 == 0) {
      H_up = shr1(rH1, vNEG);
      F1_up = shr1(rF1, vNEG);
      F2_up = shr1(rF2, vNEG);
      H_left = rH1; E1_left = rE1; E2_left = rE2;
    } else {
      H_up = rH1; F1_up = rF1; F2_up = rF2;
      H_left = shl1(rH1, vNEG);
      E1_left = shl1(rE1, vNEG);
      E2_left = shl1(rE2, vNEG);
    }
    const __m512i H_diag = rH2;
    __m512i e1o = _mm512_sub_epi16(H_left, C.vgq);
    __mmask32 m_e1c = _mm512_cmpgt_epi16_mask(E1_left, e1o);
    __m512i e1 = _mm512_sub_epi16(_mm512_max_epi16(E1_left, e1o), C.vge);
    __m512i e2o = _mm512_sub_epi16(H_left, C.vgq2);
    __mmask32 m_e2c = _mm512_cmpgt_epi16_mask(E2_left, e2o);
    __m512i e2 = _mm512_sub_epi16(_mm512_max_epi16(E2_left, e2o), C.vge2);
    __m512i f1o = _mm512_sub_epi16(H_up, C.vgq);
    __mmask32 m_f1c = _mm512_cmpgt_epi16_mask(F1_up, f1o);
    __m512i f1 = _mm512_sub_epi16(_mm512_max_epi16(F1_up, f1o), C.vge);
    __m512i f2o = _mm512_sub_epi16(H_up, C.vgq2);
    __mmask32 m_f2c = _mm512_cmpgt_epi16_mask(F2_up, f2o);
    __m512i f2 = _mm512_sub_epi16(_mm512_max_epi16(F2_up, f2o), C.vge2);
    __m512i qv = _mm512_cvtepu8_epi16(
        _mm256_loadu_si256((const __m256i*)(qb + lo)));
    __m512i tv = _mm512_cvtepu8_epi16(
        _mm256_loadu_si256((const __m256i*)(trv + (T - 1 - s + lo))));
    __mmask32 m_eq = _mm512_cmpeq_epi16_mask(qv, tv);
    __mmask32 m_amb = _mm512_cmpeq_epi16_mask(qv, C.v4) |
                      _mm512_cmpeq_epi16_mask(tv, C.v4);
    __m512i pair = _mm512_mask_mov_epi16(C.vnb, m_eq, C.va);
    pair = _mm512_mask_mov_epi16(pair, m_amb, C.vnambi);
    __m512i h = _mm512_add_epi16(H_diag, pair);
    __m512i src = _mm512_setzero_si512();
    __mmask32 m;
    m = _mm512_cmpgt_epi16_mask(e1, h);
    h = _mm512_mask_mov_epi16(h, m, e1);
    src = _mm512_mask_mov_epi16(src, m, C.v1);
    m = _mm512_cmpgt_epi16_mask(e2, h);
    h = _mm512_mask_mov_epi16(h, m, e2);
    src = _mm512_mask_mov_epi16(src, m, C.v2);
    m = _mm512_cmpgt_epi16_mask(f1, h);
    h = _mm512_mask_mov_epi16(h, m, f1);
    src = _mm512_mask_mov_epi16(src, m, C.v3);
    m = _mm512_cmpgt_epi16_mask(f2, h);
    h = _mm512_mask_mov_epi16(h, m, f2);
    src = _mm512_mask_mov_epi16(src, m, C.vsrc4);
    __m512i dirw = src;
    dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_e1c, C.vE1C));
    dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_e2c, C.vE2C));
    dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_f1c, C.vF1C));
    dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_f2c, C.vF2C));
    const __m512i vdlo = _mm512_set1_epi16((int16_t)d_lo);
    const __m512i vdhi = _mm512_set1_epi16((int16_t)d_hi);
    __mmask32 mband = _mm512_cmple_epi16_mask(vdlo, C.viota) &
                      _mm512_cmple_epi16_mask(C.viota, vdhi);
    rH2 = rH1;
    rH1 = _mm512_mask_mov_epi16(vNEG, mband, h);
    rE1 = _mm512_mask_mov_epi16(vNEG, mband, e1);
    rE2 = _mm512_mask_mov_epi16(vNEG, mband, e2);
    rF1 = _mm512_mask_mov_epi16(vNEG, mband, f1);
    rF2 = _mm512_mask_mov_epi16(vNEG, mband, f2);
    _mm256_storeu_si256(
        (__m256i*)drow,
        _mm512_cvtepi16_epi8(_mm512_maskz_mov_epi16(mband, dirw)));
    // trackers (identical decisions to step(); the improve/zdrop slow
    // paths spill the single row to the stack to scan lanes)
    alignas(64) int16_t spill[32];
    bool improved = false;
    if (_mm512_cmpgt_epi16_mask(rH1, _mm512_set1_epi16(best16))) {
      // first (lowest-d) lane holding the diagonal max — the same
      // ascending-lane tie rule as the scalar scan.  Out-of-band
      // lanes are NEG16 < diag_best so the cmpeq mask cannot hit them.
      int16_t diag_best = reduce_max_epi16(rH1);
      __mmask32 meq =
          _mm512_cmpeq_epi16_mask(rH1, _mm512_set1_epi16(diag_best));
      int d = (int)_tzcnt_u32((uint32_t)meq);
      best16 = diag_best;
      best_i = lo + d;
      best_j = s - (lo + d);
      best_real = true;
      improved = true;
    }
    int d_last = (Q - 1) - lo;
    if (d_last >= d_lo && d_last <= d_hi) {
      _mm512_store_si512((__m512i*)spill, rH1);
      int16_t hh = spill[d_last];
      if (hh > g16) { g16 = hh; g_j = s - (Q - 1); g_real = true; }
      if (s == S - 1) { end16 = hh; end_real = true; }
    }
    bool zdead = false;
    bool enter_zdrop = false;
    if (!improved && mode != 0 && zdrop > 0 && best16 > JUNK_CUT16) {
      const int32_t thr1 = (int32_t)best16 - zdrop - 1;
      if (thr1 >= 32767) {
        enter_zdrop = true;
      } else if (thr1 >= -32768) {
        enter_zdrop = !_mm512_cmpgt_epi16_mask(
            rH1, _mm512_set1_epi16((int16_t)thr1));
      }
    }
    if (enter_zdrop) {
      int32_t e_adj = (gq2 > 0 && ge2 < ge) ? ge2 : ge;
      int32_t bd = best_i - best_j;
      zdead = true;
      _mm512_store_si512((__m512i*)spill, rH1);
      for (int d = d_lo; d <= d_hi; ++d) {
        int32_t off = 2 * (lo + d) - s - bd;
        if (off < 0) off = -off;
        if ((int32_t)spill[d] >= (int32_t)best16 - zdrop - e_adj * off) {
          zdead = false;
          break;
        }
      }
    }
    lo2 = lo1;
    lo1 = lo;
    return zdead;
  }

  // One anti-diagonal; returns true when the fill terminated (zdrop).
  inline bool step(int s, const Band512Consts& C) {
    const __m512i vNEG = C.vNEG;
    const __m512i vgq = C.vgq, vge = C.vge, vgq2 = C.vgq2, vge2 = C.vge2;
    const __m512i va = C.va, vnb = C.vnb, vnambi = C.vnambi;
    const __m512i v4 = C.v4, v1 = C.v1, v2 = C.v2, v3 = C.v3;
    const __m512i vsrc4 = C.vsrc4;
    const __m512i vE1C = C.vE1C, vE2C = C.vE2C, vF1C = C.vF1C,
                  vF2C = C.vF2C;
    const __m512i viota = C.viota;
    int lo = band_lo(s, Q, T, W);
    int d1 = lo - lo1;
    int d2 = lo - lo2;
    int i_min = s - (T - 1) > lo ? s - (T - 1) : lo;
    int i_max = s < Q - 1 ? s : Q - 1;
    int d_lo = i_min - lo, d_hi = i_max - lo;
    if (d_lo < 0) d_lo = 0;
    if (d_hi > W - 1) d_hi = W - 1;
    const int ou = d1 - 1, ol = d1, od = d2 - 1;
    uint8_t* drow = dir_out + (int64_t)s * W;
    const uint8_t* qrow = qb + lo;
    const uint8_t* trow = trv + (T - 1 - s + lo);  // + d, forward
    if (d_lo > d_hi) {
      // empty diagonal (band degenerated past the matrix corner):
      // every lane goes to the sentinel, exactly like the scalar
      // fills; skipping the loads also keeps the padded-sequence
      // accesses in bounds for extreme Q/T aspect ratios
      for (int vd = 0; vd < W; vd += 32) {
        _mm512_storeu_si512((__m512i*)(H1n + vd), vNEG);
        _mm512_storeu_si512((__m512i*)(E1n + vd), vNEG);
        _mm512_storeu_si512((__m512i*)(E2n + vd), vNEG);
        _mm512_storeu_si512((__m512i*)(F1n + vd), vNEG);
        _mm512_storeu_si512((__m512i*)(F2n + vd), vNEG);
      }
      std::swap(H1, H2);
      std::swap(H1, H1n);
      std::swap(E1v, E1n);
      std::swap(E2v, E2n);
      std::swap(F1v, F1n);
      std::swap(F2v, F2n);
      lo2 = lo1;
      lo1 = lo;
      // scalar parity: an empty diagonal yields diag_best == sentinel,
      // which trips zdrop exactly when the running best is real
      return mode != 0 && zdrop > 0 && best16 > JUNK_CUT16 &&
             NEG16 < best16 - zdrop;
    }
    const __m512i vdlo = _mm512_set1_epi16((int16_t)d_lo);
    const __m512i vdhi = _mm512_set1_epi16((int16_t)d_hi);
    for (int vd = 0; vd < W; vd += 32) {
      __m512i idx = _mm512_add_epi16(viota, _mm512_set1_epi16((int16_t)vd));
      __mmask32 mband = _mm512_cmple_epi16_mask(vdlo, idx) &
                        _mm512_cmple_epi16_mask(idx, vdhi);
      __m512i H_up = _mm512_loadu_si512((const __m512i*)(H1 + vd + ou));
      __m512i F1_up = _mm512_loadu_si512((const __m512i*)(F1v + vd + ou));
      __m512i F2_up = _mm512_loadu_si512((const __m512i*)(F2v + vd + ou));
      __m512i H_left = _mm512_loadu_si512((const __m512i*)(H1 + vd + ol));
      __m512i E1_left = _mm512_loadu_si512((const __m512i*)(E1v + vd + ol));
      __m512i E2_left = _mm512_loadu_si512((const __m512i*)(E2v + vd + ol));
      __m512i H_diag = _mm512_loadu_si512((const __m512i*)(H2 + vd + od));
      __m512i e1o = _mm512_sub_epi16(H_left, vgq);
      __mmask32 m_e1c = _mm512_cmpgt_epi16_mask(E1_left, e1o);
      __m512i e1 = _mm512_sub_epi16(_mm512_max_epi16(E1_left, e1o), vge);
      __m512i e2o = _mm512_sub_epi16(H_left, vgq2);
      __mmask32 m_e2c = _mm512_cmpgt_epi16_mask(E2_left, e2o);
      __m512i e2 = _mm512_sub_epi16(_mm512_max_epi16(E2_left, e2o), vge2);
      __m512i f1o = _mm512_sub_epi16(H_up, vgq);
      __mmask32 m_f1c = _mm512_cmpgt_epi16_mask(F1_up, f1o);
      __m512i f1 = _mm512_sub_epi16(_mm512_max_epi16(F1_up, f1o), vge);
      __m512i f2o = _mm512_sub_epi16(H_up, vgq2);
      __mmask32 m_f2c = _mm512_cmpgt_epi16_mask(F2_up, f2o);
      __m512i f2 = _mm512_sub_epi16(_mm512_max_epi16(F2_up, f2o), vge2);
      __m512i qv = _mm512_cvtepu8_epi16(
          _mm256_loadu_si256((const __m256i*)(qrow + vd)));
      __m512i tv = _mm512_cvtepu8_epi16(
          _mm256_loadu_si256((const __m256i*)(trow + vd)));
      __mmask32 m_eq = _mm512_cmpeq_epi16_mask(qv, tv);
      __mmask32 m_amb = _mm512_cmpeq_epi16_mask(qv, v4) |
                        _mm512_cmpeq_epi16_mask(tv, v4);
      __m512i pair = _mm512_mask_mov_epi16(vnb, m_eq, va);
      pair = _mm512_mask_mov_epi16(pair, m_amb, vnambi);
      __m512i h = _mm512_add_epi16(H_diag, pair);
      __m512i src = _mm512_setzero_si512();
      __mmask32 m;
      m = _mm512_cmpgt_epi16_mask(e1, h);
      h = _mm512_mask_mov_epi16(h, m, e1);
      src = _mm512_mask_mov_epi16(src, m, v1);
      m = _mm512_cmpgt_epi16_mask(e2, h);
      h = _mm512_mask_mov_epi16(h, m, e2);
      src = _mm512_mask_mov_epi16(src, m, v2);
      m = _mm512_cmpgt_epi16_mask(f1, h);
      h = _mm512_mask_mov_epi16(h, m, f1);
      src = _mm512_mask_mov_epi16(src, m, v3);
      m = _mm512_cmpgt_epi16_mask(f2, h);
      h = _mm512_mask_mov_epi16(h, m, f2);
      src = _mm512_mask_mov_epi16(src, m, vsrc4);
      __m512i dirw = src;
      dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_e1c, vE1C));
      dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_e2c, vE2C));
      dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_f1c, vF1C));
      dirw = _mm512_or_si512(dirw, _mm512_maskz_mov_epi16(m_f2c, vF2C));
      // out-of-band lanes keep the NEG16 sentinel; dir bytes stay 0
      _mm512_storeu_si512((__m512i*)(H1n + vd),
                          _mm512_mask_mov_epi16(vNEG, mband, h));
      _mm512_storeu_si512((__m512i*)(E1n + vd),
                          _mm512_mask_mov_epi16(vNEG, mband, e1));
      _mm512_storeu_si512((__m512i*)(E2n + vd),
                          _mm512_mask_mov_epi16(vNEG, mband, e2));
      _mm512_storeu_si512((__m512i*)(F1n + vd),
                          _mm512_mask_mov_epi16(vNEG, mband, f1));
      _mm512_storeu_si512((__m512i*)(F2n + vd),
                          _mm512_mask_mov_epi16(vNEG, mband, f2));
      // unmasked store with out-of-band lanes forced to 0: the dir
      // buffer then needs no zero-init at all on this path (every
      // walkable (s, d) lane is written by the sweep)
      _mm256_storeu_si256(
          (__m256i*)(drow + vd),
          _mm512_cvtepi16_epi8(_mm512_maskz_mov_epi16(mband, dirw)));
    }
    // border fixups (i==0 / j==0 lanes): scalar recompute, exactly as
    // the reference fill (int32 math; values are small near borders)
    for (int pass = 0; pass < 2; ++pass) {
      int d = pass == 0 ? -lo : s - lo;
      if (d < d_lo || d > d_hi) continue;
      if (pass == 1 && lo == 0 && s - lo == 0) continue;
      int i = lo + d, j = s - i;
      if ((pass == 0 && i != 0) || (pass == 1 && j != 0)) continue;
      int32_t H_up = H1[d + ou], F1_up = F1v[d + ou], F2_up = F2v[d + ou];
      int32_t H_left = H1[d + ol], E1_left = E1v[d + ol],
              E2_left = E2v[d + ol];
      int32_t H_diag = H2[d + od];
      if (i == 0 && j == 0) H_diag = 0;
      else if (i == 0) H_diag = -gap(j);
      else if (j == 0) H_diag = -gap(i);
      if (j == 0) { H_left = -gap(i + 1); E1_left = NEG16; E2_left = NEG16; }
      if (i == 0) { H_up = -gap(j + 1); F1_up = NEG16; F2_up = NEG16; }
      int32_t e1o = H_left - gq;
      int32_t e1 = (E1_left > e1o ? E1_left : e1o) - ge;
      uint8_t e1c = E1_left > e1o ? E1_CONT : 0;
      int32_t e2o = H_left - gq2;
      int32_t e2 = (E2_left > e2o ? E2_left : e2o) - ge2;
      uint8_t e2c = E2_left > e2o ? E2_CONT : 0;
      int32_t f1o = H_up - gq;
      int32_t f1 = (F1_up > f1o ? F1_up : f1o) - ge;
      uint8_t f1c = F1_up > f1o ? F1_CONT : 0;
      int32_t f2o = H_up - gq2;
      int32_t f2 = (F2_up > f2o ? F2_up : f2o) - ge2;
      uint8_t f2c = F2_up > f2o ? F2_CONT : 0;
      int qc = q0[i], tc = t0[j];
      int32_t pair = (qc == 4 || tc == 4) ? -sc_ambi : (qc == tc ? a : -b);
      int32_t h = H_diag + pair;
      uint8_t srcb = 0;
      if (e1 > h) { h = e1; srcb = 1; }
      if (e2 > h) { h = e2; srcb = 2; }
      if (f1 > h) { h = f1; srcb = 3; }
      if (f2 > h) { h = f2; srcb = 4; }
      H1n[d] = (int16_t)h;
      E1n[d] = (int16_t)e1;
      E2n[d] = (int16_t)e2;
      F1n[d] = (int16_t)f1;
      F2n[d] = (int16_t)f2;
      drow[d] = srcb | e1c | e2c | f1c | f2c;
    }
    // trackers (same scan order/tie rules as scalar: lane-ascending,
    // strict '>'): SIMD max then a short scalar pass only on improve
    {
      // Tracker fast path: the horizontal reduction only runs when a
      // lanewise mask test says some lane beats the running best —
      // compared against broadcast best16, so the serial per-diagonal
      // cost in the common no-improve case is two vector compares.
      // All decisions (strict '>', ascending-lane tie scan, zdrop
      // entry condition) are bit-identical to the always-reduce form.
      __m512i vmax = _mm512_loadu_si512((const __m512i*)(H1n + 0));
      for (int vd = 32; vd < W; vd += 32)
        vmax = _mm512_max_epi16(
            vmax, _mm512_loadu_si512((const __m512i*)(H1n + vd)));
      bool improved = false;
      if (_mm512_cmpgt_epi16_mask(vmax, _mm512_set1_epi16(best16)) &&
          d_lo <= d_hi) {
        int16_t diag_best = reduce_max_epi16(vmax);
        for (int d = d_lo; d <= d_hi; ++d) {
          if (H1n[d] == diag_best) {
            best16 = diag_best;
            best_i = lo + d;
            best_j = s - (lo + d);
            best_real = true;
            improved = true;
            break;
          }
        }
      }
      int d_last = (Q - 1) - lo;
      if (d_last >= d_lo && d_last <= d_hi) {
        int16_t h = H1n[d_last];
        if (h > g16) { g16 = h; g_j = s - (Q - 1); g_real = true; }
        if (s == S - 1) { end16 = h; end_real = true; }
      }
      // zdrop with ksw2's diagonal-offset allowance (see the scalar
      // engine for the derivation; identical lane scan keeps the two
      // paths' termination bit-identical).  Entry condition
      // diag_best < best16 - zdrop is evaluated as a mask test
      // against the broadcast threshold: if the diagonal improved
      // best16 the condition is false by construction; otherwise any
      // lane >= best16 - zdrop is the original free early accept.
      bool zdead = false;
      bool enter_zdrop = false;
      if (!improved && mode != 0 && zdrop > 0 && best16 > JUNK_CUT16) {
        const int32_t thr1 = (int32_t)best16 - zdrop - 1;  // alive if > thr1
        if (thr1 >= 32767) {
          enter_zdrop = true;  // no lane can reach the threshold
        } else if (thr1 >= -32768) {
          enter_zdrop = !_mm512_cmpgt_epi16_mask(
              vmax, _mm512_set1_epi16((int16_t)thr1));
        }  // thr1 < INT16_MIN: every lane >= threshold -> alive
      }
      if (enter_zdrop) {
        int32_t e_adj = (gq2 > 0 && ge2 < ge) ? ge2 : ge;
        int32_t bd = best_i - best_j;
        zdead = true;
        for (int d = d_lo; d <= d_hi; ++d) {
          int32_t off = 2 * (lo + d) - s - bd;
          if (off < 0) off = -off;
          if ((int32_t)H1n[d] >= (int32_t)best16 - zdrop - e_adj * off) {
            zdead = false;
            break;
          }
        }
      }
      std::swap(H1, H2);
      std::swap(H1, H1n);
      std::swap(E1v, E1n);
      std::swap(E2v, E2n);
      std::swap(F1v, F1n);
      std::swap(F2v, F2n);
      lo2 = lo1;
      lo1 = lo;
      return zdead;
    }
  }

  void finish(Trackers* tk) const {
    // map junk-domain tracker values back to the int32 "unreachable"
    // sentinel so the shared epilogue's NEGI/2 reachability tests
    // decide exactly as the scalar engine's
    tk->best_sc = (!best_real || best16 <= JUNK_CUT16) ? NEGI_BAND : best16;
    tk->best_i = best_i;
    tk->best_j = best_j;
    tk->g_sc = (!g_real || g16 <= JUNK_CUT16) ? NEGI_BAND : g16;
    tk->g_j = g_j;
    tk->end_sc = (!end_real || end16 <= JUNK_CUT16) ? NEGI_BAND : end16;
  }
};

void band_fill_avx512(const uint8_t* q0, const uint8_t* t0, int Q, int T,
                      int W, int a, int b, int gq, int ge, int gq2,
                      int ge2, int sc_ambi, int mode, int zdrop,
                      uint8_t* dir_out, Trackers* tk) {
  Band512Consts C;
  C.init(a, b, gq, ge, gq2, ge2, sc_ambi);
  BandFill512 J;
  J.init(q0, t0, Q, T, W, a, b, gq, ge, gq2, ge2, sc_ambi, mode, zdrop,
         dir_out, 0);
  int s = 0;
  bool done = false;
  for (; s < J.S && !(W == 32 && s >= 34); ++s)
    if (J.step(s, C)) { done = true; break; }
  if (!done && s < J.S) {
    // W == 32 register loop: rows live in locals (zmm) for the whole
    // remaining sweep
    J.enter_reg();
    __m512i h1 = J.rH1, h2 = J.rH2, e1 = J.rE1, e2 = J.rE2,
            f1 = J.rF1, f2 = J.rF2;
    for (; s < J.S; ++s)
      if (J.step32r(s, C, h1, h2, e1, e2, f1, f2)) break;
  }
  J.finish(tk);
}

// Two independent jobs, anti-diagonal loops interleaved: the serial
// diagonal->diagonal dependency chain of one W=32 job underuses the
// OoO core; two chains in one loop overlap.  Each job runs the same
// step() as the single-job loop, on its own scratch slot, so outputs
// are bit-identical to two sequential fills.
void band_fill_avx512_pair(
    const uint8_t* q1, const uint8_t* t1, int Q1, int T1, int W1,
    int mode1, uint8_t* dir1, Trackers* tk1,
    const uint8_t* q2, const uint8_t* t2, int Q2, int T2, int W2,
    int mode2, uint8_t* dir2, Trackers* tk2,
    int a, int b, int gq, int ge, int gq2, int ge2, int sc_ambi,
    int zdrop) {
  Band512Consts C;
  C.init(a, b, gq, ge, gq2, ge2, sc_ambi);
  BandFill512 JA, JB;
  JA.init(q1, t1, Q1, T1, W1, a, b, gq, ge, gq2, ge2, sc_ambi, mode1,
          zdrop, dir1, 0);
  JB.init(q2, t2, Q2, T2, W2, a, b, gq, ge, gq2, ge2, sc_ambi, mode2,
          zdrop, dir2, 1);
  bool dA = false, dB = false;
  // rows of both jobs in loop-locals: 12 zmm registers + temporaries
  // fit the 32-register file, so the two dependency chains interleave
  // without touching memory between diagonals
  __m512i aH1{}, aH2{}, aE1{}, aE2{}, aF1{}, aF2{};
  __m512i bH1{}, bH2{}, bE1{}, bE2{}, bF1{}, bF2{};
  for (int s = 0; !(dA || s >= JA.S) || !(dB || s >= JB.S); ++s) {
    if (!dA && s < JA.S) {
      if (JA.W == 32 && !JA.reg_on && s >= 34) {
        JA.enter_reg();
        aH1 = JA.rH1; aH2 = JA.rH2; aE1 = JA.rE1; aE2 = JA.rE2;
        aF1 = JA.rF1; aF2 = JA.rF2;
      }
      dA = JA.reg_on
               ? JA.step32r(s, C, aH1, aH2, aE1, aE2, aF1, aF2)
               : JA.step(s, C);
    }
    if (!dB && s < JB.S) {
      if (JB.W == 32 && !JB.reg_on && s >= 34) {
        JB.enter_reg();
        bH1 = JB.rH1; bH2 = JB.rH2; bE1 = JB.rE1; bE2 = JB.rE2;
        bF1 = JB.rF1; bF2 = JB.rF2;
      }
      dB = JB.reg_on
               ? JB.step32r(s, C, bH1, bH2, bE1, bE2, bF1, bF2)
               : JB.step(s, C);
    }
  }
  JA.finish(tk1);
  JB.finish(tk2);
}

#endif  // MAPPY_AVX512

bool g_force_scalar_band = false;

}  // namespace

extern "C" {

// test hook: force the scalar band fill (SIMD/scalar equivalence tests)
void extend_set_force_scalar(int v) { g_force_scalar_band = v != 0; }

}  // extern "C"

extern "C" {

// BANDED dual-affine DP + traceback, host-side, same static
// anti-diagonal band as the device kernels (lane d of diagonal s is
// row i = band_lo(s)+d).  Bit-compatible with ops/extend.py /
// extend_pallas.py: same borders, precedence, continue flags, and
// tracker tie rules (smallest (s, i) among equals for best cell,
// smallest s for the last-row tracker).  Production extension engine
// (the Mosaic device kernel is measured ~2x slower at J=256 and would
// contend with the front end for the chip — see CONTRIBUTING.md).
// Band fill dispatches to an AVX-512BW int16 path when the job's
// score range provably fits (simd_fits); scalar otherwise.
// One banded extension job: band fill (AVX-512 int16 when the
// score range provably fits, scalar otherwise) + traceback.
// Shared by extend_banded_batch (uniform W/mode), extend_jobs_batch
// (per-job W/mode over concatenated buffers) and post_chain.cc's
// fused record emission (external linkage for that TU).
static void extend_one_job_impl(
    const uint8_t* q, const uint8_t* t, int Q_, int T_, int W,
    int a, int b, int gq, int ge, int gq2, int ge2, int sc_ambi,
    int end_bonus, int mode, int zdrop,
    int32_t* ops_out, int32_t* out_n1, int max_ops,
    int32_t* out_info4, const uint8_t* pre_dir, const Trackers* pre_tk) {
  const int32_t NEGI = NEGI_BAND;
  {
    int Q = Q_, T = T_;
    int32_t* ops = ops_out;
    int32_t* info = out_info4;
    (*out_n1) = 0;
    info[0] = info[1] = info[2] = info[3] = 0;
    if (Q <= 0 || T <= 0) return;
    int S = Q + T - 1;
    const uint8_t* dir;
    Trackers tkv;
    if (pre_dir != nullptr) {
      // fill already done (interleaved pair path): walk it directly
      dir = pre_dir;
      tkv = *pre_tk;
    } else {
      // reusable per-thread dir buffer: the AVX-512 fill writes every
      // walkable lane itself (no zero-init needed); the scalar fill
      // only writes in-band lanes, so clear first on that path
      thread_local std::vector<uint8_t> dirbuf;
      if (dirbuf.size() < (size_t)S * W) dirbuf.resize((size_t)S * W);
      uint8_t* dirw = dirbuf.data();
#if defined(MAPPY_AVX512)
      if (!g_force_scalar_band &&
          simd_fits(Q, T, W, a, b, gq, ge, gq2, ge2, sc_ambi, end_bonus)) {
        band_fill_avx512(q, t, Q, T, W, a, b, gq, ge, gq2, ge2, sc_ambi,
                         mode, zdrop, dirw, &tkv);
      } else
#endif
      {
        memset(dirw, 0, (size_t)S * W);
        band_fill_scalar(q, t, Q, T, W, a, b, gq, ge, gq2, ge2, sc_ambi,
                         mode, zdrop, dirw, &tkv);
      }
      dir = dirw;
    }
    int32_t best_sc = tkv.best_sc, best_i = tkv.best_i, best_j = tkv.best_j;
    int32_t g_sc = tkv.g_sc, g_j = tkv.g_j, end_sc = tkv.end_sc;
    int si, sj, sc;
    if (mode == 2) {
      // global with zdrop split (minimap2 gap-filling semantics):
      // when the end-cell score fell below the running max by more
      // than the DIAGONAL-ADJUSTED allowance (ksw2's rule — zdrop
      // plus the long-gap extension slope times the diagonal offset
      // between the end cell and the max cell, so pure long indels
      // align through while divergence splits), the alignment is
      // truncated at the max cell and flagged so the caller splits
      // the region.  The in-fill early-termination check applies the
      // same allowance per anti-diagonal.
      int32_t e_adj = (gq2 > 0 && ge2 < ge) ? ge2 : ge;
      int32_t dd_end = (Q - 1 - best_i) - (T - 1 - best_j);
      if (dd_end < 0) dd_end = -dd_end;
      bool dropped =
          end_sc <= NEGI / 2 ||
          (zdrop > 0 && end_sc <= best_sc - (zdrop + e_adj * dd_end));
      if (dropped && best_sc > NEGI / 2) {
        si = best_i; sj = best_j; sc = best_sc;
      } else if (end_sc > NEGI / 2) {
        si = Q - 1; sj = T - 1; sc = end_sc;
        dropped = false;
      } else {
        return;
      }
      info[3] = dropped ? 1 : 0;
    } else if (mode == 0) {
      si = Q - 1; sj = T - 1; sc = end_sc;
      if (end_sc <= NEGI / 2) return;  // end cell unreachable in band
    } else {
      bool use_end = g_sc > NEGI / 2 && g_sc + end_bonus >= best_sc;
      if (use_end && g_sc > 0) { si = Q - 1; sj = g_j; sc = g_sc; }
      else if (best_sc > 0) { si = best_i; sj = best_j; sc = best_sc; }
      else return;
    }
    int n_ops = 0;
    bool overflow = false;
    auto emit = [&](int op, int cnt) {
      if (n_ops > 0 && (ops[n_ops - 1] & 0xF) == op) ops[n_ops - 1] += cnt << 4;
      else if (n_ops < max_ops) ops[n_ops++] = (cnt << 4) | op;
      else overflow = true;
    };
    int i = si, j = sj, state = 0;
    while (i >= 0 && j >= 0 && !overflow) {
      int s = i + j;
      int d = i - band_lo(s, Q, T, W);
      uint8_t byte = (d >= 0 && d < W) ? dir[(int64_t)s * W + d] : 0;
      if (state == 0) {
        int src = byte & H_SRC_MASK;
        if (src == 0) { emit(0, 1); --i; --j; }
        else state = src;
      } else if (state == 1 || state == 2) {
        emit(2, 1);
        bool cont = byte & (state == 1 ? E1_CONT : E2_CONT);
        --j;
        if (!cont) state = 0;
      } else {
        emit(1, 1);
        bool cont = byte & (state == 3 ? F1_CONT : F2_CONT);
        --i;
        if (!cont) state = 0;
      }
    }
    if (i >= 0) emit(1, i + 1);
    if (j >= 0) emit(2, j + 1);
    for (int x = 0, y = n_ops - 1; x < y; ++x, --y) std::swap(ops[x], ops[y]);
    (*out_n1) = overflow ? -1 : n_ops;
    info[0] = sc;
    info[1] = si + 1;
    info[2] = sj + 1;
  }
}

void extend_one_job(
    const uint8_t* q, const uint8_t* t, int Q_, int T_, int W,
    int a, int b, int gq, int ge, int gq2, int ge2, int sc_ambi,
    int end_bonus, int mode, int zdrop,
    int32_t* ops_out, int32_t* out_n1, int max_ops,
    int32_t* out_info4) {
  extend_one_job_impl(q, t, Q_, T_, W, a, b, gq, ge, gq2, ge2, sc_ambi,
                      end_bonus, mode, zdrop, ops_out, out_n1, max_ops,
                      out_info4, nullptr, nullptr);
}

// Two INDEPENDENT jobs in one call.  When both band fills take the
// AVX-512 path their anti-diagonal loops run interleaved
// (band_fill_avx512_pair) so the two serial dependency chains overlap
// in the OoO core; otherwise the jobs run sequentially.  Per-job
// outputs are bit-identical to two extend_one_job calls either way.
void extend_two_jobs(
    const uint8_t* q1, const uint8_t* t1, int Q1, int T1, int W1,
    int mode1, int32_t* ops1, int32_t* n1, int max_ops1, int32_t* info1,
    const uint8_t* q2, const uint8_t* t2, int Q2, int T2, int W2,
    int mode2, int32_t* ops2, int32_t* n2, int max_ops2, int32_t* info2,
    int a, int b, int gq, int ge, int gq2, int ge2, int sc_ambi,
    int end_bonus, int zdrop) {
#if defined(MAPPY_AVX512)
  if (!g_force_scalar_band && Q1 > 0 && T1 > 0 && Q2 > 0 && T2 > 0 &&
      simd_fits(Q1, T1, W1, a, b, gq, ge, gq2, ge2, sc_ambi, end_bonus) &&
      simd_fits(Q2, T2, W2, a, b, gq, ge, gq2, ge2, sc_ambi, end_bonus)) {
    const int64_t SA = (int64_t)(Q1 + T1 - 1) * W1;
    const int64_t SB = (int64_t)(Q2 + T2 - 1) * W2;
    thread_local std::vector<uint8_t> dir_a, dir_b;
    if ((int64_t)dir_a.size() < SA) dir_a.resize(SA);
    if ((int64_t)dir_b.size() < SB) dir_b.resize(SB);
    Trackers tka, tkb;
    band_fill_avx512_pair(q1, t1, Q1, T1, W1, mode1, dir_a.data(), &tka,
                          q2, t2, Q2, T2, W2, mode2, dir_b.data(), &tkb,
                          a, b, gq, ge, gq2, ge2, sc_ambi, zdrop);
    extend_one_job_impl(q1, t1, Q1, T1, W1, a, b, gq, ge, gq2, ge2,
                        sc_ambi, end_bonus, mode1, zdrop, ops1, n1,
                        max_ops1, info1, dir_a.data(), &tka);
    extend_one_job_impl(q2, t2, Q2, T2, W2, a, b, gq, ge, gq2, ge2,
                        sc_ambi, end_bonus, mode2, zdrop, ops2, n2,
                        max_ops2, info2, dir_b.data(), &tkb);
    return;
  }
#endif
  extend_one_job_impl(q1, t1, Q1, T1, W1, a, b, gq, ge, gq2, ge2,
                      sc_ambi, end_bonus, mode1, zdrop, ops1, n1,
                      max_ops1, info1, nullptr, nullptr);
  extend_one_job_impl(q2, t2, Q2, T2, W2, a, b, gq, ge, gq2, ge2,
                      sc_ambi, end_bonus, mode2, zdrop, ops2, n2,
                      max_ops2, info2, nullptr, nullptr);
}

void extend_banded_batch(const uint8_t* qs, const uint8_t* ts,
                         const int32_t* qlen, const int32_t* tlen,
                         int J, int QSTRIDE, int TSTRIDE, int W,
                         int a, int b, int gq, int ge, int gq2, int ge2,
                         int sc_ambi, int end_bonus, int mode, int zdrop,
                         int32_t* out_ops, int32_t* out_n, int max_ops,
                         int32_t* out_info) {
  for (int job = 0; job < J; ++job) {
    extend_one_job(qs + (int64_t)job * QSTRIDE,
                   ts + (int64_t)job * TSTRIDE, qlen[job], tlen[job],
                   W, a, b, gq, ge, gq2, ge2, sc_ambi, end_bonus,
                   mode, zdrop, out_ops + (int64_t)job * max_ops,
                   out_n + job, max_ops, out_info + (int64_t)job * 4);
  }
}

// Per-job band/mode over CONCATENATED job buffers: one call per
// device batch, no host-side padding or shape grouping (the
// padded-group staging was ~0.08 ms/read of numpy time).
void extend_jobs_batch(const uint8_t* q_concat, const int64_t* q_off,
                       const uint8_t* t_concat, const int64_t* t_off,
                       const int32_t* qlen, const int32_t* tlen,
                       const int32_t* Wv, const int32_t* modev,
                       int J, int a, int b, int gq, int ge, int gq2,
                       int ge2, int sc_ambi, int end_bonus, int zdrop,
                       int32_t* out_ops, int32_t* out_n, int max_ops,
                       int32_t* out_info) {
  // consecutive jobs are independent: run them two at a time so the
  // AVX-512 fills interleave (see extend_two_jobs)
  int job = 0;
  for (; job + 1 < J; job += 2) {
    extend_two_jobs(q_concat + q_off[job], t_concat + t_off[job],
                    qlen[job], tlen[job], Wv[job], modev[job],
                    out_ops + (int64_t)job * max_ops, out_n + job,
                    max_ops, out_info + (int64_t)job * 4,
                    q_concat + q_off[job + 1], t_concat + t_off[job + 1],
                    qlen[job + 1], tlen[job + 1], Wv[job + 1],
                    modev[job + 1],
                    out_ops + (int64_t)(job + 1) * max_ops,
                    out_n + job + 1, max_ops,
                    out_info + (int64_t)(job + 1) * 4,
                    a, b, gq, ge, gq2, ge2, sc_ambi, end_bonus, zdrop);
  }
  if (job < J) {
    extend_one_job(q_concat + q_off[job], t_concat + t_off[job],
                   qlen[job], tlen[job], Wv[job], a, b, gq, ge, gq2,
                   ge2, sc_ambi, end_bonus, modev[job], zdrop,
                   out_ops + (int64_t)job * max_ops, out_n + job,
                   max_ops, out_info + (int64_t)job * 4);
  }
}


// cs tag (short form), minimap2 mm_gen_cs semantics; ops are packed
// len<<4|op.  Returns bytes written, or -1 if cap is too small.
int64_t gen_cs_native(const int32_t* ops, int n_ops, const uint8_t* q,
                      const uint8_t* t, char* out, int64_t cap) {
  static const char LOWER[] = "acgtn";
  int64_t qi = 0, ti = 0, w = 0;
  auto put = [&](char c) { if (w < cap) out[w] = c; ++w; };
  auto put_num = [&](int64_t v) {
    char tmp[20];
    int nd = 0;
    if (v == 0) tmp[nd++] = '0';
    while (v > 0) { tmp[nd++] = (char)('0' + v % 10); v /= 10; }
    while (nd > 0) put(tmp[--nd]);
  };
  for (int k = 0; k < n_ops; ++k) {
    int op = ops[k] & 0xF;
    int n = ops[k] >> 4;
    if (op == 0) {
      int run = 0;
      for (int x = 0; x < n; ++x) {
        uint8_t qc = q[qi + x], tc = t[ti + x];
        if (qc == tc && qc < 4) {
          ++run;
        } else {
          if (run) { put(':'); put_num(run); run = 0; }
          put('*');
          put(LOWER[tc > 4 ? 4 : tc]);
          put(LOWER[qc > 4 ? 4 : qc]);
        }
      }
      if (run) { put(':'); put_num(run); }
      qi += n;
      ti += n;
    } else if (op == 1) {
      put('+');
      for (int x = 0; x < n; ++x) put(LOWER[q[qi + x] > 4 ? 4 : q[qi + x]]);
      qi += n;
    } else if (op == 3) {
      // intron: ~, donor dinucleotide, length, acceptor dinucleotide
      put('~');
      put(n >= 1 ? LOWER[t[ti] > 4 ? 4 : t[ti]] : 'n');
      put(n >= 2 ? LOWER[t[ti + 1] > 4 ? 4 : t[ti + 1]] : 'n');
      put_num(n);
      put(n >= 2 ? LOWER[t[ti + n - 2] > 4 ? 4 : t[ti + n - 2]] : 'n');
      put(n >= 1 ? LOWER[t[ti + n - 1] > 4 ? 4 : t[ti + n - 1]] : 'n');
      ti += n;
    } else {
      put('-');
      for (int x = 0; x < n; ++x) put(LOWER[t[ti + x] > 4 ? 4 : t[ti + x]]);
      ti += n;
    }
  }
  return w <= cap ? w : -1;
}

// MD tag (SAM spec), minimap2 mm_gen_MD semantics.
int64_t gen_md_native(const int32_t* ops, int n_ops, const uint8_t* q,
                      const uint8_t* t, char* out, int64_t cap) {
  static const char UPPER[] = "ACGTN";
  int64_t qi = 0, ti = 0, w = 0;
  auto put = [&](char c) { if (w < cap) out[w] = c; ++w; };
  auto put_num = [&](int64_t v) {
    char tmp[20];
    int nd = 0;
    if (v == 0) tmp[nd++] = '0';
    while (v > 0) { tmp[nd++] = (char)('0' + v % 10); v /= 10; }
    while (nd > 0) put(tmp[--nd]);
  };
  int64_t run = 0;
  for (int k = 0; k < n_ops; ++k) {
    int op = ops[k] & 0xF;
    int n = ops[k] >> 4;
    if (op == 0) {
      for (int x = 0; x < n; ++x) {
        uint8_t qc = q[qi + x], tc = t[ti + x];
        if (qc == tc && qc < 4) {
          ++run;
        } else {
          put_num(run);
          put(UPPER[tc > 4 ? 4 : tc]);
          run = 0;
        }
      }
      qi += n;
      ti += n;
    } else if (op == 1) {
      qi += n;
    } else if (op == 3) {
      ti += n;  // introns are invisible to MD (match run continues)
    } else {
      put_num(run);
      run = 0;
      put('^');
      for (int x = 0; x < n; ++x) put(UPPER[t[ti + x] > 4 ? 4 : t[ti + x]]);
      ti += n;
    }
  }
  put_num(run);
  return w <= cap ? w : -1;
}

// CIGAR statistics: mlen (exact matches), blen (M+I+D), NM.
void cigar_stats(const int32_t* ops, int n_ops, const uint8_t* q,
                 const uint8_t* t, int32_t* out) {
  int64_t qi = 0, ti = 0, mlen = 0, blen = 0, nm = 0;
  for (int k = 0; k < n_ops; ++k) {
    int op = ops[k] & 0xF;
    int n = ops[k] >> 4;
    if (op == 3) {  // intron: consumes ref, excluded from blen/NM
      ti += n;
      continue;
    }
    blen += n;
    if (op == 0) {
      for (int x = 0; x < n; ++x) {
        if (q[qi + x] == t[ti + x] && q[qi + x] < 4)
          ++mlen;
        else
          ++nm;
      }
      qi += n;
      ti += n;
    } else if (op == 1) {
      nm += n;
      qi += n;
    } else {
      nm += n;
      ti += n;
    }
  }
  out[0] = (int32_t)mlen;
  out[1] = (int32_t)blen;
  out[2] = (int32_t)nm;
}

// Batched region finalize: for R regions, merge each region's part
// CIGARs (left flank reversed, mid segments, right flank) into one
// run-length-merged op array, then compute stats and (optionally) the
// cs / MD tag strings — all in ONE call so the Python worker pays
// one ctypes crossing per device batch instead of ~6 per read.
//
//   ops_concat/part_off[P+1]: packed (len<<4|op) ops of every part,
//     concatenated; part_rev[P] nonzero => iterate that part reversed
//   reg_part_off[R+1]: parts p in [reg_part_off[i], reg_part_off[i+1])
//     belong to region i (contiguous, in merge order)
//   q_concat/q_off[R+1]: strand-oriented query segment per region
//     (q_al[q_st_a:q_en_a])
//   ref/t_off[R]: target segment = ref + t_off[i] (absolute offset)
//   out_ops: caller-allocated, same size as ops_concat; region i's
//     merged ops are written at ops offset part_off[reg_part_off[i]]
//     (merging never grows the op count), out_nops[i] = count
//   out_stats[R*3]: mlen, blen, NM per region
//   cs_buf/cs_off[R+1]/cs_len[R]: per-region cs string (want_cs);
//     cs_len = -1 if the region's slice was too small (caller retries)
//   md_buf/md_off/md_len: same for MD (want_md)
void finalize_batch(
    const int32_t* ops_concat, const int64_t* part_off,
    const uint8_t* part_rev, const int32_t* reg_part_off,
    const uint8_t* q_concat, const int64_t* q_off, const uint8_t* ref,
    const int64_t* t_off, int R, int want_cs, int want_md,
    int32_t* out_ops, int32_t* out_nops, int32_t* out_stats,
    char* cs_buf, const int64_t* cs_off, int64_t* cs_len,
    char* md_buf, const int64_t* md_off, int64_t* md_len) {
  for (int i = 0; i < R; ++i) {
    int p0 = reg_part_off[i], p1 = reg_part_off[i + 1];
    int64_t w0 = part_off[p0];
    int32_t* out = out_ops + w0;
    int64_t n_out = 0;
    for (int p = p0; p < p1; ++p) {
      int64_t a = part_off[p], b = part_off[p + 1];
      if (part_rev[p]) {
        for (int64_t x = b - 1; x >= a; --x) {
          int32_t v = ops_concat[x];
          if ((v >> 4) <= 0) continue;
          if (n_out && (out[n_out - 1] & 0xF) == (v & 0xF))
            out[n_out - 1] += (v >> 4) << 4;
          else
            out[n_out++] = v;
        }
      } else {
        for (int64_t x = a; x < b; ++x) {
          int32_t v = ops_concat[x];
          if ((v >> 4) <= 0) continue;
          if (n_out && (out[n_out - 1] & 0xF) == (v & 0xF))
            out[n_out - 1] += (v >> 4) << 4;
          else
            out[n_out++] = v;
        }
      }
    }
    out_nops[i] = (int32_t)n_out;
    const uint8_t* q = q_concat + q_off[i];
    const uint8_t* t = ref + t_off[i];
    cigar_stats(out, (int)n_out, q, t, out_stats + 3 * i);
    if (want_cs)
      cs_len[i] = gen_cs_native(out, (int)n_out, q, t, cs_buf + cs_off[i],
                                cs_off[i + 1] - cs_off[i]);
    if (want_md)
      md_len[i] = gen_md_native(out, (int)n_out, q, t, md_buf + md_off[i],
                                md_off[i + 1] - md_off[i]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// FASTA/FASTQ parser (the native data-loader analogue of the
// reference's needletail path, src/lib.rs fastx handling): one scan
// pass sizes the output blobs, one fill pass copies name / comment /
// sequence / quality bytes into caller-allocated buffers with [R+1]
// cumulative offsets.  Line/tokenization semantics replicate
// mappy_rs_tpu.fastx_read's python fallback exactly: lines split on
// '\n' only ('\r' is kept as data), empty lines are skipped between
// records, FASTQ records are strict 4-line groups (a truncated final
// record is dropped), header names are the first whitespace token and
// comments the remainder after the whitespace run (length 0 => None).

namespace {

inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

struct FastxOut {
  bool fill;
  uint8_t *names, *comments, *seqs, *quals;
  int64_t *name_off, *com_off, *seq_off, *qual_off;
  int64_t R = 0, nname = 0, ncom = 0, nseq = 0, nqual = 0;

  void bytes(uint8_t* dst, int64_t& total, const uint8_t* src,
             int64_t len) {
    if (fill && len > 0) std::memcpy(dst + total, src, (size_t)len);
    total += len;
  }
  void finish_record() {
    ++R;
    if (fill) {
      name_off[R] = nname;
      com_off[R] = ncom;
      seq_off[R] = nseq;
      qual_off[R] = nqual;
    }
  }
  void header(const uint8_t* buf, int64_t ls, int64_t le) {
    int64_t p = ls + 1;  // past '>' / '@'
    while (p < le && is_ws(buf[p])) ++p;
    int64_t n0 = p;
    while (p < le && !is_ws(buf[p])) ++p;
    bytes(names, nname, buf + n0, p - n0);
    while (p < le && is_ws(buf[p])) ++p;
    if (p < le) bytes(comments, ncom, buf + p, le - p);
  }
};

// walks the buffer once; returns record count, fills totals[0..3]
// (names, comments, seqs, quals) and *mode_out (0 fasta, 1 fastq,
// -1 empty input)
int64_t fastx_walk(const uint8_t* buf, int64_t n, FastxOut& o,
                   int64_t* totals, int* mode_out) {
  int64_t i = 0;
  int mode = -1;
  bool in_rec = false;
  auto next_line = [&](int64_t& ls, int64_t& le) -> bool {
    if (i >= n) return false;
    ls = i;
    const void* nl = std::memchr(buf + i, '\n', (size_t)(n - i));
    le = nl ? (int64_t)((const uint8_t*)nl - buf) : n;
    i = le < n ? le + 1 : n;
    return true;
  };
  if (o.fill) {
    o.name_off[0] = o.com_off[0] = o.seq_off[0] = o.qual_off[0] = 0;
  }
  int64_t ls, le;
  while (next_line(ls, le)) {
    if (le == ls) continue;  // skip empty lines between records
    if (mode < 0) mode = buf[ls] == '@' ? 1 : 0;
    if (mode == 0) {
      if (buf[ls] == '>') {
        if (in_rec) o.finish_record();
        o.header(buf, ls, le);
        in_rec = true;
      } else if (in_rec) {
        o.bytes(o.seqs, o.nseq, buf + ls, le - ls);
      }
      // lines before the first '>' are ignored, as in the fallback
    } else {
      int64_t s0, s1, p0, p1, q0, q1;
      if (!next_line(s0, s1) || !next_line(p0, p1) ||
          !next_line(q0, q1))
        break;  // truncated trailing record: dropped
      o.header(buf, ls, le);
      o.bytes(o.seqs, o.nseq, buf + s0, s1 - s0);
      o.bytes(o.quals, o.nqual, buf + q0, q1 - q0);
      o.finish_record();
    }
  }
  if (mode == 0 && in_rec) o.finish_record();
  if (totals) {
    totals[0] = o.nname;
    totals[1] = o.ncom;
    totals[2] = o.nseq;
    totals[3] = o.nqual;
  }
  if (mode_out) *mode_out = mode;
  return o.R;
}

}  // namespace

extern "C" {

int64_t fastx_scan(const uint8_t* buf, int64_t n, int64_t* totals,
                   int32_t* mode_out) {
  FastxOut o;
  o.fill = false;
  int mode = -1;
  int64_t r = fastx_walk(buf, n, o, totals, &mode);
  *mode_out = (int32_t)mode;
  return r;
}

void fastx_fill(const uint8_t* buf, int64_t n, uint8_t* names,
                int64_t* name_off, uint8_t* comments, int64_t* com_off,
                uint8_t* seqs, int64_t* seq_off, uint8_t* quals,
                int64_t* qual_off) {
  FastxOut o;
  o.fill = true;
  o.names = names;
  o.comments = comments;
  o.seqs = seqs;
  o.quals = quals;
  o.name_off = name_off;
  o.com_off = com_off;
  o.seq_off = seq_off;
  o.qual_off = qual_off;
  fastx_walk(buf, n, o, nullptr, nullptr);
}

}  // extern "C"
