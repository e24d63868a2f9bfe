// Full post-chain record emission in ONE native call per device batch
// (VERDICT r3 "next round" #3): compact chain rows -> finished mapping
// records.  Covers the whole host tail the Python engine otherwise
// walks per read — region generation (ops/regions.py
// regions_from_compact), primary marking (set_parent), secondary
// selection (select_sub), extension job building + banded DP
// (pipeline._make_jobs/_run_jobs_host), part merge + stats + cs/MD
// (finalize_batch core), aligned-coordinate re-parenting, mapq
// (set_mapq) and the final filter/sort.  Reads that touch a rare path
// (zdrop split -> inversion rescue, cap overflow) are flagged for the
// Python fallback, which reruns them bit-identically.
//
// Reference parity: mm_gen_regs/mm_set_parent/mm_select_sub/
// mm_set_mapq behavior behind mappy-rs src/lib.rs:482-509 via
// the C core; every rule here is a verbatim port of the Python
// oracle (ops/regions.py, models/pipeline.py) which tests pin.

#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

// shared engine internals (mappy_native.cc, same .so; the definition
// sits inside that file's extern "C" block, so declare C linkage)
extern "C" {
void extend_one_job(const uint8_t* q, const uint8_t* t, int Q_, int T_,
                    int W, int a, int b, int gq, int ge, int gq2, int ge2,
                    int sc_ambi, int end_bonus, int mode, int zdrop,
                    int32_t* ops_out, int32_t* out_n1, int max_ops,
                    int32_t* out_info4);
void extend_two_jobs(const uint8_t* q1, const uint8_t* t1, int Q1, int T1,
                     int W1, int mode1, int32_t* ops1, int32_t* n1,
                     int max_ops1, int32_t* info1, const uint8_t* q2,
                     const uint8_t* t2, int Q2, int T2, int W2, int mode2,
                     int32_t* ops2, int32_t* n2, int max_ops2,
                     int32_t* info2, int a, int b, int gq, int ge, int gq2,
                     int ge2, int sc_ambi, int end_bonus, int zdrop);
int64_t gen_cs_native(const int32_t* ops, int n_ops, const uint8_t* q,
                      const uint8_t* t, char* out, int64_t cap);
int64_t gen_md_native(const int32_t* ops, int n_ops, const uint8_t* q,
                      const uint8_t* t, char* out, int64_t cap);
void cigar_stats(const int32_t* ops, int n_ops, const uint8_t* q,
                 const uint8_t* t, int32_t* out);
}

namespace {

// int param block indices (keep in sync with native/__init__.py)
enum {
  IP_SPAN = 0,     // default k-mer span (index.k)
  IP_MASK_LEN,
  IP_BEST_N,
  IP_MIN_DP_MAX,
  IP_A,
  IP_B,
  IP_GQ,
  IP_GE,
  IP_GQ2,
  IP_GE2,
  IP_SC_AMBI,
  IP_END_BONUS,
  IP_ZDROP,
  IP_MIN_CHAIN_SC,
  IP_IS_SR,
  IP_BW,           // min(opt.bw, flank_band // 2), pre-computed
  IP_FLANK_BAND,
  IP_MID_FLOOR,
  IP_MID_SLACK,
  IP_SEG_LEN,
  IP_CIGCAP,
  IP_N
};

// output field indices (keep in sync with native/__init__.py)
enum {
  F_REV = 0,
  F_RID,
  F_QS,
  F_QE,
  F_RS,
  F_RE,
  F_SCORE,
  F_CNT,
  F_ID,
  F_PARENT,
  F_SUBSC,
  F_NSUB,
  F_DPSCORE,
  F_DPMAX2,
  F_MAPQ,
  F_MLEN,
  F_BLEN,
  F_NM,
  F_NFIELDS
};

struct PReg {
  int32_t rev, rid, qs, qe, rs, re, score, cnt;
  int32_t id = -1, parent = -1, subsc = 0, n_sub = 0;
  std::vector<int32_t> anchors_q, anchors_r;  // ascending
  // extension results
  int32_t qs_a = 0, qe_a = 0;
  std::vector<std::vector<int32_t>> mid_ops;
  std::vector<int32_t> mid_sc;
  std::vector<int32_t> left_ops, right_ops;
  int32_t lsc = 0, lq = 0, lt = 0, rsc = 0, rq = 0, rt = 0;
  // finalize
  int32_t dp_score = 0, dp_max2 = 0, mapq = 0;
  int32_t q_st_a = 0, q_en_a = 0, r_st = 0, r_en = 0;
  int32_t mlen = 0, blen = 0, nm = 0;
  std::vector<int32_t> cigar;
  int64_t cs_n = 0, md_n = 0;  // lengths written into the slot buffers
  int slot = -1;               // output slot (cs/md buffer index)
  bool alive = true;
};

// ops/regions.py set_parent — greedy primary marking by query-interval
// overlap.  (Re)assigns ids by list position and parents; subsc/n_sub
// ACCUMULATE across calls, exactly as the Python dataclass fields do
// (the second, aligned-coordinate pass adds to the first pass's
// counts — pinned behavior).
void set_parent(std::vector<PReg*>& regs, double mask_level,
                int32_t mask_len) {
  if (regs.empty()) return;
  int n = (int)regs.size();
  for (int i = 0; i < n; ++i) regs[i]->id = i;
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
    if (regs[x]->score != regs[y]->score)
      return regs[x]->score > regs[y]->score;
    return x < y;
  });
  std::vector<int> primaries;
  for (int oi : order) {
    PReg* r = regs[oi];
    bool assigned = false;
    for (int j : primaries) {
      PReg* pr = regs[j];
      int32_t s = r->qs > pr->qs ? r->qs : pr->qs;
      int32_t e = r->qe < pr->qe ? r->qe : pr->qe;
      int32_t ol = e - s > 0 ? e - s : 0;
      int32_t min_l = (r->qe - r->qs) < (pr->qe - pr->qs)
                          ? (r->qe - r->qs)
                          : (pr->qe - pr->qs);
      if ((double)ol > mask_level * (double)min_l && min_l < mask_len) {
        r->parent = pr->id;
        if (r->score > pr->subsc) pr->subsc = r->score;
        pr->n_sub += 1;
        assigned = true;
        break;
      }
    }
    if (!assigned) {
      r->parent = r->id;
      primaries.push_back(oi);
    }
  }
}

// ops/regions.py select_sub — keep primaries + up to best_n good
// secondaries, emitted in (-score, id) order.
void select_sub(std::vector<PReg*>& regs, double pri_ratio, int best_n) {
  if (pri_ratio <= 0.0) return;
  int n = (int)regs.size();
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
    if (regs[x]->score != regs[y]->score)
      return regs[x]->score > regs[y]->score;
    return regs[x]->id < regs[y]->id;
  });
  std::vector<PReg*> out;
  int n_2nd = 0;
  for (int oi : order) {
    PReg* r = regs[oi];
    if (r->parent == r->id) {
      out.push_back(r);
    } else {
      PReg* parent = nullptr;
      for (PReg* c : regs)
        if (c->id == r->parent) { parent = c; break; }
      if (parent != nullptr &&
          (double)r->score >= (double)parent->score * pri_ratio &&
          n_2nd < best_n) {
        out.push_back(r);
        ++n_2nd;
      }
    }
  }
  regs.swap(out);
}

// ops/regions.py set_mapq — double math to match Python float exactly
void set_mapq(std::vector<PReg*>& regs, int32_t min_chain_score,
              int32_t rep_len, bool is_sr) {
  const double q_coef = 40.0;
  int64_t sum_sc = 0;
  for (PReg* r : regs)
    if (r->parent == r->id) sum_sc += r->score;
  double uniq_ratio = (sum_sc + rep_len) > 0
                          ? (double)sum_sc / (double)(sum_sc + rep_len)
                          : 1.0;
  for (PReg* r : regs) {
    if (r->parent != r->id || r->score <= 0) {
      r->mapq = 0;
      continue;
    }
    double pen_s1 =
        (r->score > 100 ? 1.0 : 0.01 * (double)r->score) * uniq_ratio;
    double pen_cm = r->cnt > 10 ? 1.0 : 0.1 * (double)r->cnt;
    double pen = pen_s1 < pen_cm ? pen_s1 : pen_cm;
    int32_t subsc =
        r->subsc > min_chain_score ? r->subsc : min_chain_score;
    double log_sc = r->score > 1 ? std::log((double)r->score) : 0.0;
    int32_t dp_max = r->dp_score;
    int mapq;
    if (dp_max > 0 && r->dp_max2 > 0) {
      double identity =
          r->blen > 0 ? (double)r->mlen / (double)r->blen : 0.0;
      double x = (double)r->dp_max2 / (double)dp_max;
      if (x > 1.0) x = 1.0;
      mapq = (int)(identity * pen * q_coef * (1.0 - x) * log_sc);
    } else if (dp_max > 0) {
      double identity =
          r->blen > 0 ? (double)r->mlen / (double)r->blen : 0.0;
      double x = (double)subsc / (double)r->score;
      mapq = (int)(identity * pen * q_coef * (1.0 - x) * log_sc);
    } else {
      double x = (double)subsc / (double)r->score;
      mapq = (int)(pen * q_coef * (1.0 - x) * log_sc);
    }
    if (r->n_sub > 0)
      mapq -= (int)(4.343 * std::log((double)r->n_sub + 1.0) + 0.499);
    if (mapq < 0) mapq = 0;
    if (mapq > 60) mapq = 60;
    if (is_sr && r->score > subsc && mapq < 1) mapq = 1;
    r->mapq = mapq;
  }
}

// run-length merge append (finalize_batch core)
inline void merge_append(std::vector<int32_t>& out, int32_t v) {
  if ((v >> 4) <= 0) return;
  if (!out.empty() && (out.back() & 0xF) == (v & 0xF))
    out.back() += (v >> 4) << 4;
  else
    out.push_back(v);
}

}  // namespace

extern "C" {

// One call per device batch: chains -> packed finished records.
//   chains  int32 [B, K, FLD] compact chain rows (backtrack layout)
//   codes   uint8 concat read codes, code_off int64 [B+1]
//   rep_len int32 [B]
//   ref     uint8 whole reference codes; seq_off/seq_len int64 per rid
//   ip      int32 [IP_N] param block, dp double [2] =
//           {mask_level, pri_ratio}
// outputs (caller-allocated):
//   out_nreg   int32 [B]  surviving regions per read (final order)
//   out_fields int32 [B, K, F_NFIELDS]
//   out_cig    int32 [B, K, CIGCAP], out_ncig int32 [B, K]
//   cs_buf/md_buf char [B*K*cap_per] with per-slot capacity cap_per
//   cs_len/md_len int64 [B, K]  (-1 = not requested / absent)
//   fallback   uint8 [B]: 1 = python must remap this read (zdrop
//              split, cap overflow) — its out_* slots are unspecified
//   stats_out  double [2]: {dp_cells, n_jobs} accumulated
void post_chain_batch(
    const int32_t* chains, int B, int K, int FLD, const uint8_t* codes,
    const int64_t* code_off, const int32_t* rep_len, const uint8_t* ref,
    const int64_t* seq_off, const int64_t* seq_len, const int32_t* ip,
    const double* dpar, int want_cs, int want_md, int32_t* out_nreg,
    int32_t* out_fields, int32_t* out_cig, int32_t* out_ncig,
    char* cs_buf, int64_t cs_cap_per, int64_t* cs_len, char* md_buf,
    int64_t md_cap_per, int64_t* md_len, uint8_t* fallback,
    double* stats_out) {
  const double mask_level = dpar[0], pri_ratio = dpar[1];
  const int span_dflt = ip[IP_SPAN];
  const int seg_len = ip[IP_SEG_LEN];
  const int cigcap = ip[IP_CIGCAP];
  const int n_cuts_max = (FLD - 9) / 2;
  double cells = 0.0, n_jobs = 0.0;
  std::vector<PReg> pool;
  std::vector<PReg*> regs;
  std::vector<uint8_t> q_rc;      // revcomp scratch
  std::vector<uint8_t> jq, jt;    // reversed flank staging
  std::vector<int32_t> ops_tmp;
  for (int bi = 0; bi < B; ++bi) {
    fallback[bi] = 0;
    out_nreg[bi] = 0;
    const int32_t qlen = (int32_t)(code_off[bi + 1] - code_off[bi]);
    const uint8_t* q_fwd = codes + code_off[bi];
    // ---- regions_from_compact ----
    pool.clear();
    pool.reserve(K);
    for (int ki = 0; ki < K; ++ki) {
      const int32_t* row = chains + ((int64_t)bi * K + ki) * FLD;
      if (row[0] < 0) continue;
      PReg r;
      r.score = row[0];
      r.cnt = row[1];
      r.rev = row[2];
      r.rid = row[3];
      int32_t sp = row[8] > 0 ? row[8] : span_dflt;
      int32_t q_first = row[6], q_last = row[7];
      if (r.rev == 0) {
        r.qs = q_first + 1 - sp;
        r.qe = q_last + 1;
      } else {
        r.qs = qlen - (q_last + 1);
        r.qe = qlen - (q_first + 1 - sp);
      }
      r.rs = row[4] + 1 - sp > 0 ? row[4] + 1 - sp : 0;
      r.re = row[5] + 1;
      // cut pairs recorded end->start (descending qpos): reverse
      r.anchors_q.push_back(q_first);
      r.anchors_r.push_back(row[4]);
      for (int c = n_cuts_max - 1; c >= 0; --c) {
        int32_t cq = row[9 + 2 * c], cr = row[10 + 2 * c];
        if (cq >= 0) {
          r.anchors_q.push_back(cq);
          r.anchors_r.push_back(cr);
        }
      }
      r.anchors_q.push_back(q_last);
      r.anchors_r.push_back(row[5]);
      pool.push_back(std::move(r));
    }
    if (pool.empty()) continue;
    regs.clear();
    for (PReg& r : pool) regs.push_back(&r);
    set_parent(regs, mask_level, ip[IP_MASK_LEN]);
    select_sub(regs, pri_ratio, ip[IP_BEST_N]);
    if (regs.empty()) continue;
    // ---- jobs + extension (pipeline._make_jobs/_run_jobs_host) ----
    bool have_rc = false;
    bool fb = false;
    for (PReg* r : regs) {
      const uint8_t* q_al;
      if (r->rev == 0) {
        q_al = q_fwd;
        r->qs_a = r->qs;
        r->qe_a = r->qe;
      } else {
        if (!have_rc) {
          q_rc.resize(qlen);
          for (int32_t i = 0; i < qlen; ++i) {
            uint8_t c = q_fwd[qlen - 1 - i];
            q_rc[i] = c < 4 ? (uint8_t)(3 - c) : c;
          }
          have_rc = true;
        }
        q_al = q_rc.data();
        r->qs_a = qlen - r->qe;
        r->qe_a = qlen - r->qs;
      }
      const int64_t roff = seq_off[r->rid];
      const int64_t rlen = seq_len[r->rid];
      // mid segmentation (_mid_segments)
      std::vector<std::array<int32_t, 4>> segs;
      {
        int32_t qs_a = r->qs_a, qe_a = r->qe_a;
        int32_t sspan = qe_a - qs_a;
        if (sspan <= 2 * seg_len || (int)r->anchors_q.size() < 3) {
          segs.push_back({qs_a, qe_a, r->rs, r->re});
        } else {
          int32_t q_prev = qs_a, t_prev = r->rs;
          int32_t last_q = r->anchors_q[0];
          for (size_t ai = 1; ai + 1 < r->anchors_q.size(); ++ai) {
            int32_t aq = r->anchors_q[ai], at_ = r->anchors_r[ai];
            if (aq - last_q >= seg_len && aq + 1 - q_prev > 0) {
              if (aq + 1 > q_prev && at_ + 1 > t_prev) {
                segs.push_back({q_prev, aq + 1, t_prev, at_ + 1});
                q_prev = aq + 1;
                t_prev = at_ + 1;
                last_q = aq;
              }
            }
          }
          segs.push_back({q_prev, qe_a, t_prev, r->re});
          segs.erase(std::remove_if(segs.begin(), segs.end(),
                                    [](const std::array<int32_t, 4>& s) {
                                      return !(s[1] > s[0] && s[3] > s[2]);
                                    }),
                     segs.end());
        }
      }
      int32_t info[4], n1;
      auto run_job = [&](const uint8_t* jqp, const uint8_t* jtp,
                         int ql, int tl, int W, int mode,
                         std::vector<int32_t>& ops_out) -> int32_t {
        int max_ops = 2 * (ql + tl) + 8;
        if ((int)ops_tmp.size() < max_ops) ops_tmp.resize(max_ops);
        extend_one_job(jqp, jtp, ql, tl, W, ip[IP_A], ip[IP_B],
                       ip[IP_GQ], ip[IP_GE], ip[IP_GQ2], ip[IP_GE2],
                       ip[IP_SC_AMBI], ip[IP_END_BONUS], mode,
                       ip[IP_ZDROP], ops_tmp.data(), &n1, max_ops,
                       info);
        cells += (double)(ql + tl - 1) * W;
        n_jobs += 1.0;
        if (n1 < 0) { fb = true; n1 = 0; }
        ops_out.assign(ops_tmp.begin(), ops_tmp.begin() + n1);
        return n1;
      };
      // mid segments: mode 2, W = band rule (_mid_band).  The segs of
      // one region are independent, so consecutive runnable pairs go
      // through extend_two_jobs (interleaved AVX-512 fills).  Results
      // are then consumed in seg order with the exact same fb checks
      // the one-at-a-time loop made, so emitted records are identical
      // (on the rare fb path some segs run wastefully; their results
      // are discarded exactly as the python fallback remap would).
      {
        const int NSEG = (int)segs.size();
        std::vector<int32_t> seg_W(NSEG, 0), seg_n(NSEG, 0);
        std::vector<char> seg_run(NSEG, 0);  // runnable flag: seg_W==0
        // must not double as the store-empty sentinel (a
        // mid_band_floor=0 config computes a real W=0 job)
        std::vector<int32_t> seg_info(4 * (size_t)NSEG, 0);
        std::vector<std::vector<int32_t>> seg_ops(NSEG);
        int prev = -1;
        auto prep = [&](int k) -> bool {
          auto& s = segs[k];
          int ql = s[1] - s[0], tl = s[3] - s[2];
          if (ql <= 0 || tl <= 0) return false;  // store_empty
          int drift = ql > tl ? ql - tl : tl - ql;
          int need = 32 * ((drift + ip[IP_MID_SLACK] + 31) / 32);
          seg_W[k] = need > ip[IP_MID_FLOOR] ? need : ip[IP_MID_FLOOR];
          seg_ops[k].resize(2 * (ql + tl) + 8);
          return true;
        };
        for (int k = 0; k < NSEG; ++k) {
          if (!prep(k)) continue;
          seg_run[k] = 1;
          if (prev < 0) { prev = k; continue; }
          auto &sa = segs[prev], &sb = segs[k];
          extend_two_jobs(
              q_al + sa[0], ref + roff + sa[2], sa[1] - sa[0],
              sa[3] - sa[2], seg_W[prev], 2, seg_ops[prev].data(),
              &seg_n[prev], (int)seg_ops[prev].size(),
              &seg_info[4 * (size_t)prev],
              q_al + sb[0], ref + roff + sb[2], sb[1] - sb[0],
              sb[3] - sb[2], seg_W[k], 2, seg_ops[k].data(), &seg_n[k],
              (int)seg_ops[k].size(), &seg_info[4 * (size_t)k],
              ip[IP_A], ip[IP_B], ip[IP_GQ], ip[IP_GE], ip[IP_GQ2],
              ip[IP_GE2], ip[IP_SC_AMBI], ip[IP_END_BONUS],
              ip[IP_ZDROP]);
          prev = -1;
        }
        if (prev >= 0) {
          auto& sa = segs[prev];
          extend_one_job(q_al + sa[0], ref + roff + sa[2],
                         sa[1] - sa[0], sa[3] - sa[2], seg_W[prev],
                         ip[IP_A], ip[IP_B], ip[IP_GQ], ip[IP_GE],
                         ip[IP_GQ2], ip[IP_GE2], ip[IP_SC_AMBI],
                         ip[IP_END_BONUS], 2, ip[IP_ZDROP],
                         seg_ops[prev].data(), &seg_n[prev],
                         (int)seg_ops[prev].size(),
                         &seg_info[4 * (size_t)prev]);
        }
        for (int k = 0; k < NSEG; ++k) {
          auto& s = segs[k];
          int ql = s[1] - s[0], tl = s[3] - s[2];
          r->mid_ops.emplace_back();
          r->mid_sc.push_back(0);
          if (!seg_run[k]) continue;  // store_empty
          cells += (double)(ql + tl - 1) * seg_W[k];
          n_jobs += 1.0;
          int32_t n1s = seg_n[k];
          if (n1s < 0) { fb = true; n1s = 0; }
          r->mid_ops.back().assign(seg_ops[k].begin(),
                                   seg_ops[k].begin() + n1s);
          r->mid_sc.back() = seg_info[4 * (size_t)k];
          if (seg_info[4 * (size_t)k + 3]) fb = true;  // zdrop split
          if (fb) break;
        }
      }
      if (fb) break;
      // left flank: reversed q/t, mode 1
      if (r->qs_a > 0) {
        int32_t tl0 = r->rs < r->qs_a + ip[IP_BW] ? r->rs
                                                  : r->qs_a + ip[IP_BW];
        if (tl0 > 0) {
          int ql = r->qs_a, tl = tl0;
          jq.assign(q_al, q_al + ql);
          std::reverse(jq.begin(), jq.end());
          jt.assign(ref + roff + r->rs - tl0, ref + roff + r->rs);
          std::reverse(jt.begin(), jt.end());
          int32_t n = run_job(jq.data(), jt.data(), ql, tl,
                              ip[IP_FLANK_BAND], 1, r->left_ops);
          if (n > 0 || info[0] > 0) {
            r->lsc = info[0];
            r->lq = info[1];
            r->lt = info[2];
          } else {
            r->left_ops.clear();
            r->lsc = r->lq = r->lt = 0;
          }
        }
      }
      if (fb) break;
      // right flank
      if (r->qe_a < qlen) {
        int64_t avail = rlen - r->re;
        int64_t want = (int64_t)(qlen - r->qe_a) + ip[IP_BW];
        int32_t tl1 = (int32_t)(avail < want ? avail : want);
        if (tl1 > 0) {
          int ql = qlen - r->qe_a;
          int32_t n = run_job(q_al + r->qe_a, ref + roff + r->re, ql,
                              tl1, ip[IP_FLANK_BAND], 1, r->right_ops);
          if (n > 0 || info[0] > 0) {
            r->rsc = info[0];
            r->rq = info[1];
            r->rt = info[2];
          } else {
            r->right_ops.clear();
            r->rsc = r->rq = r->rt = 0;
          }
        }
      }
      if (fb) break;
    }
    if (fb) {
      fallback[bi] = 1;
      continue;
    }
    // ---- survive check + finalize (_finish_reads/_finalize_many) ----
    std::vector<PReg*> done;
    for (PReg* r : regs) {
      bool ok = true;
      for (auto& m : r->mid_ops)
        if (m.empty()) { ok = false; break; }
      if (ok) done.push_back(r);
    }
    if (done.empty()) continue;
    int slot = 0;
    bool overflow = false;
    for (PReg* r : done) {
      int32_t mid_total = 0;
      for (int32_t s : r->mid_sc) mid_total += s;
      r->dp_score = mid_total + r->lsc + r->rsc;
      r->q_st_a = r->qs_a - r->lq;
      r->q_en_a = r->qe_a + r->rq;
      r->r_st = r->rs - r->lt;
      r->r_en = r->re + r->rt;
      // merged CIGAR: left reversed, mids, right
      r->cigar.clear();
      for (auto it = r->left_ops.rbegin(); it != r->left_ops.rend(); ++it)
        merge_append(r->cigar, *it);
      for (auto& m : r->mid_ops)
        for (int32_t v : m) merge_append(r->cigar, v);
      for (int32_t v : r->right_ops) merge_append(r->cigar, v);
      if ((int)r->cigar.size() > cigcap) { overflow = true; break; }
      const uint8_t* q_al = r->rev == 0 ? q_fwd : q_rc.data();
      const uint8_t* qseg = q_al + r->q_st_a;
      const uint8_t* tseg = ref + seq_off[r->rid] + r->r_st;
      int32_t st[3];
      cigar_stats(r->cigar.data(), (int)r->cigar.size(), qseg, tseg, st);
      r->mlen = st[0];
      r->blen = st[1];
      r->nm = st[2];
      r->slot = slot++;
      if (want_cs) {
        r->cs_n = gen_cs_native(
            r->cigar.data(), (int)r->cigar.size(), qseg, tseg,
            cs_buf + ((int64_t)bi * K + r->slot) * cs_cap_per,
            cs_cap_per);
        if (r->cs_n < 0) { overflow = true; break; }
      }
      if (want_md) {
        r->md_n = gen_md_native(
            r->cigar.data(), (int)r->cigar.size(), qseg, tseg,
            md_buf + ((int64_t)bi * K + r->slot) * md_cap_per,
            md_cap_per);
        if (r->md_n < 0) { overflow = true; break; }
      }
      // read-forward query coords
      if (r->rev == 0) {
        r->qs = r->q_st_a;
        r->qe = r->q_en_a;
      } else {
        r->qs = qlen - r->q_en_a;
        r->qe = qlen - r->q_st_a;
      }
      r->rs = r->r_st;
      r->re = r->r_en;
    }
    if (overflow) {
      fallback[bi] = 1;
      continue;
    }
    // ---- aligned-coords re-parent + dp_max2 + mapq ----
    set_parent(done, mask_level, ip[IP_MASK_LEN]);
    for (PReg* r : done) r->dp_max2 = 0;
    for (PReg* r : done) {
      if (r->parent != r->id) {
        for (PReg* p : done)
          if (p->id == r->parent) {
            if (r->dp_score > p->dp_max2) p->dp_max2 = r->dp_score;
            break;
          }
      }
    }
    set_mapq(done, ip[IP_MIN_CHAIN_SC], rep_len[bi],
             ip[IP_IS_SR] != 0);
    // ---- min_dp filter + final sort + emit ----
    std::vector<PReg*> fin;
    for (PReg* r : done)
      if (r->dp_score >= ip[IP_MIN_DP_MAX]) fin.push_back(r);
    std::stable_sort(fin.begin(), fin.end(), [](PReg* x, PReg* y) {
      bool xs = x->parent != x->id, ys = y->parent != y->id;
      if (xs != ys) return !xs;
      return x->dp_score > y->dp_score;
    });
    out_nreg[bi] = (int)fin.size();
    for (size_t oi = 0; oi < fin.size(); ++oi) {
      PReg* r = fin[oi];
      int32_t* f = out_fields + ((int64_t)bi * K + oi) * F_NFIELDS;
      f[F_REV] = r->rev;
      f[F_RID] = r->rid;
      f[F_QS] = r->qs;
      f[F_QE] = r->qe;
      f[F_RS] = r->rs;
      f[F_RE] = r->re;
      f[F_SCORE] = r->score;
      f[F_CNT] = r->cnt;
      f[F_ID] = r->id;
      f[F_PARENT] = r->parent;
      f[F_SUBSC] = r->subsc;
      f[F_NSUB] = r->n_sub;
      f[F_DPSCORE] = r->dp_score;
      f[F_DPMAX2] = r->dp_max2;
      f[F_MAPQ] = r->mapq;
      f[F_MLEN] = r->mlen;
      f[F_BLEN] = r->blen;
      f[F_NM] = r->nm;
      std::memcpy(out_cig + ((int64_t)bi * K + oi) * cigcap,
                  r->cigar.data(), r->cigar.size() * sizeof(int32_t));
      out_ncig[(int64_t)bi * K + oi] = (int32_t)r->cigar.size();
      // cs/md were written at the pre-sort slot index; pack it into
      // the high word so the wrapper slices the right buffer region
      cs_len[(int64_t)bi * K + oi] =
          want_cs ? ((int64_t)r->slot << 32) | r->cs_n : -1;
      md_len[(int64_t)bi * K + oi] =
          want_md ? ((int64_t)r->slot << 32) | r->md_n : -1;
    }
  }
  stats_out[0] = cells;
  stats_out[1] = n_jobs;
}

}  // extern "C"
