// dense_expand (B18): every fan-out lane's guard, multiplicity and, with
// fingerprints on, its incremental fingerprint; the split-brain abort.
//
// Replaces the XLA program of tla_raft_tpu/ops/dense_expand.py
// DenseExpand.__call__ (:330) with ops/fingerprint.py msg_coef_eff (:392),
// delta_hash (:456), child_fingerprints (:528) and finalize (:505): the
// chunk expand of canon="expand" (SuccessorKernel._expand_dense) and, with
// fingerprints off, the legacy guard of TLA_RAFT_MXU=0 and of the --audit
// re-expansion (SuccessorKernel._expand_guards, successor.py:339).
//
// Design: one block per parent state, three phases.
//  1. The parent's packed message mask goes to shared memory, and the
//     block builds DenseExpand's message-block aggregates there
//     (dense_expand.py:367-381): per (pair, term) the VoteReq, VoteResp,
//     AppendReq and AppendResp counts (vq_r, vp, aq_r, ap_r), their sums
//     over the pairs that deliver to each server (to_cnt, aq_to_cnt), the
//     AppendReq counts per (pair, term, pli, plt) (AQR) and the up-to-date
//     VoteReq counts per (pair, term, myllt, mylli) (UP, the QUAL
//     contraction).  The guards read these, and single bits for the exact
//     requests and responses; nothing here shares code with K1
//     (guards.cu), so the legacy guard is an independent formulation.
//  2. With fingerprints on, the parent's hash per permutation and channel,
//     h[p][c] = sum_f feat[f] * Ceff[f][p][c] + sum over its messages of
//     the message's effective coefficient under p (K3's message tables),
//     goes to shared memory (P * 16 B), its (feature or mask word, output)
//     terms spread over the whole block.
//  3. Each thread takes slots k = tid, tid + blockDim, ...: the family's
//     guard and multiplicity; for a valid lane, the feature deltas of its
//     action (a short list of (feature, delta)) and its added messages with
//     their liveness (an id already in the set adds nothing), then per
//     permutation the child's hash = h[p] + deltas * Ceff + the added ids'
//     coefficients (computed, mix32 of the permuted id: only the pair digit
//     moves), folded to the minimum over P of the two 64-bit channel pairs
//     in registers.  The [B, K, P, 4] hash never reaches memory.
// Outputs: valid bool[B, K]; mult i32[B, K] (0 where invalid) or the
// counted form's mult_acc i64[K]; abort bool[B] or abort_acc; fp_view,
// fp_full i64[B, K] (SENT where invalid).  Rows past the device count
// cnt - sub are dead: nothing is written for them.
//
// Bound: bytes at S = 3 with fingerprints off (the mask and fields in,
// K * 5 B out per parent); with fingerprints on, the K * 16 B of
// fingerprints per parent dominate the writes, and the P-fold of the few
// valid lanes (about 3.5 a parent) is a few thousand integer operations a
// parent.
#include "common.cuh"

constexpr int DE_THREADS = 256;
constexpr int MAX_DELTAS = 40;  // kernels.DENSE_MAX_DELTAS: the wrapper refuses wider configs

__device__ inline int de_bit(const uint32_t* w, int id) { return (w[id >> 5] >> (id & 31)) & 1; }

__device__ inline int de_popc(const uint32_t* w, int a, int n) {
  int cnt = 0;
  const int e = a + n;
  while (a < e) {
    const int lo = a & 31;
    const int take = min(32 - lo, e - a);
    const uint32_t m = take == 32 ? 0xFFFFFFFFu : (((1u << take) - 1u) << lo);
    cnt += __popc(w[a >> 5] & m);
    a += take;
  }
  return cnt;
}

__device__ inline uint32_t de_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The signed-byte-plane linearization of a u32 coefficient (u64.py _eff_u32).
__device__ inline uint32_t de_eff(uint32_t x) {
  return x - (((x >> 7) & 1u) << 8) - (((x >> 15) & 1u) << 16) - (((x >> 23) & 1u) << 24);
}

// The pair digit's destination server (0-based): the inverse of pair_of.
__device__ inline int dst_of_pair(int p, int S) {
  const int a0 = p / (S - 1), di = p % (S - 1);
  return di + (di >= a0 ? 1 : 0);
}

struct FpTabs {
  const int32_t* ceff;     // [F, P, 4] effective feature coefficients
  const int32_t* msg_eff;  // monolithic [M, P, 4], or null
  const int32_t* gt_eff;   // factored [sum of strides, NP, 4], or null
  const int32_t* pperm;    // [P, NP] pair digit under each permutation
  int F, P, NP;
  int off[4], stride[4], row_base[4];
  uint32_t seed;
};

// One added message: its type, pair digit, rest digit and liveness.
struct Added {
  int type, pair, rest, live;
};

__global__ void dense_expand_kernel(Core Pc, const int32_t* __restrict__ msgs, int B,
                                    const int32_t* __restrict__ slot_tab, int K, Dims d,
                                    int want_fp, FpTabs tb, bool* __restrict__ valid_out,
                                    int32_t* __restrict__ mult_out, bool* __restrict__ abort_out,
                                    int64_t* __restrict__ fpv_out, int64_t* __restrict__ fpf_out,
                                    const int64_t* cnt, long long sub,
                                    unsigned long long* __restrict__ mult_acc,
                                    unsigned long long* __restrict__ abort_acc, long long base) {
  extern __shared__ uint32_t smem[];
  __shared__ int abort_flag;
  const int b = blockIdx.x;
  if (b >= live_count(cnt, sub, 1, B)) return;
  const int S = d.S, T = d.T, L = d.L, V = d.V, E = d.E, NPLI = d.NPLI;
  const int NP = S * (S - 1);
  uint32_t* bits = smem;
  int* agg = (int*)(smem + d.n_words);
  int* vq_r = agg;                       // [NP, T]
  int* vp_b = vq_r + NP * T;             // [NP, T]
  int* aq_r = vp_b + NP * T;             // [NP, T]
  int* ap_r = aq_r + NP * T;             // [NP, T]
  int* to_cnt = ap_r + NP * T;           // [S, T]
  int* aq_to = to_cnt + S * T;           // [S, T]
  int* AQR = aq_to + S * T;              // [NP, T, L, T + 1]
  int* UP = AQR + NP * T * L * (T + 1);  // [NP, T, T + 1, L]
  uint32_t* hb = (uint32_t*)(UP + NP * T * (T + 1) * L);  // [P, 4], then feat [F]

  for (int i = threadIdx.x; i < d.n_words; i += blockDim.x)
    bits[i] = (uint32_t)msgs[(size_t)b * d.n_words + i];
  if (threadIdx.x == 0) abort_flag = 0;
  __syncthreads();

  // -- phase 1: the message-block aggregates --------------------------------------
  const int vq_blk = L * T, aq_blk = L * (T + 1) * E * L, ap_blk = NPLI * 2;
  for (int i = threadIdx.x; i < NP * T; i += blockDim.x) {
    vq_r[i] = de_popc(bits, d.vq_off + i * vq_blk, vq_blk);
    vp_b[i] = de_bit(bits, d.vp_off + i);
    aq_r[i] = de_popc(bits, d.aq_off + i * aq_blk, aq_blk);
    ap_r[i] = de_popc(bits, d.ap_off + i * ap_blk, ap_blk);
  }
  for (int i = threadIdx.x; i < NP * T * L * (T + 1); i += blockDim.x)
    AQR[i] = de_popc(bits, d.aq_off + i * E * L, E * L);
  for (int i = threadIdx.x; i < NP * T * (T + 1) * L; i += blockDim.x) {
    // UP[p, t, m, j] = sum over (l, k) of vq[p, t, l, k] * QUAL[k, l, m, j]
    const int j = i % L, m = (i / L) % (T + 1), pt = i / (L * (T + 1));
    int c = 0;
    for (int l = 0; l < L; ++l)
      for (int k = 0; k < T; ++k)
        if ((k > m) || (k == m && l >= j)) c += de_bit(bits, d.vq_off + (pt * L + l) * T + k);
    UP[i] = c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * T; i += blockDim.x) {
    const int s = i / T, t = i % T;
    int all = 0, aq = 0;
    for (int p = 0; p < NP; ++p) {
      if (dst_of_pair(p, S) != s) continue;
      const int q = p * T + t;
      all += vq_r[q] + vp_b[q] + aq_r[q] + ap_r[q];
      aq += aq_r[q];
    }
    to_cnt[i] = all;
    aq_to[i] = aq;
  }

  const uint8_t* vf = Pc.f[VF] + (size_t)b * S;
  const uint8_t* ct = Pc.f[CT] + (size_t)b * S;
  const uint8_t* role = Pc.f[ROLE] + (size_t)b * S;
  const uint8_t* lt = Pc.f[LT] + (size_t)b * S * L;
  const uint8_t* lv = Pc.f[LV] + (size_t)b * S * L;
  const uint8_t* ll = Pc.f[LL] + (size_t)b * S;
  const uint8_t* mi = Pc.f[MI] + (size_t)b * S * S;
  const uint8_t* ni = Pc.f[NI] + (size_t)b * S * S;
  const uint8_t* ci = Pc.f[CI] + (size_t)b * S;
  const uint8_t* pend = Pc.f[PEND] + (size_t)b * S * S;
  const uint8_t* vs = Pc.f[VS] + (size_t)b * V;
  const int ec = Pc.f[EC][b], rc = Pc.f[RC][b];

  // -- phase 2: the parent's hash per permutation ----------------------------------
  // Work items (row, output): a feature row adds feat[f] * Ceff[f][o], a
  // mask word adds the coefficients of its set ids, each into hb[o] by a
  // shared atomicAdd (u32 sums wrap mod 2^32 in any order, so the sum is
  // exact).  Spreading the items over the block keeps many independent
  // table loads in flight.
  if (want_fp) {
    const int PC = tb.P * 4;
    int* featv = (int*)(hb + PC);  // [F]
    for (int i = threadIdx.x; i < PC; i += blockDim.x) hb[i] = 0;
    for (int f = threadIdx.x; f < tb.F; f += blockDim.x)
      featv[f] = (int)(int8_t)(uint8_t)feature(Pc, b, f, d);
    __syncthreads();
    const long long items = (long long)(tb.F + d.n_words) * PC;
    for (long long i = threadIdx.x; i < items; i += blockDim.x) {
      const int o = (int)(i % PC), r = (int)(i / PC);
      uint32_t h = 0;
      if (r < tb.F) {
        if (featv[r] == 0) continue;
        h = (uint32_t)featv[r] * (uint32_t)tb.ceff[(size_t)r * PC + o];
      } else {
        const int w = r - tb.F;
        uint32_t x = bits[w];
        if (!x) continue;
        const int p = o >> 2, c = o & 3;
        while (x) {
          const int m = w * 32 + (__ffs(x) - 1);
          x &= x - 1;
          if (tb.msg_eff) {
            h += (uint32_t)tb.msg_eff[(size_t)m * PC + o];
          } else {
            const int t = (m >= tb.off[1]) + (m >= tb.off[2]) + (m >= tb.off[3]);
            const int q = (m - tb.off[t]) / tb.stride[t];
            const int rr = m - tb.off[t] - q * tb.stride[t];
            const int qp = tb.pperm[p * tb.NP + q];
            h += (uint32_t)tb.gt_eff[((size_t)(tb.row_base[t] + rr) * tb.NP + qp) * 4 + c];
          }
        }
      }
      atomicAdd(&hb[o], h);
    }
  }
  __syncthreads();

  // the split-brain Assert (Raft.tla:185): UpdateTerm (b) at a leader
  if (threadIdx.x == 0 && !d.become_follower) {
    for (int s = 0; s < S; ++s) {
      const int tix = clampi(ct[s] - 1, 0, T - 1);
      if (ct[s] >= 1 && aq_to[s * T + tix] > 0 && role[s] == LEADER) abort_flag = 1;
    }
  }

  // feature offsets of ops/fingerprint.py FeatureSpec
  const int o_ct = 0, o_role = S, o_lt = 2 * S, o_lv = 2 * S + S * L, o_ll = 2 * S + 2 * S * L;
  const int o_mi = o_ll + S, o_ni = o_mi + S * S, o_ci = o_ni + S * S, o_vf = o_ci + S;
  const int o_ec = o_vf + S * (S + 1), o_rc = o_ec + 1, o_pend = o_rc + 1, o_vs = o_pend + S * S;

  // -- phase 3: the slots ------------------------------------------------------------
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int32_t* cc = slot_tab + (size_t)k * 6;
    const int fam = cc[0], s = cc[1], c1 = cc[2], c2 = cc[3], c3 = cc[4], c4 = cc[5];
    const int ct_s = ct[s], role_s = role[s], ll_s = ll[s], ci_s = ci[s], vf_s = vf[s];
    const int tix = clampi(ct_s - 1, 0, T - 1);
    const bool has_term = ct_s >= 1;
    const int lpos = clampi(ll_s - 1, 0, L - 1);
    const int llt_val = lt[s * L + lpos];
    const int tcur1 = clampi(ct_s, 1, T);
    bool ok = false;
    int mult = 1;
    switch (fam) {
      case 0:  // BecomeCandidate(s)
        ok = ec < d.max_election && (role_s == FOLLOWER || role_s == CANDIDATE);
        break;
      case 1:  // UpdateTerm (a): any message to s at term c1 + 1
        mult = to_cnt[s * T + c1];
        ok = c1 + 1 > ct_s && mult > 0;
        break;
      case 2:  // UpdateTerm (b): an AppendReq to s at its term
        mult = aq_to[s * T + tix];
        ok = has_term && mult > 0 && role_s == CANDIDATE;
        break;
      case 3: {  // ResponseVote(s, cand = c1)
        int qual = 0, grant = 0;
        if (c1 != s) {
          qual = UP[((pair_of(d, c1, s) * T + tix) * (T + 1) + clampi(llt_val, 0, T)) * L + lpos];
          grant = vp_b[pair_of(d, s, c1) * T + tix];
        }
        const bool vf_ok = d.double_vote || vf_s == 0 || vf_s == c1 + 1;
        mult = qual;
        ok = role_s == FOLLOWER && has_term && c1 != s && vf_ok && qual > 0 && grant == 0;
        break;
      }
      case 4: {  // BecomeLeader(s): a majority of votes
        int votes = 0;
        for (int p = 0; p < NP; ++p)
          if (dst_of_pair(p, S) == s) votes += vp_b[p * T + tix];
        ok = role_s == CANDIDATE && votes + 1 >= d.majority;
        break;
      }
      case 5:  // ClientReq(s, v = c1)
        ok = role_s == LEADER && vs[c1] == 0 && ll_s < L;
        break;
      case 6: {  // LeaderAppendEntry(s, dst = c1): the request not in flight
        const int nsd = ni[s * S + c1];
        int present = 0;
        if (c1 != s) {
          const int pli = clampi(nsd - 1, 1, L);
          const int plt = clampi(lt[s * L + clampi(nsd - 2, 0, L - 1)], 0, T);
          const int epos = clampi(nsd - 1, 0, L - 1);
          const int ecode = nsd <= ll_s ? 1 + (clampi(lt[s * L + epos], 1, T) - 1) * V +
                                              (clampi(lv[s * L + epos], 1, V) - 1)
                                        : 0;
          present = de_bit(bits, aq_id(d, pair_of(d, s, c1), tcur1, pli, plt, ecode,
                                       clampi(ci_s, 1, L)));
        }
        ok = role_s == LEADER && c1 != s && nsd <= ll_s + 1 && pend[s * S + c1] == 0 &&
             present == 0;
        break;
      }
      case 7: {  // FollowerAcceptEntry(s, src = c1, pli = c2 + 1, e = c3, lc = c4 + 1)
        int present = 0;
        if (c1 != s) {
          const int plt = clampi(lt[s * L + c2], 0, T);
          present = de_bit(bits, aq_id(d, pair_of(d, c1, s), tix + 1, c2 + 1, plt, c3, c4 + 1));
        }
        ok = role_s == FOLLOWER && has_term && c1 != s && c2 + 1 <= ll_s && present > 0;
        if (ok && d.legacy_append) {  // Raft.tla:347-348: resp unsent or commit advances
          const int nl = c2 + 1 + (c3 > 0);
          const int pi = nl < L ? nl : L;
          const int resp = de_bit(bits, d.ap_off + ((pair_of(d, s, c1) * T + tix) * NPLI +
                                                    (pi - d.ap_pli_min)) * 2 + 1);
          const int minlc = c4 + 1 < nl ? c4 + 1 : nl;
          ok = resp == 0 || minlc > ci_s;
        }
        break;
      }
      case 8: {  // FollowerRejectEntry(s, src = c1, pli = c2 + 1)
        int tot = 0, match = 0, rej = 0;
        if (c1 != s) {
          const int q = (pair_of(d, c1, s) * T + tix) * L + c2;
          for (int m = 0; m <= T; ++m) tot += AQR[q * (T + 1) + m];
          match = AQR[q * (T + 1) + clampi(lt[s * L + c2], 0, T)];
          rej = de_bit(bits, d.ap_off + ((pair_of(d, s, c1) * T + tix) * NPLI + c2) * 2);
        }
        mult = tot - (c2 + 1 <= ll_s ? match : 0);
        ok = role_s == FOLLOWER && has_term && c1 != s && mult > 0 && rej == 0;
        break;
      }
      case 9: {  // HandleAppendResp(s, src = c1, pli = c2 + 1, succ = c3)
        int bit = 0;
        if (c1 != s)
          bit = de_bit(bits, d.ap_off + ((pair_of(d, c1, s) * T + tix) * NPLI + c2 +
                                         (1 - d.ap_pli_min)) * 2 + c3);
        const int pli = c2 + 1, msc = mi[s * S + c1], nsc = ni[s * S + c1];
        const bool st_ok = c3 == 1 ? msc < pli : (pli + 1 == nsc && pli > msc);
        ok = role_s == LEADER && has_term && c1 != s && pend[s * S + c1] == 1 && bit > 0 && st_ok;
        break;
      }
      case 10:  // LeaderCanCommit(s)
        ok = role_s == LEADER && rank_median(mi + s * S, S, d.median_index) > ci_s;
        break;
      default:  // Restart(s)
        ok = role_s == LEADER && rc < d.max_restart;
        break;
    }
    const size_t lane = (size_t)b * K + k;
    valid_out[lane] = ok;
    if (mult_out) mult_out[lane] = ok ? mult : 0;
    if (ok && mult_acc) atomicAdd(&mult_acc[k], (unsigned long long)(long long)mult);
    if (!want_fp) continue;
    if (!ok) {
      fpv_out[lane] = -1;
      fpf_out[lane] = -1;
      continue;
    }

    // the action's feature deltas and added messages (dense_expand.py:407-759)
    int fi[MAX_DELTAS], dv[MAX_DELTAS];
    int nd = 0;
    Added add[8];  // kernels.DENSE_MAX_ADDED
    int na = 0;
    auto delta = [&](int f, int v) {
      if (v != 0 && nd < MAX_DELTAS) {
        fi[nd] = f;
        dv[nd] = v;
        ++nd;
      }
    };
    auto vf_to = [&](int w) {  // votedFor[s]: vf_s -> w (the one-hot pair)
      delta(o_vf + s * (S + 1) + w, 1);
      delta(o_vf + s * (S + 1) + vf_s, -1);
    };
    switch (fam) {
      case 0: {
        const int nt = clampi(ct_s + 1, 1, T);
        const int llt = clampi(llt_val, 0, T - 1);
        delta(o_ct + s, nt - ct_s);
        delta(o_role + s, CANDIDATE - role_s);
        vf_to(s + 1);
        delta(o_ec, 1);
        for (int r = 0; r < S - 1; ++r) {
          const int pr = pair_of(d, s, (s + 1 + r) % S);
          const int present = de_bit(bits, vq_id(d, pr, nt, lpos + 1, llt));
          add[na++] = Added{0, pr, ((nt - 1) * L + (ll_s - 1)) * T + llt, !present};
        }
        break;
      }
      case 1:
        delta(o_ct + s, c1 + 1 - ct_s);
        delta(o_role + s, FOLLOWER - role_s);
        if (!(d.become_follower && role_s == FOLLOWER)) vf_to(0);
        break;
      case 2:
        delta(o_role + s, FOLLOWER - role_s);
        break;
      case 3:
        vf_to(c1 + 1);
        add[na++] = Added{1, pair_of(d, s, c1), tcur1 - 1, !vp_b[pair_of(d, s, c1) * T + tix]};
        break;
      case 4:
        delta(o_role + s, LEADER - role_s);
        for (int u = 0; u < S; ++u) {
          delta(o_mi + s * S + u, (u == s ? ll_s : 1) - mi[s * S + u]);
          delta(o_ni + s * S + u, ll_s + 1 - ni[s * S + u]);
          delta(o_pend + s * S + u, -(int)pend[s * S + u]);
        }
        break;
      case 5: {
        const int pos = clampi(ll_s, 0, L - 1);
        delta(o_lt + s * L + pos, ct_s - lt[s * L + pos]);
        delta(o_lv + s * L + pos, c1 + 1 - lv[s * L + pos]);
        delta(o_ll + s, 1);
        delta(o_mi + s * S + s, ll_s + 1 - mi[s * S + s]);
        delta(o_vs + c1, 1 - vs[c1]);
        break;
      }
      case 6: {
        const int nsd = ni[s * S + c1];
        const int pli = clampi(nsd - 1, 1, L);
        const int plt = clampi(lt[s * L + clampi(nsd - 2, 0, L - 1)], 0, T);
        const int epos = clampi(nsd - 1, 0, L - 1);
        const int ecode = nsd <= ll_s ? 1 + (clampi(lt[s * L + epos], 1, T) - 1) * V +
                                            (clampi(lv[s * L + epos], 1, V) - 1)
                                      : 0;
        const int lc = clampi(ci_s, 1, L);
        delta(o_pend + s * S + c1, 1 - pend[s * S + c1]);
        const int rest = ((((tcur1 - 1) * L + (pli - 1)) * (T + 1) + plt) * E + ecode) * L + lc - 1;
        add[na++] = Added{2, pair_of(d, s, c1), rest, 1};  // the guard: not present
        break;
      }
      case 7: {
        const int l = c2, e = c3, h = c4;
        const int el = e > 0;
        const int eterm = el ? (e - 1) / V + 1 : 0, evl = el ? (e - 1) % V + 1 : 0;
        const int nl = l + 1 + el;
        const int nx = l + 1 < L - 1 ? l + 1 : L - 1;  // lt_next[l] = lt[min(l + 1, L - 1)]
        const bool conflict = el == 1 && l + 1 < ll_s &&
                              (lt[s * L + nx] != eterm || lv[s * L + nx] != evl);
        if (nl > ll_s || conflict) {
          const int at_j = l + 1 < L - 1 ? l + 1 : L - 1;
          for (int j = 0; j < L; ++j) {
            const int at = (j == at_j && e >= 1) ? 1 : 0;
            const int keepx = (j <= l && !at) ? 1 : 0;
            delta(o_lt + s * L + j, (keepx - 1) * lt[s * L + j] + at * eterm);
            delta(o_lv + s * L + j, (keepx - 1) * lv[s * L + j] + at * evl);
          }
          delta(o_ll + s, nl - ll_s);
        }
        const int minlc = h + 1 < nl ? h + 1 : nl;
        delta(o_ci + s, (ci_s > minlc ? ci_s : minlc) - ci_s);
        const int pi = nl < L ? nl : L;
        const int pr = pair_of(d, s, c1);
        const int resp = de_bit(bits, d.ap_off + ((pr * T + tix) * NPLI + (pi - d.ap_pli_min)) * 2 + 1);
        add[na++] = Added{3, pr, ((tcur1 - 1) * NPLI + (pi - d.ap_pli_min)) * 2 + 1, !resp};
        break;
      }
      case 8: {
        const int pr = pair_of(d, s, c1);
        add[na++] = Added{3, pr, ((tcur1 - 1) * NPLI + c2) * 2, 1};  // the guard: unsent
        break;
      }
      case 9: {
        const int pli = c2 + 1, x = c3;
        delta(o_mi + s * S + c1, x * (pli - mi[s * S + c1]));
        delta(o_ni + s * S + c1, pli + x - ni[s * S + c1]);
        delta(o_pend + s * S + c1, -(int)pend[s * S + c1]);
        break;
      }
      case 10:
        delta(o_ci + s, rank_median(mi + s * S, S, d.median_index) - ci_s);
        break;
      default:
        delta(o_role + s, FOLLOWER - role_s);
        delta(o_rc, 1);
        break;
    }

    unsigned long long best_v = ~0ull, best_f = ~0ull;
    for (int p = 0; p < tb.P; ++p) {
      uint32_t h[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) h[c] = hb[p * 4 + c];
      for (int i = 0; i < nd; ++i) {
        const int32_t* co = tb.ceff + ((size_t)fi[i] * tb.P + p) * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) h[c] += (uint32_t)dv[i] * (uint32_t)co[c];
      }
      for (int a = 0; a < na; ++a) {
        if (!add[a].live) continue;
        const int t = add[a].type;
        const uint32_t idp = (uint32_t)(tb.off[t] + tb.pperm[p * tb.NP + add[a].pair] * tb.stride[t] +
                                        add[a].rest);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h[c] += de_eff(de_mix32(idp * 0x9E3779B9u + (uint32_t)c * 0x85EBCA6Bu + tb.seed));
      }
      const unsigned long long v = ((unsigned long long)h[0] << 32) | h[1];
      const unsigned long long f = ((unsigned long long)h[2] << 32) | h[3];
      best_v = v < best_v ? v : best_v;
      best_f = f < best_f ? f : best_f;
    }
    fpv_out[lane] = (int64_t)best_v;
    fpf_out[lane] = (int64_t)best_f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (abort_out) abort_out[b] = abort_flag != 0;
    if (abort_flag && abort_acc) atomicMin(abort_acc, (unsigned long long)(base + b));
  }
}

// Dynamic shared memory of one block: the mask, the aggregates and (with
// fingerprints) the parent's hash per permutation.
static size_t de_smem(const Dims& d, int want_fp, int P, int F) {
  const int NP = d.S * (d.S - 1), S = d.S, T = d.T, L = d.L;
  const size_t ints = (size_t)4 * NP * T + 2 * S * T + 2 * (size_t)NP * T * L * (T + 1);
  return 4 * ((size_t)d.n_words + ints + (want_fp ? (size_t)P * 4 + F : 0));
}

// tdims = off[4], stride[4], row_base[4] of the message types.  msg_eff
// (monolithic) or gt_eff (factored) is null; with want_fp = 0 every table
// may be null.  mult and abort_out may be null (the counted form's
// mult_acc / abort_acc take them); fpv / fpf are written with want_fp.
EXPORT int launch_dense_expand(const void* const* core, const int32_t* msgs, int B,
                               const int32_t* slot_tab, int K, const int* dims, int want_fp,
                               const int32_t* ceff, int F, int P, const int32_t* msg_eff,
                               const int32_t* gt_eff, const int32_t* pperm, int NP,
                               const int* tdims, long long seed, bool* valid, int32_t* mult,
                               bool* abort_out, int64_t* fpv, int64_t* fpf, const int64_t* cnt,
                               long long sub, int64_t* mult_acc, int64_t* abort_acc,
                               long long base, void* stream) {
  Core Pc;
  for (int i = 0; i < N_FIELDS; ++i) Pc.f[i] = (const uint8_t*)core[i];
  Dims d = load_dims(dims);
  if (d.S < 2) return (int)cudaErrorInvalidValue;
  FpTabs tb;
  tb.ceff = ceff;
  tb.msg_eff = msg_eff;
  tb.gt_eff = gt_eff;
  tb.pperm = pperm;
  tb.F = F;
  tb.P = P;
  tb.NP = NP;
  for (int i = 0; i < 4; ++i) {
    tb.off[i] = tdims[i];
    tb.stride[i] = tdims[4 + i];
    tb.row_base[i] = tdims[8 + i];
  }
  tb.seed = (uint32_t)seed;
  const size_t smem = de_smem(d, want_fp, P, F);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(dense_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  if (B > 0)
    dense_expand_kernel<<<B, DE_THREADS, smem, (cudaStream_t)stream>>>(
        Pc, msgs, B, slot_tab, K, d, want_fp, tb, valid, mult, abort_out, fpv, fpf, cnt, sub,
        (unsigned long long*)mult_acc, (unsigned long long*)abort_acc, base);
  return (int)cudaGetLastError();
}

WARM((const void*)dense_expand_kernel)
