// K1 guards: every slot's guard, multiplicity and the split-brain abort.
//
// Replaces the XLA program of tla_raft_tpu/ops/mxu_expand.py
// MXUExpand._guard_features + guards (the static guard conjunctions as a
// [B, 133] x [133, 696] matmul) and ops/dense_expand.py
// DenseExpand.msg_guard_parts (the message-side terms as block reductions
// over the 4,824-bit mask).  The TPU wanted a matmul; on this card a
// per-lane switch on the slot's family is the natural form.
//
// Design: one block per parent state.  The parent's packed message mask
// (151 words, 604 B at the reference constants) is staged in shared memory;
// each thread takes slots k = tid, tid + blockDim, ... and evaluates that
// slot's family guard term by term, with message counts as __popc over the
// contiguous id ranges the family reads.  Outputs: valid bool[B, K],
// mult i32[B, K] (0 where invalid), abort bool[B].
//
// Bound: bytes.  Per parent it reads ~670 B (mask + fields) and writes
// K * 5 B = 3.5 KB (valid + mult), so the writes dominate; the arithmetic
// per slot is a few dozen integer operations.  The simple design keeps the
// mask in shared memory so no slot re-reads device memory for its bits.
#include "common.cuh"

__device__ inline int bit_at(const uint32_t* w, int id) { return (w[id >> 5] >> (id & 31)) & 1; }

// Number of set bits with ids in [a, a + n).
__device__ inline int popc_range(const uint32_t* w, int a, int n) {
  int cnt = 0;
  int e = a + n;
  while (a < e) {
    int lo = a & 31;
    int take = min(32 - lo, e - a);
    uint32_t m = take == 32 ? 0xFFFFFFFFu : (((1u << take) - 1u) << lo);
    cnt += __popc(w[a >> 5] & m);
    a += take;
  }
  return cnt;
}

__global__ void guards_kernel(Core P, const int32_t* __restrict__ msgs, int B,
                              const int32_t* __restrict__ slot_tab, int K, Dims d,
                              bool* __restrict__ valid, int32_t* __restrict__ mult,
                              bool* __restrict__ abort_out) {
  extern __shared__ uint32_t bits[];
  __shared__ int abort_flag;
  const int b = blockIdx.x;
  if (b >= B) return;
  const int S = d.S, T = d.T, L = d.L, V = d.V, E = d.E;
  for (int i = threadIdx.x; i < d.n_words; i += blockDim.x)
    bits[i] = (uint32_t)msgs[(size_t)b * d.n_words + i];
  if (threadIdx.x == 0) abort_flag = 0;
  __syncthreads();

  const uint8_t* vf = P.f[VF] + (size_t)b * S;
  const uint8_t* ct = P.f[CT] + (size_t)b * S;
  const uint8_t* role = P.f[ROLE] + (size_t)b * S;
  const uint8_t* lt = P.f[LT] + (size_t)b * S * L;
  const uint8_t* lv = P.f[LV] + (size_t)b * S * L;
  const uint8_t* ll = P.f[LL] + (size_t)b * S;
  const uint8_t* mi = P.f[MI] + (size_t)b * S * S;
  const uint8_t* ni = P.f[NI] + (size_t)b * S * S;
  const uint8_t* ci = P.f[CI] + (size_t)b * S;
  const int ec = P.f[EC][b];
  const int rc = P.f[RC][b];
  const uint8_t* pend = P.f[PEND] + (size_t)b * S * S;
  const uint8_t* vs = P.f[VS] + (size_t)b * V;
  const int vq_blk = L * T;                      // VoteReq ids per (pair, term)
  const int aq_term_blk = L * (T + 1) * E * L;   // AppendReq ids per (pair, term)
  const int aq_pli_blk = (T + 1) * E * L;        // ... per (pair, term, pli)
  const int ap_term_blk = d.NPLI * 2;            // AppendResp ids per (pair, term)

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int32_t* c = slot_tab + (size_t)k * 6;
    const int fam = c[0], s = c[1], c1 = c[2], c2 = c[3], c3 = c[4], c4 = c[5];
    const int ct_s = ct[s], role_s = role[s], ll_s = ll[s], ci_s = ci[s];
    const int tix = clampi(ct_s - 1, 0, T - 1);  // the term digit a message to s carries
    const bool has_term = ct_s >= 1;
    bool ok = false;
    int m = 1;
    switch (fam) {
      case 0:  // BecomeCandidate
        ok = (role_s == FOLLOWER || role_s == CANDIDATE) && ec < d.max_election;
        break;
      case 1: {  // UpdateTerm (a): any message to s at term c1 + 1
        int cnt = 0;
        for (int src = 0; src < S; ++src) {
          if (src == s) continue;
          int p = pair_of(d, src, s);
          cnt += popc_range(bits, vq_id(d, p, c1 + 1, 1, 0), vq_blk);
          cnt += bit_at(bits, vp_id(d, p, c1 + 1));
          cnt += popc_range(bits, aq_id(d, p, c1 + 1, 1, 0, 0, 1), aq_term_blk);
          cnt += popc_range(bits, d.ap_off + (p * T + c1) * ap_term_blk, ap_term_blk);
        }
        ok = c1 + 1 > ct_s && cnt > 0;
        m = cnt;
        break;
      }
      case 2: {  // UpdateTerm (b) + the split-brain Assert (Raft.tla:185)
        int cnt = 0;
        for (int src = 0; src < S; ++src) {
          if (src == s) continue;
          cnt += popc_range(bits, aq_id(d, pair_of(d, src, s), tix + 1, 1, 0, 0, 1), aq_term_blk);
        }
        ok = role_s == CANDIDATE && has_term && cnt > 0;
        m = cnt;
        if (!d.become_follower && has_term && cnt > 0 && role_s == LEADER) abort_flag = 1;
        break;
      }
      case 3: {  // ResponseVote(s, cand = c1)
        const int cand = c1;
        const int vf_s = vf[s];
        const bool vf_ok = d.double_vote || vf_s == 0 || vf_s == cand + 1;
        int qual = 0, grant = 0;
        if (cand != s) {
          const int lpos = clampi(ll_s - 1, 0, L - 1);
          const int myllt = clampi(lt[s * L + lpos], 0, T);
          const int p = pair_of(d, cand, s);
          for (int l0 = 0; l0 < L; ++l0)
            for (int k2 = 0; k2 < T; ++k2)
              if (k2 > myllt || (k2 == myllt && l0 >= lpos))
                qual += bit_at(bits, vq_id(d, p, tix + 1, l0 + 1, k2));
          grant = bit_at(bits, vp_id(d, pair_of(d, s, cand), tix + 1));
        }
        ok = role_s == FOLLOWER && has_term && vf_ok && cand != s && qual > 0 && grant == 0;
        m = qual;
        break;
      }
      case 4: {  // BecomeLeader: the vote count (Raft.tla:160-164)
        int votes = 0;
        for (int src = 0; src < S; ++src)
          if (src != s) votes += bit_at(bits, vp_id(d, pair_of(d, src, s), tix + 1));
        ok = role_s == CANDIDATE && votes + 1 >= d.majority;
        break;
      }
      case 5:  // ClientReq(s, v = c1)
        ok = role_s == LEADER && vs[c1] == 0 && ll_s < L;
        break;
      case 6: {  // LeaderAppendEntry(s, dst = c1): the request not in flight
        const int dd = c1;
        const int nsd = ni[s * S + dd];
        bool present = false;
        if (dd != s) {
          const int pli = clampi(nsd - 1, 1, L);
          const int plt = clampi(lt[s * L + clampi(nsd - 2, 0, L - 1)], 0, T);
          const int epos = clampi(nsd - 1, 0, L - 1);
          const int et = clampi(lt[s * L + epos], 1, T);
          const int ev = clampi(lv[s * L + epos], 1, V);
          const int ecode = nsd <= ll_s ? 1 + (et - 1) * V + (ev - 1) : 0;
          present = bit_at(bits, aq_id(d, pair_of(d, s, dd), clampi(ct_s, 1, T), pli, plt, ecode,
                                       clampi(ci_s, 1, L)));
        }
        ok = role_s == LEADER && pend[s * S + dd] == 0 && nsd <= ll_s + 1 && dd != s && !present;
        break;
      }
      case 7: {  // FollowerAcceptEntry(s, src = c1, pli = c2 + 1, e = c3, lc = c4 + 1)
        const int src = c1, l0 = c2, e = c3, h0 = c4;
        bool present = false;
        if (src != s) {
          const int plt = clampi(lt[s * L + l0], 0, T);
          present = bit_at(bits, aq_id(d, pair_of(d, src, s), tix + 1, l0 + 1, plt, e, h0 + 1));
          if (d.legacy_append) {  // the dead FollowerAppendEntry's send-guard (Raft.tla:347-348)
            const int nl = l0 + 1 + (e > 0);
            const int rpli = min(nl, L);
            const bool resp = bit_at(bits, ap_id(d, pair_of(d, s, src), tix + 1, rpli, 1));
            const bool ci_adv = min(h0 + 1, nl) > ci_s;
            present = present && (!resp || ci_adv);
          }
        }
        ok = role_s == FOLLOWER && has_term && l0 + 1 <= ll_s && src != s && present;
        break;
      }
      case 8: {  // FollowerRejectEntry(s, src = c1, pli = c2 + 1)
        const int src = c1, l0 = c2;
        int cnt = 0, rej = 0;
        if (src != s) {
          const int p = pair_of(d, src, s);
          const int tot = popc_range(bits, aq_id(d, p, tix + 1, l0 + 1, 0, 0, 1), aq_pli_blk);
          const int mplt = clampi(lt[s * L + l0], 0, T);
          const int match = popc_range(bits, aq_id(d, p, tix + 1, l0 + 1, mplt, 0, 1), E * L);
          cnt = tot - (l0 + 1 <= ll_s ? match : 0);
          rej = bit_at(bits, ap_id(d, pair_of(d, s, src), tix + 1, l0 + d.ap_pli_min, 0));
        }
        ok = role_s == FOLLOWER && has_term && src != s && cnt > 0 && rej == 0;
        m = cnt;
        break;
      }
      case 9: {  // HandleAppendResp(s, src = c1, pli = c2 + 1, succ = c3)
        const int src = c1, pli = c2 + 1, x = c3;
        const int msd = mi[s * S + src], nsd = ni[s * S + src];
        const bool st_ok = x == 1 ? msd < pli : (pli + 1 == nsd && pli > msd);
        const bool present =
            src != s && bit_at(bits, ap_id(d, pair_of(d, src, s), tix + 1, pli, x));
        ok = role_s == LEADER && has_term && pend[s * S + src] == 1 && st_ok && present;
        break;
      }
      case 10:  // LeaderCanCommit: the median of matchIndex[s] past commitIndex[s]
        ok = role_s == LEADER && rank_median(mi + s * S, S, d.median_index) > ci_s;
        break;
      default:  // Restart
        ok = role_s == LEADER && rc < d.max_restart;
        break;
    }
    valid[(size_t)b * K + k] = ok;
    mult[(size_t)b * K + k] = ok ? m : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) abort_out[b] = abort_flag != 0;
}

EXPORT int launch_guards(const void* const* core, const int32_t* msgs, int B,
                         const int32_t* slot_tab, int K, const int* dims, bool* valid,
                         int32_t* mult, bool* abort_out, void* stream) {
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  Dims d = load_dims(dims);
  if (B > 0) {
    guards_kernel<<<B, 256, d.n_words * sizeof(uint32_t), (cudaStream_t)stream>>>(
        P, msgs, B, slot_tab, K, d, valid, mult, abort_out);
  }
  return (int)cudaGetLastError();
}
