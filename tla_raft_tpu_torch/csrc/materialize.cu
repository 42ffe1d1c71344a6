// K2 materialize: children of (parent row, slot) lanes, with their sent
// message ids and sorted message-id lists.
//
// Replaces the XLA program of tla_raft_tpu/ops/mxu_expand.py
// MXUExpand.materialize_added (a one-hot [G, K] x BIG[K, 47] constant fetch
// plus masked selects per family) fused with engine/bfs.py
// JaxChecker._ids_insert (sorted insertion of the sent ids into the
// parent's id list, with the cap_m overflow flag).
//
// Design: one thread per lane.  The thread copies the parent's row (about
// 64 B of core fields at the reference constants), applies its slot's
// family update term by term, writes the A sent ids, then copies the
// parent's id list into the child's row and inserts the live sent ids in
// place (an id already present is skipped: the message set is a set,
// Raft.tla:43-45).  Garbage lanes (indices clamped into range) compute
// in-range garbage and never fault.
//
// Bound: bytes.  Per lane it reads the parent row and id list
// (~64 + 2 * cap_m B) and writes the same again plus the sent ids; the
// work per lane is a few dozen integer operations and a cap_m-long scan.
#include "common.cuh"

__global__ void materialize_kernel(Core P, const int16_t* __restrict__ ids, int cap_m, long long N,
                                   const int64_t* __restrict__ pidx,
                                   const int64_t* __restrict__ slots, long long G,
                                   const int32_t* __restrict__ slot_tab, int K, Dims d, CoreOut C,
                                   int32_t* __restrict__ added, int16_t* __restrict__ child_ids,
                                   bool* __restrict__ ovf) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int S = d.S, T = d.T, L = d.L, V = d.V, E = d.E;
  const int A = S - 1 > 1 ? S - 1 : 1;
  long long p = pidx[g];
  p = p < 0 ? 0 : (p >= N ? N - 1 : p);
  long long sl = slots[g];
  sl = sl < 0 ? 0 : (sl >= K ? K - 1 : sl);

  // child := parent
  for (int f = 0; f < N_FIELDS; ++f) {
    const int w = field_width(d, f);
    const uint8_t* src = P.f[f] + p * w;
    uint8_t* dst = C.f[f] + g * w;
    for (int i = 0; i < w; ++i) dst[i] = src[i];
  }
  const int32_t* c = slot_tab + sl * 6;
  const int fam = c[0], s = c[1], c1 = c[2], c2 = c[3], c3 = c[4], c4 = c[5];
  const uint8_t* pct = P.f[CT] + p * S;
  const uint8_t* pvf = P.f[VF] + p * S;
  const uint8_t* prole = P.f[ROLE] + p * S;
  const uint8_t* plt = P.f[LT] + p * S * L + s * L;  // row s
  const uint8_t* plv = P.f[LV] + p * S * L + s * L;
  const uint8_t* pmi = P.f[MI] + p * S * S + s * S;
  const uint8_t* pni = P.f[NI] + p * S * S + s * S;
  const int ct_s = pct[s], vf_s = pvf[s], role_s = prole[s];
  const int ll_s = P.f[LL][p * S + s], ci_s = P.f[CI][p * S + s];
  uint8_t* cvf = C.f[VF] + g * S;
  uint8_t* cct = C.f[CT] + g * S;
  uint8_t* crole = C.f[ROLE] + g * S;
  uint8_t* clt = C.f[LT] + g * S * L + s * L;
  uint8_t* clv = C.f[LV] + g * S * L + s * L;
  uint8_t* cmi = C.f[MI] + g * S * S + s * S;
  uint8_t* cni = C.f[NI] + g * S * S + s * S;
  uint8_t* cpend = C.f[PEND] + g * S * S + s * S;
  int sent[8];
  for (int a = 0; a < A; ++a) sent[a] = -1;
  const int ap_pair_stride = T * d.NPLI * 2;

  switch (fam) {
    case 0: {  // BecomeCandidate(s)
      const int nt = clampi(ct_s + 1, 1, T);
      const int lpos = ll_s - 1 < 0 ? 0 : ll_s - 1;
      const int llt = clampi(lpos < L ? plt[lpos] : 0, 0, T - 1);
      cct[s] = (uint8_t)nt;
      crole[s] = CANDIDATE;
      cvf[s] = (uint8_t)(s + 1);
      C.f[EC][g] = (uint8_t)(P.f[EC][p] + 1);
      for (int r = 0; r < A; ++r) {
        const int pr = S > 1 ? pair_of(d, s, (s + 1 + r) % S) : 0;
        sent[r] = d.vq_off + pr * T * L * T + ((nt - 1) * L + (ll_s - 1)) * T + llt;
      }
      break;
    }
    case 1:  // UpdateTerm (a)
      cvf[s] = (uint8_t)(d.become_follower && role_s == FOLLOWER ? vf_s : 0);
      cct[s] = (uint8_t)(c1 + 1);
      crole[s] = FOLLOWER;
      break;
    case 2:  // UpdateTerm (b)
      crole[s] = FOLLOWER;
      break;
    case 3:  // ResponseVote(s, cand = c1): vote and grant
      cvf[s] = (uint8_t)(c1 + 1);
      sent[0] = d.vp_off + pair_of(d, s, c1) * T + (ct_s < 1 ? 1 : ct_s) - 1;
      break;
    case 4:  // BecomeLeader(s)
      crole[s] = LEADER;
      for (int u = 0; u < S; ++u) {
        cmi[u] = (uint8_t)(u == s ? ll_s : 1);
        cni[u] = (uint8_t)(ll_s + 1);
        cpend[u] = 0;
      }
      break;
    case 5: {  // ClientReq(s, v = c1)
      const int at = clampi(ll_s, 0, L - 1);
      clt[at] = (uint8_t)ct_s;
      clv[at] = (uint8_t)(c1 + 1);
      C.f[LL][g * S + s] = (uint8_t)(ll_s + 1);
      cmi[s] = (uint8_t)(ll_s + 1);
      C.f[VS][g * V + c1] = 1;
      break;
    }
    case 6: {  // LeaderAppendEntry(s, dst = c1)
      const int nsd = pni[c1];
      const int pli = clampi(nsd - 1, 1, L);
      const int pt = clampi(plt[clampi(nsd - 2, 0, L - 1)], 0, T);
      const int epos = clampi(nsd - 1, 0, L - 1);
      const int et = clampi(plt[epos], 1, T), ev = clampi(plv[epos], 1, V);
      const int ecode = nsd <= ll_s ? 1 + (et - 1) * V + (ev - 1) : 0;
      cpend[c1] = 1;
      sent[0] = d.aq_off + pair_of(d, s, c1) * T * L * (T + 1) * E * L +
                ((((clampi(ct_s, 1, T) - 1) * L + (pli - 1)) * (T + 1) + pt) * E + ecode) * L +
                (ci_s - 1);
      break;
    }
    case 7: {  // FollowerAcceptEntry(s, src = c1, pli = c2 + 1, e = c3, lc = c4 + 1)
      const int pli = c2 + 1, e = c3;
      const int el = e > 0;
      const int eterm = el ? (e - 1) / V + 1 : 0, evl = el ? (e - 1) % V + 1 : 0;
      const int nl = pli + el;
      const int pos = pli < L - 1 ? pli : L - 1;
      const bool conflict = el == 1 && pli < ll_s && (plt[pos] != eterm || plv[pos] != evl);
      if (nl > ll_s || conflict) {
        for (int j = 0; j < L; ++j) {
          const bool at = el == 1 && j == pos;
          clt[j] = (uint8_t)(at ? eterm : (j < pli ? plt[j] : 0));
          clv[j] = (uint8_t)(at ? evl : (j < pli ? plv[j] : 0));
        }
        C.f[LL][g * S + s] = (uint8_t)nl;
      }
      const int minlc = c4 + 1 < nl ? c4 + 1 : nl;
      C.f[CI][g * S + s] = (uint8_t)(ci_s > minlc ? ci_s : minlc);
      const int rpli = clampi(nl, 1, L);
      sent[0] = d.ap_off + pair_of(d, s, c1) * ap_pair_stride + (rpli - d.ap_pli_min) * 2 + 1 +
                (clampi(ct_s, 1, T) - 1) * (d.NPLI * 2);
      break;
    }
    case 8: {  // FollowerRejectEntry(s, src = c1, pli = c2 + 1): sends the reject only
      const int rej_pli = c2 + (d.legacy_append ? 0 : 1);
      sent[0] = d.ap_off + pair_of(d, s, c1) * ap_pair_stride + (rej_pli - d.ap_pli_min) * 2 +
                (clampi(ct_s, 1, T) - 1) * (d.NPLI * 2);
      break;
    }
    case 9: {  // HandleAppendResp(s, src = c1, pli = c2 + 1, succ = c3)
      const int pli = c2 + 1, sc = c3;
      if (sc == 1) cmi[c1] = (uint8_t)pli;
      cni[c1] = (uint8_t)(pli + sc);
      cpend[c1] = 0;
      break;
    }
    case 10:  // LeaderCanCommit(s)
      C.f[CI][g * S + s] = (uint8_t)rank_median(pmi, S, d.median_index);
      break;
    default:  // Restart(s)
      crole[s] = FOLLOWER;
      C.f[RC][g] = (uint8_t)(P.f[RC][p] + 1);
      break;
  }

  for (int a = 0; a < A; ++a) added[g * A + a] = sent[a];

  // child ids := parent ids with the live sent ids inserted in order
  const int16_t* in = ids + p * cap_m;
  int16_t* out = child_ids + g * cap_m;
  for (int j = 0; j < cap_m; ++j) out[j] = in[j];
  bool of = false;
  for (int a = 0; a < A; ++a) {
    const int aid = sent[a];
    if (aid < 0) continue;
    bool present = false;
    int pos = 0;
    for (int j = 0; j < cap_m; ++j) {
      const int v = out[j] < 0 ? d.M : out[j];
      present |= v == aid;
      pos += v < aid;
    }
    if (present) continue;
    if (out[cap_m - 1] >= 0) of = true;  // the list is full: the last id drops
    for (int j = cap_m - 1; j > pos; --j) out[j] = out[j - 1];
    if (pos < cap_m) out[pos] = (int16_t)aid;
  }
  ovf[g] = of;
}

EXPORT int launch_materialize(const void* const* core, const int16_t* ids, int cap_m,
                              long long N, const int64_t* pidx, const int64_t* slots, long long G,
                              const int32_t* slot_tab, int K, const int* dims,
                              void* const* core_out, int32_t* added, int16_t* child_ids,
                              bool* ovf, void* stream) {
  Core P;
  CoreOut C;
  for (int i = 0; i < N_FIELDS; ++i) {
    P.f[i] = (const uint8_t*)core[i];
    C.f[i] = (uint8_t*)core_out[i];
  }
  Dims d = load_dims(dims);
  if (G > 0) {
    const int threads = 128;
    const long long blocks = (G + threads - 1) / threads;
    materialize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        P, ids, cap_m, N, pidx, slots, G, slot_tab, K, d, C, added, child_ids, ovf);
  }
  return (int)cudaGetLastError();
}
