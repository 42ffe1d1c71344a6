// legacy_materialize (B20): the children of (parent row, slot) lanes by
// the reference's per-lane scalar actions.
//
// Replaces the XLA programs of tla_raft_tpu/ops/successor.py
// SuccessorKernel._materialize_one / _materialize / _materialize_added
// (:701-748: a lax.switch over the 12 action families of :364-665, then
// the SendMsg union of the added ids into the message set), which the
// reference keeps beside the matrix forms as their A/B reference
// (TLA_RAFT_MXU=0) and as the --audit re-expansion.  The port's frontier
// carries message sets as ascending id lists, so the union is the sorted
// insertion of JaxChecker._ids_insert (engine/bfs.py:861) with its cap_m
// overflow flag.
//
// Design: one thread per lane.  The lane's slot decodes to (family,
// witness); the family's action reads the parent's fields for server s and
// writes the child's: first the whole parent row is copied, then the
// action's assignments (the scalar transcription's _set1 / _set2 /
// _set_row) overwrite it.  The sent ids go to `added`, and each live one
// that is not in the list yet is inserted in order.  It takes K2's C
// interface (materialize.cu: lanes as (pidx, slot) or payloads, device
// counts, the overflow word), so every route can take either kernel; the
// code is written from the scalar actions, not from K2, so that the audit
// holds two formulations against each other.
//
// Bound: bytes.  Per lane the parent row and id list are read (about
// 64 B + 2 * cap_m B at the reference constants) and the child row, list
// and sent ids written; the work is a few dozen integer operations and a
// cap_m-long scan per sent id.
#include "common.cuh"

template <typename Id>
__global__ void legacy_kernel(Core P, const Id* __restrict__ ids, int cap_m, long long N,
                              const int64_t* __restrict__ pidx, const int64_t* __restrict__ slots,
                              long long G, const int32_t* __restrict__ slot_tab, int K, Dims d,
                              CoreOut C, int32_t* __restrict__ added, Id* __restrict__ child_ids,
                              bool* __restrict__ ovf, const int64_t* __restrict__ pay,
                              long long pay_base, const int64_t* cnt, long long sub,
                              long long* ovf_any) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= live_count(cnt, sub, 1, G)) return;
  const int S = d.S, T = d.T, L = d.L, V = d.V;
  const int A = S > 2 ? S - 1 : 1;
  long long par, slot;
  if (pay) {
    const long long y = pay[g];
    const long long q = y >= 0 ? y / K : -((-y + K - 1) / K);  // floor division
    par = q - pay_base;
    slot = y - q * K;
  } else {
    par = pidx[g];
    slot = slots[g];
  }
  par = min(max(par, 0ll), N - 1);
  slot = min(max(slot, 0ll), (long long)K - 1);

  for (int f = 0; f < N_FIELDS; ++f) {
    const int w = field_width(d, f);
    for (int i = 0; i < w; ++i) C.f[f][g * w + i] = P.f[f][par * w + i];
  }
  // scalar getters on the parent (_get1 / _get2 of successor.py) and
  // setters on the child (_set1 / _set2)
  auto get1 = [&](int f, int s) -> int { return P.f[f][par * S + s]; };
  auto get2 = [&](int f, int a, int b) -> int {
    return P.f[f][par * field_width(d, f) + a * (f == LT || f == LV ? L : S) + b];
  };
  auto set1 = [&](int f, int s, int v) { C.f[f][g * S + s] = (uint8_t)v; };
  auto set2 = [&](int f, int a, int b, int v) {
    C.f[f][g * field_width(d, f) + a * (f == LT || f == LV ? L : S) + b] = (uint8_t)v;
  };

  const int32_t* c = slot_tab + slot * 6;
  const int fam = c[0], s = c[1];
  int sent[8];
  for (int a = 0; a < 8; ++a) sent[a] = -1;
  const int cur = get1(CT, s);

  switch (fam) {
    case 0: {  // _become_candidate
      const int new_term = clampi(cur + 1, 1, T);
      const int ll = get1(LL, s);
      const int llt = clampi(get2(LT, s, ll - 1 < 0 ? 0 : ll - 1), 0, T - 1);
      for (int r = 0; r < S - 1; ++r) {
        const int peer = (s + 1 + r) % S;
        sent[r] = vq_id(d, pair_of(d, s, peer), new_term, ll, llt);  // encode_votereq
      }
      set1(CT, s, new_term);
      set1(ROLE, s, CANDIDATE);
      set1(VF, s, s + 1);
      C.f[EC][g] = (uint8_t)(P.f[EC][par] + 1);
      break;
    }
    case 1: {  // _update_term_a (term c[2] + 1)
      const int t = c[2] + 1;
      const int new_vf = (d.become_follower && get1(ROLE, s) == FOLLOWER) ? get1(VF, s) : 0;
      set1(ROLE, s, FOLLOWER);
      set1(CT, s, t);
      set1(VF, s, new_vf);
      break;
    }
    case 2:  // _update_term_b
      set1(ROLE, s, FOLLOWER);
      break;
    case 3: {  // _response_vote (cand = c[2])
      const int cand = c[2];
      sent[0] = vp_id(d, pair_of(d, s, cand), cur < 1 ? 1 : cur);  // encode_voteresp
      set1(VF, s, cand + 1);
      break;
    }
    case 4: {  // _become_leader
      const int ll = get1(LL, s);
      set1(ROLE, s, LEADER);
      for (int u = 0; u < S; ++u) {
        set2(MI, s, u, u == s ? ll : 1);
        set2(NI, s, u, ll + 1);
        set2(PEND, s, u, 0);
      }
      break;
    }
    case 5: {  // _client_req (v = c[2])
      const int v = c[2], ll = get1(LL, s);
      const int at = clampi(ll, 0, L - 1);
      C.f[VS][g * V + v] = 1;
      set2(LT, s, at, cur);
      set2(LV, s, at, v + 1);
      set1(LL, s, ll + 1);
      set2(MI, s, s, ll + 1);
      break;
    }
    case 6: {  // _leader_append (dst = c[2])
      const int dd = c[2];
      const int ni = get2(NI, s, dd), ll = get1(LL, s);
      const int pli = clampi(ni - 1, 1, L);
      const int plt = clampi(get2(LT, s, clampi(ni - 2, 0, L - 1)), 0, T);
      const int epos = clampi(ni - 1, 0, L - 1);
      const int ecode = ni <= ll ? 1 + (clampi(get2(LT, s, epos), 1, T) - 1) * V +
                                       (clampi(get2(LV, s, epos), 1, V) - 1)  // entry_code
                                 : 0;
      sent[0] = aq_id(d, pair_of(d, s, dd), clampi(cur, 1, T), pli, plt, ecode, get1(CI, s));
      set2(PEND, s, dd, 1);
      break;
    }
    case 7: {  // _follower_accept (src, pli, e, lc)
      const int src = c[2], pli = c[3] + 1, e = c[4], lc = c[5] + 1;
      const int ll = get1(LL, s);
      const int el = e > 0;
      const int eterm = el ? (e - 1) / V + 1 : 0, evl = el ? (e - 1) % V + 1 : 0;
      const int new_len = pli + el;
      const int pos = clampi(pli, 0, L - 1);
      const bool conflict = el == 1 && pli < ll &&
                            (get2(LT, s, pos) != eterm || get2(LV, s, pos) != evl);
      if (new_len > ll || conflict) {  // updated
        for (int j = 0; j < L; ++j) {
          const bool at_entry = j == pos && el == 1;
          set2(LT, s, j, at_entry ? eterm : (j < pli ? get2(LT, s, j) : 0));
          set2(LV, s, j, at_entry ? evl : (j < pli ? get2(LV, s, j) : 0));
        }
        set1(LL, s, new_len);
      }
      const int old_ci = get1(CI, s);
      const int mn = lc < new_len ? lc : new_len;
      set1(CI, s, old_ci > mn ? old_ci : mn);
      sent[0] = ap_id(d, pair_of(d, s, src), clampi(cur, 1, T), clampi(pli + el, 1, L), 1);
      break;
    }
    case 8: {  // _follower_reject (src, pli): the child is the parent
      const int src = c[2], pli = c[3] + 1;
      const int rej_pli = d.legacy_append ? pli - 1 : pli;
      sent[0] = ap_id(d, pair_of(d, s, src), clampi(cur, 1, T), rej_pli, 0);
      break;
    }
    case 9: {  // _handle_append_resp (src, pli, success)
      const int src = c[2], pli = c[3] + 1, sc = c[4];
      const int mi = get2(MI, s, src);
      set2(MI, s, src, sc == 1 ? pli : mi);
      set2(NI, s, src, pli + sc);
      set2(PEND, s, src, 0);
      break;
    }
    case 10:  // _leader_can_commit
      set1(CI, s, rank_median(P.f[MI] + par * S * S + s * S, S, d.median_index));
      break;
    default:  // _restart
      set1(ROLE, s, FOLLOWER);
      C.f[RC][g] = (uint8_t)(P.f[RC][par] + 1);
      break;
  }
  for (int a = 0; a < A; ++a) added[g * A + a] = sent[a];

  // SendMsg (Raft.tla:43-45): the union of the sent ids into the sorted list
  const Id* src_ids = ids + par * cap_m;
  Id* out = child_ids + g * cap_m;
  int n = 0;
  for (int j = 0; j < cap_m; ++j) {
    out[j] = src_ids[j];
    n += src_ids[j] >= 0;
  }
  bool of = false;
  for (int a = 0; a < A; ++a) {
    const int id = sent[a];
    if (id < 0) continue;
    if (id >= d.M) {  // past the universe (a garbage lane): never listed
      of = of || n == cap_m;
      continue;
    }
    int pos = 0;
    while (pos < n && out[pos] < id) ++pos;
    if (pos < n && out[pos] == id) continue;  // already in the set
    if (n == cap_m) {
      of = true;  // the list is full: its last id drops (or the new one, past it)
      if (pos == cap_m) continue;
      --n;
    }
    for (int j = n; j > pos; --j) out[j] = out[j - 1];
    out[pos] = (Id)id;
    ++n;
  }
  ovf[g] = of;
  if (of && ovf_any) *ovf_any = 1;
}

// The C interface of launch_materialize (materialize.cu).
EXPORT int launch_legacy(const void* const* core, const void* ids, int id_bytes, int cap_m,
                         long long N, const int64_t* pidx, const int64_t* slots, long long G,
                         const int32_t* slot_tab, int K, const int* dims, void* const* core_out,
                         int32_t* added, void* child_ids, bool* ovf, const int64_t* pay,
                         long long pay_base, const int64_t* cnt, long long sub, int64_t* ovf_any,
                         void* stream) {
  if (id_bytes != 2 && id_bytes != 4) return (int)cudaErrorInvalidValue;
  Core P;
  CoreOut C;
  for (int i = 0; i < N_FIELDS; ++i) {
    P.f[i] = (const uint8_t*)core[i];
    C.f[i] = (uint8_t*)core_out[i];
  }
  Dims d = load_dims(dims);
  if (d.S > 9 || d.S < 2) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((G + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    if (id_bytes == 2)
      legacy_kernel<int16_t><<<blocks, threads, 0, st>>>(
          P, (const int16_t*)ids, cap_m, N, pidx, slots, G, slot_tab, K, d, C, added,
          (int16_t*)child_ids, ovf, pay, pay_base, cnt, sub, (long long*)ovf_any);
    else
      legacy_kernel<int32_t><<<blocks, threads, 0, st>>>(
          P, (const int32_t*)ids, cap_m, N, pidx, slots, G, slot_tab, K, d, C, added,
          (int32_t*)child_ids, ovf, pay, pay_base, cnt, sub, (long long*)ovf_any);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)legacy_kernel<int16_t>, (const void*)legacy_kernel<int32_t>)
