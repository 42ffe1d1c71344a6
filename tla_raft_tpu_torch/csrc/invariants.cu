// Invariant scan: the first state of a batch that violates a configured
// invariant or probe (Raft.tla:432-507).
//
// Replaces the XLA program of tla_raft_tpu/engine/bfs.py _inv_scan_impl:
// every configured predicate of tla_raft_tpu/engine/invariants.py
// (leader_has_all_committed_entries, the Inv the reference configuration
// checks, and the six debug probes, each optionally negated), OR-ed into a
// bad mask over the level, then argmax for the first bad row.
//
// Design: one thread per state evaluates each configured predicate from
// the state's core fields as the spec states it (loops over servers; the
// few message existentials of NoAllCommit are scans of the state's sorted
// id list).  A bad row does an unsigned atomicMin of its index (plus the
// caller's row offset) into one 64-bit word that the entry point first
// sets to all ones: the minimum is order-free, and all ones reads as -1
// (no bad row) in int64.
//
// Bound: bytes.  Each state reads its core fields (~64 B at S = 3; the
// id list only for NoAllCommit); the work is O(S^2 L) comparisons.
#include "common.cuh"

constexpr int MAX_INV = 8;

enum InvCode {
  INV_LEADER_HAS_ALL = 0, RAFT_CAN_COMMT, FOLLOWER_CAN_COMMIT, COMMIT_ALL, NO_SPLIT_VOTE,
  NO_ALL_COMMIT, EXIST_LEADER_AND_CANDIDATE,
};

struct InvList {
  int n;
  int code[MAX_INV];    // InvCode
  int negate[MAX_INV];  // the `~Name` probe form
};

__device__ inline uint8_t at(const Core& P, int f, long long g, int w, int i) {
  return P.f[f][g * w + i];
}

__device__ bool leader_has_all(const Core& P, long long g, const Dims& d) {
  const int S = d.S, L = d.L;
  bool any_leader = false, ok_any = false;
  for (int l = 0; l < S; ++l) {
    if (at(P, ROLE, g, S, l) != LEADER) continue;
    any_leader = true;
    bool bad = false;
    for (int p = 0; p < S && !bad; ++p) {
      if (p == l || at(P, CT, g, S, p) > at(P, CT, g, S, l)) continue;
      const int ci = at(P, CI, g, S, p);
      if (ci > at(P, LL, g, S, l)) bad = true;
      for (int k = 0; k < L && k < ci && !bad; ++k) {
        bad = at(P, LT, g, S * L, l * L + k) != at(P, LT, g, S * L, p * L + k) ||
              at(P, LV, g, S * L, l * L + k) != at(P, LV, g, S * L, p * L + k);
      }
    }
    if (!bad) ok_any = true;
  }
  return !any_leader || ok_any;
}

// Any of the state's ids in [lo, lo + len)?
__device__ inline bool has_in(const int16_t* ids, int cap_m, int lo, int len) {
  for (int j = 0; j < cap_m; ++j) {
    const int id = ids[j];
    if (id < 0) break;
    if (id >= lo && id < lo + len) return true;
  }
  return false;
}

__device__ bool no_all_commit(const Core& P, const int16_t* ids, int cap_m, long long g,
                              const Dims& d) {
  const int S = d.S, T = d.T, L = d.L;
  const int aq_block = (T + 1) * d.E * L;  // ids of one (src, dst, term, pli)
  for (int s1 = 0; s1 < S; ++s1)
    for (int s2 = 0; s2 < S; ++s2) {
      if (s2 == s1) continue;
      for (int s3 = 0; s3 < S; ++s3) {
        if (s3 == s2 || s3 == s1) continue;
        const int ct1 = at(P, CT, g, S, s1), ct3 = at(P, CT, g, S, s3);
        const bool base =
            at(P, ROLE, g, S, s1) == LEADER && at(P, ROLE, g, S, s2) == FOLLOWER &&
            at(P, ROLE, g, S, s3) == FOLLOWER && ct1 == ct3 && at(P, CI, g, S, s1) == 2 &&
            at(P, CI, g, S, s2) == 2 && at(P, CI, g, S, s3) == 1 &&
            at(P, MI, g, S * S, s1 * S + s2) == 2 && at(P, MI, g, S * S, s1 * S + s3) == 2;
        if (!base) continue;
        const int pr = pair_of(d, s1, s3);
        const int t3 = clampi(ct3 - 1, 0, T - 1);
        const bool m1 = ct3 >= 1 && has_in(ids, cap_m, aq_id(d, pr, t3 + 1, 1, 0, 0, 1), aq_block);
        const bool m2 = has_in(ids, cap_m, ap_id(d, pair_of(d, s3, s1), clampi(ct3, 1, T), 1, 1), 1);
        bool m3 = false;
        if (L >= 2)
          for (int t = 1; t <= T && !m3; ++t)
            m3 = has_in(ids, cap_m, aq_id(d, pr, t, 2, 0, 0, 1), aq_block);
        if (m1 && m2 && m3) return true;
      }
    }
  return false;
}

__device__ bool holds(int code, const Core& P, const int16_t* ids, int cap_m, long long g,
                      const Dims& d) {
  const int S = d.S;
  switch (code) {
    case INV_LEADER_HAS_ALL:
      return leader_has_all(P, g, d);
    case RAFT_CAN_COMMT:
      for (int s = 0; s < S; ++s)
        if (at(P, CI, g, S, s) > 1) return true;
      return false;
    case FOLLOWER_CAN_COMMIT:
      for (int s = 0; s < S; ++s)
        if (at(P, ROLE, g, S, s) == FOLLOWER && at(P, CI, g, S, s) > 1) return true;
      return false;
    case COMMIT_ALL:
      for (int s = 0; s < S; ++s)
        if (at(P, CI, g, S, s) != 3) return false;
      return true;
    case NO_SPLIT_VOTE:
      for (int s = 0; s < S; ++s)
        for (int t = 0; t < S; ++t)
          if (s != t && at(P, ROLE, g, S, s) == LEADER && at(P, ROLE, g, S, t) == LEADER &&
              at(P, CT, g, S, s) == at(P, CT, g, S, t))
            return false;
      return true;
    case NO_ALL_COMMIT:
      return no_all_commit(P, ids, cap_m, g, d);
    default: {  // EXIST_LEADER_AND_CANDIDATE
      bool lead = false, cand = false;
      for (int s = 0; s < S; ++s) {
        lead |= at(P, ROLE, g, S, s) == LEADER;
        cand |= at(P, ROLE, g, S, s) == CANDIDATE;
      }
      return lead && cand;
    }
  }
}

__global__ void inv_scan_kernel(Core P, const int16_t* __restrict__ ids, int cap_m, long long n,
                                InvList inv, Dims d, long long offset,
                                unsigned long long* __restrict__ first_bad) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  bool bad = false;
  for (int i = 0; i < inv.n && !bad; ++i)
    bad = holds(inv.code[i], P, ids + g * cap_m, cap_m, g, d) == (inv.negate[i] != 0);
  if (bad) atomicMin(first_bad, (unsigned long long)(g + offset));
}

// codes[i] = InvCode, negate[i] = 1 for `~Name`.  first_bad is an int64
// that reads -1 when no row is bad, else the smallest bad row + offset.
// fresh = 1 sets it to -1 first; fresh = 0 folds this batch into it.
EXPORT int launch_inv_scan(const void* const* core, const int16_t* ids, int cap_m, long long n,
                           const int* codes, const int* negate, int n_inv, const int* dims,
                           long long offset, int fresh, int64_t* first_bad, void* stream) {
  if (n_inv > MAX_INV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  InvList inv;
  inv.n = n_inv;
  for (int i = 0; i < n_inv; ++i) {
    inv.code[i] = codes[i];
    inv.negate[i] = negate[i];
  }
  if (fresh) cudaMemsetAsync(first_bad, 0xFF, sizeof(int64_t), st);
  if (n > 0)
    inv_scan_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        P, ids, cap_m, n, inv, load_dims(dims), offset, (unsigned long long*)first_bad);
  return (int)cudaGetLastError();
}
