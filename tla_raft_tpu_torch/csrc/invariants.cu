// Invariant scan: the first state of a batch that violates a configured
// invariant or probe (Raft.tla:432-507).
//
// Replaces the XLA program of tla_raft_tpu/engine/bfs.py _inv_scan_impl:
// every configured predicate of tla_raft_tpu/engine/invariants.py
// (leader_has_all_committed_entries, the Inv the reference configuration
// checks, and the six debug probes, each optionally negated), OR-ed into a
// bad mask over the level, then argmax for the first bad row.
//
// Bound: bytes.  Each live state's fields that the configured predicates
// read are read once (30 B at S = 3, L = 3 for Inv: role, currentTerm,
// commitIndex, log length, log terms and values; matchIndex and the id
// list only for NoAllCommit); the work is O(S^2 L) byte compares a state.
//
// Design: a persistent grid (as many blocks as stay resident, sized at
// launch, so once per captured graph) walks tiles of IV_ROWS states, each
// block its tiles in ascending order, up to the live count read from a
// device word: rows past it cost nothing, and one launch covers a whole
// level's survivors.  Each
// tile's spans of the fields the configured predicates read (for
// NoAllCommit, matchIndex and the id lists too), as many as fit
// IV_SMEM_MAX (the rest are read from device memory), are copied
// into shared memory by cp.async as 16-B vectors (byte loads where a span
// is not 16-B aligned, as for views at arbitrary row offsets), the next
// tile's copy in flight while this one is evaluated, a thread a state.
// The predicates' byte-wise loops with early exits, not the copies, cost
// the most (measured by ablation): the kernel is built for 3, 5 and 7 servers,
// so their loops over servers unroll into shared-memory loads, and for
// any count (which alone reads the unstaged fields of wide dimensions).  A tile's first bad row is a warp minimum (__reduce_min_sync)
// then a block minimum; the block does one unsigned atomicMin of it (plus
// the caller's row offset) into a 64-bit word, only when the tile has a
// bad row.  The minimum is order-free, and all ones reads as -1 (no bad
// row) in int64.  A block stops at its first tile that starts at or past
// the word's current value (a relaxed read): its later tiles start later
// still, so no smaller row is lost.
#include "common.cuh"
#include "stage.cuh"

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

// A state of a staged tile as the predicates read it: each field's bytes
// of the state in the tile's rows in shared memory, or in device memory
// where the field was not staged (null where no configured predicate
// reads the field).  at() reads byte
// i of field f (g and w, the state and the field's width, are already in
// the row pointer).
struct TileRows {
  const uint8_t* row[N_FIELDS];
};

__device__ __forceinline__ uint8_t at(const TileRows& P, int f, int g, int w, int i) {
  return P.row[f][i];
}

// SN: the servers when the kernel is built for a count (3, 5, 7: its
// loops over servers unroll), 0 for any count (d.S).
template <int SN>
__device__ __forceinline__ bool leader_has_all(const TileRows& P, int g, const Dims& d) {
  const int S = SN ? SN : d.S, L = d.L;
  bool any_leader = false, ok_any = false;
#pragma unroll
  for (int l = 0; l < S; ++l) {
    if (at(P, ROLE, g, S, l) != LEADER) continue;
    any_leader = true;
    bool bad = false;
#pragma unroll
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
template <typename Id>
__device__ __forceinline__ bool has_in(const Id* ids, int cap_m, int lo, int len) {
  for (int j = 0; j < cap_m; ++j) {
    const int id = ids[j];
    if (id < 0) break;
    if (id >= lo && id < lo + len) return true;
  }
  return false;
}

template <int SN, typename Id>
__device__ __forceinline__ bool no_all_commit(const TileRows& P, const Id* ids, int cap_m, int g,
                                              const Dims& d) {
  const int S = SN ? SN : d.S, T = d.T, L = d.L;
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

template <int SN, typename Id>
__device__ __forceinline__ bool holds(int code, const TileRows& P, const Id* ids, int cap_m, int g,
                                      const Dims& d) {
  const int S = SN ? SN : d.S;
  switch (code) {
    case INV_LEADER_HAS_ALL:
      return leader_has_all<SN>(P, g, d);
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
      return no_all_commit<SN>(P, ids, cap_m, g, d);
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

constexpr int IV_ROWS = 512;             // states a tile, a thread a state
constexpr int IV_STAGES = 2;             // tiles a block has in flight: this one and the next
constexpr int IV_SMEM_MAX = 96 * 1024;   // the stage buffers at most

// The fields each predicate reads (bit f: Field f).
static unsigned fields_of(int code) {
  const unsigned lead = 1u << ROLE | 1u << CT | 1u << CI | 1u << LL | 1u << LT | 1u << LV;
  switch (code) {
    case INV_LEADER_HAS_ALL: return lead;
    case RAFT_CAN_COMMT: case COMMIT_ALL: return 1u << CI;
    case FOLLOWER_CAN_COMMIT: return 1u << ROLE | 1u << CI;
    case NO_SPLIT_VOTE: return 1u << ROLE | 1u << CT;
    case NO_ALL_COMMIT: return 1u << ROLE | 1u << CT | 1u << CI | 1u << MI;
    default: return 1u << ROLE;  // EXIST_LEADER_AND_CANDIDATE
  }
}

// What a tile stages: the spans (stage_rows), field f's rows at foff[f] of
// a stage buffer (-1: not staged), the id lists at ids_off (-1: not staged),
// and one buffer's bytes.  A field or the id lists that a predicate reads
// but that would push IV_STAGES buffers past IV_SMEM_MAX (wide logs, many
// servers, NoAllCommit's matchIndex) is read from device memory at gsrc[f]
// (null: no predicate reads it, or it is staged), so every dimension scans.
struct IvPlan {
  Segs segs;
  int foff[N_FIELDS];
  const uint8_t* gsrc[N_FIELDS];
  int ids_off;
  int buf_b;
};

static IvPlan plan_of(const Core& P, const void* ids, int id_bytes, int cap_m, const int* codes,
                      int n_inv, const Dims& d) {
  unsigned mask = 0;
  bool need_ids = false;
  for (int i = 0; i < n_inv; ++i) {
    mask |= fields_of(codes[i]);
    need_ids |= codes[i] == NO_ALL_COMMIT;
  }
  IvPlan p;
  p.segs.n = 0;
  int off = 0;
  for (int f = 0; f < N_FIELDS; ++f) {
    p.foff[f] = -1;
    p.gsrc[f] = nullptr;
    if (!(mask >> f & 1)) continue;
    const int b = up16(IV_ROWS * field_width(d, f));
    if (IV_STAGES * (off + b) > IV_SMEM_MAX) {
      p.gsrc[f] = P.f[f];
      continue;
    }
    const int s = p.segs.n++;
    p.segs.src[s] = P.f[f];
    p.segs.dst[s] = p.foff[f] = off;
    p.segs.rb[s] = field_width(d, f);
    off += b;
  }
  p.ids_off = -1;
  const int ids_b = up16(IV_ROWS * cap_m * id_bytes);
  if (need_ids && IV_STAGES * (off + ids_b) <= IV_SMEM_MAX) {
    const int s = p.segs.n++;
    p.segs.src[s] = (const uint8_t*)ids;
    p.segs.dst[s] = p.ids_off = off;
    p.segs.rb[s] = cap_m * id_bytes;
    off += ids_b;
  }
  p.buf_b = off;
  return p;
}

// Tile ti's live rows into stage buffer k (one cp.async group a call,
// empty past the last tile).
__device__ __forceinline__ void stage_tile(uint8_t* smem, int buf_b, const Segs* sg,
                                           long long ti, long long n_tiles, long long live,
                                           int k) {
  if (ti < n_tiles) {
    const long long base = ti * IV_ROWS;
    stage_rows<IV_ROWS, true>(smem + k * buf_b, sg, base,
                              (int)(live - base < IV_ROWS ? live - base : IV_ROWS), nullptr);
  }
  cp_async_commit();
}

// GF: some field a predicate reads is not staged (plan.gsrc).  Without it
// every field pointer is one into shared memory, so the predicates' loads
// are shared-memory loads, not generic ones.
template <int SN, typename Id, bool GF>
__global__ void __launch_bounds__(IV_ROWS)
    inv_scan_tiles(IvPlan plan, const Id* __restrict__ ids, int cap_m, long long n, InvList inv,
                   Dims d, long long offset, unsigned long long* __restrict__ first_bad,
                   const int64_t* cnt, long long sub) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Segs sg;
  __shared__ InvList iv;  // indexed by a loop counter: here, not copied to local memory
  __shared__ unsigned wmin[IV_ROWS / 32];
  __shared__ int past;
  const int t = threadIdx.x, lane = t & 31;
  const long long live = live_count(cnt, sub, 1, n);
  const long long n_tiles = (live + IV_ROWS - 1) / IV_ROWS;
  if ((long long)blockIdx.x >= n_tiles) return;
  if (t == 0) {
    sg = plan.segs;
    iv = inv;
  }
  __syncthreads();
  for (int s = 0; s < IV_STAGES - 1; ++s)
    stage_tile(smem, plan.buf_b, &sg, blockIdx.x + (long long)s * gridDim.x, n_tiles, live, s);
  int k = 0;  // this tile's stage buffer
  for (long long ti = blockIdx.x; ti < n_tiles;
       ti += gridDim.x, k = k + 1 < IV_STAGES ? k + 1 : 0) {
    const long long base = ti * IV_ROWS;
    if (t == 0) past = (unsigned long long)(base + offset) >= __ldcg(first_bad);
    // IV_STAGES - 1 tiles on, into the buffer the last tile was evaluated from
    stage_tile(smem, plan.buf_b, &sg, ti + (long long)(IV_STAGES - 1) * gridDim.x, n_tiles, live,
               k ? k - 1 : IV_STAGES - 1);
    cp_async_wait<IV_STAGES - 1>();  // this tile's rows
    __syncthreads();
    if (past) break;  // uniform: this tile and every later one of the block
    const uint8_t* buf = smem + k * plan.buf_b;
    unsigned bad_r = ~0u;
    if (base + t < live) {
      TileRows R;  // state t of the tile: row t of each staged field
#pragma unroll
      for (int f = 0; f < N_FIELDS; ++f)
        R.row[f] = plan.foff[f] >= 0 ? buf + plan.foff[f] + t * field_width(d, f)
                   : GF && plan.gsrc[f] ? plan.gsrc[f] + (base + t) * field_width(d, f)
                                  : nullptr;
      const Id* row_ids = plan.ids_off >= 0 ? (const Id*)(buf + plan.ids_off) + t * cap_m
                                            : ids + (base + t) * cap_m;
      bool bad = false;
      for (int i = 0; i < iv.n && !bad; ++i)
        bad = holds<SN>(iv.code[i], R, row_ids, cap_m, t, d) == (iv.negate[i] != 0);
      if (bad) bad_r = t;
    }
    bad_r = __reduce_min_sync(0xFFFFFFFFu, bad_r);
    if (lane == 0) wmin[t >> 5] = bad_r;
    __syncthreads();
    if (t == 0) {
      unsigned m = wmin[0];
      for (int w = 1; w < IV_ROWS / 32; ++w) m = wmin[w] < m ? wmin[w] : m;
      if (m != ~0u) atomicMin(first_bad, (unsigned long long)(base + m + offset));
    }
  }
  cp_async_wait<0>();
}

template <int SN, typename Id, bool GF>
static void launch_tiles(const IvPlan& plan, const void* ids, int cap_m, long long n,
                         const InvList& inv, const Dims& d, long long offset,
                         unsigned long long* first_bad, const int64_t* cnt, long long sub,
                         cudaStream_t st) {
  const void* fn = (const void*)inv_scan_tiles<SN, Id, GF>;
  const size_t smem = IV_STAGES * (size_t)plan.buf_b;
  const unsigned grid = resident_blocks(fn, IV_ROWS, smem, (n + IV_ROWS - 1) / IV_ROWS);
  inv_scan_tiles<SN, Id, GF><<<grid, IV_ROWS, smem, st>>>(plan, (const Id*)ids, cap_m, n, inv,
                                                          d, offset, first_bad, cnt, sub);
}

template <typename Id>
static void launch_for_servers(const IvPlan& plan, const void* ids, int cap_m, long long n,
                               const InvList& inv, const Dims& d, long long offset,
                               unsigned long long* first_bad, const int64_t* cnt, long long sub,
                               cudaStream_t st) {
  bool gf = false;
  for (int f = 0; f < N_FIELDS; ++f) gf |= plan.gsrc[f] != nullptr;
  if (gf) {  // dimensions past the stage buffers: the general build
    launch_tiles<0, Id, true>(plan, ids, cap_m, n, inv, d, offset, first_bad, cnt, sub, st);
    return;
  }
  switch (d.S) {
    case 3:
      launch_tiles<3, Id, false>(plan, ids, cap_m, n, inv, d, offset, first_bad, cnt, sub, st);
      break;
    case 5:
      launch_tiles<5, Id, false>(plan, ids, cap_m, n, inv, d, offset, first_bad, cnt, sub, st);
      break;
    case 7:
      launch_tiles<7, Id, false>(plan, ids, cap_m, n, inv, d, offset, first_bad, cnt, sub, st);
      break;
    default:
      launch_tiles<0, Id, false>(plan, ids, cap_m, n, inv, d, offset, first_bad, cnt, sub, st);
  }
}

// codes[i] = InvCode, negate[i] = 1 for `~Name`.  first_bad is an int64
// that reads -1 when no row is bad, else the smallest bad row + offset.
// fresh = 1 sets it to -1 first; fresh = 0 folds this batch into it (the
// fused level's LC_BAD, set to -1 by lv_begin: no memset inside a level).
// With cnt, rows at or past live_count(cnt, sub, 1, n) are not scanned.
// id_bytes: 2 (int16 ids) or 4 (int32).
EXPORT int launch_inv_scan(const void* const* core, const void* ids, int id_bytes, int cap_m,
                           long long n, const int* codes, const int* negate, int n_inv,
                           const int* dims, long long offset, int fresh, int64_t* first_bad,
                           const int64_t* cnt, long long sub, void* stream) {
  if (n_inv > MAX_INV || (id_bytes != 2 && id_bytes != 4)) return (int)cudaErrorInvalidValue;
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
  if (n > 0) {
    const Dims d = load_dims(dims);
    const IvPlan plan = plan_of(P, ids, id_bytes, cap_m, codes, n_inv, d);
    unsigned long long* fb = (unsigned long long*)first_bad;
    if (id_bytes == 2)
      launch_for_servers<int16_t>(plan, ids, cap_m, n, inv, d, offset, fb, cnt, sub, st);
    else
      launch_for_servers<int32_t>(plan, ids, cap_m, n, inv, d, offset, fb, cnt, sub, st);
  }
  return (int)cudaGetLastError();
}

// The kernels load now (not inside a graph capture), with room for the
// stage buffers (IV_SMEM_MAX).
EXPORT int lib_warm() {
  const void* fns[] = {
      (const void*)inv_scan_tiles<0, int16_t, false>, (const void*)inv_scan_tiles<3, int16_t, false>,
      (const void*)inv_scan_tiles<5, int16_t, false>, (const void*)inv_scan_tiles<7, int16_t, false>,
      (const void*)inv_scan_tiles<0, int32_t, false>, (const void*)inv_scan_tiles<3, int32_t, false>,
      (const void*)inv_scan_tiles<5, int32_t, false>, (const void*)inv_scan_tiles<7, int32_t, false>,
      (const void*)inv_scan_tiles<0, int16_t, true>, (const void*)inv_scan_tiles<0, int32_t, true>};
  cudaFuncAttributes a;
  for (const void* fn : fns) {
    cudaFuncGetAttributes(&a, fn);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, IV_SMEM_MAX);
  }
  return (int)cudaGetLastError();
}
