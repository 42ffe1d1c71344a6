// B19 the sorted visited store: membership, the level's dedup, the merge.
//
// Replaces the XLA programs of tla_raft_tpu/engine/bfs.py
//   _group_filter (:358)  searchsorted of a group's lanes against the
//                         sorted store, then _filter_compact: sorted_member
//                         here writes the keep flags the filter compaction
//                         (compact.cu) takes;
//   _level_dedup  (:407)  lexsort of the level's lanes by (fp_view,
//                         fp_full, payload), the first lane of each fp_view,
//                         searchsorted against the store, and the stable
//                         compaction of the survivors: launch_level_dedup;
//   _merge_sorted (:469)  the sort of the store and the level's new
//                         fingerprints: launch_merge_sorted;
//   _group_unique_impl (:437, jitted as _group_unique :465 and fused into
//                         _expand_group_fused_impl :1130)  the external
//                         store route's dedup of one group's candidates:
//                         the first lane of each fp_view in (fp_view,
//                         fp_full, payload) order, SENT dropped, compacted
//                         fp_view-ascending with its fp_full and payload,
//                         and no store access: launch_group_unique.
// Fingerprints are u64 held in int64 (SENT = all ones, the largest value,
// so pads sort last); the kernels compare them as unsigned.  The payload is
// a signed key: its sign bit is flipped before it is sorted as unsigned.
//
// Design.
//   sorted_member  one thread a lane: a branch-free binary search (the
//                  lower bound) over the store, then one compare.  Bound:
//                  bytes (8 B read, 1 B written a lane, and at most one
//                  32-byte sector of the store a lane: a search needs no
//                  more of it), but each search is ~log2(V) dependent loads,
//                  most from L2.
//   level_dedup    a stable LSD radix sort, 8-bit digits, of the lanes'
//                  index by the 24-byte key: 8 passes over the payload (sign
//                  flipped), then the index gathers fp_full and 8 passes, then
//                  fp_view and 8 passes.  A pass moves (key word, u32 index)
//                  pairs: a per-block digit histogram (rs_hist), the
//                  exclusive scan of the digit-major counts (rs_scan_local +
//                  scan.cuh's scan_offsets over the partial sums), and a
//                  scatter that ranks each lane among the equal digits of its
//                  block in lane order (warp match + per-warp counts in
//                  shared memory), so every pass is stable and the result is
//                  the lexicographic order.  Then one pass flags the first
//                  lane of each fp_view that is not SENT and not in the store
//                  (the same binary search) and gathers its payload, and the
//                  tile scan of compact.cuh packs the survivors in sorted
//                  order.  Bound: bytes; 24 passes of ~28 B a lane (8 B key
//                  read twice, key and index read and written once).
//   group_unique   the same radix passes over fp_view alone (8 instead of
//                  24): runs of equal fp_view are then contiguous, and the
//                  thread at the head of each run that is not SENT walks it
//                  and keeps the least (fp_full unsigned, payload signed)
//                  pair -- the lexsort's first lane of the run, whatever
//                  order the run's lanes came in (the values, not the lane,
//                  are the output, and equal pairs give equal values).  The
//                  tile scan packs the heads in sorted order.  Bound: bytes
//                  (each input read once, the outputs written once: 48 B a
//                  lane); the 8 passes move ~28 B a lane each, and a run's
//                  walk is as long as the run (a few lanes at the main
//                  path's shapes; one thread walks a run of equal views).
//   sieve_merge    (_deep_sieve_merge_body, tla_raft_tpu/parallel/sharded.py
//                  :1322: the sorted sieve of the deep sweep, the sort of the
//                  sieve and a round's candidates, the dedup, SENT dropped,
//                  the first scap kept, overflow when more are unique) the
//                  round's live candidates (ascending once the sieve's SENT
//                  holes are skipped) packed by the tile scan, then the merge
//                  path below over the sieve and them, first-of-run flags,
//                  and the tile scan again into the scap outputs: the largest
//                  fall off the end, and the overflow is the unique count
//                  past scap.  Duplicates across rounds, which a merge alone
//                  keeps, are runs of equal values after it.  Bound: bytes
//                  (each input read once, the output written once); the
//                  passes move the merged lanes about four times.
//   merge_sorted   merge path: each block searches its first and last
//                  output diagonal (two binary searches), stages its slices
//                  of both inputs in shared memory, and each thread merges
//                  8 outputs from its own diagonal; the block writes its tile
//                  coalesced.  Only the first n_out outputs are made (the
//                  caller's trim).  Bound: bytes (each input read once, the
//                  output written once).
// No atomics decide an output: every launch gives the same bytes.
#include "compact.cuh"

typedef unsigned long long u64;

constexpr u64 SENT64 = ~0ull;
constexpr u64 SIGN64 = 1ull << 63;

// -- membership --------------------------------------------------------------

// The first position whose value is >= x (V when none), branch-free.
__device__ inline long long lower_bound_u64(const u64* __restrict__ v, long long V, u64 x) {
  const u64* b = v;
  long long len = V;
  while (len > 1) {
    const long long half = len >> 1;
    b += (b[half - 1] < x) ? half : 0;
    len -= half;
  }
  return (b - v) + (*b < x ? 1 : 0);
}

// x is in the sorted store v[V] (the reference's visited[clip(pos)] == x).
__device__ inline bool member(const u64* __restrict__ v, long long V, u64 x) {
  if (V <= 0) return false;
  long long p = lower_bound_u64(v, V, x);
  if (p >= V) p = V - 1;
  return v[p] == x;
}

__global__ void sorted_member(const u64* __restrict__ visited, long long V,
                              const u64* __restrict__ fps, long long n, bool* __restrict__ hit,
                              bool* __restrict__ keep) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const u64 x = fps[i];
    const bool h = member(visited, V, x);
    if (hit) hit[i] = h;
    if (keep) keep[i] = x != SENT64 && !h;
  }
}

// visited u64[V] sorted; hit and keep bool[n] (either may be null): hit[i]
// = fps[i] is in the store, keep[i] = fps[i] is not SENT and not in it.
EXPORT int launch_sorted_member(const int64_t* visited, long long V, const int64_t* fps,
                                long long n, bool* hit, bool* keep, void* stream) {
  if (n > 0) {
    const long long b = (n + 255) / 256;
    sorted_member<<<(unsigned)(b > 65535 ? 65535 : b), 256, 0, (cudaStream_t)stream>>>(
        (const u64*)visited, V, (const u64*)fps, n, hit, keep);
  }
  return (int)cudaGetLastError();
}

// -- the level dedup: a stable LSD radix sort, then flags and compaction ------------

constexpr int RS_THREADS = 256;  // one thread a digit in the block's tables
constexpr int RS_ITEMS = 16;
constexpr int RS_TILE = RS_THREADS * RS_ITEMS;
constexpr int RS_WARPS = RS_THREADS / 32;

// keys = payload with its sign bit flipped (signed order as unsigned), idx = lane.
__global__ void rs_init(const int64_t* __restrict__ cp, long long n, u64* __restrict__ keys,
                        unsigned* __restrict__ idx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    keys[i] = (u64)cp[i] ^ SIGN64;
    idx[i] = (unsigned)i;
  }
}

// keys[i] = src[idx[i]]: the next key word in the current order.
__global__ void rs_gather(const u64* __restrict__ src, const unsigned* __restrict__ idx,
                          long long n, u64* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = src[idx[i]];
}

// counts[digit * nb + block] = the block tile's lanes with that digit.
__global__ void rs_hist(const u64* __restrict__ keys, long long n, int shift,
                        int* __restrict__ counts, long long nb) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RS_TILE;
  for (int r = 0; r < RS_ITEMS; ++r) {
    const long long i = base + (long long)r * RS_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(int)((keys[i] >> shift) & 255)], 1);
  }
  __syncthreads();
  counts[(long long)threadIdx.x * nb + blockIdx.x] = h[threadIdx.x];
}

// Exclusive scan of counts[m] within tiles of scan.cuh's TILE; each tile's
// sum to part[tile] (scan_offsets then scans part).
__global__ void rs_scan_local(int* __restrict__ counts, long long m, long long* __restrict__ part) {
  const long long base = thread_base();
  int v[ITEMS];
  int s = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    v[k] = i < m ? counts[i] : 0;
    s += v[k];
  }
  int total;
  int ex = block_exclusive_scan(s, &total);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < m) counts[i] = ex;
    ex += v[k];
  }
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// One stable pass: each lane of the block's tile goes to its digit's global
// offset for this block plus its rank among the block's earlier lanes of the
// same digit (rounds of RS_THREADS lanes in lane order; in a round, the
// earlier warps' counts of the digit, then the rank in the warp).
__global__ void rs_scatter(const u64* __restrict__ kin, const unsigned* __restrict__ iin,
                           long long n, int shift, const int* __restrict__ counts,
                           const long long* __restrict__ part, long long nb,
                           u64* __restrict__ kout, unsigned* __restrict__ iout) {
  __shared__ int s_off[256];
  __shared__ int s_w[RS_WARPS][256];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  {
    const long long c = (long long)t * nb + blockIdx.x;
    s_off[t] = counts[c] + (int)part[c / TILE];
  }
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) s_w[w][t] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RS_TILE;
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < RS_ITEMS; ++r) {
    const long long i = base + (long long)r * RS_THREADS + t;
    const bool valid = i < n;
    u64 k = 0;
    unsigned ix = 0;
    int d = 256;  // past every digit: a dead lane matches no live one
    if (valid) {
      k = kin[i];
      ix = iin[i];
      d = (int)((k >> shift) & 255);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & below);
    if (valid && lane == __ffs(peers) - 1) s_w[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = s_off[d] + rank;
      for (int w = 0; w < warp; ++w) pos += s_w[w][d];
      kout[pos] = k;
      iout[pos] = ix;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) {
      add += s_w[w][t];
      s_w[w][t] = 0;
    }
    s_off[t] += add;
    __syncthreads();
  }
}

// After the sort (sv = fp_view in sorted order, idx the lanes): flags[i] =
// the first lane of its fp_view, not SENT, not in the store; sp[i] = its
// payload.
__global__ void dedup_flags(const u64* __restrict__ sv, const unsigned* __restrict__ idx,
                            long long n, const int64_t* __restrict__ cp,
                            const u64* __restrict__ visited, long long V,
                            uint8_t* __restrict__ flags, int64_t* __restrict__ sp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 x = sv[i];
  const bool first = i == 0 || sv[i - 1] != x;
  flags[i] = first && x != SENT64 && !member(visited, V, x);
  sp[i] = cp[idx[i]];
}

EXPORT long long rs_tile() { return RS_TILE; }
EXPORT long long rs_scan_tile() { return TILE; }

// cv, cf, cp i64[n] (u64, u64, signed); visited u64[V] sorted.  Out:
// new_fps i64[n] (the survivors' fp_view in sorted order, SENT past
// *n_new), new_pay i64[n] (their payloads, -1 past it), *n_new.  Scratch:
// keys u64[2][n], idx u32[2][n], counts i32[256 * nb] (nb = ceil(n /
// RS_TILE)), part i64[ceil(256 * nb / TILE) + 1], flags u8[n], sp i64[n],
// tile i64[ceil(n / TILE)].  n < 2^31.
EXPORT int launch_level_dedup(const int64_t* cv, const int64_t* cf, const int64_t* cp, long long n,
                              const int64_t* visited, long long V, int64_t* new_fps,
                              int64_t* new_pay, int64_t* n_new, int64_t* keys, int32_t* idx,
                              int32_t* counts, int64_t* part, uint8_t* flags, int64_t* sp,
                              int64_t* tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  u64* kb[2] = {(u64*)keys, (u64*)keys + n};
  unsigned* ib[2] = {(unsigned*)idx, (unsigned*)idx + n};
  const long long nb = (n + RS_TILE - 1) / RS_TILE;
  const long long m = 256 * nb;
  const long long n_parts = (m + TILE - 1) / TILE;
  const unsigned eb = blocks_of(n, THREADS);
  int cur = 0;
  if (n > 0) {
    rs_init<<<eb, THREADS, 0, st>>>(cp, n, kb[0], ib[0]);
    const u64* words[3] = {nullptr, (const u64*)cf, (const u64*)cv};
    for (int w = 0; w < 3; ++w) {
      if (words[w]) rs_gather<<<eb, THREADS, 0, st>>>(words[w], ib[cur], n, kb[cur]);
      for (int shift = 0; shift < 64; shift += 8) {
        rs_hist<<<(unsigned)nb, RS_THREADS, 0, st>>>(kb[cur], n, shift, counts, nb);
        rs_scan_local<<<(unsigned)n_parts, THREADS, 0, st>>>(counts, m, (long long*)part);
        scan_offsets<<<1, THREADS, 0, st>>>((long long*)part, n_parts,
                                            (long long*)part + n_parts);
        rs_scatter<<<(unsigned)nb, RS_THREADS, 0, st>>>(kb[cur], ib[cur], n, shift, counts,
                                                         (const long long*)part, nb,
                                                         kb[cur ^ 1], ib[cur ^ 1]);
        cur ^= 1;
      }
    }
    dedup_flags<<<eb, THREADS, 0, st>>>(kb[cur], ib[cur], n, cp, (const u64*)visited, V, flags,
                                        sp);
  }
  Vals vs = {{(const long long*)kb[cur], (const long long*)sp, nullptr},
             {(long long*)new_fps, (long long*)new_pay, nullptr},
             {-1, -1, 0}};
  return run_compact(flags, n, vs, n, nullptr, tile, n_new, nullptr, 0, 1, 0, nullptr, nullptr,
                     nullptr, st);
}

// -- the group dedup: 8 radix passes on fp_view, then each run's least pair ----------

// keys = fp_view, idx = lane.
__global__ void gu_init(const int64_t* __restrict__ cv, long long n, u64* __restrict__ keys,
                        unsigned* __restrict__ idx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    keys[i] = (u64)cv[i];
    idx[i] = (unsigned)i;
  }
}

// After the sort by fp_view (sv, idx the lanes): flags[i] = the head of a
// run of equal fp_view that is not SENT; bf[i], bp[i] = the run's least
// (fp_full as unsigned, payload as signed) pair.  Other lanes write only
// their flag.
__global__ void gu_heads(const u64* __restrict__ sv, const unsigned* __restrict__ idx,
                         long long n, const int64_t* __restrict__ cf,
                         const int64_t* __restrict__ cp, uint8_t* __restrict__ flags,
                         int64_t* __restrict__ bf, int64_t* __restrict__ bp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 x = sv[i];
  if ((i > 0 && sv[i - 1] == x) || x == SENT64) {
    flags[i] = 0;
    return;
  }
  unsigned lane = idx[i];
  u64 f = (u64)cf[lane];
  long long p = cp[lane];
  for (long long j = i + 1; j < n && sv[j] == x; ++j) {
    lane = idx[j];
    const u64 f2 = (u64)cf[lane];
    const long long p2 = cp[lane];
    if (f2 < f || (f2 == f && p2 < p)) {
      f = f2;
      p = p2;
    }
  }
  flags[i] = 1;
  bf[i] = (int64_t)f;
  bp[i] = p;
}

// cv, cf, cp i64[n] (u64, u64, signed).  Out: gv, gf i64[n] (the heads'
// fp_view and least fp_full in fp_view order, SENT past *n_u), gp i64[n]
// (the least pair's payload, -1 past it), *n_u.  Scratch: keys u64[2][n],
// idx u32[2][n], counts i32[256 * nb] (nb = ceil(n / RS_TILE)), part
// i64[ceil(256 * nb / TILE) + 1], flags u8[n], bf i64[n], bp i64[n], tile
// i64[ceil(n / TILE)].  n < 2^31.
EXPORT int launch_group_unique(const int64_t* cv, const int64_t* cf, const int64_t* cp,
                               long long n, int64_t* gv, int64_t* gf, int64_t* gp,
                               int64_t* n_u, int64_t* keys, int32_t* idx, int32_t* counts,
                               int64_t* part, uint8_t* flags, int64_t* bf, int64_t* bp,
                               int64_t* tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  u64* kb[2] = {(u64*)keys, (u64*)keys + n};
  unsigned* ib[2] = {(unsigned*)idx, (unsigned*)idx + n};
  const long long nb = (n + RS_TILE - 1) / RS_TILE;
  const long long m = 256 * nb;
  const long long n_parts = (m + TILE - 1) / TILE;
  const unsigned eb = blocks_of(n, THREADS);
  int cur = 0;
  if (n > 0) {
    gu_init<<<eb, THREADS, 0, st>>>(cv, n, kb[0], ib[0]);
    for (int shift = 0; shift < 64; shift += 8) {
      rs_hist<<<(unsigned)nb, RS_THREADS, 0, st>>>(kb[cur], n, shift, counts, nb);
      rs_scan_local<<<(unsigned)n_parts, THREADS, 0, st>>>(counts, m, (long long*)part);
      scan_offsets<<<1, THREADS, 0, st>>>((long long*)part, n_parts, (long long*)part + n_parts);
      rs_scatter<<<(unsigned)nb, RS_THREADS, 0, st>>>(kb[cur], ib[cur], n, shift, counts,
                                                       (const long long*)part, nb, kb[cur ^ 1],
                                                       ib[cur ^ 1]);
      cur ^= 1;
    }
    gu_heads<<<eb, THREADS, 0, st>>>(kb[cur], ib[cur], n, cf, cp, flags, bf, bp);
  }
  Vals vs = {{(const long long*)kb[cur], (const long long*)bf, (const long long*)bp},
             {(long long*)gv, (long long*)gf, (long long*)gp},
             {-1, -1, -1}};
  return run_compact(flags, n, vs, n, nullptr, tile, n_u, nullptr, 0, 1, 0, nullptr, nullptr,
                     nullptr, st);
}

// -- the merge ----------------------------------------------------------------------

constexpr int MG_THREADS = 256;
constexpr int MG_ITEMS = 8;
constexpr int MG_TILE = MG_THREADS * MG_ITEMS;

// How many of the first d outputs come from a (ties: a first).
__device__ inline long long merge_path(const u64* __restrict__ a, long long A,
                                       const u64* __restrict__ b, long long B, long long d) {
  long long lo = d > B ? d - B : 0, hi = d < A ? d : A;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void merge_sorted(const u64* __restrict__ a, long long A, const u64* __restrict__ b,
                             long long B, u64* __restrict__ out, long long n_out) {
  __shared__ long long s_split[2];
  __shared__ u64 s_in[MG_TILE];
  __shared__ u64 s_out[MG_TILE];
  const long long d0 = (long long)blockIdx.x * MG_TILE;
  const long long d1 = d0 + MG_TILE < n_out ? d0 + MG_TILE : n_out;
  if (threadIdx.x < 2) s_split[threadIdx.x] = merge_path(a, A, b, B, threadIdx.x ? d1 : d0);
  __syncthreads();
  const long long i0 = s_split[0], i1 = s_split[1];
  const int na = (int)(i1 - i0), nbb = (int)((d1 - i1) - (d0 - i0));
  const long long j0 = d0 - i0;
  for (int k = threadIdx.x; k < na; k += MG_THREADS) s_in[k] = a[i0 + k];
  for (int k = threadIdx.x; k < nbb; k += MG_THREADS) s_in[na + k] = b[j0 + k];
  __syncthreads();
  const u64* sa = s_in;
  const u64* sb = s_in + na;
  const int len = (int)(d1 - d0);
  const int t0 = threadIdx.x * MG_ITEMS;
  if (t0 < len) {
    int lo = t0 > nbb ? t0 - nbb : 0, hi = t0 < na ? t0 : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] <= sb[t0 - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    int ia = lo, ib = t0 - lo;
    const int t1 = t0 + MG_ITEMS < len ? t0 + MG_ITEMS : len;
    for (int k = t0; k < t1; ++k) {
      const bool take_a = ib >= nbb || (ia < na && sa[ia] <= sb[ib]);
      s_out[k] = take_a ? sa[ia++] : sb[ib++];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += MG_THREADS) out[d0 + k] = s_out[k];
}

// a u64[A], b u64[B], each sorted; out u64[n_out] = the first n_out values
// of their sorted union (with repeats), n_out <= A + B.
EXPORT int launch_merge_sorted(const int64_t* a, long long A, const int64_t* b, long long B,
                               int64_t* out, long long n_out, void* stream) {
  if (n_out < 0 || n_out > A + B) return (int)cudaErrorInvalidValue;
  if (n_out > 0)
    merge_sorted<<<blocks_of(n_out, MG_TILE), MG_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)a, A, (const u64*)b, B, (u64*)out, n_out);
  return (int)cudaGetLastError();
}

// -- the deep sweep's sorted sieve -----------------------------------------------

// flags[i] = v[i] is not SENT.
__global__ void sm_live(const u64* __restrict__ v, long long n, uint8_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) flags[i] = v[i] != SENT64;
}

// flags[i] = v[i] is the first of its run and not SENT (v sorted).
__global__ void sm_first(const u64* __restrict__ v, long long n, uint8_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) flags[i] = v[i] != SENT64 && (i == 0 || v[i - 1] != v[i]);
}

// sieve u64[S] sorted (SENT-padded), cv u64[n] ascending where not SENT.
// out u64[S] = the first S of the sorted unique non-SENT values of both,
// SENT-padded; *n_unique = their count; *ovf = 1 when it passes S (else 0).
// Scratch: flags u8[S + n], live u64[n], merged u64[S + n], tile
// i64[ceil((S + n) / TILE)], n_live i64 0-d.
EXPORT int launch_sieve_merge(const int64_t* sieve, long long S, const int64_t* cv, long long n,
                              int64_t* out, int64_t* n_unique, int64_t* ovf, uint8_t* flags,
                              int64_t* live, int64_t* merged, int64_t* tile, int64_t* n_live,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(ovf, 0, sizeof(int64_t), st);
  if (n > 0) sm_live<<<blocks_of(n, THREADS), THREADS, 0, st>>>((const u64*)cv, n, flags);
  Vals lv = {{(const long long*)cv, nullptr, nullptr}, {(long long*)live, nullptr, nullptr},
             {-1, 0, 0}};
  int rc = run_compact(flags, n, lv, n, nullptr, tile, n_live, nullptr, 0, 1, 0, nullptr, nullptr,
                       nullptr, st);
  if (rc) return rc;
  const long long m = S + n;
  if (m > 0) {
    merge_sorted<<<blocks_of(m, MG_TILE), MG_THREADS, 0, st>>>((const u64*)sieve, S,
                                                                (const u64*)live, n,
                                                                (u64*)merged, m);
    sm_first<<<blocks_of(m, THREADS), THREADS, 0, st>>>((const u64*)merged, m, flags);
  }
  Vals mv = {{(const long long*)merged, nullptr, nullptr}, {(long long*)out, nullptr, nullptr},
             {-1, 0, 0}};
  return run_compact(flags, m, mv, S, nullptr, tile, n_unique, nullptr, 0, 1, 0, nullptr, nullptr,
                     ovf, st);
}

WARM((const void*)sm_live, (const void*)sm_first, (const void*)sorted_member,
     (const void*)rs_init, (const void*)rs_gather,
     (const void*)rs_hist, (const void*)rs_scan_local, (const void*)scan_offsets,
     (const void*)rs_scatter, (const void*)dedup_flags, (const void*)count_tiles,
     (const void*)scatter_tiles, (const void*)pad_tail, (const void*)merge_sorted,
     (const void*)gu_init, (const void*)gu_heads)
