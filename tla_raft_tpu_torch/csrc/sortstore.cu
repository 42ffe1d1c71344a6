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
//   level_dedup    (a) the live lanes (fp_view not SENT) packed in lane
//                  order by the tile scan of scan.cuh: the first kernel
//                  counts a tile's live lanes and builds, from the same read
//                  of the keys, the histograms of all 8 digits of the live
//                  fp_views; one block scans the tile counts and the 8
//                  histograms into every pass's digit offsets; a third
//                  kernel writes (fp_view, lane) pairs of the live lanes.
//                  (b) A stable LSD radix sort of those pairs by fp_view
//                  alone, 8-bit digits, one launch a pass: a block takes the
//                  next tile of 4,096 pairs (an atomic ticket), each warp
//                  ranks its 512 contiguous pairs in order (warp match +
//                  per-warp digit counts), the block publishes its digit
//                  counts and finds the counts of the tiles before it by a
//                  decoupled look-back over per-(tile, digit) status words
//                  (a pass's epoch in the flag bits, so the words are zeroed
//                  once a call), places the tile's pairs in digit order in
//                  shared memory (48 KB) and writes each digit's pairs out
//                  contiguous at its offset + the earlier tiles' count.
//                  (c) The thread at the head of each run of equal fp_view
//                  tests the store (the same binary search as
//                  sorted_member, one a run: sorted queries, so neighbours
//                  share their search paths), and if the view is new walks
//                  the run for the least (fp_full unsigned, payload signed)
//                  pair through the lanes' gathers -- the lexsort's first
//                  lane of the run, as in group_unique; a run of one lane
//                  reads only its payload -- and writes the keep flag and
//                  the payload.  (Staging a block's slice of the store in
//                  shared memory for its heads, or gathering fp_full and
//                  payload in the last pass, measured slower on the H100.)
//                  (d) The one-pass compaction of compact.cuh packs the
//                  survivors in fp_view order.  14 launches a call (16 before
//                  that compaction took two), every pass over live
//                  lanes only.  Bound: bytes (each input read once, the
//                  outputs written once); the design moves the keys twice at
//                  full width (8 B a lane), then ~12 B a live lane read and
//                  written in each of 8 passes, the heads' gathers and
//                  searches, and 16 B a lane out (the SENT / -1 pad).
//                  The earlier design, an LSD radix sort of every lane over
//                  all 24 key bytes (24 passes of 4 launches, 104 a call),
//                  took 74.94 ms over a depth-25 level's 100,663,296 lanes,
//                  against 40.72 ms for the lexsort's three stable
//                  torch.argsort (H100, chip_smoke.py; PERF.md).
//   group_unique   a stable LSD radix sort of every lane's (fp_view, lane)
//                  pair, 8 passes of 4 launches: a per-block digit
//                  histogram (rs_hist), the exclusive scan of the digit-major
//                  counts (rs_scan_local + scan.cuh's scan_offsets over the
//                  partial sums), and a scatter that ranks each lane among
//                  the equal digits of its block in lane order (warp match +
//                  per-warp counts in shared memory).  Runs of equal fp_view
//                  are then contiguous, and the
//                  thread at the head of each run that is not SENT walks it
//                  and keeps the least (fp_full unsigned, payload signed)
//                  pair -- the lexsort's first lane of the run, whatever
//                  order the run's lanes came in (the values, not the lane,
//                  are the output, and equal pairs give equal values).  The
//                  one-pass compaction packs the heads in sorted order.  Bound: bytes
//                  (each input read once, the outputs written once: 48 B a
//                  lane); the 8 passes move ~28 B a lane each, and a run's
//                  walk is as long as the run (a few lanes at the main
//                  path's shapes; one thread walks a run of equal views).
//   sieve_merge    (_deep_sieve_merge_body, tla_raft_tpu/parallel/sharded.py
//                  :1322: the sorted sieve of the deep sweep, the sort of the
//                  sieve and a round's candidates, the dedup, SENT dropped,
//                  the first scap kept, overflow when more are unique) the
//                  round's live candidates (ascending once the sieve's SENT
//                  holes are skipped) packed by the one-pass compaction, then
//                  the merge path below over the sieve and them, first-of-run
//                  flags, and the compaction again into the scap outputs: the largest
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

// -- the level dedup: live lanes, a one-sweep radix sort by fp_view, run heads ------

constexpr int LD_PASSES = 8;                    // 8-bit digits of the 64-bit fp_view
constexpr int OS_THREADS = 256;                 // one thread a digit in the tables
constexpr int OS_WARPS = OS_THREADS / 32;
constexpr int OS_ITEMS = 16;                    // pairs a thread: a warp ranks 512 in order
constexpr int OS_TILE = OS_THREADS * OS_ITEMS;  // pairs a block
constexpr int OS_FLAG = 58;                     // status word: epoch flag << 58 | count
constexpr u64 OS_COUNT = (1ull << OS_FLAG) - 1;
constexpr int LD_CT = 16;                       // scan tiles a block of ld_count
constexpr int OS_SMEM = OS_TILE * (8 + 4);      // ld_pass's staged keys and lanes

// One block LD_CT scan.cuh tiles: tile[b] = tile b's live lanes (fp_view
// not SENT); hist[d][x] += the live lanes whose digit d is x (every digit
// from one read of the keys, in shared memory, then one global add a bin a
// block); the look-back's status words are zeroed.
__global__ void ld_count(const u64* __restrict__ cv, long long n, long long* __restrict__ tile,
                         unsigned long long* __restrict__ hist, u64* __restrict__ status,
                         long long n_status) {
  __shared__ unsigned h[LD_PASSES * 256];
  for (int i = threadIdx.x; i < LD_PASSES * 256; i += THREADS) h[i] = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n_status;
       i += (long long)gridDim.x * THREADS)
    status[i] = 0;
  __syncthreads();
  const long long n_tiles = (n + TILE - 1) / TILE;
  for (long long tb = (long long)blockIdx.x * LD_CT; tb < (long long)(blockIdx.x + 1) * LD_CT &&
                                                     tb < n_tiles; ++tb) {
    const long long base = tb * TILE + (long long)threadIdx.x * ITEMS;
    int c = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = base + k;
      if (i < n) {
        const u64 x = cv[i];
        if (x != SENT64) {
          ++c;
#pragma unroll
          for (int d = 0; d < LD_PASSES; ++d)
            atomicAdd(&h[d * 256 + (int)((x >> (8 * d)) & 255)], 1u);
        }
      }
    }
    int total;
    block_exclusive_scan(c, &total);
    if (threadIdx.x == 0) tile[tb] = total;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < LD_PASSES * 256; i += THREADS)
    if (h[i]) atomicAdd(&hist[i], (unsigned long long)h[i]);
}

// One block: the tile counts to exclusive offsets in place and their sum to
// *n_live; hist[d][x] to the exclusive offset of digit x in pass d, in
// place; the passes' tickets to 0.
__global__ void ld_scan(long long* __restrict__ tile, long long n_tiles,
                        long long* __restrict__ n_live, unsigned long long* __restrict__ hist,
                        int* __restrict__ ticket) {
  __shared__ long long carry;
  __shared__ long long part[THREADS];
#pragma unroll 1
  for (int d = 0; d < LD_PASSES; ++d) {  // THREADS == 256: a thread a digit
    const int x = (int)hist[d * 256 + threadIdx.x];
    int total;
    const int ex = block_exclusive_scan(x, &total);
    hist[d * 256 + threadIdx.x] = (unsigned long long)ex;
  }
  if (threadIdx.x < LD_PASSES) ticket[threadIdx.x] = 0;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long b = 0; b < n_tiles; b += THREADS) {
    const long long i = b + threadIdx.x;
    const long long v = i < n_tiles ? tile[i] : 0;
    part[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < THREADS; o <<= 1) {  // Hillis-Steele inclusive scan
      const long long y = threadIdx.x >= o ? part[threadIdx.x - o] : 0;
      __syncthreads();
      part[threadIdx.x] += y;
      __syncthreads();
    }
    if (i < n_tiles) tile[i] = carry + part[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += part[THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_live = carry;
}

// The live lanes' (fp_view, lane) pairs, packed in lane order.
__global__ void ld_live(const u64* __restrict__ cv, long long n,
                        const long long* __restrict__ tile_off, u64* __restrict__ keys,
                        unsigned* __restrict__ idx) {
  const long long base = thread_base();
  int c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    c += (i < n && cv[i] != SENT64) ? 1 : 0;
  }
  int total;
  long long r = tile_off[blockIdx.x] + block_exclusive_scan(c, &total);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < n) {
      const u64 x = cv[i];
      if (x != SENT64) {
        keys[r] = x;
        idx[r] = (unsigned)i;
        ++r;
      }
    }
  }
}

// One stable pass over the *n_live pairs by digit `pass`: off[x] is the
// digit's first position, status [tiles][256] the look-back's words, ticket
// the pass's tile counter.  The tile's pairs are placed in digit order in
// shared memory first (OS_SMEM dynamic bytes), so the writes of a digit's
// pairs go out contiguous.
__global__ void __launch_bounds__(OS_THREADS)
    ld_pass(const u64* __restrict__ kin, const unsigned* __restrict__ iin,
            const long long* __restrict__ n_live, int pass,
            const unsigned long long* __restrict__ off, u64* status, int* ticket,
            u64* __restrict__ kout, unsigned* __restrict__ iout) {
  extern __shared__ __align__(16) uint8_t os_smem[];
  u64* sk = (u64*)os_smem;                   // [OS_TILE] keys in the tile's digit order
  unsigned* si = (unsigned*)(sk + OS_TILE);  // [OS_TILE] their lanes
  __shared__ int s_tile;
  __shared__ int s_w[OS_WARPS][256];  // a warp's digit counts, then the earlier warps'
  __shared__ int s_loc[256];          // a digit's first position in the tile
  __shared__ long long s_base[256];   // global position of tile position 0 of the digit
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(ticket + pass, 1);
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) s_w[w][t] = 0;
  __syncthreads();
  const long long nl = *n_live;
  const long long tile = s_tile;
  if (tile * OS_TILE >= nl) return;  // uniform
  const int shift = 8 * pass;
  const long long base = tile * OS_TILE + (long long)warp * (OS_ITEMS * 32);
  const unsigned below = (1u << lane) - 1u;
  u64 k[OS_ITEMS];
  unsigned ix[OS_ITEMS];
  int rk[OS_ITEMS];
#pragma unroll
  for (int j = 0; j < OS_ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    int dg = 256;  // past every digit: a dead lane matches no live one
    k[j] = 0;
    ix[j] = 0;
    if (i < nl) {
      k[j] = kin[i];
      ix[j] = iin[i];
      dg = (int)((k[j] >> shift) & 255);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, dg);
    const int before = dg < 256 ? s_w[warp][dg] : 0;
    rk[j] = before + __popc(peers & below);
    __syncwarp();
    if (dg < 256 && lane == __ffs(peers) - 1) s_w[warp][dg] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread t = digit t: the earlier warps' counts, the tile's count and the
  // digit's first position in the tile
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) {
    const int c = s_w[w][t];
    s_w[w][t] = cnt;
    cnt += c;
  }
  int tile_n;
  const int loc = block_exclusive_scan(cnt, &tile_n);
  s_loc[t] = loc;
  // decoupled look-back: publish the tile's count, add the earlier tiles'
  const u64 agg = (u64)(2 * pass + 1) << OS_FLAG, pre = (u64)(2 * pass + 2) << OS_FLAG;
  long long ex = 0;
  if (tile == 0) {
    atomicExch((unsigned long long*)&status[t], (unsigned long long)(pre | (u64)cnt));
  } else {
    atomicExch((unsigned long long*)&status[tile * 256 + t], (unsigned long long)(agg | (u64)cnt));
    for (long long b = tile - 1;;) {
      const u64 v = *(volatile const u64*)&status[b * 256 + t];
      const u64 fl = v >> OS_FLAG;
      if (fl < (u64)(2 * pass + 1)) continue;  // not yet published in this pass
      ex += (long long)(v & OS_COUNT);
      if (fl == (u64)(2 * pass + 2)) break;
      --b;
    }
    atomicExch((unsigned long long*)&status[tile * 256 + t],
               (unsigned long long)(pre | (u64)(ex + cnt)));
  }
  s_base[t] = (long long)off[pass * 256 + t] + ex - loc;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OS_ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    if (i < nl) {
      const int dg = (int)((k[j] >> shift) & 255);
      const int lp = s_loc[dg] + s_w[warp][dg] + rk[j];
      sk[lp] = k[j];
      si[lp] = ix[j];
    }
  }
  __syncthreads();
  for (int q = t; q < tile_n; q += OS_THREADS) {
    const u64 x = sk[q];
    const long long pos = s_base[(int)((x >> shift) & 255)] + q;
    kout[pos] = x;
    iout[pos] = si[q];
  }
}

// After the sort (sv = the live fp_views ascending, idx their lanes): at the
// head of each run of equal views that is not in the store, flags[i] = 1 and
// sp[i] = the payload of the run's least (fp_full unsigned, payload signed)
// pair (a run of one lane reads no fp_full); other lanes below *n_live get
// flags[i] = 0.
__global__ void ld_heads(const u64* __restrict__ sv, const unsigned* __restrict__ idx,
                         const long long* __restrict__ n_live, const int64_t* __restrict__ cf,
                         const int64_t* __restrict__ cp, const u64* __restrict__ visited,
                         long long V, uint8_t* __restrict__ flags, int64_t* __restrict__ sp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nl = *n_live;
  if (i >= nl) return;
  const u64 x = sv[i];
  if ((i > 0 && sv[i - 1] == x) || member(visited, V, x)) {
    flags[i] = 0;
    return;
  }
  unsigned lane = idx[i];
  long long p = cp[lane];
  if (i + 1 < nl && sv[i + 1] == x) {  // a run of more than one lane
    u64 f = (u64)cf[lane];
    for (long long j = i + 1; j < nl && sv[j] == x; ++j) {
      lane = idx[j];
      const u64 f2 = (u64)cf[lane];
      const long long p2 = cp[lane];
      if (f2 < f || (f2 == f && p2 < p)) {
        f = f2;
        p = p2;
      }
    }
  }
  flags[i] = 1;
  sp[i] = p;
}

EXPORT long long ld_tile() { return OS_TILE; }
EXPORT long long ld_passes() { return LD_PASSES; }

// cv, cf, cp i64[n] (u64, u64, signed); visited u64[V] sorted.  Out:
// new_fps i64[n] (the survivors' fp_view in sorted order, SENT past
// *n_new), new_pay i64[n] (their payloads, -1 past it), *n_new.  Scratch:
// keys u64[2][n], idx u32[2][n], status u64[256 * ceil(n / OS_TILE)], aux
// i64[2048 + 8] (the digit histograms and offsets, the passes' tickets as
// 8 i32, the live count), flags u8[n], sp i64[n], tile i64[ceil(n / TILE)],
// cscr i64[compact_scratch_words(n)] (the compaction's, compact.cuh).
// n < 2^31.
EXPORT int launch_level_dedup(const int64_t* cv, const int64_t* cf, const int64_t* cp, long long n,
                              const int64_t* visited, long long V, int64_t* new_fps,
                              int64_t* new_pay, int64_t* n_new, int64_t* keys, int32_t* idx,
                              int64_t* status, int64_t* aux, uint8_t* flags, int64_t* sp,
                              int64_t* tile, int64_t* cscr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  u64* kb[2] = {(u64*)keys, (u64*)keys + n};
  unsigned* ib[2] = {(unsigned*)idx, (unsigned*)idx + n};
  unsigned long long* hist = (unsigned long long*)aux;
  int* ticket = (int*)(aux + LD_PASSES * 256);
  long long* n_live = (long long*)(aux + LD_PASSES * 256 + LD_PASSES / 2);
  const long long n_tiles = n_tiles_of(n);
  const long long nb = (n + OS_TILE - 1) / OS_TILE;
  int cur = 0;
  if (n > 0) {
    cudaMemsetAsync(hist, 0, LD_PASSES * 256 * sizeof(unsigned long long), st);
    ld_count<<<blocks_of(n_tiles, LD_CT), THREADS, 0, st>>>((const u64*)cv, n, (long long*)tile, hist,
                                                     (u64*)status, nb * 256);
    ld_scan<<<1, THREADS, 0, st>>>((long long*)tile, n_tiles, n_live, hist, ticket);
    ld_live<<<(unsigned)n_tiles, THREADS, 0, st>>>((const u64*)cv, n, (const long long*)tile,
                                                    kb[0], ib[0]);
    cudaFuncSetAttribute((const void*)ld_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         OS_SMEM);
    for (int pass = 0; pass < LD_PASSES; ++pass) {
      ld_pass<<<(unsigned)nb, OS_THREADS, OS_SMEM, st>>>(kb[cur], ib[cur], n_live, pass, hist,
                                                         (u64*)status, ticket, kb[cur ^ 1],
                                                         ib[cur ^ 1]);
      cur ^= 1;
    }
    ld_heads<<<blocks_of(n, THREADS), THREADS, 0, st>>>(kb[cur], ib[cur], n_live, cf, cp,
                                                        (const u64*)visited, V, flags, sp);
  }
  Vals vs = {{(const long long*)kb[cur], (const long long*)sp, nullptr},
             {(long long*)new_fps, (long long*)new_pay, nullptr},
             {-1, -1, 0}};
  return run_compact(flags, FLAG_BYTES, n, vs, n, nullptr, cscr, n_new, (const int64_t*)n_live, 0,
                     1, 0, nullptr, nullptr, nullptr, st);
}

// -- the group dedup's radix passes (per-block histograms, scans, stable scatter) ---

constexpr int RS_THREADS = 256;  // one thread a digit in the block's tables
constexpr int RS_ITEMS = 16;
constexpr int RS_TILE = RS_THREADS * RS_ITEMS;
constexpr int RS_WARPS = RS_THREADS / 32;

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

EXPORT long long rs_tile() { return RS_TILE; }
EXPORT long long rs_scan_tile() { return TILE; }

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
// i64[compact_scratch_words(n)] (the compaction's, compact.cuh).  n < 2^31.
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
  return run_compact(flags, FLAG_BYTES, n, vs, n, nullptr, tile, n_u, nullptr, 0, 1, 0, nullptr,
                     nullptr, nullptr, st);
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
// i64[compact_scratch_words(S + n)] (both compactions', compact.cuh), n_live
// i64 0-d.
EXPORT int launch_sieve_merge(const int64_t* sieve, long long S, const int64_t* cv, long long n,
                              int64_t* out, int64_t* n_unique, int64_t* ovf, uint8_t* flags,
                              int64_t* live, int64_t* merged, int64_t* tile, int64_t* n_live,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(ovf, 0, sizeof(int64_t), st);
  if (n > 0) sm_live<<<blocks_of(n, THREADS), THREADS, 0, st>>>((const u64*)cv, n, flags);
  Vals lv = {{(const long long*)cv, nullptr, nullptr}, {(long long*)live, nullptr, nullptr},
             {-1, 0, 0}};
  int rc = run_compact(flags, FLAG_BYTES, n, lv, n, nullptr, tile, n_live, nullptr, 0, 1, 0,
                       nullptr, nullptr, nullptr, st);
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
  return run_compact(flags, FLAG_BYTES, m, mv, S, nullptr, tile, n_unique, nullptr, 0, 1, 0,
                     nullptr, nullptr, ovf, st);
}

WARM((const void*)sm_live, (const void*)sm_first, (const void*)sorted_member,
     (const void*)ld_count, (const void*)ld_scan, (const void*)ld_live, (const void*)ld_pass,
     (const void*)ld_heads, (const void*)rs_hist, (const void*)rs_scan_local,
     (const void*)scan_offsets, (const void*)rs_scatter, COMPACT_KERNELS, (const void*)merge_sorted,
     (const void*)gu_init, (const void*)gu_heads)
