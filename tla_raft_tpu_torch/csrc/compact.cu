// Order-keeping compaction: the flagged lanes' values packed to a prefix.
//
// Replaces the XLA programs of tla_raft_tpu/engine/bfs.py _compact_payloads
// (the valid (parent, slot) lanes of a chunk packed to cap_x candidate
// lanes, plus the overflow flag) and tla_raft_tpu/ops/hashstore.py
// compact_fresh (the fresh lanes of a level's insert packed to the new
// frontier's payload list).  Both are a cumsum over the flags and a scatter
// of the values to their ranks; the order of the kept lanes is the lane
// order, so the compacted list does not depend on the chunk size.
//
// Design: a three-pass tile scan, each pass a launch.
//   count    one block per tile of TILE lanes: its number of flagged lanes;
//   offsets  one block: the exclusive scan of the tile counts, and the
//            total (the number of flagged lanes);
//   scatter  one block per tile again: each thread takes ITEMS adjacent
//            lanes, a block scan of the per-thread counts gives each
//            flagged lane its rank, and the lane writes its value(s) there
//            when the rank is below cap;
//   pad      every output lane at or past the total gets the pad values,
//            and the optional lane mask is rank < total.
// Ranks come from the scan, never from atomics, so the output is the same
// on every launch.
//
// Bound: bytes.  The flags are read twice (1 B a lane), the kept values
// once (8 B each) and written once; the pad pass writes the rest of cap.
// The integer work is a few operations per lane.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;

// Exclusive block scan of one int per thread; *total gets the block sum.
__device__ inline int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return before + inc - x;
}

__device__ inline int thread_count(const uint8_t* flags, long long n, long long base) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    c += (i < n && flags[i]) ? 1 : 0;
  }
  return c;
}

__global__ void count_tiles(const uint8_t* __restrict__ flags, long long n,
                            long long* __restrict__ tile_count, const int64_t* cnt,
                            long long sub, long long mul) {
  n = live_count(cnt, sub, mul, n);
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  const int c = thread_count(flags, n, base);
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

// One block: tile_count -> exclusive offsets in place; *total = the sum.
__global__ void scan_offsets(long long* __restrict__ tile, long long n_tiles,
                             long long* __restrict__ total) {
  __shared__ long long carry;
  __shared__ long long part[THREADS];
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
  if (threadIdx.x == 0) *total = carry;
}

__global__ void scatter_tiles(const uint8_t* __restrict__ flags, long long n,
                              const long long* __restrict__ tile_off,
                              const long long* __restrict__ va, const long long* __restrict__ vb,
                              long long cap, long long* __restrict__ oa, long long* __restrict__ ob,
                              const int64_t* cnt, long long sub, long long mul,
                              long long iota_base) {
  n = live_count(cnt, sub, mul, n);
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  int total;
  long long r = tile_off[blockIdx.x] + block_exclusive_scan(thread_count(flags, n, base), &total);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < n && flags[i]) {
      if (r < cap) {
        oa[r] = va ? va[i] : iota_base + i;
        if (ob) ob[r] = vb[i];
      }
      ++r;
    }
  }
}

__global__ void pad_tail(const long long* __restrict__ total, long long cap, long long pad_a,
                         long long pad_b, long long* __restrict__ oa, long long* __restrict__ ob,
                         bool* __restrict__ lane) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const bool kept = i < *total;
  if (!kept) {
    oa[i] = pad_a;
    if (ob) ob[i] = pad_b;
  }
  if (lane) lane[i] = kept;
}

static inline unsigned blocks_of(long long n, long long per) { return (unsigned)((n + per - 1) / per); }

// Scratch: tile i64[ceil(n / TILE)].  vb/ob and lane may be null; va null
// means the values are iota_base + lane (the chunk's payloads).  With cnt,
// only the first live_count(cnt, sub, mul, n) flag lanes count.
EXPORT long long compact_tile() { return TILE; }

EXPORT int launch_compact(const uint8_t* flags, long long n, const int64_t* va,
                          const int64_t* vb, long long pad_a, long long pad_b, long long cap,
                          int64_t* oa, int64_t* ob, bool* lane, int64_t* tile, int64_t* total,
                          const int64_t* cnt, long long sub, long long mul, long long iota_base,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (n_tiles > 0)
    count_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>(flags, n, (long long*)tile, cnt, sub,
                                                       mul);
  scan_offsets<<<1, THREADS, 0, st>>>((long long*)tile, n_tiles, (long long*)total);
  if (n_tiles > 0)
    scatter_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        flags, n, (const long long*)tile, (const long long*)va, (const long long*)vb, cap,
        (long long*)oa, (long long*)ob, cnt, sub, mul, iota_base);
  if (cap > 0)
    pad_tail<<<blocks_of(cap, THREADS), THREADS, 0, st>>>(
        (const long long*)total, cap, pad_a, pad_b, (long long*)oa, (long long*)ob, lane);
  return (int)cudaGetLastError();
}

WARM((const void*)count_tiles, (const void*)scan_offsets, (const void*)scatter_tiles,
     (const void*)pad_tail)
