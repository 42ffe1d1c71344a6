// The three-pass tile scan of the frontier row compaction (tiered.cu
// drop_rows), the delta stream's and the repack's offsets (deep.cu) and the
// group dedup's digit offsets (sortstore.cu).  The order-keeping value
// compactions are compact.cuh's one-pass scan.
//
// A flag array of n lanes is cut into tiles of TILE lanes; each thread of
// a tile's block takes ITEMS adjacent lanes.
//   count_tiles   one block per tile: its number of flagged lanes;
//   scan_offsets  one block: the exclusive scan of the tile counts, in
//                 place, and the total (the number of flagged lanes);
//   tile_rank     inside a scatter kernel: the rank of the thread's first
//                 flagged lane (tile offset + a block scan of the
//                 per-thread counts), so each flagged lane finds its output
//                 position in lane order.
// Ranks come from the scans, never from atomics, so every launch gives the
// same output.
#pragma once

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

// The first lane this thread takes.
__device__ inline long long thread_base() {
  return (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
}

// The output rank of this thread's first flagged lane.
__device__ inline long long tile_rank(const uint8_t* flags, long long n,
                                      const long long* tile_off) {
  int total;
  return tile_off[blockIdx.x] + block_exclusive_scan(thread_count(flags, n, thread_base()), &total);
}

__global__ void count_tiles(const uint8_t* __restrict__ flags, long long n,
                            long long* __restrict__ tile_count, const int64_t* cnt,
                            long long sub, long long mul) {
  n = live_count(cnt, sub, mul, n);
  const int c = thread_count(flags, n, thread_base());
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

static inline long long n_tiles_of(long long n) { return (n + TILE - 1) / TILE; }

static inline unsigned blocks_of(long long n, long long per) {
  return (unsigned)((n + per - 1) / per);
}
