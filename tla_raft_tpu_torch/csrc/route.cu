// The mesh's owner routing (B15): the stable D-way partition of a shard's
// lanes by owner, and the verdict map back.
//
// Replaces the routing lines of the XLA programs of
// tla_raft_tpu/parallel/sharded.py: _body_all_to_all (:659-684) and
// _body_a2a_phase1 (:753-770) -- owner = fp % D (SENT lanes to a virtual
// owner D), a stable argsort by owner, bincount, the per-lane rank, the
// [D, cap_r] send rows of fp_view, fp_full and payload gathered from the
// owner-grouped lanes, and the overflow counts[:D].max() > cap_r -- and
// the winner grouping of _ship_winners_to_owners (:506-518): the same
// partition of the payloads by a given owner array where a mask holds
// (the winners), into [D, cap_w] rows.  route_back is the verdict map of
// :725-726 and :796-797: lane i wins when the owner's returned verdict at
// (owner[i], rank[i]) is set and the lane was sent (owner < D, rank < cap).
//
// Design: the tile-count, scan and scatter pattern of compact.cu and
// scan.cuh, with one counter per owner a tile instead of one.
//   count    one block per tile of TILE lanes, each of its 8 warps taking
//            256 adjacent lanes in 8 rounds of 32: __match_any_sync groups
//            a round's lanes by owner and the lowest lane of each group adds
//            the group's size to its warp's counter of that owner (shared
//            memory, one row a warp); the block's sums go out owner-major,
//            tile_count[g * n_tiles + tile];
//   scan     one block per owner g: the exclusive scan of its tile counts in
//            place, counts[g] = the total, and the overflow flag when an
//            owner below D has more than cap lanes;
//   scatter  the count pass again, then each warp's offset per owner (the
//            tile's offset plus the warps before it), and each lane's rank =
//            that offset + the lanes of its owner in the warp's earlier
//            rounds + the lanes of its match group below it; the lane's
//            owner and rank are written, and its columns go to
//            rows[owner][rank] when owner < D and rank < cap;
//   pad      every row slot at or past its owner's count gets the fill.
// Ranks come from scans and ballots, never from atomics, so a lane's
// place is its stable-argsort place and every launch gives the same rows.
//
// Bound: bytes.  A lane reads its fp or its mask and owner (8-9 B) and up
// to three 8-byte columns, and writes its owner (4 B), its rank (8 B) and
// its columns once; the pad writes the unfilled row slots.  About 64 B a
// lane with three columns.  The count pass runs twice (the scatter
// recounts its tile rather than store per-lane owners between passes).
#include "common.cuh"

namespace {

constexpr int RT_WARPS = 8;
constexpr int RT_THREADS = RT_WARPS * 32;
constexpr int RT_ROUNDS = 8;
constexpr int RT_TILE = RT_WARPS * RT_ROUNDS * 32;  // 2,048 lanes a tile
constexpr int MAX_GROUPS = 257;                     // owners D <= 256, plus SENT's D
constexpr unsigned long long SENT = ~0ull;

struct Cols {
  const long long* v[3];
  long long* o[3];
  long long fill[3];
};

// The owner of lane i: by fingerprint (mode 0: fp % D, SENT -> D), or the
// given owner where the mask holds, else D (mode 1).
__device__ inline int owner_of(int mode, const long long* fp, const uint8_t* mask,
                               const int* given, int D, long long i) {
  if (mode == 0) {
    const unsigned long long v = (unsigned long long)fp[i];
    return v == SENT ? D : (int)(v % (unsigned long long)D);
  }
  return mask[i] ? given[i] : D;
}

// wc[w][g]: the lanes of owner g among warp w's 256 lanes of this tile.
__device__ inline void warp_counts(int mode, const long long* fp, const uint8_t* mask,
                                   const int* given, long long n, int D,
                                   int (*wc)[MAX_GROUPS]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * RT_TILE + (long long)w * RT_ROUNDS * 32;
  for (int r = 0; r < RT_ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    const int g = i < n ? owner_of(mode, fp, mask, given, D, i) : -1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, g);
    if (g >= 0 && lane == __ffs(peers) - 1) wc[w][g] += __popc(peers);
    __syncwarp();
  }
}

__device__ inline void zero_counts(int (*wc)[MAX_GROUPS], int D) {
  for (int k = threadIdx.x; k < RT_WARPS * (D + 1); k += RT_THREADS)
    wc[k / (D + 1)][k % (D + 1)] = 0;
  __syncthreads();
}

__global__ void route_count(int mode, const long long* fp, const uint8_t* mask, const int* given,
                            long long n, int D, long long* tile_count, long long n_tiles) {
  __shared__ int wc[RT_WARPS][MAX_GROUPS];
  zero_counts(wc, D);
  warp_counts(mode, fp, mask, given, n, D, wc);
  __syncthreads();
  for (int g = threadIdx.x; g <= D; g += RT_THREADS) {
    long long s = 0;
    for (int w = 0; w < RT_WARPS; ++w) s += wc[w][g];
    tile_count[(long long)g * n_tiles + blockIdx.x] = s;
  }
}

// One block per owner g: tile_count[g, :] -> exclusive offsets in place,
// counts[g] = the sum, *ovf = 1 when g < D holds more than cap lanes.
__global__ void route_scan(long long* tile_count, long long n_tiles, int D, long long cap,
                           long long* counts, long long* ovf) {
  __shared__ long long carry;
  __shared__ long long part[RT_THREADS];
  const int g = blockIdx.x;
  long long* t = tile_count + (long long)g * n_tiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long b = 0; b < n_tiles; b += RT_THREADS) {
    const long long i = b + threadIdx.x;
    const long long v = i < n_tiles ? t[i] : 0;
    part[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < RT_THREADS; o <<= 1) {  // Hillis-Steele inclusive scan
      const long long y = threadIdx.x >= o ? part[threadIdx.x - o] : 0;
      __syncthreads();
      part[threadIdx.x] += y;
      __syncthreads();
    }
    if (i < n_tiles) t[i] = carry + part[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += part[RT_THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[g] = carry;
    if (g < D && carry > cap) *ovf = 1;
  }
}

__global__ void route_scatter(int mode, const long long* fp, const uint8_t* mask,
                              const int* given, long long n, int D,
                              const long long* tile_off, long long n_tiles, Cols cs,
                              long long cap, int* lane_owner, long long* lane_rank) {
  __shared__ int wc[RT_WARPS][MAX_GROUPS];
  __shared__ long long wo[RT_WARPS][MAX_GROUPS];
  zero_counts(wc, D);
  warp_counts(mode, fp, mask, given, n, D, wc);
  __syncthreads();
  for (int g = threadIdx.x; g <= D; g += RT_THREADS) {
    long long run = tile_off[(long long)g * n_tiles + blockIdx.x];
    for (int w = 0; w < RT_WARPS; ++w) {
      wo[w][g] = run;
      run += wc[w][g];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * RT_TILE + (long long)w * RT_ROUNDS * 32;
  for (int r = 0; r < RT_ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    const int g = i < n ? owner_of(mode, fp, mask, given, D, i) : -1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, g);
    long long rank = 0;
    if (g >= 0) rank = wo[w][g] + __popc(peers & below);
    __syncwarp();
    if (g >= 0 && lane == __ffs(peers) - 1) wo[w][g] += __popc(peers);
    __syncwarp();
    if (g < 0) continue;
    lane_owner[i] = g;
    lane_rank[i] = rank;
    if (g < D && rank < cap) {
      const long long slot = (long long)g * cap + rank;
      for (int c = 0; c < 3; ++c)
        if (cs.o[c]) cs.o[c][slot] = cs.v[c][i];
    }
  }
}

__global__ void route_pad(const long long* counts, long long cap, long long rows, Cols cs) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= rows * cap) return;
  if (k % cap < counts[k / cap]) return;
  for (int c = 0; c < 3; ++c)
    if (cs.o[c]) cs.o[c][k] = cs.fill[c];
}

__global__ void back_map(const uint8_t* back, const int* lane_owner, const long long* lane_rank,
                         long long n, int D, long long cap, bool* win) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = lane_owner[i];
  const long long r = lane_rank[i];
  win[i] = g < D && r < cap && back[(long long)g * cap + r];
}

inline unsigned blocks(long long n, long long per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

EXPORT long long route_tile() { return RT_TILE; }
EXPORT int route_max_owners() { return MAX_GROUPS - 1; }

// mode 0: owners from fp (i64[n]); mode 1:
// owners from given (i32[n]) where mask (u8[n]) holds.  Columns v0..v2
// (i64[n], any may be null) go to rows o0..o2 (i64[D, cap]) padded with
// f0..f2.  Outputs: counts i64[D + 1], lane_owner i32[n], lane_rank
// i64[n], ovf i64[1].  Scratch: tile_count i64[(D + 1) * ceil(n / TILE)].
EXPORT int route_launch(int mode, const int64_t* fp, const uint8_t* mask, const int32_t* given,
                        long long n, int D, const int64_t* v0, const int64_t* v1,
                        const int64_t* v2, int64_t* o0, int64_t* o1, int64_t* o2, long long f0,
                        long long f1, long long f2, long long cap, int64_t* counts,
                        int32_t* lane_owner, int64_t* lane_rank, int64_t* ovf,
                        int64_t* tile_count, void* stream) {
  if (D < 1 || D > MAX_GROUPS - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = (n + RT_TILE - 1) / RT_TILE;
  Cols cs = {{(const long long*)v0, (const long long*)v1, (const long long*)v2},
             {(long long*)o0, (long long*)o1, (long long*)o2},
             {f0, f1, f2}};
  cudaMemsetAsync(ovf, 0, sizeof(int64_t), st);
  if (n_tiles > 0)
    route_count<<<(unsigned)n_tiles, RT_THREADS, 0, st>>>(
        mode, (const long long*)fp, mask, given, n, D, (long long*)tile_count, n_tiles);
  route_scan<<<D + 1, RT_THREADS, 0, st>>>((long long*)tile_count, n_tiles, D, cap,
                                            (long long*)counts, (long long*)ovf);
  if (n_tiles > 0)
    route_scatter<<<(unsigned)n_tiles, RT_THREADS, 0, st>>>(
        mode, (const long long*)fp, mask, given, n, D, (const long long*)tile_count, n_tiles,
        cs, cap, lane_owner, (long long*)lane_rank);
  if ((long long)D * cap > 0)
    route_pad<<<blocks((long long)D * cap, 256), 256, 0, st>>>((const long long*)counts, cap, D,
                                                                cs);
  return (int)cudaGetLastError();
}

// win[i] = lane_owner[i] < D && lane_rank[i] < cap && back[owner][rank]
// (back u8[D, cap], the verdict tiles returned to this origin).
EXPORT int route_back_launch(const uint8_t* back, const int32_t* lane_owner,
                             const int64_t* lane_rank, long long n, int D, long long cap,
                             bool* win, void* stream) {
  if (n > 0)
    back_map<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        back, lane_owner, (const long long*)lane_rank, n, D, cap, win);
  return (int)cudaGetLastError();
}

WARM((const void*)route_count, (const void*)route_scan, (const void*)route_scatter,
     (const void*)route_pad, (const void*)back_map)
