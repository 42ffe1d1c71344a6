// The order-keeping compaction: the flagged lanes' values (up to three
// arrays) packed to a prefix in lane order, the rest padded.  Shared by
// compact.cu (the chunk, fresh-lane, filter and fan-out compactions) and
// sortstore.cu (the level dedup's survivors, the group dedup's heads, the
// sorted sieve's merges).
//
// Design: one pass over the flags with decoupled look-back, then a small
// pad launch; two launches a call.
//   compact_pass  a block takes the next tile of lanes by an atomic
//                 ticket, so it only ever waits on tiles that running blocks
//                 hold; each thread reads its 32 lanes' flags (64 from
//                 CP_LARGE lanes) as 16-B vectors (bytes where the flags
//                 are not 16-B aligned, and in the last vectors; the chunk
//                 compaction's fingerprints are read coalesced, a lane a
//                 thread, into flag bytes in shared memory first), their ranks in the tile come from warp
//                 ballots of the threads' counts and popcounts, and the
//                 tile's kept lanes are listed in order in shared memory.
//                 Warp 0 publishes the tile's count, then (after a look-back
//                 over the status words of the tiles before it, 32 at a
//                 time) its inclusive prefix; then the block writes its kept
//                 values to their ranks, adjacent threads on adjacent
//                 outputs, four lanes' loads in flight a thread.  The flags
//                 are read once.
//   compact_pad   every output lane at or past the total gets the pad
//                 values, and the optional lane mask is rank < total; the
//                 total (the last live tile's inclusive prefix), the
//                 overflow word (total > cap), and the scratch's ticket and
//                 epoch for the next call.
// Scratch (compact_scratch_words(n): CP_CTL + a word each 8,192 lanes, zero
// at allocation and used by nothing else; a scratch sized for n serves any
// compaction of at most n lanes): the ticket, the epoch, then a status word
// a tile:
// epoch << 38 | flag << 36 | count, flag 1 a tile's own count, 2 its
// inclusive prefix.  A word is valid only in its call's epoch, so neither
// the host nor a reset node touches the scratch between calls, and a
// captured graph replays it as it is.  (The epoch is 26 bits: a stale word
// could pass for a fresh one only after 2^26 calls on one scratch left it
// unwritten.)  Ranks come from the scan, never from atomics, so every
// launch gives the same output.
//
// The earlier design (count_tiles, scan_offsets, scatter_tiles, pad_tail of
// scan.cuh's tile scan: the flags read twice, a byte a load, and one block
// scanning the tile counts) took ~0.046 ms over a chunk's 11,403,264 flag
// lanes on an H100 (PERF.md); drop_rows (tiered.cu), pack_deltas and
// deep_repack (deep.cu) and group_unique's digit offsets (sortstore.cu)
// keep that scan.
#pragma once

#include "scan.cuh"

// Up to three value arrays (v[0] null: the values are iota_base + lane),
// their outputs and pad values.
struct Vals {
  const long long* v[3];
  long long* o[3];
  long long pad[3];
};

constexpr int CP_THREADS = 256;
constexpr int CP_WARPS = CP_THREADS / 32;
constexpr long long CP_LARGE = 1ll << 22;         // from here a thread takes 64 lanes
constexpr int CP_CTL = 2;                         // the ticket and the epoch
constexpr int CP_WRITE = 4;                       // kept lanes a thread writes at once
constexpr int CP_COUNT_BITS = 36;
constexpr unsigned long long CP_COUNT = (1ull << CP_COUNT_BITS) - 1;
constexpr unsigned long long CP_EPOCHS = 1ull << 26;
constexpr unsigned CP_AGG = 1, CP_INC = 2;

// Where a lane's flag comes from: a byte (kept when not 0), or an i64
// fingerprint (kept when not SENT: the chunk compaction's live lanes).
enum FlagSrc { FLAG_BYTES = 0, FLAG_LIVE_FP = 1 };

// Flag lanes a thread takes in a compaction of n lanes: 32 (two 16-B
// vectors; tiles of 8,192 lanes), or 64 from CP_LARGE lanes (tiles of
// 16,384: half the tiles, so a chunk's 11.4 M flags run in one wave of
// resident blocks).
__host__ __device__ inline int cp_items(long long n) { return n >= CP_LARGE ? 64 : 32; }

__host__ __device__ inline long long cp_tiles(long long n, long long lanes) {
  const long long tile = (long long)CP_THREADS * cp_items(n);
  return (lanes + tile - 1) / tile;
}

__device__ inline unsigned long long cp_word(unsigned long long epoch, unsigned flag,
                                             long long count) {
  return epoch << (CP_COUNT_BITS + 2) | (unsigned long long)flag << CP_COUNT_BITS |
         (unsigned long long)count;
}

// The 4 lanes of a flag word as bits 0-3 (byte k not 0 -> bit k).
__device__ inline unsigned byte_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// 16 flag bytes from i0 as a 16-bit mask (lanes at or past nl: 0), as one
// 16-B vector where aligned and whole.
__device__ inline unsigned mask16(const uint8_t* __restrict__ f, long long i0, long long nl,
                                  bool aligned) {
  unsigned m = 0;
  if (aligned && i0 + 16 <= nl) {
    const uint4 x = *(const uint4*)(f + i0);
    m = byte_bits(x.x) | byte_bits(x.y) << 4 | byte_bits(x.z) << 8 | byte_bits(x.w) << 12;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i0 + k < nl && f[i0 + k]) m |= 1u << k;
  }
  return m;
}

template <int SRC, int ITEMS>
__global__ void __launch_bounds__(CP_THREADS)
    compact_pass(const void* __restrict__ src, long long n, Vals vs, long long cap,
                 const int64_t* cnt, long long sub, long long mul, long long iota_base,
                 const int64_t* out_off, const int64_t* add_2, unsigned long long* scr) {
  // the tile's kept lanes in lane order (first, for fingerprints, their live flags)
  __shared__ __align__(16) unsigned short s_lane[CP_THREADS * ITEMS];
  __shared__ int s_warp[CP_WARPS];
  __shared__ long long s_tile, s_excl;
  __shared__ unsigned long long s_epoch;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_tile = (long long)atomicAdd(scr, 1ull);
    s_epoch = *(volatile unsigned long long*)(scr + 1);
  }
  __syncthreads();
  const long long nl = live_count(cnt, sub, mul, n);
  const long long tile = s_tile;
  const long long base = tile * (CP_THREADS * ITEMS);
  if (base >= nl) return;  // uniform
  const unsigned long long epoch = s_epoch;
  unsigned long long* status = scr + CP_CTL;
  const int l0 = t * ITEMS;
  const uint8_t* flags = (const uint8_t*)src + base;
  long long nf = nl - base;
  bool aligned = ((uintptr_t)src & 15) == 0;
  if (SRC == FLAG_LIVE_FP) {  // fingerprints read coalesced into flag bytes first
    uint8_t* sf = (uint8_t*)s_lane;
    const long long* fv = (const long long*)src + base;
#pragma unroll 16
    for (int k = 0; k < ITEMS; ++k) {
      const int i = k * CP_THREADS + t;
      sf[i] = i < nf && __ldg(fv + i) != -1ll;
    }
    __syncthreads();
    flags = sf;
    nf = CP_THREADS * ITEMS;
    aligned = true;
  }
  unsigned long long m = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; k += 16)
    m |= (unsigned long long)mask16(flags, l0 + k, nf, aligned) << k;
  // ranks: this thread's count, the warp's earlier threads' by ballots (the
  // barrier below also ends the reads of the fingerprints' flag bytes)
  const int c = __popcll(m);
  const unsigned below = (1u << lane) - 1u;
  int ex = 0, wsum = 0;
#pragma unroll
  for (int b = 0; b < 7; ++b) {  // c <= 64
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, (c >> b) & 1);
    ex += __popc(bal & below) << b;
    wsum += __popc(bal) << b;
  }
  if (lane == 0) s_warp[warp] = wsum;
  __syncthreads();
  int before = 0, tile_n = 0;
#pragma unroll
  for (int w = 0; w < CP_WARPS; ++w) {
    before += w < warp ? s_warp[w] : 0;
    tile_n += s_warp[w];
  }
  if (warp == 0) {  // publish the count, look back, publish the inclusive prefix
    long long excl = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, cp_word(epoch, CP_INC, tile_n));
    } else {
      if (lane == 0) atomicExch(status + tile, cp_word(epoch, CP_AGG, tile_n));
      for (long long j = tile - 1 - lane;; j -= 32) {
        unsigned long long v;
        unsigned fl;
        do {
          v = j >= 0 ? *(volatile const unsigned long long*)(status + j)
                     : cp_word(epoch, CP_INC, 0);
          fl = (v >> (CP_COUNT_BITS + 2)) == epoch ? (unsigned)(v >> CP_COUNT_BITS) & 3u : 0u;
        } while (!__all_sync(0xFFFFFFFFu, fl != 0));
        const unsigned inc = __ballot_sync(0xFFFFFFFFu, fl == CP_INC);
        const int stop = inc ? __ffs(inc) - 1 : 31;  // the nearest inclusive prefix
        long long add = lane <= stop ? (long long)(v & CP_COUNT) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xFFFFFFFFu, add, o);
        excl += add;
        if (inc) break;
      }
      if (lane == 0) atomicExch(status + tile, cp_word(epoch, CP_INC, excl + tile_n));
    }
    if (lane == 0) s_excl = excl;
  }
  // the kept lanes' tile offsets at their ranks in the tile
  int r = before + ex;
  for (unsigned long long b = m; b; b &= b - 1) s_lane[r++] = (unsigned short)(l0 + __ffsll(b) - 1);
  __syncthreads();
  const long long excl = s_excl;
  const long long off = out_off ? *out_off : 0;
  const long long add = add_2 ? *add_2 : 0;
  const long long n_out = cap - excl < tile_n ? cap - excl : tile_n;  // ranks below cap
  // CP_WRITE kept lanes a thread at once: their values' loads in flight
  // before the stores
  for (int q0 = t; q0 < n_out; q0 += CP_WRITE * CP_THREADS) {
    long long x[3][CP_WRITE];
#pragma unroll
    for (int u = 0; u < CP_WRITE; ++u) {
      const int q = q0 + u * CP_THREADS;
      if (q < n_out) {
        const long long i = base + s_lane[q];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          if (vs.o[a]) x[a][u] = vs.v[a] ? __ldg(vs.v[a] + i) : iota_base + i;
      }
    }
#pragma unroll
    for (int u = 0; u < CP_WRITE; ++u) {
      const int q = q0 + u * CP_THREADS;
      if (q < n_out) {
        const long long o = off + excl + q;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          if (vs.o[a]) vs.o[a][o] = x[a][u] + (a == 2 ? add : 0);
      }
    }
  }
}

__global__ void compact_pad(long long n, long long cap, Vals vs, bool* __restrict__ lane,
                            const int64_t* cnt, long long sub, long long mul,
                            const int64_t* out_off, int64_t* __restrict__ total,
                            int64_t* __restrict__ ovf, unsigned long long* scr) {
  const long long nt = cp_tiles(n, live_count(cnt, sub, mul, n));
  const long long tot = nt ? (long long)(scr[CP_CTL + nt - 1] & CP_COUNT) : 0;
  const long long off = out_off ? *out_off : 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (long long)gridDim.x * blockDim.x) {
    const bool kept = i < tot;
    if (!kept)
      for (int j = 0; j < 3; ++j)
        if (vs.o[j]) vs.o[j][off + i] = vs.pad[j];
    if (lane) lane[i] = kept;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *total = tot;
    if (ovf && tot > cap) *ovf = 1;
    scr[0] = 0;
    scr[1] = (scr[1] + 1) & (CP_EPOCHS - 1);
  }
}

// The scratch words a compaction of n lanes takes: a status word for each
// 8,192 lanes, the smaller tile, so the count grows with n and a scratch
// sized for n serves every compaction of fewer lanes (from CP_LARGE lanes
// half the words go unused).
static inline long long compact_scratch_words(long long n) {
  constexpr long long small_tile = (long long)CP_THREADS * 32;
  return CP_CTL + (n + small_tile - 1) / small_tile;
}

// The compaction of n lanes (only the first live_count(cnt, sub, mul, n)
// count): the flagged lanes' values to (vs.o)[*out_off + rank] for rank <
// cap, pads past the total, lane[i] = i < total (lane may be null), *total,
// *ovf = 1 when total > cap (ovf may be null).  Two launches.
static int run_compact(const void* src, int src_kind, long long n, Vals vs, long long cap,
                       bool* lane, int64_t* scratch, int64_t* total, const int64_t* cnt,
                       long long sub, long long mul, long long iota_base, const int64_t* out_off,
                       const int64_t* add_2, int64_t* ovf, cudaStream_t st) {
  unsigned long long* scr = (unsigned long long*)scratch;
  const long long nt = cp_tiles(n, n);
  if (nt > 0) {
    const bool large = cp_items(n) == 64;
    auto fn = src_kind == FLAG_LIVE_FP ? (large ? compact_pass<FLAG_LIVE_FP, 64>
                                                : compact_pass<FLAG_LIVE_FP, 32>)
                                       : (large ? compact_pass<FLAG_BYTES, 64>
                                                : compact_pass<FLAG_BYTES, 32>);
    fn<<<(unsigned)nt, CP_THREADS, 0, st>>>(src, n, vs, cap, cnt, sub, mul, iota_base, out_off,
                                            add_2, scr);
  }
  const long long pb = (cap + THREADS - 1) / THREADS;
  compact_pad<<<(unsigned)(pb < 1 ? 1 : pb > 8192 ? 8192 : pb), THREADS, 0, st>>>(
      n, cap, vs, lane, cnt, sub, mul, out_off, total, ovf, scr);
  return (int)cudaGetLastError();
}

#define COMPACT_KERNELS                                                                   \
  (const void*)compact_pass<FLAG_BYTES, 32>, (const void*)compact_pass<FLAG_BYTES, 64>,   \
      (const void*)compact_pass<FLAG_LIVE_FP, 32>, (const void*)compact_pass<FLAG_LIVE_FP, 64>, \
      (const void*)compact_pad
