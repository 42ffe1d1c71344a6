// The sharded deep sweep's own kernels (B15's deep bodies, and the packed
// fingerprint stream).
//
// Replaces
//   pack_fp_deltas (tla_raft_tpu/parallel/exchange.py:38)  the delta/varint
//       packing of an owner's ascending unique fingerprints: delta_i = fp_i -
//       fp_{i-1} (fp_{-1} = 0) in 1-8 little-endian bytes, a 4-bit length
//       nibble an entry (entry 2k in the low nibble of byte k), int64
//       offsets; a cumsum and a masked scatter-add there: pack_deltas here;
//   _deep_verdict_body (tla_raft_tpu/parallel/sharded.py:1159)  the owner's
//       is-new bits (one per unique fingerprint, LSB first) back on its
//       received lanes; it re-runs the finalize lexsort and an argsort to
//       find them: deep_verdict here reads the winners' receive indices the
//       finalize kept (its group_unique payloads), so nothing is sorted;
//   _deep_repack_body (sharded.py:1283)  the rounds' shipped children,
//       round-major, compacted into the next level's segments with their
//       gpidx and slots (an argsort of the live flags and a gather a field
//       there): deep_repack here copies every block of rows (a range of one
//       source's rows: the children one origin shipped to the owner in one
//       round) to its offset, the offsets the exclusive scan of the blocks'
//       row counts, every field of every block in one launch.
//
// Design.
//   pack_deltas   the tile scan of scan.cuh over byte lengths instead of
//                 flags: pd_tiles sums each tile's lengths (a block of 256
//                 threads, 8 adjacent lanes a thread), scan_offsets turns
//                 the tile sums into int64 offsets and the total, and
//                 pd_write recomputes its lanes' lengths, ranks its thread
//                 by a block scan, writes each lane's bytes into the tile's
//                 shared-memory image (at most 8 B a lane) and each lane
//                 pair's nibble byte, then the block writes the image to the
//                 stream at the tile's offset, adjacent threads on adjacent
//                 bytes.  Lanes own disjoint bytes: no atomics, and the
//                 stream past the total stays the memset's zeros.
//                 Bound: bytes (8 B read a lane; 1-8 B and half a nibble
//                 byte written a lane); the lengths are computed twice
//                 rather than stored between the passes.
//   deep_verdict  one thread a unique fingerprint: win[gp[i]] = bit i, on a
//                 memset of win.  Bound: bytes (8 B of gp and an eighth of a
//                 bit byte read, 1 B written a unique; the memset writes 1 B
//                 a received lane).  The writes scatter: a unique's lane is
//                 anywhere in the owner's receive order.
//   deep_repack   scan_offsets over the blocks' row counts (in place), then
//                 rp_copy: each (block, field) pair's bytes cut into chunks of
//                 RP_CHUNK bytes, one CUDA block a chunk (it finds its pair
//                 by a binary search of the pairs' first chunks); each thread
//                 loads its 32 bytes of the chunk (strided by the block, so
//                 every warp step reads 32 adjacent bytes) into registers
//                 before it stores any, keeping 32 loads in flight (rows are
//                 1-9 B of a field wide and start anywhere: no wider copy is
//                 aligned on both sides).  The grid is the chunks' count, not
//                 the widest pair's chunks times the pairs.  Bound: bytes
//                 (each row read and written once).
#include "scan.cuh"

namespace {

typedef unsigned long long u64;

__device__ inline int delta_len(u64 d) {
  int nb = 1;
#pragma unroll
  for (int k = 1; k < 8; ++k) nb += d >= (1ull << (8 * k)) ? 1 : 0;
  return nb;
}

// The byte lengths of this thread's ITEMS lanes (0 past n).
__device__ inline int lane_lengths(const u64* __restrict__ fps, long long n, long long base,
                                   int* nb, u64* delta) {
  int sum = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    nb[k] = 0;
    delta[k] = 0;
    if (i < n) {
      const u64 prev = i > 0 ? fps[i - 1] : 0ull;
      delta[k] = fps[i] - prev;
      nb[k] = delta_len(delta[k]);
    }
    sum += nb[k];
  }
  return sum;
}

// The live lanes: min(cap, *n_dev), or n_host when n_dev is null.
__device__ inline long long pack_count(const int64_t* n_dev, long long n_host, long long cap) {
  return n_dev ? live_count(n_dev, 0, 1, cap) : (n_host < cap ? n_host : cap);
}

__global__ void pd_tiles(const u64* __restrict__ fps, long long cap, const int64_t* n_dev,
                         long long n_host, long long* __restrict__ tile_sum) {
  const long long n = pack_count(n_dev, n_host, cap);
  int nb[ITEMS];
  u64 delta[ITEMS];
  const int s = lane_lengths(fps, n, thread_base(), nb, delta);
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

__global__ void pd_write(const u64* __restrict__ fps, long long cap, const int64_t* n_dev,
                         long long n_host, const long long* __restrict__ tile_off,
                         uint8_t* __restrict__ stream, uint8_t* __restrict__ nibbles) {
  const long long n = pack_count(n_dev, n_host, cap);
  const long long base = thread_base();
  int nb[ITEMS];
  u64 delta[ITEMS];
  __shared__ uint8_t s_bytes[TILE * 8];
  const int s = lane_lengths(fps, n, base, nb, delta);
  int total;
  int off = block_exclusive_scan(s, &total);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    for (int b = 0; b < nb[k]; ++b) s_bytes[off + b] = (uint8_t)(delta[k] >> (8 * b));
    off += nb[k];
  }
  __syncthreads();
  uint8_t* out = stream + tile_off[blockIdx.x];
  for (int i = threadIdx.x; i < total; i += THREADS) out[i] = s_bytes[i];
#pragma unroll
  for (int k = 0; k < ITEMS; k += 2) {
    const long long i = base + k;  // even: base is a multiple of ITEMS
    if (i < cap) nibbles[i >> 1] = (uint8_t)(nb[k] | (nb[k + 1] << 4));
  }
}

__global__ void dv_scatter(const uint8_t* __restrict__ bits, long long n_bits_bytes,
                           const int64_t* __restrict__ gp, long long cap_u, const int64_t* n_dev,
                           long long n_recv, bool* __restrict__ win) {
  const long long n = live_count(n_dev, 0, 1, cap_u);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long byte = i >> 3;
    const bool bit = byte < n_bits_bytes && ((bits[byte] >> (i & 7)) & 1);
    const long long lane = gp[i];
    if (lane >= 0 && lane < n_recv) win[lane] = bit;
  }
}

constexpr int RP_THREADS = 256;
constexpr int RP_PER = 32;                                // bytes a thread copies
constexpr long long RP_CHUNK = RP_THREADS * RP_PER;       // bytes a CUDA block copies

// Block b is rows [row[b], row[b] + counts[b]) of source src[b]; srcs[s *
// F + f]: source s's field f; widths[f]: bytes a row of field f; offs[b]:
// block b's first output row (the scanned counts); dsts[f]: the output of
// field f; chunk0[p], p = b * F + f: pair p's first chunk (the exclusive
// scan of ceil(bytes / RP_CHUNK), chunk0[P] = the chunks' count).
__global__ void rp_copy(const long long* __restrict__ srcs, const long long* __restrict__ src,
                        const long long* __restrict__ row, const long long* __restrict__ counts,
                        const long long* __restrict__ offs, const long long* __restrict__ widths,
                        const long long* __restrict__ dsts, int F,
                        const long long* __restrict__ chunk0, int P) {
  __shared__ int s_pair;
  const long long c = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = P - 1;  // the last pair whose first chunk is <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (chunk0[mid] <= c) lo = mid;
      else hi = mid - 1;
    }
    s_pair = lo;
  }
  __syncthreads();
  const int p = s_pair, b = p / F, f = p % F;
  const long long w = widths[f];
  const long long nbytes = counts[b] * w;
  const long long start = (c - chunk0[p]) * RP_CHUNK;
  const long long end = start + RP_CHUNK < nbytes ? start + RP_CHUNK : nbytes;
  const uint8_t* in = (const uint8_t*)srcs[src[b] * F + f] + row[b] * w;
  uint8_t* dst = (uint8_t*)dsts[f] + offs[b] * w;
  uint8_t v[RP_PER];
#pragma unroll
  for (int k = 0; k < RP_PER; ++k) {
    const long long i = start + k * RP_THREADS + threadIdx.x;
    v[k] = i < end ? in[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < RP_PER; ++k) {
    const long long i = start + k * RP_THREADS + threadIdx.x;
    if (i < end) dst[i] = v[k];
  }
}

}  // namespace

// fps u64[cap] ascending in its first n lanes (n = min(cap, *n_dev), or
// n_host when n_dev is null); stream u8[cap * 8], nibbles u8[(cap + 1) / 2];
// total i64 0-d (the stream's live bytes).  Scratch: tile i64[ceil(cap /
// TILE)].
EXPORT int launch_pack_deltas(const int64_t* fps, long long cap, const int64_t* n_dev,
                              long long n_host, uint8_t* stream, uint8_t* nibbles,
                              int64_t* total, int64_t* tile, void* stream_) {
  cudaStream_t st = (cudaStream_t)stream_;
  cudaMemsetAsync(stream, 0, (size_t)cap * 8, st);
  const long long n_tiles = n_tiles_of(cap);
  if (n_tiles > 0)
    pd_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>((const u64*)fps, cap, n_dev, n_host,
                                                    (long long*)tile);
  scan_offsets<<<1, THREADS, 0, st>>>((long long*)tile, n_tiles, (long long*)total);
  if (n_tiles > 0)
    pd_write<<<(unsigned)n_tiles, THREADS, 0, st>>>((const u64*)fps, cap, n_dev, n_host,
                                                    (const long long*)tile, stream, nibbles);
  return (int)cudaGetLastError();
}

// bits u8[n_bits_bytes] (bit i = unique i's verdict, LSB first); gp
// i64[cap_u] (unique i's receive lane), n = min(cap_u, *n_dev) (or cap_u);
// win bool[n_recv] = bit i at gp[i] for i < n, 0 elsewhere.
EXPORT int launch_deep_verdict(const uint8_t* bits, long long n_bits_bytes, const int64_t* gp,
                               long long cap_u, const int64_t* n_dev, long long n_recv, bool* win,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_recv > 0) cudaMemsetAsync(win, 0, (size_t)n_recv, st);
  if (cap_u > 0) {
    const long long b = (cap_u + 255) / 256;
    dv_scatter<<<(unsigned)(b > 65535 ? 65535 : b), 256, 0, st>>>(bits, n_bits_bytes, gp, cap_u,
                                                                  n_dev, n_recv, win);
  }
  return (int)cudaGetLastError();
}

EXPORT long long rp_chunk() { return RP_CHUNK; }

// S sources and B blocks of F fields, in one i64 table: srcs [S * F]
// (device pointers), src [B], row [B] and counts [B] (each block's source,
// first row and rows), widths [F] (bytes a row), dsts [F], chunk0 [B * F +
// 1] (each pair's first chunk of RP_CHUNK bytes, and the chunks' count
// n_chunks).  offs i64[B] (scratch: the exclusive scan of counts); *n_out =
// the rows written.
EXPORT int launch_deep_repack(const int64_t* table, int64_t* offs, int64_t* n_out, int S, int B,
                              int F, long long n_chunks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || B <= 0 || F <= 0 || n_chunks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const long long* srcs = (const long long*)table;
  const long long* src = srcs + (long long)S * F;
  const long long* row = src + B;
  const long long* counts = row + B;
  const long long* widths = counts + B;
  const long long* dsts = widths + F;
  const long long* chunk0 = dsts + F;
  cudaMemcpyAsync(offs, counts, sizeof(int64_t) * B, cudaMemcpyDeviceToDevice, st);
  scan_offsets<<<1, THREADS, 0, st>>>((long long*)offs, B, (long long*)n_out);
  if (n_chunks > 0)
    rp_copy<<<(unsigned)n_chunks, RP_THREADS, 0, st>>>(srcs, src, row, counts,
                                                      (const long long*)offs, widths, dsts, F,
                                                      chunk0, B * F);
  return (int)cudaGetLastError();
}

WARM((const void*)pd_tiles, (const void*)pd_write, (const void*)scan_offsets,
     (const void*)dv_scatter, (const void*)rp_copy)
