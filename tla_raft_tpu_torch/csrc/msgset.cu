// Message sets between their two forms: the sparse, ascending, -1-padded
// id list a frontier stores (int16 ids while M < 2^15, int32 past it, as
// the reference's id_dtype, engine/bfs.py:547), and the packed 32-bit
// bitmask the guards read.
//
// Replaces the XLA programs of tla_raft_tpu/engine/bfs.py _ids_to_msgs
// (inflate: a one-hot compare of every id against every word, summed) and
// _msgs_to_ids (deflate: top_k over the M-wide bit-position keys, plus the
// per-row cap_m overflow flag), which _inflate / _deflate wrap.
//
// Design: one warp per state for both.
//   inflate  the warp zeroes the row's words in shared memory, each lane
//            ORs the bits of its ids in (shared atomics: OR is order-free),
//            and the warp writes the row out;
//   deflate  the warp reads 32 words at a time, a warp scan of their
//            popcounts gives each lane the rank of its first set bit, and
//            each lane writes its bits' ids at their ranks while the rank
//            is below cap_m; the rest of the row is -1, and the row
//            overflows when it holds more than cap_m ids.
// Both keep ascending order by construction: ids are written at their
// rank among the set bits.  On the fused, superstep and grouped levels K1
// builds its masks from the id lists itself (csrc/guards.cu), so inflate
// runs for the staged chain, the dense expand (canon="expand",
// use_mxu=False), the bucket, the mesh and trace rebuilding.
//
// Bound: bytes.  Inflate reads 2 * cap_m B (4 * cap_m with int32 ids) and
// writes 4 * n_words B a row; deflate reads 4 * n_words B and writes
// 2 * cap_m + 1 B (4 * cap_m + 1).  The
// integer work is a few operations per id or word.
#include "common.cuh"

constexpr int WARPS = 8;  // states per block

template <typename Id>
__global__ void inflate_kernel(const Id* __restrict__ ids, int cap_m, long long n,
                               int n_words, uint32_t* __restrict__ msgs, const int64_t* cnt,
                               long long sub) {
  extern __shared__ uint32_t sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= live_count(cnt, sub, 1, n)) return;
  uint32_t* w = sh + warp * n_words;
  for (int j = lane; j < n_words; j += 32) w[j] = 0u;
  __syncwarp();
  const Id* r = ids + row * cap_m;
  for (int j = lane; j < cap_m; j += 32) {
    const int id = r[j];
    if (id >= 0 && (id >> 5) < n_words) atomicOr(&w[id >> 5], 1u << (id & 31));
  }
  __syncwarp();
  uint32_t* out = msgs + row * n_words;
  for (int j = lane; j < n_words; j += 32) out[j] = w[j];
}

template <typename Id>
__global__ void deflate_kernel(const uint32_t* __restrict__ msgs, int n_words, int M, long long n,
                               int cap_m, Id* __restrict__ ids, bool* __restrict__ ovf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= n) return;
  const uint32_t* m = msgs + row * n_words;
  Id* out = ids + row * cap_m;
  int base = 0;
  for (int w0 = 0; w0 < n_words; w0 += 32) {
    const int w = w0 + lane;
    uint32_t word = 0u;
    if (w < n_words) {
      word = m[w];
      const int nbits = M - w * 32;  // bits of the word inside the universe
      if (nbits < 32) word &= nbits <= 0 ? 0u : ((1u << nbits) - 1u);
    }
    const int c = __popc(word);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
      if (lane >= o) inc += y;
    }
    int pos = base + inc - c;
    while (word) {
      const int b = __ffs(word) - 1;
      if (pos < cap_m) out[pos] = (Id)(w * 32 + b);
      ++pos;
      word &= word - 1u;
    }
    base += __shfl_sync(0xFFFFFFFFu, inc, 31);
  }
  for (int j = lane; j < cap_m; j += 32)
    if (j >= base) out[j] = -1;
  if (lane == 0) ovf[row] = base > cap_m;
}

static inline unsigned blocks_of(long long n) { return (unsigned)((n + WARPS - 1) / WARPS); }

// With cnt, rows at or past live_count(cnt, sub, 1, n) are dead (not written).
// id_bytes: 2 (int16 ids) or 4 (int32 ids).
EXPORT int launch_inflate(const void* ids, int id_bytes, int cap_m, long long n, int n_words,
                          int32_t* msgs, const int64_t* cnt, long long sub, void* stream) {
  if (id_bytes != 2 && id_bytes != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t sm = WARPS * n_words * sizeof(uint32_t);
    cudaStream_t st = (cudaStream_t)stream;
    if (id_bytes == 2)
      inflate_kernel<int16_t><<<blocks_of(n), WARPS * 32, sm, st>>>(
          (const int16_t*)ids, cap_m, n, n_words, (uint32_t*)msgs, cnt, sub);
    else
      inflate_kernel<int32_t><<<blocks_of(n), WARPS * 32, sm, st>>>(
          (const int32_t*)ids, cap_m, n, n_words, (uint32_t*)msgs, cnt, sub);
  }
  return (int)cudaGetLastError();
}

EXPORT int launch_deflate(const int32_t* msgs, int n_words, int M, long long n, int cap_m,
                          void* ids, int id_bytes, bool* ovf, void* stream) {
  if (id_bytes != 2 && id_bytes != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (id_bytes == 2)
      deflate_kernel<int16_t><<<blocks_of(n), WARPS * 32, 0, st>>>(
          (const uint32_t*)msgs, n_words, M, n, cap_m, (int16_t*)ids, ovf);
    else
      deflate_kernel<int32_t><<<blocks_of(n), WARPS * 32, 0, st>>>(
          (const uint32_t*)msgs, n_words, M, n, cap_m, (int32_t*)ids, ovf);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)inflate_kernel<int16_t>, (const void*)inflate_kernel<int32_t>,
     (const void*)deflate_kernel<int16_t>, (const void*)deflate_kernel<int32_t>)
