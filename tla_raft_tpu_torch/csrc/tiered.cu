// B16 drop_rows: a materialized frontier's kept rows packed to a prefix.
//
// Replaces the XLA program of tla_raft_tpu/store/tiered.py drop_rows_impl
// (:810): after the tiered store's level-tail probe finds fresh rows that
// are revisits of demoted generations, those rows leave the frontier.
// Kept rows keep their order (the payload order every route pins), and
// every row at or past the kept count is zero in every field, as the
// reference's stable argsort + where leaves it.
//
// Design: the tile scan of scan.cuh over the keep flags gives each kept
// row its destination (count, offsets, then a scatter of source row
// indices to their ranks); one gather kernel then copies, field by field,
// every output row from its source row, or writes zeros past the kept
// count, in the widest word (16, 8, 4, 2 or 1 B) that divides the field's
// row width and both addresses.  The destinations come from scans, never
// from atomics.
//
// Bound: bytes.  The function must read the keep flags (1 B a row) and
// the kept rows once, and write all `rows` output rows once.  The row
// index scratch (8 B a kept row, written and read) is this design's own
// and is not in the bound.
#include "scan.cuh"

struct Fields {
  const uint8_t* src[16];
  uint8_t* dst[16];
  long long width[16];  // bytes per row
  int unit[16];         // bytes per copied word
  int n;
};

__global__ void scatter_rows(const uint8_t* __restrict__ keep, long long n,
                             const long long* __restrict__ tile_off, long long* __restrict__ idx) {
  const long long base = thread_base();
  long long r = tile_rank(keep, n, tile_off);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < n && keep[i]) idx[r++] = i;
  }
}

// every output row of one field, `wu` words of T a row; I is the index
// type (32-bit where the field's words fit, so the row divide is cheap)
template <typename T, typename I>
__device__ void gather_field(const long long* __restrict__ idx, long long n_keep, I rows, I wu,
                             const T* __restrict__ src, T* __restrict__ dst) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I e = (I)blockIdx.x * blockDim.x + threadIdx.x; e < rows * wu; e += stride) {
    const I r = e / wu;
    dst[e] = (long long)r < n_keep ? src[(I)idx[r] * wu + (e - r * wu)] : T{};
  }
}

template <typename T>
__device__ void gather_unit(const long long* idx, long long n_keep, long long rows,
                            const uint8_t* src, uint8_t* dst, long long w) {
  const long long wu = w / (long long)sizeof(T);
  if (rows * wu < (1ll << 31))
    gather_field<T, unsigned>(idx, n_keep, (unsigned)rows, (unsigned)wu, (const T*)src, (T*)dst);
  else
    gather_field<T, long long>(idx, n_keep, rows, wu, (const T*)src, (T*)dst);
}

__global__ void gather_rows(const long long* __restrict__ idx, const long long* __restrict__ total,
                            long long rows, Fields f) {
  const long long n_keep = *total;
  for (int j = 0; j < f.n; ++j) {
    const long long w = f.width[j];
    switch (f.unit[j]) {
      case 16: gather_unit<uint4>(idx, n_keep, rows, f.src[j], f.dst[j], w); break;
      case 8: gather_unit<unsigned long long>(idx, n_keep, rows, f.src[j], f.dst[j], w); break;
      case 4: gather_unit<unsigned>(idx, n_keep, rows, f.src[j], f.dst[j], w); break;
      case 2: gather_unit<unsigned short>(idx, n_keep, rows, f.src[j], f.dst[j], w); break;
      default: gather_unit<uint8_t>(idx, n_keep, rows, f.src[j], f.dst[j], w); break;
    }
  }
}

static inline unsigned grid_of(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

EXPORT long long drop_rows_tile() { return TILE; }

// keep u8[rows]; src/dst: n_fields row-major buffers of `rows` rows, width
// = bytes per row; scratch tile i64[ceil(rows / TILE)], idx i64[rows];
// *total = the kept rows.
EXPORT int drop_rows_launch(const uint8_t* keep, long long rows, const void* const* src,
                            void* const* dst, const long long* width, int n_fields, int64_t* tile,
                            int64_t* idx, int64_t* total, void* stream) {
  if (n_fields > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Fields f;
  long long row_b = 0;
  for (int j = 0; j < n_fields; ++j) {
    f.src[j] = (const uint8_t*)src[j];
    f.dst[j] = (uint8_t*)dst[j];
    f.width[j] = width[j];
    const unsigned long long a = (unsigned long long)src[j] | (unsigned long long)dst[j];
    int u = 16;
    while (u > 1 && (width[j] % u || a % u)) u >>= 1;
    f.unit[j] = u;
    row_b += width[j];
  }
  f.n = n_fields;
  const long long n_tiles = n_tiles_of(rows);
  if (n_tiles > 0)
    count_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>(keep, rows, (long long*)tile, nullptr, 0,
                                                       1);
  scan_offsets<<<1, THREADS, 0, st>>>((long long*)tile, n_tiles, (long long*)total);
  if (n_tiles > 0)
    scatter_rows<<<(unsigned)n_tiles, THREADS, 0, st>>>(keep, rows, (const long long*)tile,
                                                        (long long*)idx);
  if (rows > 0)
    gather_rows<<<grid_of(rows * row_b), THREADS, 0, st>>>((const long long*)idx,
                                                           (const long long*)total, rows, f);
  return (int)cudaGetLastError();
}

WARM((const void*)count_tiles, (const void*)scan_offsets, (const void*)scatter_rows,
     (const void*)gather_rows)
