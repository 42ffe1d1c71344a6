// The order-keeping compaction's scatter and pad passes over the tile scan
// of scan.cuh: the flagged lanes' values (up to three arrays) packed to a
// prefix in lane order, the rest padded.  Shared by compact.cu (the
// chunk, fresh-lane, filter and fan-out compactions) and sortstore.cu (the
// level dedup's survivors).  Ranks come from the scan, never from atomics,
// so every launch gives the same output.
#pragma once

#include "scan.cuh"

// Up to three value arrays (v[0] null: the values are iota_base + lane),
// their outputs and pad values.
struct Vals {
  const long long* v[3];
  long long* o[3];
  long long pad[3];
};

__global__ void scatter_tiles(const uint8_t* __restrict__ flags, long long n,
                              const long long* __restrict__ tile_off, Vals vs, long long cap,
                              const int64_t* cnt, long long sub, long long mul,
                              long long iota_base, const int64_t* out_off, const int64_t* add_2) {
  n = live_count(cnt, sub, mul, n);
  const long long base = thread_base();
  long long r = tile_rank(flags, n, tile_off);
  const long long off = out_off ? *out_off : 0;
  const long long add = add_2 ? *add_2 : 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k;
    if (i < n && flags[i]) {
      if (r < cap) {
        vs.o[0][off + r] = vs.v[0] ? vs.v[0][i] : iota_base + i;
        if (vs.o[1]) vs.o[1][off + r] = vs.v[1][i];
        if (vs.o[2]) vs.o[2][off + r] = (vs.v[2] ? vs.v[2][i] : iota_base + i) + add;
      }
      ++r;
    }
  }
}

__global__ void pad_tail(const long long* __restrict__ total, long long cap, Vals vs,
                         bool* __restrict__ lane, const int64_t* out_off, int64_t* ovf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const bool kept = i < *total;
  if (!kept) {
    const long long off = out_off ? *out_off : 0;
    for (int j = 0; j < 3; ++j)
      if (vs.o[j]) vs.o[j][off + i] = vs.pad[j];
  }
  if (lane) lane[i] = kept;
  if (ovf && i == 0 && *total > cap) *ovf = 1;
}

static int run_compact(const uint8_t* flags, long long n, Vals vs, long long cap, bool* lane,
                       int64_t* tile, int64_t* total, const int64_t* cnt, long long sub,
                       long long mul, long long iota_base, const int64_t* out_off,
                       const int64_t* add_2, int64_t* ovf, cudaStream_t st) {
  const long long n_tiles = n_tiles_of(n);
  if (n_tiles > 0)
    count_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>(flags, n, (long long*)tile, cnt, sub,
                                                       mul);
  scan_offsets<<<1, THREADS, 0, st>>>((long long*)tile, n_tiles, (long long*)total);
  if (n_tiles > 0)
    scatter_tiles<<<(unsigned)n_tiles, THREADS, 0, st>>>(flags, n, (const long long*)tile, vs,
                                                         cap, cnt, sub, mul, iota_base, out_off,
                                                         add_2);
  if (cap > 0)
    pad_tail<<<blocks_of(cap, THREADS), THREADS, 0, st>>>((const long long*)total, cap, vs, lane,
                                                          out_off, ovf);
  return (int)cudaGetLastError();
}
