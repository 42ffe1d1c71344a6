// Shared-memory staging of row-major field spans, used by the kernels that
// copy a tile of states into shared memory before they read it (K3's S <= 3
// and pair-digit forms in fingerprint.cu, the invariant scan in
// invariants.cu): cp.async of 16-byte vectors where a span is 16-B aligned,
// byte loads where it is not, and the persistent grid such kernels launch.
#pragma once

#include "common.cuh"

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

// 16 bytes global -> shared without a register round trip (zeros when
// src_bytes is 0), and the group waits.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The spans a block stages (stage_rows): the core
// fields, then (with the id lists) the ids; each its source, its
// destination's offset in a staging buffer and its bytes a row.
struct Segs {
  const uint8_t* src[N_FIELDS + 1];
  int dst[N_FIELDS + 1];
  int rb[N_FIELDS + 1];
  int n;
};

// The rows [base, base + nrows) of a block (row r is state base + r, or
// idx[base + r] in the indexed mode) of every segment copied to the staging
// buffer buf, a warp a segment (segments w, w + NW, ...): outside the
// indexed mode a segment's rows are one contiguous span, its 16-B vectors
// spread over the warp's lanes where its start is 16-B aligned, the rest
// bytewise; in it, each row's vectors where a row is a whole number of
// them.  ASYNC: the vectors go by cp.async (the caller commits and waits),
// else through registers, four loads in flight a lane.  buf and the
// destinations are 16-B aligned; no barrier inside.
template <int NT, bool ASYNC>
__device__ inline void stage_rows(uint8_t* buf, const Segs* sg, long long base, int nrows,
                                  const int64_t* idx) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < sg->n; s += NW) {
    const int rb = sg->rb[s], nb = nrows * rb;
    uint8_t* dst = buf + sg->dst[s];
    const uint8_t* src = sg->src[s];
    const bool rows16 = rb % 16 == 0 && ((uintptr_t)src & 15) == 0;
    int nv = 0;  // the vectors
    if (!idx) {
      src += base * rb;
      nv = ((uintptr_t)src & 15) == 0 ? nb / 16 : 0;
    } else if (rows16) {
      nv = nb / 16;
    }
    const int vr = rb / 16;
    for (int v0 = lane; v0 < nv; v0 += 4 * 32) {
      uint4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * 32;
        if (v < nv) {
          const uint4* from;
          if (idx) {
            const int r = v / vr;
            from = (const uint4*)(src + idx[base + r] * rb) + (v - r * vr);
          } else {
            from = (const uint4*)src + v;
          }
          if (ASYNC) cp_async16(dst + 16 * v, from, 16);
          else x[u] = __ldg(from);
        }
      }
      if (!ASYNC)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (v0 + u * 32 < nv) ((uint4*)dst)[v0 + u * 32] = x[u];
    }
    const int done = idx ? (nv ? nb : 0) : nv * 16;  // the bytes past the vectors
    for (int i = done + lane; i < nb; i += 32) {
      if (idx) {
        const int r = i / rb;
        dst[i] = sg->src[s][idx[base + r] * rb + (i - r * rb)];
      } else {
        dst[i] = src[i];
      }
    }
  }
}

// A persistent grid: as many blocks of ``fn`` as stay resident on the card
// (at ``threads`` a block and ``smem`` dynamic bytes), at most ``tiles``.
static inline unsigned resident_blocks(const void* fn, int threads, size_t smem,
                                       long long tiles) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, threads, smem);
  const long long b = (long long)sms * (per > 0 ? per : 1);
  return (unsigned)(tiles < b ? (tiles > 0 ? tiles : 1) : b);
}
