// B13 sieve probe: a blocked-bloom membership test per fingerprint lane.
//
// Replaces the XLA program of tla_raft_tpu/ops/sieve.py probe_impl (:194)
// with its hash pipeline _word_and_mask / _mix / _SALT (:68-95), as the
// fused level runs it over its fresh lanes (megakernel.py:257-261).
//
// h1 = mix(fp) picks the block word (h1 & (M - 1)), h2 = mix(fp ^ SALT)
// gives K_BITS = 4 bit positions from disjoint 6-bit fields; the lane hits
// when every bit is set in its word.  A hit of a live lane (fp != SENT)
// adds one to *count; with hit non-null each lane's answer is written too.
// While nothing is spilled the sieve is the 1-word all-zero sentinel, and
// every lane misses.
//
// Design.  The work is bounded by the device live count cnt (the fused
// level passes its n_new): lanes past it are neither read nor counted, and
// their hit flags are 0, so a superstep level far smaller than its buffer
// reads only its own lanes.  One wave of resident blocks walks the lanes
// grid-stride (1,056 blocks, two waves at 5 an SM, were up to 9 % slower:
// PERF.md).  A thread takes 4 consecutive lanes with two 16-B loads (a
// scalar head lane where the view is not 16-B aligned, and a scalar tail),
// issues its 4 word gathers before it tests any, and writes its hit flags
// as one 4-B store where aligned.  With the 1-word sentinel (a build of its
// own) the word is one broadcast load and h1 is not computed.  Hits are
// counted by warp ballots, summed over the block in shared memory, and
// added with one atomicAdd a block: an integer sum, the same in any order.
//
// Bound: bytes.  8 B read a lane below the live count (1 B written with
// hit), plus one word for each distinct word the live lanes gather; two
// 64-bit mixes a lane.
#include "stage.cuh"

typedef unsigned long long u64;

constexpr int SV_THREADS = 256;
constexpr int SV_LANES = 4;  // consecutive lanes a thread
constexpr u64 SV_SENT = ~0ull;

__device__ inline u64 sieve_mix(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D9ECA592EAF335ull;
  return x ^ (x >> 31);
}

__device__ inline u64 sieve_mask(u64 fp) {
  const u64 h2 = sieve_mix(fp ^ 0x9E3779B97F4A7C15ull);
  u64 mask = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) mask |= 1ull << ((h2 >> (6 * b)) & 63);
  return mask;
}

// The lane's word: the sentinel's one word, or a gather.
template <bool ONE>
__device__ inline u64 word_of(const u64* __restrict__ words, u64 m, u64 fp, u64 w0) {
  return ONE ? w0 : __ldg(words + (sieve_mix(fp) & (m - 1)));
}

template <bool ONE>
__global__ void __launch_bounds__(SV_THREADS)
    sieve_probe(const u64* __restrict__ words, long long m, const u64* __restrict__ fps,
                long long n, bool* hit, unsigned long long* count, const int64_t* cnt) {
  __shared__ u64 s_warp[SV_THREADS / 32];
  const long long live = live_count(cnt, 0, 1, n);
  const long long end = hit ? n : live;  // lanes past live only get their 0 flag
  const long long head = ((uintptr_t)fps & 15) && end > 0 ? 1 : 0;
  const long long groups = (end - head) / SV_LANES;
  const long long tail0 = head + groups * SV_LANES;  // scalar lanes from here to end
  const u64 w0 = ONE ? __ldg(words) : 0;
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * SV_THREADS + threadIdx.x;
  const long long nth = (long long)gridDim.x * SV_THREADS;
  u64 c = 0;  // the warp's hits, in lane 0
  // warp-uniform trips (tid - lane is the warp's first thread)
  for (long long g0 = tid - lane; g0 < groups; g0 += nth) {
    const long long g = g0 + lane;
    const long long i0 = head + g * SV_LANES;
    u64 fp[SV_LANES];
    if (g < groups && i0 + SV_LANES <= live) {
      const ulonglong2* v = reinterpret_cast<const ulonglong2*>(fps + i0);
      const ulonglong2 a = __ldg(v), b = __ldg(v + 1);
      fp[0] = a.x, fp[1] = a.y, fp[2] = b.x, fp[3] = b.y;
    } else {
#pragma unroll
      for (int k = 0; k < SV_LANES; ++k)
        fp[k] = g < groups && i0 + k < live ? __ldg(fps + i0 + k) : SV_SENT;
    }
    u64 w[SV_LANES];
#pragma unroll
    for (int k = 0; k < SV_LANES; ++k)
      w[k] = g < groups && i0 + k < live ? word_of<ONE>(words, (u64)m, fp[k], w0) : 0;
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < SV_LANES; ++k) {
      const u64 mask = sieve_mask(fp[k]);
      const bool h = g < groups && i0 + k < live && (w[k] & mask) == mask;
      bits |= (unsigned)h << (8 * k);
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, h && fp[k] != SV_SENT);
      if (lane == 0) c += __popc(bal);
    }
    if (hit && g < groups) {
      if (((uintptr_t)(hit + i0) & 3) == 0) {
        *reinterpret_cast<unsigned*>(hit + i0) = bits;
      } else {
#pragma unroll
        for (int k = 0; k < SV_LANES; ++k) hit[i0 + k] = (bits >> (8 * k)) & 1;
      }
    }
  }
  // the scalar lanes: the head (lane 0) and the tail, in the first warp
  if (tid < 32) {
    const long long i = tid == SV_LANES ? 0 : tail0 + tid;
    const bool mine = tid == SV_LANES ? head == 1 : tid < SV_LANES && i < end;
    bool h = false;
    u64 fp = SV_SENT;
    if (mine && i < live) {
      fp = __ldg(fps + i);
      const u64 mask = sieve_mask(fp);
      h = (word_of<ONE>(words, (u64)m, fp, w0) & mask) == mask;
    }
    if (mine && hit) hit[i] = h;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, h && fp != SV_SENT);
    if (lane == 0) c += __popc(bal);
  }
  if (!count) return;
  if (lane == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 s = 0;
#pragma unroll
    for (int k = 0; k < SV_THREADS / 32; ++k) s += s_warp[k];
    if (s) atomicAdd(count, s);
  }
}

// words u64[m], m a power of two; hit and count may be null; cnt (may be
// null) bounds the live lanes.  One launch.
EXPORT int sieve_probe_launch(const int64_t* words, long long m, const int64_t* fps, long long n,
                              bool* hit, int64_t* count, const int64_t* cnt, void* stream) {
  if (m < 1 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    auto fn = m == 1 ? sieve_probe<true> : sieve_probe<false>;
    constexpr long long span = (long long)SV_THREADS * SV_LANES;
    const unsigned grid = resident_blocks((const void*)fn, SV_THREADS, 0, (n + span - 1) / span);
    fn<<<grid, SV_THREADS, 0, (cudaStream_t)stream>>>((const u64*)words, m, (const u64*)fps, n,
                                                      hit, (unsigned long long*)count, cnt);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)sieve_probe<true>, (const void*)sieve_probe<false>)
