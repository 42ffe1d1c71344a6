// B13 sieve probe: a blocked-bloom membership test per fingerprint lane.
//
// Replaces the XLA program of tla_raft_tpu/ops/sieve.py probe_impl (:194)
// with its hash pipeline _word_and_mask / _mix / _SALT (:68-95), as the
// fused level runs it over its fresh lanes (megakernel.py:257-261).
//
// Design: one thread per lane.  h1 = mix(fp) picks the block word
// (h1 & (M - 1)), h2 = mix(fp ^ SALT) gives K_BITS = 4 bit positions from
// disjoint 6-bit fields; the lane hits when every bit is set in its word.
// A hit of a live lane (fp != SENT) adds one to *count; with hit non-null
// each lane's answer is written too.  While nothing is spilled the sieve
// is the 1-word all-zero sentinel, and every lane misses.
//
// Bound: bytes.  8 B read and at most 1 B written a lane, plus one word
// gather; two 64-bit mixes a lane.
#include "common.cuh"

typedef unsigned long long u64;

__device__ inline u64 sieve_mix(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D9ECA592EAF335ull;
  return x ^ (x >> 31);
}

__global__ void sieve_probe(const u64* words, long long m, const u64* fps, long long n,
                            bool* hit, unsigned long long* count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const u64 fp = fps[i];
    const u64 h1 = sieve_mix(fp);
    const u64 h2 = sieve_mix(fp ^ 0x9E3779B97F4A7C15ull);
    u64 mask = 0;
    for (int b = 0; b < 4; ++b) mask |= 1ull << ((h2 >> (6 * b)) & 63);
    const bool h = (words[h1 & (u64)(m - 1)] & mask) == mask;
    if (hit) hit[i] = h;
    if (count && h && fp != ~0ull) atomicAdd(count, 1ull);
  }
}

// words u64[m], m a power of two; hit and count may be null.
EXPORT int sieve_probe_launch(const int64_t* words, long long m, const int64_t* fps, long long n,
                              bool* hit, int64_t* count, void* stream) {
  if (m < 1 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  const long long b = (n + 255) / 256;
  if (n > 0)
    sieve_probe<<<(unsigned)(b > 4096 ? 4096 : b), 256, 0, (cudaStream_t)stream>>>(
        (const u64*)words, m, (const u64*)fps, n, hit, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

WARM((const void*)sieve_probe)
