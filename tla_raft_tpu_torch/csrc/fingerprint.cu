// K3 state fingerprints: symmetry-folded (fp_view, fp_full) of each state.
//
// Replaces the XLA program of tla_raft_tpu/ops/fingerprint.py
// FeatureSpec.features + Fingerprinter.feat_hash / _plane_matmul (an i8
// [G, 73] x [73, 96] byte-plane matmul), Fingerprinter.msg_hash (the i8
// [G, 4824] x [4824, 96] message-set matmul) and finalize (the unsigned
// minimum over the P server permutations of the two 64-bit channel pairs).
//
// Design: one warp per state; the 16 * P plane columns (96 at S = 3) are
// spread over the lanes, each accumulating its columns in int32.  The
// feature part is the state's F features (computed from the core fields,
// cast to int8 as the reference casts) times the feature plane table,
// which every block stages in shared memory.  The message part is the sum
// of the plane-table rows of the state's set message ids — at most cap_m
// rows instead of a product with the whole mask; ids are unique per state,
// so the sum equals the matmul exactly.  The planes then combine into u32
// hashes mod 2^32 and lane 0 takes the unsigned minimum over permutations.
//
// Bound: bytes.  Per state it reads its core fields (~64 B) and id list
// (2 * cap_m B) and writes 16 B; each set id also pulls one 96 B row of the
// 463 KB message table, which stays in L2.  The integer work is
// (F + ids) * 16P multiply-adds per state.
#include "common.cuh"

constexpr int WARPS = 8;     // states per block
constexpr int MAX_COLS = 384; // 16 * P with P <= 24 (S <= 4)
constexpr int MAX_F = 128;

__device__ inline int feature(const Core& P, long long g, int e, const Dims& d) {
  const int S = d.S, L = d.L;
  if (e < S) return P.f[CT][g * S + e];
  e -= S;
  if (e < S) return P.f[ROLE][g * S + e];
  e -= S;
  if (e < S * L) return P.f[LT][g * S * L + e];
  e -= S * L;
  if (e < S * L) return P.f[LV][g * S * L + e];
  e -= S * L;
  if (e < S) return P.f[LL][g * S + e];
  e -= S;
  if (e < S * S) return P.f[MI][g * S * S + e];
  e -= S * S;
  if (e < S * S) return P.f[NI][g * S * S + e];
  e -= S * S;
  if (e < S) return P.f[CI][g * S + e];
  e -= S;
  if (e < S * (S + 1)) return P.f[VF][g * S + e / (S + 1)] == e % (S + 1);
  e -= S * (S + 1);
  if (e == 0) return P.f[EC][g];
  if (e == 1) return P.f[RC][g];
  e -= 2;
  if (e < S * S) return P.f[PEND][g * S * S + e];
  e -= S * S;
  return P.f[VS][g * d.V + e];
}

__global__ void fingerprint_kernel(Core P, const int16_t* __restrict__ ids, int cap_m,
                                   long long G, const int8_t* __restrict__ cplanes,
                                   const int8_t* __restrict__ gplanes, int F, int ncols, int nperm,
                                   Dims d, int64_t* __restrict__ fp_view,
                                   int64_t* __restrict__ fp_full, const int64_t* cnt,
                                   long long sub) {
  extern __shared__ int8_t csm[];  // the feature plane table, F * ncols
  __shared__ int8_t feats[WARPS][MAX_F];
  __shared__ int32_t acc_sm[WARPS][MAX_COLS];
  __shared__ uint32_t hash_sm[WARPS][MAX_COLS / 4];
  for (int i = threadIdx.x; i < F * ncols; i += blockDim.x) csm[i] = cplanes[i];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + w;
  const bool live = g < live_count(cnt, sub, 1, G);
  if (live)
    for (int e = lane; e < F; e += 32) feats[w][e] = (int8_t)feature(P, g, e, d);
  __syncthreads();
  if (!live) {  // a dead lane of a counted launch reads as SENT
    if (g < G && lane == 0) fp_view[g] = fp_full[g] = -1;
    return;
  }

  int acc[MAX_COLS / 32];
  const int per_lane = (ncols + 31) / 32;
  for (int c = 0; c < per_lane; ++c) acc[c] = 0;
  for (int e = 0; e < F; ++e) {
    const int v = feats[w][e];
    if (v == 0) continue;
    for (int c = 0; c < per_lane; ++c) {
      const int col = lane + 32 * c;
      if (col < ncols) acc[c] += v * csm[e * ncols + col];
    }
  }
  const int16_t* row_ids = ids + g * cap_m;
  for (int j = 0; j < cap_m; ++j) {
    const int id = row_ids[j];
    if (id < 0) continue;
    const int8_t* grow = gplanes + (long long)id * ncols;
    for (int c = 0; c < per_lane; ++c) {
      const int col = lane + 32 * c;
      if (col < ncols) acc[c] += grow[col];
    }
  }
  for (int c = 0; c < per_lane; ++c) {
    const int col = lane + 32 * c;
    if (col < ncols) acc_sm[w][col] = acc[c];
  }
  __syncwarp();
  // combine the 4 byte planes of each (perm, channel) into a u32, mod 2^32
  for (int pc = lane; pc < ncols / 4; pc += 32) {
    const int32_t* a = &acc_sm[w][pc * 4];
    hash_sm[w][pc] = (uint32_t)a[0] + ((uint32_t)a[1] << 8) + ((uint32_t)a[2] << 16) +
                     ((uint32_t)a[3] << 24);
  }
  __syncwarp();
  if (lane == 0) {
    uint64_t view = ~0ull, full = ~0ull;
    for (int p = 0; p < nperm; ++p) {
      const uint32_t* h = &hash_sm[w][p * 4];
      const uint64_t v = ((uint64_t)h[0] << 32) | h[1];
      const uint64_t f = ((uint64_t)h[2] << 32) | h[3];
      view = v < view ? v : view;
      full = f < full ? f : full;
    }
    fp_view[g] = (int64_t)view;
    fp_full[g] = (int64_t)full;
  }
}

// With cnt, lanes at or past live_count(cnt, sub, 1, G) are dead and get
// SENT (-1) in both outputs.
EXPORT int launch_fingerprints(const void* const* core, const int16_t* ids, int cap_m,
                               long long G, const int8_t* cplanes, const int8_t* gplanes, int F,
                               int ncols, int nperm, const int* dims, int64_t* fp_view,
                               int64_t* fp_full, const int64_t* cnt, long long sub,
                               void* stream) {
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  Dims d = load_dims(dims);
  if (F > MAX_F || ncols > MAX_COLS || ncols != 16 * nperm) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    const long long blocks = (G + WARPS - 1) / WARPS;
    fingerprint_kernel<<<(unsigned)blocks, WARPS * 32, F * ncols, (cudaStream_t)stream>>>(
        P, ids, cap_m, G, cplanes, gplanes, F, ncols, nperm, d, fp_view, fp_full, cnt, sub);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)fingerprint_kernel)
