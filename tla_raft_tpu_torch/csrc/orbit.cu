// B17 orbit pruning: the canonical-relabel fingerprint of each state.
//
// Replaces the XLA program of tla_raft_tpu/ops/fingerprint.py
// state_fingerprints_orbit (:721) with its helpers _orbit_pairh (:619),
// _orbit_colors (:634), _orbit_rank (:690) and _plane_matmul_flat (:710).
// Per state:
//   (a) the per-(src, dst)-pair message multiset hash pairh[NP]: each set id
//       off_t + q * stride_t + r adds W_t[r] to pairh[q] (mod 2^32, so the
//       shared-memory atomicAdds are exact in any order);
//   (b) three rounds of Weisfeiler-Leman colour refinement over the S
//       servers from VIEW data (currentTerm, role, log, commitIndex,
//       matchIndex / nextIndex rows and columns, votedFor, pairh);
//   (c) the canonical permutation (server i -> the number of smaller
//       colours), its Lehmer rank in server_perms() order, and `discrete`
//       (no two colours equal);
//   (d) the hash at permutation `rank`, from K3's own tables (csrc/
//       fingerprint.cu): the features against the 16 plane rows
//       rank * 16 .. rank * 16 + 15 of the transposed feature table ct,
//       combined as K3 combines its planes (linear mod 2^32, so each feature
//       adds feat * the combined coefficient), plus the message part
//       eff[id][rank][.] (monolithic) or gt[row_base_t + r][PPERM[rank][q]][.]
//       (factored).  The reference hashes the permuted features and bitmask
//       against the identity tables; the two are the same sum (the plain
//       twin takes the reference's route, tests/test_torch_orbit.py).
// Outputs per state: fp_view = ch0 << 32 | ch1, fp_full = ch2 << 32 | ch3,
// discrete, rank, and (optional) tied = live and not discrete, the flags
// the tied rows' compaction reads.  The hash is computed on every live row
// (on tied rows it is the reference's value too; the fold replaces it).
//
// Design: a warp per state.  Lanes over the id list for (a) and (d), lanes
// 0..S-1 as the servers for (b) and (c) (colours exchanged by shuffles),
// lanes over the features for (d), one warp reduction of the four channel
// sums.  Bound: a few hundred 32-bit operations per server and round and
// 16 table bytes per feature and per id; the bytes are the state's core
// fields and ids and 17-21 B out.  The tables stay in L2 (ct: 23 MB at
// S = 7, eff or gt: 0.5-31 MB).
#include "common.cuh"

constexpr int OB_WARPS = 8;
constexpr int OB_THREADS = OB_WARPS * 32;
constexpr int OB_MAX_NP = 56;  // S * (S - 1), S <= 8
constexpr unsigned FULL = 0xFFFFFFFFu;

struct OrbitTab {
  const int32_t* w;      // W_t concatenated, type t's from row_base[t]
  const int8_t* ct;      // K3's feature planes, i8 [16 nperm][f_pad]
  const uint32_t* eff;   // monolithic [M][nperm][4], or factored [rows][np][4]
  const uint8_t* pperm;  // factored: PPERM u8 [nperm][np]; null when monolithic
  int f_pad, F, nperm, np;
  int off[4], stride[4], row_base[4];
};

__device__ inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// id -> (message type, pair digit q, rest r)
__device__ inline void decode(const OrbitTab& t, int id, int& ty, int& q, int& r) {
  ty = (id >= t.off[1]) + (id >= t.off[2]) + (id >= t.off[3]);
  const int rel = id - t.off[ty];
  q = rel / t.stride[ty];
  r = rel - q * t.stride[ty];
}

template <typename Id>
__global__ void __launch_bounds__(OB_THREADS)
    orbit_kernel(Core P, const Id* __restrict__ ids, int cap_m, long long G, OrbitTab tb, Dims d,
                 unsigned long long* __restrict__ fp_view,
                 unsigned long long* __restrict__ fp_full, bool* __restrict__ discrete,
                 int32_t* __restrict__ rank_out, bool* __restrict__ tied, const int64_t* cnt,
                 long long sub) {
  __shared__ uint32_t pairh_s[OB_WARPS][OB_MAX_NP];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * OB_WARPS + w;
  if (g >= G) return;  // warp-uniform
  if (g >= live_count(cnt, sub, 1, G)) {
    if (lane == 0) {
      fp_view[g] = ~0ull;
      fp_full[g] = ~0ull;
      discrete[g] = false;
      rank_out[g] = 0;
      if (tied) tied[g] = false;
    }
    return;
  }
  const int S = d.S, L = d.L;
  uint32_t* ph = pairh_s[w];
  for (int i = lane; i < tb.np; i += 32) ph[i] = 0;
  __syncwarp();
  const Id* rid = ids + g * cap_m;
  // (a) pairh: ascending ids, then -1 pads
  for (int j = lane; j < cap_m; j += 32) {
    const int id = (int)rid[j];
    if (id < 0) break;
    int ty, q, r;
    decode(tb, id, ty, q, r);
    atomicAdd(&ph[q], (uint32_t)tb.w[tb.row_base[ty] + r]);
  }
  __syncwarp();

  // (b) the colours: lane i < S is server i (the other lanes repeat server 0)
  const int i = lane < S ? lane : 0;
  const long long gs = g * S;
  const uint8_t* mi = P.f[MI] + gs * S;
  const uint8_t* ni = P.f[NI] + gs * S;
  uint32_t logh = 0;
  for (int l = 0; l < L; ++l) {
    const uint32_t lt = P.f[LT][(gs + i) * L + l], lv = P.f[LV][(gs + i) * L + l];
    logh += mix32(lt * 0x85EBCA6Bu + lv * 0xC2B2AE35u + (uint32_t)l * 0x9E3779B9u);
  }
  uint32_t c = mix32((uint32_t)P.f[CT][gs + i] * 0x8DA6B343u +
                     (uint32_t)P.f[ROLE][gs + i] * 0xD8163841u +
                     (uint32_t)P.f[LL][gs + i] * 0xCB1AB31Fu +
                     (uint32_t)P.f[CI][gs + i] * 0x165667B1u + logh);
  const int vf = P.f[VF][gs + i];
  const int vsrc = clampi(vf - 1, 0, S - 1);
  for (int it = 0; it < 3; ++it) {
    uint32_t e_out = 0, e_in = 0;
    for (int j = 0; j < S; ++j) {
      const uint32_t cj = __shfl_sync(FULL, c, j);
      if (j == i) continue;
      e_out += mix32(cj + ph[pair_of(d, i, j)] * 3u + (uint32_t)mi[i * S + j] * 0x27D4EB2Fu +
                     (uint32_t)ni[i * S + j] * 0x9E3779B1u);
      e_in += mix32(cj + ph[pair_of(d, j, i)] * 5u + (uint32_t)mi[j * S + i] * 0x85EBCA77u +
                    (uint32_t)ni[j * S + i] * 0xC2B2AE3Du);
    }
    const uint32_t cvf = __shfl_sync(FULL, c, vsrc);
    const uint32_t vfh = vf == 0 ? 0x94D049BBu : mix32(cvf + 0xBF58476Du);
    c = mix32(c * 0xFF51AFD7u + e_out + e_in + vfh + (uint32_t)mi[i * S + i] * 0xE6546B64u +
              (uint32_t)ni[i * S + i] * 0x2545F491u);
  }

  // (c) the image of server i, ties, the Lehmer rank
  int img = 0;
  bool tie = false;
  for (int j = 0; j < S; ++j) {
    const uint32_t cj = __shfl_sync(FULL, c, j);
    img += cj < c;
    tie |= j != i && cj == c;
  }
  const bool disc = !__any_sync(FULL, lane < S && tie);
  int code = 0;
  for (int j = 0; j < S; ++j) {
    const int pj = __shfl_sync(FULL, img, j);
    code += j > i && pj < img;
  }
  int fact = 1;  // (S - 1 - i)!
  for (int k = 2; k < S - i; ++k) fact *= k;
  int rank = lane < S ? code * fact : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rank += __shfl_xor_sync(FULL, rank, o);

  // (d) the hash at permutation `rank`
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  const int8_t* ctr = tb.ct + (long long)rank * 16 * tb.f_pad;
  for (int e = lane; e < tb.F; e += 32) {
    const uint32_t fe = (uint32_t)(int)(int8_t)feature(P, g, e, d);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const int8_t* col = ctr + ch * 4 * tb.f_pad + e;
      const uint32_t coef = (uint32_t)(int)col[0] + ((uint32_t)(int)col[tb.f_pad] << 8) +
                            ((uint32_t)(int)col[2 * tb.f_pad] << 16) +
                            ((uint32_t)(int)col[3 * tb.f_pad] << 24);
      h[ch] += fe * coef;
    }
  }
  for (int j = lane; j < cap_m; j += 32) {
    const int id = (int)rid[j];
    if (id < 0) break;
    long long row;
    if (!tb.pperm) {
      row = (long long)id * tb.nperm + rank;
    } else {
      int ty, q, r;
      decode(tb, id, ty, q, r);
      row = (long long)(tb.row_base[ty] + r) * tb.np + tb.pperm[(long long)rank * tb.np + q];
    }
    const uint4 v = *(const uint4*)(tb.eff + row * 4);
    h[0] += v.x;
    h[1] += v.y;
    h[2] += v.z;
    h[3] += v.w;
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) h[ch] += __shfl_xor_sync(FULL, h[ch], o);
  if (lane == 0) {
    fp_view[g] = ((unsigned long long)h[0] << 32) | h[1];
    fp_full[g] = ((unsigned long long)h[2] << 32) | h[3];
    discrete[g] = disc;
    rank_out[g] = rank;
    if (tied) tied[g] = !disc;
  }
}

// w: i32 [sum of strides]; ct: i8 [16 nperm][f_pad]; eff: u32 [M][nperm][4]
// (pperm null) or [rows][np][4] with pperm u8 [nperm][np]; type_dims =
// off[4], stride[4], row_base[4].  Rows at or past live_count(cnt, sub, 1, G)
// get SENT, discrete and tied false, rank 0; tied may be null.
EXPORT int launch_orbit(const void* const* core, const void* ids, int id_bytes, int cap_m,
                        long long G, const int32_t* w, const int8_t* ct, int f_pad, int F,
                        int nperm, const uint32_t* eff, const uint8_t* pperm, int np,
                        const int* type_dims, const int* dims, int64_t* fp_view,
                        int64_t* fp_full, bool* discrete, int32_t* rank, bool* tied,
                        const int64_t* cnt, long long sub, void* stream) {
  const Dims d = load_dims(dims);
  if (np != d.S * (d.S - 1) || np > OB_MAX_NP || d.S > 8 || F > f_pad ||
      (id_bytes != 2 && id_bytes != 4) || nperm < 1)
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return (int)cudaGetLastError();
  OrbitTab tb;
  tb.w = w;
  tb.ct = ct;
  tb.eff = eff;
  tb.pperm = pperm;
  tb.f_pad = f_pad;
  tb.F = F;
  tb.nperm = nperm;
  tb.np = np;
  for (int i = 0; i < 4; ++i) {
    tb.off[i] = type_dims[i];
    tb.stride[i] = type_dims[4 + i];
    tb.row_base[i] = type_dims[8 + i];
  }
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((G + OB_WARPS - 1) / OB_WARPS);
  if (id_bytes == 2)
    orbit_kernel<int16_t><<<grid, OB_THREADS, 0, st>>>(
        P, (const int16_t*)ids, cap_m, G, tb, d, (unsigned long long*)fp_view,
        (unsigned long long*)fp_full, discrete, rank, tied, cnt, sub);
  else
    orbit_kernel<int32_t><<<grid, OB_THREADS, 0, st>>>(
        P, (const int32_t*)ids, cap_m, G, tb, d, (unsigned long long*)fp_view,
        (unsigned long long*)fp_full, discrete, rank, tied, cnt, sub);
  return (int)cudaGetLastError();
}

WARM((const void*)orbit_kernel<int16_t>, (const void*)orbit_kernel<int32_t>)
