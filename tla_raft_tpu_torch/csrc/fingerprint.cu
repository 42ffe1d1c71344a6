// K3 state fingerprints: symmetry-folded (fp_view, fp_full) of each state.
//
// Replaces the XLA program of tla_raft_tpu/ops/fingerprint.py
// FeatureSpec.features + Fingerprinter.feat_hash / _plane_matmul (an i8
// [G, F] x [F, 16 P] byte-plane matmul), Fingerprinter.msg_hash (the i8
// [G, M] x [M, 16 P] message-set matmul, or at S=7 the pair-block factored
// form _msg_hash_factored, :424) and finalize (the unsigned minimum over the
// P server permutations of the two 64-bit channel pairs).
//
// Design: one tiled form for any symmetry group (S = 3: P = 6, S = 5:
//   P = 120, S = 7: P = 5,040).  A grid over (64 states, a range of
//   permutation tiles of 8 permutations = 128 plane columns).  The
//   block computes its states' features (i8, F padded to a multiple of 32)
//   once and keeps them as MMA A fragments in registers.  Per tile it stages
//   the tile's columns of the transposed feature table in shared memory, sums
//   each state's message part for the tile's (permutation, channel) pairs,
//   and runs int8 tensor-core MMAs (mma.sync m16n8k32, s8 x s8 -> s32) for the
//   feature part, one warp per 16 states.  The epilogue combines the planes
//   of each (state, permutation, channel) into a u32 in registers, adds the
//   message part, and keeps the running unsigned minimum of the two 64-bit
//   pairs; at the end one atomicMin per state and output folds the block's
//   minimum into fp_view / fp_full, which the launch first sets to all ones
//   (SENT).  The minimum is order-free, so the bytes do not depend on thread
//   timing.  No [G, P, chan] hash is written anywhere.
//
//   The message part adds effective u32 coefficients (the four signed byte
//   planes of a coefficient combined, ops/fingerprint.py kernel_tables): the
//   plane combine is linear mod 2^32, so adding combined coefficients equals
//   combining the plane sums.  Monolithic: eff[id][p][chan] is the folded
//   table.  Factored (B7 _msg_hash_factored): a permutation moves only the
//   pair digit q of id = off_t + q * stride_t + r, so the entry is
//   gt[row_base_t + r][PPERM[p][q]][chan] over a [sum of strides, NP, 4]
//   table (543 KB at S = 7) — the reference's partial sums R[q, q'] folded
//   by PPERM, computed per id and permutation in exact u32 arithmetic.
//
//   Indexed mode (orbit pruning, B17: the exact fold of the tied rows of
//   tla_raft_tpu/engine/bfs.py _orbit_chunk_fps :1056): launch row i is
//   state idx[i] and writes fp_view / fp_full[idx[i]], for i below a device
//   count (the tied rows' compaction total), so the fold runs inside a
//   captured graph with no host read; a first kernel sets just those
//   outputs to SENT (the others keep the orbit kernel's values) and sets an
//   overflow word when the count passes the index budget.
//
//   An earlier form (a warp per state, the 16 P plane columns over its lanes
//   in int32 on the CUDA cores) took 0.76 ms where this one takes 0.25 ms at
//   the S = 3 main path's shapes on an H100 (chip_smoke.py), and could not
//   hold S >= 4.
//
// Bound: the int8 tensor rate for the feature part
// (2 F_pad * 16 P operations a state) and the 32-bit adds of the message
// part (P * 4 per set id); the bytes are the states' core fields and id
// lists (~2-4 B * cap_m) and 16 B out.  The tables stay in L2 (30.9 MB
// eff + 0.3 MB features at S = 5; 23 MB features + 0.5 MB gt at S = 7).
#include "common.cuh"

// -- the kernel ---------------------------------------------------------------------

constexpr int TB_STATES = 64;            // states per block: 4 warps x 16 MMA rows
constexpr int TB_THREADS = 128;
constexpr int TB_PERMS = 8;              // permutations per tile
constexpr int TB_COLS = TB_PERMS * 16;   // plane columns per tile
constexpr int TB_TILES = 16;             // tiles per block (grid.y splits the rest)
constexpr int MAX_KS = 12;               // F_pad / 32, F <= 384
constexpr int MAX_NP = 56;               // S * (S - 1), S <= 8
constexpr int MS_STRIDE = 34;            // u32 row stride of the message sums
constexpr int TB_SMEM_MAX = 96 * 1024;   // the dynamic shared memory the launch may ask

// The message-part table: monolithic eff [M][P][4] (pperm null), or the
// factored gt [rows][NP][4] with PPERM [P][NP] and the type layout.
struct MsgTab {
  const uint32_t* eff;
  const uint8_t* pperm;
  int np;
  int off[4], stride[4], row_base[4];
};

__device__ inline void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Effective coefficient of message `id` under permutation p (the tile's
// local index pl into `pp`, the tile's PPERM rows), channel ch.
__device__ inline uint32_t msg_coef(const MsgTab& mt, const uint8_t* pp, int id, int p, int pl,
                                    int ch, int nperm) {
  if (!mt.pperm) return mt.eff[((long long)id * nperm + p) * 4 + ch];
  const int t = (id >= mt.off[1]) + (id >= mt.off[2]) + (id >= mt.off[3]);
  const int rel = id - mt.off[t];
  const int q = rel / mt.stride[t];
  const int r = rel - q * mt.stride[t];
  return mt.eff[((long long)(mt.row_base[t] + r) * mt.np + pp[pl * MAX_NP + q]) * 4 + ch];
}

template <typename Id>
__global__ void __launch_bounds__(TB_THREADS)
    fingerprint_kernel(Core P, const Id* __restrict__ ids, int cap_m, long long G,
                       const int8_t* __restrict__ ct, int f_pad, int F, int nperm, MsgTab mt,
                       Dims d, unsigned long long* __restrict__ fp_view,
                       unsigned long long* __restrict__ fp_full, const int64_t* cnt,
                       long long sub, const int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_b = f_pad + 16;  // shared row stride (bytes): spreads the fragment loads' banks
  int8_t* As = (int8_t*)smem;                                 // [64][row_b] features
  int8_t* Bs = As + TB_STATES * row_b;                        // [128][row_b] tile columns
  uint32_t* msum = (uint32_t*)(Bs + TB_COLS * row_b);         // [64][MS_STRIDE]
  uint8_t* pp = (uint8_t*)(msum + TB_STATES * MS_STRIDE);     // [8][MAX_NP] PPERM rows
  const long long live = live_count(cnt, sub, 1, G);
  const long long base = (long long)blockIdx.x * TB_STATES;
  if (base >= live) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks_n = f_pad / 32;

  // launch row g is state g, or idx[g] in the indexed mode
  for (int i = tid; i < TB_STATES * f_pad; i += TB_THREADS) {
    const int r = i / f_pad, e = i - r * f_pad;
    const long long g = base + r;
    As[r * row_b + e] =
        (g < live && e < F) ? (int8_t)feature(P, idx ? idx[g] : g, e, d) : (int8_t)0;
  }
  __syncthreads();
  // the warp's A fragments (rows w*16 + gq and + 8), every k-step
  uint32_t a[MAX_KS][4];
  {
    const int8_t* r0 = As + (w * 16 + gq) * row_b + t4 * 4;
    const int8_t* r1 = r0 + 8 * row_b;
#pragma unroll
    for (int ks = 0; ks < MAX_KS; ++ks) {
      if (ks < ks_n) {
        a[ks][0] = *(const uint32_t*)(r0 + ks * 32);
        a[ks][1] = *(const uint32_t*)(r1 + ks * 32);
        a[ks][2] = *(const uint32_t*)(r0 + ks * 32 + 16);
        a[ks][3] = *(const uint32_t*)(r1 + ks * 32 + 16);
      }
    }
  }
  uint64_t minv[2] = {~0ull, ~0ull}, minf[2] = {~0ull, ~0ull};
  const int n_tiles = (nperm + TB_PERMS - 1) / TB_PERMS;
  const int t_lo = blockIdx.y * TB_TILES;
  const int t_hi = min(n_tiles, t_lo + TB_TILES);
  const int ncols = nperm * 16, vec_per_row = f_pad / 16;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int p0 = tile * TB_PERMS;
    __syncthreads();  // the previous tile's columns and sums are consumed
    for (int i = tid; i < TB_COLS * vec_per_row; i += TB_THREADS) {
      const int c = i / vec_per_row, v = i - c * vec_per_row;
      const int col = p0 * 16 + c;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (col < ncols) x = *(const uint4*)(ct + (long long)col * f_pad + v * 16);
      *(uint4*)(Bs + c * row_b + v * 16) = x;
    }
    if (mt.pperm)
      for (int i = tid; i < TB_PERMS * mt.np; i += TB_THREADS) {
        const int pl = i / mt.np, q = i - pl * mt.np;
        pp[pl * MAX_NP + q] = p0 + pl < nperm ? mt.pperm[(long long)(p0 + pl) * mt.np + q] : 0;
      }
    __syncthreads();
    // the message sums of the warp's own 16 states: lane = (perm in tile, channel)
    {
      const int pl = lane >> 2, ch = lane & 3, p = p0 + pl;
      for (int r = 0; r < 16; ++r) {
        const int row = w * 16 + r;
        const long long g = base + row;
        uint32_t acc = 0;
        if (g < live) {
          const Id* rid = ids + (idx ? idx[g] : g) * cap_m;
          for (int j0 = 0; j0 < cap_m; j0 += 32) {  // the ids, 32 at a time
            const int mine = j0 + lane < cap_m ? (int)rid[j0 + lane] : -1;
            const int n = __popc(__ballot_sync(0xFFFFFFFFu, mine >= 0));
#pragma unroll 4
            for (int k = 0; k < n; ++k) {
              const int id = __shfl_sync(0xFFFFFFFFu, mine, k);
              if (p < nperm) acc += msg_coef(mt, pp, id, p, pl, ch, nperm);
            }
            if (n < 32) break;  // ascending ids, then -1 pads
          }
        }
        msum[row * MS_STRIDE + lane] = acc;
      }
    }
    __syncwarp();
    for (int pl = 0; pl < TB_PERMS; ++pl) {
      if (p0 + pl >= nperm) break;  // uniform
      int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};  // plane columns 0-7, 8-15
      const int8_t* b0p = Bs + (pl * 16 + gq) * row_b + t4 * 4;
      const int8_t* b1p = b0p + 8 * row_b;
#pragma unroll
      for (int ks = 0; ks < MAX_KS; ++ks) {
        if (ks < ks_n) {
          mma_s8(acc0, a[ks], *(const uint32_t*)(b0p + ks * 32),
                 *(const uint32_t*)(b0p + ks * 32 + 16));
          mma_s8(acc1, a[ks], *(const uint32_t*)(b1p + ks * 32),
                 *(const uint32_t*)(b1p + ks * 32 + 16));
        }
      }
      // lane (gq, t4) holds plane sums of rows gq, gq + 8, at columns 2 t4, 2 t4 + 1
      // of each n-tile j: channel 2 j + (t4 >> 1), bytes 2 (t4 & 1) and + 1
      const int sh = 16 * (t4 & 1);
      uint32_t h[2][2];
      h[0][0] = ((uint32_t)acc0[0] << sh) + ((uint32_t)acc0[1] << (sh + 8));
      h[0][1] = ((uint32_t)acc0[2] << sh) + ((uint32_t)acc0[3] << (sh + 8));
      h[1][0] = ((uint32_t)acc1[0] << sh) + ((uint32_t)acc1[1] << (sh + 8));
      h[1][1] = ((uint32_t)acc1[2] << sh) + ((uint32_t)acc1[3] << (sh + 8));
      uint32_t o[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          h[j][r] += __shfl_xor_sync(0xFFFFFFFFu, h[j][r], 1);  // all four bytes
          h[j][r] += msum[(w * 16 + gq + 8 * r) * MS_STRIDE + pl * 4 + 2 * j + (t4 >> 1)];
          o[j][r] = __shfl_xor_sync(0xFFFFFFFFu, h[j][r], 2);  // the pair's other channel
        }
      // lanes with t4 == 0: channels 2j in h, 2j + 1 in o
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint64_t v = ((uint64_t)h[0][r] << 32) | o[0][r];
        const uint64_t f = ((uint64_t)h[1][r] << 32) | o[1][r];
        minv[r] = v < minv[r] ? v : minv[r];
        minf[r] = f < minf[r] ? f : minf[r];
      }
    }
  }
  if (t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long g = base + w * 16 + gq + 8 * r;
      if (g < live) {
        const long long s = idx ? idx[g] : g;
        atomicMin(fp_view + s, minv[r]);
        atomicMin(fp_full + s, minf[r]);
      }
    }
}

// The indexed mode's outputs to SENT (the rows below the count), and
// *ovf = 1 when the count passes the G index rows.
__global__ void sent_at_idx(const int64_t* __restrict__ idx, long long G, const int64_t* cnt,
                            long long sub, int64_t* fp_view, int64_t* fp_full, int64_t* ovf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 && ovf && *cnt - sub > G) *ovf = 1;
  if (i < live_count(cnt, sub, 1, G)) {
    fp_view[idx[i]] = -1;
    fp_full[idx[i]] = -1;
  }
}

static Core core_of(const void* const* core) {
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  return P;
}

// ct: i8 [16 nperm][f_pad]; eff: u32 [M][nperm][4]
// (pperm null) or [rows][np][4] with pperm u8 [nperm][np] and type_dims =
// off[4], stride[4], row_base[4].  Both outputs are set to SENT first; lanes
// at or past live_count(cnt, sub, 1, G) stay SENT.  With idx (i64 [G], the
// indexed mode; cnt then required) launch row i is state idx[i], only the
// outputs at idx[i] are set and folded, and ovf (nullable) is set to 1 when
// the count passes G.
EXPORT int launch_fingerprints(const void* const* core, const void* ids, int id_bytes,
                               int cap_m, long long G, const int8_t* ct, int f_pad, int F,
                               int nperm, const uint32_t* eff, const uint8_t* pperm, int np,
                               const int* type_dims, const int* dims, int64_t* fp_view,
                               int64_t* fp_full, const int64_t* cnt, long long sub,
                               const int64_t* idx, int64_t* ovf, void* stream) {
  const size_t smem = (size_t)(TB_STATES + TB_COLS) * (f_pad + 16) +
                      TB_STATES * MS_STRIDE * sizeof(uint32_t) + TB_PERMS * MAX_NP;
  if (f_pad % 32 || f_pad / 32 > MAX_KS || F > f_pad || np > MAX_NP || smem > TB_SMEM_MAX ||
      (id_bytes != 2 && id_bytes != 4) || nperm < 1 || (idx && !cnt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0) return (int)cudaGetLastError();
  if (idx) {
    sent_at_idx<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(idx, G, cnt, sub, fp_view, fp_full,
                                                             ovf);
  } else {
    cudaMemsetAsync(fp_view, 0xFF, (size_t)G * sizeof(int64_t), st);
    cudaMemsetAsync(fp_full, 0xFF, (size_t)G * sizeof(int64_t), st);
  }
  MsgTab mt;
  mt.eff = eff;
  mt.pperm = pperm;
  mt.np = np;
  for (int i = 0; i < 4; ++i) {
    mt.off[i] = pperm ? type_dims[i] : 0;
    mt.stride[i] = pperm ? type_dims[4 + i] : 1;
    mt.row_base[i] = pperm ? type_dims[8 + i] : 0;
  }
  const Core P = core_of(core);
  const Dims d = load_dims(dims);
  const int n_tiles = (nperm + TB_PERMS - 1) / TB_PERMS;
  const dim3 grid((unsigned)((G + TB_STATES - 1) / TB_STATES),
                  (unsigned)((n_tiles + TB_TILES - 1) / TB_TILES));
  if (id_bytes == 2)
    fingerprint_kernel<int16_t><<<grid, TB_THREADS, smem, st>>>(
        P, (const int16_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, d,
        (unsigned long long*)fp_view, (unsigned long long*)fp_full, cnt, sub, idx);
  else
    fingerprint_kernel<int32_t><<<grid, TB_THREADS, smem, st>>>(
        P, (const int32_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, d,
        (unsigned long long*)fp_view, (unsigned long long*)fp_full, cnt, sub, idx);
  return (int)cudaGetLastError();
}

// Loads the kernel now (not at a first launch inside a graph capture) and
// lets it take more than 48 KB of dynamic shared memory.
EXPORT int lib_warm() {
  cudaFuncAttributes a;
  const void* fns[] = {(const void*)fingerprint_kernel<int16_t>,
                       (const void*)fingerprint_kernel<int32_t>, (const void*)sent_at_idx};
  for (const void* f : fns) {
    cudaFuncGetAttributes(&a, f);
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, TB_SMEM_MAX);
  }
  return (int)cudaGetLastError();
}
