// K3 state fingerprints: symmetry-folded (fp_view, fp_full) of each state.
//
// Replaces the XLA program of tla_raft_tpu/ops/fingerprint.py
// FeatureSpec.features + Fingerprinter.feat_hash / _plane_matmul (an i8
// [G, F] x [F, 16 P] byte-plane matmul), Fingerprinter.msg_hash (the i8
// [G, M] x [M, 16 P] message-set matmul, or at S=7 the pair-block factored
// form _msg_hash_factored, :424) and finalize (the unsigned minimum over the
// P server permutations of the two 64-bit channel pairs).
//
// Design: a tiled form for any symmetry group (S = 5: P = 120, S = 7:
//   P = 5,040), and at S <= 3 (P <= 8: every permutation in one tile; F_pad
//   <= 128) a form of its own (below).  A grid over (64 states, a range of
//   permutation tiles of 8 permutations = 128 plane columns).  The
//   block computes its states' features (i8, F padded to a multiple of 32)
//   once and keeps them as MMA A fragments in registers.  Per tile it stages
//   the tile's columns of the transposed feature table in shared memory and
//   runs int8 tensor-core MMAs (mma.sync m16n8k32, s8 x s8 -> s32) for the
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
//   combining the plane sums.
//
//   Monolithic (S = 4, 5, 6, and S <= 3 with F_pad > 128; fingerprint_kernel,
//   128 threads): eff[id][p][chan]
//   is the folded table; per tile each lane (permutation, channel) of a warp
//   sums its states' entries over their ids.  S = 4-6 keep this form by
//   design: their P passes one tile.
//
//   S <= 3 (fingerprint_s3, 384 threads, a persistent grid of as many
//   blocks as stay resident): the feature table's P * 16 used columns and
//   the features' packed codes are staged once a block; then each group of
//   64 states has its fields (field-major, each field's rows one contiguous
//   span) and id lists copied to shared memory as 16-B cp.async vectors
//   while the previous group computes; its features are read there through
//   the codes; the message part takes a thread a (state, permutation), its
//   four channels one 16-B load of eff an id, 8 ids' loads in flight (a
//   state's id row is 4 P u32: P 16-B vectors); warp w runs the MMAs of row
//   group w & 3 for permutations w / 4, + 3, + 6, and the three sets'
//   minima meet in shared memory: each state is written once (SENT past
//   the live count), with no memset and no atomic.  Its earlier form, the
//   tiled one with every feature read byte by byte through a 13-branch
//   chain and 128 columns staged per block, took 0.144 ms for a fused
//   level's chunk (75,206 live of 98,304 lanes) on an H100, half of it the
//   feature staging (PERF.md).
//
//   Factored (S = 7, B7 _msg_hash_factored; fingerprint_factored, 256
//   threads): a permutation moves only the pair digit q of id = off_t +
//   q * stride_t + r, so the message part of permutation p is
//   sum over the digits q the state carries of R[q][PPERM[p][q]], where
//   R[q][q'] = sum over its ids of digit q of gt[row_base_t + r][q'] -- the
//   reference's own partial sums, exact in u32 arithmetic mod 2^32, which is
//   what the reference's exact f32 fold gives after the plane combine.  The
//   two 64-bit pairs are independent minima, so the block runs twice, for
//   channels 0-1 (fp_view) and 2-3 (fp_full), on a half of gt's channels a
//   pass (gt_half [sum of strides, 2, NP, 2] u32, 543 KB at S = 7): half the
//   shared sums a pass, so a block takes 256 permutations (grid.y = 20 at
//   S = 7) and each state's R rows are built 20 times a launch, not 630.
//   A pass, state by state (a warp a state, 8 at once): each id is decoded
//   once (type, digit, row) and its half row (2 NP u32, contiguous) added
//   into its digit's R row by the lanes owning the columns (no atomics;
//   ascending ids put a digit's ids of one type side by side, so a run sums
//   in registers), R held for the present digits only (28 rows a warp, more
//   in batches); then each lane folds 8 of the block's permutations, one
//   8-byte shared load a present digit.  The sums (64 states x 256
//   permutations x 2 channels, 129 KB) stay in shared memory for the tile
//   loop, whose epilogue reads them: no id loop, division or global gather
//   is left inside it.  The tile loop copies two tiles' half columns a round
//   with cp.async into one of two buffers while the other's MMAs run (warps
//   0-3 and 4-7 the round's two tiles, each warp 16 states, its 8
//   permutations' MMA chains side by side).  The states' core fields are
//   copied to shared memory first, and each feature is read there through
//   a per-feature code (field, byte, one-hot value).  Shared memory at
//   F_pad = 288: sums 129 KB, region B 76 KB (the B buffers; before them the
//   R rows; before those the A tile and the fields), PPERM rows 11 KB: one
//   block of 8 warps an SM.
//   The factored part's earlier design (every lane of every tile walking all
//   of a state's ids: a shuffle, the type test, a division, a PPERM lookup
//   and a scattered gt gather per id, permutation and channel) took 28.02 ms
//   for 12,288 S = 7 lanes (msg_hash_factored) and 48.71 ms for a depth-15
//   chunk's 17,610 tied rows (orbit_fold) on an H100 (chip_smoke.py; PERF.md).
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
//   in int32 on the CUDA cores) took 0.76 ms where the tiled one took 0.25
//   ms at the S = 3 main path's shapes on an H100 (chip_smoke.py), and could
//   not hold S >= 4.
//
// Bound: the int8 tensor rate for the feature part
// (2 F_pad * 16 P operations a state) and the 32-bit adds of the message
// part (P * 4 per set id); the bytes are the states' core fields and id
// lists (~2-4 B * cap_m) and 16 B out.  The tables stay in L2 (30.9 MB
// eff + 0.3 MB features at S = 5; 23 MB features + 0.5 MB gt at S = 7).
#include "common.cuh"

// -- the kernels --------------------------------------------------------------------

constexpr int TB_STATES = 64;            // states per block: 4 row groups x 16 MMA rows
constexpr int TB_THREADS = 128;          // the monolithic form: 4 warps
constexpr int TB_PERMS = 8;              // permutations per tile
constexpr int TB_COLS = TB_PERMS * 16;   // plane columns per tile
constexpr int TB_TILES = 16;             // tiles per block (grid.y splits the rest)
constexpr int MAX_KS = 12;               // F_pad / 32, F <= 384
constexpr int MAX_NP = 56;               // S * (S - 1), S <= 8
constexpr int MS_STRIDE = 34;            // u32 row stride of the monolithic message sums
constexpr int TB_SMEM_MAX = 96 * 1024;   // the monolithic launch's dynamic shared memory
constexpr int FX_THREADS = 256;          // the factored form: 8 warps
constexpr int FX_WARPS = FX_THREADS / 32;
constexpr int FX_TILES = 32;             // tiles a block
constexpr int FX_PERMS = FX_TILES * TB_PERMS;  // permutations a block: 256
constexpr int FX_MS_ROW = FX_PERMS * 2 + 2;    // u32 stride of a state's sums of a half (+2: banks)
constexpr int FX_HCOLS = TB_PERMS * 8;   // a tile's plane columns of one half
constexpr int FX_CC = 3;                 // half-row words a lane: np <= 48 (S <= 7)
constexpr int FX_IDS = 8;                // ids whose gt rows a lane loads at once
constexpr int FX_CHAINS = 8;             // permutations whose MMAs a warp interleaves
constexpr int FX_SMEM_MAX = 227 * 1024;
constexpr int S3_THREADS = 384;          // the S <= 3 form: 12 warps
constexpr int S3_PSETS = 3;              // warps a row group: permutations p = w / 4 (mod 3)
constexpr int S3_MAX_PERMS = 8;          // every permutation in one tile (S <= 3)
constexpr int S3_MAX_KS = 4;             // F_pad <= 128 (the reference's S <= 3 constants: 96)
constexpr int S3_IDS = 8;                // eff loads a thread keeps in flight
constexpr int S3_IDS_SMEM = 32 * 1024;   // id lists staged when a buffer's fit
constexpr int S3_SMEM_MAX = 120 * 1024;

// The message-part table: monolithic eff [M][P][4] (pperm null), or the
// factored gt_half [rows][2][NP][2] with PPERM [P][NP] and the type layout.
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

// The block's 64 states' features into As [64][row_b] (zero past F and for
// rows at or past live); launch row g is state g, or idx[g] in the indexed mode.
template <int NT>
__device__ inline void stage_features(int8_t* As, int row_b, const Core& P, long long base,
                                      long long live, int f_pad, int F, const Dims& d,
                                      const int64_t* idx) {
  for (int i = threadIdx.x; i < TB_STATES * f_pad; i += NT) {
    const int r = i / f_pad, e = i - r * f_pad;
    const long long g = base + r;
    As[r * row_b + e] =
        (g < live && e < F) ? (int8_t)feature(P, idx ? idx[g] : g, e, d) : (int8_t)0;
  }
}

// A warp's A fragments (rows rg*16 + gq and + 8), every k-step (KS of
// them at most).
template <int KS>
__device__ inline void load_a(uint32_t (&a)[KS][4], const int8_t* As, int row_b, int rg,
                              int ks_n) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int8_t* r0 = As + (rg * 16 + gq) * row_b + t4 * 4;
  const int8_t* r1 = r0 + 8 * row_b;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < ks_n) {
      a[ks][0] = *(const uint32_t*)(r0 + ks * 32);
      a[ks][1] = *(const uint32_t*)(r1 + ks * 32);
      a[ks][2] = *(const uint32_t*)(r0 + ks * 32 + 16);
      a[ks][3] = *(const uint32_t*)(r1 + ks * 32 + 16);
    }
  }
}

// ncol columns of the transposed feature table from column col0 into Bs
// [ncol][row_b] (zero past the table's ncols).
template <int NT>
__device__ inline void stage_cols(int8_t* Bs, int row_b, const int8_t* __restrict__ ct, int f_pad,
                                  int col0, int ncol, int ncols) {
  const int vec_per_row = f_pad / 16;
  for (int i = threadIdx.x; i < ncol * vec_per_row; i += NT) {
    const int c = i / vec_per_row, v = i - c * vec_per_row;
    const int col = col0 + c;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (col < ncols) x = *(const uint4*)(ct + (long long)col * f_pad + v * 16);
    *(uint4*)(Bs + c * row_b + v * 16) = x;
  }
}

// One permutation of a warp's 16 states: the feature part's MMAs over the
// permutation's 16 staged plane columns (bt), the planes combined, the
// message part m[j][r] (this lane's channel 2 j + (t4 >> 1) of row gq + 8 r)
// added, and the running minima of the two 64-bit pairs (lanes t4 == 0).
template <int KS>
__device__ inline void fold_perm(const uint32_t (&a)[KS][4], const int8_t* bt, int row_b,
                                 int ks_n, const uint32_t (&m)[2][2], uint64_t (&minv)[2],
                                 uint64_t (&minf)[2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};  // plane columns 0-7, 8-15
  const int8_t* b0p = bt + gq * row_b + t4 * 4;
  const int8_t* b1p = b0p + 8 * row_b;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
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
      h[j][r] += m[j][r];
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

// The block's minima into the outputs (rows rg*16 + gq and + 8): an
// atomicMin onto the launch's SENT.
__device__ inline void store_min(const uint64_t (&minv)[2], const uint64_t (&minf)[2], int rg,
                                 long long base, long long live, const int64_t* idx,
                                 unsigned long long* fp_view, unsigned long long* fp_full) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  if (t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long g = base + rg * 16 + gq + 8 * r;
      if (g < live) {
        const long long s = idx ? idx[g] : g;
        atomicMin(fp_view + s, minv[r]);
        atomicMin(fp_full + s, minf[r]);
      }
    }
}

// The monolithic form (eff [M][P][4]; S = 4, 5, 6, and S <= 3 when the
// feature table passes S3_MAX_KS k-steps).
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
  const long long live = live_count(cnt, sub, 1, G);
  const long long base = (long long)blockIdx.x * TB_STATES;
  if (base >= live) return;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks_n = f_pad / 32;

  stage_features<TB_THREADS>(As, row_b, P, base, live, f_pad, F, d, idx);
  __syncthreads();
  uint32_t a[MAX_KS][4];
  load_a(a, As, row_b, w, ks_n);
  uint64_t minv[2] = {~0ull, ~0ull}, minf[2] = {~0ull, ~0ull};
  const int n_tiles = (nperm + TB_PERMS - 1) / TB_PERMS;
  const int t_lo = blockIdx.y * TB_TILES;
  const int t_hi = min(n_tiles, t_lo + TB_TILES);
  const int gq = lane >> 2, t4 = lane & 3;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int p0 = tile * TB_PERMS;
    __syncthreads();  // the previous tile's columns and sums are consumed
    stage_cols<TB_THREADS>(Bs, row_b, ct, f_pad, p0 * 16, TB_COLS, nperm * 16);
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
              if (p < nperm) acc += mt.eff[((long long)id * nperm + p) * 4 + ch];
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
      uint32_t m[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[j][r] = msum[(w * 16 + gq + 8 * r) * MS_STRIDE + pl * 4 + 2 * j + (t4 >> 1)];
      fold_perm(a, Bs + pl * 16 * row_b, row_b, ks_n, m, minv, minf);
    }
  }
  store_min(minv, minf, w, base, live, idx, fp_view, fp_full);
}

// A state's bytes of field f (the Core layout of common.cuh).
__host__ __device__ inline int field_bytes(int f, const Dims& d) {
  const int S = d.S;
  switch (f) {
    case LT: case LV: return S * d.L;
    case MI: case NI: case PEND: return S * S;
    case EC: case RC: return 1;
    case VS: return d.V;
    default: return S;
  }
}

__host__ __device__ inline int state_bytes(const Dims& d) {
  int b = 0;
  for (int f = 0; f < N_FIELDS; ++f) b += field_bytes(f, d);
  return b;
}

// Where feature e lives, as common.cuh feature() reads it: field | byte j of
// the state's row << 4 | (for the votedFor one-hot, the value compared
// with, plus one) << 16.
__device__ inline int feature_code(int e, const Dims& d) {
  const int S = d.S, L = d.L;
  int f, j = e, cmp = 0;
  if (j < S) f = CT;
  else if ((j -= S) < S) f = ROLE;
  else if ((j -= S) < S * L) f = LT;
  else if ((j -= S * L) < S * L) f = LV;
  else if ((j -= S * L) < S) f = LL;
  else if ((j -= S) < S * S) f = MI;
  else if ((j -= S * S) < S * S) f = NI;
  else if ((j -= S * S) < S) f = CI;
  else if ((j -= S) < S * (S + 1)) {
    f = VF;
    cmp = j % (S + 1) + 1;
    j /= S + 1;
  } else if ((j -= S * (S + 1)) < 2) {
    f = j ? RC : EC;
    j = 0;
  } else if ((j -= 2) < S * S) {
    f = PEND;
  } else {
    j -= S * S;
    f = VS;
  }
  return f | j << 4 | cmp << 16;
}

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

// A block's segment table in shared memory (thread s writes segment s):
// field f's rows at foff[f] of a buffer (64 rows a field, field after
// field), then the id lists at ids_off when ids_off >= 0.
template <typename Id>
__device__ inline void seg_table(Segs* sg, const Core& P, const Id* ids, int cap_m,
                                 const int* foff, const int* fsz, int ids_off) {
  const int t = threadIdx.x;
  if (t < N_FIELDS) {
    sg->src[t] = P.f[t];
    sg->dst[t] = foff[t];
    sg->rb[t] = fsz[t];
  } else if (t == N_FIELDS && ids_off >= 0) {
    sg->src[t] = (const uint8_t*)ids;
    sg->dst[t] = ids_off;
    sg->rb[t] = cap_m * (int)sizeof(Id);
  }
  if (t == 0) sg->n = ids_off >= 0 ? N_FIELDS + 1 : N_FIELDS;
}

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

// The block's features As [64][row_b] (4 a thread at once), each read from
// the staged fields through its packed code (feature_tables; -1 past F:
// 0); rows at or past nrows are 0.
template <int NT>
__device__ inline void build_features(int8_t* As, int row_b, const uint8_t* raw,
                                      const int* pcode, int nrows, int f_pad) {
  const int t = threadIdx.x, n_cw = f_pad / 4;
  for (int i = t; i < TB_STATES * n_cw; i += NT) {
    const int r = i / n_cw, e0 = (i - r * n_cw) * 4;
    uint32_t w = 0;
    if (r < nrows)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = pcode[e0 + k];
        if (c >= 0) {
          const uint8_t v = raw[(c & 0xFFFF) + r * ((c >> 16) & 0xFF)];
          const int cmp = c >> 24;
          w |= (uint32_t)(cmp ? (uint8_t)(v == cmp - 1) : v) << (8 * k);
        }
      }
    *(uint32_t*)(As + r * row_b + e0) = w;
  }
}

// The fields' offsets in the staged rows (64 rows a field, field after
// field) and row bytes, and each feature's packed code pcode[f_pad]: where
// feature_code puts it in those rows (its field's offset + the byte | the
// field's row bytes << 16 | the votedFor one-hot value + 1 << 24), -1 past
// F.
__device__ inline void feature_tables(int* pcode, int* foff, int* fsz, int f_pad, int F,
                                      const Dims& d) {
  if (threadIdx.x < N_FIELDS) {
    int o = 0;
    for (int f = 0; f < (int)threadIdx.x; ++f) o += field_bytes(f, d);
    foff[threadIdx.x] = TB_STATES * o;
    fsz[threadIdx.x] = field_bytes(threadIdx.x, d);
  }
  for (int e = threadIdx.x; e < f_pad; e += blockDim.x) {
    int c = -1;
    if (e < F) {
      const int code = feature_code(e, d), f = code & 15;
      int o = 0;
      for (int g = 0; g < f; ++g) o += field_bytes(g, d);
      c = (TB_STATES * o + ((code >> 4) & 4095)) | field_bytes(f, d) << 16 | (code >> 16) << 24;
    }
    pcode[e] = c;
  }
}

// The factored form's shared regions: the sums of one half [64][FX_MS_ROW]
// u32; region B (the B tiles of two rounds, or the warps' R rows, or the A
// tile and the states' fields); the block's PPERM rows [FX_PERMS][np]; the
// states' digit masks [64]; the warps' present digits [FX_WARPS][MAX_NP];
// the features' codes [MAX_KS * 32]; the fields' offsets and sizes.
static inline size_t fx_region_b(int f_pad, int np, const Dims& d) {
  size_t b = (size_t)4 * FX_HCOLS * (f_pad + 16);
  const size_t a = (size_t)TB_STATES * (f_pad + 16) + (size_t)TB_STATES * state_bytes(d);
  const size_t r = (size_t)FX_WARPS * 4 * np * 8;  // at least 4 R rows a warp
  if (a > b) b = a;
  if (r > b) b = r;
  return (b + 127) / 128 * 128;
}

__host__ __device__ inline size_t fx_pp_bytes(int np) { return ((size_t)FX_PERMS * np + 15) / 16 * 16; }

static inline size_t fx_smem(int f_pad, int np, const Dims& d) {
  return (size_t)TB_STATES * FX_MS_ROW * 4 + fx_region_b(f_pad, np, d) + fx_pp_bytes(np) +
         TB_STATES * 8 + (size_t)FX_WARPS * MAX_NP + MAX_KS * 32 * 4 + 2 * N_FIELDS * 4;
}

// The factored form (gt as two halves [rows][2][np][2], PPERM [P][np]).
template <typename Id>
__global__ void __launch_bounds__(FX_THREADS, 1)
    fingerprint_factored(Core P, const Id* __restrict__ ids, int cap_m, long long G,
                         const int8_t* __restrict__ ct, int f_pad, int F, int nperm, MsgTab mt,
                         int region_b, Dims d, unsigned long long* __restrict__ fp_view,
                         unsigned long long* __restrict__ fp_full, const int64_t* cnt,
                         long long sub, const int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_b = f_pad + 16;
  const int np = mt.np, w2 = np * 2, w4 = np * 4;  // u32 of a half row and of a gt row
  uint32_t* msum = (uint32_t*)smem;                                  // [64][FX_MS_ROW]
  uint8_t* rb = smem + (size_t)TB_STATES * FX_MS_ROW * 4;            // region B
  uint8_t* pp = rb + region_b;                                       // [FX_PERMS][np]
  unsigned long long* masks = (unsigned long long*)(pp + fx_pp_bytes(np));
  uint8_t* qs = (uint8_t*)(masks + TB_STATES);                      // [FX_WARPS][MAX_NP]
  int* pcode = (int*)(qs + FX_WARPS * MAX_NP);                       // [f_pad]
  int* foff = pcode + MAX_KS * 32;                                   // [N_FIELDS]: 64 rows each
  int* fsz = foff + N_FIELDS;
  const long long live = live_count(cnt, sub, 1, G);
  const long long base = (long long)blockIdx.x * TB_STATES;
  if (base >= live) return;
  const int nrows = live - base < TB_STATES ? (int)(live - base) : TB_STATES;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ks_n = f_pad / 32;
  const int n_tiles = (nperm + TB_PERMS - 1) / TB_PERMS;
  const int t_lo = blockIdx.y * FX_TILES;
  const int t_hi = min(n_tiles, t_lo + FX_TILES);
  const int p_lo = t_lo * TB_PERMS, n_p = min(FX_PERMS, nperm - p_lo);

  // the block's PPERM rows (contiguous, 16-byte aligned: FX_PERMS * np is)
  {
    const uint8_t* src = mt.pperm + (long long)p_lo * np;
    const int nb = n_p * np, n16 = nb / 16;
    for (int i = threadIdx.x; i < n16; i += FX_THREADS) cp_async16(pp + i * 16, src + i * 16, 16);
    cp_async_commit();
    for (int i = n16 * 16 + threadIdx.x; i < nb; i += FX_THREADS) pp[i] = src[i];
  }
  feature_tables(pcode, foff, fsz, f_pad, F, d);
  __syncthreads();
  // the states' fields (a field's 64 rows after another's), then the features
  Segs* sg = (Segs*)(pp + fx_pp_bytes(np));  // the state masks' room until the message part
  seg_table(sg, P, ids, cap_m, foff, fsz, -1);
  __syncthreads();
  int8_t* As = (int8_t*)rb;               // [64][row_b]
  uint8_t* raw = rb + TB_STATES * row_b;  // [fields][64][its bytes]
  stage_rows<FX_THREADS, false>(raw, sg, base, nrows, idx);
  __syncthreads();
  build_features<FX_THREADS>(As, row_b, raw, pcode, nrows, f_pad);
  __syncthreads();
  const int rg = w & 3, half_w = w >> 2;
  uint32_t a[MAX_KS][4];
  load_a(a, As, row_b, rg, ks_n);
  uint64_t minv[2], minf[2];  // rows gq, gq + 8
  const int rw = region_b / FX_WARPS / (w2 * 4);  // R rows a warp
  uint32_t* R = (uint32_t*)(rb + w * (region_b / FX_WARPS));
  uint8_t* myq = qs + w * MAX_NP;
  const int vec = f_pad / 16, buf_b = 2 * FX_HCOLS * row_b;
  const int rounds = (t_hi - t_lo + 1) / 2;
  cp_async_wait<0>();  // the PPERM rows
  // channels 0-1 (fp_view), then 2-3 (fp_full)
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    uint64_t mn[2] = {~0ull, ~0ull};
    __syncthreads();  // region B (the A tile, or the last half's B tiles) is consumed
    // the message sums of the block's permutations and the half's two
    // channels, a warp a state
    for (int row = w; row < nrows; row += FX_WARPS) {
      const long long g = base + row;
      const Id* rid = ids + (idx ? idx[g] : g) * cap_m;
      unsigned long long mask;
      if (h == 0) {  // the pair digits the state's ids carry
        unsigned lo = 0, hi = 0;
        for (int j0 = 0; j0 < cap_m; j0 += 32) {
          const int id = j0 + lane < cap_m ? (int)rid[j0 + lane] : -1;
          int q = -1;
          if (id >= 0) {
            const int t = (id >= mt.off[1]) + (id >= mt.off[2]) + (id >= mt.off[3]);
            q = (id - mt.off[t]) / mt.stride[t];
          }
          lo |= __reduce_or_sync(0xFFFFFFFFu, (q >= 0 && q < 32) ? 1u << q : 0u);
          hi |= __reduce_or_sync(0xFFFFFFFFu, q >= 32 ? 1u << (q - 32) : 0u);
          if (__popc(__ballot_sync(0xFFFFFFFFu, id >= 0)) < 32) break;  // ascending, then -1
        }
        mask = ((unsigned long long)hi << 32) | lo;
        if (lane == 0) masks[row] = mask;
      } else {
        mask = masks[row];
      }
      const int n_q = __popcll(mask);
      for (int q = lane; q < 64; q += 32)
        if ((mask >> q) & 1ull) myq[__popcll(mask & ((1ull << q) - 1ull))] = (uint8_t)q;
      __syncwarp();
      // R rows of digits [b0, b0 + nr) a batch, then their fold
      for (int b0 = 0; b0 == 0 || b0 < n_q; b0 += rw) {
        const int nr = min(rw, n_q - b0);
        for (int s2 = 0; s2 < nr; ++s2)
          for (int c = lane; c < w2; c += 32) R[s2 * w2 + c] = 0u;
        uint32_t run[FX_CC];  // the current slot's running sums of this lane's columns
        int cur = -1;
        for (int j0 = 0; j0 < cap_m && nr > 0; j0 += 32) {
          const int id = j0 + lane < cap_m ? (int)rid[j0 + lane] : -1;
          int slot = -1, grow = 0;
          if (id >= 0) {
            const int t = (id >= mt.off[1]) + (id >= mt.off[2]) + (id >= mt.off[3]);
            const int rel = id - mt.off[t];
            const int q = rel / mt.stride[t];
            grow = mt.row_base[t] + rel - q * mt.stride[t];
            slot = __popcll(mask & ((1ull << q) - 1ull)) - b0;
            if (slot >= nr) slot = -1;
          }
          const int n = __popc(__ballot_sync(0xFFFFFFFFu, id >= 0));
          for (int k0 = 0; k0 < n; k0 += FX_IDS) {
            int sl[FX_IDS], gr[FX_IDS];
#pragma unroll
            for (int u = 0; u < FX_IDS; ++u) {
              const int k = (k0 + u) & 31;
              sl[u] = __shfl_sync(0xFFFFFFFFu, slot, k);
              gr[u] = __shfl_sync(0xFFFFFFFFu, grow, k);
              if (k0 + u >= n) sl[u] = -1;
            }
            uint32_t v[FX_CC][FX_IDS];
#pragma unroll
            for (int cc = 0; cc < FX_CC; ++cc)
#pragma unroll
              for (int u = 0; u < FX_IDS; ++u) {
                const int c = lane + 32 * cc;
                v[cc][u] = (c < w2 && sl[u] >= 0)
                               ? __ldg(mt.eff + (long long)gr[u] * w4 + h * w2 + c)
                               : 0u;
              }
            // ids are ascending, so a digit's ids of one type are adjacent:
            // a run of one slot sums in registers and goes to R at its end
#pragma unroll
            for (int u = 0; u < FX_IDS; ++u) {
              if (sl[u] >= 0 && sl[u] != cur) {  // uniform
                if (cur >= 0)
#pragma unroll
                  for (int cc = 0; cc < FX_CC; ++cc)
                    if (lane + 32 * cc < w2) R[cur * w2 + lane + 32 * cc] += run[cc];
                cur = sl[u];
#pragma unroll
                for (int cc = 0; cc < FX_CC; ++cc) run[cc] = 0u;
              }
#pragma unroll
              for (int cc = 0; cc < FX_CC; ++cc) run[cc] += v[cc][u];
            }
          }
          if (n < 32) break;
        }
        if (cur >= 0)
#pragma unroll
          for (int cc = 0; cc < FX_CC; ++cc)
            if (lane + 32 * cc < w2) R[cur * w2 + lane + 32 * cc] += run[cc];
        __syncwarp();
        // the fold: lane takes permutations lane + 32 i
        uint2 acc[FX_PERMS / 32];
#pragma unroll
        for (int i = 0; i < FX_PERMS / 32; ++i) {
          const int pl = lane + 32 * i;
          acc[i] = (b0 && pl < n_p) ? *(const uint2*)(msum + row * FX_MS_ROW + pl * 2)
                                    : make_uint2(0u, 0u);
        }
        for (int s2 = 0; s2 < nr; ++s2) {
          const int q = myq[b0 + s2];
          const uint2* Rs = (const uint2*)(R + s2 * w2);
#pragma unroll
          for (int i = 0; i < FX_PERMS / 32; ++i) {
            const int pl = lane + 32 * i;
            if (pl < n_p) {
              const uint2 x = Rs[pp[pl * np + q]];
              acc[i].x += x.x;
              acc[i].y += x.y;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < FX_PERMS / 32; ++i) {
          const int pl = lane + 32 * i;
          if (pl < n_p) *(uint2*)(msum + row * FX_MS_ROW + pl * 2) = acc[i];
        }
        __syncwarp();  // R is consumed before the next batch or state
      }
    }
    // the half's feature part over the block's tiles, two a round (warps
    // 0-3 the first, 4-7 the second), the next round's columns copied in
    // while this one's MMAs run, and the minima
    __syncthreads();  // the R rows are consumed
    auto stage = [&](int k) {  // round k's 2 tiles x 8 permutations x the half's 8 columns
      int8_t* B = (int8_t*)rb + (k & 1) * buf_b;
      const int tile = t_lo + 2 * k;
      for (int i = threadIdx.x; i < 2 * FX_HCOLS * vec; i += FX_THREADS) {
        const int cr = i / vec, v = i - cr * vec;
        const int p = (tile + cr / FX_HCOLS) * TB_PERMS + (cr / 8) % TB_PERMS;
        const bool ok = p < nperm;
        cp_async16(B + cr * row_b + v * 16,
                   ct + (long long)((ok ? p : 0) * 16 + 8 * h + cr % 8) * f_pad + v * 16,
                   ok ? 16 : 0);
      }
      cp_async_commit();
    };
    stage(0);
    for (int k = 0; k < rounds; ++k) {
      if (k + 1 < rounds) {
        stage(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // round k's columns are in
      const int my = t_lo + 2 * k + half_w;
      if (my < t_hi) {
        const int8_t* Bt = (const int8_t*)rb + (k & 1) * buf_b + half_w * FX_HCOLS * row_b;
        for (int pl0 = 0; pl0 < TB_PERMS; pl0 += FX_CHAINS) {
          int c[FX_CHAINS][4] = {};  // FX_CHAINS permutations' MMA chains side by side
#pragma unroll
          for (int ks = 0; ks < MAX_KS; ++ks)
            if (ks < ks_n)
#pragma unroll
              for (int u = 0; u < FX_CHAINS; ++u) {
                const int8_t* bp = Bt + ((pl0 + u) * 8 + gq) * row_b + t4 * 4 + ks * 32;
                mma_s8(c[u], a[ks], *(const uint32_t*)bp, *(const uint32_t*)(bp + 16));
              }
#pragma unroll
          for (int u = 0; u < FX_CHAINS; ++u) {
            const int p = my * TB_PERMS + pl0 + u;
            if (p >= nperm) break;  // uniform
            // lane (gq, t4): rows gq, gq + 8 at columns 2 t4, 2 t4 + 1: channel
            // 2 h + (t4 >> 1), bytes 2 (t4 & 1) and + 1
            const int sh = 16 * (t4 & 1);
            const uint32_t* ms = msum + (p - p_lo) * 2 + (t4 >> 1);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              uint32_t hv =
                  ((uint32_t)c[u][2 * r] << sh) + ((uint32_t)c[u][2 * r + 1] << (sh + 8));
              hv += __shfl_xor_sync(0xFFFFFFFFu, hv, 1);  // all four bytes
              hv += ms[(rg * 16 + gq + 8 * r) * FX_MS_ROW];
              const uint32_t o = __shfl_xor_sync(0xFFFFFFFFu, hv, 2);  // the pair's other channel
              const uint64_t x = ((uint64_t)hv << 32) | o;  // lanes t4 == 0
              mn[r] = x < mn[r] ? x : mn[r];
            }
          }
        }
      }
      __syncthreads();  // round k's buffer is consumed before round k + 2 is copied in
    }
    if (h) {
      minf[0] = mn[0];
      minf[1] = mn[1];
    } else {
      minv[0] = mn[0];
      minv[1] = mn[1];
    }
  }
  store_min(minv, minf, rg, base, live, idx, fp_view, fp_full);
}

// -- the S <= 3 form -----------------------------------------------------------------

// The shared regions of fingerprint_s3, byte offsets (each 16-B aligned):
// the feature table's used columns [nperm * 16][row_b]; the features
// [64][row_b]; two buffers (a group's, and the next group's in flight) of
// the staged fields [fields][64][their bytes] and the id lists [64][cap_m]
// (when they fit in S3_IDS_SMEM), ids at offset ids_off of a buffer; the
// message sums [64][ms] u32; the permutation sets' minima [S3_PSETS][64][2]
// u64; the segment table; the features' packed codes and the fields'
// offsets and sizes.
struct S3Layout {
  int bs, as, buf, buf_b, ids_off, msum, mins, segs, pcode, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline S3Layout s3_layout(int f_pad, int nperm, int cap_m, int id_bytes,
                                              const Dims& d) {
  S3Layout L;
  const int row_b = f_pad + 16, ids_b = TB_STATES * cap_m * id_bytes;
  L.bs = 0;
  L.as = L.bs + up16(nperm * 16 * row_b);
  L.buf = L.as + up16(TB_STATES * row_b);
  L.ids_off = ids_b <= S3_IDS_SMEM ? up16(TB_STATES * state_bytes(d)) : -1;
  L.buf_b = up16(TB_STATES * state_bytes(d)) + (L.ids_off >= 0 ? up16(ids_b) : 0);
  L.msum = L.buf + 2 * L.buf_b;
  L.mins = L.msum + up16(TB_STATES * (nperm * 4 + 4) * 4);
  L.segs = L.mins + S3_PSETS * TB_STATES * 16;
  L.pcode = L.segs + up16((int)sizeof(Segs));
  L.total = L.pcode + up16((f_pad + 2 * N_FIELDS) * 4);
  return L;
}

// The S <= 3 form (nperm <= 8: every permutation in one tile; eff
// [M][nperm][4]).  A persistent grid: each block stages the feature table's
// nperm * 16 used columns and the features' codes once, then loops over
// groups of 64 states, the next group's fields and id lists copied in by
// cp.async (stage_rows) while this one computes: the features through
// their codes (build_features); the message part with a thread a (state,
// permutation), its four channels one 16-B load of eff an id, S3_IDS ids'
// loads in flight; then warp w's MMAs for row group w & 3 over
// permutations w / 4, + 3, + 6; the three permutation sets' minima met in
// shared memory and stored once a state (SENT past live; groups of states
// wholly past live store SENT only).
template <typename Id>
__global__ void __launch_bounds__(S3_THREADS, 2)
    fingerprint_s3(Core P, const Id* __restrict__ ids, int cap_m, long long G,
                   const int8_t* __restrict__ ct, int f_pad, int F, int nperm,
                   const uint32_t* __restrict__ eff, Dims d, unsigned long long* __restrict__ fp_view,
                   unsigned long long* __restrict__ fp_full, const int64_t* cnt, long long sub,
                   const int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint8_t smem[];
  const S3Layout L = s3_layout(f_pad, nperm, cap_m, (int)sizeof(Id), d);
  const int row_b = f_pad + 16, ncols = nperm * 16, vec = f_pad / 16, ms = nperm * 4 + 4;
  int8_t* Bs = (int8_t*)(smem + L.bs);
  int8_t* As = (int8_t*)(smem + L.as);
  uint32_t* msum = (uint32_t*)(smem + L.msum);
  unsigned long long* mins = (unsigned long long*)(smem + L.mins);
  int* pcode = (int*)(smem + L.pcode);
  int* foff = pcode + f_pad;
  int* fsz = foff + N_FIELDS;
  const uint4* eff4 = (const uint4*)eff;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, gq = lane >> 2, t4 = lane & 3;
  const int rg = w & 3, pset = w >> 2, ks_n = f_pad / 32;
  const long long live = live_count(cnt, sub, 1, G);
  const long long n_groups = (G + TB_STATES - 1) / TB_STATES;
  for (int i = t; i < ncols * vec; i += S3_THREADS) {
    const int c = i / vec, v = i - c * vec;
    *(uint4*)(Bs + c * row_b + v * 16) = __ldg((const uint4*)(ct + (long long)c * f_pad) + v);
  }
  feature_tables(pcode, foff, fsz, f_pad, F, d);
  __syncthreads();
  Segs* sg = (Segs*)(smem + L.segs);
  seg_table(sg, P, ids, cap_m, foff, fsz, L.ids_off);
  __syncthreads();
  // group gi's rows into buffer k (one cp.async group a call, empty when
  // the group is past live)
  auto stage = [&](long long gi, int k) {
    const long long base = gi * TB_STATES;
    if (gi < n_groups && base < live)
      stage_rows<S3_THREADS, true>(smem + L.buf + k * L.buf_b, sg, base,
                                   (int)(live - base < TB_STATES ? live - base : TB_STATES), idx);
    cp_async_commit();
  };
  stage(blockIdx.x, 0);
  int k = 0;
  for (long long gi = blockIdx.x; gi < n_groups; gi += gridDim.x, k ^= 1) {
    const long long base = gi * TB_STATES;
    if (base >= live) {  // uniform: a group wholly past live (and every later one)
      if (!idx && t < TB_STATES && base + t < G) {
        fp_view[base + t] = ~0ull;
        fp_full[base + t] = ~0ull;
      }
      continue;
    }
    const int nrows = live - base < TB_STATES ? (int)(live - base) : TB_STATES;
    stage(gi + gridDim.x, k ^ 1);
    cp_async_wait<1>();  // this group's rows
    __syncthreads();
    const uint8_t* raw = smem + L.buf + k * L.buf_b;
    const Id* ids_s = L.ids_off >= 0 ? (const Id*)(raw + L.ids_off) : nullptr;
    build_features<S3_THREADS>(As, row_b, raw, pcode, nrows, f_pad);
    // the message sums, a thread a (state, permutation): its four channels
    for (int it = t; it < TB_STATES * nperm; it += S3_THREADS) {
      const int r = it / nperm, p = it - r * nperm;
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        const Id* sid = ids_s ? ids_s + r * cap_m : ids + (idx ? idx[base + r] : base + r) * cap_m;
        for (int j0 = 0; j0 < cap_m; j0 += S3_IDS) {
          int id[S3_IDS];
#pragma unroll
          for (int u = 0; u < S3_IDS; ++u) id[u] = j0 + u < cap_m ? (int)sid[j0 + u] : -1;
          uint4 x[S3_IDS];
#pragma unroll
          for (int u = 0; u < S3_IDS; ++u)
            x[u] = id[u] >= 0 ? __ldg(eff4 + (long long)id[u] * nperm + p)
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int u = 0; u < S3_IDS; ++u) {
            acc.x += x[u].x;
            acc.y += x[u].y;
            acc.z += x[u].z;
            acc.w += x[u].w;
          }
          if (id[S3_IDS - 1] < 0) break;  // ascending ids, then -1 pads
        }
      }
      *(uint4*)(msum + r * ms + p * 4) = acc;
    }
    __syncthreads();
    uint32_t a[S3_MAX_KS][4];
    load_a(a, As, row_b, rg, ks_n);
    uint64_t minv[2] = {~0ull, ~0ull}, minf[2] = {~0ull, ~0ull};
    for (int p = pset; p < nperm; p += S3_PSETS) {
      uint32_t m[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[j][r] = msum[(rg * 16 + gq + 8 * r) * ms + p * 4 + 2 * j + (t4 >> 1)];
      fold_perm(a, Bs + p * 16 * row_b, row_b, ks_n, m, minv, minf);
    }
    if (t4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned long long* o = mins + (pset * TB_STATES + rg * 16 + gq + 8 * r) * 2;
        o[0] = minv[r];
        o[1] = minf[r];
      }
    __syncthreads();
    if (t < TB_STATES) {
      const long long g = base + t;
      if (t < nrows) {
        unsigned long long v = ~0ull, f = ~0ull;
#pragma unroll
        for (int q = 0; q < S3_PSETS; ++q) {
          const unsigned long long* o = mins + (q * TB_STATES + t) * 2;
          v = o[0] < v ? o[0] : v;
          f = o[1] < f ? o[1] : f;
        }
        const long long st = idx ? idx[g] : g;
        fp_view[st] = v;
        fp_full[st] = f;
      } else if (!idx && g < G) {
        fp_view[g] = ~0ull;
        fp_full[g] = ~0ull;
      }
    }
    __syncthreads();  // the group's shared data is consumed
  }
  cp_async_wait<0>();
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

// fingerprint_s3's grid: as many blocks as stay resident on the card, at
// most one a group of 64 states.
static unsigned s3_grid(const void* fn, size_t smem, long long groups) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, S3_THREADS, smem);
  const long long b = (long long)sms * (per > 0 ? per : 1);
  return (unsigned)(groups < b ? groups : b);
}

template <typename Id>
static void launch_s3(const Core& P, const void* ids, int cap_m, long long G, const int8_t* ct,
                      int f_pad, int F, int nperm, const uint32_t* eff, const Dims& d,
                      unsigned long long* fv, unsigned long long* ff, const int64_t* cnt,
                      long long sub, const int64_t* idx, size_t smem, cudaStream_t st) {
  const long long groups = (G + TB_STATES - 1) / TB_STATES;
  const void* fn = (const void*)fingerprint_s3<Id>;
  fingerprint_s3<Id><<<s3_grid(fn, smem, groups), S3_THREADS, smem, st>>>(
      P, (const Id*)ids, cap_m, G, ct, f_pad, F, nperm, eff, d, fv, ff, cnt, sub, idx);
}

// ct: i8 [16 nperm][f_pad]; eff: u32 [M][nperm][4]
// (pperm null) or [rows][2][np][2] with pperm u8 [nperm][np] and type_dims =
// off[4], stride[4], row_base[4].  Lanes at or past live_count(cnt, sub, 1,
// G) get SENT.  With idx (i64 [G], the indexed mode; cnt then required)
// launch row i is state idx[i], only the outputs at idx[i] are set (to SENT
// first) and folded, and ovf (nullable) is set to 1 when the count passes G.
// The form: nperm <= 8 (S <= 3) with f_pad <= 128 fingerprint_s3, each
// state written once; the factored message part (pperm)
// fingerprint_factored; else the tiled monolithic form (S = 4, 5, 6, and
// S <= 3 with a wider feature table).  Outside fingerprint_s3 both outputs
// are set to SENT first and the blocks' minima fold in by atomicMin.
EXPORT int launch_fingerprints(const void* const* core, const void* ids, int id_bytes,
                               int cap_m, long long G, const int8_t* ct, int f_pad, int F,
                               int nperm, const uint32_t* eff, const uint8_t* pperm, int np,
                               const int* type_dims, const int* dims, int64_t* fp_view,
                               int64_t* fp_full, const int64_t* cnt, long long sub,
                               const int64_t* idx, int64_t* ovf, void* stream) {
  const Dims d = load_dims(dims);
  const bool s3 = !pperm && nperm <= S3_MAX_PERMS && f_pad <= S3_MAX_KS * 32;
  const size_t smem = pperm ? fx_smem(f_pad, np, d)
                      : s3  ? (size_t)s3_layout(f_pad, nperm, cap_m, id_bytes, d).total
                            : (size_t)(TB_STATES + TB_COLS) * (f_pad + 16) +
                                  TB_STATES * MS_STRIDE * sizeof(uint32_t);
  if (f_pad % 32 || f_pad / 32 > MAX_KS || F > f_pad || np > MAX_NP || np < 1 ||
      (pperm && 2 * np > 32 * FX_CC) ||
      smem > (size_t)(pperm ? FX_SMEM_MAX : s3 ? S3_SMEM_MAX : TB_SMEM_MAX) ||
      (s3 && (((uintptr_t)eff | (uintptr_t)ct) & 15)) ||
      (id_bytes != 2 && id_bytes != 4) || nperm < 1 || (idx && !cnt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0) return (int)cudaGetLastError();
  const int n_tiles = (nperm + TB_PERMS - 1) / TB_PERMS;
  const int tiles_a_block = pperm ? FX_TILES : TB_TILES;
  const dim3 grid((unsigned)((G + TB_STATES - 1) / TB_STATES),
                  (unsigned)((n_tiles + tiles_a_block - 1) / tiles_a_block));
  if (idx) {
    sent_at_idx<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(idx, G, cnt, sub, fp_view, fp_full,
                                                             ovf);
  } else if (!s3) {
    cudaMemsetAsync(fp_view, 0xFF, (size_t)G * sizeof(int64_t), st);
    cudaMemsetAsync(fp_full, 0xFF, (size_t)G * sizeof(int64_t), st);
  }
  const Core P = core_of(core);
  unsigned long long* fv = (unsigned long long*)fp_view;
  unsigned long long* ff = (unsigned long long*)fp_full;
  if (s3) {
    if (id_bytes == 2)
      launch_s3<int16_t>(P, ids, cap_m, G, ct, f_pad, F, nperm, eff, d, fv, ff, cnt, sub, idx,
                         smem, st);
    else
      launch_s3<int32_t>(P, ids, cap_m, G, ct, f_pad, F, nperm, eff, d, fv, ff, cnt, sub, idx,
                         smem, st);
    return (int)cudaGetLastError();
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
  if (pperm) {
    const int rb = (int)fx_region_b(f_pad, np, d);
    if (id_bytes == 2)
      fingerprint_factored<int16_t><<<grid, FX_THREADS, smem, st>>>(
          P, (const int16_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, rb, d, fv, ff, cnt, sub, idx);
    else
      fingerprint_factored<int32_t><<<grid, FX_THREADS, smem, st>>>(
          P, (const int32_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, rb, d, fv, ff, cnt, sub, idx);
  } else if (id_bytes == 2) {
    fingerprint_kernel<int16_t><<<grid, TB_THREADS, smem, st>>>(
        P, (const int16_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, d, fv, ff, cnt, sub, idx);
  } else {
    fingerprint_kernel<int32_t><<<grid, TB_THREADS, smem, st>>>(
        P, (const int32_t*)ids, cap_m, G, ct, f_pad, F, nperm, mt, d, fv, ff, cnt, sub, idx);
  }
  return (int)cudaGetLastError();
}

// Loads the kernels now (not at a first launch inside a graph capture) and
// lets them take more than 48 KB of dynamic shared memory.
EXPORT int lib_warm() {
  cudaFuncAttributes a;
  const void* mono[] = {(const void*)fingerprint_kernel<int16_t>,
                        (const void*)fingerprint_kernel<int32_t>};
  const void* fact[] = {(const void*)fingerprint_factored<int16_t>,
                        (const void*)fingerprint_factored<int32_t>};
  const void* s3[] = {(const void*)fingerprint_s3<int16_t>,
                      (const void*)fingerprint_s3<int32_t>};
  for (const void* f : mono) {
    cudaFuncGetAttributes(&a, f);
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, TB_SMEM_MAX);
  }
  for (const void* f : fact) {
    cudaFuncGetAttributes(&a, f);
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, FX_SMEM_MAX);
  }
  for (const void* f : s3) {
    cudaFuncGetAttributes(&a, f);
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, S3_SMEM_MAX);
  }
  cudaFuncGetAttributes(&a, (const void*)sent_at_idx);
  return (int)cudaGetLastError();
}
