// B11 level control: the scalar kernels of the fused whole-level program.
//
// Replaces the control part of the XLA program of
// tla_raft_tpu/engine/megakernel.py fused_level_core (:170) /
// build_level_program (:311): the while_loop's carried reductions
// (mult + m, minimum(ab, a), ovf | o), the ctrl stack (:353-362), the
// `(slab2 != SENT).sum()` conservation count, and the pidx/slot casts of
// the survivors (:363-364).  The level's lane work (guards, compaction,
// materialize, fingerprints, probe-and-insert, sieve, invariant scan) runs
// in the kernels of the other sources, each bounded by a count these
// kernels keep in the level's control words (LevelCtl in common.cuh), so
// the whole level is one CUDA graph with no host read inside.
//
// Design:
//   lv_begin     one block: the control words and the level's mult[K]
//                to their empty values; the level's parent count from a
//                device word (the caller's n_f, or the superstep's);
//   lv_gate      one block, after the chunk loop: folds the chunks'
//                compaction totals into OVF_X, and sets LIVE_LANES (the
//                lanes K4 and the fresh compaction take) to 0 when the
//                level aborted or overflowed cap_x or cap_m — the staged
//                chain inserts nothing then (engine/bfs.py expand_level);
//   lv_decide    one thread: the per-level undo flag (probe or rounds
//                overflow, more fresh states than cap_out, a cap_m
//                overflow in materialize), read by K4's gated undo;
//   slab_live    grid-stride count of the slab's live slots, a block
//                reduction and one atomic add per block;
//   lv_finalize  ctrl i64[8] in the reference's layout, and the
//                survivors' pidx u32 / slot u16 from their payloads: a
//                grid-stride loop bounded by the device word LC_N_NEW
//                (lanes past it are left as they were; every reader
//                takes [:n_new]).
//
// The grouped level (engine/group.py, the counterpart of bfs.py's
// _expand_group_gfused_impl :1144 and the grouped tail of
// _expand_level_device :3522-3690) replays one captured group program per
// group of G chunks; its control kernels keep the group's words in the
// same control vector, one control launch a group:
//   lv_group_step  one block, at the head of each group's graph: closes
//                  the previous group (its chunk totals, which stay in
//                  the chunk-total buffer until this group's chunks
//                  overwrite them, into OVF_X; its split-brain row into
//                  the level's ABORT, as a level row), then opens this
//                  one (its live rows: the level's n_f less the rows
//                  before the group, clamped to the seat; its payload
//                  base and lane offset) from the group index the
//                  previous replay left, and advances the index;
//   lv_tail_gate   one block: closes the last group as lv_group_step
//                  does, then LIVE_LANES for the level's one
//                  probe-and-insert, 0 when the level aborted or
//                  overflowed cap_x, cap_m or cap_g (nothing is inserted).
//
// Bound: bytes.  slab_live reads the slab once (8 B a slot); lv_finalize
// reads 8 B and writes 6 B a survivor (n_new of them, not the buffer's
// lanes); the rest is O(K + chunks).
#include "common.cuh"

__global__ void lv_begin(int64_t* lc, int64_t* mult, int K, const int64_t* n_run) {
  for (int i = threadIdx.x; i < LC_LEN; i += blockDim.x) lc[i] = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) mult[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    lc[LC_N_RUN] = *n_run;
    lc[LC_ABORT] = LC_BIG;
    lc[LC_BAD] = -1;
  }
}

__global__ void lv_gate(int64_t* lc, const int64_t* chunk_total, int n_chunks, long long cap_x,
                        long long chunk) {
  __shared__ int ovf;
  if (threadIdx.x == 0) ovf = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_chunks; i += blockDim.x)
    if (chunk_total[i] > cap_x) ovf = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long n_run = lc[LC_N_RUN];
    lc[LC_OVF_X] = ovf;
    const bool gate = ovf || lc[LC_OVF_MX] || lc[LC_ABORT] < n_run;
    lc[LC_LIVE_LANES] = gate ? 0 : (n_run + chunk - 1) / chunk * cap_x;
  }
}

__global__ void lv_decide(int64_t* lc, long long cap_out) {
  if (threadIdx.x || blockIdx.x) return;
  const bool undo = lc[LC_LIVE_LANES] > 0 &&
                    (lc[LC_OVF_SLAB] || lc[LC_OVF_ROUNDS] || lc[LC_N_NEW] > cap_out ||
                     lc[LC_OVF_M]);
  lc[LC_UNDO] = undo;
}

__global__ void slab_live(const unsigned long long* slab, long long cap,
                          unsigned long long* out) {
  __shared__ unsigned long long part[32];
  unsigned long long c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (long long)gridDim.x * blockDim.x)
    c += slab[i] != ~0ull;
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0;
    for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
    if (threadIdx.x == 0) atomicAdd(out, c);
  }
}

// ctrl layout: tla_raft_tpu/engine/megakernel.py:77-88.
__global__ void lv_finalize(const int64_t* lc, int64_t* ctrl, const int64_t* pay, long long n,
                            int K, uint32_t* pidx, uint16_t* slot) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[0] = lc[LC_N_NEW];
    ctrl[1] = lc[LC_ABORT];
    ctrl[2] = lc[LC_OVF_X];
    ctrl[3] = lc[LC_OVF_SLAB];
    // the port's cap_m overflow: an expanded child (whose fingerprint is
    // then void) or a materialized survivor
    ctrl[4] = lc[LC_OVF_MX] || (lc[LC_OVF_M] && lc[LC_N_NEW] > 0);
    ctrl[5] = lc[LC_BAD];
    ctrl[6] = lc[LC_SLAB_LIVE];
    ctrl[7] = lc[LC_TIER_HITS];
  }
  const long long live = live_count(lc + LC_N_NEW, 0, 1, n);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < live;
       i += (long long)gridDim.x * blockDim.x) {
    const long long y = pay[i];
    const long long q = y >= 0 ? y / K : -((-y + K - 1) / K);
    pidx[i] = (uint32_t)q;
    slot[i] = (uint16_t)(y - q * K);
  }
}

// Close group g - 1 of the level (g = lc[LC_GROUP], 0: none yet): its chunk
// totals past cap_x into OVF_X, its abort row into ABORT.  Called by one
// whole block.
__device__ void close_group(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                            long long cap_x, long long rows) {
  __shared__ int ovf;
  const long long g = lc[LC_GROUP];
  if (threadIdx.x == 0) ovf = 0;
  __syncthreads();
  if (g > 0)
    for (int i = threadIdx.x; i < n_chunks; i += blockDim.x)
      if (chunk_total[i] > cap_x) ovf = 1;
  __syncthreads();
  if (threadIdx.x == 0 && g > 0) {
    if (ovf) lc[LC_OVF_X] = 1;
    if (lc[LC_G_ABORT] < LC_BIG) {
      const long long row = (g - 1) * rows + lc[LC_G_ABORT];
      if (row < lc[LC_ABORT]) lc[LC_ABORT] = row;
    }
  }
}

__global__ void lv_group_step(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                              long long cap_x, long long rows, int K, long long cap_g) {
  close_group(lc, chunk_total, n_chunks, cap_x, rows);
  if (threadIdx.x) return;
  const long long g = lc[LC_GROUP];
  long long run = lc[LC_N_RUN] - g * rows;
  run = run < 0 ? 0 : (run > rows ? rows : run);
  lc[LC_G_RUN] = run;
  lc[LC_G_PAY] = g * rows * K;
  lc[LC_G_OUT] = g * cap_g;
  lc[LC_G_ABORT] = LC_BIG;
  lc[LC_G_TOTAL] = 0;
  lc[LC_GROUP] = g + 1;
}

__global__ void lv_tail_gate(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                             long long cap_x, long long rows, long long lanes) {
  close_group(lc, chunk_total, n_chunks, cap_x, rows);
  if (threadIdx.x) return;
  const bool gate = lc[LC_OVF_X] || lc[LC_OVF_MX] || lc[LC_OVF_G] || lc[LC_ABORT] < lc[LC_N_RUN];
  lc[LC_LIVE_LANES] = gate ? 0 : lanes;
}

static inline unsigned grid_of(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

EXPORT int lv_begin_launch(int64_t* lc, int64_t* mult, int K, const int64_t* n_run,
                           void* stream) {
  lv_begin<<<1, 256, 0, (cudaStream_t)stream>>>(lc, mult, K, n_run);
  return (int)cudaGetLastError();
}

EXPORT int lv_gate_launch(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                          long long cap_x, long long chunk, void* stream) {
  lv_gate<<<1, 256, 0, (cudaStream_t)stream>>>(lc, chunk_total, n_chunks, cap_x, chunk);
  return (int)cudaGetLastError();
}

EXPORT int lv_decide_launch(int64_t* lc, long long cap_out, void* stream) {
  lv_decide<<<1, 32, 0, (cudaStream_t)stream>>>(lc, cap_out);
  return (int)cudaGetLastError();
}

// *out += the live slots of slab (the caller zeroes it).
EXPORT int slab_live_launch(const int64_t* slab, long long cap, int64_t* out, void* stream) {
  slab_live<<<grid_of(cap), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)slab, cap, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

EXPORT int lv_finalize_launch(const int64_t* lc, int64_t* ctrl, const int64_t* pay, long long n,
                              int K, uint32_t* pidx, uint16_t* slot, void* stream) {
  lv_finalize<<<grid_of(n), 256, 0, (cudaStream_t)stream>>>(lc, ctrl, pay, n, K, pidx, slot);
  return (int)cudaGetLastError();
}

// rows = the group's seat (G * chunk parent rows), cap_g its lane slice;
// chunk_total[n_chunks] the group program's chunk totals.
EXPORT int lv_group_step_launch(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                                long long cap_x, long long rows, int K, long long cap_g,
                                void* stream) {
  lv_group_step<<<1, 256, 0, (cudaStream_t)stream>>>(lc, chunk_total, n_chunks, cap_x, rows, K,
                                                     cap_g);
  return (int)cudaGetLastError();
}

// lanes = the level's groups * cap_g.
EXPORT int lv_tail_gate_launch(int64_t* lc, const int64_t* chunk_total, int n_chunks,
                               long long cap_x, long long rows, long long lanes, void* stream) {
  lv_tail_gate<<<1, 256, 0, (cudaStream_t)stream>>>(lc, chunk_total, n_chunks, cap_x, rows,
                                                    lanes);
  return (int)cudaGetLastError();
}

WARM((const void*)lv_begin, (const void*)lv_gate, (const void*)lv_decide,
     (const void*)slab_live, (const void*)lv_finalize, (const void*)lv_group_step,
     (const void*)lv_tail_gate)
