// B12 superstep commit and ring: the control kernels of the resident
// multi-level driver.
//
// Replaces the control part of the XLA program of
// tla_raft_tpu/engine/superstep.py build_superstep_program (:181): the
// while_loop's cond (:239-249), the per-level commit/stop/reason/flags
// algebra (:258-300), the drop-mode ring append at the running offset
// (:272-279), the meta_n / meta_mult writes (:280-283), the committed
// frontier select (:301-302) and the ctrl stack (:330-337).  Each level of
// the span runs the fused level's kernels (level.cu and the lane kernels)
// on a device parent count that the commit kernel sets to 0 once the loop
// has stopped, so every later level's kernels exit at once; the span's
// levels are one CUDA graph with one host read after it.
//
// Design:
//   ss_begin   one thread: the superstep words from the host's (n_f,
//              lvl_cap, ring) arguments;
//   ss_commit  one block: the level's stop / commit / reason / flags
//              exactly as superstep.py computes them (the port adds two
//              stop causes of its own: an expanded child over cap_m, and
//              K4's rounds budget), meta_n[lvl] and meta_mult[lvl, :],
//              then advances lvl, off and n_f and the running flag, and
//              leaves the ring offset (or -1) and the undo flag for the
//              next two kernels;
//   ss_append  one thread per survivor lane: fps u64 / pidx u32 / slot
//              u16 at the ring offset, only for a committed level;
//   ss_settle  the frontier select: levels alternate between two
//              frontier buffers, so after an odd number of committed
//              levels the committed frontier is copied into the first.
//
// Bound: bytes.  ss_append moves 8 + 8 B in and 14 B out a lane; ss_settle
// copies n_f frontier rows (~250 B each at the reference constants) when
// it copies at all; ss_commit moves K * 8 B.
#include "common.cuh"

enum SsWord {
  SS_LEVELS = 0, SS_REASON = 1, SS_NF = 2, SS_OFF = 3, SS_SLAB_LIVE = 4, SS_FLAGS = 5,
  SS_RUNNING = 6, SS_NRUN = 7, SS_LVL_CAP = 8, SS_APPEND = 9, SS_UNDO = 10, SS_RING = 11,
  SS_LEN = 16,
};
enum Reason { REASON_RUN = 0, REASON_STOP = 1, REASON_RING = 2, REASON_FIX = 3 };
enum Flag {
  FLAG_OVF_X = 1, FLAG_OVF_SLAB = 2, FLAG_OVF_M = 4, FLAG_OVF_OUT = 8, FLAG_ABORT = 16,
  FLAG_BAD = 32, FLAG_TIER = 128, FLAG_OVF_ROUNDS = 256,
};

__global__ void ss_begin(int64_t* ss, const int64_t* args) {
  if (threadIdx.x || blockIdx.x) return;
  for (int i = 0; i < SS_LEN; ++i) ss[i] = 0;
  ss[SS_NF] = args[0];
  ss[SS_LVL_CAP] = args[1];
  ss[SS_RUNNING] = args[1] > 0;
  ss[SS_NRUN] = args[1] > 0 ? args[0] : 0;
  ss[SS_APPEND] = -1;
  ss[SS_RING] = args[2];
}

__global__ void ss_commit(int64_t* ss, const int64_t* lc, const int64_t* mult, int K,
                          long long cap_f, int64_t* meta_n, int64_t* meta_mult,
                          int64_t* meta_rounds) {
  __shared__ long long row;
  if (threadIdx.x == 0) {
    row = -1;
    if (!ss[SS_RUNNING]) {
      ss[SS_APPEND] = -1;
      ss[SS_UNDO] = 0;
    } else {
      const long long n_f = ss[SS_NF], off = ss[SS_OFF], lvl = ss[SS_LEVELS];
      const long long n_new = lc[LC_N_NEW];
      const bool abort = lc[LC_ABORT] < n_f;
      const bool ovf_x = lc[LC_OVF_X] != 0;
      const bool ovf_slab = lc[LC_OVF_SLAB] != 0;
      const bool ovf_m = lc[LC_OVF_MX] || (lc[LC_OVF_M] && n_new > 0);
      const bool ovf_out = n_new > cap_f;
      const bool ring_ovf = off + n_new > ss[SS_RING];
      const bool tier = lc[LC_TIER_HITS] > 0;
      const bool bad = lc[LC_BAD] >= 0;
      const bool rounds = lc[LC_OVF_ROUNDS] != 0;
      const bool stop = abort || ovf_x || ovf_slab || ovf_m || ovf_out || bad || tier || rounds;
      const bool commit = !stop && !ring_ovf;
      const bool fix = commit && n_new == 0;
      const int reason =
          stop ? REASON_STOP : (ring_ovf ? REASON_RING : (fix ? REASON_FIX : REASON_RUN));
      const long long flags = ovf_x * FLAG_OVF_X + ovf_slab * FLAG_OVF_SLAB +
                              ovf_m * FLAG_OVF_M + ovf_out * FLAG_OVF_OUT +
                              abort * FLAG_ABORT + bad * FLAG_BAD + tier * FLAG_TIER +
                              rounds * FLAG_OVF_ROUNDS;
      meta_n[lvl] = n_new;
      meta_rounds[lvl] = lc[LC_ROUNDS];
      row = lvl;
      ss[SS_APPEND] = commit ? off : -1;
      // an uncommitted level gives its claims back (a gated-off K4 has
      // none: its live lane count is 0)
      ss[SS_UNDO] = !commit;
      const long long lvl2 = lvl + commit;
      ss[SS_LEVELS] = lvl2;
      ss[SS_OFF] = off + (commit ? n_new : 0);
      ss[SS_REASON] = reason;
      ss[SS_FLAGS] = stop ? flags : 0;
      ss[SS_NF] = commit ? n_new : n_f;
      const bool run = reason == REASON_RUN && lvl2 < ss[SS_LVL_CAP];
      ss[SS_RUNNING] = run;
      ss[SS_NRUN] = run ? ss[SS_NF] : 0;
    }
  }
  __syncthreads();
  if (row >= 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x) meta_mult[row * K + k] = mult[k];
}

__global__ void ss_append(const int64_t* ss, const int64_t* lc, const int64_t* fps,
                          const int64_t* pay, long long n, int K, int64_t* ring_fps,
                          uint32_t* ring_pidx, uint16_t* ring_slot) {
  const long long off = ss[SS_APPEND];
  if (off < 0) return;
  const long long n_new = lc[LC_N_NEW] < n ? lc[LC_N_NEW] : n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_new;
       i += (long long)gridDim.x * blockDim.x) {
    const long long y = pay[i];
    const long long q = y >= 0 ? y / K : -((-y + K - 1) / K);
    ring_fps[off + i] = fps[i];
    ring_pidx[off + i] = (uint32_t)q;
    ring_slot[off + i] = (uint16_t)(y - q * K);
  }
}

struct Fields {
  const uint8_t* src[16];
  uint8_t* dst[16];
  long long width[16];  // bytes per row
  int n;
};

__global__ void ss_settle(const int64_t* ss, Fields f) {
  if (!(ss[SS_LEVELS] & 1)) return;
  const long long rows = ss[SS_NF];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int j = 0; j < f.n; ++j) {
    const long long nb = rows * f.width[j];
    const long long n16 = nb / 16;
    const uint4* s = (const uint4*)f.src[j];
    uint4* d = (uint4*)f.dst[j];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n16; i += stride)
      d[i] = s[i];
    for (long long i = n16 * 16 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
         i += stride)
      f.dst[j][i] = f.src[j][i];
  }
}

static inline unsigned grid_of(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

// args i64[3] = (n_f, lvl_cap, ring), written by the host before the
// launch: the levels this superstep may commit and the ring entries it may
// use are device words, so one graph serves every --max-depth remainder and
// every ring size up to its buffers.
EXPORT int ss_begin_launch(int64_t* ss, const int64_t* args, void* stream) {
  ss_begin<<<1, 32, 0, (cudaStream_t)stream>>>(ss, args);
  return (int)cudaGetLastError();
}

EXPORT int ss_commit_launch(int64_t* ss, const int64_t* lc, const int64_t* mult, int K,
                            long long cap_f, int64_t* meta_n, int64_t* meta_mult,
                            int64_t* meta_rounds, void* stream) {
  ss_commit<<<1, 256, 0, (cudaStream_t)stream>>>(ss, lc, mult, K, cap_f, meta_n, meta_mult,
                                                 meta_rounds);
  return (int)cudaGetLastError();
}

EXPORT int ss_append_launch(const int64_t* ss, const int64_t* lc, const int64_t* fps,
                            const int64_t* pay, long long n, int K, int64_t* ring_fps,
                            uint32_t* ring_pidx, uint16_t* ring_slot, void* stream) {
  ss_append<<<grid_of(n), 256, 0, (cudaStream_t)stream>>>(ss, lc, fps, pay, n, K, ring_fps,
                                                          ring_pidx, ring_slot);
  return (int)cudaGetLastError();
}

// src/dst: n_fields row-major field buffers (16-byte aligned), width =
// bytes per row; rows = the committed n_f.
EXPORT int ss_settle_launch(const int64_t* ss, const void* const* src, void* const* dst,
                            const long long* width, int n_fields, long long max_rows,
                            void* stream) {
  if (n_fields > 16) return (int)cudaErrorInvalidValue;
  Fields f;
  long long row_b = 0;
  for (int j = 0; j < n_fields; ++j) {
    f.src[j] = (const uint8_t*)src[j];
    f.dst[j] = (uint8_t*)dst[j];
    f.width[j] = width[j];
    row_b += width[j];
  }
  f.n = n_fields;
  ss_settle<<<grid_of(max_rows * row_b / 16), 256, 0, (cudaStream_t)stream>>>(ss, f);
  return (int)cudaGetLastError();
}

WARM((const void*)ss_begin, (const void*)ss_commit, (const void*)ss_append,
     (const void*)ss_settle)
