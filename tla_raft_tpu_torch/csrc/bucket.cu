// B14: the batched bucket core of the sweep service.
//
// Replaces the bucket-specific work of the XLA programs of
// tla_raft_tpu/service/bucket.py BucketPrograms: _level_step (:176, the
// per-config MaxRestart refinement of the Restart slots, the fingerprint
// salts, the per-config gen / abort segment sums and, after the
// probe-and-insert, the per-config new segment sum), _fused_level (:236,
// the keep filter fresh & ~(done | abort)[crow]) and _superstep (:270, the
// while_loop body's retirement and commit algebra :320-399, the ring of
// inserted fingerprints and the per-level meta rows).  The level's other
// work runs in the kernels the engine already has: inflate, dense_expand
// (fingerprints of every fan-out lane, built at the bucket's largest
// MaxRestart), chunk_compact, K4, the order-keeping compactions, K2 (or
// legacy_materialize) and inv_scan.
//
// A bucket stacks the frontiers of C same-shape configs; row r belongs to
// config crow[r] and is live when r < n_run and its config is not done.
//
// Design:
//   bucket_refine  one thread per (row, slot) lane of a chunk's dense-expand
//                  output: valid &= live & (slot not Restart | rc < mr[c]);
//                  fp_view ^= salt[c] where valid, SENT elsewhere (fp_full
//                  stays unsalted: the tie-break key); per-config gen (the
//                  valid lanes' mult) and abort (a live row's split-brain
//                  flag) in shared-memory [C] accumulators, each thread
//                  keeping a running sum of its current config (rows of a
//                  config are contiguous) and one atomic per block and
//                  config at the end;
//   bucket_tally   one thread per lane of the level's lane buffer, after K4
//                  and the fresh compaction: per-config new (a shared-memory
//                  histogram of the fresh lanes' configs), the keep flags
//                  for the survivors' compaction, and the ring append of
//                  the inserted salted fingerprints (the fresh compaction's
//                  lane-ordered prefix) at the superstep's ring offset;
//   bucket_ctrl    the control words: BEGIN (one thread: the superstep's
//                  words from the host's arguments), PRE (one block: the
//                  depth-cap retirement before a level expands, the level's
//                  parent count, the accumulators zeroed), POST (block 0:
//                  the stop / ring / fixpoint reasons, the commit, the
//                  per-level meta rows, the retirement of aborts then
//                  fixpoints, depth + 1 for the members still alive, the
//                  undo flag for K4's gated undo; every block: the next
//                  frontier's crow = crow[rows] of the survivors), LEVEL
//                  (the per-level program's undo decision and the same
//                  gather).
//
// Bound: bytes.  bucket_refine reads 14 B and writes 8 B a lane (valid,
// mult, fp_view) plus 10 B a row; bucket_tally reads 9 B and writes 1 B a
// lane plus 16 B an inserted fingerprint; bucket_ctrl's gather reads 8 B
// and writes 8 B a survivor (the crow lookup is a dependent load).
#include "common.cuh"

constexpr long long SENT = -1;

enum BucketWord {
  BS_LEVELS = 0,     // committed levels (the ss_settle layout: word 0)
  BS_REASON = 1,     // stop reason (REASON_*)
  BS_NRUN = 2,       // rows of the carried frontier (the ss_settle layout: word 2)
  BS_OFF = 3,        // ring entries used by the committed levels
  BS_SLAB_LIVE = 4,  // live slab slots after the program
  BS_FLAGS = 5,      // the stopped level's cause bits (FLAG_*)
  BS_RUNNING = 6,    // the superstep's loop still runs
  BS_LRUN = 7,       // this level's parent rows (0 once stopped)
  BS_SPAN = 8,       // levels this superstep may commit
  BS_RING = 9,       // ring entries this superstep may use
  BS_UNDO = 10,      // give this level's claims back
  BS_NG = 11,        // this level's survivors (the keep compaction's total)
  BS_LEN = 16,
};
enum Reason { REASON_RUN = 0, REASON_STOP = 1, REASON_RING = 2, REASON_FIX = 3 };
enum Flag {
  FLAG_OVF_X = 1, FLAG_OVF_SLAB = 2, FLAG_OVF_M = 4, FLAG_OVF_OUT = 8, FLAG_BAD = 32,
  FLAG_OVF_ROUNDS = 256,
};
enum Phase { BC_BEGIN = 0, BC_PRE = 1, BC_POST = 2, BC_LEVEL = 3 };
constexpr int MAX_C = 1024;

__device__ inline void flush_sum(unsigned long long* sh, int c, unsigned long long v) {
  if (c >= 0 && v) atomicAdd(&sh[c], v);
}

__global__ void bucket_refine_k(const bool* __restrict__ valid, const int32_t* __restrict__ mult,
                                const bool* __restrict__ abort_row, int64_t* __restrict__ fpv,
                                const int64_t* __restrict__ crow, const uint8_t* __restrict__ rc,
                                const uint8_t* __restrict__ fam_rs,
                                const int32_t* __restrict__ mr, const int64_t* __restrict__ salt,
                                const int64_t* __restrict__ done, int C, long long rows, int K,
                                const int64_t* cnt, long long sub, int64_t* gen,
                                int64_t* abort_c) {
  extern __shared__ unsigned long long sh[];  // gen[C], then abort[C]
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) sh[c] = 0;
  __syncthreads();
  const long long n_live = live_count(cnt, sub, 1, rows);
  const long long n = rows * K;
  int cur = -1;
  unsigned long long acc = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / K;
    const int k = (int)(i - r * K);
    bool ok = false;
    int c = -1;
    if (r < n_live) {
      c = (int)crow[r];
      if (!done[c]) {
        ok = valid[i] && (!fam_rs[k] || (int)rc[r] < mr[c]);
        if (k == 0 && abort_row[r]) sh[C + c] = 1;
      }
    }
    if (ok) {
      if (c != cur) {
        flush_sum(sh, cur, acc);
        cur = c;
        acc = 0;
      }
      acc += (unsigned long long)(long long)mult[i];
      fpv[i] = (int64_t)((unsigned long long)fpv[i] ^ (unsigned long long)salt[c]);
    } else {
      fpv[i] = SENT;
    }
  }
  flush_sum(sh, cur, acc);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (sh[c]) atomicAdd((unsigned long long*)&gen[c], sh[c]);
    if (sh[C + c]) abort_c[c] = 1;
  }
}

__global__ void bucket_tally_k(const bool* __restrict__ fresh, const int64_t* __restrict__ pay,
                               long long n, const int64_t* live, const int64_t* __restrict__ crow,
                               int K, const int64_t* __restrict__ done,
                               const int64_t* __restrict__ abort_c, int C, int64_t* new_c,
                               bool* __restrict__ keep, const int64_t* __restrict__ ins,
                               const int64_t* n_ins, int64_t* ring, long long R,
                               const int64_t* ring_off) {
  extern __shared__ unsigned long long sh[];  // new[C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) sh[c] = 0;
  __syncthreads();
  const long long n_live = *live < n ? *live : n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int cur = -1;
  unsigned long long acc = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool kp = false;
    if (i < n_live && fresh[i]) {
      const int c = (int)crow[pay[i] / K];
      if (c != cur) {
        flush_sum(sh, cur, acc);
        cur = c;
        acc = 0;
      }
      ++acc;
      kp = !done[c] && !abort_c[c];
    }
    keep[i] = kp;
  }
  flush_sum(sh, cur, acc);
  if (ring) {
    // the inserted fingerprints in lane order, at the running ring offset
    // (dropped past R: the commit sees the ring overflow and stops)
    const long long off = *ring_off, m = *n_ins;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride)
      if (off + i < R) ring[off + i] = ins[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    if (sh[c]) atomicAdd((unsigned long long*)&new_c[c], sh[c]);
}

struct CtrlArgs {
  int64_t* bs;
  int64_t* lc;
  const int64_t* args;  // (n_run, span, ring)
  int64_t* done;
  int64_t* done1;
  int64_t* depth;
  const int64_t* cap;
  int64_t* gen_c;
  int64_t* new_c;
  int64_t* abort_c;
  int C;
  int64_t* m_new;  // [span, C], then m_gen, m_abort, m_ins [span], m_ng [span]
  int64_t* m_gen;
  int64_t* m_abort;
  int64_t* m_ins;
  int64_t* m_ng;
  long long g_cap;
  const int64_t* crow_in;
  int64_t* crow_out;
  const int64_t* pay;  // the survivors' payloads [g_cap]
  int K;
};

__global__ void bucket_ctrl_k(int phase, CtrlArgs a) {
  int64_t* bs = a.bs;
  const int C = a.C;
  if (phase == BC_BEGIN) {
    if (threadIdx.x || blockIdx.x) return;
    for (int i = 0; i < BS_LEN; ++i) bs[i] = 0;
    bs[BS_NRUN] = a.args[0];
    bs[BS_SPAN] = a.args[1];
    bs[BS_RING] = a.args[2];
    bs[BS_RUNNING] = a.args[1] > 0;
    return;
  }
  if (phase == BC_PRE) {
    if (blockIdx.x) return;
    const bool run = bs[BS_RUNNING] != 0;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      // depth caps retire members BEFORE the level expands (the engine's
      // break-before-expanding order)
      const bool capped = run && a.cap[c] >= 0 && a.depth[c] >= a.cap[c] && !a.done[c];
      a.done1[c] = a.done[c] || capped;
      a.gen_c[c] = 0;
      a.new_c[c] = 0;
      a.abort_c[c] = 0;
    }
    if (threadIdx.x == 0) bs[BS_LRUN] = run ? bs[BS_NRUN] : 0;
    return;
  }
  const long long n_g = bs[BS_NG];
  const int64_t* lc = a.lc;
  if (blockIdx.x == 0) {
    __shared__ int all_done, commit_s, running;
    if (threadIdx.x == 0) {
      running = bs[BS_RUNNING] != 0;
      all_done = 1;
      commit_s = 0;
    }
    __syncthreads();
    if (phase == BC_LEVEL) {
      if (threadIdx.x == 0)
        bs[BS_UNDO] = lc[LC_LIVE_LANES] > 0 &&
                      (lc[LC_OVF_SLAB] || lc[LC_OVF_ROUNDS] || n_g > a.g_cap ||
                       (lc[LC_OVF_M] && n_g > 0));
    } else if (running) {
      const long long lvl = bs[BS_LEVELS], off = bs[BS_OFF];
      const long long n_ins = lc[LC_N_NEW];
      const bool ring_ovf = off + n_ins > bs[BS_RING];
      const bool ovf_x = lc[LC_OVF_X] != 0, ovf_slab = lc[LC_OVF_SLAB] != 0;
      const bool rounds = lc[LC_OVF_ROUNDS] != 0, ovf_g = n_g > a.g_cap;
      const bool ovf_m = lc[LC_OVF_M] && n_g > 0, bad = lc[LC_BAD] >= 0;
      const bool stop = ovf_x || ovf_slab || rounds || ovf_g || ovf_m || bad;
      const bool commit = !stop && !ring_ovf;
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        a.m_new[lvl * C + c] = a.new_c[c];
        a.m_gen[lvl * C + c] = a.gen_c[c];
        a.m_abort[lvl * C + c] = a.abort_c[c] != 0;
        // bottom-of-level retirement: aborts, then fixpoints
        const bool alive = !a.done1[c], ab = a.abort_c[c] != 0;
        const bool d2 = a.done1[c] || (alive && ab) || (alive && !ab && a.new_c[c] == 0);
        if (!d2) all_done = 0;
        if (commit) {
          a.done[c] = d2;
          a.depth[c] += alive && !ab && a.new_c[c] > 0;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        a.m_ins[lvl] = n_ins;
        a.m_ng[lvl] = n_g;
        const bool fix = commit && (all_done || n_g == 0);
        const int reason =
            stop ? REASON_STOP : (ring_ovf ? REASON_RING : (fix ? REASON_FIX : REASON_RUN));
        const long long lvl2 = lvl + commit;
        bs[BS_LEVELS] = lvl2;
        bs[BS_OFF] = off + (commit ? n_ins : 0);
        bs[BS_REASON] = reason;
        bs[BS_FLAGS] = stop ? ovf_x * FLAG_OVF_X + ovf_slab * FLAG_OVF_SLAB +
                                  ovf_m * FLAG_OVF_M + ovf_g * FLAG_OVF_OUT + bad * FLAG_BAD +
                                  rounds * FLAG_OVF_ROUNDS
                            : 0;
        if (commit) bs[BS_NRUN] = n_g;
        bs[BS_RUNNING] = reason == REASON_RUN && lvl2 < bs[BS_SPAN];
        // an uncommitted level gives its claims back (a gated-off K4 has
        // none: its live lane count is 0)
        bs[BS_UNDO] = !commit;
        commit_s = commit;
      }
    } else if (threadIdx.x == 0) {
      bs[BS_UNDO] = 0;
    }
  }
  // the next frontier's configs: crow[rows] of the survivors, written into
  // the other crow buffer (the frontier ping-pongs with it)
  const long long m = n_g < a.g_cap ? n_g : a.g_cap;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x)
    a.crow_out[i] = a.crow_in[a.pay[i] / a.K];
}

static inline unsigned grid_of(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

EXPORT int bucket_refine_launch(const bool* valid, const int32_t* mult, const bool* abort_row,
                                int64_t* fpv, const int64_t* crow, const uint8_t* rc,
                                const uint8_t* fam_rs, const int32_t* mr, const int64_t* salt,
                                const int64_t* done, int C, long long rows, int K,
                                const int64_t* cnt, long long sub, int64_t* gen,
                                int64_t* abort_c, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  bucket_refine_k<<<grid_of(rows * K), 256, 2 * C * sizeof(unsigned long long),
                    (cudaStream_t)stream>>>(valid, mult, abort_row, fpv, crow, rc, fam_rs, mr,
                                            salt, done, C, rows, K, cnt, sub, gen, abort_c);
  return (int)cudaGetLastError();
}

EXPORT int bucket_tally_launch(const bool* fresh, const int64_t* pay, long long n,
                               const int64_t* live, const int64_t* crow, int K,
                               const int64_t* done, const int64_t* abort_c, int C,
                               int64_t* new_c, bool* keep, const int64_t* ins,
                               const int64_t* n_ins, int64_t* ring, long long R,
                               const int64_t* ring_off, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  bucket_tally_k<<<grid_of(n), 256, C * sizeof(unsigned long long), (cudaStream_t)stream>>>(
      fresh, pay, n, live, crow, K, done, abort_c, C, new_c, keep, ins, n_ins, ring, R,
      ring_off);
  return (int)cudaGetLastError();
}

EXPORT int bucket_ctrl_launch(int phase, int64_t* bs, int64_t* lc, const int64_t* args,
                              int64_t* done, int64_t* done1, int64_t* depth, const int64_t* cap,
                              int64_t* gen_c, int64_t* new_c, int64_t* abort_c, int C,
                              int64_t* m_new, int64_t* m_gen, int64_t* m_abort, int64_t* m_ins,
                              int64_t* m_ng, long long g_cap, const int64_t* crow_in,
                              int64_t* crow_out, const int64_t* pay, int K, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  CtrlArgs a{bs, lc, args, done, done1, depth, cap, gen_c, new_c, abort_c, C, m_new, m_gen,
             m_abort, m_ins, m_ng, g_cap, crow_in, crow_out, pay, K};
  const unsigned grid = (phase == BC_POST || phase == BC_LEVEL) ? grid_of(g_cap) : 1;
  bucket_ctrl_k<<<grid, 256, 0, (cudaStream_t)stream>>>(phase, a);
  return (int)cudaGetLastError();
}

WARM((const void*)bucket_refine_k, (const void*)bucket_tally_k, (const void*)bucket_ctrl_k)
