// Shared definitions of the port's CUDA kernels: the state layout, the
// config constants and the message-id encoders of ops/msg_universe.py.
//
// A batch of states is 13 row-major uint8 arrays (the core fields of
// models/raft.py, in that order) plus the message set, either as packed
// 32-bit words or as an ascending, -1-padded id list (int16 while the
// universe has M < 2^15 ids, int32 past it; the kernels that read ids are
// instantiated for both and take the width as ``id_bytes``).  Every entry
// point has a plain C interface (for ctypes), launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

enum Field { VF, CT, ROLE, LT, LV, LL, MI, NI, CI, EC, RC, PEND, VS, N_FIELDS };

struct Core {
  const uint8_t* f[N_FIELDS];
};

struct CoreOut {
  uint8_t* f[N_FIELDS];
};

// Config constants, in the order tla_raft_tpu_torch/kernels builds them.
struct Dims {
  int S, T, L, V, E, NPLI, ap_pli_min;
  int vq_off, vp_off, aq_off, ap_off, M, n_words;
  int majority, median_index, max_election, max_restart;
  int double_vote, legacy_append, become_follower;
};

EXPORT const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// A live count read on the device: min(n, max(0, *cnt - sub) * mul), or n
// when cnt is null.  The fused level (engine/megakernel.py) sizes every
// grid at its static capacity and bounds the work by such counts, so one
// captured CUDA graph serves every frontier size: chunk rows
// (n_f - start), a chunk's flag lanes ((n_f - start) * K), compacted lanes
// (a total), a materialize slice ((n_new - start)).
__device__ inline long long live_count(const int64_t* cnt, long long sub, long long mul,
                                       long long n) {
  if (!cnt) return n;
  long long v = (long long)*cnt - sub;
  if (v <= 0) return 0;
  v *= mul;
  return v < n ? v : n;
}

// The fused level's control words (i64[LC_LEN]; engine/megakernel.py
// keeps the same numbers).  Written by the level's own kernels on the
// device, read by the host once per level (or once per superstep).
enum LevelCtl {
  LC_N_RUN = 0,       // live parent rows of the level (0: a dead level)
  LC_ABORT = 1,       // first split-brain parent, BIG if none
  LC_OVF_X = 2,       // a chunk overflowed cap_x
  LC_OVF_MX = 3,      // an expanded child overflowed cap_m (its fingerprint is void)
  LC_LIVE_LANES = 4,  // candidate lanes K4 takes (0: K4 gated off)
  LC_N_NEW = 5,       // fresh lanes (the new frontier's rows)
  LC_OVF_SLAB = 6,    // a probe window filled
  LC_OVF_M = 7,       // a materialized child overflowed cap_m
  LC_BAD = 8,         // first invariant-violating new row, -1 if none
  LC_SLAB_LIVE = 9,   // live slab slots after the level
  LC_TIER_HITS = 10,  // sieve hits among the fresh lanes
  LC_W0 = 11,         // claiming lanes, even rounds (K4's two counters)
  LC_W1 = 12,         // claiming lanes, odd rounds
  LC_K4_NEW = 13,     // K4's own fresh count
  LC_ROUNDS = 14,     // claim rounds that ran
  LC_OVF_ROUNDS = 15, // lanes still claimed after the rounds budget
  LC_UNDO = 16,       // give this level's claims back
  // the grouped level (engine/group.py): the level's words above, plus
  LC_OVF_G = 17,      // a group's unvisited lanes overflowed cap_g
  LC_GROUP = 18,      // the group the next replay runs
  LC_G_RUN = 19,      // live parent rows of the group's seat
  LC_G_PAY = 20,      // payload of the seat's row 0, slot 0: group * rows * K
  LC_G_OUT = 21,      // the group's first lane in the level's lane buffer
  LC_G_ABORT = 22,    // first split-brain row of the seat, BIG if none
  LC_G_TOTAL = 23,    // the group's unvisited lanes
  LC_LEN = 24,
};
constexpr long long LC_BIG = 1ll << 62;

// Force the module's kernels to load now (under CUDA's lazy loading a
// kernel loads at its first launch, which must not be inside a graph
// capture).
#define WARM(...)                                                        \
  EXPORT int lib_warm() {                                                \
    cudaFuncAttributes a;                                                \
    const void* fns[] = {__VA_ARGS__};                                   \
    for (const void* f : fns) cudaFuncGetAttributes(&a, f);              \
    return (int)cudaGetLastError();                                      \
  }

static inline Dims load_dims(const int* dims) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  return d;
}

// Row width (bytes per state) of each core field.
__host__ __device__ inline int field_width(const Dims& d, int f) {
  switch (f) {
    case VF: case CT: case ROLE: case LL: case CI: return d.S;
    case LT: case LV: return d.S * d.L;
    case MI: case NI: case PEND: return d.S * d.S;
    case EC: case RC: return 1;
    default: return d.V;  // VS
  }
}

enum Role { FOLLOWER = 0, CANDIDATE = 1, LEADER = 2 };

__device__ inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// (src-1, dst-1) -> the src-major pair digit of the universe layout.
__device__ inline int pair_of(const Dims& d, int a0, int b0) {
  return a0 * (d.S - 1) + (b0 - (b0 > a0 ? 1 : 0));
}

__device__ inline int vq_id(const Dims& d, int pair, int term, int lli, int llt) {
  return d.vq_off + ((pair * d.T + (term - 1)) * d.L + (lli - 1)) * d.T + llt;
}

__device__ inline int vp_id(const Dims& d, int pair, int term) {
  return d.vp_off + pair * d.T + (term - 1);
}

__device__ inline int aq_id(const Dims& d, int pair, int term, int pli, int plt, int entry,
                            int lc) {
  int x = pair * d.T + (term - 1);
  x = (x * d.L + (pli - 1)) * (d.T + 1) + plt;
  x = (x * d.E + entry) * d.L + (lc - 1);
  return d.aq_off + x;
}

__device__ inline int ap_id(const Dims& d, int pair, int term, int pli, int succ) {
  return d.ap_off + ((pair * d.T + (term - 1)) * d.NPLI + (pli - d.ap_pli_min)) * 2 + succ;
}

// Rank-select median of a row (Raft.tla:70-75): the element whose stable
// ascending position is `median_index`, 0 when none is.
__device__ inline int rank_median(const uint8_t* row, int S, int median_index) {
  int med = 0;
  for (int u = 0; u < S; ++u) {
    int pos = 0;
    for (int w = 0; w < S; ++w) {
      pos += (row[w] < row[u]) + (w < u && row[w] == row[u]);
    }
    if (pos == median_index) med += row[u];
  }
  return med;
}

// Feature e of state g: the flattening of ops/fingerprint.py FeatureSpec
// (currentTerm, role, logTerm, logVal, logLen, matchIndex, nextIndex,
// commitIndex, the votedFor one-hot, electionCount, restartCount,
// pendingResponse, valSent), as the uint8 value (callers wrap it to int8).
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
