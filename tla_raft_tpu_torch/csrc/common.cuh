// Shared definitions of the port's CUDA kernels: the state layout, the
// config constants and the message-id encoders of ops/msg_universe.py.
//
// A batch of states is 13 row-major uint8 arrays (the core fields of
// models/raft.py, in that order) plus the message set, either as packed
// 32-bit words or as an ascending, -1-padded int16 id list.  Every entry
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
