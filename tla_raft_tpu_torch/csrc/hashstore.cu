// K4 probe-and-insert into the open-addressing fingerprint slab.
//
// Replaces the XLA program of tla_raft_tpu/ops/hashstore.py
// probe_and_insert_impl (_probe_rounds + _claim_loop: a while_loop of
// windowed gathers and scatter-min claims, then two scatter-min passes for
// the min-(key, payload) representative of each new fingerprint).
//
// Design: the reference's rounds, kept exactly, as separate launches so the
// slab layout cannot depend on thread timing:
//   probe_first     every live lane walks its probe path against the slab
//                   as passed in (this is also the pre-call membership
//                   test): found -> its slot; an empty slot -> a claim
//                   target; 64 full slots -> probe-depth overflow;
//   claim           every claiming lane atomicMin's its fp into its target;
//   verify_probe    a lane whose fp now sits in its target has won; a lane
//                   that lost walks again against the slab as it stands
//                   after the claims (the next round's probe).
// The host repeats claim + verify_probe while any lane still claims.  Then
// rep_key / rep_pay / rep_fresh pick each new slot group's min-(key,
// payload) lane through two slab-sized scratch minima (unsigned on keys,
// signed on payloads), so the representative is order-free too, and
// rep_reset puts the scratch back to empty at exactly the slots this call
// touched, so the scratch is filled once per slab size, not per call.
//
// The insert works on the slab in place.  Every slot it changes was empty
// before the call and is held by a lane that won its claim (flag WON), so
// after a probe-depth overflow `undo` empties those slots and the slab is
// exactly as it was: the caller grows it and redoes the batch.
//
// Bound: bytes.  Each lane reads its fp, key and payload (24 B) and a
// few slab words, and writes its fresh flag; the slab traffic is random
// 8-byte accesses, a cache line each.
#include "common.cuh"

constexpr unsigned long long SENT = ~0ull;
constexpr int PROBE_DEPTH = 64;
constexpr long long BIGP = 1ll << 62;  // the payload minimum's empty value
enum LaneFlags { WANT = 1, PREFOUND = 2, LIVE = 4, WON = 8 };

__device__ inline unsigned long long mix64(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Walk fp's probe path: 1 = found at *idx, 0 = empty slot at *idx,
// -1 = the whole depth is full of other fingerprints.
__device__ inline int walk(const unsigned long long* slab, unsigned long long cap,
                           unsigned long long fp, long long* idx) {
  const unsigned long long h0 = mix64(fp) & (cap - 1);
  for (int j = 0; j < PROBE_DEPTH; ++j) {
    const unsigned long long cur = (h0 + j) & (cap - 1);
    const unsigned long long v = slab[cur];
    if (v == fp) { *idx = (long long)cur; return 1; }
    if (v == SENT) { *idx = (long long)cur; return 0; }
  }
  return -1;
}

// Lane bookkeeping after a walk: found -> slot, empty -> claim target.
__device__ inline void settle(int r, long long idx, long long i, long long* slot,
                              long long* tgt, uint8_t* flags, unsigned long long* ctr) {
  if (r == 1) {
    slot[i] = idx;
    flags[i] &= ~WANT;
  } else if (r == 0) {
    tgt[i] = idx;
    flags[i] |= WANT;
    atomicAdd(&ctr[0], 1ull);
  } else {
    flags[i] &= ~WANT;
    ctr[1] = 1;  // probe-depth overflow
  }
}

__global__ void probe_first(const unsigned long long* slab, unsigned long long cap,
                            const unsigned long long* fps, long long n, long long* slot,
                            long long* tgt, uint8_t* flags, unsigned long long* ctr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long fp = fps[i];
  slot[i] = 0;
  flags[i] = 0;
  if (fp == SENT) return;
  flags[i] = LIVE;
  long long idx = 0;
  const int r = walk(slab, cap, fp, &idx);
  if (r == 1) flags[i] |= PREFOUND;
  settle(r, idx, i, slot, tgt, flags, ctr);
}

__global__ void claim(unsigned long long* slab, const unsigned long long* fps, long long n,
                      const long long* tgt, const uint8_t* flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(flags[i] & WANT)) return;
  atomicMin(&slab[tgt[i]], fps[i]);
}

__global__ void verify_probe(const unsigned long long* slab, unsigned long long cap,
                             const unsigned long long* fps, long long n, long long* slot,
                             long long* tgt, uint8_t* flags, unsigned long long* ctr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(flags[i] & WANT)) return;
  const unsigned long long fp = fps[i];
  if (slab[tgt[i]] == fp) {  // won the claim
    slot[i] = tgt[i];
    flags[i] = (flags[i] & ~WANT) | WON;
    return;
  }
  long long idx = 0;
  settle(walk(slab, cap, fp, &idx), idx, i, slot, tgt, flags, ctr);
}

__device__ inline bool group_new(uint8_t fl) { return (fl & LIVE) && !(fl & PREFOUND); }

__global__ void rep_key(const unsigned long long* keys, long long n, const long long* slot,
                        const uint8_t* flags, unsigned long long* m1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !group_new(flags[i])) return;
  atomicMin(&m1[slot[i]], keys[i]);
}

__global__ void rep_pay(const unsigned long long* keys, const long long* pays, long long n,
                        const long long* slot, const uint8_t* flags,
                        const unsigned long long* m1, long long* m2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !group_new(flags[i]) || m1[slot[i]] != keys[i]) return;
  atomicMin(&m2[slot[i]], pays[i]);
}

__global__ void rep_fresh(const unsigned long long* keys, const long long* pays, long long n,
                          const long long* slot, const uint8_t* flags,
                          const unsigned long long* m1, const long long* m2, bool* fresh,
                          unsigned long long* ctr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool f = group_new(flags[i]) && m1[slot[i]] == keys[i] && m2[slot[i]] == pays[i];
  fresh[i] = f;
  if (f) atomicAdd(&ctr[2], 1ull);
}

__global__ void rep_reset(long long n, const long long* slot, const uint8_t* flags,
                          unsigned long long* m1, long long* m2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !group_new(flags[i])) return;
  m1[slot[i]] = SENT;
  m2[slot[i]] = BIGP;
}

__global__ void undo(unsigned long long* slab, long long n, const long long* slot,
                     const uint8_t* flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && (flags[i] & WON)) slab[slot[i]] = SENT;
}

static inline unsigned grid_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ctr[0] = lanes that claim this round, ctr[1] = overflow, ctr[2] = n_new.
EXPORT int hs_probe_first(const int64_t* slab, long long cap, const int64_t* fps, long long n,
                          int64_t* slot, int64_t* tgt, uint8_t* flags, int64_t* ctr,
                          void* stream) {
  if (n > 0)
    probe_first<<<grid_of(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)slab, (unsigned long long)cap,
        (const unsigned long long*)fps, n, (long long*)slot, (long long*)tgt, flags,
        (unsigned long long*)ctr);
  return (int)cudaGetLastError();
}

EXPORT int hs_round(int64_t* slab, long long cap, const int64_t* fps, long long n,
                    int64_t* slot, int64_t* tgt, uint8_t* flags, int64_t* ctr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(ctr, 0, sizeof(int64_t), st);
  claim<<<grid_of(n, 256), 256, 0, st>>>((unsigned long long*)slab,
                                         (const unsigned long long*)fps, n,
                                         (const long long*)tgt, flags);
  verify_probe<<<grid_of(n, 256), 256, 0, st>>>(
      (const unsigned long long*)slab, (unsigned long long)cap, (const unsigned long long*)fps,
      n, (long long*)slot, (long long*)tgt, flags, (unsigned long long*)ctr);
  return (int)cudaGetLastError();
}

// Scratch m1 (all ones) and m2 (BIGP) come in empty and go out empty.
EXPORT int hs_represent(const int64_t* keys, const int64_t* pays, long long n,
                        const int64_t* slot, const uint8_t* flags, int64_t* m1, int64_t* m2,
                        bool* fresh, int64_t* ctr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    const unsigned long long* k = (const unsigned long long*)keys;
    const long long* s = (const long long*)slot;
    rep_key<<<grid_of(n, 256), 256, 0, st>>>(k, n, s, flags, (unsigned long long*)m1);
    rep_pay<<<grid_of(n, 256), 256, 0, st>>>(k, (const long long*)pays, n, s, flags,
                                             (const unsigned long long*)m1, (long long*)m2);
    rep_fresh<<<grid_of(n, 256), 256, 0, st>>>(k, (const long long*)pays, n, s, flags,
                                               (const unsigned long long*)m1,
                                               (const long long*)m2, fresh,
                                               (unsigned long long*)ctr);
    rep_reset<<<grid_of(n, 256), 256, 0, st>>>(n, s, flags, (unsigned long long*)m1,
                                               (long long*)m2);
  }
  return (int)cudaGetLastError();
}

EXPORT int hs_undo(int64_t* slab, long long n, const int64_t* slot, const uint8_t* flags,
                   void* stream) {
  if (n > 0)
    undo<<<grid_of(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)slab, n, (const long long*)slot, flags);
  return (int)cudaGetLastError();
}
