// K4 probe-and-insert into the open-addressing fingerprint slab, and the
// membership probe hs_probe.
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
// The host repeats claim + verify_probe while any lane still claims (the
// staged chain reads the claim count after every round).  The fused level
// cannot read the device inside its CUDA graph, so it launches a fixed
// budget of rounds (hs_rounds_dev): each round reads the number of lanes
// claiming in it from one of two counters and exits at once when it is 0,
// and clears the other counter for the next round; lanes still claiming
// after the budget raise a rounds overflow, and the engine doubles the
// budget and redoes the level.  Either way every round is its own pair of
// launches, probing the slab as it stood at the round's start.  Then
// rep_key / rep_pay / rep_fresh pick each new slot group's min-(key,
// payload) lane through two slab-sized scratch minima (unsigned on keys,
// signed on payloads), so the representative is order-free too, and
// rep_reset puts the scratch back to empty at exactly the slots this call
// touched, so the scratch is filled once per slab size, not per call.
//
// The insert works on the slab in place.  Every slot it changes was empty
// before the call and is held by a lane that won its claim (flag WON), so
// after a probe-depth overflow `undo` empties those slots and the slab is
// exactly as it was: the caller grows it and redoes the batch.  The fused
// level runs `undo` gated on a device flag (a level that stopped for any
// reason gives its claims back in the same graph).
//
// hs_probe is the read-only membership test of probe_impl (:210): each lane
// walks its probe path against the slab as it is and reports found, and
// optionally the keep flag of the group filter (live and not found) that
// the filter compaction in compact.cu takes.  The grouped level runs it
// against the slab as it was before the level (K4 inserts only in the
// level's tail).
//
// hs_live counts the slab's live slots.  It is the live-count delta of
// insert_only (B8 insert_only_impl, :325): the claim rounds above alone
// (hs_probe_first, then hs_round until no lane claims), with no
// representative pass and no undo; a lane whose probe window is full is
// skipped and raises the overflow, n_inserted is the live count after
// minus the live count before, and a load past 1/2 raises the overflow
// too.  HashStore.grow rehashes the old slab through it, as the
// reference's grow does (hashstore.py:511-531).
//
// Bound: bytes.  Each lane reads its fp, key and payload (24 B) and a
// few slab words, and writes its fresh flag; the slab traffic is random
// 8-byte accesses, a cache line each.  hs_probe reads 8 B a lane plus the
// slab words its walk touches, and writes 1 B (or 2) a lane.
#include "common.cuh"

constexpr unsigned long long SENT = ~0ull;
constexpr int PROBE_DEPTH = 64;
constexpr long long BIGP = 1ll << 62;  // the payload minimum's empty value
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 4096;  // grid-stride beyond this
enum LaneFlags { WANT = 1, PREFOUND = 2, LIVE = 4, WON = 8 };

typedef unsigned long long u64;

__device__ inline u64 mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

#define LANES(i, n)                                                                 \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += (long long)gridDim.x * blockDim.x)

// Walk fp's probe path: 1 = found at *idx, 0 = empty slot at *idx,
// -1 = the whole depth is full of other fingerprints.
__device__ inline int walk(const u64* slab, u64 cap, u64 fp, long long* idx) {
  const u64 h0 = mix64(fp) & (cap - 1);
  for (int j = 0; j < PROBE_DEPTH; ++j) {
    const u64 cur = (h0 + j) & (cap - 1);
    const u64 v = slab[cur];
    if (v == fp) { *idx = (long long)cur; return 1; }
    if (v == SENT) { *idx = (long long)cur; return 0; }
  }
  return -1;
}

// Lane bookkeeping after a walk: found -> slot, empty -> claim target
// (counted into *claims), full -> probe-depth overflow.
__device__ inline void settle(int r, long long idx, long long i, long long* slot, long long* tgt,
                              uint8_t* flags, u64* claims, u64* ovf) {
  if (r == 1) {
    slot[i] = idx;
    flags[i] &= ~WANT;
  } else if (r == 0) {
    tgt[i] = idx;
    flags[i] |= WANT;
    atomicAdd(claims, 1ull);
  } else {
    flags[i] &= ~WANT;
    *ovf = 1;
  }
}

__global__ void probe_first(const u64* slab, u64 cap, const u64* fps, long long n,
                            long long* slot, long long* tgt, uint8_t* flags, u64* claims,
                            u64* ovf, const int64_t* cnt) {
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    const u64 fp = fps[i];
    slot[i] = 0;
    flags[i] = 0;
    if (fp == SENT) continue;
    flags[i] = LIVE;
    long long idx = 0;
    const int r = walk(slab, cap, fp, &idx);
    if (r == 1) flags[i] |= PREFOUND;
    settle(r, idx, i, slot, tgt, flags, claims, ovf);
  }
}

// One round's claim.  cur counts the lanes claiming in this round: 0 ends
// the rounds (the kernel exits at once); nxt is cleared for the lanes that
// will claim in the next round, and *rounds counts the rounds that ran.
__global__ void claim(u64* slab, const u64* fps, long long n, const long long* tgt,
                      const uint8_t* flags, const u64* cur, u64* nxt, u64* rounds) {
  if (cur) {
    const u64 c = *cur;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *nxt = 0;
      if (c && rounds) *rounds += 1;
    }
    if (!c) return;
  }
  LANES(i, n) {
    if (flags[i] & WANT) atomicMin(&slab[tgt[i]], fps[i]);
  }
}

__global__ void verify_probe(const u64* slab, u64 cap, const u64* fps, long long n,
                             long long* slot, long long* tgt, uint8_t* flags, const u64* cur,
                             u64* claims, u64* ovf) {
  if (cur && !*cur) return;
  LANES(i, n) {
    if (!(flags[i] & WANT)) continue;
    const u64 fp = fps[i];
    if (slab[tgt[i]] == fp) {  // won the claim
      slot[i] = tgt[i];
      flags[i] = (flags[i] & ~WANT) | WON;
      continue;
    }
    long long idx = 0;
    settle(walk(slab, cap, fp, &idx), idx, i, slot, tgt, flags, claims, ovf);
  }
}

// Membership of every lane (one thread a lane): hit = found on its probe
// path, keep = live (not SENT) and not found; lanes past the device count
// cnt are neither.
__global__ void probe_keep(const u64* slab, u64 cap, const u64* fps, long long n, bool* hit,
                           uint8_t* keep, const int64_t* cnt) {
  const long long live = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    const u64 fp = fps[i];
    bool found = false;
    if (i < live && fp != SENT) {
      long long idx = 0;
      found = walk(slab, cap, fp, &idx) == 1;
    }
    if (hit) hit[i] = found;
    if (keep) keep[i] = i < live && fp != SENT && !found;
  }
}

__device__ inline bool group_new(uint8_t fl) { return (fl & LIVE) && !(fl & PREFOUND); }

__global__ void rep_key(const u64* keys, long long n, const long long* slot,
                        const uint8_t* flags, u64* m1, const int64_t* cnt) {
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    if (group_new(flags[i])) atomicMin(&m1[slot[i]], keys[i]);
  }
}

__global__ void rep_pay(const u64* keys, const long long* pays, long long n,
                        const long long* slot, const uint8_t* flags, const u64* m1,
                        long long* m2, const int64_t* cnt) {
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    if (group_new(flags[i]) && m1[slot[i]] == keys[i]) atomicMin(&m2[slot[i]], pays[i]);
  }
}

__global__ void rep_fresh(const u64* keys, const long long* pays, long long n,
                          const long long* slot, const uint8_t* flags, const u64* m1,
                          const long long* m2, bool* fresh, u64* n_new, const int64_t* cnt) {
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    const bool f = group_new(flags[i]) && m1[slot[i]] == keys[i] && m2[slot[i]] == pays[i];
    fresh[i] = f;
    if (f) atomicAdd(n_new, 1ull);
  }
}

__global__ void rep_reset(long long n, const long long* slot, const uint8_t* flags, u64* m1,
                          long long* m2, const int64_t* cnt) {
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    if (group_new(flags[i])) {
      m1[slot[i]] = SENT;
      m2[slot[i]] = BIGP;
    }
  }
}

__global__ void undo(u64* slab, long long n, const long long* slot, const uint8_t* flags,
                     const int64_t* cnt, const int64_t* cond) {
  if (cond && !*cond) return;
  n = live_count(cnt, 0, 1, n);
  LANES(i, n) {
    if (flags[i] & WON) slab[slot[i]] = SENT;
  }
}

// The live (non-SENT) slots of the slab, added to *out.  Each thread counts
// its grid-stride share, each warp sums by shuffles, and one atomic a warp
// adds it: an integer sum, the same in any order.
__global__ void live_slots(const u64* slab, long long cap, u64* out) {
  u64 c = 0;
  LANES(i, cap) c += slab[i] != SENT;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out, c);
}

// Rounds exhausted: lanes still claim after the last round of the budget.
__global__ void rounds_left(const u64* cur, int64_t* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) *out = *cur ? 1 : 0;
}

static inline unsigned grid_of(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// claims counts the lanes that claim in the first round, ovf is set on a
// probe-depth overflow (the host loop passes ctr[0] and ctr[1] of its
// ctr = [claiming, overflow, n_new]).  cnt (may be null) bounds the live
// lanes at every step.
EXPORT int hs_probe_first(const int64_t* slab, long long cap, const int64_t* fps, long long n,
                          int64_t* slot, int64_t* tgt, uint8_t* flags, int64_t* claims,
                          int64_t* ovf, const int64_t* cnt, void* stream) {
  if (n > 0)
    probe_first<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)slab, (u64)cap, (const u64*)fps, n, (long long*)slot, (long long*)tgt,
        flags, (u64*)claims, (u64*)ovf, cnt);
  return (int)cudaGetLastError();
}

// One round of the host-driven loop: claim, then verify_probe.
EXPORT int hs_round(int64_t* slab, long long cap, const int64_t* fps, long long n,
                    int64_t* slot, int64_t* tgt, uint8_t* flags, int64_t* ctr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(ctr, 0, sizeof(int64_t), st);
  claim<<<grid_of(n), THREADS, 0, st>>>((u64*)slab, (const u64*)fps, n, (const long long*)tgt,
                                        flags, nullptr, nullptr, nullptr);
  verify_probe<<<grid_of(n), THREADS, 0, st>>>(
      (const u64*)slab, (u64)cap, (const u64*)fps, n, (long long*)slot, (long long*)tgt, flags,
      nullptr, (u64*)ctr, (u64*)ctr + 1);
  return (int)cudaGetLastError();
}

// The fused level's rounds: `budget` rounds without a host read.  w[0] holds
// the claims of round 0 (from hs_probe_first), w[0]/w[1] alternate after
// that; ovf is the probe-depth overflow word, rounds counts the rounds that
// ran, left (i64) is set to 1 when lanes still claim after the budget.
EXPORT int hs_rounds_dev(int64_t* slab, long long cap, const int64_t* fps, long long n,
                         int64_t* slot, int64_t* tgt, uint8_t* flags, int64_t* w, int64_t* ovf,
                         int64_t* rounds, int64_t* left, int budget, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  u64* ww = (u64*)w;
  for (int r = 0; r < budget; ++r) {
    u64* cur = ww + (r & 1);
    u64* nxt = ww + ((r + 1) & 1);
    claim<<<grid_of(n), THREADS, 0, st>>>((u64*)slab, (const u64*)fps, n,
                                          (const long long*)tgt, flags, cur, nxt, (u64*)rounds);
    verify_probe<<<grid_of(n), THREADS, 0, st>>>((const u64*)slab, (u64)cap, (const u64*)fps, n,
                                                 (long long*)slot, (long long*)tgt, flags, cur,
                                                 nxt, (u64*)ovf);
  }
  rounds_left<<<1, 32, 0, st>>>(ww + (budget & 1), left);
  return (int)cudaGetLastError();
}

// Scratch m1 (all ones) and m2 (BIGP) come in empty and go out empty.
EXPORT int hs_represent(const int64_t* keys, const int64_t* pays, long long n,
                        const int64_t* slot, const uint8_t* flags, int64_t* m1, int64_t* m2,
                        bool* fresh, int64_t* n_new, const int64_t* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    const u64* k = (const u64*)keys;
    const long long* s = (const long long*)slot;
    rep_key<<<grid_of(n), THREADS, 0, st>>>(k, n, s, flags, (u64*)m1, cnt);
    rep_pay<<<grid_of(n), THREADS, 0, st>>>(k, (const long long*)pays, n, s, flags,
                                            (const u64*)m1, (long long*)m2, cnt);
    rep_fresh<<<grid_of(n), THREADS, 0, st>>>(k, (const long long*)pays, n, s, flags,
                                              (const u64*)m1, (const long long*)m2, fresh,
                                              (u64*)n_new, cnt);
    rep_reset<<<grid_of(n), THREADS, 0, st>>>(n, s, flags, (u64*)m1, (long long*)m2, cnt);
  }
  return (int)cudaGetLastError();
}

// Membership without insert: hit bool[n] and/or keep u8[n] (either may be
// null); cnt (may be null) bounds the live lanes.
EXPORT int hs_probe(const int64_t* slab, long long cap, const int64_t* fps, long long n,
                    bool* hit, uint8_t* keep, const int64_t* cnt, void* stream) {
  if (n > 0)
    probe_keep<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)slab, (u64)cap, (const u64*)fps, n, hit, keep, cnt);
  return (int)cudaGetLastError();
}

// *out = the slab's live slots (insert_only's counts before and after).
EXPORT int hs_live(const int64_t* slab, long long cap, int64_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(int64_t), st);
  if (cap > 0) live_slots<<<grid_of(cap), THREADS, 0, st>>>((const u64*)slab, cap, (u64*)out);
  return (int)cudaGetLastError();
}

// Empties the slots this call's lanes won; with cond (i64), only when *cond.
EXPORT int hs_undo(int64_t* slab, long long n, const int64_t* slot, const uint8_t* flags,
                   const int64_t* cnt, const int64_t* cond, void* stream) {
  if (n > 0)
    undo<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>((u64*)slab, n,
                                                           (const long long*)slot, flags, cnt,
                                                           cond);
  return (int)cudaGetLastError();
}

WARM((const void*)probe_first, (const void*)claim, (const void*)verify_probe,
     (const void*)rep_key, (const void*)rep_pay, (const void*)rep_fresh, (const void*)rep_reset,
     (const void*)undo, (const void*)rounds_left, (const void*)probe_keep,
     (const void*)live_slots)
