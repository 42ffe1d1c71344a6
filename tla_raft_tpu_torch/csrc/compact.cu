// Order-keeping compaction: the flagged lanes' values packed to a prefix.
//
// Also tla_raft_tpu/engine/bfs.py _chunk_compact (:313; canon="expand":
// a chunk's live fan-out lanes, those whose fp_view is not SENT, packed
// with fp_view, fp_full and their payloads to cap_x lanes, with the
// overflow flag): launch_chunk_compact derives the flags from fp_view in
// one pass and runs the same scan.
// Replaces the XLA programs of tla_raft_tpu/engine/bfs.py _compact_payloads
// (the valid (parent, slot) lanes of a chunk packed to cap_x candidate
// lanes, plus the overflow flag), tla_raft_tpu/ops/hashstore.py
// compact_fresh (the fresh lanes of a level's insert packed to the new
// frontier's payload list) and tla_raft_tpu/engine/bfs.py _filter_compact
// (:338; a group's unvisited candidate lanes, (fp_view, fp_full, payload),
// packed to cap_g lanes with an overflow flag: the tail of
// _group_filter_hash :374, whose probe is hs_probe in hashstore.cu).
// All three are a cumsum over the flags and a scatter of the values to
// their ranks; the order of the kept lanes is the lane order, so the
// compacted list does not depend on the chunk size.
//
// Design: the tile scan of scan.cuh, each pass a launch.
//   count    one block per tile of TILE lanes: its number of flagged lanes;
//   offsets  one block: the exclusive scan of the tile counts, and the
//            total (the number of flagged lanes);
//   scatter  one block per tile again: each flagged lane finds its rank
//            and writes its value(s) there when the rank is below cap;
//   pad      every output lane at or past the total gets the pad values,
//            and the optional lane mask is rank < total.
// The filter form (launch_filter_compact) moves three value arrays, writes
// them at a lane offset read on the device (a group's slice of the level's
// lane buffer), adds a device offset to the third (the group's payload
// base) and ORs `total > cap` into an overflow word, so it sits in the
// group's CUDA graph with no host value that changes from group to group.
// Ranks come from the scan, never from atomics, so the output is the same
// on every launch.
//
// Bound: bytes.  The flags are read twice (1 B a lane), the kept values
// once (8 B each) and written once; the pad pass writes the rest of cap.
// The integer work is a few operations per lane.
#include "compact.cuh"

// Scratch: tile i64[ceil(n / TILE)].  vb/ob and lane may be null; va null
// means the values are iota_base + lane (the chunk's payloads).  With cnt,
// only the first live_count(cnt, sub, mul, n) flag lanes count.
EXPORT long long compact_tile() { return TILE; }

EXPORT int launch_compact(const uint8_t* flags, long long n, const int64_t* va,
                          const int64_t* vb, long long pad_a, long long pad_b, long long cap,
                          int64_t* oa, int64_t* ob, bool* lane, int64_t* tile, int64_t* total,
                          const int64_t* cnt, long long sub, long long mul, long long iota_base,
                          void* stream) {
  Vals vs = {{(const long long*)va, (const long long*)vb, nullptr},
             {(long long*)oa, (long long*)ob, nullptr},
             {pad_a, pad_b, 0}};
  return run_compact(flags, n, vs, cap, lane, tile, total, cnt, sub, mul, iota_base, nullptr,
                     nullptr, nullptr, (cudaStream_t)stream);
}

// The filter compaction: keep u8[n] (the probe's unvisited live lanes);
// (cv, cf, cp) -> (ov, of, op)[*out_off + r] for r < cap, padded SENT,
// SENT, -1; op gets cp + *pay_off; *total = the kept lanes; *ovf = 1 when
// they are more than cap.  out_off, pay_off and ovf may be null.
EXPORT int launch_filter_compact(const uint8_t* keep, long long n, const int64_t* cv,
                                 const int64_t* cf, const int64_t* cp, long long cap, int64_t* ov,
                                 int64_t* of, int64_t* op, int64_t* tile, int64_t* total,
                                 const int64_t* out_off, const int64_t* pay_off, int64_t* ovf,
                                 void* stream) {
  Vals vs = {{(const long long*)cv, (const long long*)cf, (const long long*)cp},
             {(long long*)ov, (long long*)of, (long long*)op},
             {-1, -1, -1}};
  return run_compact(keep, n, vs, cap, nullptr, tile, total, nullptr, 0, 1, 0, out_off, pay_off,
                     ovf, (cudaStream_t)stream);
}

// flags[i] = fv[i] != SENT over the first live_count(cnt, sub, mul, n) lanes.
__global__ void live_flags(const int64_t* __restrict__ fv, long long n, uint8_t* __restrict__ flags,
                           const int64_t* cnt, long long sub, long long mul) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < live_count(cnt, sub, mul, n)) flags[i] = fv[i] != -1;
}

// The chunk compaction (B3 _chunk_compact): the lanes of fv i64[n] that
// are not SENT, in lane order, to (ov, of, op)[r] for r < cap: fv, ff and
// the payload iota_base + lane; padded SENT, SENT, -1.  *total = the live
// lanes; *ovf (may be null) = 1 when they are more than cap.  With cnt only
// the first live_count(cnt, sub, mul, n) lanes count.  Scratch: flags
// u8[n], tile i64[ceil(n / TILE)].
EXPORT int launch_chunk_compact(const int64_t* fv, const int64_t* ff, long long n, long long cap,
                                int64_t* ov, int64_t* of, int64_t* op, uint8_t* flags,
                                int64_t* tile, int64_t* total, int64_t* ovf, const int64_t* cnt,
                                long long sub, long long mul, long long iota_base, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) live_flags<<<blocks_of(n, THREADS), THREADS, 0, st>>>(fv, n, flags, cnt, sub, mul);
  Vals vs = {{(const long long*)fv, (const long long*)ff, nullptr},
             {(long long*)ov, (long long*)of, (long long*)op},
             {-1, -1, -1}};
  return run_compact(flags, n, vs, cap, nullptr, tile, total, cnt, sub, mul, iota_base, nullptr,
                     nullptr, ovf, st);
}

WARM((const void*)live_flags, (const void*)count_tiles, (const void*)scan_offsets, (const void*)scatter_tiles,
     (const void*)pad_tail)
