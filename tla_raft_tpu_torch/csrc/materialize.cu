// K2 materialize: children of (parent row, slot) lanes, with their sent
// message ids and sorted message-id lists.
//
// Replaces the XLA program of tla_raft_tpu/ops/mxu_expand.py
// MXUExpand.materialize_added (:416; a one-hot [G, K] x BIG[K, 47]
// constant fetch plus masked selects per family) and materialize (:653),
// fused with engine/bfs.py JaxChecker._ids_insert (:861; sorted insertion
// of the sent ids into the parent's id list, with the cap_m overflow flag).
//
// Bound: bytes.  Lanes come in payload order, so a block's lanes share a
// few parents: each distinct parent's row and id list (64 + 2 * cap_m B at
// the reference constants, 4 * cap_m with int32 ids) is read once, and a
// lane reads its payload and writes its child's row and list, its sent ids
// and overflow flag (273 B at cap_m = 96).  The fused level's candidate
// pass over a chunk (16,384 parents, 75,206 live lanes) moves 24.7 MB,
// 0.0074 ms at 3.35 TB/s.  The work is a few dozen integer operations a
// lane and a binary search of the parent's list per sent id.
//
// Design: a block of TILE = 128 lanes, four phases.
// 1. A thread a lane decodes its (parent, slot), copies the parent's core
//    row into the block's staging area in shared memory (field-major:
//    field f of the block is one [TILE][w_f] span, as in the output),
//    applies its slot's family update there, and writes its A sent ids.
// 2. The same thread finds its id list's merge by rank (below) with a
//    binary search of the parent's ascending, -1-padded list per live sent
//    id, and keeps the new ids and their ranks in shared memory.
// 3. The block writes each field's span of its children from shared memory
//    in 16-B stores (neighbouring threads on neighbouring addresses), or
//    bytes where the span is not 16-B aligned.
// 4. A warp a lane writes the child's list: position j holds the new id
//    whose rank is j, or else parent id j - (new ranks below j), or -1
//    past the union; every list is written once, coalesced.
// A thread a lane over device memory, the first design, copied rows byte
// by byte at a lane stride of 64 B, then for every sent id scanned and
// shifted the child's whole list in device memory at a stride of 192 B:
// 0.18 ms of device time for that candidate pass (25x the bound) on an
// H100 80GB HBM3 at 700 W, where this design takes about 0.035 ms (4.6x).
//
// The merge by rank.  The child's list is the cap_m smallest ids of
// (parent ids U new ids), ascending and -1-padded, where the new ids are
// the live sent ids (0 <= id < M) not in the parent's list and not sent
// twice (the message set is a set, Raft.tla:43-45): a new id a goes to
// position lower_bound(parent, a) + (new ids below a).  The sequential
// insert of _ids_insert sets the overflow flag on any insert into a full
// list, which is exactly n_parent + n_new > cap_m; a sent id at or past M
// (only a garbage lane's) is never inserted and sets the flag when the
// list is full at its turn (n_parent + new ids before it >= cap_m), as the
// sequential loop does.
//
// Ids are int16 while M < 2^15 and int32 past it (S = 7: M = 33,768), the
// reference's id_dtype (engine/bfs.py:547); the kernel is instantiated for
// both.  Garbage lanes (indices clamped into range) compute in-range
// garbage and never fault; lanes past the live count write nothing.
#include "common.cuh"

constexpr int TILE = 128;
constexpr int A_MAX = 8;

// The block's shared memory: the children's core rows, field-major, then
// the per-lane merge plan.
struct MatPlan {
  long long par[TILE];        // parent row
  int n_par[TILE];            // real ids in the parent's list
  int n_new[TILE];            // new ids
  int nid[A_MAX][TILE];       // new ids, in sent order
  int rank[A_MAX][TILE];      // their positions in the child's list
};

template <typename Id>
__device__ inline int id_at(const Id* l, int j, int M) {
  const int v = l[j];
  return v < 0 ? M : v;
}

// Number of ids of the ascending list l[0, n) (pads read as M) below a.
template <typename Id>
__device__ inline int lower_bound(const Id* l, int n, int a, int M) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (id_at(l, mid, M) < a) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename Id>
__global__ void __launch_bounds__(TILE)
materialize_kernel(Core P, const Id* __restrict__ ids, int cap_m, long long N,
                   const int64_t* __restrict__ pidx, const int64_t* __restrict__ slots,
                   long long G, const int32_t* __restrict__ slot_tab, int K, Dims d, CoreOut C,
                   int32_t* __restrict__ added, Id* __restrict__ child_ids,
                   bool* __restrict__ ovf, const int64_t* __restrict__ pay, long long pay_base,
                   const int64_t* cnt, long long sub, long long* ovf_any) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ MatPlan plan;
  const long long live = live_count(cnt, sub, 1, G);
  const long long g0 = (long long)blockIdx.x * TILE;
  if (g0 >= live) return;
  const int nl = (int)(live - g0 < TILE ? live - g0 : TILE);
  const int t = threadIdx.x;
  const int S = d.S, T = d.T, L = d.L, V = d.V, E = d.E, M = d.M;
  const int A = S - 1 > 1 ? S - 1 : 1;

  // this lane's row of each field in the staging area
  uint8_t* R[N_FIELDS];
  {
    int off = 0;
    for (int f = 0; f < N_FIELDS; ++f) {
      const int w = field_width(d, f);
      R[f] = stage + off + t * w;
      off += TILE * w;
    }
  }

  if (t < nl) {
    const long long g = g0 + t;
    long long p, sl;
    if (pay) {  // a global payload parent * K + slot: floor division, floor mod
      const long long y = pay[g];
      const long long q = y >= 0 ? y / K : -((-y + K - 1) / K);
      p = q - pay_base;
      sl = y - q * K;
    } else {
      p = pidx[g];
      sl = slots[g];
    }
    p = p < 0 ? 0 : (p >= N ? N - 1 : p);
    sl = sl < 0 ? 0 : (sl >= K ? K - 1 : sl);
    plan.par[t] = p;

    // child := parent, in the staging area
    for (int f = 0; f < N_FIELDS; ++f) {
      const int w = field_width(d, f);
      const uint8_t* src = P.f[f] + p * w;
      for (int i = 0; i < w; ++i) R[f][i] = src[i];
    }
    const int32_t* c = slot_tab + sl * 6;
    const int fam = c[0], s = c[1], c1 = c[2], c2 = c[3], c3 = c[4], c4 = c[5];
    // the parent's values the update reads, taken before it writes
    uint8_t* lt = R[LT] + s * L;  // row s
    uint8_t* lv = R[LV] + s * L;
    uint8_t* mi = R[MI] + s * S;
    uint8_t* ni = R[NI] + s * S;
    uint8_t* pend = R[PEND] + s * S;
    const int ct_s = R[CT][s], vf_s = R[VF][s], role_s = R[ROLE][s];
    const int ll_s = R[LL][s], ci_s = R[CI][s];
    int sent[A_MAX];
    for (int a = 0; a < A_MAX; ++a) sent[a] = -1;
    const int ap_pair_stride = T * d.NPLI * 2;

    switch (fam) {
      case 0: {  // BecomeCandidate(s)
        const int nt = clampi(ct_s + 1, 1, T);
        const int lpos = ll_s - 1 < 0 ? 0 : ll_s - 1;
        const int llt = clampi(lpos < L ? lt[lpos] : 0, 0, T - 1);
        R[CT][s] = (uint8_t)nt;
        R[ROLE][s] = CANDIDATE;
        R[VF][s] = (uint8_t)(s + 1);
        R[EC][0] = (uint8_t)(R[EC][0] + 1);
        for (int r = 0; r < A; ++r) {
          const int pr = S > 1 ? pair_of(d, s, (s + 1 + r) % S) : 0;
          sent[r] = d.vq_off + pr * T * L * T + ((nt - 1) * L + (ll_s - 1)) * T + llt;
        }
        break;
      }
      case 1:  // UpdateTerm (a)
        R[VF][s] = (uint8_t)(d.become_follower && role_s == FOLLOWER ? vf_s : 0);
        R[CT][s] = (uint8_t)(c1 + 1);
        R[ROLE][s] = FOLLOWER;
        break;
      case 2:  // UpdateTerm (b)
        R[ROLE][s] = FOLLOWER;
        break;
      case 3:  // ResponseVote(s, cand = c1): vote and grant
        R[VF][s] = (uint8_t)(c1 + 1);
        sent[0] = d.vp_off + pair_of(d, s, c1) * T + (ct_s < 1 ? 1 : ct_s) - 1;
        break;
      case 4:  // BecomeLeader(s)
        R[ROLE][s] = LEADER;
        for (int u = 0; u < S; ++u) {
          mi[u] = (uint8_t)(u == s ? ll_s : 1);
          ni[u] = (uint8_t)(ll_s + 1);
          pend[u] = 0;
        }
        break;
      case 5: {  // ClientReq(s, v = c1)
        const int at = clampi(ll_s, 0, L - 1);
        lt[at] = (uint8_t)ct_s;
        lv[at] = (uint8_t)(c1 + 1);
        R[LL][s] = (uint8_t)(ll_s + 1);
        mi[s] = (uint8_t)(ll_s + 1);
        R[VS][c1] = 1;
        break;
      }
      case 6: {  // LeaderAppendEntry(s, dst = c1)
        const int nsd = ni[c1];
        const int pli = clampi(nsd - 1, 1, L);
        const int pt = clampi(lt[clampi(nsd - 2, 0, L - 1)], 0, T);
        const int epos = clampi(nsd - 1, 0, L - 1);
        const int et = clampi(lt[epos], 1, T), ev = clampi(lv[epos], 1, V);
        const int ecode = nsd <= ll_s ? 1 + (et - 1) * V + (ev - 1) : 0;
        pend[c1] = 1;
        sent[0] = d.aq_off + pair_of(d, s, c1) * T * L * (T + 1) * E * L +
                  ((((clampi(ct_s, 1, T) - 1) * L + (pli - 1)) * (T + 1) + pt) * E + ecode) * L +
                  (ci_s - 1);
        break;
      }
      case 7: {  // FollowerAcceptEntry(s, src = c1, pli = c2 + 1, e = c3, lc = c4 + 1)
        const int pli = c2 + 1, e = c3;
        const int el = e > 0;
        const int eterm = el ? (e - 1) / V + 1 : 0, evl = el ? (e - 1) % V + 1 : 0;
        const int nl7 = pli + el;
        const int pos = pli < L - 1 ? pli : L - 1;
        const bool conflict = el == 1 && pli < ll_s && (lt[pos] != eterm || lv[pos] != evl);
        if (nl7 > ll_s || conflict) {
          for (int j = 0; j < L; ++j) {  // reads entry j before it writes it
            const bool at = el == 1 && j == pos;
            lt[j] = (uint8_t)(at ? eterm : (j < pli ? lt[j] : 0));
            lv[j] = (uint8_t)(at ? evl : (j < pli ? lv[j] : 0));
          }
          R[LL][s] = (uint8_t)nl7;
        }
        const int minlc = c4 + 1 < nl7 ? c4 + 1 : nl7;
        R[CI][s] = (uint8_t)(ci_s > minlc ? ci_s : minlc);
        const int rpli = clampi(nl7, 1, L);
        sent[0] = d.ap_off + pair_of(d, s, c1) * ap_pair_stride + (rpli - d.ap_pli_min) * 2 + 1 +
                  (clampi(ct_s, 1, T) - 1) * (d.NPLI * 2);
        break;
      }
      case 8: {  // FollowerRejectEntry(s, src = c1, pli = c2 + 1): sends the reject only
        const int rej_pli = c2 + (d.legacy_append ? 0 : 1);
        sent[0] = d.ap_off + pair_of(d, s, c1) * ap_pair_stride + (rej_pli - d.ap_pli_min) * 2 +
                  (clampi(ct_s, 1, T) - 1) * (d.NPLI * 2);
        break;
      }
      case 9: {  // HandleAppendResp(s, src = c1, pli = c2 + 1, succ = c3)
        const int pli = c2 + 1, sc = c3;
        if (sc == 1) mi[c1] = (uint8_t)pli;
        ni[c1] = (uint8_t)(pli + sc);
        pend[c1] = 0;
        break;
      }
      case 10:  // LeaderCanCommit(s)
        R[CI][s] = (uint8_t)rank_median(mi, S, d.median_index);
        break;
      default:  // Restart(s)
        R[ROLE][s] = FOLLOWER;
        R[RC][0] = (uint8_t)(R[RC][0] + 1);
        break;
    }
    for (int a = 0; a < A; ++a) added[g * A + a] = sent[a];

    // the merge plan of the child's id list
    const Id* in = ids + p * cap_m;
    const int n_par = lower_bound(in, cap_m, M, M);
    int k = 0;
    bool of = false;
    for (int a = 0; a < A; ++a) {
      const int aid = sent[a];
      if (aid < 0) continue;
      if (aid >= M) {  // never inserted; a full list at its turn overflows
        of |= n_par + k >= cap_m;
        continue;
      }
      bool dup = false;
      for (int b = 0; b < a; ++b) dup |= sent[b] == aid;
      const int lb = lower_bound(in, n_par, aid, M);
      if (dup || (lb < n_par && id_at(in, lb, M) == aid)) continue;
      plan.nid[k][t] = aid;
      plan.rank[k][t] = lb;
      ++k;
    }
    for (int i = 0; i < k; ++i)  // + the new ids below it
      for (int j = 0; j < k; ++j) plan.rank[i][t] += plan.nid[j][t] < plan.nid[i][t];
    of |= n_par + k > cap_m;
    plan.n_par[t] = n_par;
    plan.n_new[t] = k;
    ovf[g] = of;
    if (of && ovf_any) *ovf_any = 1;
  }
  __syncthreads();

  // the children's core rows: each field's span of the block, coalesced
  {
    int off = 0;
    for (int f = 0; f < N_FIELDS; ++f) {
      const int w = field_width(d, f);
      const uint8_t* src = stage + off;
      uint8_t* dst = C.f[f] + g0 * w;
      const int nb = nl * w;
      if (((uintptr_t)dst & 15) == 0) {
        const int n16 = nb >> 4;
        for (int i = t; i < n16; i += TILE)
          reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
        for (int i = (n16 << 4) + t; i < nb; i += TILE) dst[i] = src[i];
      } else {
        for (int i = t; i < nb; i += TILE) dst[i] = src[i];
      }
      off += TILE * w;
    }
  }

  // the children's id lists: a warp a lane, a thread a position
  const int warp = t >> 5, ln = t & 31;
  for (int r = warp; r < nl; r += TILE / 32) {
    const Id* in = ids + plan.par[r] * cap_m;
    Id* out = child_ids + (g0 + r) * cap_m;
    const int n_par = plan.n_par[r], k = plan.n_new[r];
    for (int j = ln; j < cap_m; j += 32) {
      int below = 0, hit = -1;
      for (int i = 0; i < k; ++i) {
        const int rk = plan.rank[i][r];
        below += rk < j;
        if (rk == j) hit = plan.nid[i][r];
      }
      const int q = j - below;
      out[j] = hit >= 0 ? (Id)hit : (q < n_par ? in[q] : (Id)-1);
    }
  }
}

// Lanes are (pidx, slots), or with pay non-null the payloads
// pay = (parent + pay_base) * K + slot.  With cnt, lanes at or past
// live_count(cnt, sub, 1, G) are dead (nothing written); ovf_any (i64, may
// be null) is set to 1 when a live lane's id list overflows.  id_bytes: 2
// (int16 ids in and out) or 4 (int32).  Each parent's id list must be
// ascending and -1-padded (every frontier's is).
EXPORT int launch_materialize(const void* const* core, const void* ids, int id_bytes, int cap_m,
                              long long N, const int64_t* pidx, const int64_t* slots, long long G,
                              const int32_t* slot_tab, int K, const int* dims,
                              void* const* core_out, int32_t* added, void* child_ids,
                              bool* ovf, const int64_t* pay, long long pay_base,
                              const int64_t* cnt, long long sub, int64_t* ovf_any,
                              void* stream) {
  if (id_bytes != 2 && id_bytes != 4) return (int)cudaErrorInvalidValue;
  Core P;
  CoreOut C;
  for (int i = 0; i < N_FIELDS; ++i) {
    P.f[i] = (const uint8_t*)core[i];
    C.f[i] = (uint8_t*)core_out[i];
  }
  Dims d = load_dims(dims);
  if (d.S - 1 > A_MAX) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    int row = 0;
    for (int f = 0; f < N_FIELDS; ++f) row += field_width(d, f);
    const size_t smem = (size_t)TILE * row;
    const unsigned blocks = (unsigned)((G + TILE - 1) / TILE);
    cudaStream_t st = (cudaStream_t)stream;
    const void* fn = id_bytes == 2 ? (const void*)materialize_kernel<int16_t>
                                   : (const void*)materialize_kernel<int32_t>;
    if (smem + sizeof(MatPlan) > 48 * 1024)
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (id_bytes == 2)
      materialize_kernel<int16_t><<<blocks, TILE, smem, st>>>(
          P, (const int16_t*)ids, cap_m, N, pidx, slots, G, slot_tab, K, d, C, added,
          (int16_t*)child_ids, ovf, pay, pay_base, cnt, sub, (long long*)ovf_any);
    else
      materialize_kernel<int32_t><<<blocks, TILE, smem, st>>>(
          P, (const int32_t*)ids, cap_m, N, pidx, slots, G, slot_tab, K, d, C, added,
          (int32_t*)child_ids, ovf, pay, pay_base, cnt, sub, (long long*)ovf_any);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)materialize_kernel<int16_t>, (const void*)materialize_kernel<int32_t>)
