// K1 guards: every slot's guard, multiplicity and the split-brain abort.
//
// Replaces the XLA programs of tla_raft_tpu/ops/mxu_expand.py
// MXUExpand._guard_features (:342) + guards (:398; the static guard
// conjunctions as a [B, 133] x [133, 696] matmul) and ops/dense_expand.py
// DenseExpand.msg_guard_parts (:184; the message-side terms as block
// reductions over the 4,824-bit mask).  The TPU wanted a matmul; on this
// card a switch on the slot's family is the natural form.
//
// Bound: bytes.  A parent's fields and its message set are read once (64
// B, and 604 B of packed mask, or 192 B of int16 id list at cap_m = 96, at
// the reference constants) and its valid row written once (K = 696 B):
// 952 B a parent in the id-list form every fused, grouped and superstep
// level launches (1,364 B from the mask; the per-slot sums are K words a
// launch), 0.0047 ms for a 16,384-parent chunk at 3.35 TB/s; the per-row
// form adds the i32 mult row (4 * K B).
//
// Design: a block of 256 threads takes NP parents (a group; NP from the
// shared-memory budget, 16 at S = 3).
// 1. The group's message sets and core rows are consecutive rows of the
//    inputs: the block copies the core rows into shared memory as
//    contiguous spans, and the masks either as a span of words or, in the
//    id-list form, builds them there: it zeroes the group's words and ORs
//    each live id in (id >= 0 and id / 32 < n_words, as the inflate
//    kernel of csrc/msgset.cu; OR is order-free, so the words equal
//    inflate's).  The id-list form is the inflate of
//    tla_raft_tpu/engine/bfs.py _ids_to_msgs (:833) folded into K1: the
//    fused, superstep and grouped levels launch no inflate and hold no
//    mask buffer (the inflate kernel took about 0.009 ms a chunk there and
//    K1 read its 604 B a parent back).
// 2. Per parent and (pair, term), the message counts families 1 and 2 read
//    (any message, AppendReqs) are summed once into a small table, so no
//    slot runs a long popcount loop.
// 3. FollowerAcceptEntry (family 7) is 567 of the 696 slots, and for one
//    (s, src, pli) its E * L slots (entry, leaderCommit) test E * L
//    consecutive bits of the mask under one common condition: a thread
//    takes such a run and copies the bits.  Every other slot is a thread
//    on its family's switch.  Valid flags go to a shared copy of the
//    group's valid rows, written out in 16-B stores once the group is done
//    (its rows are one contiguous span); multiplicities add into a shared
//    K-word sum, flushed as one 64-bit atomic a nonzero (block, slot):
//    integer adds are order-free, so the sums stay exact.  The first
//    aborting row is one unsigned atomic minimum a group.
// A block a parent and a thread a slot, the first design, spent its time
// on per-(parent, slot) work: each re-read its slot's table row, families 1
// and 2 re-counted their id ranges, 567 family-7 bit tests ran where 27
// runs do, and a parent's block was short (0.22 ms of device time a chunk,
// 33x the bound, on an H100 80GB HBM3 at 700 W).  This design takes about
// 0.047 ms there (7x); by ablation (scripts/torch_redesign_profile.py
// --parts k1phases) the slots off family 7 are about 36 % of it, the runs
// 25 %, the count tables 8 %, the staging and write-out 29 %.
#include "common.cuh"

constexpr int TPB = 256;
constexpr int NP_MAX = 16;
constexpr int SMEM_BUDGET = 48 * 1024;

__device__ inline int bit_at(const uint32_t* w, int id) { return (w[id >> 5] >> (id & 31)) & 1; }

// Number of set bits with ids in [a, a + n).
__device__ inline int popc_range(const uint32_t* w, int a, int n) {
  int cnt = 0;
  int e = a + n;
  while (a < e) {
    int lo = a & 31;
    int take = min(32 - lo, e - a);
    uint32_t m = take == 32 ? 0xFFFFFFFFu : (((1u << take) - 1u) << lo);
    cnt += __popc(w[a >> 5] & m);
    a += take;
  }
  return cnt;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// The block's shared memory: the per-slot sums [K], then per parent of the
// group the mask words, the (pair, term) counts (any message, AppendReqs),
// the abort flag, the core row, the valid row [K] and, in the per-row form,
// the multiplicities of the slots off family 7 [K - n7] (family 7's is its
// valid flag).
struct GroupLayout {
  int row, npt, k7, el, n7, bits_off, tab_off, ab_off, core_off, v_off, m_off, bytes;
  int o[N_FIELDS];  // byte offset of each field in a core row
  __host__ __device__ GroupLayout(const Dims& d, int K, int k7_, int n7_, int np,
                                  bool per_row) {
    const int S = d.S;
    row = 0;
    for (int f = 0; f < N_FIELDS; ++f) {
      o[f] = row;
      row += field_width(d, f);
    }
    npt = S * (S - 1) * d.T;
    // family 7's slots [k7, k7 + n7): runs of E * L (ops/successor.py
    // SlotLayout.accept_runs)
    k7 = k7_;
    n7 = n7_;
    el = d.E * d.L;
    bits_off = align16(K * 4);
    tab_off = bits_off + np * d.n_words * 4;
    ab_off = tab_off + np * npt * 2 * 4;
    core_off = ab_off + np * 4;
    v_off = align16(core_off + np * row);
    m_off = align16(v_off + np * K);
    bytes = per_row ? m_off + np * (K - n7) * 4 : v_off + np * K;
  }
};

// Guard and multiplicity of slot (fam, s, c1..c4) for one parent: its mask
// w, core row, and (pair, term) counts anyc / aqc.
__device__ inline bool eval_slot(const Dims& d, const GroupLayout& g, int fam, int s, int c1,
                                 int c2, int c3, int c4, const uint32_t* w, const uint8_t* row,
                                 const int* anyc, const int* aqc, int& m, bool& abort) {
  const int S = d.S, T = d.T, L = d.L, V = d.V, E = d.E;
  const int ct_s = row[g.o[CT] + s], role_s = row[g.o[ROLE] + s];
  const int ll_s = row[g.o[LL] + s], ci_s = row[g.o[CI] + s];
  const uint8_t* lt = row + g.o[LT] + s * L;  // row s
  const int tix = clampi(ct_s - 1, 0, T - 1);  // the term digit a message to s carries
  const bool has_term = ct_s >= 1;
  m = 1;
  switch (fam) {
    case 0:  // BecomeCandidate
      return (role_s == FOLLOWER || role_s == CANDIDATE) && row[g.o[EC]] < d.max_election;
    case 1: {  // UpdateTerm (a): any message to s at term c1 + 1
      int n = 0;
      for (int src = 0; src < S; ++src)
        if (src != s) n += anyc[pair_of(d, src, s) * T + c1];
      m = n;
      return c1 + 1 > ct_s && n > 0;
    }
    case 2: {  // UpdateTerm (b) + the split-brain Assert (Raft.tla:185)
      int n = 0;
      for (int src = 0; src < S; ++src)
        if (src != s) n += aqc[pair_of(d, src, s) * T + tix];
      m = n;
      abort = !d.become_follower && has_term && n > 0 && role_s == LEADER;
      return role_s == CANDIDATE && has_term && n > 0;
    }
    case 3: {  // ResponseVote(s, cand = c1)
      const int cand = c1;
      const int vf_s = row[g.o[VF] + s];
      const bool vf_ok = d.double_vote || vf_s == 0 || vf_s == cand + 1;
      int qual = 0, grant = 0;
      if (cand != s) {
        const int lpos = clampi(ll_s - 1, 0, L - 1);
        const int myllt = clampi(lt[lpos], 0, T);
        const int p = pair_of(d, cand, s);
        for (int l0 = 0; l0 < L; ++l0)
          for (int k2 = 0; k2 < T; ++k2)
            if (k2 > myllt || (k2 == myllt && l0 >= lpos))
              qual += bit_at(w, vq_id(d, p, tix + 1, l0 + 1, k2));
        grant = bit_at(w, vp_id(d, pair_of(d, s, cand), tix + 1));
      }
      m = qual;
      return role_s == FOLLOWER && has_term && vf_ok && cand != s && qual > 0 && grant == 0;
    }
    case 4: {  // BecomeLeader: the vote count (Raft.tla:160-164)
      int votes = 0;
      for (int src = 0; src < S; ++src)
        if (src != s) votes += bit_at(w, vp_id(d, pair_of(d, src, s), tix + 1));
      return role_s == CANDIDATE && votes + 1 >= d.majority;
    }
    case 5:  // ClientReq(s, v = c1)
      return role_s == LEADER && row[g.o[VS] + c1] == 0 && ll_s < L;
    case 6: {  // LeaderAppendEntry(s, dst = c1): the request not in flight
      const int dd = c1;
      const int nsd = row[g.o[NI] + s * S + dd];
      bool present = false;
      if (dd != s) {
        const uint8_t* lv = row + g.o[LV] + s * L;
        const int pli = clampi(nsd - 1, 1, L);
        const int plt = clampi(lt[clampi(nsd - 2, 0, L - 1)], 0, T);
        const int epos = clampi(nsd - 1, 0, L - 1);
        const int et = clampi(lt[epos], 1, T);
        const int ev = clampi(lv[epos], 1, V);
        const int ecode = nsd <= ll_s ? 1 + (et - 1) * V + (ev - 1) : 0;
        present = bit_at(w, aq_id(d, pair_of(d, s, dd), clampi(ct_s, 1, T), pli, plt, ecode,
                                  clampi(ci_s, 1, L)));
      }
      return role_s == LEADER && row[g.o[PEND] + s * S + dd] == 0 && nsd <= ll_s + 1 &&
             dd != s && !present;
    }
    // family 7, FollowerAcceptEntry, runs in guards_kernel's step 3
    case 8: {  // FollowerRejectEntry(s, src = c1, pli = c2 + 1)
      const int src = c1, l0 = c2;
      int n = 0, rej = 0;
      if (src != s) {
        const int p = pair_of(d, src, s);
        const int tot = popc_range(w, aq_id(d, p, tix + 1, l0 + 1, 0, 0, 1), (T + 1) * E * L);
        const int mplt = clampi(lt[l0], 0, T);
        const int match = popc_range(w, aq_id(d, p, tix + 1, l0 + 1, mplt, 0, 1), E * L);
        n = tot - (l0 + 1 <= ll_s ? match : 0);
        rej = bit_at(w, ap_id(d, pair_of(d, s, src), tix + 1, l0 + d.ap_pli_min, 0));
      }
      m = n;
      return role_s == FOLLOWER && has_term && src != s && n > 0 && rej == 0;
    }
    case 9: {  // HandleAppendResp(s, src = c1, pli = c2 + 1, succ = c3)
      const int src = c1, pli = c2 + 1, x = c3;
      const int msd = row[g.o[MI] + s * S + src], nsd = row[g.o[NI] + s * S + src];
      const bool st_ok = x == 1 ? msd < pli : (pli + 1 == nsd && pli > msd);
      const bool present = src != s && bit_at(w, ap_id(d, pair_of(d, src, s), tix + 1, pli, x));
      return role_s == LEADER && has_term && row[g.o[PEND] + s * S + src] == 1 && st_ok &&
             present;
    }
    case 10:  // LeaderCanCommit: the median of matchIndex[s] past commitIndex[s]
      return role_s == LEADER && rank_median(row + g.o[MI] + s * S, S, d.median_index) > ci_s;
    default:  // Restart
      return role_s == LEADER && row[g.o[RC]] < d.max_restart;
  }
}

template <typename Id>
__global__ void __launch_bounds__(TPB)
guards_kernel(Core P, const int32_t* __restrict__ msgs, const Id* __restrict__ ids, int cap_m,
              int B, int NP,
              const int32_t* __restrict__ slot_tab, int K, int k7, int n7, Dims d,
              bool* __restrict__ valid,
              int32_t* __restrict__ mult, bool* __restrict__ abort_out, const int64_t* cnt,
              long long sub, unsigned long long* __restrict__ mult_acc,
              unsigned long long* __restrict__ abort_acc, long long base) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int live = (int)live_count(cnt, sub, 1, B);
  const int b0 = blockIdx.x * NP;
  if (b0 >= live) return;
  const int np = live - b0 < NP ? live - b0 : NP;
  const int T = d.T, L = d.L, E = d.E;
  const GroupLayout g(d, K, k7, n7, NP, mult != nullptr);
  unsigned* acc = reinterpret_cast<unsigned*>(sm);
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + g.bits_off);
  int* tab = reinterpret_cast<int*>(sm + g.tab_off);  // [np][2][npt]
  int* ab = reinterpret_cast<int*>(sm + g.ab_off);
  uint8_t* core = sm + g.core_off;
  uint8_t* vrow = sm + g.v_off;
  int* msingle = reinterpret_cast<int*>(sm + g.m_off);  // [np][K - n7], per-row form
  const int t = threadIdx.x;
  const int words = d.n_words;

  // 1. the group's masks (copied, or ORed from the id lists) and core rows
  {
    if (ids) {
      for (int i = t; i < np * words; i += TPB) bits[i] = 0u;
      __syncthreads();
      const Id* src = ids + (size_t)b0 * cap_m;
      for (int i = t; i < np * cap_m; i += TPB) {
        const int id = src[i], j = i / cap_m;
        if (id >= 0 && (id >> 5) < words) atomicOr(&bits[j * words + (id >> 5)], 1u << (id & 31));
      }
    } else {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(msgs) + (size_t)b0 * words;
      for (int i = t; i < np * words; i += TPB) bits[i] = src[i];
    }
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) {
      const int w = field_width(d, f);
      const uint8_t* fs = P.f[f] + (size_t)b0 * w;
      for (int i = t; i < np * w; i += TPB) {
        const int j = i / w;
        core[j * g.row + g.o[f] + (i - j * w)] = fs[i];
      }
    }
    if (t < NP) ab[t] = 0;
    if (mult_acc)
      for (int k = t; k < K; k += TPB) acc[k] = 0;
  }
  __syncthreads();

  // 2. per parent and (pair, term): any message, AppendReqs
  const int vq_blk = L * T;                     // VoteReq ids per (pair, term)
  const int aq_term_blk = L * (T + 1) * E * L;  // AppendReq ids per (pair, term)
  const int ap_term_blk = d.NPLI * 2;           // AppendResp ids per (pair, term)
  for (int i = t; i < np * g.npt; i += TPB) {
    const int x = i / np, j = i - x * np;
    const int p = x / T, tt = x - p * T;
    const uint32_t* w = bits + j * words;
    const int aq = popc_range(w, aq_id(d, p, tt + 1, 1, 0, 0, 1), aq_term_blk);
    tab[(j * 2 + 1) * g.npt + x] = aq;
    tab[j * 2 * g.npt + x] = aq + popc_range(w, vq_id(d, p, tt + 1, 1, 0), vq_blk) +
                             bit_at(w, vp_id(d, p, tt + 1)) +
                             popc_range(w, d.ap_off + (p * T + tt) * ap_term_blk, ap_term_blk);
  }
  __syncthreads();

  // 3. the slots: off family 7 a thread a (slot, parent), neighbouring
  // threads on one slot's parents (a warp runs at most two families); on
  // family 7 a thread a (run, parent)
  const int n_other = K - g.n7, n_runs = g.n7 / g.el;
  for (int i = t; i < np * n_other; i += TPB) {
    const int x = i / np, j = i - x * np;
    const int k = x < g.k7 ? x : x + g.n7;
    const int32_t* c = slot_tab + (size_t)k * 6;
    int m;
    bool abort = false;
    const bool ok = eval_slot(d, g, c[0], c[1], c[2], c[3], c[4], c[5], bits + j * words,
                              core + j * g.row, tab + j * 2 * g.npt, tab + (j * 2 + 1) * g.npt,
                              m, abort);
    vrow[j * K + k] = ok;
    if (mult) msingle[j * n_other + x] = ok ? m : 0;
    if (mult_acc && ok && m) atomicAdd(&acc[k], (unsigned)m);
    if (abort) ab[j] = 1;
  }
  // family 7's run (s, src, pli = l0 + 1): slots k7 + run * E * L + (e * L + h0),
  // valid iff the common condition holds and bit id0 + e * L + h0 is set
  for (int i = t; i < np * n_runs; i += TPB) {
    const int run = i / np, j = i - run * np;
    const uint32_t* w = bits + j * words;
    const uint8_t* row = core + j * g.row;
    const int k0 = g.k7 + run * g.el;
    const int32_t* c = slot_tab + (size_t)k0 * 6;  // the run's (s, src, l0)
    const int s = c[1], src = c[2], l0 = c[3];
    const int ct_s = row[g.o[CT] + s], ll_s = row[g.o[LL] + s];
    const int tix = clampi(ct_s - 1, 0, T - 1);
    const bool cond = row[g.o[ROLE] + s] == FOLLOWER && ct_s >= 1 && l0 + 1 <= ll_s && src != s;
    const int plt = clampi(row[g.o[LT] + s * L + l0], 0, T);
    const int id0 = cond ? aq_id(d, pair_of(d, src, s), tix + 1, l0 + 1, plt, 0, 1) : 0;
    const int ci_s = row[g.o[CI] + s];
    uint8_t* v = vrow + j * K + k0;
    // the run's bits, low bit first (a window of two words while E * L <= 32;
    // the word past the group's last mask is in shared memory, its bits unused)
    const unsigned long long win =
        cond && g.el <= 32 ? (((unsigned long long)w[(id0 >> 5) + 1] << 32) | w[id0 >> 5]) >>
                                 (id0 & 31)
                           : 0ull;
    for (int q = 0; q < g.el; ++q) {
      bool ok = cond && (g.el <= 32 ? (win >> q) & 1 : bit_at(w, id0 + q));
      if (ok && d.legacy_append) {  // the dead FollowerAppendEntry's send-guard
        const int e = q / L, h0 = q - e * L;
        const int nl = l0 + 1 + (e > 0);
        ok = !bit_at(w, ap_id(d, pair_of(d, s, src), tix + 1, min(nl, L), 1)) ||
             min(h0 + 1, nl) > ci_s;
      }
      v[q] = ok;
      if (mult_acc && ok) atomicAdd(&acc[k0 + q], 1u);
    }
  }
  __syncthreads();

  // the group's valid rows: one contiguous span
  {
    uint8_t* dst = reinterpret_cast<uint8_t*>(valid) + (size_t)b0 * K;
    const int nb = np * K;
    if (((uintptr_t)dst & 15) == 0) {
      const int n16 = nb >> 4;
      for (int i = t; i < n16; i += TPB)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(vrow)[i];
      for (int i = (n16 << 4) + t; i < nb; i += TPB) dst[i] = vrow[i];
    } else {
      for (int i = t; i < nb; i += TPB) dst[i] = vrow[i];
    }
  }
  if (mult) {  // the group's mult rows: one contiguous span
    int32_t* dst = mult + (size_t)b0 * K;
    for (int i = t; i < np * K; i += TPB) {
      const int j = i / K, k = i - j * K;
      const int x = k < g.k7 ? k : k - g.n7;
      dst[i] = k >= g.k7 && k < g.k7 + g.n7 ? vrow[i] : msingle[j * n_other + x];
    }
  }
  if (mult_acc)
    for (int k = t; k < K; k += TPB)
      if (acc[k]) atomicAdd(&mult_acc[k], (unsigned long long)acc[k]);
  if (abort_out && t < np) abort_out[b0 + t] = ab[t] != 0;
  if (abort_acc && t == 0) {
    int first = -1;
    for (int j = np - 1; j >= 0; --j)
      if (ab[j]) first = j;
    if (first >= 0) atomicMin(abort_acc, (unsigned long long)(base + b0 + first));
  }
}

// Parents a block: the most (up to NP_MAX) whose group fits SMEM_BUDGET,
// at least one.
static int group_parents(const Dims& d, int K, int k7, int n7, bool per_row) {
  int np = NP_MAX;
  while (np > 1 && GroupLayout(d, K, k7, n7, np, per_row).bytes > SMEM_BUDGET) --np;
  return np;
}

// The parents a block of launch_guards takes, for a config's Dims and K, in
// the per-row form (mult given) or not.
EXPORT int guards_group_parents(const int* dims, int K, int k7, int n7, int per_row) {
  return group_parents(load_dims(dims), K, k7, n7, per_row != 0);
}

// The message sets: packed words msgs [B][n_words], or (ids non-null,
// msgs ignored) ascending -1-padded id lists [B][cap_m] of id_bytes (2 or
// 4) each.  mult and abort_out may be null.  With cnt, rows at or past
// live_count(cnt, sub, 1, B) are dead (nothing written); with mult_acc
// (i64[K]) each live row's per-slot multiplicities add into it, and with
// abort_acc the first aborting row (+ base) is an unsigned atomic minimum
// into it: the fused level's per-level sums, exact (integer adds and
// minima are order-free).  Family 7's slots are [k7, k7 + n7) of the slot
// table, runs of E * L slots of one (s, src, pli), (entry, leaderCommit)
// row-major (SlotLayout.accept_runs).
EXPORT int launch_guards(const void* const* core, const int32_t* msgs, const void* ids,
                         int id_bytes, int cap_m, int B,
                         const int32_t* slot_tab, int K, int k7, int n7, const int* dims,
                         bool* valid,
                         int32_t* mult, bool* abort_out, const int64_t* cnt, long long sub,
                         int64_t* mult_acc, int64_t* abort_acc, long long base, void* stream) {
  Core P;
  for (int i = 0; i < N_FIELDS; ++i) P.f[i] = (const uint8_t*)core[i];
  Dims d = load_dims(dims);
  if (ids && id_bytes != 2 && id_bytes != 4) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int np = group_parents(d, K, k7, n7, mult != nullptr);
    const int smem = GroupLayout(d, K, k7, n7, np, mult != nullptr).bytes;
    const unsigned blocks = (unsigned)((B + np - 1) / np);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute((const void*)guards_kernel<int16_t>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      cudaFuncSetAttribute((const void*)guards_kernel<int32_t>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    cudaStream_t st = (cudaStream_t)stream;
    unsigned long long* ma = (unsigned long long*)mult_acc;
    unsigned long long* aa = (unsigned long long*)abort_acc;
    if (ids && id_bytes == 4)
      guards_kernel<int32_t><<<blocks, TPB, smem, st>>>(
          P, msgs, (const int32_t*)ids, cap_m, B, np, slot_tab, K, k7, n7, d, valid, mult,
          abort_out, cnt, sub, ma, aa, base);
    else
      guards_kernel<int16_t><<<blocks, TPB, smem, st>>>(
          P, msgs, (const int16_t*)ids, cap_m, B, np, slot_tab, K, k7, n7, d, valid, mult,
          abort_out, cnt, sub, ma, aa, base);
  }
  return (int)cudaGetLastError();
}

WARM((const void*)guards_kernel<int16_t>, (const void*)guards_kernel<int32_t>)
