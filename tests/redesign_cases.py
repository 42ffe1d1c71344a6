"""Seeded edge-case inputs of the redesigned kernels, and numpy models of
their routes, in numpy (no JAX and no port module: the ``cuda`` tests
import them on a machine without JAX).

``dedup_case``: a level's lanes and a sorted store for B19's
``_level_dedup`` (``level_dedup``); ``k3_id_lists``: S=7 message id lists
for K3's factored message part (``msg_hash_factored`` / ``orbit_fold``);
``K2_MERGE_CASES`` / ``k2_merge_case`` and ``ids_merge_by_rank``: K2's id
lists (csrc/materialize.cu); ``k1_group_parents`` and ``k1_group_model``:
K1's groups, count tables and family-7 runs (csrc/guards.cu);
``compact_model``: the one-pass compaction (csrc/compact.cuh);
``k3s3_id_lists`` and ``k3s3_model``: K3's S <= 3 form (csrc/fingerprint.cu
``fingerprint_s3``); ``k3pairs_id_lists``, ``k3pairs_sibling_lists`` and
``k3pairs_model``: its
pair-digit form (``fingerprint_pairs``, S = 4, 5); ``k1_ids_words``: K1's
masks built from id lists (csrc/guards.cu, the inflate folded in);
``inv_tiles_model``: the invariant scan's persistent tiled walk
(csrc/invariants.cu ``inv_scan_tiles``); ``probe_case`` and
``probe_model``: slabs and lanes for the slab probe's edge cases and its
walk (hs_probe, csrc/hashstore.cu); ``sieve_blocks_model``: the sieve
probe's groups of 4 lanes and per-block counts under a live count
(csrc/sieve.cu).
"""

import numpy as np

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
TOP = np.uint64(1 << 63)

DEDUP_KINDS = ("all_sent", "no_dups", "long_runs", "signed_ties", "top_bit", "empty_store",
               "store_every_head")


def _u64(g, n: int, top: float = 0.5) -> np.ndarray:
    x = g.integers(0, 1 << 63, n, dtype=np.uint64)
    return x | np.where(g.random(n) < top, TOP, np.uint64(0))


def _store(vals: np.ndarray, pad: int = 64) -> np.ndarray:
    """A sorted store (unsigned order) of ``vals`` with ``pad`` SENT slots."""
    u = np.unique(vals[vals != SENT])
    return np.concatenate([u, np.full(pad, SENT)])


def dedup_case(kind: str, n: int, seed: int):
    """(store u64[V], cv u64[n], cf u64[n], cp i64[n]) of one kind:

    * ``all_sent``: every lane a SENT pad (fp_view, fp_full SENT, payload -1);
    * ``no_dups``: distinct fp_views, a tenth of the lanes SENT;
    * ``long_runs``: two fp_views cover three quarters and a quarter of the
      lanes (past 16,384 lanes: runs of ~6,000), less a tenth of random
      views (at 9,000 lanes a run longer than a 4,096-lane tile);
    * ``signed_ties``: runs whose lanes share fp_full, payloads of both
      signs, so the payload decides the run's lane;
    * ``top_bit``: every fp_view has its top bit set;
    * ``empty_store``: a store of SENT pads only;
    * ``store_every_head``: the store holds every live fp_view (no
      survivors).
    Each but the last two has a store hitting about a fifth of the views."""
    g = np.random.default_rng(seed)
    cv = _u64(g, n)
    cf = _u64(g, n)
    cp = (g.permutation(n).astype(np.int64) - n // 3) * 5
    pad = np.zeros(n, bool)
    if kind == "all_sent":
        pad[:] = True
    elif kind == "no_dups":
        cv = np.unique(cv)
        while cv.shape[0] < n:
            cv = np.unique(np.concatenate([cv, _u64(g, n)]))
        cv = g.permutation(cv[:n])
        pad = g.random(n) < 0.1
    elif kind == "long_runs":
        if n <= 16384:
            views = _u64(g, 2)
            cv[: 3 * n // 4] = views[0]
            cv[3 * n // 4:] = views[1]
        else:  # runs of ~6,000 lanes
            k = n // 6000
            cv = _u64(g, k)[np.arange(n) * k // n]
        rest = g.random(n) < 0.1
        cv[rest] = _u64(g, int(rest.sum()))
        cv = cv[g.permutation(n)]
        pad = g.random(n) < 0.03
    elif kind == "signed_ties":
        base = _u64(g, max(1, n // 8))
        cv = base[g.integers(0, base.shape[0], n)]
        fulls = _u64(g, base.shape[0])
        cf = fulls[np.searchsorted(np.sort(base), cv) % base.shape[0]]
        cp = g.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
        pad = g.random(n) < 0.05
    elif kind == "top_bit":
        cv = _u64(g, max(1, n // 3), top=1.0)[g.integers(0, max(1, n // 3), n)]
        pad = g.random(n) < 0.1
    else:
        dup = g.random(n) < 0.5
        cv[dup] = cv[g.integers(0, n, int(dup.sum()))]
        pad = g.random(n) < 0.1
    cv[pad], cf[pad], cp[pad] = SENT, SENT, -1
    live = cv[cv != SENT]
    if kind == "empty_store":
        store = np.full(64, SENT)
    elif kind == "store_every_head":
        store = _store(np.concatenate([live, _u64(g, 50)]))
    else:
        hits = live[g.random(live.shape[0]) < 0.2]
        store = _store(np.concatenate([hits, _u64(g, 300)]))
    return store, cv, cf, cp


K3_KINDS = ("no_ids", "one_digit", "every_digit", "high_ids", "full", "random")


def k3_id_lists(uni, rows: int, cap_m: int, seed: int) -> np.ndarray:
    """Ascending -1-padded id lists i64 [rows, cap_m] at S=7, cycling through
    ``K3_KINDS``: no ids; one pair digit carried by every id (type 2's 756
    ids of a digit, cap_m of them); every one of the S(S-1) digits present;
    ids >= 2^15 only (type 3 of the universe's layout); cap_m random ids;
    a random count of random ids."""
    g = np.random.default_rng(seed)
    NP = uni.S * (uni.S - 1)
    offs, strides = uni.type_offsets, uni.type_strides
    out = np.full((rows, cap_m), -1, np.int64)
    for i in range(rows):
        kind = K3_KINDS[i % len(K3_KINDS)]
        if kind == "no_ids":
            ids = np.zeros(0, np.int64)
        elif kind == "one_digit":
            q = int(g.integers(0, NP))
            ids = offs[2] + q * strides[2] + g.choice(strides[2], cap_m, replace=False)
        elif kind == "every_digit":
            t = g.integers(0, 4, NP)
            ids = np.array([offs[k] + q * strides[k] + g.integers(0, strides[k])
                            for q, k in enumerate(t)], np.int64)
            extra = g.choice(uni.M, max(0, cap_m - NP), replace=False)
            ids = np.unique(np.concatenate([ids, extra]))[:cap_m]
        elif kind == "high_ids":
            lo = max(1 << 15, offs[3])
            ids = g.choice(np.arange(lo, uni.M), min(cap_m, uni.M - lo), replace=False)
        elif kind == "full":
            ids = g.choice(uni.M, cap_m, replace=False)
        else:
            ids = g.choice(uni.M, int(g.integers(1, cap_m + 1)), replace=False)
        ids = np.sort(np.asarray(ids, np.int64))
        out[i, : ids.shape[0]] = ids
    return out


# -- K2: the child's id list as a merge by rank ---------------------------------------

K2_MERGE_CASES = ("empty", "full_drops_largest", "already_present", "two_past_last",
                  "s7_int32_high", "random")


def k2_merge_case(kind: str, M: int, cap_m: int, A: int, seed: int):
    """(parent ids i64 [n, cap_m] ascending and -1-padded, sent ids i64
    [n, A] (-1 pads)) of one kind: ``empty`` parent lists; ``full`` lists
    where a sent id below the largest makes it drop; ``already_present``
    sent ids; ``two_past_last`` two sent ids past the list's last id;
    ``s7_int32_high`` A sent ids at and past 2^15 (M > 2^15); ``random``
    lists of every length, sent ids of every kind, ids at or past M (a
    garbage lane's) included."""
    g = np.random.default_rng(seed)
    n = 64
    ids = np.full((n, cap_m), -1, np.int64)
    sent = np.full((n, A), -1, np.int64)
    for r in range(n):
        if kind == "empty":
            par = np.zeros(0, np.int64)
            k = int(g.integers(1, A + 1))
            sent[r, :k] = g.choice(M, k, replace=False)
        elif kind == "full_drops_largest":
            par = np.sort(g.choice(M - 1, cap_m, replace=False)) + 1
            sent[r, 0] = int(g.choice(np.setdiff1d(np.arange(par[-1]), par)))
        elif kind == "already_present":
            par = np.sort(g.choice(M, int(g.integers(1, cap_m + 1)), replace=False))
            k = min(A, par.shape[0])
            sent[r, :k] = g.choice(par, k, replace=False)
        elif kind == "two_past_last":
            m = int(g.integers(0, cap_m - 1))
            par = np.sort(g.choice(M // 2, m, replace=False))
            sent[r, :2] = M // 2 + g.choice(M // 2, 2, replace=False)
        elif kind == "s7_int32_high":
            par = np.sort(g.choice(M, int(g.integers(0, cap_m + 1)), replace=False))
            sent[r] = (1 << 15) + g.choice(M - (1 << 15), A, replace=False)
        else:
            par = np.sort(g.choice(M, int(g.integers(0, cap_m + 1)), replace=False))
            for a in range(A):
                x = g.random()
                sent[r, a] = (-1 if x < 0.2 else int(g.choice(par)) if x < 0.4 and par.size
                              else M + int(g.integers(0, 3)) if x < 0.45
                              else int(g.integers(0, M)))
        ids[r, : par.shape[0]] = par
    return ids, sent


def ids_merge_by_rank(ids: np.ndarray, sent: np.ndarray, M: int):
    """numpy model of K2's id lists: the child's list is the cap_m smallest
    ids of (parent ids U new ids), ascending and -1-padded, where the new
    ids are the sent ids in [0, M) neither in the parent's list nor sent
    before; a new id goes to lower_bound(parent, id) + (new ids below it),
    parent id q to q + (new ranks at or below it).  Overflow: n_parent +
    n_new > cap_m, or a sent id at or past M meeting a full list at its
    turn.  Returns (child ids i64 [n, cap_m], overflow bool [n])."""
    n, cap_m = ids.shape
    out = np.full((n, cap_m), -1, np.int64)
    ovf = np.zeros(n, bool)
    for r in range(n):
        par = ids[r][ids[r] >= 0]
        n_par = par.shape[0]
        new, of = [], False
        for a_i, a in enumerate(sent[r]):
            if a < 0:
                continue
            if a >= M:
                of |= n_par + len(new) >= cap_m
                continue
            if a in sent[r][:a_i] or a in par:
                continue
            new.append(int(a))
        rank = [int(np.searchsorted(par, a)) + sum(b < a for b in new) for a in new]
        ovf[r] = of or n_par + len(new) > cap_m
        for j in range(cap_m):
            hit = [a for a, rk in zip(new, rank) if rk == j]
            q = j - sum(rk < j for rk in rank)
            out[r, j] = hit[0] if hit else (par[q] if q < n_par else -1)
    return out, ovf


# -- K1: groups of parents, (pair, term) count tables, family-7 runs ----------------

# the C ``Dims`` struct's fields (csrc/common.cuh), in order
DIMS = ("S", "T", "L", "V", "E", "NPLI", "ap_pli_min", "vq_off", "vp_off", "aq_off", "ap_off",
        "M", "n_words", "majority", "median_index", "max_election", "max_restart",
        "double_vote", "legacy_append", "become_follower")
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


def k1_group_parents(d: dict, K: int, n7: int, per_row: bool) -> int:
    """The parents a block of K1 takes (csrc/guards.cu ``group_parents``):
    the most, up to 16, whose shared memory fits 48 KB; ``n7`` family 7's
    slots."""
    S, T, L, V = d["S"], d["T"], d["L"], d["V"]
    row = 5 * S + 2 * S * L + 3 * S * S + 2 + V
    a16 = lambda x: (x + 15) & ~15  # noqa: E731

    def size(np_):
        core_off = a16(K * 4) + np_ * d["n_words"] * 4 + np_ * S * (S - 1) * T * 8 + np_ * 4
        v_off = a16(core_off + np_ * row)
        return a16(v_off + np_ * K) + np_ * (K - n7) * 4 if per_row else v_off + np_ * K

    np_ = 16
    while np_ > 1 and size(np_) > 48 * 1024:
        np_ -= 1
    return np_


def k1_group_model(d: dict, f: dict, bits: np.ndarray, slot_table: np.ndarray,
                   accept_runs: tuple, np_: int, live: int):
    """numpy model of K1's route (csrc/guards.cu) over ``live`` parents in
    groups of ``np_``: the per-parent (pair, term) count tables (any
    message to dst; AppendReqs), family 7 as runs of E * L consecutive mask
    bits under one condition, every other slot on its family, then each
    group's per-slot sums of the multiplicities and its first abort.

    ``d``: the config's constants (S, T, L, V, E, NPLI, ap_pli_min, the
    four type offsets, majority, median_index, max_election, max_restart,
    the three mutation flags); ``f``: the core fields (numpy, rows first);
    ``bits``: the message sets u8 [B, M]; ``accept_runs``: family 7's
    (first slot, slots), as ``SlotLayout.accept_runs`` gives them.  Returns (valid bool [live, K],
    mult i32 [live, K], abort bool [live], group sums i64 [groups, K], the
    first aborting row or -1)."""
    S, T, L, V, E = d["S"], d["T"], d["L"], d["V"], d["E"]
    B = live
    K = slot_table.shape[0]
    bits = bits[:B].astype(np.int64)
    f = {k: np.asarray(v[:B]).astype(np.int64) for k, v in f.items()}
    csum = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(bits, 1)], 1)
    rows = np.arange(B)

    def pair(a, b):
        return a * (S - 1) + (b - (b > a))

    def vq(p, term, lli, llt):
        return d["vq_off"] + ((p * T + term - 1) * L + lli - 1) * T + llt

    def vp(p, term):
        return d["vp_off"] + p * T + term - 1

    def aq(p, term, pli, plt, entry, lc):
        x = ((((p * T + term - 1) * L + pli - 1) * (T + 1) + plt) * E + entry) * L + lc - 1
        return d["aq_off"] + x

    def ap(p, term, pli, succ):
        return d["ap_off"] + ((p * T + term - 1) * d["NPLI"] + pli - d["ap_pli_min"]) * 2 + succ

    def bit(ids):
        return bits[rows, np.broadcast_to(ids, (B,))]

    def popc(a, n):
        a = np.broadcast_to(a, (B,))
        return csum[rows, a + n] - csum[rows, a]

    # family 7's runs: slots [k7, k7 + n7), E * L a run
    k7, n7 = accept_runs
    el = E * L

    # the (pair, term) tables
    npair = S * (S - 1)
    anyc = np.zeros((B, npair, T), np.int64)
    aqc = np.zeros((B, npair, T), np.int64)
    for p in range(npair):
        for tt in range(T):
            aqc[:, p, tt] = popc(aq(p, tt + 1, 1, 0, 0, 1), L * (T + 1) * E * L)
            anyc[:, p, tt] = (aqc[:, p, tt] + popc(vq(p, tt + 1, 1, 0), L * T)
                              + bit(vp(p, tt + 1))
                              + popc(d["ap_off"] + (p * T + tt) * d["NPLI"] * 2, d["NPLI"] * 2))

    def med(r):  # rank-select median of rows r [B, S]
        pos = ((r[:, None, :] < r[:, :, None]).sum(2)
               + np.tril((r[:, None, :] == r[:, :, None]), -1).sum(2))
        return np.where(pos == d["median_index"], r, 0).sum(1)

    valid = np.zeros((B, K), bool)
    mult = np.zeros((B, K), np.int64)
    abort = np.zeros(B, bool)
    for k in list(range(k7)) + list(range(k7 + n7, K)):
        fam, s, c1, c2, c3, c4 = (int(x) for x in slot_table[k])
        ct, role, ll, ci = (f[x][:, s] for x in ("current_term", "role", "log_len",
                                                   "commit_index"))
        lt = f["log_term"][:, s]
        tix = np.clip(ct - 1, 0, T - 1)
        ht = ct >= 1
        m = np.ones(B, np.int64)
        if fam == 0:
            ok = ((role == FOLLOWER) | (role == CANDIDATE)) & (f["election_count"]
                                                                < d["max_election"])
        elif fam == 1:
            m = sum(anyc[:, pair(src, s), c1] for src in range(S) if src != s)
            ok = (c1 + 1 > ct) & (m > 0)
        elif fam == 2:
            m = sum(aqc[rows, pair(src, s), tix] for src in range(S) if src != s)
            ok = (role == CANDIDATE) & ht & (m > 0)
            abort |= (not d["become_follower"]) & ht & (m > 0) & (role == LEADER)
        elif fam == 3:
            vf = f["voted_for"][:, s]
            vf_ok = d["double_vote"] | (vf == 0) | (vf == c1 + 1)
            qual = np.zeros(B, np.int64)
            grant = np.zeros(B, np.int64)
            if c1 != s:
                lpos = np.clip(ll - 1, 0, L - 1)
                myllt = np.clip(lt[rows, lpos], 0, T)
                for l0 in range(L):
                    for k2 in range(T):
                        use = (k2 > myllt) | ((k2 == myllt) & (l0 >= lpos))
                        qual += use * bit(vq(pair(c1, s), tix + 1, l0 + 1, k2))
                grant = bit(vp(pair(s, c1), tix + 1))
            m = qual
            ok = (role == FOLLOWER) & ht & vf_ok & (c1 != s) & (qual > 0) & (grant == 0)
        elif fam == 4:
            votes = sum(bit(vp(pair(src, s), tix + 1)) for src in range(S) if src != s)
            ok = (role == CANDIDATE) & (votes + 1 >= d["majority"])
        elif fam == 5:
            ok = (role == LEADER) & (f["val_sent"][:, c1] == 0) & (ll < L)
        elif fam == 6:
            nsd = f["next_index"][:, s, c1]
            present = np.zeros(B, bool)
            if c1 != s:
                lv = f["log_val"][:, s]
                pli = np.clip(nsd - 1, 1, L)
                plt = np.clip(lt[rows, np.clip(nsd - 2, 0, L - 1)], 0, T)
                epos = np.clip(nsd - 1, 0, L - 1)
                et = np.clip(lt[rows, epos], 1, T)
                ev = np.clip(lv[rows, epos], 1, V)
                ecode = np.where(nsd <= ll, 1 + (et - 1) * V + (ev - 1), 0)
                present = bit(aq(pair(s, c1), np.clip(ct, 1, T), pli, plt, ecode,
                                 np.clip(ci, 1, L))) > 0
            ok = ((role == LEADER) & (f["pending"][:, s, c1] == 0) & (nsd <= ll + 1)
                  & (c1 != s) & ~present)
        elif fam == 8:
            n = np.zeros(B, np.int64)
            rej = np.zeros(B, np.int64)
            if c1 != s:
                p = pair(c1, s)
                tot = popc(aq(p, tix + 1, c2 + 1, 0, 0, 1), (T + 1) * E * L)
                mplt = np.clip(lt[:, c2], 0, T)
                match = popc(aq(p, tix + 1, c2 + 1, mplt, 0, 1), E * L)
                n = tot - np.where(c2 + 1 <= ll, match, 0)
                rej = bit(ap(pair(s, c1), tix + 1, c2 + d["ap_pli_min"], 0))
            m = n
            ok = (role == FOLLOWER) & ht & (c1 != s) & (n > 0) & (rej == 0)
        elif fam == 9:
            pli = c2 + 1
            msd, nsd = f["match_index"][:, s, c1], f["next_index"][:, s, c1]
            st_ok = msd < pli if c3 == 1 else (pli + 1 == nsd) & (pli > msd)
            present = (bit(ap(pair(c1, s), tix + 1, pli, c3)) > 0) if c1 != s else False
            ok = (role == LEADER) & ht & (f["pending"][:, s, c1] == 1) & st_ok & present
        elif fam == 10:
            ok = (role == LEADER) & (med(f["match_index"][:, s]) > ci)
        else:
            ok = (role == LEADER) & (f["restart_count"] < d["max_restart"])
        valid[:, k] = ok
        mult[:, k] = np.where(ok, m, 0)
    for r_ in range(n7 // el):  # family 7's runs, (s, src, l0) from the run's first slot
        s, src, l0 = (int(x) for x in slot_table[k7 + r_ * el, 1:4])
        if src == s:  # no message to oneself: the run stays invalid
            continue
        ct, ll, ci = (f[x][:, s] for x in ("current_term", "log_len", "commit_index"))
        tix = np.clip(ct - 1, 0, T - 1)
        cond = (f["role"][:, s] == FOLLOWER) & (ct >= 1) & (l0 + 1 <= ll)
        plt = np.clip(f["log_term"][:, s, l0], 0, T)
        id0 = np.where(cond, aq(pair(src, s), tix + 1, l0 + 1, plt, 0, 1), 0)
        for qq in range(el):
            ok = cond & (bit(id0 + qq) > 0)
            if d["legacy_append"]:
                e, h0 = qq // L, qq % L
                nl = l0 + 1 + (e > 0)
                resp = bit(ap(pair(s, src), tix + 1, min(nl, L), 1)) > 0
                ok &= ~resp | (min(h0 + 1, nl) > ci)
            valid[:, k7 + r_ * el + qq] = ok
            mult[:, k7 + r_ * el + qq] = ok
    groups = -(-B // np_)
    sums = np.stack([mult[g * np_:(g + 1) * np_].sum(0) for g in range(groups)])
    firsts = [g * np_ + int(np.argmax(abort[g * np_:(g + 1) * np_])) for g in range(groups)
              if abort[g * np_:(g + 1) * np_].any()]
    return valid, mult.astype(np.int32), abort, sums, min(firsts, default=-1)


# -- the one-pass compaction (csrc/compact.cuh) -------------------------------------

CP_THREADS, CP_ITEMS = 256, 32
CP_LARGE = 1 << 22  # from here a thread takes 64 lanes
CP_COUNT_BITS = 36
CP_EPOCHS = 1 << 26
CP_AGG, CP_INC = 1, 2


def cp_word(epoch: int, flag: int, count: int) -> int:
    """A status word: epoch << 38 | flag << 36 | count."""
    return (epoch << (CP_COUNT_BITS + 2)) | (flag << CP_COUNT_BITS) | count


def cp_scratch_words(n: int, threads: int = CP_THREADS) -> int:
    """``compact_scratch_words``: the ticket, the epoch and a status word
    each ``threads * CP_ITEMS`` lanes (the smaller tile), so the count grows
    with ``n`` and covers the larger tiles' fewer words too."""
    return 2 + -(-n // (threads * CP_ITEMS))


def cp_stale_scratch(n_tiles: int, epoch: int, seed: int) -> np.ndarray:
    """The scratch an earlier call left: the ticket 0, ``epoch``, and status
    words of earlier epochs (aggregates and inclusive prefixes with random
    counts, and zeros)."""
    g = np.random.default_rng(seed)
    words = []
    for _ in range(n_tiles):
        e = int((epoch - g.integers(1, 4)) % CP_EPOCHS)
        words.append(0 if g.random() < 0.2 else
                     cp_word(e, int(g.integers(1, 3)), int(g.integers(0, 1 << 20))))
    return np.asarray([0, epoch] + words, np.uint64)


def compact_model(flags, vals, pads, cap: int, *, outs=None, out_off: int = 0, add: int = 0,
                  iota_base: int = 0, live=None, scratch=None, ovf: int = 0,
                  threads: int = CP_THREADS, items=None, seed: int = 0):
    """numpy model of one compaction call (compact_pass, then compact_pad):
    ``flags`` bool [n] (only the first ``live`` count), ``vals`` the value
    arrays (None: ``iota_base`` + lane), their ``outs`` (i64 arrays written
    from ``out_off``; cap long when not given) and ``pads``; ``add`` goes on
    the third array's kept values.  Tiles of ``threads * items`` lanes
    (``items`` 32, or 64 from ``CP_LARGE`` lanes, as the kernel picks) are
    taken by ticket and then run in a seeded random interleaving: a tile
    publishes its count, looks back over the status words of the tiles
    before it 32 at a time (spinning on a window while a word there is not
    of this call's epoch), publishes its inclusive prefix and writes its
    kept values; ranks in a tile come from each thread's ``items``-lane
    mask and the warps' ballots.  Returns dict(outs, lane, total, ovf, scratch)."""
    g = np.random.default_rng(seed)
    flags = np.asarray(flags, bool)
    n = flags.shape[0]
    nl = n if live is None else max(0, min(n, int(live)))
    if items is None:
        items = 64 if n >= CP_LARGE else CP_ITEMS
    tile = threads * items
    nt = -(-n // tile)
    if scratch is None:
        scratch = np.zeros(cp_scratch_words(n, threads), np.uint64)
    if scratch.shape[0] < 2 + nt:  # the kernel would write past the scratch
        raise ValueError(f"a scratch of {scratch.shape[0]} words for {2 + nt}")
    scratch = scratch.copy()
    if outs is None:
        outs = [np.full(cap, 7, np.int64) for _ in vals]
    outs = [o.copy() for o in outs]
    epoch = int(scratch[1])
    status = scratch[2:]
    count_mask = (1 << CP_COUNT_BITS) - 1

    def word_fields(w: int):
        w = int(w)
        return w >> (CP_COUNT_BITS + 2), (w >> CP_COUNT_BITS) & 3, w & count_mask

    live_tiles = -(-nl // tile)
    order = {}  # a tile's kept lanes (tile offsets) at their ranks
    tile_n = {}
    for j in range(live_tiles):
        base = j * tile
        f = np.zeros(tile, bool)
        hi = min(nl, base + tile)
        f[: hi - base] = flags[base:hi]
        m = f.reshape(threads, items)  # a thread's lanes
        c = m.sum(1)
        ws = min(32, threads)  # a warp's threads (fewer in a narrowed model)
        ex = np.zeros(threads, np.int64)
        wsum = np.zeros(threads // ws, np.int64)
        for b in range(6):  # the warps' ballots of the counts' bits (c <= 32)
            bits = ((c >> b) & 1).reshape(-1, ws)
            ex += ((np.cumsum(bits, 1) - bits) << b).reshape(-1)
            wsum += bits.sum(1) << b
        before = np.repeat(np.cumsum(wsum) - wsum, ws)
        pos = np.full(tile, -1, np.int64)
        for t in range(threads):
            r = before[t] + ex[t]
            for k in np.flatnonzero(m[t]):
                pos[r] = t * items + k
                r += 1
        tile_n[j] = int(wsum.sum())
        order[j] = pos[: tile_n[j]]

    phase = {j: 0 for j in range(live_tiles)}
    look = {j: j - 1 for j in range(live_tiles)}
    excl = {j: 0 for j in range(live_tiles)}
    while any(p < 2 for p in phase.values()):
        j = int(g.choice([k for k, p in phase.items() if p < 2]))
        if phase[j] == 0:
            status[j] = cp_word(epoch, CP_INC if j == 0 else CP_AGG, tile_n[j])
            phase[j] = 2 if j == 0 else 1
            continue
        idx = look[j] - np.arange(32)
        words = [cp_word(epoch, CP_INC, 0) if i < 0 else int(status[i]) for i in idx]
        fl = [f if e == epoch else 0 for e, f, _c in map(word_fields, words)]
        if not all(fl):
            continue  # spin: a word of this window is not published in this call
        inc = [k for k, f in enumerate(fl) if f == CP_INC]
        stop = inc[0] if inc else 31
        excl[j] += sum(word_fields(w)[2] for w in words[: stop + 1])
        if inc:
            status[j] = cp_word(epoch, CP_INC, excl[j] + tile_n[j])
            phase[j] = 2
        else:
            look[j] -= 32
    for j in g.permutation(live_tiles):
        n_out = min(tile_n[j], cap - excl[j])
        for q in range(max(n_out, 0)):
            i = j * tile + int(order[j][q])
            o = out_off + excl[j] + q
            for a, (v, out) in enumerate(zip(vals, outs)):
                x = iota_base + i if v is None else int(v[i])
                out[o] = x + (add if a == 2 else 0)
    total = word_fields(status[live_tiles - 1])[2] if live_tiles else 0
    lane = np.arange(cap) < total
    for out, pad in zip(outs, pads):
        out[out_off + total: out_off + cap] = pad
    if total > cap:
        ovf = 1
    scratch[0] = 0
    scratch[1] = (epoch + 1) % CP_EPOCHS
    return dict(outs=outs, lane=lane, total=total, ovf=ovf, scratch=scratch)


# -- K3 at S <= 3 (csrc/fingerprint.cu fingerprint_s3) ------------------------------

# the core fields in the kernels' order (csrc/common.cuh ``Field``)
CORE_FIELDS = ("voted_for", "current_term", "role", "log_term", "log_val", "log_len",
               "match_index", "next_index", "commit_index", "election_count", "restart_count",
               "pending", "val_sent")
VF, CT, ROLE, LT, LV, LL, MI, NI, CI, EC, RC, PEND, VS = range(13)
K3S3_KINDS = ("no_ids", "full", "random", "high_ids", "one_id")
S3_STATES, S3_PSETS, S3_IDS = 64, 3, 8


def feature_codes(S: int, L: int, F: int) -> list:
    """Where each feature lives (csrc/fingerprint.cu ``feature_code``):
    (field, byte of the state's row, votedFor one-hot value + 1 or 0)."""
    out = []
    for e in range(F):
        j, cmp = e, 0
        for f, w in ((CT, S), (ROLE, S), (LT, S * L), (LV, S * L), (LL, S), (MI, S * S),
                     (NI, S * S), (CI, S)):
            if j < w:
                break
            j -= w
        else:
            if j < S * (S + 1):
                f, cmp, j = VF, j % (S + 1) + 1, j // (S + 1)
            elif (j := j - S * (S + 1)) < 2:
                f, j = (RC if j else EC), 0
            elif (j := j - 2) < S * S:
                f = PEND
            else:
                f, j = VS, j - S * S
        out.append((f, j, cmp))
    return out


def k3s3_id_lists(M: int, rows: int, cap_m: int, seed: int) -> np.ndarray:
    """Ascending -1-padded id lists i64 [rows, cap_m] cycling through
    ``K3S3_KINDS``: no ids; cap_m ids (a full list); a random count; the
    highest ids of the universe; a single id."""
    g = np.random.default_rng(seed)
    out = np.full((rows, cap_m), -1, np.int64)
    for i in range(rows):
        kind = K3S3_KINDS[i % len(K3S3_KINDS)]
        if kind == "no_ids":
            ids = np.zeros(0, np.int64)
        elif kind == "full":
            ids = g.choice(M, min(cap_m, M), replace=False)
        elif kind == "high_ids":
            ids = np.arange(M - min(cap_m, M), M)
        elif kind == "one_id":
            ids = g.integers(0, M, 1)
        else:
            ids = g.choice(M, int(g.integers(1, min(cap_m, M) + 1)), replace=False)
        ids = np.sort(np.asarray(ids, np.int64))
        out[i, : ids.shape[0]] = ids
    return out


def k3s3_model(fields: dict, ids: np.ndarray, ct: np.ndarray, eff: np.ndarray, S: int, L: int,
               F: int, live: int, id_bytes: int = 2, idx=None, out=None):
    """numpy model of fingerprint_s3 over the rows of ``fields`` (the
    Frontier's core fields, uint8 arrays) and ``ids`` (-1-padded ascending
    lists): groups of 64 states (launch row r is state r, or ``idx[r]``);
    each group's fields staged field-major and its id lists as ``id_bytes``
    wide words; each feature read through its code from the staged rows;
    the planes of the feature table's used columns (``ct`` i8 [16 P, f_pad])
    combined into u32 a (permutation, channel); the message part of each
    (state, permutation), its four channels summed from ``eff`` u32 [M, P,
    4] an id at a time in runs of 8 that stop after the first -1; each of
    the three permutation sets' minima of the two 64-bit pairs, then their
    minimum.  Rows from ``live`` are SENT outside the indexed mode; in it
    only the outputs at ``idx[r]``, r < live, are written (``out``: the
    outputs before the call).  Returns (fp_view u64, fp_full u64)."""
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    n = ids.shape[0] if idx is None else len(idx)
    P = eff.shape[1]
    f_pad = ct.shape[1]
    codes = feature_codes(S, L, F)
    fsz = [int(np.prod(fields[f].shape[1:], dtype=np.int64)) for f in CORE_FIELDS]
    if out is None:
        out = (np.full(ids.shape[0], sent), np.full(ids.shape[0], sent))
    fv, ff = (x.copy() for x in out)
    itype = np.int16 if id_bytes == 2 else np.int32
    m32 = np.int64(0xFFFFFFFF)
    for base in range(0, n, S3_STATES):
        rows = np.arange(base, min(base + S3_STATES, n))
        if idx is None:
            fv[rows[rows >= live]] = sent
            ff[rows[rows >= live]] = sent
        rows = rows[rows < live]
        if not rows.shape[0]:
            continue
        states = rows if idx is None else np.asarray(idx)[rows]
        raw = [np.ascontiguousarray(fields[f][states]).reshape(len(states), -1).view(np.uint8)
               for f in CORE_FIELDS]
        assert [r.shape[1] for r in raw] == fsz
        staged_ids = np.ascontiguousarray(ids[states].astype(itype)).view(np.uint8)
        sid = staged_ids.view(itype).astype(np.int64)
        A = np.zeros((len(states), f_pad), np.int64)
        for e, (f, j, cmp) in enumerate(codes):
            v = raw[f][:, j].astype(np.int64)
            A[:, e] = (v == cmp - 1) if cmp else v.astype(np.uint8).view(np.int8)
        planes = (A @ ct.astype(np.int64).T).reshape(len(states), P, 4, 4)
        h = (planes * (np.int64(1) << (8 * np.arange(4, dtype=np.int64)))).sum(-1) & m32
        msum = np.zeros((len(states), P, 4), np.int64)
        for r in range(len(states)):
            for j0 in range(0, sid.shape[1], S3_IDS):
                run = sid[r, j0:j0 + S3_IDS]
                for i in run[run >= 0]:
                    msum[r] = (msum[r] + eff[i].astype(np.int64)) & m32
                if run.shape[0] < S3_IDS or run[-1] < 0:
                    break
        h = ((h + msum) & m32).astype(np.uint64)
        view = (h[..., 0] << np.uint64(32)) | h[..., 1]
        full = (h[..., 2] << np.uint64(32)) | h[..., 3]
        sets_v = [view[:, k::S3_PSETS].min(1) if k < P else np.full(len(states), sent)
                  for k in range(S3_PSETS)]
        sets_f = [full[:, k::S3_PSETS].min(1) if k < P else np.full(len(states), sent)
                  for k in range(S3_PSETS)]
        fv[states] = np.minimum.reduce(sets_v)
        ff[states] = np.minimum.reduce(sets_f)
    return fv, ff


# -- K3's pair-digit form (csrc/fingerprint.cu fingerprint_pairs) --------------------

PR_WARPS = 16
PR_RUN = 64 // PR_WARPS  # consecutive states a warp takes
K3PAIRS_KINDS = K3S3_KINDS + ("one_digit", "every_digit")


def k3pairs_id_lists(M: int, offs, strides, rows: int, cap_m: int, seed: int) -> np.ndarray:
    """Ascending -1-padded id lists i64 [rows, cap_m] cycling through
    ``K3PAIRS_KINDS``: ``K3S3_KINDS`` (none, cap_m of them, random, the
    universe's highest ids, one), then ids of a single pair digit (type
    2's, as many as fit) and every pair digit present (one id each, of a
    random type, then random ids up to cap_m)."""
    g = np.random.default_rng(seed)
    NP = (offs[1] - offs[0]) // strides[0]
    out = k3s3_id_lists(M, rows, cap_m, seed)
    for i in range(rows):
        kind = K3PAIRS_KINDS[i % len(K3PAIRS_KINDS)]
        if kind == "one_digit":
            q = int(g.integers(0, NP))
            ids = offs[2] + q * strides[2] + g.choice(strides[2], min(cap_m, strides[2]),
                                                      replace=False)
        elif kind == "every_digit":
            t = g.integers(0, 4, NP)
            ids = np.array([offs[k] + q * strides[k] + g.integers(0, strides[k])
                            for q, k in enumerate(t)], np.int64)
            extra = g.choice(M, max(0, cap_m - NP), replace=False)
            ids = np.unique(np.concatenate([ids, extra]))[:cap_m]
        else:
            continue
        ids = np.sort(np.asarray(ids, np.int64))
        out[i] = -1
        out[i, : ids.shape[0]] = ids
    return out


def k3pairs_sibling_lists(M: int, rows: int, cap_m: int, seed: int) -> np.ndarray:
    """Ascending -1-padded id lists i64 [rows, cap_m] in runs of 1 to 12
    siblings, as a level's candidates come: a run's parent list (0 to
    cap_m - 2 random ids), each child the parent's list with one or two
    ids added (its list cut to cap_m), now and then the parent's own list
    or one with an id taken out."""
    g = np.random.default_rng(seed)
    out = np.full((rows, cap_m), -1, np.int64)
    i = 0
    while i < rows:
        parent = np.sort(g.choice(M, int(g.integers(0, cap_m - 1)), replace=False))
        for _ in range(int(g.integers(1, 13))):
            if i == rows:
                break
            kind = g.integers(0, 8)
            if kind == 0:
                ids = parent
            elif kind == 1 and parent.shape[0]:
                ids = np.delete(parent, g.integers(0, parent.shape[0]))
            else:
                ids = np.union1d(parent, g.integers(0, M, int(g.integers(1, 3))))[:cap_m]
            out[i, : ids.shape[0]] = ids
            i += 1
    return out


def k3pairs_model(fields: dict, ids: np.ndarray, ct: np.ndarray, gt: np.ndarray,
                  pperm: np.ndarray, offs, strides, row_base, S: int, L: int, F: int, live: int,
                  id_bytes: int = 2, idx=None, out=None):
    """numpy model of fingerprint_pairs over the rows of ``fields`` and
    ``ids`` (-1-padded ascending lists): groups of 64 states (launch row r
    is state r, or ``idx[r]``), their fields staged field-major and their
    id lists as ``id_bytes`` wide words, each feature read through its code;
    the message part: warp w takes the group's states 4 w .. 4 w + 3 in
    turn, each permutation's sums (four channels) carried from state to
    state; a state's valid ids are its list up to the first -1; the sums
    are updated by the ids only the state has (+) and only the last state
    had (-), or, for the warp's first state or where that touches at least
    as many ids as the state has, rebuilt from its own ids; an id (type,
    pair digit q, gt row) adds ``gt[row, pperm[p, q]]`` (``gt`` u32 [rows,
    NP, 4]) to permutation p's sums, the ids two at a time in mask order,
    u32 mod 2^32; the feature part from
    the feature table's columns (``ct`` i8 [16 P, f_pad]), the planes
    combined a (permutation, channel); each warp's minima over its
    permutations (warp w takes w, w + 16, ...), then the warps' minimum.
    Rows from ``live`` are SENT outside the indexed mode; in it only the
    outputs at ``idx[r]``, r < live, are written (``out``: the outputs
    before the call).  Returns (fp_view u64, fp_full u64)."""
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    m32 = np.uint64(0xFFFFFFFF)
    n = ids.shape[0] if idx is None else len(idx)
    P, NP = pperm.shape
    f_pad = ct.shape[1]
    codes = feature_codes(S, L, F)
    if out is None:
        out = (np.full(ids.shape[0], sent), np.full(ids.shape[0], sent))
    fv, ff = (x.copy() for x in out)
    itype = np.int16 if id_bytes == 2 else np.int32
    gt = gt.astype(np.uint64)
    sets = [np.arange(w, P, PR_WARPS) for w in range(PR_WARPS)]
    for base in range(0, n, S3_STATES):
        rows = np.arange(base, min(base + S3_STATES, n))
        if idx is None:
            fv[rows[rows >= live]] = sent
            ff[rows[rows >= live]] = sent
        rows = rows[rows < live]
        if not rows.shape[0]:
            continue
        states = rows if idx is None else np.asarray(idx)[rows]
        raw = [np.ascontiguousarray(fields[f][states]).reshape(len(states), -1).view(np.uint8)
               for f in CORE_FIELDS]
        sid = np.ascontiguousarray(ids[states].astype(itype)).astype(np.int64)
        A = np.zeros((len(states), f_pad), np.int64)
        for e, (f, j, cmp) in enumerate(codes):
            v = raw[f][:, j].astype(np.int64)
            A[:, e] = (v == cmp - 1) if cmp else v.astype(np.uint8).view(np.int8)
        planes = (A @ ct.astype(np.int64).T).reshape(len(states), P, 4, 4)
        h = ((planes * (np.int64(1) << (8 * np.arange(4, dtype=np.int64)))).sum(-1)
             & np.int64(0xFFFFFFFF)).astype(np.uint64)
        msum = np.zeros((len(states), P, 4), np.uint64)
        def part(i):  # an id's part of every permutation's sums [P, 4]
            ty = int(i >= offs[1]) + int(i >= offs[2]) + int(i >= offs[3])
            q, rest = divmod(int(i) - offs[ty], strides[ty])
            return gt[row_base[ty] + rest][pperm[:, q]]

        for w in range(PR_WARPS):
            acc, prev = None, None
            for r in range(PR_RUN * w, min(len(states), PR_RUN * (w + 1))):
                row = sid[r]
                cur = row[: int(np.argmax(row < 0)) if (row < 0).any() else row.shape[0]]
                if prev is not None:
                    add = cur[~np.isin(cur, prev)]
                    sub = prev[~np.isin(prev, cur)]
                if prev is None or add.shape[0] + sub.shape[0] >= cur.shape[0]:
                    acc = np.zeros((P, 4), np.uint64)
                    add, sub = cur, cur[:0]
                for i in add:
                    acc = (acc + part(i)) & m32
                for i in sub:
                    acc = (acc - part(i)) & m32
                msum[r] = acc
                prev = cur
        h = (h + msum) & m32
        view = (h[..., 0] << np.uint64(32)) | h[..., 1]
        full = (h[..., 2] << np.uint64(32)) | h[..., 3]
        mv = [view[:, s_].min(1) if s_.shape[0] else np.full(len(states), sent) for s_ in sets]
        mf = [full[:, s_].min(1) if s_.shape[0] else np.full(len(states), sent) for s_ in sets]
        fv[states] = np.minimum.reduce(mv)
        ff[states] = np.minimum.reduce(mf)
    return fv, ff


# -- K1's masks from id lists (csrc/guards.cu, the inflate folded in) ---------------


def k1_ids_words(ids: np.ndarray, n_words: int, np_: int) -> np.ndarray:
    """The masks K1 builds in shared memory from id lists i64 [B, cap_m],
    a group of ``np_`` parents at a time: the group's words zeroed, then
    each id with id >= 0 and id >> 5 < n_words ORed in, in the order the
    block's threads take the group's ids (OR is order-free).  Returns u32
    [B, n_words]."""
    B, cap_m = ids.shape
    out = np.zeros((B, n_words), np.uint32)
    for b0 in range(0, B, np_):
        grp = ids[b0:b0 + np_].reshape(-1)
        words = np.zeros((grp.shape[0] // cap_m, n_words), np.uint32)
        for i in np.random.default_rng(b0).permutation(grp.shape[0]):
            v = int(grp[i])
            if v >= 0 and (v >> 5) < n_words:
                words[i // cap_m, v >> 5] |= np.uint32(1 << (v & 31))
        out[b0:b0 + np_] = words
    return out


# -- K4's claim rounds over pending-lane lists (csrc/hashstore.cu) ------------------

HS_PROBE_DEPTH = 64
HS_EPOCH_BITS = 20
HS_PAY_BITS = 64 - HS_EPOCH_BITS
HS_EPOCH_MAX = (1 << HS_EPOCH_BITS) - 1
HS_FIN_LANES = 4096  # a list this short goes to the one-block finisher
HS_GRID_ROUNDS = 6   # grid-wide round kernels a call launches before the finisher
LIVE, PREFOUND, WON = 4, 2, 8
_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _walk(slab: np.ndarray, fp: int):
    """(1 found | 0 empty | -1 the window full, slot) of fp's probe path."""
    cap = slab.shape[0]
    h0 = _mix64(fp) & (cap - 1)
    for j in range(HS_PROBE_DEPTH):
        cur = (h0 + j) & (cap - 1)
        v = int(slab[cur])
        if v == fp:
            return 1, cur
        if v == int(SENT):
            return 0, cur
    return -1, 0


def hs_stale_words(cap: int, epochs, seed: int) -> np.ndarray:
    """Representative words an earlier call left ([cap, 2] u64: key, then
    payload << 20 | epoch): a third of the slots hold a word of one of
    ``epochs`` with key 0 and payload 0 (below any lane's, so a stale word
    read as this call's would win), the rest are zero (epoch 0)."""
    g = np.random.default_rng(seed)
    words = np.zeros((cap, 2), np.uint64)
    hit = g.random(cap) < 1 / 3
    eps = np.asarray(epochs, np.uint64)
    words[hit, 1] = eps[g.integers(0, eps.shape[0], int(hit.sum()))]
    return words


def hs_rounds_model(slab, fps, keys=None, pays=None, *, words=None, epoch: int = 0,
                    budget: int = 1 << 62, grid_rounds: int = HS_GRID_ROUNDS,
                    fin_lanes: int = HS_FIN_LANES, undo: bool = True, seed: int = 0):
    """numpy model of one K4 call (``keys`` given) or one ``insert_only``
    call (``keys`` None) over u64 ``slab`` (in place) and lanes ``fps``.

    ``hs_begin`` moves the representative's epoch on (``epoch`` is the last
    call's; past HS_EPOCH_MAX every word is cleared and the epoch is 1
    again).  ``probe_first`` walks every live lane against the slab as it
    came in: found (PREFOUND), an empty slot (the lane goes on the pending
    list, in a seeded shuffled order: the list's order is the appends'), or
    the window full (overflow; a group lane of slot 0).  Each round then
    claims (scatter-min of the list's fingerprints into their targets) and
    verifies the list in a shuffled order: a lane whose fingerprint holds
    its target won it (WON), a lane that lost walks the slab as it stands
    after the claims and is found, goes on the next list, or overflows.
    Rounds run on the grid while the list is longer than ``fin_lanes`` and
    fewer than ``grid_rounds`` have run there, then on the finisher; after
    ``budget`` rounds lanes still pending raise ``left`` and count as group
    lanes of slot 0.  Every group lane (live, not found before the call)
    takes the 16-byte minimum of (key, payload << 20 | epoch) into its
    slot's word, a word of another epoch counting as empty; a lane is
    fresh when its slot's word is its own.  ``undo`` empties the slots won
    when the call overflowed (K4's host-driven wrapper).  Returns dict(slab,
    fresh, n_new, ovf, rounds, left, grid, lists, words, epoch, bad_pay,
    live, group, n_inserted)."""
    g = np.random.default_rng(seed)
    cap = slab.shape[0]
    fps = np.asarray(fps, np.uint64)
    n = fps.shape[0]
    rep = keys is not None
    if rep:
        keys = np.asarray(keys, np.uint64)
        pays = np.asarray(pays, np.int64)
        if words is None:
            words = np.zeros((cap, 2), np.uint64)
        epoch += 1
        if epoch > HS_EPOCH_MAX:
            words[:] = 0
            epoch = 1
    before = int((slab != SENT).sum())
    flags = np.zeros(n, np.uint8)
    slot = np.zeros(n, np.int64)
    tgt = np.zeros(n, np.int64)
    dead = np.zeros(n, bool)
    st = dict(ovf=False, bad_pay=False)

    def cas(i, s):
        p = int(pays[i])
        if p < 0 or p >= 1 << HS_PAY_BITS:
            st["bad_pay"] = True
        new = (int(keys[i]), ((p & ((1 << HS_PAY_BITS) - 1)) << HS_EPOCH_BITS) | epoch)
        old = (int(words[s, 0]), int(words[s, 1]))
        if old[1] & HS_EPOCH_MAX != epoch or new < old:
            words[s] = new

    def settle(i, r, idx, nxt):
        group = rep and not flags[i] & PREFOUND
        if r == 1:
            slot[i] = idx
        elif r == 0:
            tgt[i] = idx
            nxt.append(i)
            return
        else:
            st["ovf"] = True
            dead[i] = True
            slot[i] = 0
        if group:
            cas(i, slot[i])

    pend = []
    for i in g.permutation(n):
        fp = int(fps[i])
        if fp == int(SENT):
            continue
        flags[i] = LIVE
        r, idx = _walk(slab, fp)
        if r == 1:
            flags[i] |= PREFOUND
        settle(i, r, idx, pend)
    lists = [len(pend)]
    rounds = grid = 0
    left = False
    while pend:
        if rounds >= budget:
            left = True
            for i in pend:
                dead[i] = True
                slot[i] = 0
                if rep:
                    cas(i, 0)
            break
        rounds += 1
        grid += int(len(pend) > fin_lanes and grid == rounds - 1 and grid < grid_rounds)
        idx = np.asarray(pend)
        np.minimum.at(slab, tgt[idx], fps[idx])
        nxt = []
        for i in g.permutation(idx):
            if slab[tgt[i]] == fps[i]:
                slot[i] = tgt[i]
                flags[i] |= WON
                if rep:
                    cas(i, slot[i])
            else:
                r, j = _walk(slab, int(fps[i]))
                settle(i, r, j, nxt)
        pend = nxt
        lists.append(len(pend))
    group = (flags & LIVE).astype(bool) & ~(flags & PREFOUND).astype(bool)
    fresh = np.zeros(n, bool)
    if rep:
        key_w = words[slot, 0]
        pay_w = words[slot, 1]
        mine = (((pays & ((1 << HS_PAY_BITS) - 1)).astype(np.uint64) << np.uint64(HS_EPOCH_BITS))
                | np.uint64(epoch))
        fresh = group & (key_w == keys) & (pay_w == mine)
    won = (flags & WON).astype(bool)
    if undo and rep and (st["ovf"] or left):
        slab[slot[won]] = SENT
    after = int((slab != SENT).sum())
    return dict(slab=slab, fresh=fresh, n_new=int(fresh.sum()), ovf=st["ovf"], rounds=rounds,
                left=left, grid=grid, lists=lists, words=words, epoch=epoch,
                bad_pay=st["bad_pay"], live=int((fps != SENT).sum()), group=group, won=won,
                dead=dead, n_inserted=after - before)


IV_ROWS = 512  # csrc/invariants.cu: the states of a tile, a thread a state
ALL_ONES = (1 << 64) - 1


def inv_tiles_model(bad: np.ndarray, offset: int = 0, first_bad: int = -1, *, cnt=None,
                    sub: int = 0, grid: int = 1, rows: int = IV_ROWS, seed: int = 0):
    """csrc/invariants.cu ``inv_scan_tiles`` over a batch whose per-row
    verdicts are ``bad`` (bool[n]: the row violates a configured
    predicate).  The live count is ``min(n, max(0, cnt - sub))`` (``n``
    without ``cnt``, as common.cuh ``live_count``); ``grid`` blocks (those
    past the live tiles exit) each walk their tiles ``b, b + grid, ...`` in
    ascending order, the blocks' steps interleaved in a seeded random order
    (blocks run in no order); a block stops at its first tile whose first
    row plus ``offset`` is at or past the word's current value (its later
    tiles start later still); a tile's first bad row is the minimum of its
    warps' minima, and the block folds it plus ``offset`` into the word by
    an unsigned minimum, only when the tile has one.  ``first_bad`` is the
    word before the launch (an earlier result, -1 = all ones: none).
    Returns (the word as an int64, -1 for none; tiles evaluated)."""
    n = bad.shape[0]
    word = ALL_ONES if first_bad < 0 else first_bad
    live = n if cnt is None else min(n, max(0, cnt - sub))
    n_tiles = -(-live // rows)
    nxt = {b: b for b in range(min(grid, n_tiles))}
    g = np.random.default_rng(seed)
    evaluated = 0
    while nxt:
        b = sorted(nxt)[int(g.integers(len(nxt)))]
        ti = nxt[b]
        base = ti * rows
        if base + offset >= word:  # this tile and every later one of the block
            del nxt[b]
            continue
        evaluated += 1
        seg = bad[base:min(base + rows, live)]
        warp_mins = [w + int(np.flatnonzero(seg[w:w + 32])[0])
                     for w in range(0, seg.shape[0], 32) if seg[w:w + 32].any()]
        if warp_mins:
            word = min(word, base + min(warp_mins) + offset)
        nxt[b] = ti + grid
        if nxt[b] >= n_tiles:
            del nxt[b]
    return (-1 if word == ALL_ONES else word), evaluated


# -- B8 hs_probe and the grouped level's pre-filter (csrc/hashstore.cu) ---------------


def probe_walk(slab: np.ndarray, fp: int) -> tuple:
    """(found, slots passed) of fp's walk, slot by slot from its home slot:
    until fp, an empty slot or HS_PROBE_DEPTH slots, wrapping at the slab's
    end (hs_probe's walk, one thread a lane)."""
    cap = slab.shape[0]
    h0 = _mix64(fp) & (cap - 1)
    for j in range(HS_PROBE_DEPTH):
        v = int(slab[(h0 + j) & (cap - 1)])
        if v == fp:
            return True, j
        if v == int(SENT):
            return False, j
    return False, HS_PROBE_DEPTH


def probe_model(slab, fps, *, live=None) -> dict:
    """numpy model of hs_probe (csrc/hashstore.cu probe_keep): a lane below
    the live count and not SENT walks (``probe_walk``); hit = found, keep =
    live and not found; lanes past the live count are neither.  Returns
    dict(hit, keep, steps: the slots each lane's walk passed)."""
    slab = np.asarray(slab, np.uint64)
    fps = np.asarray(fps, np.uint64)
    n = fps.shape[0]
    nl = n if live is None else max(0, min(n, int(live)))
    hit = np.zeros(n, bool)
    keep = np.zeros(n, bool)
    steps = np.zeros(n, np.int64)
    for i in range(nl):
        if fps[i] != SENT:
            hit[i], steps[i] = probe_walk(slab, int(fps[i]))
            keep[i] = not hit[i]
    return dict(hit=hit, keep=keep, steps=steps)


PROBE_CAP = 4096
PROBE_KINDS = ("half", "near_depth", "wrap", "top_bit", "full_window")


def probe_homes(keys: np.ndarray, cap: int) -> np.ndarray:
    """The home slots of ``keys`` in a slab of ``cap`` slots."""
    return np.asarray([_mix64(int(k)) & (cap - 1) for k in keys], np.int64)


def probe_keys_homed(g, cap: int, lo: int, hi: int, n: int, top: bool = False) -> np.ndarray:
    """n distinct keys whose home slots lie in [lo, hi) (mod cap)."""
    out = []
    while len(out) < n:
        k = g.integers(1, 1 << 63, 4096, dtype=np.uint64)
        if top:
            k |= TOP
        h = probe_homes(k, cap)
        out += [int(x) for x, s in zip(k, h) if (s - lo) % cap < (hi - lo) % cap
                and int(x) not in out]
    return np.asarray(out[:n], np.uint64)


def _probe_lanes(g, members: np.ndarray, n: int, chunk: int, top: bool = False):
    """n candidate lanes in chunks of ``chunk`` lanes, each chunk's tail
    dead (SENT past a random count), 45 % slab members (hits), the rest
    fresh keys (misses), a few SENT lanes inside the live part; fp_full
    keys and global payloads (-1 on SENT lanes)."""
    cv = g.integers(1, 1 << 63, n, dtype=np.uint64)
    if top:
        cv |= TOP
    take = g.random(n) < 0.45
    cv[take] = members[g.integers(0, len(members), int(take.sum()))]
    cv[g.random(n) < 0.03] = SENT
    for c0 in range(0, n, chunk):
        cv[c0 + int(g.integers(chunk // 2, chunk + 1)):c0 + chunk] = SENT
    cf = g.integers(1, 1 << 63, n, dtype=np.uint64)
    cf[cv == SENT] = SENT
    cp = np.where(cv == SENT, -1, np.arange(n) * 7 + 3).astype(np.int64)
    return cv, cf, cp


def probe_case(kind: str, insert):
    """(slab u64[PROBE_CAP], probe lanes (cv, cf, cp)) of one of
    ``PROBE_KINDS``: ``half`` a slab at load about 1/2; ``near_depth`` one
    run of 58 keys homed in 2 slots, walks near PROBE_DEPTH; ``wrap`` a run
    across the slab's last slot, walks that wrap; ``top_bit`` every
    fingerprint with the top bit; ``full_window`` 70 full slots with no
    empty one, walks that stop at PROBE_DEPTH (a key at step 63 found, one
    at step 64 not).  ``insert(slab, keys)`` builds the slab (the
    reference's insert in the CPU tests)."""
    CAP = PROBE_CAP  # noqa: N806
    g = np.random.default_rng(PROBE_KINDS.index(kind))
    slab = np.full(CAP, SENT, np.uint64)
    top = kind == "top_bit"
    members = g.integers(1, 1 << 63, CAP // 2 - 80, dtype=np.uint64)
    if top:
        members |= TOP
    if kind == "near_depth":  # one run of 58 keys homed in 2 slots, nothing near it
        h = probe_homes(members, CAP)
        members = np.concatenate([probe_keys_homed(g, CAP, 2000, 2002, 58),
                                  members[(h < 1936) | (h >= 2200)]])
    if kind == "wrap":  # a run across the slab's last slot
        h = probe_homes(members, CAP)
        members = np.concatenate([probe_keys_homed(g, CAP, CAP - 6, CAP, 40),
                                  members[(h < CAP - 70) & (h >= 70)]])
    if kind == "full_window":
        h = probe_homes(members, CAP)
        members = members[(h < 900) | (h >= 1200)]
    slab = insert(slab, members)
    if kind == "full_window":
        # 70 slots from 1000 full of other fingerprints, no empty slot on
        # them: walks homed there stop after PROBE_DEPTH slots (a key at
        # step 63 is found, one at step 64 is not)
        slab[1000:1070] = g.integers(1, 1 << 63, 70, dtype=np.uint64)
        at = probe_keys_homed(g, CAP, 1000, 1001, 3)
        slab[1000 + 63], slab[1000 + 64] = at[0], at[1]
    cv, cf, cp = _probe_lanes(g, members, 3072, 768, top=top)
    if kind == "full_window":
        cv[:3] = at  # found, not found (past the depth), not found (walks 64)
    if kind == "near_depth":
        cv[:40] = np.concatenate([members[:20], probe_keys_homed(g, CAP, 2000, 2002, 20)])
    if kind == "wrap":
        cv[:40] = np.concatenate([members[:20], probe_keys_homed(g, CAP, CAP - 3, CAP, 20)])
    cf[:40], cp[:40] = 5, np.arange(40) * 7 + 3
    return slab, (cv, cf, cp)


# -- B13 sieve probe (csrc/sieve.cu) --------------------------------------------------

SV_THREADS = 256
SV_LANES = 4
SV_BLOCKS = 660  # one wave of resident blocks on an H100 (the kernel asks the card)
_SV_C2 = 0x94D9ECA592EAF335
_SV_SALT = 0x9E3779B97F4A7C15


def _sieve_mix(x: int) -> int:
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * _SV_C2) & _M64
    return x ^ (x >> 31)


def _sieve_hit(words: np.ndarray, fp: int) -> bool:
    h2 = _sieve_mix(fp ^ _SV_SALT)
    mask = 0
    for b in range(4):
        mask |= 1 << ((h2 >> (6 * b)) & 63)
    w = int(words[0]) if words.shape[0] == 1 else int(words[_sieve_mix(fp) & (words.shape[0] - 1)])
    return (w & mask) == mask


def sieve_blocks_model(words, fps, *, live=None, offset: int = 0, with_hit: bool = True,
                       threads: int = SV_THREADS, blocks: int = SV_BLOCKS, seed: int = 0) -> dict:
    """numpy model of csrc/sieve.cu's schedule: ``fps`` is a view whose
    first lane sits ``offset`` lanes past a 16-B boundary, so an odd offset
    gives one scalar head lane; then groups of 4 consecutive lanes, a
    thread a group, warp-uniform grid-stride trips over a grid of
    min(``blocks``, n / 1024) blocks; the scalar tail (at most 3 lanes) and
    the head in the first warp of block 0.  Lanes at or past ``live`` are not probed and
    their flags are 0 (with hit, every lane is written; without, only up to
    live).  A warp's hits (live, not SENT) are counted by ballots, the
    block's summed, one atomic a block with hits.  Blocks run in a seeded
    order.  Returns dict(hit, count, block_counts, atomics, vector_groups:
    the groups read as two 16-B loads)."""
    g = np.random.default_rng(seed)
    words = np.asarray(words, np.uint64)
    fps = np.asarray(fps, np.uint64)
    n = fps.shape[0]
    nl = n if live is None else max(0, min(n, int(live)))
    end = n if with_hit else nl
    head = 1 if offset % 2 and end > 0 else 0
    groups = (end - head) // SV_LANES
    tail0 = head + groups * SV_LANES
    grid = max(1, min(blocks, -(-n // (threads * SV_LANES))))
    nth = grid * threads
    hit = np.zeros(n, bool)
    written = np.zeros(n, np.int64)
    block_counts = np.zeros(grid, np.int64)
    vector = 0

    def probe(i: int) -> tuple:
        if i >= nl:
            return False, False
        fp = int(fps[i])
        h = _sieve_hit(words, fp)
        return h, h and fp != int(SENT)

    for b in g.permutation(grid):
        for w in range(threads // 32):
            for g0 in range(b * threads + w * 32, groups, nth):
                for lane in range(32):
                    gi = g0 + lane
                    if gi >= groups:
                        continue
                    i0 = head + gi * SV_LANES
                    vector += i0 + SV_LANES <= nl
                    for k in range(SV_LANES):
                        h, c = probe(i0 + k)
                        hit[i0 + k] = h
                        written[i0 + k] += 1
                        block_counts[b] += c
        if b == 0:
            scalar = ([0] if head else []) + list(range(tail0, end))
            assert len(scalar) <= 4
            for i in scalar:
                h, c = probe(i)
                hit[i] = h
                written[i] += 1
                block_counts[b] += c
    assert (written[:end] == 1).all() and (written[end:] == 0).all()
    return dict(hit=hit if with_hit else None, count=int(block_counts.sum()),
                block_counts=block_counts, atomics=int((block_counts > 0).sum()),
                vector_groups=vector)
