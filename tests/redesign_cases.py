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
``fingerprint_s3``).
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
