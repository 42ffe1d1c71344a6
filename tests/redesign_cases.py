"""Seeded edge-case inputs of the two redesigned kernels, in numpy (no JAX:
the ``cuda`` tests import them on a machine without it).

``dedup_case``: a level's lanes and a sorted store for B19's
``_level_dedup`` (``level_dedup``); ``k3_id_lists``: S=7 message id lists
for K3's factored message part (``msg_hash_factored`` / ``orbit_fold``).
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
