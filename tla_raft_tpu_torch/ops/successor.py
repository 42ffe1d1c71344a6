"""The successor fan-out layout: Raft's ``Next`` as K slots per state.

The port of the slot layout and ``GuardTables`` of
``tla_raft_tpu/ops/successor.py``.  Every action x existential witness
is one **slot**, a (family, server, witness...) coordinate; the slot
order (family order, witness grids raveled C-style) is the reference's,
so payloads ``parent * K + slot``, traces and coverage agree bit for
bit:

  family  0 BecomeCandidate(s)            Raft.tla:107-130   W = S
  family  1 UpdateTerm(s) branch (a)      Raft.tla:178-182   W = S*T
  family  2 UpdateTerm(s) branch (b)      Raft.tla:183-188   W = S
  family  3 ResponseVote(s, cand)         Raft.tla:132-155   W = S*S
  family  4 BecomeLeader(s)               Raft.tla:157-173   W = S
  family  5 ClientReq(s, v)               Raft.tla:233-240   W = S*V
  family  6 LeaderAppendEntry(s, dst)     Raft.tla:242-269   W = S*S
  family  7 FollowerAcceptEntry(s, src,   Raft.tla:275-300   W = S*S*L*E*L
              pli, entry, leaderCommit)
  family  8 FollowerRejectEntry(s, src,   Raft.tla:302-321   W = S*S*L
              pli)
  family  9 HandleAppendResp(s, src,      Raft.tla:374-396   W = S*S*L*2
              pli, success)
  family 10 LeaderCanCommit(s)            Raft.tla:398-407   W = S
  family 11 Restart(s)                    Raft.tla:409-414   W = S

The guards and updates of each family are implemented twice: by the
kernels (csrc/guards.cu, csrc/materialize.cu: one thread per slot or per
lane, following the family's guard and update term by term) and by
their plain twins in ops/mxu_expand.py, ports of the reference's
guard-matrix and select-matrix formulations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import APPEND_REQ, VOTE_REQ, VOTE_RESP, RaftConfig
from ..device import resolve_device
from .msg_universe import get_universe

FAMILY_NAMES = (
    "BecomeCandidate", "UpdateTerm", "UpdateTerm", "ResponseVote",
    "BecomeLeader", "ClientReq", "LeaderAppendEntry", "FollowerAcceptEntry",
    "FollowerRejectEntry", "HandleAppendResp", "LeaderCanCommit", "Restart",
)


def _pack(uni, bits: np.ndarray) -> np.ndarray:
    return uni.pack_bits(bits.astype(np.uint8))


class GuardTables:
    """Pattern masks over the message universe: each row is a packed
    bitmask (u32 words held as int32) selecting the messages of one
    (type, src, dst, term, ...) pattern; a guard is ``msgs & row``
    followed by any / popcount.  Servers and terms index 0-based rows
    (term t -> row t - 1).  The kernels compute the same id ranges
    arithmetically; the invariant probes read ``aq_block``."""

    def __init__(self, cfg: RaftConfig, device=None):
        device = resolve_device(device)
        uni = get_universe(cfg)
        self.uni = uni
        S, T, L = cfg.S, cfg.T, cfg.L
        W = uni.n_words

        def dev(a):
            return torch.from_numpy(a.view(np.int32)).to(device)

        # any message / AppendReq to dst at term t (UpdateTerm, Raft.tla:178-185)
        self.any_to = dev(uni.dst_term_any_mask)
        self.aq_to = dev(uni.dst_term_appendreq_mask)
        # VoteResp to dst at term t (BecomeLeader count, Raft.tla:160-164)
        vp = np.zeros((S, T, W), np.uint32)
        for d in range(1, S + 1):
            for t in range(1, T + 1):
                vp[d - 1, t - 1] = _pack(uni, (uni.typ == VOTE_RESP) & (uni.dst == d) & (uni.term == t))
        self.vp_to = dev(vp)
        # up-to-date VoteReq from c to d at term t given the receiver's
        # (lastLogTerm, lastLogIndex) (Raft.tla:145-147)
        vq = np.zeros((S, S, T, T + 1, L, W), np.uint32)
        blk = np.zeros((S, S, T, L, W), np.uint32)
        sub = np.zeros((S, S, T, L, T + 1, W), np.uint32)
        for c in range(1, S + 1):
            for d in range(1, S + 1):
                if c == d:
                    continue
                for t in range(1, T + 1):
                    sel = (uni.typ == VOTE_REQ) & (uni.src == c) & (uni.dst == d) & (uni.term == t)
                    for myllt in range(T + 1):
                        for mylli in range(1, L + 1):
                            ok = (uni.llt > myllt) | ((uni.llt == myllt) & (uni.lli >= mylli))
                            vq[c - 1, d - 1, t - 1, myllt, mylli - 1] = _pack(uni, sel & ok)
                    # AppendReq blocks by (src, dst, term, pli), and per prevLogTerm
                    sel0 = (uni.typ == APPEND_REQ) & (uni.src == c) & (uni.dst == d) & (uni.term == t)
                    for pli in range(1, L + 1):
                        sel1 = sel0 & (uni.pli == pli)
                        blk[c - 1, d - 1, t - 1, pli - 1] = _pack(uni, sel1)
                        for plt in range(T + 1):
                            sub[c - 1, d - 1, t - 1, pli - 1, plt] = _pack(uni, sel1 & (uni.plt == plt))
        self.vq_uptodate = dev(vq)
        self.aq_block = dev(blk)
        self.aq_plt = dev(sub)


class SlotLayout:
    """The fan-out's slot grid for one config: ``families`` (name,
    witness coords [W, 5]), ``slot_family`` i32[K], ``slot_coords``
    i32[K, 5], K and A (the most messages one action sends)."""

    def __init__(self, cfg: RaftConfig):
        self.cfg = cfg
        uni = get_universe(cfg)
        S, T, L, V = cfg.S, cfg.T, cfg.L, cfg.V
        E = uni.n_entry
        self.A = max(S - 1, 1)

        def grid(*dims):
            g = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
            out = np.zeros((int(np.prod(dims)), 5), np.int32)
            for i, x in enumerate(g):
                out[:, i] = x.ravel()
            return out

        names = list(FAMILY_NAMES)
        if "become-follower" in cfg.mutations:
            names[1] = names[2] = "BecomeFollower"
        if "legacy-append" in cfg.mutations:
            names[7] = names[8] = "FollowerAppendEntry"
        grids = [
            grid(S), grid(S, T), grid(S), grid(S, S), grid(S), grid(S, V),
            grid(S, S), grid(S, S, L, E, L), grid(S, S, L), grid(S, S, L, 2),
            grid(S), grid(S),
        ]
        self.families = list(zip(names, grids))
        self.slot_family = np.concatenate(
            [np.full(c.shape[0], fi, np.int32) for fi, (_, c) in enumerate(self.families)]
        )
        self.slot_coords = np.concatenate([c for _, c in self.families])
        self.K = int(self.slot_family.shape[0])
        # [K, 6] = (family, c0..c4): the slot table the kernels read
        self.slot_table_np = np.ascontiguousarray(
            np.concatenate([self.slot_family[:, None], self.slot_coords], axis=1),
            dtype=np.int32,
        )

    def action_name(self, slot: int) -> str:
        fam = int(self.slot_family[slot])
        server = int(self.slot_coords[slot, 0]) + 1
        return f"{self.families[fam][0]}({server})"

    def action_counts(self, mult_per_slot: np.ndarray) -> dict:
        """Per-slot fired-transition counts folded to action names (the
        TLC -coverage analog; the two UpdateTerm families sum)."""
        out: dict[str, int] = {}
        for fi, (name, _c) in enumerate(self.families):
            out[name] = out.get(name, 0) + int(mult_per_slot[self.slot_family == fi].sum())
        return {k: v for k, v in out.items() if v}


@functools.lru_cache(maxsize=16)
def get_layout(cfg: RaftConfig) -> SlotLayout:
    return SlotLayout(cfg)



# -- scalar transcriptions: one state, one slot ------------------------------
#
# The per-lane definition that kernels K1 (csrc/guards.cu) and K2
# (csrc/materialize.cu) implement, in plain Python on one state's values
# (a dict of numpy rows, the ``encode_np`` layout without the batch axis,
# plus the sorted message-id set).  They transcribe the actions of
# Raft.tla as the reference's scalar kernels do (tla_raft_tpu/ops/
# successor.py:356-730), with the witness collapse of the slot grid, and
# follow the same clips, so they agree with the plain twins on every
# slot.  Tests hold them against the twins; nothing on the main path
# calls them.


class ScalarActions:
    """``guard(st, slot)`` -> (valid, mult, abort) and ``apply(st, slot)``
    -> (child, sent ids) for one state of one config."""

    def __init__(self, cfg: RaftConfig):
        self.cfg = cfg
        self.uni = get_universe(cfg)
        self.layout = get_layout(cfg)

    # message-id encoders (ops/msg_universe.py layout, pair digits)
    def _pair(self, a0: int, b0: int) -> int:
        return a0 * (self.cfg.S - 1) + (b0 - (1 if b0 > a0 else 0))

    def _vq(self, p, term, lli, llt):
        c, u = self.cfg, self.uni
        return u.vq_off + ((p * c.T + term - 1) * c.L + lli - 1) * c.T + llt

    def _vp(self, p, term):
        return self.uni.vp_off + p * self.cfg.T + term - 1

    def _aq(self, p, term, pli, plt, entry, lc):
        c, u = self.cfg, self.uni
        x = ((p * c.T + term - 1) * c.L + pli - 1) * (c.T + 1) + plt
        return u.aq_off + (x * u.n_entry + entry) * c.L + lc - 1

    def _ap(self, p, term, pli, succ):
        c, u = self.cfg, self.uni
        return u.ap_off + ((p * c.T + term - 1) * u.ap_npli + pli - u.ap_pli_min) * 2 + succ

    def _median(self, row) -> int:
        S, mi = self.cfg.S, self.cfg.median_index
        for u in range(S):
            pos = sum((row[w] < row[u]) + (w < u and row[w] == row[u]) for w in range(S))
            if pos == mi:
                return int(row[u])
        return 0

    def guard(self, st: dict, ids: frozenset, slot: int):
        """Raft.tla guards of one slot: (valid, mult, abort) — ``abort`` is
        the split-brain Assert (Raft.tla:185), raised by UpdateTerm (b)."""
        cfg, uni = self.cfg, self.uni
        S, T, L, V, E = cfg.S, cfg.T, cfg.L, cfg.V, uni.n_entry
        fam = int(self.layout.slot_family[slot])
        s, c1, c2, c3, c4 = (int(x) for x in self.layout.slot_coords[slot])
        ct, role, ll = int(st["current_term"][s]), int(st["role"][s]), int(st["log_len"][s])
        ci, lt, lv = int(st["commit_index"][s]), st["log_term"][s], st["log_val"][s]
        tix = min(max(ct - 1, 0), T - 1)
        has_term = ct >= 1
        clip = lambda x, lo, hi: min(max(x, lo), hi)  # noqa: E731

        def count(a, n):
            return sum(1 for m in range(a, a + n) if m in ids)

        ok, mult, abort = False, 1, False
        if fam == 0:  # BecomeCandidate (Raft.tla:107-130)
            ok = role in (0, 1) and int(st["election_count"]) < cfg.max_election
        elif fam == 1:  # UpdateTerm (a): a message to s at a higher term
            cnt = 0
            for src in range(S):
                if src != s:
                    p = self._pair(src, s)
                    cnt += count(self._vq(p, c1 + 1, 1, 0), L * T)
                    cnt += count(self._vp(p, c1 + 1), 1)
                    cnt += count(self._aq(p, c1 + 1, 1, 0, 0, 1), L * (T + 1) * E * L)
                    cnt += count(uni.ap_off + (p * T + c1) * uni.ap_npli * 2, uni.ap_npli * 2)
            ok, mult = c1 + 1 > ct and cnt > 0, cnt
        elif fam == 2:  # UpdateTerm (b): an AppendReq at the current term
            cnt = sum(count(self._aq(self._pair(src, s), tix + 1, 1, 0, 0, 1),
                            L * (T + 1) * E * L) for src in range(S) if src != s)
            ok, mult = role == 1 and has_term and cnt > 0, cnt
            abort = "become-follower" not in cfg.mutations and has_term and cnt > 0 and role == 2
        elif fam == 3:  # ResponseVote(s, cand) (Raft.tla:132-155)
            vf = int(st["voted_for"][s])
            vf_ok = "double-vote" in cfg.mutations or vf in (0, c1 + 1)
            qual = grant = 0
            if c1 != s:
                lpos = clip(ll - 1, 0, L - 1)
                myllt = clip(int(lt[lpos]), 0, T)
                p = self._pair(c1, s)
                qual = sum(1 for l0 in range(L) for k in range(T)
                           if (k > myllt or (k == myllt and l0 >= lpos))
                           and self._vq(p, tix + 1, l0 + 1, k) in ids)
                grant = int(self._vp(self._pair(s, c1), tix + 1) in ids)
            ok = role == 0 and has_term and vf_ok and c1 != s and qual > 0 and grant == 0
            mult = qual
        elif fam == 4:  # BecomeLeader: a majority of votes (Raft.tla:157-173)
            votes = sum(self._vp(self._pair(src, s), tix + 1) in ids
                        for src in range(S) if src != s)
            ok = role == 1 and votes + 1 >= cfg.majority
        elif fam == 5:  # ClientReq(s, v) (Raft.tla:233-240)
            ok = role == 2 and int(st["val_sent"][c1]) == 0 and ll < L
        elif fam == 6:  # LeaderAppendEntry(s, d): the request not in flight
            nsd = int(st["next_index"][s][c1])
            present = False
            if c1 != s:
                epos = clip(nsd - 1, 0, L - 1)
                ecode = (1 + (clip(int(lt[epos]), 1, T) - 1) * V + clip(int(lv[epos]), 1, V) - 1
                         if nsd <= ll else 0)
                present = self._aq(self._pair(s, c1), clip(ct, 1, T), clip(nsd - 1, 1, L),
                                   clip(int(lt[clip(nsd - 2, 0, L - 1)]), 0, T), ecode,
                                   clip(ci, 1, L)) in ids
            ok = (role == 2 and int(st["pending"][s][c1]) == 0 and nsd <= ll + 1
                  and c1 != s and not present)
        elif fam == 7:  # FollowerAcceptEntry(s, src, pli, e, lc) (Raft.tla:275-300)
            present = False
            if c1 != s:
                present = self._aq(self._pair(c1, s), tix + 1, c2 + 1,
                                   clip(int(lt[c2]), 0, T), c3, c4 + 1) in ids
                if "legacy-append" in cfg.mutations:  # Raft.tla:347-348
                    nl = c2 + 1 + (c3 > 0)
                    resp = self._ap(self._pair(s, c1), tix + 1, min(nl, L), 1) in ids
                    present = present and (not resp or min(c4 + 1, nl) > ci)
            ok = role == 0 and has_term and c2 + 1 <= ll and c1 != s and present
        elif fam == 8:  # FollowerRejectEntry(s, src, pli) (Raft.tla:302-321)
            cnt = rej = 0
            if c1 != s:
                p = self._pair(c1, s)
                tot = count(self._aq(p, tix + 1, c2 + 1, 0, 0, 1), (T + 1) * E * L)
                match = count(self._aq(p, tix + 1, c2 + 1, clip(int(lt[c2]), 0, T), 0, 1), E * L)
                cnt = tot - (match if c2 + 1 <= ll else 0)
                rej = int(self._ap(self._pair(s, c1), tix + 1, c2 + uni.ap_pli_min, 0) in ids)
            ok, mult = role == 0 and has_term and c1 != s and cnt > 0 and rej == 0, cnt
        elif fam == 9:  # HandleAppendResp(s, src, pli, succ) (Raft.tla:374-396)
            pli = c2 + 1
            msd, nsd = int(st["match_index"][s][c1]), int(st["next_index"][s][c1])
            st_ok = msd < pli if c3 == 1 else (pli + 1 == nsd and pli > msd)
            present = c1 != s and self._ap(self._pair(c1, s), tix + 1, pli, c3) in ids
            ok = role == 2 and has_term and int(st["pending"][s][c1]) == 1 and st_ok and present
        elif fam == 10:  # LeaderCanCommit (Raft.tla:398-407)
            ok = role == 2 and self._median(st["match_index"][s]) > ci
        else:  # Restart (Raft.tla:409-414)
            ok = role == 2 and int(st["restart_count"]) < cfg.max_restart
        return bool(ok), (mult if ok else 0), bool(abort)

    def apply(self, st: dict, slot: int):
        """The child of one slot (a new dict) and the ids it sends (-1
        padded to A): the update half of the action."""
        cfg, uni = self.cfg, self.uni
        S, T, L, V, E = cfg.S, cfg.T, cfg.L, cfg.V, uni.n_entry
        A = self.layout.A
        ch = {k: np.array(v, copy=True) for k, v in st.items()}
        fam = int(self.layout.slot_family[slot])
        s, c1, c2, c3, c4 = (int(x) for x in self.layout.slot_coords[slot])
        ct, role, ll = int(st["current_term"][s]), int(st["role"][s]), int(st["log_len"][s])
        ci, lt, lv = int(st["commit_index"][s]), st["log_term"][s], st["log_val"][s]
        clip = lambda x, lo, hi: min(max(x, lo), hi)  # noqa: E731
        u8 = lambda x: x & 0xFF  # noqa: E731
        sent = [-1] * A
        ap_stride = T * uni.ap_npli * 2
        if fam == 0:
            nt = clip(ct + 1, 1, T)
            lpos = max(ll - 1, 0)
            llt = clip(int(lt[lpos]) if lpos < L else 0, 0, T - 1)
            ch["current_term"][s], ch["role"][s], ch["voted_for"][s] = nt, 1, s + 1
            ch["election_count"] = np.uint8(u8(int(st["election_count"]) + 1))
            for r in range(A):
                sent[r] = (uni.vq_off + self._pair(s, (s + 1 + r) % S) * T * L * T
                           + ((nt - 1) * L + ll - 1) * T + llt)
        elif fam == 1:
            keep = "become-follower" in cfg.mutations and role == 0
            ch["voted_for"][s] = int(st["voted_for"][s]) if keep else 0
            ch["current_term"][s], ch["role"][s] = c1 + 1, 0
        elif fam == 2:
            ch["role"][s] = 0
        elif fam == 3:
            ch["voted_for"][s] = c1 + 1
            sent[0] = uni.vp_off + self._pair(s, c1) * T + max(ct, 1) - 1
        elif fam == 4:
            ch["role"][s] = 2
            ch["match_index"][s] = [u8(ll) if u == s else 1 for u in range(S)]
            ch["next_index"][s] = u8(ll + 1)
            ch["pending"][s] = 0
        elif fam == 5:
            at = clip(ll, 0, L - 1)
            ch["log_term"][s][at], ch["log_val"][s][at] = ct, c1 + 1
            ch["log_len"][s] = u8(ll + 1)
            ch["match_index"][s][s] = u8(ll + 1)
            ch["val_sent"][c1] = 1
        elif fam == 6:
            nsd = int(st["next_index"][s][c1])
            epos = clip(nsd - 1, 0, L - 1)
            ecode = (1 + (clip(int(lt[epos]), 1, T) - 1) * V + clip(int(lv[epos]), 1, V) - 1
                     if nsd <= ll else 0)
            ch["pending"][s][c1] = 1
            sent[0] = self._aq(self._pair(s, c1), clip(ct, 1, T), clip(nsd - 1, 1, L),
                               clip(int(lt[clip(nsd - 2, 0, L - 1)]), 0, T), ecode, ci)
        elif fam == 7:
            pli, e = c2 + 1, c3
            el = int(e > 0)
            eterm, evl = ((e - 1) // V + 1, (e - 1) % V + 1) if el else (0, 0)
            nl = pli + el
            pos = min(pli, L - 1)
            conflict = el and pli < ll and (int(lt[pos]) != eterm or int(lv[pos]) != evl)
            if nl > ll or conflict:
                for j in range(L):
                    at = el and j == pos
                    ch["log_term"][s][j] = eterm if at else (lt[j] if j < pli else 0)
                    ch["log_val"][s][j] = evl if at else (lv[j] if j < pli else 0)
                ch["log_len"][s] = nl
            ch["commit_index"][s] = max(ci, min(c4 + 1, nl))
            sent[0] = (uni.ap_off + self._pair(s, c1) * ap_stride
                       + (clip(nl, 1, L) - uni.ap_pli_min) * 2 + 1
                       + (clip(ct, 1, T) - 1) * uni.ap_npli * 2)
        elif fam == 8:
            rej_pli = c2 + (0 if "legacy-append" in cfg.mutations else 1)
            sent[0] = (uni.ap_off + self._pair(s, c1) * ap_stride
                       + (rej_pli - uni.ap_pli_min) * 2 + (clip(ct, 1, T) - 1) * uni.ap_npli * 2)
        elif fam == 9:
            if c3 == 1:
                ch["match_index"][s][c1] = c2 + 1
            ch["next_index"][s][c1] = c2 + 1 + c3
            ch["pending"][s][c1] = 0
        elif fam == 10:
            ch["commit_index"][s] = self._median(st["match_index"][s])
        else:
            ch["role"][s] = 0
            ch["restart_count"] = np.uint8(u8(int(st["restart_count"]) + 1))
        return ch, sent


# -- the legacy per-lane materialize (B20), plain twin ---------------------------
#
# The reference keeps its per-lane kernels (successor.py:364-748: a
# ``lax.switch`` over the 12 families of scalar actions, then the SendMsg
# union of the added ids) as the A/B reference of the matrix forms and as
# the ``--audit`` re-expansion.  ``materialize_legacy_plain`` is that
# switch with the lanes as a batch: each family's lanes are picked out and
# updated by the family's action, as the scalar transcriptions write it;
# the kernel ``legacy_materialize`` (csrc/legacy.cu) is the same switch,
# one thread per lane.


def _median_rows(rows: torch.Tensor, median_index: int) -> torch.Tensor:
    """Median(F) (Raft.tla:70-75) of each row of ``rows`` [n, S] (int64):
    the element whose stable ascending position is ``median_index``."""
    S = rows.shape[1]
    ar = torch.arange(S, device=rows.device)
    pos = (rows[:, None, :] < rows[:, :, None]).sum(-1) + (
        (rows[:, None, :] == rows[:, :, None]) & (ar[None, :] < ar[:, None])).sum(-1)
    return (rows * (pos == median_index).to(torch.int64)).sum(-1)


def materialize_legacy_plain(cfg: RaftConfig, fr, pidx: torch.Tensor, slots: torch.Tensor):
    """Children of the (parent row, slot) lanes by the scalar actions
    (the reference's ``_materialize_added``, successor.py:735, with the
    message set carried as ids): (child Frontier [G], added i32[G, A],
    overflow bool[G]); the sent ids go into the parent's sorted id list
    (``ids_insert``, the port of ``JaxChecker._ids_insert``)."""
    from ..models.raft import Frontier
    from .mxu_expand import ids_insert

    uni = get_universe(cfg)
    lay = get_layout(cfg)
    S, T, L, V, E = cfg.S, cfg.T, cfg.L, cfg.V, uni.n_entry
    A = lay.A
    I64_ = torch.int64
    dev = pidx.device
    n = fr.voted_for.shape[0]
    p = pidx.to(I64_).clamp(0, n - 1)
    sl = slots.to(I64_).clamp(0, lay.K - 1)
    G = p.shape[0]
    ch = {f: getattr(fr, f)[p].to(I64_) for f in Frontier._fields[:-1]}
    tab = torch.from_numpy(lay.slot_table_np.astype(np.int64)).to(dev)[sl]
    fam, s, c1, c2, c3, c4 = (tab[:, i] for i in range(6))
    sent = torch.full((G, A), -1, dtype=I64_, device=dev)
    def pair(a, b):
        return a * (S - 1) + b - (b > a).to(I64_)

    def clip(x, lo, hi):
        return x.clamp(lo, hi)

    def lanes(f):
        return torch.nonzero(fam == f).reshape(-1)

    def get1(field, i):  # field[s] of lanes i
        return ch[field][i, s[i]]

    def set1(field, i, val):
        ch[field][i, s[i]] = val

    ct0 = ch["current_term"].clone()  # the parent's values (fields change below)
    ll0 = ch["log_len"].clone()
    ci0 = ch["commit_index"].clone()
    lt0 = ch["log_term"].clone()
    lv0 = ch["log_val"].clone()
    mi0 = ch["match_index"].clone()
    ni0 = ch["next_index"].clone()
    role0 = ch["role"].clone()
    vf0 = ch["voted_for"].clone()

    # BecomeCandidate(s) (Raft.tla:107-130)
    i = lanes(0)
    if i.numel():
        si = s[i]
        nt = clip(ct0[i, si] + 1, 1, T)
        ll = ll0[i, si]
        llt = clip(lt0[i, si, clip(ll - 1, 0, L - 1)], 0, T - 1)
        set1("current_term", i, nt)
        set1("role", i, torch.full_like(nt, 1))
        set1("voted_for", i, si + 1)
        ch["election_count"][i] = (ch["election_count"][i] + 1) & 0xFF
        for r in range(A):
            peer = (si + 1 + r) % S
            sent[i, r] = uni.vq_off + (((pair(si, peer) * T + nt - 1) * L + ll - 1) * T + llt)
    # UpdateTerm (a) / BecomeFollower (Raft.tla:178-182, 192-197)
    i = lanes(1)
    if i.numel():
        si = s[i]
        keep = (role0[i, si] == 0) if "become-follower" in cfg.mutations else torch.zeros_like(si, dtype=torch.bool)
        set1("voted_for", i, torch.where(keep, vf0[i, si], torch.zeros_like(si)))
        set1("current_term", i, c1[i] + 1)
        set1("role", i, torch.zeros_like(si))
    # UpdateTerm (b) (Raft.tla:183-188)
    i = lanes(2)
    if i.numel():
        set1("role", i, torch.zeros_like(s[i]))
    # ResponseVote(s, cand) (Raft.tla:132-155)
    i = lanes(3)
    if i.numel():
        si, cand = s[i], c1[i]
        set1("voted_for", i, cand + 1)
        sent[i, 0] = uni.vp_off + pair(si, cand) * T + clip(ct0[i, si], 1, 255) - 1
    # BecomeLeader(s) (Raft.tla:157-173)
    i = lanes(4)
    if i.numel():
        si = s[i]
        ll = ll0[i, si]
        ar = torch.arange(S, device=dev)
        set1("role", i, torch.full_like(si, 2))
        ch["match_index"][i, si] = torch.where(ar[None, :] == si[:, None], ll[:, None],
                                               torch.ones_like(ll)[:, None])
        ch["next_index"][i, si] = (ll + 1)[:, None].expand(-1, S)
        ch["pending"][i, si] = 0
    # ClientReq(s, v) (Raft.tla:233-240)
    i = lanes(5)
    if i.numel():
        si, v = s[i], c1[i]
        ll = ll0[i, si]
        at = clip(ll, 0, L - 1)
        ch["val_sent"][i, v] = 1
        ch["log_term"][i, si, at] = ct0[i, si]
        ch["log_val"][i, si, at] = v + 1
        set1("log_len", i, ll + 1)
        ch["match_index"][i, si, si] = ll + 1
    # LeaderAppendEntry(s, dst) (Raft.tla:242-269)
    i = lanes(6)
    if i.numel():
        si, d = s[i], c1[i]
        nsd = ni0[i, si, d]
        ll = ll0[i, si]
        pli = clip(nsd - 1, 1, L)
        plt = clip(lt0[i, si, clip(nsd - 2, 0, L - 1)], 0, T)
        epos = clip(nsd - 1, 0, L - 1)
        ecode = torch.where(nsd <= ll, 1 + (clip(lt0[i, si, epos], 1, T) - 1) * V
                            + clip(lv0[i, si, epos], 1, V) - 1, torch.zeros_like(nsd))
        ch["pending"][i, si, d] = 1
        x = ((pair(si, d) * T + clip(ct0[i, si], 1, T) - 1) * L + pli - 1) * (T + 1) + plt
        sent[i, 0] = uni.aq_off + (x * E + ecode) * L + ci0[i, si] - 1
    # FollowerAcceptEntry(s, src, pli, e, lc) (Raft.tla:275-300)
    i = lanes(7)
    if i.numel():
        si, src, pli, e, lc = s[i], c1[i], c2[i] + 1, c3[i], c4[i] + 1
        ll = ll0[i, si]
        lt, lv = lt0[i, si], lv0[i, si]  # [g, L]
        el = (e > 0).to(I64_)
        eterm = torch.where(el == 1, torch.div(e - 1, V, rounding_mode="floor") + 1, 0 * e)
        evl = torch.where(el == 1, torch.remainder(e - 1, V) + 1, 0 * e)
        nl = pli + el
        pos = clip(pli, 0, L - 1)
        ar = torch.arange(L, device=dev)[None, :]
        at_pos = ar == pos[:, None]
        conflict = (el == 1) & (pli < ll) & (((at_pos * lt).sum(1) != eterm)
                                             | ((at_pos * lv).sum(1) != evl))
        updated = (nl > ll) | conflict
        keep = ar < pli[:, None]
        at_entry = at_pos & (el == 1)[:, None]
        new_lt = torch.where(at_entry, eterm[:, None], torch.where(keep, lt, 0 * lt))
        new_lv = torch.where(at_entry, evl[:, None], torch.where(keep, lv, 0 * lv))
        ch["log_term"][i, si] = torch.where(updated[:, None], new_lt, lt)
        ch["log_val"][i, si] = torch.where(updated[:, None], new_lv, lv)
        set1("log_len", i, torch.where(updated, nl, ll))
        set1("commit_index", i, torch.maximum(ci0[i, si], torch.minimum(lc, nl)))
        sent[i, 0] = uni.ap_off + ((pair(si, src) * T + clip(ct0[i, si], 1, T) - 1) * uni.ap_npli
                                   + clip(nl, 1, L) - uni.ap_pli_min) * 2 + 1
    # FollowerRejectEntry(s, src, pli) (Raft.tla:302-321): sends the reject only
    i = lanes(8)
    if i.numel():
        si, src = s[i], c1[i]
        rej_pli = c2[i] + (0 if "legacy-append" in cfg.mutations else 1)
        sent[i, 0] = uni.ap_off + ((pair(si, src) * T + clip(ct0[i, si], 1, T) - 1) * uni.ap_npli
                                   + rej_pli - uni.ap_pli_min) * 2
    # HandleAppendResp(s, src, pli, succ) (Raft.tla:374-396)
    i = lanes(9)
    if i.numel():
        si, src, pli, sc = s[i], c1[i], c2[i] + 1, c3[i]
        ch["match_index"][i, si, src] = torch.where(sc == 1, pli, mi0[i, si, src])
        ch["next_index"][i, si, src] = pli + sc
        ch["pending"][i, si, src] = 0
    # LeaderCanCommit(s) (Raft.tla:398-407)
    i = lanes(10)
    if i.numel():
        set1("commit_index", i, _median_rows(mi0[i, s[i]], cfg.median_index))
    # Restart(s) (Raft.tla:409-414)
    i = lanes(11)
    if i.numel():
        set1("role", i, torch.zeros_like(s[i]))
        ch["restart_count"][i] = (ch["restart_count"][i] + 1) & 0xFF
    added = sent.to(torch.int32)
    ids, ovf = ids_insert(fr.msg_ids[p], added, uni.M)
    child = Frontier(msg_ids=ids, **{f: (v & 0xFF).to(torch.uint8) for f, v in ch.items()})
    return child, added, ovf
