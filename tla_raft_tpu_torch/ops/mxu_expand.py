"""Guards (kernel K1) and materialize (kernel K2), with their plain twins.

The port of ``tla_raft_tpu/ops/mxu_expand.py``.  The reference evaluates
the static half of every action guard as one ``phi @ W == theta``
coefficient matmul and the message half as dense block reductions
(ops/dense_expand.py), and builds children with select-matrix products
over a per-slot constant block ``BIG``.  Those formulations are ports
here, line for line, as the **plain twins** (``guards_plain``,
``materialize_plain``): they run on CPU tensors and are what the card's
kernels are held against.

On the card the work is done by hand-written kernels, where a per-lane
switch on the slot's family is the natural form:

* K1 ``guards`` (csrc/guards.cu): one block per parent, one thread per
  slot; the parent's bitmask is staged in shared memory and each thread
  evaluates its family's guard and multiplicity directly;
* K2 ``materialize`` (csrc/materialize.cu): one thread per (parent,
  slot) lane; it writes the child's core fields, the ids the action
  sent, and the child's sorted message-id list with its ``cap_m``
  overflow flag (``_ids_insert`` of engine/bfs.py fused in).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..config import CANDIDATE, FOLLOWER, LEADER, RaftConfig
from ..device import resolve_device
from ..models.raft import Frontier, RaftState
from .dense_expand import DenseExpand
from .msg_universe import get_universe
from .successor import SlotLayout, get_layout

I64 = torch.int64


def mxu_enabled_by_env() -> bool:
    """The matrix forms' default (mxu_expand.py:72): on; ``TLA_RAFT_MXU=0``
    selects the legacy per-lane kernels."""
    return os.environ.get("TLA_RAFT_MXU", "1") != "0"


def _pair(a0, b0, S: int) -> int:
    """(src-1, dst-1) -> the src-major pair digit (msg_universe layout)."""
    return a0 * (S - 1) + (b0 - (1 if b0 > a0 else 0))


def _rank_select_median(x: torch.Tensor, median_index: int) -> torch.Tensor:
    """Median(F) (Raft.tla:70-75) over the trailing axis without a sort:
    element u's stable ascending position is #(x_w < x_u) + #(w < u with
    x_w == x_u); pick the element at ``median_index``."""
    S = x.shape[-1]
    xu = x[..., :, None]
    xw = x[..., None, :]
    ar = torch.arange(S, device=x.device)
    tri = (ar[:, None] > ar[None, :]).to(I64)
    pos = (xw < xu).to(I64).sum(-1) + ((xw == xu).to(I64) * tri).sum(-1)
    return (x * (pos == median_index).to(I64)).sum(-1)


class MXUTables:
    """Per-slot coefficient tables (numpy, copied from the reference):
    the guard matrix ``W [feat, K]``, ``theta [K]``, ``slot_ok [K]``, and
    the update-constant block ``BIG [K, X]`` with its ``col_off``."""

    _BLOCKS = (
        "roleF", "roleC", "roleL", "roleFC", "has_term", "ec", "rc",
        "tgt", "vs0", "llL", "pend0", "pend1", "nille", "vfok",
        "plill", "oksucc", "okfail", "medgt",
    )

    def __init__(self, cfg, uni, families, slot_family, slot_coords):
        S, T, L, V = cfg.S, cfg.T, cfg.L, cfg.V
        E = uni.n_entry
        NPLI = uni.ap_npli
        A = max(S - 1, 1)
        K = int(slot_family.shape[0])
        self.K, self.A = K, A
        fam = slot_family
        c = slot_coords
        legacy_ae = "legacy-append" in cfg.mutations
        double_vote = "double-vote" in cfg.mutations

        widths = dict(
            roleF=S, roleC=S, roleL=S, roleFC=S, has_term=S, ec=1, rc=1,
            tgt=S * T, vs0=V, llL=S, pend0=S * S, pend1=S * S,
            nille=S * S, vfok=S * S, plill=S * L,
            oksucc=S * S * L, okfail=S * S * L, medgt=S,
        )
        off, acc = {}, 0
        for name in self._BLOCKS:
            off[name] = acc
            acc += widths[name]
        self.n_feat = acc
        W = np.zeros((acc, K), np.float32)
        theta = np.zeros((K,), np.float32)
        ok = np.ones((K,), bool)

        def req(k, name, idx=0):
            W[off[name] + idx, k] += 1.0
            theta[k] += 1.0

        for k in range(K):
            f = int(fam[k])
            s = int(c[k, 0])
            if f == 0:
                req(k, "roleFC", s)
                req(k, "ec")
            elif f == 1:
                req(k, "tgt", s * T + int(c[k, 1]))
            elif f == 2:
                req(k, "roleC", s)
                req(k, "has_term", s)
            elif f == 3:
                cand = int(c[k, 1])
                req(k, "roleF", s)
                req(k, "has_term", s)
                if not double_vote:
                    req(k, "vfok", s * S + cand)
                ok[k] = cand != s
            elif f == 4:
                req(k, "roleC", s)
            elif f == 5:
                req(k, "roleL", s)
                req(k, "vs0", int(c[k, 1]))
                req(k, "llL", s)
            elif f == 6:
                d = int(c[k, 1])
                req(k, "roleL", s)
                req(k, "pend0", s * S + d)
                req(k, "nille", s * S + d)
                ok[k] = d != s
            elif f == 7:
                src = int(c[k, 1])
                req(k, "roleF", s)
                req(k, "has_term", s)
                req(k, "plill", s * L + int(c[k, 2]))
                ok[k] = src != s
            elif f == 8:
                src = int(c[k, 1])
                req(k, "roleF", s)
                req(k, "has_term", s)
                ok[k] = src != s
            elif f == 9:
                src, l0, x = int(c[k, 1]), int(c[k, 2]), int(c[k, 3])
                req(k, "roleL", s)
                req(k, "has_term", s)
                req(k, "pend1", s * S + src)
                req(k, "oksucc" if x == 1 else "okfail", (s * S + src) * L + l0)
                ok[k] = src != s
            elif f == 10:
                req(k, "roleL", s)
                req(k, "medgt", s)
            else:
                req(k, "roleL", s)
                req(k, "rc")
        self.feat_off = off
        self.W = W
        self.theta = theta
        self.slot_ok = ok

        cols: list[tuple[str, np.ndarray]] = []

        def col(name, arr):
            arr = np.asarray(arr, np.int32)
            if arr.ndim == 1:
                arr = arr[:, None]
            cols.append((name, arr))

        NF = len(families)
        col("fam", (fam[:, None] == np.arange(NF)).astype(np.int32))
        col("oh_s", (c[:, 0:1] == np.arange(S)).astype(np.int32))
        is_pairfam = np.isin(fam, (3, 6, 7, 8, 9))
        oh_d = (c[:, 1:2] == np.arange(S)) & is_pairfam[:, None]
        col("oh_d", oh_d.astype(np.int32))
        col("oh_v", ((c[:, 1:2] == np.arange(V)) & (fam[:, None] == 5)).astype(np.int32))
        col("s_idx", c[:, 0])
        col("t1", np.where(fam == 1, c[:, 1] + 1, 0))
        col("cand1", np.where(fam == 3, c[:, 1] + 1, 0))
        col("v5p1", np.where(fam == 5, c[:, 1] + 1, 0))
        col("pli9", np.where(fam == 9, c[:, 2] + 1, 0))
        col("sc9", np.where(fam == 9, c[:, 3], 0))
        grant = np.zeros(K, np.int64)
        aq6 = np.zeros(K, np.int64)
        apc7 = np.zeros(K, np.int64)
        apc8 = np.zeros(K, np.int64)
        peer = np.zeros((K, A), np.int64)
        pli7 = np.where(fam == 7, c[:, 2] + 1, 0)
        e7 = np.where(fam == 7, c[:, 3], 0)
        lc7 = np.where(fam == 7, c[:, 4] + 1, 0)
        el7 = (e7 > 0).astype(np.int64)
        eterm7 = np.where(e7 > 0, (e7 - 1) // V + 1, 0)
        eval7 = np.where(e7 > 0, (e7 - 1) % V + 1, 0)
        nl7 = pli7 + el7
        minlc7 = np.minimum(lc7, nl7)
        vq_stride = T * L * T
        aq_stride = T * L * (T + 1) * E * L
        ap_pair_stride = T * NPLI * 2
        for k in range(K):
            f = int(fam[k])
            s = int(c[k, 0])
            if f == 0:
                for r in range(A):
                    p0 = (s + 1 + r) % S if S > 1 else 0
                    pr = _pair(s, p0, S) if S > 1 else 0
                    peer[k, r] = uni.vq_off + pr * vq_stride
            elif f == 3:
                grant[k] = uni.vp_off + _pair(s, int(c[k, 1]), S) * T
            elif f == 6:
                aq6[k] = uni.aq_off + _pair(s, int(c[k, 1]), S) * aq_stride
            elif f == 7:
                rpli = int(np.clip(pli7[k] + el7[k], 1, L))
                apc7[k] = (uni.ap_off + _pair(s, int(c[k, 1]), S) * ap_pair_stride
                           + (rpli - uni.ap_pli_min) * 2 + 1)
            elif f == 8:
                rej_pli = int(c[k, 2]) + (0 if legacy_ae else 1)
                apc8[k] = (uni.ap_off + _pair(s, int(c[k, 1]), S) * ap_pair_stride
                           + (rej_pli - uni.ap_pli_min) * 2)
        col("grant_base", grant)
        col("aq_base6", aq6)
        col("apc7", apc7)
        col("apc8", apc8)
        col("peer_base", peer)
        col("pli7", pli7)
        col("el7", el7)
        col("eterm7", eterm7)
        col("eval7", eval7)
        col("nl7", nl7)
        col("minlc7", minlc7)
        ar = np.arange(L)
        keep7 = (ar[None, :] < pli7[:, None]).astype(np.int32)
        pos7 = np.minimum(pli7, L - 1)
        posoh7 = (ar[None, :] == pos7[:, None]).astype(np.int32)
        ate7 = posoh7 * (el7[:, None] == 1) * (fam[:, None] == 7)
        col("keep7", keep7 * (fam[:, None] == 7))
        col("posoh7", posoh7 * (fam[:, None] == 7))
        col("ate7", ate7.astype(np.int32))

        offc, acc = {}, 0
        parts = []
        for name, arr in cols:
            offc[name] = slice(acc, acc + arr.shape[1])
            acc += arr.shape[1]
            parts.append(arr)
        self.col_off = offc
        self.BIG = np.concatenate(parts, axis=1)  # [K, X] int32


class MXUExpand:
    """Guards and materialize for one config on one device: the kernels'
    wrappers (``guards``, ``materialize``) and their plain twins."""

    def __init__(self, cfg: RaftConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.uni = get_universe(cfg)
        self.layout: SlotLayout = get_layout(cfg)
        self.K = self.layout.K
        self.A = self.layout.A
        self.dense = DenseExpand(cfg, self.uni, self.device)
        self.tables = MXUTables(
            cfg, self.uni, self.layout.families, self.layout.slot_family,
            self.layout.slot_coords,
        )
        t = self.tables
        self.W = torch.from_numpy(t.W).to(self.device)
        self.theta = torch.from_numpy(t.theta).to(self.device)
        self.slot_ok = torch.from_numpy(t.slot_ok).to(self.device)
        self.BIG = torch.from_numpy(t.BIG).to(I64).to(self.device)
        self.slot_table = torch.from_numpy(self.layout.slot_table_np).to(self.device)

    # ---- K1: guards -----------------------------------------------------

    def _guard_features(self, st: RaftState) -> torch.Tensor:
        """The packed static predicate block phi f32[B, feat]."""
        cfg = self.cfg
        S, T, L = cfg.S, cfg.T, cfg.L
        role = st.role.to(I64)
        ct = st.current_term.to(I64)
        vf = st.voted_for.to(I64)
        ll = st.log_len.to(I64)
        mi = st.match_index.to(I64)
        ni = st.next_index.to(I64)
        ci = st.commit_index.to(I64)
        pend = st.pending.to(I64)
        vs = st.val_sent.to(I64)
        B = role.shape[0]
        dvc = role.device
        t_ax = torch.arange(1, T + 1, dtype=I64, device=dvc)
        pli_ax = torch.arange(1, L + 1, dtype=I64, device=dvc)
        s_ax = torch.arange(1, S + 1, dtype=I64, device=dvc)
        med = _rank_select_median(mi, cfg.median_index)
        blocks = [
            role == FOLLOWER,
            role == CANDIDATE,
            role == LEADER,
            (role == FOLLOWER) | (role == CANDIDATE),
            ct >= 1,
            (st.election_count.to(I64) < cfg.max_election)[:, None],
            (st.restart_count.to(I64) < cfg.max_restart)[:, None],
            (t_ax[None, None, :] > ct[:, :, None]).reshape(B, S * T),
            vs == 0,
            ll < L,
            (pend == 0).reshape(B, S * S),
            (pend == 1).reshape(B, S * S),
            (ni <= ll[:, :, None] + 1).reshape(B, S * S),
            ((vf[:, :, None] == 0) | (vf[:, :, None] == s_ax)).reshape(B, S * S),
            (pli_ax[None, None, :] <= ll[:, :, None]).reshape(B, S * L),
            (mi[:, :, :, None] < pli_ax).reshape(B, S * S * L),
            ((pli_ax + 1 == ni[:, :, :, None]) & (pli_ax > mi[:, :, :, None])).reshape(B, S * S * L),
            med > ci,
        ]
        return torch.cat([b.to(torch.float32) for b in blocks], 1)

    def guards_plain(self, st: RaftState):
        """Plain twin of K1: (valid bool[B,K], mult i32[B,K], abort bool[B]),
        ``mult`` zeroed where the slot is invalid (successor.py:348-354)."""
        if st.role.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 counts
        msg_ok, mult, abort = self.dense.msg_guard_parts(st)
        cnt = self._guard_features(st) @ self.W
        static_ok = (cnt == self.theta[None, :]) & self.slot_ok[None, :]
        valid = static_ok & msg_ok
        mult = torch.where(valid, mult, torch.zeros_like(mult)).to(torch.int32)
        return valid, mult, abort

    def guards(self, st: RaftState):
        """(valid, mult, abort) of a parent batch: kernel K1 on the card,
        the plain twin on the CPU."""
        if st.msgs.device.type == "cpu":
            return self.guards_plain(st)
        return kernels.guards(self, st)

    # ---- K2: materialize ------------------------------------------------

    def materialize_plain(self, fr: Frontier, pidx: torch.Tensor, slots: torch.Tensor):
        """Plain twin of K2: children of the (parent row, slot) lanes.

        Returns (child Frontier [G], added i32[G, A], overflow bool[G]):
        the port of ``MXUExpand.materialize_added`` (core fields; the
        message set is carried as ids) followed by ``_ids_insert``."""
        cfg, uni = self.cfg, self.uni
        S, T, L, V = cfg.S, cfg.T, cfg.L, cfg.V
        E = uni.n_entry
        NPLI = uni.ap_npli
        A = self.A
        co = self.tables.col_off
        n = fr.voted_for.shape[0]
        p = pidx.clamp(0, n - 1)
        par = Frontier(*(x[p] for x in fr))
        lane = self.BIG[slots]  # the per-slot constants of each lane

        def colv(name):
            v = lane[:, co[name]]
            return v[:, 0] if v.shape[1] == 1 else v

        famm = colv("fam")
        f = [famm[:, i] > 0 for i in range(famm.shape[1])]
        os_ = colv("oh_s")
        osb = os_ > 0
        od = colv("oh_d")
        odb = od > 0
        dvc = lane.device
        ar_L = torch.arange(L, dtype=I64, device=dvc)[None, :]

        ct = par.current_term.to(I64)
        vf = par.voted_for.to(I64)
        ll = par.log_len.to(I64)
        ci = par.commit_index.to(I64)
        lt = par.log_term.to(I64)
        lv = par.log_val.to(I64)
        mi = par.match_index.to(I64)
        ni = par.next_index.to(I64)
        pend = par.pending.to(I64)
        role = par.role.to(I64)

        def pick(oh, x):  # one-hot row select over the server axis
            return (oh[:, :, None] * x).sum(1) if x.dim() == 3 else (oh * x).sum(1)

        ct_s, vf_s, role_s = pick(os_, ct), pick(os_, vf), pick(os_, role)
        ll_s, ci_s = pick(os_, ll), pick(os_, ci)
        lt_row, lv_row = pick(os_, lt), pick(os_, lv)
        mi_row, ni_row, pend_row = pick(os_, mi), pick(os_, ni), pick(os_, pend)
        mi_sd = (od * mi_row).sum(1)
        ni_sd = (od * ni_row).sum(1)

        def where(c, a, b):
            return torch.where(c, torch.as_tensor(a, device=dvc), torch.as_tensor(b, device=dvc))

        # F0 BecomeCandidate
        new_term0 = (ct_s + 1).clamp(1, T)
        llt0 = ((ar_L == (ll_s - 1).clamp(min=0)[:, None]) * lt_row).sum(-1).clamp(0, T - 1)
        rest0 = ((new_term0 - 1) * L + (ll_s - 1)) * T + llt0
        peer_ids = colv("peer_base").reshape(-1, A) + rest0[:, None]
        # F1 / F3
        t1 = colv("t1")
        if "become-follower" in cfg.mutations:
            nvf1 = where(role_s == FOLLOWER, vf_s, 0)
        else:
            nvf1 = torch.zeros_like(vf_s)
        cand1 = colv("cand1")
        grant3 = colv("grant_base") + ct_s.clamp(min=1) - 1
        # F4 BecomeLeader
        row4_mi = where(osb, ll_s[:, None], 1)
        row4_ni = (ll_s + 1)[:, None].expand_as(row4_mi)
        # F5 ClientReq
        at_w = ar_L == ll_s.clamp(0, L - 1)[:, None]
        row5_lt = where(at_w, ct_s[:, None], lt_row)
        row5_lv = where(at_w, colv("v5p1")[:, None], lv_row)
        row5_mi = where(osb, (ll_s + 1)[:, None], mi_row)
        # F6 LeaderAppendEntry
        pli6 = (ni_sd - 1).clamp(1, L)
        prev_oh = ar_L == (ni_sd - 2).clamp(0, L - 1)[:, None]
        plt6 = (prev_oh * lt_row).sum(-1).clamp(0, T)
        has_e = ni_sd <= ll_s
        epos_oh = ar_L == (ni_sd - 1).clamp(0, L - 1)[:, None]
        et6 = (epos_oh * lt_row).sum(-1).clamp(1, T)
        ev6 = (epos_oh * lv_row).sum(-1).clamp(1, V)
        ecode6 = where(has_e, 1 + (et6 - 1) * V + (ev6 - 1), 0)
        mid6 = colv("aq_base6") + (
            ((((ct_s.clamp(1, T) - 1) * L + (pli6 - 1)) * (T + 1) + plt6) * E + ecode6) * L
            + (ci_s - 1)
        )
        row6_pend = where(odb, 1, pend_row)
        # F7 FollowerAcceptEntry
        pli7, el7 = colv("pli7"), colv("el7")
        eterm7, eval7, nl7 = colv("eterm7"), colv("eval7"), colv("nl7")
        keep7, posoh7, ate7 = colv("keep7"), colv("posoh7"), colv("ate7")
        append_new = nl7 > ll_s
        conflict = (
            (el7 == 1)
            & (pli7 < ll_s)
            & (((posoh7 * lt_row).sum(-1) != eterm7) | ((posoh7 * lv_row).sum(-1) != eval7))
        )
        updated7 = append_new | conflict
        new_lt7 = where(ate7 > 0, eterm7[:, None], where(keep7 > 0, lt_row, 0))
        new_lv7 = where(ate7 > 0, eval7[:, None], where(keep7 > 0, lv_row, 0))
        row7_lt = where(updated7[:, None], new_lt7, lt_row)
        row7_lv = where(updated7[:, None], new_lv7, lv_row)
        ll7 = where(updated7, nl7, ll_s)
        ci7 = torch.maximum(ci_s, colv("minlc7"))
        resp7 = colv("apc7") + (ct_s.clamp(1, T) - 1) * (NPLI * 2)
        # F8 FollowerRejectEntry (no state change)
        rej8 = colv("apc8") + (ct_s.clamp(1, T) - 1) * (NPLI * 2)
        # F9 HandleAppendResp
        pli9, sc9 = colv("pli9"), colv("sc9")
        row9_mi = where(odb, where(sc9 == 1, pli9, mi_sd)[:, None], mi_row)
        row9_ni = where(odb, (pli9 + sc9)[:, None], ni_row)
        row9_pend = where(odb, 0, pend_row)
        # F10 LeaderCanCommit
        med10 = _rank_select_median(mi_row, cfg.median_index)

        def set1(field, mask, val):
            return torch.where(mask[:, None] & osb, val[:, None].to(field.dtype), field)

        def set_row(field, mask, row):
            return torch.where((mask[:, None] & osb)[:, :, None], row[:, None, :].to(field.dtype), field)

        vf_val = where(f[0], colv("s_idx") + 1, where(f[1], nvf1, cand1))
        ct_val = where(f[0], new_term0, t1)
        role_val = where(f[0], CANDIDATE, where(f[4], LEADER, FOLLOWER)) * torch.ones_like(ct_s)
        one8 = torch.ones((), dtype=torch.uint8, device=dvc)
        child = Frontier(
            voted_for=set1(par.voted_for, f[0] | f[1] | f[3], vf_val),
            current_term=set1(par.current_term, f[0] | f[1], ct_val),
            role=set1(par.role, f[0] | f[1] | f[2] | f[4] | f[11], role_val),
            log_term=set_row(par.log_term, f[5] | f[7], where(f[5][:, None], row5_lt, row7_lt)),
            log_val=set_row(par.log_val, f[5] | f[7], where(f[5][:, None], row5_lv, row7_lv)),
            log_len=set1(par.log_len, f[5] | f[7], where(f[5], ll_s + 1, ll7)),
            match_index=set_row(
                par.match_index, f[4] | f[5] | f[9],
                where(f[4][:, None], row4_mi, where(f[5][:, None], row5_mi, row9_mi)),
            ),
            next_index=set_row(par.next_index, f[4] | f[9], where(f[4][:, None], row4_ni, row9_ni)),
            pending=set_row(
                par.pending, f[4] | f[6] | f[9],
                where(f[4][:, None], torch.zeros_like(pend_row), where(f[6][:, None], row6_pend, row9_pend)),
            ),
            commit_index=set1(par.commit_index, f[7] | f[10], where(f[7], ci7, med10)),
            election_count=torch.where(f[0], par.election_count + one8, par.election_count),
            restart_count=torch.where(f[11], par.restart_count + one8, par.restart_count),
            val_sent=torch.where(colv("oh_v").reshape(-1, V) > 0, one8, par.val_sent),
            msg_ids=par.msg_ids,
        )
        a0 = where(f[0], peer_ids[:, 0], where(f[3], grant3, where(f[6], mid6, where(
            f[7], resp7, where(f[8], rej8, -1)))))
        addcols = [a0] + [where(f[0], peer_ids[:, r], -1) for r in range(1, A)]
        added = torch.stack(addcols, 1).to(torch.int32)
        child_ids, ovf = ids_insert(par.msg_ids, added, uni.M)
        return child._replace(msg_ids=child_ids), added, ovf

    def materialize(self, fr: Frontier, pidx: torch.Tensor, slots: torch.Tensor):
        """(child Frontier, added, overflow) of the (parent row, slot)
        lanes: kernel K2 on the card, the plain twin on the CPU."""
        if fr.msg_ids.device.type == "cpu":
            return self.materialize_plain(fr, pidx, slots)
        return kernels.materialize(self, fr, pidx, slots)


def ids_insert(ids: torch.Tensor, added: torch.Tensor, M: int):
    """Child message-id lists by sorted insertion of the sent ids (the
    port of ``JaxChecker._ids_insert``): ids [n, cap_m] ascending, -1
    padded; added i32[n, A] (-1 pads).  Ids already present are skipped
    (the message set is a set, Raft.tla:43-45).  Returns (child ids,
    overflow bool[n]) — overflow when a live id finds the list full."""
    cap_m = ids.shape[1]
    dvc = ids.device
    pos_iota = torch.arange(cap_m, dtype=I64, device=dvc)[None, :]
    idl = ids.to(I64)
    cur = torch.where(idl < 0, torch.full_like(idl, M), idl)  # pads sort last
    ovf = torch.zeros(ids.shape[0], dtype=torch.bool, device=dvc)
    for a in range(added.shape[1]):
        aid = added[:, a].to(I64)[:, None]
        live = (aid >= 0) & ~(cur == aid).any(1, keepdim=True)
        pos = (cur < aid).sum(1, keepdim=True)
        shifted = torch.cat([cur[:, :1], cur[:, :-1]], 1)
        ins = torch.where(pos_iota < pos, cur, torch.where(pos_iota == pos, aid, shifted))
        ovf = ovf | (live[:, 0] & (cur[:, -1] < M))
        cur = torch.where(live, ins, cur)
    child = torch.where(cur >= M, torch.full_like(cur, -1), cur).to(ids.dtype)
    return child, ovf

