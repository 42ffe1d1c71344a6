"""The dense expand (B18): ``Next`` as block algebra over the message set.

The port of ``tla_raft_tpu/ops/dense_expand.py``.  The message set is
viewed as mixed-radix blocks (static reshapes of the unpacked bit vector,
``[B, pair, term, ...]`` per message type); every guard's message
conjunct is an existence or count reduction over those blocks, with the
data-dependent digits (term, prevLogTerm, ...) selected by tiny one-hot
contractions, and every fan-out lane's fingerprint is incremental: the
parent's feature hash plus its message hash ``msum``, plus the lane
family's feature delta (the ``C_*`` coefficient blocks), plus the
``delta_hash`` of the messages the action adds, then the minimum over the
symmetry group (``Fingerprinter.finalize``).

Two users:

* ``msg_guard_parts``: the message half of the plain twin of kernel K1
  (ops/mxu_expand.py ``guards_plain``);
* ``__call__`` (the reference's ``DenseExpand.__call__``, dense_expand.py:330),
  the plain twin of the ``dense_expand`` kernel (csrc/dense_expand.cu):
  with fingerprints it is ``canon="expand"``'s chunk expand
  (``SuccessorKernel._expand_dense``); guards-only it is the legacy guard
  of ``use_mxu=False`` and of the ``--audit`` re-expansion
  (``SuccessorKernel._expand_guards``, successor.py:339), independent of
  K1's formulation.  ``expand`` and ``guards`` send CPU tensors to the twin
  and CUDA tensors to the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import CANDIDATE, FOLLOWER, LEADER, RaftConfig
from ..device import resolve_device
from ..u64 import MASK32, SENT
from .msg_universe import MsgUniverse, _dst_from_idx

I64 = torch.int64
# rows of the fingerprinting twin per block: bounds its [rows, *W, P, chan]
# temporaries
_FP_ROWS = 256


def _oh(x: torch.Tensor, n: int) -> torch.Tensor:
    """One-hot over a tiny digit range (all zeros when out of range)."""
    return (x[..., None] == torch.arange(n, dtype=x.dtype, device=x.device)).to(I64)


def ieinsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """Exact integer einsum: int64 on the CPU; float64 on the card, where
    torch has no integer matmul (exact: every count, and every coefficient
    (< 2^32) times a field delta (< 2^8) summed over a few terms, is
    < 2^53)."""
    if ops[0].device.type == "cpu":
        return torch.einsum(eq, *(o.to(I64) for o in ops))
    out = torch.einsum(eq, *(o.to(torch.float64) for o in ops))
    return torch.round(out).to(I64)


def unpack_bits(packed: torch.Tensor, M: int) -> torch.Tensor:
    """int32 words [N, n_words] -> 0/1 int64 [N, M]."""
    sh = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> sh) & 1
    return bits.reshape(packed.shape[0], -1)[:, :M].to(I64)


class DenseExpand:
    """Constants of the dense expand for one config; with a Fingerprinter
    also the per-family coefficient blocks of its fingerprint deltas."""

    def __init__(self, cfg: RaftConfig, uni: MsgUniverse, device=None, fpr=None):
        device = resolve_device(device)
        self.device = device
        self.cfg = cfg
        self.uni = uni
        self.fpr = fpr
        S, T, L, V = cfg.S, cfg.T, cfg.L, cfg.V
        E = uni.n_entry
        NP = S * (S - 1)
        self.S, self.T, self.L, self.V, self.E, self.NP = S, T, L, V, E, NP

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=I64, device=device)

        pair_of = np.zeros((S, S), np.int64)  # (a0, b0) -> pair digit a->b
        for src in range(1, S + 1):
            for di in range(S - 1):
                dst = _dst_from_idx(src, di)
                pair_of[src - 1, dst - 1] = (src - 1) * (S - 1) + di
        selp = np.zeros((S, S, NP), np.int64)  # one-hot of pair(a->b)
        for a in range(S):
            for b in range(S):
                if a != b:
                    selp[a, b, pair_of[a, b]] = 1
        self.SELP = dev(selp)
        self.SELD = dev(selp.sum(0))  # pairs delivering TO b
        # ResponseVote up-to-date qualifier (Raft.tla:145-147)
        q = np.zeros((T, L, T + 1, L), np.int64)
        for k in range(T):
            for l0 in range(L):
                for m in range(T + 1):
                    for j0 in range(L):
                        q[k, l0, m, j0] = int((k > m) or (k == m and l0 >= j0))
        self.QUAL = dev(q)
        EL = np.array([0] + [1] * (E - 1), np.int64)
        NL = (np.arange(L)[:, None] + 1) + EL[None, :]
        self.PI = dev(np.minimum(NL, L))  # resp prevLogIndex [l, e]
        self.MINLC = dev(np.minimum(np.arange(1, L + 1)[None, None, :], NL[:, :, None]))
        # FollowerAcceptEntry witness constants over (pli0 = l, e, lc0 = h)
        self.EL = dev(EL)
        self.ETERM = dev(np.array([0] + [(e - 1) // V + 1 for e in range(1, E)], np.int64))
        self.EVAL = dev(np.array([0] + [(e - 1) % V + 1 for e in range(1, E)], np.int64))
        self.NL = dev(NL)
        jj, ll_ = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
        keep = (jj <= ll_).astype(np.int64)  # j < pli
        pos = np.minimum(np.arange(L) + 1, L - 1)  # the carried entry's slot per l
        at = np.zeros((L, L, E), np.int64)
        for l0 in range(L):
            at[pos[l0], l0, 1:] = 1
        self.KEEPX = dev(keep[:, :, None] * (1 - at))  # [j, l, e]
        self.AT = dev(at)
        self.pair_ab = pair_of  # [a, b] (diagonal unused)
        if S > 1:  # BecomeCandidate's peers (s -> the S-1 others, broadcast order)
            peers = np.stack([[(s + 1 + r) % S for r in range(S - 1)] for s in range(S)])
            self.pair_peers = pair_of[np.arange(S)[:, None], peers]  # [S, S-1]
            selpeer = np.zeros((S, S - 1, NP), np.int64)
            for s in range(S):
                for r in range(S - 1):
                    selpeer[s, r, self.pair_peers[s, r]] = 1
            self.SELPEER = dev(selpeer)
        from .successor import get_layout

        lay = get_layout(cfg)
        self.K = lay.K
        self.slot_table = torch.from_numpy(lay.slot_table_np).to(device)  # the kernel's
        if fpr is not None:
            self._coef_blocks(fpr)

    def _coef_blocks(self, fpr) -> None:
        """The effective feature coefficients by state variable, u32 in
        int64 [*idx, P, chan] (dense_expand.py:99-128), and the pair-digit
        permutation table (int32, the kernel's)."""
        S, L, V = self.S, self.L, self.V
        P, NC = fpr.P, fpr.N_CHAN
        ceff = fpr.ceff.to(I64) & MASK32  # [F, P, chan]
        sp = fpr.spec

        def cf(sl, *shape):
            return ceff[sl].reshape(*shape, P, NC).to(self.device)

        self.C_ct = cf(sp.ct, S)
        self.C_role = cf(sp.role, S)
        self.C_lt = cf(sp.lt, S, L)
        self.C_lv = cf(sp.lv, S, L)
        self.C_ll = cf(sp.ll, S)
        self.C_mi = cf(sp.mi, S, S)
        self.C_ni = cf(sp.ni, S, S)
        self.C_ci = cf(sp.ci, S)
        self.C_vf = cf(sp.vf_oh, S, S + 1)
        self.C_ec = cf(sp.ec, 1)[0]
        self.C_rc = cf(sp.rc, 1)[0]
        self.C_pend = cf(sp.pend, S, S)
        self.C_vs = cf(sp.vs, V)
        ar = torch.arange(S, device=self.device)
        self.C_vf_self = self.C_vf[ar, ar + 1]  # votedFor[s] := s + 1
        self.C_mi_diag = self.C_mi[ar, ar]
        self.pperm32 = torch.from_numpy(  # [P, NP]: the pair digit under each permutation
            np.ascontiguousarray(self.uni.pair_perm_table, dtype=np.int32)).to(self.device)

    def msg_guard_parts(self, st):
        """(msg_ok bool[B,K], mult i64[B,K], abort bool[B]) of a RaftState
        batch: the message-dependent conjunct of every slot's guard."""
        cfg, uni = self.cfg, self.uni
        S, T, L, V, E, NP = self.S, self.T, self.L, self.V, self.E, self.NP
        B = st.voted_for.shape[0]
        dvc = st.voted_for.device
        role = st.role.to(I64)
        ct = st.current_term.to(I64)
        ll = st.log_len.to(I64)
        lt = st.log_term.to(I64)
        ci = st.commit_index.to(I64)

        bits = unpack_bits(st.msgs, uni.M)
        vq = bits[:, : uni.vp_off].reshape(B, NP, T, L, T)
        vp = bits[:, uni.vp_off : uni.aq_off].reshape(B, NP, T)
        aq = bits[:, uni.aq_off : uni.ap_off].reshape(B, NP, T, L, T + 1, E, L)
        NPLI = uni.ap_npli
        legacy_ae = "legacy-append" in cfg.mutations
        ap = bits[:, uni.ap_off :].reshape(B, NP, T, NPLI, 2)

        vq_r = vq.sum((3, 4))
        aq_r = aq.sum((3, 4, 5, 6))
        ap_r = ap.sum((3, 4))
        to_cnt = ieinsum("bpt,dp->bdt", vq_r + vp + aq_r + ap_r, self.SELD)
        aq_to_cnt = ieinsum("bpt,dp->bdt", aq_r, self.SELD)
        AQR = aq.sum((5, 6))
        ap0, ap1 = ap[..., 0], ap[..., 1]

        oh_ct = _oh((ct - 1).clamp(0, T - 1), T)
        has_term = ct >= 1
        oh_ll_pos = _oh((ll - 1).clamp(0, L - 1), L)
        llt_val = (oh_ll_pos * lt).sum(-1)
        tcur1 = ct.clamp(1, T)
        pli_ax = torch.arange(1, L + 1, dtype=I64, device=dvc)

        def true_(*sh):
            return torch.ones((B, *sh), dtype=torch.bool, device=dvc)

        def one_(*sh):
            return torch.ones((B, *sh), dtype=I64, device=dvc)

        ok_parts, mult_parts = [], []

        def emit(ok, mult):
            ok_parts.append(ok.reshape(B, -1))
            mult_parts.append(mult.reshape(B, -1))

        # F0 BecomeCandidate: no message guard
        emit(true_(S), one_(S))
        # F1 UpdateTerm (a): any message to s at term t
        emit(to_cnt > 0, to_cnt)
        # F2 UpdateTerm (b) + the split-brain Assert (Raft.tla:185)
        cnt2 = ieinsum("bdt,bdt->bd", aq_to_cnt, oh_ct)
        has2 = has_term & (cnt2 > 0)
        if "become-follower" in cfg.mutations:
            abort = torch.zeros((B,), dtype=torch.bool, device=dvc)
        else:
            abort = (has2 & (role == LEADER)).any(1)
        emit(cnt2 > 0, cnt2)
        # F3 ResponseVote: up-to-date VoteReq present, grant not re-sent
        UP = ieinsum("bptlk,klmj->bptmj", vq, self.QUAL)
        oh_myllt = _oh(llt_val.clamp(0, T), T + 1)
        qual_cnt = ieinsum(
            "bptmj,csp,bst,bsm,bsj->bsc", UP, self.SELP, oh_ct, oh_myllt, oh_ll_pos
        )
        grant_bit = ieinsum("bpt,scp,bst->bsc", vp, self.SELP, oh_ct)
        emit((qual_cnt > 0) & (grant_bit == 0), qual_cnt)
        # F4 BecomeLeader: the vote-count threshold (Raft.tla:160-164)
        votes = ieinsum("bpt,sp,bst->bs", vp, self.SELD, oh_ct)
        emit(votes + 1 >= cfg.majority, one_(S))
        # F5 ClientReq: no message guard
        emit(true_(S, V), one_(S, V))
        # F6 LeaderAppendEntry: the exact request not already in flight
        ni = st.next_index.to(I64)
        lv = st.log_val.to(I64)
        pli6 = (ni - 1).clamp(1, L)
        prev_oh = _oh((ni - 2).clamp(0, L - 1), L)
        plt6 = ieinsum("bsdl,bsl->bsd", prev_oh, lt).clamp(0, T)
        has_e = ni <= ll[:, :, None]
        epos_oh = _oh((ni - 1).clamp(0, L - 1), L)
        et6 = ieinsum("bsdl,bsl->bsd", epos_oh, lt).clamp(1, T)
        ev6 = ieinsum("bsdl,bsl->bsd", epos_oh, lv).clamp(1, V)
        ecode6 = torch.where(has_e, 1 + (et6 - 1) * V + (ev6 - 1), torch.zeros_like(et6))
        lc6 = ci.clamp(1, L)[:, :, None]
        present6 = ieinsum(
            "bqtlmeh,sdq,bsdt,bsdl,bsdm,bsde,bsdh->bsd",
            aq, self.SELP,
            _oh(tcur1[:, :, None].expand(B, S, S) - 1, T),
            _oh(pli6 - 1, L), _oh(plt6, T + 1), _oh(ecode6, E),
            _oh(lc6.expand(B, S, S) - 1, L),
        )
        emit(present6 == 0, one_(S, S))
        # F7 FollowerAcceptEntry: the exact request present (+ the dead
        # FollowerAppendEntry's resp/commit-advance gate under mutation)
        oh_plt7 = _oh(lt.clamp(0, T), T + 1)
        present7 = ieinsum("bqtlmeh,csq,bst,bslm->bscleh", aq, self.SELP, oh_ct, oh_plt7)
        ok7 = present7 > 0
        if legacy_ae:
            oh_pi = _oh(self.PI - uni.ap_pli_min, NPLI)
            resp_present7 = ieinsum("bqtj,scq,bst,lej->bscle", ap1, self.SELP, oh_ct, oh_pi)
            ci_adv = self.MINLC[None, None] > ci[:, :, None, None, None]
            ok7 = ok7 & ((resp_present7[:, :, :, :, :, None] == 0) | ci_adv[:, :, None])
        emit(ok7, one_(S, S, L, E, L))
        # F8 FollowerRejectEntry: mismatching blocks present, reject unsent
        log_match = pli_ax[None, None, :] <= ll[:, :, None]
        tot8 = ieinsum("bqtlm,csq,bst->bscl", AQR, self.SELP, oh_ct)
        match8 = ieinsum("bqtlm,csq,bst,bslm->bscl", AQR, self.SELP, oh_ct, oh_plt7)
        cnt8 = tot8 - torch.where(log_match[:, :, None, :], match8, torch.zeros_like(match8))
        ap0_rej = ap0 if uni.ap_pli_min == 1 else ap0[:, :, :, :L]
        rej_bit = ieinsum("bqtl,scq,bst->bscl", ap0_rej, self.SELP, oh_ct)
        emit((cnt8 > 0) & (rej_bit == 0), cnt8)
        # F9 HandleAppendResp: the response bit present
        ap9 = ap if uni.ap_pli_min == 1 else ap[:, :, :, 1:]
        bit9 = ieinsum("bqtlx,csq,bst->bsclx", ap9, self.SELP, oh_ct)
        emit(bit9 > 0, one_(S, S, L, 2))
        # F10 LeaderCanCommit / F11 Restart: no message guard
        emit(true_(S), one_(S))
        emit(true_(S), one_(S))
        return torch.cat(ok_parts, 1), torch.cat(mult_parts, 1), abort

    # ---- added-message hash contribution ------------------------------------

    def _add_msg(self, pair_const: np.ndarray, type_idx: int, rest, live):
        """One added message per lane (dense_expand.py:172): ``pair_const``
        np[*axes] (the pair digit), ``rest`` i64[B, *axes], ``live``
        i64[B, *axes] (1 = actually added) -> u32 [B, *axes, P, chan]."""
        off = self.uni.type_offsets[type_idx]
        stride = self.uni.type_strides[type_idx]
        pc = torch.as_tensor(np.asarray(pair_const), dtype=I64, device=rest.device)
        pp = self.pperm32.to(device=rest.device, dtype=I64)[:, pc]  # [P, *axes]
        pp = pp.permute(*range(1, pp.dim()), 0)  # [*axes, P]
        id_p = off + pp * stride + rest[..., None]
        g = self.fpr.msg_coef_eff(id_p)
        return torch.where(live[..., None, None] != 0, g, torch.zeros_like(g))

    # ---- the expand (plain twin of the dense_expand kernel) ------------------

    def __call__(self, st, msum, want_fp: bool = True):
        """Dense pass 1 (dense_expand.py:330): (valid bool[B, K], mult
        i64[B, K] (not masked), fp_view, fp_full (i64 u64 bits [B, K]; None
        guards-only), abort bool[B]).  ``msum`` u32 [B, P, chan] in int64 is
        the parents' message hash (unused guards-only).  Fingerprints are
        computed for every lane, as in the reference; the engine keeps only
        the valid lanes'.  Rows are taken in blocks of ``_FP_ROWS`` with
        fingerprints on."""
        B = st.voted_for.shape[0]
        if not want_fp or B <= _FP_ROWS:
            return self._call(st, msum, want_fp)
        outs = [self._call(type(st)(*(x[a:a + _FP_ROWS] for x in st)), msum[a:a + _FP_ROWS],
                           True) for a in range(0, B, _FP_ROWS)]
        return tuple(torch.cat(z) for z in zip(*outs))

    def _call(self, st, msum, want_fp: bool):
        cfg, uni = self.cfg, self.uni
        S, T, L, V, E, NP = self.S, self.T, self.L, self.V, self.E, self.NP
        B = st.voted_for.shape[0]
        dvc = st.voted_for.device
        fpr = self.fpr
        if want_fp:
            P, NC = fpr.P, fpr.N_CHAN

        def u(x):
            return x.to(I64)

        ct, vf, role, ll = u(st.current_term), u(st.voted_for), u(st.role), u(st.log_len)
        lt, lv, mi, ni = u(st.log_term), u(st.log_val), u(st.match_index), u(st.next_index)
        ci, pend, ec, rc, vs = (u(st.commit_index), u(st.pending), u(st.election_count),
                                u(st.restart_count), u(st.val_sent))

        bits = unpack_bits(st.msgs, uni.M)
        vq = bits[:, : uni.vp_off].reshape(B, NP, T, L, T)
        vp = bits[:, uni.vp_off : uni.aq_off].reshape(B, NP, T)
        aq = bits[:, uni.aq_off : uni.ap_off].reshape(B, NP, T, L, T + 1, E, L)
        NPLI = uni.ap_npli
        legacy_ae = "legacy-append" in cfg.mutations
        ap = bits[:, uni.ap_off :].reshape(B, NP, T, NPLI, 2)

        # per-chunk aggregates
        vq_r = vq.sum((3, 4))
        aq_r = aq.sum((3, 4, 5, 6))
        ap_r = ap.sum((3, 4))
        to_cnt = ieinsum("bpt,dp->bdt", vq_r + vp + aq_r + ap_r, self.SELD)
        aq_to_cnt = ieinsum("bpt,dp->bdt", aq_r, self.SELD)
        AQR = aq.sum((5, 6))
        ap0, ap1 = ap[..., 0], ap[..., 1]

        oh_ct = _oh((ct - 1).clamp(0, T - 1), T)
        has_term = ct >= 1
        oh_ll_pos = _oh((ll - 1).clamp(0, L - 1), L)
        llt_val = (oh_ll_pos * lt).sum(-1)
        not_self = ~torch.eye(S, dtype=torch.bool, device=dvc)[None]
        tcur1 = ct.clamp(1, T)
        zero = torch.zeros((), dtype=I64, device=dvc)

        if want_fp:
            oh_vfw = _oh(vf, S + 1)
            old_vf_c = ieinsum("bsw,swpc->bspc", oh_vfw, self.C_vf)
            base = (fpr.feat_hash(fpr.spec.features(st)) + msum) & MASK32  # [B, P, C]

        fpv_parts, fpf_parts, valid_parts, mult_parts = [], [], [], []

        def emit(valid, mult, dh=None):
            valid_parts.append(valid.reshape(B, -1))
            mult_parts.append(mult.reshape(B, -1))
            if dh is None:
                return
            h = base.reshape(B, *([1] * (dh.dim() - 3)), P, NC) + dh
            v, f = fpr.finalize(h & MASK32)
            fpv_parts.append(v.reshape(B, -1))
            fpf_parts.append(f.reshape(B, -1))

        def dmul(C, delta):
            """C u32[*idx, P, chan] * delta i64[..., *idx] (mod 2^32 later)."""
            return C * delta[..., None, None]

        def ones(*sh):
            return torch.ones((B, *sh), dtype=I64, device=dvc)

        # F0 BecomeCandidate(s)  [B, s]
        valid0 = (ec[:, None] < cfg.max_election) & ((role == FOLLOWER) | (role == CANDIDATE))
        dh0 = None
        if want_fp:
            new_term = (ct + 1).clamp(1, T)
            llt_cand = llt_val.clamp(0, T - 1)
            dh0 = (dmul(self.C_ct, new_term - ct) + dmul(self.C_role, CANDIDATE - role)
                   + self.C_vf_self - old_vf_c + self.C_ec)
            if S > 1:
                present0 = ieinsum("bptlk,srp,bst,bsl,bsk->bsr", vq, self.SELPEER,
                                   _oh(new_term - 1, T), oh_ll_pos, _oh(llt_cand, T))
                rest0 = ((new_term - 1) * L + (ll - 1)) * T + llt_cand
                dh0 = dh0 + self._add_msg(self.pair_peers, 0,
                                          rest0[:, :, None].expand(B, S, S - 1),
                                          1 - present0).sum(2)
        emit(valid0, ones(S), dh0)

        # F1 UpdateTerm branch (a)  [B, s, t0]
        t_ax = torch.arange(1, T + 1, dtype=I64, device=dvc)
        valid1 = (t_ax[None, None, :] > ct[:, :, None]) & (to_cnt > 0)
        dh1 = None
        if want_fp:
            vf_delta1 = self.C_vf[:, 0] - old_vf_c
            if "become-follower" in cfg.mutations:
                vf_delta1 = torch.where((role == FOLLOWER)[:, :, None, None], zero, vf_delta1)
            dh1 = (dmul(self.C_ct[:, None], t_ax[None, None, :] - ct[:, :, None])
                   + (dmul(self.C_role, FOLLOWER - role) + vf_delta1)[:, :, None])
        emit(valid1, to_cnt, dh1)

        # F2 UpdateTerm branch (b) + the split-brain Assert  [B, s]
        cnt2 = ieinsum("bdt,bdt->bd", aq_to_cnt, oh_ct)
        has2 = has_term & (cnt2 > 0)
        valid2 = has2 & (role == CANDIDATE)
        if "become-follower" in cfg.mutations:
            abort = torch.zeros((B,), dtype=torch.bool, device=dvc)
        else:
            abort = (has2 & (role == LEADER)).any(1)
        emit(valid2, cnt2, dmul(self.C_role, FOLLOWER - role) if want_fp else None)

        # F3 ResponseVote(s, cand)  [B, s, c]
        UP = ieinsum("bptlk,klmj->bptmj", vq, self.QUAL)
        oh_myllt = _oh(llt_val.clamp(0, T), T + 1)
        qual_cnt = ieinsum("bptmj,csp,bst,bsm,bsj->bsc", UP, self.SELP, oh_ct, oh_myllt,
                           oh_ll_pos)
        grant_bit = ieinsum("bpt,scp,bst->bsc", vp, self.SELP, oh_ct)
        if "double-vote" in cfg.mutations:
            vf_ok = torch.ones((B, S, S), dtype=torch.bool, device=dvc)
        else:
            vf_ok = (vf[:, :, None] == 0) | (
                vf[:, :, None] == torch.arange(1, S + 1, dtype=I64, device=dvc)[None, None, :])
        valid3 = ((role == FOLLOWER)[:, :, None] & has_term[:, :, None] & not_self & vf_ok
                  & (qual_cnt > 0) & (grant_bit == 0))
        dh3 = None
        if want_fp:
            dh3 = self.C_vf[None, :, 1:] - old_vf_c[:, :, None]
            rest3 = (tcur1 - 1)[:, :, None].expand(B, S, S)
            dh3 = dh3 + self._add_msg(self.pair_ab, 1, rest3, 1 - grant_bit)
        emit(valid3, qual_cnt, dh3)

        # F4 BecomeLeader(s)  [B, s]
        votes = ieinsum("bpt,sp,bst->bs", vp, self.SELD, oh_ct)
        valid4 = (role == CANDIDATE) & (votes + 1 >= cfg.majority)
        dh4 = None
        if want_fp:
            ar = torch.arange(S, dtype=I64, device=dvc)
            mi_tgt = torch.where(ar[None, None, :] == ar[None, :, None], ll[:, :, None],
                                 torch.ones((), dtype=I64, device=dvc))
            dh4 = (dmul(self.C_role, LEADER - role)
                   + ieinsum("bsu,supc->bspc", mi_tgt - mi, self.C_mi)
                   + ieinsum("bsu,supc->bspc", (ll[:, :, None] + 1) - ni, self.C_ni)
                   + ieinsum("bsu,supc->bspc", -pend, self.C_pend))
        emit(valid4, ones(S), dh4)

        # F5 ClientReq(s, v)  [B, s, v]
        valid5 = (role == LEADER)[:, :, None] & (vs[:, None, :] == 0) & (ll < L)[:, :, None]
        dh5 = None
        if want_fp:
            pos_oh = _oh(ll.clamp(0, L - 1), L)
            d_lt5 = ieinsum("bsl,slpc->bspc", pos_oh * (ct[:, :, None] - lt), self.C_lt)
            C_lv_pos = ieinsum("bsl,slpc->bspc", pos_oh, self.C_lv)
            lv_pos = (pos_oh * lv).sum(-1)
            v_val = torch.arange(1, V + 1, dtype=I64, device=dvc)
            d_lv5 = C_lv_pos[:, :, None] * (v_val[None, None, :] - lv_pos[:, :, None])[..., None, None]
            d_mid5 = dmul(self.C_mi_diag, (ll + 1) - torch.diagonal(mi, 0, 1, 2))
            d_vs5 = dmul(self.C_vs, 1 - vs)
            dh5 = (d_lt5 + self.C_ll + d_mid5)[:, :, None] + d_lv5 + d_vs5[:, None]
        emit(valid5, ones(S, V), dh5)

        # F6 LeaderAppendEntry(s, d)  [B, s, d]
        pli6 = (ni - 1).clamp(1, L)
        prev_oh = _oh((ni - 2).clamp(0, L - 1), L)
        plt6 = ieinsum("bsdl,bsl->bsd", prev_oh, lt).clamp(0, T)
        has_e = ni <= ll[:, :, None]
        epos_oh = _oh((ni - 1).clamp(0, L - 1), L)
        et6 = ieinsum("bsdl,bsl->bsd", epos_oh, lt).clamp(1, T)
        ev6 = ieinsum("bsdl,bsl->bsd", epos_oh, lv).clamp(1, V)
        ecode6 = torch.where(has_e, 1 + (et6 - 1) * V + (ev6 - 1), zero)
        lc6 = ci.clamp(1, L)[:, :, None]
        present6 = ieinsum(
            "bqtlmeh,sdq,bsdt,bsdl,bsdm,bsde,bsdh->bsd", aq, self.SELP,
            _oh(tcur1[:, :, None].expand(B, S, S) - 1, T), _oh(pli6 - 1, L), _oh(plt6, T + 1),
            _oh(ecode6, E), _oh(lc6.expand(B, S, S) - 1, L))
        valid6 = ((role == LEADER)[:, :, None] & not_self & (ni <= ll[:, :, None] + 1)
                  & (pend == 0) & (present6 == 0))
        dh6 = None
        if want_fp:
            dh6 = ieinsum("bsd,sdpc->bsdpc", 1 - pend, self.C_pend)
            rest6 = ((((tcur1[:, :, None] - 1) * L + (pli6 - 1)) * (T + 1) + plt6) * E
                     + ecode6) * L + (lc6 - 1)
            dh6 = dh6 + self._add_msg(self.pair_ab, 2, rest6, 1 - present6)
        emit(valid6, ones(S, S), dh6)

        # F7 FollowerAcceptEntry(s, src, pli, e, lc)  [B, s, c, l, e, h]
        oh_plt7 = _oh(lt.clamp(0, T), T + 1)
        present7 = ieinsum("bqtlmeh,csq,bst,bslm->bscleh", aq, self.SELP, oh_ct, oh_plt7)
        pli_ax = torch.arange(1, L + 1, dtype=I64, device=dvc)
        log_match = pli_ax[None, None, :] <= ll[:, :, None]
        valid7 = ((role == FOLLOWER)[:, :, None, None, None, None]
                  & has_term[:, :, None, None, None, None]
                  & not_self[:, :, :, None, None, None]
                  & log_match[:, :, None, :, None, None] & (present7 > 0))
        resp_present7 = None
        if legacy_ae or want_fp:
            oh_pi = _oh(self.PI - uni.ap_pli_min, NPLI)
            resp_present7 = ieinsum("bqtj,scq,bst,lej->bscle", ap1, self.SELP, oh_ct, oh_pi)
        if legacy_ae:
            ci_adv = self.MINLC[None, None] > ci[:, :, None, None, None]
            valid7 = valid7 & ((resp_present7[:, :, :, :, :, None] == 0) | ci_adv[:, :, None])
        dh7 = None
        if want_fp:
            append_new = self.NL[None, None] > ll[:, :, None, None]
            lt_next = torch.cat([lt[..., 1:], lt[..., -1:]], -1)
            lv_next = torch.cat([lv[..., 1:], lv[..., -1:]], -1)
            conflict = ((self.EL[None, None, None] == 1)
                        & (pli_ax[None, None, :, None] < ll[:, :, None, None])
                        & ((lt_next[:, :, :, None] != self.ETERM[None, None, None])
                           | (lv_next[:, :, :, None] != self.EVAL[None, None, None])))
            updated = (append_new | conflict).to(I64)  # [B, s, l, e]
            d_lt_j = ((self.KEEPX[None, None] - 1) * lt[:, :, :, None, None]
                      + self.AT[None, None] * self.ETERM[None, None, None, None])
            d_lv_j = ((self.KEEPX[None, None] - 1) * lv[:, :, :, None, None]
                      + self.AT[None, None] * self.EVAL[None, None, None, None])
            d_log7 = (ieinsum("bsjle,sjpc->bslepc", d_lt_j, self.C_lt)
                      + ieinsum("bsjle,sjpc->bslepc", d_lv_j, self.C_lv))
            d_ll7 = dmul(self.C_ll[:, None, None], self.NL[None, None] - ll[:, :, None, None])
            d_upd7 = (d_log7 + d_ll7) * updated[..., None, None]
            d_ci7 = dmul(self.C_ci[:, None, None, None],
                         torch.maximum(ci[:, :, None, None, None], self.MINLC[None, None])
                         - ci[:, :, None, None, None])
            rest7 = ((tcur1 - 1)[:, :, None, None] * NPLI
                     + (self.PI[None, None] - uni.ap_pli_min)) * 2 + 1
            dmsg7 = self._add_msg(self.pair_ab[:, :, None, None], 3,
                                  rest7[:, :, None].expand(B, S, S, L, E), 1 - resp_present7)
            dh7 = (d_upd7[:, :, None, :, :, None] + d_ci7[:, :, None]
                   + dmsg7[:, :, :, :, :, None]).expand(B, S, S, L, E, L, P, NC)
        emit(valid7, ones(S, S, L, E, L), dh7)

        # F8 FollowerRejectEntry(s, src, pli)  [B, s, c, l]
        tot8 = ieinsum("bqtlm,csq,bst->bscl", AQR, self.SELP, oh_ct)
        match8 = ieinsum("bqtlm,csq,bst,bslm->bscl", AQR, self.SELP, oh_ct, oh_plt7)
        cnt8 = tot8 - torch.where(log_match[:, :, None, :], match8, zero)
        ap0_rej = ap0 if uni.ap_pli_min == 1 else ap0[:, :, :, :L]
        rej_bit = ieinsum("bqtl,scq,bst->bscl", ap0_rej, self.SELP, oh_ct)
        valid8 = ((role == FOLLOWER)[:, :, None, None] & has_term[:, :, None, None]
                  & not_self[:, :, :, None] & (cnt8 > 0) & (rej_bit == 0))
        dh8 = None
        if want_fp:
            rest8 = (((tcur1 - 1)[:, :, None, None] * NPLI
                      + torch.arange(L, dtype=I64, device=dvc)) * 2).expand(B, S, S, L)
            dh8 = self._add_msg(self.pair_ab[:, :, None], 3, rest8, 1 - rej_bit)
        emit(valid8, cnt8, dh8)

        # F9 HandleAppendResp(s, src, pli, succ)  [B, s, c, l, x]
        ap9 = ap if uni.ap_pli_min == 1 else ap[:, :, :, 1:]
        bit9 = ieinsum("bqtlx,csq,bst->bsclx", ap9, self.SELP, oh_ct)
        pli9 = pli_ax[None, None, None, :]
        mi_sc = mi[:, :, :, None]
        ni_sc = ni[:, :, :, None]
        ok9 = torch.stack([(pli9 + 1 == ni_sc) & (pli9 > mi_sc), mi_sc < pli9], -1)
        valid9 = ((role == LEADER)[:, :, None, None, None] & has_term[:, :, None, None, None]
                  & not_self[:, :, :, None, None] & (pend == 1)[:, :, :, None, None]
                  & (bit9 > 0) & ok9)
        dh9 = None
        if want_fp:
            x_ax = torch.arange(2, dtype=I64, device=dvc)
            dh9 = (dmul(self.C_mi[:, :, None, None], x_ax * (pli9[..., None] - mi_sc[..., None]))
                   + dmul(self.C_ni[:, :, None, None], pli9[..., None] + x_ax - ni_sc[..., None])
                   + dmul(self.C_pend[:, :, None, None], -pend[:, :, :, None, None]))
        emit(valid9, ones(S, S, L, 2), dh9)

        # F10 LeaderCanCommit(s): the median_index-th order statistic  [B, s]
        xu, xw = mi[:, :, :, None], mi[:, :, None, :]
        arS = torch.arange(S, device=dvc)
        tri = (arS[:, None] > arS[None, :]).to(I64)
        pos = (xw < xu).to(I64).sum(-1) + ((xw == xu).to(I64) * tri).sum(-1)
        med = (mi * (pos == cfg.median_index).to(I64)).sum(-1)
        valid10 = (role == LEADER) & (med > ci)
        emit(valid10, ones(S), dmul(self.C_ci, med - ci) if want_fp else None)

        # F11 Restart(s)  [B, s]
        valid11 = (role == LEADER) & (rc[:, None] < cfg.max_restart)
        emit(valid11, ones(S),
             dmul(self.C_role, FOLLOWER - role) + self.C_rc if want_fp else None)

        valid = torch.cat(valid_parts, 1)
        mult = torch.cat(mult_parts, 1)
        if not want_fp:
            return valid, mult, None, None, abort
        return valid, mult, torch.cat(fpv_parts, 1), torch.cat(fpf_parts, 1), abort

    # ---- the selection of the engine: the kernel on the card -----------------

    def expand_plain(self, st):
        """Plain twin of the ``dense_expand`` kernel with fingerprints (the
        reference's ``_expand_dense``, successor.py:335, with the parents'
        ``msum`` from ``msg_hash``): (valid, mult i32 (0 where invalid),
        fp_view, fp_full (SENT where invalid), abort)."""
        msum = self.fpr.msg_hash_plain(st.msgs)
        valid, mult, fv, ff, abort = self(st, msum, True)
        sent = torch.full_like(fv, SENT)
        return (valid, torch.where(valid, mult, torch.zeros_like(mult)).to(torch.int32),
                torch.where(valid, fv, sent), torch.where(valid, ff, sent), abort)

    def guards_plain(self, st):
        """Plain twin of the guards-only ``dense_expand`` (the legacy guard,
        ``_expand_guards``, successor.py:339): (valid, mult i32, abort)."""
        valid, mult, _fv, _ff, abort = self(st, None, False)
        return valid, torch.where(valid, mult, torch.zeros_like(mult)).to(torch.int32), abort

    def expand(self, st):
        """(valid, mult, fp_view, fp_full, abort) of a parent batch: the
        ``dense_expand`` kernel on the card, the plain twin on the CPU."""
        if st.msgs.device.type == "cpu":
            return self.expand_plain(st)
        return kernels.dense_expand(self, st, want_fp=True)

    def guards(self, st):
        """(valid, mult, abort): the guards-only ``dense_expand`` kernel on
        the card, the plain twin on the CPU."""
        if st.msgs.device.type == "cpu":
            return self.guards_plain(st)
        valid, mult, _fv, _ff, abort = kernels.dense_expand(self, st, want_fp=False)
        return valid, mult, abort
