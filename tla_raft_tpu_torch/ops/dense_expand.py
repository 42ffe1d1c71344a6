"""Message-side guard terms as dense block algebra (plain torch).

The port of ``DenseExpand.__init__``'s constant tables and
``DenseExpand.msg_guard_parts`` (``tla_raft_tpu/ops/dense_expand.py``):
the message set is viewed as mixed-radix blocks (static reshapes of the
unpacked bit vector, ``[B, pair, term, ...]`` per message type), and every
guard's message-dependent conjunct is an existence or count reduction
over those blocks, with the data-dependent digits (term, prevLogTerm,
...) selected by tiny one-hot contractions.  This is half of the plain
twin of kernel K1 (ops/mxu_expand.py ``guards_plain``); the kernel
itself (csrc/guards.cu) reads the bits it needs directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LEADER, RaftConfig
from ..device import resolve_device
from .msg_universe import MsgUniverse, _dst_from_idx

I64 = torch.int64


def _oh(x: torch.Tensor, n: int) -> torch.Tensor:
    """One-hot over a tiny digit range (all zeros when out of range)."""
    return (x[..., None] == torch.arange(n, dtype=x.dtype, device=x.device)).to(I64)


def ieinsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """Exact integer einsum: int64 on the CPU; float64 on the card, where
    torch has no integer matmul (exact: every count here is < 2^53)."""
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
    """Constants of the dense message-side guard algebra for one config."""

    def __init__(self, cfg: RaftConfig, uni: MsgUniverse, device=None):
        device = resolve_device(device)
        self.cfg = cfg
        self.uni = uni
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
