"""Canonical state fingerprints: the port of ``tla_raft_tpu/ops/fingerprint.py``.

The fingerprint definition is the reference's, bit for bit: a multilinear
hash ``h = sum_e feat[e] * C[e] (mod 2^32)`` over the flattened state
features plus the set hash ``sum_{m in msgs} G[m]`` over the message
set, both folded over every server permutation (the symmetry group),
with the coefficients split into four signed byte planes.  ``fp_view``
is the unsigned minimum over permutations of ``ch0 << 32 | ch1`` (the
VIEW projection) and ``fp_full`` of ``ch2 << 32 | ch3`` (all variables).
The coefficient tables are built here with the reference's numpy code,
copied; tests/test_torch_tables.py holds them equal to the reference's.

Two forms of the message-set hash, as in the reference:

* **monolithic**: ``G_planes`` holds the permutation-folded plane table
  ``[M, P * chan * 4]`` (463 KB at S=3, 30.9 MB at S=5);
* **pair-block factored** (``factored_msgs``, chosen where the folded
  table would pass 64 MiB — S=7, where it would be 2.7 GB): a server
  permutation moves only the (src, dst) pair digit ``q`` of a message id
  ``off_t + q * stride_t + rest``, so per message type t the state's
  partial sums ``R[q, q', plane]`` of ``Gt_planes[t][rest, q' * 16 +
  plane]`` fold over the permutations as ``sum_q R[q, PPERM[p, q]]``.
  Both forms give the same bits (tests/test_torch_scale.py).

``state_fingerprints`` is kernel K3 (csrc/fingerprint.cu): on a CUDA
frontier it launches the kernel, on a CPU frontier it runs the plain
twin ``state_fingerprints_plain``.  The input is the sparse form
(``Frontier``: core fields + ascending message ids), so the kernel's
message part adds one table entry per set id and permutation instead of
a product with the whole M-bit mask; the ids are unique per state, so
the sum equals ``bits @ G_planes`` exactly.  The kernel adds the
*effective* u32 coefficients (``_eff_u32``: the four signed byte planes
combined), which is the plane sum combined, because the combine is
linear mod 2^32; ``kernel_tables_np`` builds them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import RaftConfig
from ..device import resolve_device
from ..models.raft import Frontier
from ..u64 import (
    _combine_planes_u32,
    _eff_u32,
    _mix32_np,
    _u32_to_i8_planes,
    umin,
)
from .msg_universe import MsgUniverse, get_universe

_SEED = 0x7C3A_11E5
_PHI = 0x9E3779B9
_PHI2 = 0x85EBCA6B


class FeatureSpec:
    """Flattening of the 12 state variables into one small-int vector.

    Layout: currentTerm[S], role[S], logTerm[S*L], logVal[S*L],
    logLen[S], matchIndex[S*S], nextIndex[S*S], commitIndex[S],
    votedFor one-hot [S*(S+1)] — the VIEW prefix — then electionCount,
    restartCount, pendingResponse[S*S], valSent[V].
    """

    def __init__(self, cfg: RaftConfig):
        self.cfg = cfg
        S, L, V = cfg.S, cfg.L, cfg.V
        off = 0

        def take(n: int) -> slice:
            nonlocal off
            sl = slice(off, off + n)
            off += n
            return sl

        self.ct = take(S)
        self.role = take(S)
        self.lt = take(S * L)
        self.lv = take(S * L)
        self.ll = take(S)
        self.mi = take(S * S)
        self.ni = take(S * S)
        self.ci = take(S)
        self.vf_oh = take(S * (S + 1))
        self.F_view = off
        self.ec = take(1)
        self.rc = take(1)
        self.pend = take(S * S)
        self.vs = take(V)
        self.F = off

    def features(self, st) -> torch.Tensor:
        """RaftState / Frontier -> i8[N, F] (uint8 fields wrap to int8)."""
        S, L, V = self.cfg.S, self.cfg.L, self.cfg.V
        n = st.voted_for.shape[0]

        def flat(x, k):
            return x.reshape(n, k).to(torch.int8)

        ar = torch.arange(S + 1, dtype=st.voted_for.dtype, device=st.voted_for.device)
        oh = (st.voted_for[:, :, None] == ar).to(torch.int8)
        return torch.cat(
            [
                flat(st.current_term, S),
                flat(st.role, S),
                flat(st.log_term, S * L),
                flat(st.log_val, S * L),
                flat(st.log_len, S),
                flat(st.match_index, S * S),
                flat(st.next_index, S * S),
                flat(st.commit_index, S),
                oh.reshape(n, S * (S + 1)),
                flat(st.election_count, 1),
                flat(st.restart_count, 1),
                flat(st.pending, S * S),
                flat(st.val_sent, V),
            ],
            dim=1,
        )

    def perm_source_indices(self, p: tuple[int, ...]) -> np.ndarray:
        """pi[d] = source feature index that lands at position d under p."""
        cfg = self.cfg
        S, L, V = cfg.S, cfg.L, cfg.V
        inv = np.empty(S, np.int64)
        for s0 in range(S):
            inv[p[s0] - 1] = s0
        src = np.empty(self.F, np.int64)
        ar = np.arange
        for sl in (self.ct, self.role, self.ll, self.ci):
            src[sl] = sl.start + inv
        for sl in (self.lt, self.lv):
            src[sl] = sl.start + (inv[:, None] * L + ar(L)[None, :]).ravel()
        for sl in (self.mi, self.ni, self.pend):
            src[sl] = sl.start + (inv[:, None] * S + inv[None, :]).ravel()
        wmap = np.concatenate([[0], inv + 1])
        src[self.vf_oh] = self.vf_oh.start + (inv[:, None] * (S + 1) + wmap[None, :]).ravel()
        src[self.ec] = self.ec.start
        src[self.rc] = self.rc.start
        src[self.vs] = self.vs.start + ar(V)
        return src


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two small-int tensors, through float64
    (torch has no integer matmul on the card, and none that is fast on the
    CPU): exact while every |sum| < 2^53, which the plane tables keep
    (127 * 33,768 * 128 << 2^53)."""
    return torch.round(a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _effective_u32_np(c: np.ndarray) -> np.ndarray:
    """u32 coefficients -> the u32 their four signed byte planes combine to
    (what a plane sum adds, mod 2^32)."""
    return _eff_u32(torch.from_numpy(c.astype(np.int64))).numpy().astype(np.uint32)


# rows of the plain twin per block: bounds its [rows, P * chan * 4] temporaries
_PLAIN_ELEMS = 1 << 22


class Fingerprinter:
    """Permutation-folded hash tables + the fingerprint kernel for one cfg.

    Channels 0,1 -> fp_view (aux coefficients zeroed under VIEW);
    channels 2,3 -> fp_full.  ``force_factored`` overrides the choice of
    the message-hash form (the reference's argument of the same name)."""

    N_CHAN = 4

    def __init__(self, cfg: RaftConfig, seed: int = _SEED, device=None,
                 force_factored: bool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.uni: MsgUniverse = get_universe(cfg)
        self.spec = FeatureSpec(cfg)
        F, M = self.spec.F, self.uni.M
        self.perms = cfg.server_perms()
        P = len(self.perms)
        self.P = P
        self.factored_msgs = P * self.N_CHAN * M * 4 > (64 << 20)
        if force_factored is not None:
            self.factored_msgs = bool(force_factored)

        rng = np.random.default_rng(seed)
        self.seed = np.uint32(seed)
        C = rng.integers(0, 1 << 32, size=(self.N_CHAN, F), dtype=np.uint32)
        if cfg.use_view:
            C[0:2, self.spec.F_view :] = 0  # aux vars excluded from view hash
        Cp = np.empty((P, self.N_CHAN, F), np.uint32)
        for pi, p in enumerate(self.perms):
            Cp[pi][:, self.spec.perm_source_indices(p)] = C
        # plane layout: columns = (P, chan, byte)
        self.C_planes_np = (
            _u32_to_i8_planes(Cp).transpose(2, 0, 1, 3).reshape(F, P * self.N_CHAN * 4)
        )
        self._Cp_np = Cp
        self.C_planes = torch.from_numpy(np.ascontiguousarray(self.C_planes_np)).to(self.device)
        self.pair_perm = self.uni.pair_perm_table  # int32 [P, NP]
        self.NP = self.pair_perm.shape[1]
        if self.factored_msgs:
            self._build_pair_block_tables()
            self.G_planes_np = self.G_planes = None
        else:
            G = np.moveaxis(self.raw_msg_coef_np(np.arange(M, dtype=np.uint32)), -1, 0)
            Gp = np.empty((P, self.N_CHAN, M), np.uint32)
            pt = self.uni.perm_table
            for pi in range(P):
                Gp[pi] = G[:, pt[pi]]
            self.G_planes_np = (
                _u32_to_i8_planes(Gp).transpose(2, 0, 1, 3).reshape(M, P * self.N_CHAN * 4)
            )
            self._Gp_np = Gp
            self.G_planes = torch.from_numpy(np.ascontiguousarray(self.G_planes_np)).to(
                self.device)
        # K3's tables on the card, built here: a first launch may be inside a
        # graph capture, which cannot copy from the host
        self.ktab = self._kernel_tables_on(self.device) if self.device.type == "cuda" else None

    def _build_pair_block_tables(self) -> None:
        """Per-type pair-block plane tables ``Gt_planes[t]`` i8 [stride_t,
        NP * chan * 4] and the P-fold map ``fold_index`` [P, NP] = q * NP +
        PPERM[p, q], the column of the reference's one-hot fold
        ``_ppfold`` that (p, q) selects (fingerprint.py:332)."""
        uni = self.uni
        # the reference's exactness bound for its f32 fold (every folded
        # partial sums at most M plane bytes): the port folds in int64, but
        # a universe past it would leave the reference's fingerprints, so it
        # fails here as the reference does
        if 127 * uni.M >= (1 << 24):
            raise ValueError(
                f"factored message hash exactness bound violated: 127*M = {127 * uni.M} "
                ">= 2^24; use the monolithic form (force_factored=False)")
        NP = self.NP
        self.Gt_planes_np = []
        for off, stride in zip(uni.type_offsets, uni.type_strides):
            q = np.arange(NP, dtype=np.uint32)[:, None]
            r = np.arange(stride, dtype=np.uint32)[None, :]
            coef = self.raw_msg_coef_np(np.uint32(off) + q * np.uint32(stride) + r)
            planes = _u32_to_i8_planes(coef)  # i8 [NP, stride, chan, 4]
            self.Gt_planes_np.append(np.ascontiguousarray(
                planes.transpose(1, 0, 2, 3).reshape(stride, NP * self.N_CHAN * 4)))
        self.fold_index_np = (np.arange(NP, dtype=np.int64)[None, :] * NP
                              + self.pair_perm.astype(np.int64))
        self.Gt_planes = [torch.from_numpy(g).to(self.device) for g in self.Gt_planes_np]
        self.fold_index = torch.from_numpy(self.fold_index_np).to(self.device)

    def raw_msg_coef_np(self, ids: np.ndarray) -> np.ndarray:
        """Message id(s) -> raw u32 coefficient per channel [..., chan]:
        ``G[c, m] = mix32(m*PHI + c*PHI2 + seed)``."""
        with np.errstate(over="ignore"):
            chan_c = (
                np.arange(self.N_CHAN, dtype=np.uint32) * np.uint32(_PHI2)
                + np.uint32(self.seed)
            )
            x = ids.astype(np.uint32)[..., None] * np.uint32(_PHI) + chan_c
        return _mix32_np(x)

    # -- the plain twin ---------------------------------------------------

    def ids_to_bits(self, ids: torch.Tensor) -> torch.Tensor:
        """msg ids [N, cap_m] (-1 padded) -> 0/1 int8 [N, M]."""
        M = self.uni.M
        n = ids.shape[0]
        idl = ids.to(torch.int64)
        tgt = torch.where(idl >= 0, idl, torch.full_like(idl, M))
        bits = torch.zeros((n, M + 1), dtype=torch.int8, device=ids.device)
        bits.scatter_(1, tgt, 1)
        return bits[:, :M]

    def msg_planes_factored(self, bits: torch.Tensor) -> torch.Tensor:
        """Pair-block message hash (the reference's ``_msg_hash_factored``
        before its combine): 0/1 bits [n, M] -> plane sums i64 [n, P, chan,
        4].  The partial sums R and the fold are exact integers (the fold
        gathers R[q, PPERM[p, q]] and sums over q in int64)."""
        uni, NP, n = self.uni, self.NP, bits.shape[0]
        R = None
        for (off, stride), Gt in zip(zip(uni.type_offsets, uni.type_strides), self.Gt_planes):
            bt = bits[:, off : off + NP * stride].reshape(n, NP, stride)
            Rt = _int_matmul(bt, Gt)  # [n, q, q' * chan * 4]
            R = Rt if R is None else R + Rt
        R = R.reshape(n, NP * NP, self.N_CHAN * 4)
        out = torch.zeros((n, self.P, self.N_CHAN * 4), dtype=torch.int64, device=bits.device)
        for q in range(NP):
            out += R[:, self.fold_index[:, q]]
        return out.reshape(n, self.P, self.N_CHAN, 4)

    def msg_planes_factored_np(self, bits: np.ndarray) -> np.ndarray:
        """numpy twin of ``msg_planes_factored`` (the reference's
        ``_msg_planes_factored_np``, fingerprint.py:787)."""
        uni, NP = self.uni, self.NP
        b = np.asarray(bits).astype(np.int64)
        R = None
        for (off, stride), Gt in zip(zip(uni.type_offsets, uni.type_strides),
                                     self.Gt_planes_np):
            bt = b[:, off : off + NP * stride].reshape(-1, NP, stride)
            Rt = bt @ Gt.astype(np.int64)
            R = Rt if R is None else R + Rt
        R = R.reshape(R.shape[0], NP * NP, self.N_CHAN * 4)
        folded = np.zeros((R.shape[0], self.P, self.N_CHAN * 4), np.int64)
        for q in range(NP):
            folded += R[:, self.fold_index_np[:, q]]
        return folded.reshape(-1, self.P, self.N_CHAN, 4)

    def state_fingerprints_plain(self, fr: Frontier) -> tuple[torch.Tensor, torch.Tensor]:
        """Plain torch twin of K3: (fp_view, fp_full) as int64 u64 bits,
        in blocks of rows that bound the temporaries."""
        n = fr.msg_ids.shape[0]
        step = max(1, _PLAIN_ELEMS // (self.P * self.N_CHAN * 4))
        views, fulls = [], []
        for a in range(0, n, step):
            part = Frontier(*(x[a : a + step] for x in fr))
            planes = _int_matmul(self.spec.features(part), self.C_planes)
            bits = self.ids_to_bits(part.msg_ids)
            planes = planes.reshape(-1, self.P, self.N_CHAN, 4)
            if self.factored_msgs:
                planes = planes + self.msg_planes_factored(bits)
            else:
                planes = planes + _int_matmul(bits, self.G_planes).reshape(planes.shape)
            v, f = self.finalize(_combine_planes_u32(planes))
            views.append(v)
            fulls.append(f)
        if not views:
            e = torch.empty((0,), dtype=torch.int64, device=fr.msg_ids.device)
            return e, e.clone()
        return torch.cat(views), torch.cat(fulls)

    @staticmethod
    def finalize(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """u32 [..., P, chan] (int64) -> (fp_view, fp_full): the unsigned
        minimum over the symmetry group of the two 64-bit channel pairs."""
        view = (h[..., 0] << 32) | h[..., 1]
        full = (h[..., 2] << 32) | h[..., 3]
        return umin(view, -1), umin(full, -1)

    # -- kernel K3 --------------------------------------------------------

    def kernel_tables_np(self) -> dict:
        """K3's tables, in numpy:

        * ``ct``: the feature planes transposed, i8 [P * 16, F_pad] (F
          padded with zeros to a multiple of 32, the MMA depth);
        * monolithic: ``msg_eff`` u32 [M, P, chan] = the effective
          coefficient of message m under permutation p;
        * factored: ``gt_eff`` u32 [sum of strides, NP, chan] (type t's
          rows from ``row_base[t]``: the effective coefficient of the id
          with pair digit q' and rest r) and ``pperm`` u8 [P, NP]."""
        F = self.spec.F
        f_pad = -(-F // 32) * 32
        ct = np.zeros((self.P * self.N_CHAN * 4, f_pad), np.int8)
        ct[:, :F] = self.C_planes_np.T
        out = dict(ct=ct, f_pad=f_pad)
        if self.factored_msgs:
            uni, NP = self.uni, self.NP
            rows = []
            for off, stride in zip(uni.type_offsets, uni.type_strides):
                q = np.arange(NP, dtype=np.uint32)[None, :]
                r = np.arange(stride, dtype=np.uint32)[:, None]
                rows.append(_effective_u32_np(self.raw_msg_coef_np(
                    np.uint32(off) + q * np.uint32(stride) + r)))  # [stride, NP, chan]
            out.update(gt_eff=np.ascontiguousarray(np.concatenate(rows)),
                       pperm=self.pair_perm.astype(np.uint8),
                       row_base=np.concatenate([[0], np.cumsum(uni.type_strides)[:-1]]))
        else:
            out.update(msg_eff=np.ascontiguousarray(
                _effective_u32_np(self._Gp_np).transpose(2, 0, 1)))  # [M, P, chan]
        return out

    def _kernel_tables_on(self, dev) -> dict:
        """``kernel_tables_np`` on ``dev`` (the u32 tables as int32 bit
        patterns)."""
        t = self.kernel_tables_np()
        out = dict(ct=torch.from_numpy(t["ct"]).to(dev), f_pad=t["f_pad"])
        if self.factored_msgs:
            out.update(gt_eff=torch.from_numpy(t["gt_eff"].view(np.int32)).to(dev),
                       pperm=torch.from_numpy(t["pperm"]).to(dev),
                       row_base=[int(x) for x in t["row_base"]])
        else:
            out["msg_eff"] = torch.from_numpy(t["msg_eff"].view(np.int32)).to(dev)
        return out

    def state_fingerprints(self, fr: Frontier) -> tuple[torch.Tensor, torch.Tensor]:
        """(fp_view i64[N], fp_full i64[N]) of a Frontier batch: kernel K3
        on the card, the plain twin on the CPU."""
        if fr.msg_ids.device.type == "cpu":
            return self.state_fingerprints_plain(fr)
        return kernels.fingerprints(self, fr)
