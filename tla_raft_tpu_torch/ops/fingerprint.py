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

``state_fingerprints`` is kernel K3 (csrc/fingerprint.cu): on a CUDA
frontier it launches the kernel, on a CPU frontier it runs the plain
twin ``state_fingerprints_plain``.  The input is the sparse form
(``Frontier``: core fields + ascending message ids), so the message
part is the sum of at most ``cap_m`` rows of the plane table instead of
a product with the whole 4,824-bit mask; the ids are unique per state,
so the sum equals ``bits @ G_planes`` exactly.
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
    """Exact integer product: int64 on the CPU; on the card, where torch
    has no integer matmul, float64 (exact while |sum| < 2^53, which the
    plane tables keep: 127 * 4824 * 127 << 2^53)."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return torch.round(a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


class Fingerprinter:
    """Permutation-folded hash tables + the fingerprint kernel for one cfg.

    Channels 0,1 -> fp_view (aux coefficients zeroed under VIEW);
    channels 2,3 -> fp_full.  Only the monolithic message hash exists in
    the port: a config whose folded table would exceed the reference's
    64 MB budget (``factored_msgs``) raises ``NotImplementedError``.
    """

    N_CHAN = 4

    def __init__(self, cfg: RaftConfig, seed: int = _SEED, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.uni: MsgUniverse = get_universe(cfg)
        self.spec = FeatureSpec(cfg)
        F, M = self.spec.F, self.uni.M
        self.perms = cfg.server_perms()
        P = len(self.perms)
        self.P = P
        self.factored_msgs = P * self.N_CHAN * M * 4 > (64 << 20)
        if self.factored_msgs:
            raise NotImplementedError(
                f"{cfg.describe()}: the message-set hash needs the pair-block "
                "factored form, which the port does not have yet"
            )

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
        G = np.moveaxis(self.raw_msg_coef_np(np.arange(M, dtype=np.uint32)), -1, 0)
        Gp = np.empty((P, self.N_CHAN, M), np.uint32)
        pt = self.uni.perm_table
        for pi in range(P):
            Gp[pi] = G[:, pt[pi]]
        self.G_planes_np = (
            _u32_to_i8_planes(Gp).transpose(2, 0, 1, 3).reshape(M, P * self.N_CHAN * 4)
        )
        self._Cp_np = Cp
        self._Gp_np = Gp
        self.C_planes = torch.from_numpy(np.ascontiguousarray(self.C_planes_np)).to(self.device)
        self.G_planes = torch.from_numpy(np.ascontiguousarray(self.G_planes_np)).to(self.device)

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

    def state_fingerprints_plain(self, fr: Frontier) -> tuple[torch.Tensor, torch.Tensor]:
        """Plain torch twin of K3: (fp_view, fp_full) as int64 u64 bits."""
        feats = self.spec.features(fr)
        planes = _int_matmul(feats, self.C_planes) + _int_matmul(
            self.ids_to_bits(fr.msg_ids), self.G_planes
        )
        h = _combine_planes_u32(planes.reshape(-1, self.P, self.N_CHAN, 4))
        return self.finalize(h)

    @staticmethod
    def finalize(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """u32 [..., P, chan] (int64) -> (fp_view, fp_full): the unsigned
        minimum over the symmetry group of the two 64-bit channel pairs."""
        view = (h[..., 0] << 32) | h[..., 1]
        full = (h[..., 2] << 32) | h[..., 3]
        return umin(view, -1), umin(full, -1)

    # -- kernel K3 --------------------------------------------------------

    def state_fingerprints(self, fr: Frontier) -> tuple[torch.Tensor, torch.Tensor]:
        """(fp_view i64[N], fp_full i64[N]) of a Frontier batch: kernel K3
        on the card, the plain twin on the CPU."""
        if fr.msg_ids.device.type == "cpu":
            return self.state_fingerprints_plain(fr)
        return kernels.fingerprints(self, fr)
