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

**Orbit pruning** (B17, ``TLA_RAFT_ORBIT=1``; the reference's
``state_fingerprints_orbit`` and ``bfs._orbit_chunk_fps``) is a second
fingerprint definition: a per-state Weisfeiler-Leman colouring of the
servers from VIEW data picks one canonical permutation (servers sorted by
colour) where no two colours tie ("discrete" states), and the fingerprint
is the hash at that one permutation; tied states keep the exact minimum
over P.  The values differ from the min-over-P definition (the counts do
not), so one run uses one definition throughout.  ``state_fingerprints_orbit``
is the ``orbit`` kernel (csrc/orbit.cu) on the card and the plain twin
``state_fingerprints_orbit_plain`` on the CPU; ``orbit_chunk_fps`` folds a
chunk's tied rows with K3's indexed mode on a compacted budget.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..config import RaftConfig
from ..device import resolve_device
from ..models.raft import Frontier
from ..u64 import (
    MASK32,
    SENT,
    _combine_planes_u32,
    _eff_u32,
    _mix32,
    _mix32_np,
    _u32_to_i8_planes,
    umin,
)
from .msg_universe import MsgUniverse, _dst_idx, get_universe

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

    # -- the incremental (delta) hash of canon="expand" -------------------

    def raw_msg_coef(self, ids: torch.Tensor) -> torch.Tensor:
        """Torch form of ``raw_msg_coef_np`` (the reference's
        ``raw_msg_coef``, fingerprint.py:379): ids [...] -> u32 [..., chan]
        in int64."""
        chan = torch.arange(self.N_CHAN, dtype=torch.int64, device=ids.device)
        chan_c = (chan * _PHI2 + int(self.seed)) & MASK32
        return _mix32(ids.to(torch.int64)[..., None] * _PHI + chan_c)

    def msg_coef_eff(self, ids: torch.Tensor) -> torch.Tensor:
        """The byte-plane-linearized coefficient a delta adds
        (fingerprint.py:392)."""
        return _eff_u32(self.raw_msg_coef(ids))

    def delta_hash(self, ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """The added messages' contribution (fingerprint.py:456): ids
        i32[..., A], live bool[..., A] -> u32 [..., P, chan] in int64.  A
        dead id (-1 padding, or a message already in the parent's set:
        set union adds nothing, Raft.tla:292-295) adds zero.  Under a
        server permutation only the (src, dst) pair digit of an id moves:
        id_p = off_t + PPERM[p, pair] * stride_t + rest."""
        uni = self.uni
        dev = ids.device
        id0 = ids.to(torch.int64).clamp(0, uni.M - 1)
        offs = torch.tensor(uni.type_offsets, dtype=torch.int64, device=dev)
        strides = torch.tensor(uni.type_strides, dtype=torch.int64, device=dev)
        t = (id0 >= offs[1]).long() + (id0 >= offs[2]).long() + (id0 >= offs[3]).long()
        q = id0 - offs[t]
        pair = torch.div(q, strides[t], rounding_mode="floor")
        rest = q - pair * strides[t]
        pp = torch.from_numpy(self.pair_perm.astype(np.int64)).to(dev)  # [P, NP]
        id_p = offs[t][..., None] + pp.t()[pair] * strides[t][..., None] + rest[..., None]
        g = self.msg_coef_eff(id_p)  # [..., A, P, chan]
        g = torch.where(live[..., None, None], g, torch.zeros_like(g))
        return g.sum(-3) & MASK32

    def msg_hash_plain(self, msgs: torch.Tensor) -> torch.Tensor:
        """The message-set hash of packed words int32 [N, n_words] (the
        reference's ``msg_hash``, fingerprint.py:418): u32 [N, P, chan] in
        int64, in either form."""
        from .dense_expand import unpack_bits

        bits = unpack_bits(msgs, self.uni.M)
        if self.factored_msgs:
            planes = self.msg_planes_factored(bits)
        else:
            planes = _int_matmul(bits, self.G_planes).reshape(-1, self.P, self.N_CHAN, 4)
        return _combine_planes_u32(planes)

    def feat_hash(self, feats: torch.Tensor) -> torch.Tensor:
        """i8 [N, F] -> u32 [N, P, chan] in int64 (fingerprint.py:408)."""
        planes = _int_matmul(feats, self.C_planes).reshape(-1, self.P, self.N_CHAN, 4)
        return _combine_planes_u32(planes)

    def child_fingerprints(self, feats, parent_msum, ids, live):
        """Successor fingerprints from fresh features and the parent's
        message hash plus the added messages (fingerprint.py:528)."""
        h = self.feat_hash(feats) + parent_msum + self.delta_hash(ids, live)
        return self.finalize(h & MASK32)

    @functools.cached_property
    def ceff(self) -> torch.Tensor:
        """The effective u32 feature coefficients, int32 bit patterns
        [F, P, chan] on the Fingerprinter's device: the table the
        ``dense_expand`` kernel reads for its feature deltas (the
        reference's ``C_*`` blocks are slices of it, dense_expand.py:100)."""
        c = _effective_u32_np(self._Cp_np).transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(c).view(np.int32)).to(self.device)

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
        * ``form``: K3's form (``kernels.k3_form``), whose tables follow;
        * the pair-digit tables, for the pair-digit and factored forms
          (0.26 MB at S=5): ``gt_eff`` u32 [sum of strides, NP, chan] (type
          t's rows from ``row_base[t]``: the effective coefficient of the
          id with pair digit q' and rest r; the orbit kernel reads it under
          the factored hash) and ``pperm`` u8 [P, NP]; the factored form
          reads ``gt_half`` u32 [sum of strides, 2, NP, 2] (the same rows,
          channels 0-1, then 2-3: one half a pass);
        * monolithic (not ``factored_msgs``): ``msg_eff`` u32 [M, P, chan]
          = the effective coefficient of message m under permutation p
          (K3's S <= 3 form and the orbit kernel read it)."""
        F = self.spec.F
        f_pad = -(-F // 32) * 32
        ct = np.zeros((self.P * self.N_CHAN * 4, f_pad), np.int8)
        ct[:, :F] = self.C_planes_np.T
        uni, NP = self.uni, self.NP
        form = kernels.k3_form(self.factored_msgs, self.P, f_pad)
        out = dict(ct=ct, f_pad=f_pad, form=form,
                   row_base=np.concatenate([[0], np.cumsum(uni.type_strides)[:-1]]))
        if form != "s3":
            rows = []
            for off, stride in zip(uni.type_offsets, uni.type_strides):
                q = np.arange(NP, dtype=np.uint32)[None, :]
                r = np.arange(stride, dtype=np.uint32)[:, None]
                rows.append(_effective_u32_np(self.raw_msg_coef_np(
                    np.uint32(off) + q * np.uint32(stride) + r)))  # [stride, NP, chan]
            gt = np.ascontiguousarray(np.concatenate(rows))
            out.update(gt_eff=gt, pperm=self.pair_perm.astype(np.uint8))
            if form == "factored":
                out["gt_half"] = np.ascontiguousarray(
                    gt.reshape(gt.shape[0], NP, 2, 2).transpose(0, 2, 1, 3))
        if not self.factored_msgs:
            out["msg_eff"] = np.ascontiguousarray(
                _effective_u32_np(self._Gp_np).transpose(2, 0, 1))  # [M, P, chan]
        return out

    def _kernel_tables_on(self, dev) -> dict:
        """``kernel_tables_np`` on ``dev`` (the u32 tables as int32 bit
        patterns)."""
        t = self.kernel_tables_np()
        out = dict(t, ct=torch.from_numpy(t["ct"]).to(dev),
                   row_base=[int(x) for x in t["row_base"]])
        for k in ("gt_eff", "gt_half", "msg_eff"):
            if k in t:
                out[k] = torch.from_numpy(t[k].view(np.int32)).to(dev)
        if "pperm" in t:
            out["pperm"] = torch.from_numpy(t["pperm"]).to(dev)
        return out

    def state_fingerprints(self, fr: Frontier) -> tuple[torch.Tensor, torch.Tensor]:
        """(fp_view i64[N], fp_full i64[N]) of a Frontier batch: kernel K3
        on the card, the plain twin on the CPU."""
        if fr.msg_ids.device.type == "cpu":
            return self.state_fingerprints_plain(fr)
        return kernels.fingerprints(self, fr)

    # -- orbit pruning (B17) --------------------------------------------------

    @functools.cached_property
    def orbit_tables(self) -> dict:
        """The reference's ``_orbit_tables`` (fingerprint.py:565), on the
        Fingerprinter's device: ``psi`` [P, F] (``perm_source_indices`` of
        every permutation), ``ppinv`` [P, NP] (the inverse pair-digit map),
        ``qidx`` [S, S] ((src, dst) -> pair digit; diagonal 0), ``W`` (one
        int32 vector of random pair-hash coefficients per message type,
        lengths ``type_strides``), ``C0`` i8 [F, 16] and ``G0`` i8 [M, 16]
        (the identity permutation's feature and message planes), ``fact``
        [S] ((S-1-i)!, the Lehmer weights); ``w_cat`` is ``W`` concatenated
        (the ``orbit`` kernel's).  Built at first use: the engine touches
        it at construction, since a first launch may be inside a graph
        capture."""
        uni, S, P, NP, F = self.uni, self.cfg.S, self.P, self.NP, self.spec.F
        psi = np.stack([self.spec.perm_source_indices(p) for p in self.perms])
        ppinv = np.empty_like(self.pair_perm)
        ppinv[np.arange(P)[:, None], self.pair_perm] = np.arange(NP)[None, :]
        qidx = np.zeros((S, S), np.int64)
        for src in range(1, S + 1):
            for dst in range(1, S + 1):
                if src != dst:
                    qidx[src - 1, dst - 1] = (src - 1) * (S - 1) + _dst_idx(src, dst)
        rng = np.random.default_rng(int(self.seed) ^ 0x0B17)
        W = [rng.integers(-(1 << 31), 1 << 31, size=(s,), dtype=np.int64).astype(np.int32)
             for s in uni.type_strides]
        C0 = self.C_planes_np.reshape(F, P, self.N_CHAN * 4)[:, 0, :]
        G0 = _u32_to_i8_planes(self.raw_msg_coef_np(np.arange(uni.M, dtype=np.uint32)))
        fact = np.ones(S, np.int64)
        for i in range(S - 2, -1, -1):
            fact[i] = fact[i + 1] * (S - 1 - i)
        dev = self.device

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        return dict(psi=t(psi, torch.int64), ppinv=t(ppinv, torch.int64),
                    qidx=t(qidx, torch.int64), W=[t(w, torch.int32) for w in W],
                    w_cat=t(np.concatenate(W), torch.int32), C0=t(C0, torch.int8),
                    G0=t(G0.reshape(uni.M, self.N_CHAN * 4), torch.int8),
                    fact=t(fact, torch.int64))

    def orbit_pairh(self, ids: torch.Tensor) -> torch.Tensor:
        """The reference's ``_orbit_pairh`` (fingerprint.py:619) from the
        sparse ids: per (src, dst) pair digit q, the sum of ``W_t[r]`` over
        the state's messages ``off_t + q * stride_t + r``, mod 2^32: u32
        [n, NP] held in int64."""
        uni, dev = self.uni, ids.device
        idl = ids.to(torch.int64)
        live = idl >= 0
        id0 = idl.clamp(min=0)  # dead ids decode as id 0 and add nothing
        offs = torch.tensor(uni.type_offsets, dtype=torch.int64, device=dev)
        strides = torch.tensor(uni.type_strides, dtype=torch.int64, device=dev)
        base = torch.tensor([sum(uni.type_strides[:t]) for t in range(4)], dtype=torch.int64,
                            device=dev)
        ty = (id0 >= offs[1]).long() + (id0 >= offs[2]).long() + (id0 >= offs[3]).long()
        rel = id0 - offs[ty]
        q = torch.div(rel, strides[ty], rounding_mode="floor")
        w = self.orbit_tables["w_cat"].to(dev).to(torch.int64)[base[ty] + rel - q * strides[ty]]
        acc = torch.zeros((ids.shape[0], self.NP), dtype=torch.int64, device=dev)
        acc.scatter_add_(1, q, torch.where(live, w, torch.zeros_like(w)))
        return acc & MASK32

    def orbit_colors(self, st, pairh: torch.Tensor) -> torch.Tensor:
        """The reference's ``_orbit_colors`` (fingerprint.py:634): three
        rounds of view-covariant WL refinement, u32 [n, S] in int64.  Every
        sum is taken in int64 and masked (``_mix32`` masks its input), which
        is the u32 arithmetic mod 2^32."""
        S, L = self.cfg.S, self.cfg.L
        tb = self.orbit_tables
        dev = pairh.device

        def u(x):
            return x.to(torch.int64)

        ct, role, ll, ci = u(st.current_term), u(st.role), u(st.log_len), u(st.commit_index)
        lt, lv, mi, ni, vf = (u(st.log_term), u(st.log_val), u(st.match_index),
                              u(st.next_index), u(st.voted_for))
        lpos = (torch.arange(L, dtype=torch.int64, device=dev) * 0x9E3779B9) & MASK32
        logh = _mix32(lt * 0x85EBCA6B + lv * 0xC2B2AE35 + lpos).sum(-1) & MASK32
        c = _mix32(ct * 0x8DA6B343 + role * 0xD8163841 + ll * 0xCB1AB31F
                   + ci * 0x165667B1 + logh)
        qidx = tb["qidx"].to(dev)
        ph_ij = pairh[:, qidx]  # [n, S(i), S(j)]; the diagonal is masked below
        ph_ji = pairh[:, qidx.t()]
        offdiag = ~torch.eye(S, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        mi_d, ni_d = torch.diagonal(mi, 0, -2, -1), torch.diagonal(ni, 0, -2, -1)
        mi_t, ni_t = mi.transpose(-1, -2), ni.transpose(-1, -2)
        vsrc = (vf - 1).clamp(0, S - 1)
        for _ in range(3):
            cj = c[:, None, :]
            e_out = torch.where(offdiag, _mix32(cj + ph_ij * 3 + mi * 0x27D4EB2F
                                                + ni * 0x9E3779B1), zero).sum(-1)
            e_in = torch.where(offdiag, _mix32(cj + ph_ji * 5 + mi_t * 0x85EBCA77
                                               + ni_t * 0xC2B2AE3D), zero).sum(-1)
            vfh = torch.where(vf == 0, torch.full_like(vf, 0x94D049BB),
                              _mix32(c.gather(1, vsrc) + 0xBF58476D))
            c = _mix32((c * 0xFF51AFD7 & MASK32) + e_out + e_in + vfh + mi_d * 0xE6546B64
                       + ni_d * 0x2545F491)
        return c

    def orbit_rank(self, colors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_orbit_rank`` (fingerprint.py:690): (rank i64
        [n], discrete bool [n]).  The canonical permutation maps server i to
        1 + the number of smaller colours; its index in ``server_perms()``
        is the Lehmer code of that image sequence weighted by ``fact``.
        Only meaningful where ``discrete`` (no two colours equal)."""
        S = self.cfg.S
        dev = colors.device
        ci, cj = colors[:, :, None], colors[:, None, :]
        p = (cj < ci).sum(-1)  # 0-based images (u32 values in int64: signed order is unsigned)
        eq = (ci == cj) & ~torch.eye(S, dtype=torch.bool, device=dev)
        discrete = ~eq.any(-1).any(-1)
        after = torch.triu(torch.ones((S, S), dtype=torch.bool, device=dev), diagonal=1)
        code = ((p[:, None, :] < p[:, :, None]) & after).sum(-1)
        return (code * self.orbit_tables["fact"].to(dev)).sum(-1), discrete

    def state_fingerprints_orbit_plain(self, fr: Frontier):
        """Plain twin of the ``orbit`` kernel, in the reference's form
        (``state_fingerprints_orbit``, fingerprint.py:721): (fp_view i64
        [n], fp_full i64 [n], discrete bool [n], rank i64 [n]).  The hash
        at the canonical permutation ``rank`` takes the features permuted
        by ``psi[rank]`` and the message bitmask with each type block's pair
        digits moved by ``ppinv[rank]``, against the identity planes C0 and
        G0.  Exact on every row; the canonical value only where
        ``discrete``.  In blocks of rows that bound the bitmask."""
        tb = self.orbit_tables
        uni, NP = self.uni, self.NP
        n = fr.msg_ids.shape[0]
        step = max(1, _PLAIN_ELEMS // uni.M)
        outs = []
        for a in range(0, n, step):
            part = Frontier(*(x[a : a + step] for x in fr))
            m = part.msg_ids.shape[0]
            dev = part.msg_ids.device
            rank, disc = self.orbit_rank(self.orbit_colors(part, self.orbit_pairh(part.msg_ids)))
            fplanes = self.spec.features(part).gather(1, tb["psi"].to(dev)[rank])
            h = _int_matmul(fplanes, tb["C0"].to(dev))
            bits = self.ids_to_bits(part.msg_ids)
            ppinv_row = tb["ppinv"].to(dev)[rank]  # [m, NP]
            parts = []
            for off, stride in zip(uni.type_offsets, uni.type_strides):
                bt = bits[:, off : off + NP * stride].reshape(m, NP, stride)
                parts.append(bt.gather(1, ppinv_row[:, :, None].expand(m, NP, stride))
                             .reshape(m, NP * stride))
            h = h + _int_matmul(torch.cat(parts, 1), tb["G0"].to(dev))
            h = _combine_planes_u32(h.reshape(m, self.N_CHAN, 4))
            outs.append(((h[:, 0] << 32) | h[:, 1], (h[:, 2] << 32) | h[:, 3], disc, rank))
        if not outs:
            e = torch.empty((0,), dtype=torch.int64, device=fr.msg_ids.device)
            return e, e.clone(), e.to(torch.bool), e.clone()
        return tuple(torch.cat(z) for z in zip(*outs))

    def state_fingerprints_orbit(self, fr: Frontier):
        """(fp_view, fp_full, discrete, rank) of a Frontier batch under orbit
        pruning: the ``orbit`` kernel on the card (rank int32), the plain
        twin on the CPU (rank int64)."""
        if fr.msg_ids.device.type == "cpu":
            return self.state_fingerprints_orbit_plain(fr)
        return kernels.orbit(self, fr)

    def orbit_chunk_fps_plain(self, children: Frontier, lane: torch.Tensor, cap_nd: int):
        """Plain twin of the reference's ``_orbit_chunk_fps`` (bfs.py:1056)
        with its budget ``cap_nd`` given: the canonical-relabel
        fingerprints of every row, then the exact min-over-P fold for the
        live rows that are not discrete, the first ``cap_nd`` of them in
        lane order; (fp_view, fp_full, overflow 0-d bool: more tied live
        rows than ``cap_nd``).  Rows the budget leaves out keep their
        canonical-relabel value, as in the reference (the chunk redoes)."""
        fv, ff, disc, _rank = self.state_fingerprints_orbit_plain(children)
        need = lane & ~disc
        comp = torch.nonzero(need).reshape(-1)[:cap_nd]
        if comp.numel():
            sv, sf = self.state_fingerprints_plain(Frontier(*(x[comp] for x in children)))
            fv[comp] = sv
            ff[comp] = sf
        return fv, ff, need.sum() > cap_nd

    def orbit_chunk_fps(self, children: Frontier, cap_nd: int, cnt: torch.Tensor, *, sub=0,
                        out=None, ovf=None, scratch=None):
        """One chunk's candidate fingerprints under orbit pruning, for its
        first ``cnt - sub`` rows (a device count; the rest get SENT):
        (fp_view, fp_full, ovf), ``ovf`` an int64 0-d word set to 1 when more
        than ``cap_nd`` live rows are tied (the caller's cap_x redo grows
        the budget).  On the card: the ``orbit`` kernel, the compaction of
        its tied flags to ``cap_nd`` row indices (``compact``), and K3's
        indexed mode folding those rows over P in place, all under device
        counts (no host read: it runs inside the grouped level's graph);
        ``out``, ``ovf`` and ``scratch`` (``OrbitScratch``) are written in
        place when given.  On the CPU: ``orbit_chunk_fps_plain``."""
        n = children.msg_ids.shape[0]
        dev = children.msg_ids.device
        if out is None:
            out = (torch.empty((n,), dtype=torch.int64, device=dev),
                   torch.empty((n,), dtype=torch.int64, device=dev))
        if ovf is None:
            ovf = torch.zeros((), dtype=torch.int64, device=dev)
        fv, ff = out
        if dev.type == "cpu":
            live = max(0, min(n, int(cnt) - sub))
            fv.fill_(SENT)
            ff.fill_(SENT)
            if live:
                v, f, o = self.orbit_chunk_fps_plain(Frontier(*(x[:live] for x in children)),
                                                     torch.ones((live,), dtype=torch.bool), cap_nd)
                fv[:live] = v
                ff[:live] = f
                if bool(o):
                    ovf.fill_(1)
            return fv, ff, ovf
        scr = scratch if scratch is not None else OrbitScratch(n, cap_nd, dev)
        kernels.orbit(self, children, out=out, discrete=scr.discrete, rank=scr.rank,
                      tied=scr.tied, cnt=cnt, sub=sub)
        kernels.compact(scr.tied, None, -1, cap_nd, out_a=scr.idx, total=scr.n_tied,
                        tile=scr.tile)
        kernels.fingerprints(self, children, out=out, idx=scr.idx, cnt=scr.n_tied, ovf=ovf)
        return fv, ff, ovf


class OrbitScratch:
    """The device buffers of one chunk's orbit fingerprints (``n`` rows,
    ``cap_nd`` tied rows), allocated once (nothing is allocated while a
    graph is captured): the orbit kernel's discrete / rank / tied outputs,
    the tied rows' indices, their count and the compaction's tile scratch."""

    def __init__(self, n: int, cap_nd: int, device):
        self.discrete = torch.zeros((n,), dtype=torch.bool, device=device)
        self.rank = torch.zeros((n,), dtype=torch.int32, device=device)
        self.tied = torch.zeros((n,), dtype=torch.bool, device=device)
        self.idx = torch.full((cap_nd,), -1, dtype=torch.int64, device=device)
        self.n_tied = torch.zeros((), dtype=torch.int64, device=device)
        self.tile = torch.zeros((kernels.compact_tiles(n),), dtype=torch.int64, device=device)
