"""Enumerated message universe: the tensor encoding of the ``msgs`` set.

The port's own copy of ``tla_raft_tpu/ops/msg_universe.py`` (numpy only);
tests/test_torch_tables.py holds the two bit for bit equal.

The reference models the network as one global grow-only *set* of message
records (``SendMsg``/``SendMultiMsgs`` are set union, Raft.tla:43-45;
membership tests at Raft.tla:151,265,319; counting at Raft.tla:160-164).
Because every field of every message schema is statically bounded by the
model constants (SURVEY.md §7.1), the whole reachable message space can be
enumerated up front and the set becomes a **bitmask** — union is bitwise OR,
membership is a bit test, cardinality is a popcount, all cheap on any vector unit.

Message IDs use a mixed-radix layout so kernels can *compute* the ID of a
message they are about to send with pure integer arithmetic (no host
round-trip, no dynamic shapes):

  VoteReq   (src, dst, term, lastLogIndex, lastLogTerm)    Raft.tla:118-125
  VoteResp  (src, dst, term)                               Raft.tla:149
  AppendReq (src, dst, term, prevLogIndex, prevLogTerm,
             entry | empty, leaderCommit)                  Raft.tla:254-263
  AppendResp(src, dst, term, prevLogIndex, succ)           Raft.tla:283-290

Field bounds (derived in config.py): term in 1..T, prevLogIndex and
leaderCommit in 1..L, lastLogIndex in 1..L, lastLogTerm in 0..T-1 (a
candidate's last log term is strictly below the term it mints,
Raft.tla:111,116), prevLogTerm in 0..T, entries carry at most ONE entry
(Raft.tla:252-253). ``dst`` is enumerated over the S-1 servers != src.
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import APPEND_REQ, APPEND_RESP, VOTE_REQ, VOTE_RESP, RaftConfig


def _dst_idx(src, dst):
    """Rank of dst among servers != src (both 1-based)."""
    return dst - 1 - (dst > src)


def _dst_from_idx(src, di):
    d = di + 1
    return np.where(d >= src, d + 1, d) if isinstance(d, np.ndarray) else (d + 1 if d >= src else d)


class MsgUniverse:
    """Static ID space + decode tables + masks for one RaftConfig."""

    def __init__(self, cfg: RaftConfig):
        self.cfg = cfg
        S, T, L, V = cfg.S, cfg.T, cfg.L, cfg.V
        self.S, self.T, self.L, self.V = S, T, L, V
        pairs = S * (S - 1)
        self.n_entry = 1 + T * V  # 0 = heartbeat, else (eterm, eval)
        # The dead FollowerAppendEntry's reject response carries
        # prevLogIndex - 1 (Raft.tla:364), which reaches 0 — compiling it
        # in (--mutate legacy-append) widens the AppendResp pli domain to
        # 0..L; the live spec's responses keep 1..L.
        self.ap_pli_min = 0 if "legacy-append" in cfg.mutations else 1
        self.ap_npli = L + 1 - self.ap_pli_min

        self.vq_size = pairs * T * L * T
        self.vp_size = pairs * T
        self.aq_size = pairs * T * L * (T + 1) * self.n_entry * L
        self.ap_size = pairs * T * self.ap_npli * 2
        self.vq_off = 0
        self.vp_off = self.vq_off + self.vq_size
        self.aq_off = self.vp_off + self.vp_size
        self.ap_off = self.aq_off + self.aq_size
        self.M = self.ap_off + self.ap_size
        self.n_words = (self.M + 31) // 32  # packed u32 width
        # Every type's layout is id = off + pair*stride + rest with
        # pair = (src-1)*(S-1) + dst_idx (src-major, see the encoders), so
        # a server permutation moves only the pair digit: permuted id =
        # off + pair_perm_table[p, pair]*stride + rest.  Kernels exploit
        # this to permute message IDs arithmetically (no [P, M] gather).
        self.type_offsets = (self.vq_off, self.vp_off, self.aq_off, self.ap_off)
        self.type_strides = (
            T * L * T,  # VoteReq block per (src, dst)
            T,  # VoteResp
            T * L * (T + 1) * self.n_entry * L,  # AppendReq
            T * self.ap_npli * 2,  # AppendResp
        )

        self._build_decode_tables()

    # ---- arithmetic encoders (work on numpy and jax arrays alike) -------

    def encode_votereq(self, src, dst, term, lli, llt):
        S, T, L = self.S, self.T, self.L
        di = _dst_idx(src, dst)
        return self.vq_off + (((((src - 1) * (S - 1) + di) * T + (term - 1)) * L + (lli - 1)) * T + llt)

    def encode_voteresp(self, src, dst, term):
        S, T = self.S, self.T
        di = _dst_idx(src, dst)
        return self.vp_off + (((src - 1) * (S - 1) + di) * T + (term - 1))

    def encode_appendreq(self, src, dst, term, pli, plt, entry, lc):
        """entry: 0 for heartbeat, else 1 + (eterm-1)*V + (eval-1)."""
        S, T, L = self.S, self.T, self.L
        di = _dst_idx(src, dst)
        x = ((src - 1) * (S - 1) + di) * T + (term - 1)
        x = (x * L + (pli - 1)) * (T + 1) + plt
        x = (x * self.n_entry + entry) * L + (lc - 1)
        return self.aq_off + x

    def encode_appendresp(self, src, dst, term, pli, succ):
        S, T = self.S, self.T
        di = _dst_idx(src, dst)
        x = (((src - 1) * (S - 1) + di) * T + (term - 1)) * self.ap_npli + (
            pli - self.ap_pli_min
        )
        return self.ap_off + x * 2 + succ

    def entry_code(self, eterm, eval_):
        """Entry field code for a one-entry AppendReq payload (1-based args)."""
        return 1 + (eterm - 1) * self.V + (eval_ - 1)

    # ---- decode tables ---------------------------------------------------

    def _build_decode_tables(self):
        S, T, L, V = self.S, self.T, self.L, self.V
        M = self.M
        typ = np.zeros(M, np.int32)
        src = np.zeros(M, np.int32)
        dst = np.zeros(M, np.int32)
        term = np.zeros(M, np.int32)
        lli = np.zeros(M, np.int32)
        llt = np.zeros(M, np.int32)
        pli = np.zeros(M, np.int32)
        plt = np.zeros(M, np.int32)
        entry = np.zeros(M, np.int32)  # 0 = none/heartbeat
        lc = np.zeros(M, np.int32)
        succ = np.zeros(M, np.int32)

        def grid(*dims):
            return np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")

        # VoteReq
        g = grid(S, S - 1, T, L, T)
        ids = self.vq_off + np.ravel_multi_index([x.ravel() for x in g], (S, S - 1, T, L, T))
        typ[ids] = VOTE_REQ
        src[ids] = g[0].ravel() + 1
        dst[ids] = _dst_from_idx(g[0].ravel() + 1, g[1].ravel())
        term[ids] = g[2].ravel() + 1
        lli[ids] = g[3].ravel() + 1
        llt[ids] = g[4].ravel()
        # VoteResp
        g = grid(S, S - 1, T)
        ids = self.vp_off + np.ravel_multi_index([x.ravel() for x in g], (S, S - 1, T))
        typ[ids] = VOTE_RESP
        src[ids] = g[0].ravel() + 1
        dst[ids] = _dst_from_idx(g[0].ravel() + 1, g[1].ravel())
        term[ids] = g[2].ravel() + 1
        # AppendReq
        g = grid(S, S - 1, T, L, T + 1, self.n_entry, L)
        ids = self.aq_off + np.ravel_multi_index(
            [x.ravel() for x in g], (S, S - 1, T, L, T + 1, self.n_entry, L)
        )
        typ[ids] = APPEND_REQ
        src[ids] = g[0].ravel() + 1
        dst[ids] = _dst_from_idx(g[0].ravel() + 1, g[1].ravel())
        term[ids] = g[2].ravel() + 1
        pli[ids] = g[3].ravel() + 1
        plt[ids] = g[4].ravel()
        entry[ids] = g[5].ravel()
        lc[ids] = g[6].ravel() + 1
        # AppendResp
        g = grid(S, S - 1, T, self.ap_npli, 2)
        ids = self.ap_off + np.ravel_multi_index(
            [x.ravel() for x in g], (S, S - 1, T, self.ap_npli, 2)
        )
        typ[ids] = APPEND_RESP
        src[ids] = g[0].ravel() + 1
        dst[ids] = _dst_from_idx(g[0].ravel() + 1, g[1].ravel())
        term[ids] = g[2].ravel() + 1
        pli[ids] = g[3].ravel() + self.ap_pli_min
        succ[ids] = g[4].ravel()

        self.typ, self.src, self.dst, self.term = typ, src, dst, term
        self.lli, self.llt, self.pli, self.plt = lli, llt, pli, plt
        self.entry, self.lc, self.succ = entry, lc, succ
        # entry field decode: eterm/eval (0 when no entry)
        has = entry > 0
        self.eterm = np.where(has, (entry - 1) // V + 1, 0).astype(np.int32)
        self.eval_ = np.where(has, (entry - 1) % V + 1, 0).astype(np.int32)

    # ---- oracle bridge ---------------------------------------------------

    def msg_to_id(self, m: tuple) -> int:
        t = m[0]
        if t == VOTE_REQ:
            _, s, d, tm, lli, llt = m
            return int(self.encode_votereq(s, d, tm, lli, llt))
        if t == VOTE_RESP:
            _, s, d, tm = m
            return int(self.encode_voteresp(s, d, tm))
        if t == APPEND_REQ:
            _, s, d, tm, pli, plt, entries, lc = m
            e = self.entry_code(entries[0][0], entries[0][1]) if entries else 0
            return int(self.encode_appendreq(s, d, tm, pli, plt, e, lc))
        if t == APPEND_RESP:
            _, s, d, tm, pli, succ = m
            return int(self.encode_appendresp(s, d, tm, pli, int(succ)))
        raise ValueError(f"bad message {m}")

    def id_to_msg(self, i: int) -> tuple:
        t = int(self.typ[i])
        s, d, tm = int(self.src[i]), int(self.dst[i]), int(self.term[i])
        if t == VOTE_REQ:
            return (t, s, d, tm, int(self.lli[i]), int(self.llt[i]))
        if t == VOTE_RESP:
            return (t, s, d, tm)
        if t == APPEND_REQ:
            e = int(self.entry[i])
            entries = () if e == 0 else ((int(self.eterm[i]), int(self.eval_[i])),)
            return (t, s, d, tm, int(self.pli[i]), int(self.plt[i]), entries, int(self.lc[i]))
        return (t, s, d, tm, int(self.pli[i]), bool(self.succ[i]))

    def msgs_to_mask(self, msgs) -> np.ndarray:
        """frozenset of message tuples -> packed u32[n_words]."""
        out = np.zeros(self.n_words, np.uint32)
        for m in msgs:
            i = self.msg_to_id(m)
            out[i >> 5] |= np.uint32(1 << (i & 31))
        return out

    def mask_to_msgs(self, mask: np.ndarray) -> frozenset:
        ids = np.nonzero(self.unpack_bits(mask))[0]
        return frozenset(self.id_to_msg(int(i)) for i in ids)

    def unpack_bits(self, mask: np.ndarray) -> np.ndarray:
        """packed u32[..., n_words] -> u8[..., M] of 0/1."""
        bits = (mask[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
        return bits.reshape(*mask.shape[:-1], self.n_words * 32)[..., : self.M].astype(np.uint8)

    def pack_bits(self, bits: np.ndarray) -> np.ndarray:
        pad = self.n_words * 32 - self.M
        b = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], pad), bits.dtype)], axis=-1
        ).reshape(*bits.shape[:-1], self.n_words, 32)
        return (b.astype(np.uint32) << np.arange(32, dtype=np.uint32)).sum(
            axis=-1, dtype=np.uint32
        )

    # ---- precomputed masks for witness-collapsed guards ------------------

    @functools.cached_property
    def dst_term_any_mask(self) -> np.ndarray:
        """u32[S, T, n_words]: bit m set iff dst[m]=s and term[m]=t.

        Used by the UpdateTerm(s) branch-(a) guard (Raft.tla:178): the
        successor depends only on m.term, so the existential over msgs
        collapses to "any message to s with term t present".
        """
        out = np.zeros((self.S, self.T, self.n_words), np.uint32)
        for s in range(1, self.S + 1):
            for t in range(1, self.T + 1):
                bits = ((self.dst == s) & (self.term == t)).astype(np.uint8)
                out[s - 1, t - 1] = self.pack_bits(bits)
        return out

    @functools.cached_property
    def dst_term_appendreq_mask(self) -> np.ndarray:
        """u32[S, T, n_words]: AppendReq messages to s at term t.

        Guard of UpdateTerm branch (b) (Raft.tla:183-184) and the split-brain
        Assert condition (Raft.tla:185).
        """
        out = np.zeros((self.S, self.T, self.n_words), np.uint32)
        for s in range(1, self.S + 1):
            for t in range(1, self.T + 1):
                bits = (
                    (self.typ == APPEND_REQ) & (self.dst == s) & (self.term == t)
                ).astype(np.uint8)
                out[s - 1, t - 1] = self.pack_bits(bits)
        return out

    @functools.cached_property
    def pair_perm_table(self) -> np.ndarray:
        """int32[P, S*(S-1)]: the (src, dst)-pair digit under each perm.

        pair_perm_table[p, (src-1)*(S-1)+dst_idx] is the pair digit of the
        same message with src/dst remapped through permutation p — the
        tiny table behind the arithmetic message-ID permutation
        (see ``type_offsets``/``type_strides``).
        """
        S = self.S
        perms = self.cfg.server_perms()
        out = np.zeros((len(perms), S * (S - 1)), np.int32)
        for pi, p in enumerate(perms):
            for src in range(1, S + 1):
                for di in range(S - 1):
                    dst = _dst_from_idx(src, di)
                    ns, nd = p[src - 1], p[dst - 1]
                    out[pi, (src - 1) * (S - 1) + di] = (ns - 1) * (S - 1) + _dst_idx(
                        ns, nd
                    )
        return out

    @functools.cached_property
    def perm_table(self) -> np.ndarray:
        """int32[P, M]: message ID under each server permutation.

        perm_table[p, m] = id of message m with src/dst remapped through
        permutation p — the msgs part of TLC's symmetry normalization
        (Raft.tla:21, Raft.cfg:24).
        """
        perms = self.cfg.server_perms()
        out = np.zeros((len(perms), self.M), np.int32)
        ar = np.arange(self.M)
        for pi, p in enumerate(perms):
            pv = np.array((0,) + p, np.int32)  # value remap, 1-based
            ns, nd = pv[self.src], pv[self.dst]
            new_id = np.where(
                self.typ == VOTE_REQ,
                self.encode_votereq(ns, nd, self.term, np.maximum(self.lli, 1), self.llt),
                np.where(
                    self.typ == VOTE_RESP,
                    self.encode_voteresp(ns, nd, self.term),
                    np.where(
                        self.typ == APPEND_REQ,
                        self.encode_appendreq(
                            ns, nd, self.term, np.maximum(self.pli, 1), self.plt,
                            self.entry, np.maximum(self.lc, 1),
                        ),
                        self.encode_appendresp(
                            ns, nd, self.term,
                            np.maximum(self.pli, self.ap_pli_min), self.succ,
                        ),
                    ),
                ),
            )
            out[pi] = new_id
            assert np.array_equal(np.sort(new_id), ar), "perm must be a bijection"
        return out


@functools.lru_cache(maxsize=32)
def get_universe(cfg: RaftConfig) -> MsgUniverse:
    return MsgUniverse(cfg)
