"""Tensor encoding of the Raft checker state, in PyTorch.

The port of ``tla_raft_tpu/models/raft.py`` (and of ``Frontier`` /
``_CORE_FIELDS`` from ``tla_raft_tpu/engine/bfs.py``).  The 12 spec
variables are a NamedTuple of tensors with one leading batch dimension:
per-server data is uint8, and the message set is a packed bitmask over
the enumerated universe (ops/msg_universe.py), kept as int32 words that
hold the u32 bit patterns.  ``Frontier`` is the same state with the
bitmask replaced by the ascending, -1-padded list of the state's message
ids (``msg_ids``: int16 while the universe has fewer than 2^15 ids, int32
past it, as the reference's ``id_dtype``; ``id_dtype`` below).

Canonical-form invariants every kernel keeps: log slots at positions
>= log_len are zero, and bits past the universe in the last word are
zero, so equal states are equal tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FOLLOWER, RaftConfig
from ..device import resolve_device
from ..ops.msg_universe import get_universe


class RaftState(NamedTuple):
    """Batched checker state; every field has leading dim N."""

    voted_for: torch.Tensor  # u8[N, S], 0 = None
    current_term: torch.Tensor  # u8[N, S]
    role: torch.Tensor  # u8[N, S]
    log_term: torch.Tensor  # u8[N, S, L]
    log_val: torch.Tensor  # u8[N, S, L]
    log_len: torch.Tensor  # u8[N, S] in 1..L
    match_index: torch.Tensor  # u8[N, S, S] in 1..L
    next_index: torch.Tensor  # u8[N, S, S] in 2..L+1
    commit_index: torch.Tensor  # u8[N, S] in 1..L
    election_count: torch.Tensor  # u8[N]
    restart_count: torch.Tensor  # u8[N]
    pending: torch.Tensor  # u8[N, S, S] 0/1
    val_sent: torch.Tensor  # u8[N, V] 0 = None, 1 = FALSE
    msgs: torch.Tensor  # i32[N, n_words]: packed u32 bitmask words


class Frontier(NamedTuple):
    """Compact frontier: RaftState minus ``msgs``, plus sparse ids.

    ``msg_ids``: ascending message ids, -1 padded, width ``cap_m``."""

    voted_for: torch.Tensor
    current_term: torch.Tensor
    role: torch.Tensor
    log_term: torch.Tensor
    log_val: torch.Tensor
    log_len: torch.Tensor
    match_index: torch.Tensor
    next_index: torch.Tensor
    commit_index: torch.Tensor
    election_count: torch.Tensor
    restart_count: torch.Tensor
    pending: torch.Tensor
    val_sent: torch.Tensor
    msg_ids: torch.Tensor


_CORE_FIELDS = [f for f in RaftState._fields if f != "msgs"]


class OState(NamedTuple):
    """One full checker state as Python values: the field layout of the
    reference oracle's ``OState`` (a NamedTuple, so the two compare
    equal field for field)."""

    voted_for: tuple
    current_term: tuple
    role: tuple
    logs: tuple
    match_index: tuple
    next_index: tuple
    commit_index: tuple
    msgs: frozenset
    election_count: int
    restart_count: int
    pending_response: tuple
    val_sent: tuple


def id_dtype(cfg: RaftConfig) -> torch.dtype:
    """The message-id width of a config's frontiers (engine/bfs.py:547 of
    the reference): int16 while M < 2^15 (S <= 5 at the Raft.cfg bounds),
    int32 past it (S = 7: M = 33,768)."""
    return torch.int16 if get_universe(cfg).M < (1 << 15) else torch.int32


def core_of(st) -> dict:
    """The 13 core fields of a RaftState or Frontier, by name."""
    return {f: getattr(st, f) for f in _CORE_FIELDS}


def init_batch(cfg: RaftConfig, n: int = 1, device=None) -> RaftState:
    """The single initial state (Init — Raft.tla:93-105), tiled n times."""
    device = resolve_device(device)
    uni = get_universe(cfg)
    S, L, V = cfg.S, cfg.L, cfg.V
    u8 = dict(dtype=torch.uint8, device=device)

    def z(*shape):
        return torch.zeros((n, *shape), **u8)

    return RaftState(
        voted_for=z(S),
        current_term=z(S),
        role=torch.full((n, S), FOLLOWER, **u8),
        log_term=z(S, L),  # sentinel entry term 0 at slot 0 (Raft.tla:97)
        log_val=z(S, L),
        log_len=torch.ones((n, S), **u8),
        match_index=torch.ones((n, S, S), **u8),
        next_index=torch.full((n, S, S), 2, **u8),
        commit_index=torch.ones((n, S), **u8),
        election_count=z(),
        restart_count=z(),
        pending=z(S, S),
        val_sent=z(V),
        msgs=torch.zeros((n, uni.n_words), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Oracle bridge (host side: tests and trace printing)
# ---------------------------------------------------------------------------


def encode_np(cfg: RaftConfig, states) -> dict:
    """Encode a list of OState-shaped states as a dict of numpy arrays
    (``msgs`` as the packed u32 bitmask)."""
    uni = get_universe(cfg)
    S, L, V = cfg.S, cfg.L, cfg.V
    n = len(states)
    a = {
        "voted_for": np.zeros((n, S), np.uint8),
        "current_term": np.zeros((n, S), np.uint8),
        "role": np.zeros((n, S), np.uint8),
        "log_term": np.zeros((n, S, L), np.uint8),
        "log_val": np.zeros((n, S, L), np.uint8),
        "log_len": np.zeros((n, S), np.uint8),
        "match_index": np.zeros((n, S, S), np.uint8),
        "next_index": np.zeros((n, S, S), np.uint8),
        "commit_index": np.zeros((n, S), np.uint8),
        "election_count": np.zeros((n,), np.uint8),
        "restart_count": np.zeros((n,), np.uint8),
        "pending": np.zeros((n, S, S), np.uint8),
        "val_sent": np.zeros((n, V), np.uint8),
        "msgs": np.zeros((n, uni.n_words), np.uint32),
    }
    for i, st in enumerate(states):
        a["voted_for"][i] = st.voted_for
        a["current_term"][i] = st.current_term
        a["role"][i] = st.role
        for s in range(S):
            log = st.logs[s]
            a["log_len"][i, s] = len(log)
            for j, (t, v) in enumerate(log):
                a["log_term"][i, s, j] = t
                a["log_val"][i, s, j] = v
        a["match_index"][i] = st.match_index
        a["next_index"][i] = st.next_index
        a["commit_index"][i] = st.commit_index
        a["election_count"][i] = st.election_count
        a["restart_count"][i] = st.restart_count
        a["pending"][i] = st.pending_response
        a["val_sent"][i] = st.val_sent
        a["msgs"][i] = uni.msgs_to_mask(st.msgs)
    return a


def state_from_np(arrs: dict, device=None) -> RaftState:
    """A dict of numpy arrays (``encode_np`` layout) -> RaftState."""
    device = resolve_device(device)
    f = {k: torch.from_numpy(np.ascontiguousarray(arrs[k])).to(device)
         for k in _CORE_FIELDS}
    msgs = np.ascontiguousarray(np.asarray(arrs["msgs"], np.uint32).view(np.int32))
    return RaftState(msgs=torch.from_numpy(msgs).to(device), **f)


def from_oracle(cfg: RaftConfig, states, device=None) -> RaftState:
    """Encode a list of OState-shaped states as a batched RaftState."""
    return state_from_np(encode_np(cfg, states), device)


def state_to_np(st: RaftState) -> dict:
    out = {f: getattr(st, f).cpu().numpy() for f in _CORE_FIELDS}
    out["msgs"] = st.msgs.cpu().numpy().view(np.uint32)
    return out


def to_oracle(cfg: RaftConfig, state: RaftState) -> list:
    """Decode a batched RaftState back to OStates."""
    uni = get_universe(cfg)
    S = cfg.S
    sv = state_to_np(state)
    out = []
    for i in range(sv["voted_for"].shape[0]):
        logs = []
        for s in range(S):
            ln = int(sv["log_len"][i, s])
            logs.append(
                tuple(
                    (int(sv["log_term"][i, s, j]), int(sv["log_val"][i, s, j]))
                    for j in range(ln)
                )
            )
        out.append(
            OState(
                voted_for=tuple(int(x) for x in sv["voted_for"][i]),
                current_term=tuple(int(x) for x in sv["current_term"][i]),
                role=tuple(int(x) for x in sv["role"][i]),
                logs=tuple(logs),
                match_index=tuple(tuple(int(x) for x in r) for r in sv["match_index"][i]),
                next_index=tuple(tuple(int(x) for x in r) for r in sv["next_index"][i]),
                commit_index=tuple(int(x) for x in sv["commit_index"][i]),
                msgs=uni.mask_to_msgs(sv["msgs"][i]),
                election_count=int(sv["election_count"][i]),
                restart_count=int(sv["restart_count"][i]),
                pending_response=tuple(tuple(int(x) for x in r) for r in sv["pending"][i]),
                val_sent=tuple(int(x) for x in sv["val_sent"][i]),
            )
        )
    return out
