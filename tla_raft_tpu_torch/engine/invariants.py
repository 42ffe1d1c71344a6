"""Batched invariant and probe predicates (Raft.tla:432-507).

The port of ``tla_raft_tpu/engine/invariants.py``.  Every predicate maps a
RaftState batch to bool[N] (True = holds).  ``Inv`` (Raft.tla:502) binds
LeaderHasAllCommittedEntries (Raft.tla:491-499), the invariant the
reference configuration checks; the rest are the reference's debug
probes, meant to be run negated (``~Name``) to prove reachability.
Only ``NoAllCommit`` reads the message set (``NEEDS_MSGS``).

These are the plain twins of the invariant kernel (csrc/invariants.cu),
which ``TorchChecker.inv_scan`` launches on the card; ``inv_scan_plain``
is the twin of the whole scan.
"""

from __future__ import annotations

import torch

from ..config import CANDIDATE, FOLLOWER, LEADER, RaftConfig

I64 = torch.int64


def leader_has_all_committed_entries(cfg: RaftConfig, st, tables=None):
    """Either no Leader exists, or some Leader l is such that no other
    server p with currentTerm[p] <= currentTerm[l] commits past l's log
    or commits an entry differing from l's (the spec's ∃ over leaders)."""
    S, L = cfg.S, cfg.L
    dvc = st.role.device
    ct = st.current_term.to(I64)
    ci = st.commit_index.to(I64)
    ll = st.log_len.to(I64)
    is_leader = st.role == LEADER
    not_self = ~torch.eye(S, dtype=torch.bool, device=dvc)[None]
    applies = not_self & (ct[:, None, :] <= ct[:, :, None])  # [N, l, p]
    over = ci[:, None, :] > ll[:, :, None]
    mism = (st.log_term[:, None, :, :] != st.log_term[:, :, None, :]) | (
        st.log_val[:, None, :, :] != st.log_val[:, :, None, :]
    )
    in_prefix = torch.arange(L, device=dvc)[None, None, None, :] < ci[:, None, :, None]
    differs = (mism & in_prefix).any(-1)
    bad = applies & (over | differs)
    ok_l = is_leader & ~bad.any(-1)
    return ~is_leader.any(-1) | ok_l.any(-1)


def raft_can_commt(cfg, st, tables=None):
    """RaftCanCommt [sic] — Raft.tla:434."""
    return (st.commit_index.to(I64) > 1).any(-1)


def follower_can_commit(cfg, st, tables=None):
    """FollowerCanCommit — Raft.tla:436-439."""
    return ((st.role == FOLLOWER) & (st.commit_index.to(I64) > 1)).any(-1)


def commit_all(cfg, st, tables=None):
    """CommitAll — Raft.tla:442 (literal constant 3)."""
    return (st.commit_index.to(I64) == 3).all(-1)


def no_split_vote(cfg, st, tables=None):
    """NoSplitVote — Raft.tla:444-449: no two Leaders share a term."""
    S = cfg.S
    lead = st.role == LEADER
    ct = st.current_term.to(I64)
    pair = (
        lead[:, :, None]
        & lead[:, None, :]
        & (ct[:, :, None] == ct[:, None, :])
        & ~torch.eye(S, dtype=torch.bool, device=ct.device)[None]
    )
    return ~pair.any(-1).any(-1)


def exist_leader_and_candidate(cfg, st, tables=None):
    """ExistLeaderAndCandidate — Raft.tla:483-487."""
    return (st.role == LEADER).any(-1) & (st.role == CANDIDATE).any(-1)


def _bit(msgs: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    word = torch.gather(msgs, 1, (mid >> 5)[:, None])[:, 0]
    return ((word >> (mid & 31).to(torch.int32)) & 1).to(torch.bool)


def no_all_commit(cfg, st, tables):
    """NoAllCommit — Raft.tla:451-481: a specific negative-scenario probe
    over roles, commit/match indexes and three message existentials."""
    S, T = cfg.S, cfg.T
    uni = tables.uni
    ct = st.current_term.to(I64)
    ci = st.commit_index.to(I64)
    mi = st.match_index.to(I64)
    role = st.role
    N = role.shape[0]
    hold = torch.zeros((N,), dtype=torch.bool, device=role.device)
    for s1 in range(S):
        for s2 in range(S):
            if s2 == s1:
                continue
            for s3 in range(S):
                if s3 == s2 or s1 == s3:
                    continue
                base = (
                    (role[:, s1] == LEADER)
                    & (role[:, s2] == FOLLOWER)
                    & (role[:, s3] == FOLLOWER)
                    & (ct[:, s1] == ct[:, s3])
                    & (ci[:, s1] == 2)
                    & (ci[:, s2] == 2)
                    & (ci[:, s3] == 1)
                    & (mi[:, s1, s2] == 2)
                    & (mi[:, s1, s3] == 2)
                )
                t3 = (ct[:, s3] - 1).clamp(0, T - 1)
                m1_mask = tables.aq_block[s1, s3][t3, 0]  # [N, W]
                m1 = ((st.msgs & m1_mask) != 0).any(-1) & (ct[:, s3] >= 1)
                mid = uni.encode_appendresp(s3 + 1, s1 + 1, ct[:, s3].clamp(1, T), 1, 1)
                m2 = _bit(st.msgs, mid)
                if cfg.L >= 2:
                    m3_mask = tables.aq_block[s1, s3, 0, 1]
                    for t in range(1, T):
                        m3_mask = m3_mask | tables.aq_block[s1, s3, t, 1]
                    m3 = ((st.msgs & m3_mask) != 0).any(-1)
                else:
                    m3 = torch.zeros((N,), dtype=torch.bool, device=role.device)
                hold = hold | (base & m1 & m2 & m3)
    return hold


INVARIANT_KERNELS = {
    "Inv": leader_has_all_committed_entries,
    "LeaderHasAllCommittedEntries": leader_has_all_committed_entries,
    "RaftCanCommt": raft_can_commt,
    "FollowerCanCommit": follower_can_commit,
    "CommitAll": commit_all,
    "NoSplitVote": no_split_vote,
    "NoAllCommit": no_all_commit,
    "ExistLeaderAndCandidate": exist_leader_and_candidate,
}
NEEDS_MSGS = {"NoAllCommit"}


def resolve_invariant_kernel(name: str):
    """Resolve an invariant name; a leading ``~`` negates (probe workflow)."""
    if name.startswith("~"):
        inner = INVARIANT_KERNELS[name[1:]]
        return lambda cfg, st, tables: ~inner(cfg, st, tables)
    fn = INVARIANT_KERNELS[name]
    return lambda cfg, st, tables: fn(cfg, st, tables)


def needs_msgs(name: str) -> bool:
    return name.lstrip("~") in NEEDS_MSGS


def inv_scan_plain(cfg: RaftConfig, st, names, tables, offset: int = 0) -> torch.Tensor:
    """First row (+ ``offset``) of ``st`` violating one of the invariants
    ``names``, or -1 (a 0-d int64).  ``st`` carries ``msgs`` when a name
    reads the message set."""
    n = st.role.shape[0]
    bad = torch.zeros((n,), dtype=torch.bool, device=st.role.device)
    for name in names:
        bad = bad | ~resolve_invariant_kernel(name)(cfg, st, tables)
    idx = torch.argmax(bad.to(torch.int32)).to(I64) + offset
    return torch.where(bad.any(), idx, torch.full_like(idx, -1))
