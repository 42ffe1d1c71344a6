"""Model configuration and derived static bounds.

The port's own copy of ``tla_raft_tpu/config.py`` (the port imports
nothing of the JAX package); the two must stay field-for-field equal,
which tests/test_torch_tables.py checks.

The reference binds its constants in ``Raft.cfg`` (Raft.cfg:1-21):
``Servers = {s1, s2, s3}``, ``Vals = {v1, v2}``, ``MaxElection = 3``,
``MaxRestart = 3`` (plus a vestigial ``MaxTerm = 3`` that has no matching
``CONSTANT`` in the spec — terms are actually bounded by ``MaxElection``
because ``BecomeCandidate`` is the only action that mints a new term,
Raft.tla:108-111).

Everything the kernels need to be *static* — tensor shapes, radixes of
the message universe, fan-out slot counts — derives from these four numbers.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

# Role encoding (CONSTANT Follower, Candidate, Leader — Raft.tla:14).
FOLLOWER = 0
CANDIDATE = 1
LEADER = 2

# votedFor sentinel (CONSTANT None — Raft.tla:10). Servers are 1..S.
NONE = 0

# Message type tags (CONSTANT VoteReq, VoteResp, AppendReq, AppendResp —
# Raft.tla:8).
VOTE_REQ = 0
VOTE_RESP = 1
APPEND_REQ = 2
APPEND_RESP = 3

MSG_TYPE_NAMES = {
    VOTE_REQ: "VoteReq",
    VOTE_RESP: "VoteResp",
    APPEND_REQ: "AppendReq",
    APPEND_RESP: "AppendResp",
}

ROLE_NAMES = {FOLLOWER: "Follower", CANDIDATE: "Candidate", LEADER: "Leader"}


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Static model bounds, the analog of the CONSTANTS block of Raft.cfg.

    Attributes:
      n_servers: |Servers| (Raft.cfg:18).
      n_vals: |Vals| (Raft.cfg:21).
      max_election: MaxElection (Raft.cfg:4) — bound on BecomeCandidate.
      max_restart: MaxRestart (Raft.cfg:3) — bound on Restart.
      symmetry: SYMMETRY symmServers present (Raft.cfg:24).
      use_view: VIEW view present (Raft.cfg:26) — fingerprint on the 8-var
        projection, aux vars excluded (Raft.tla:38).
      invariants: names of INVARIANT predicates to check (Raft.cfg:33-34).
      max_term_cfg: the vestigial ``MaxTerm`` value if present (Raft.cfg:2);
        recorded for cfg fidelity, never used.
      mutations: planted semantic bugs to compile in (SURVEY.md §4.4 —
        the reference keeps buggy variants in comments as checker tests).
        Known: "median-bug" — FindMedian's deliberate off-by-one
        (``pos == Len(mlist) \\div 2`` on the descending-sorted list,
        Raft.tla:65-66): commits at one order statistic above the
        majority median, an over-commit the checker must catch.
        "double-vote" — drops ResponseVote's votedFor guard, making the
        in-path split-brain Assert (Raft.tla:185) reachable.
        "legacy-append" — compiles the dead monolithic
        ``FollowerAppendEntry`` (Raft.tla:323-371) in place of the live
        accept/reject pair: rejects carry ``prevLogIndex - 1`` (:364 vs
        :314) and accepts gain the :347-348 send-guard — detected by
        state-count divergence from the live spec.
        "become-follower" — compiles the dead ``BecomeFollower`` family
        (Raft.tla:191-231) in place of ``UpdateTerm``: a Follower keeps
        its votedFor on term adoption and the split-brain Assert is gone
        — detected by state-count divergence.
    """

    n_servers: int = 3
    n_vals: int = 2
    max_election: int = 3
    max_restart: int = 3
    symmetry: bool = True
    use_view: bool = True
    invariants: tuple[str, ...] = ("Inv",)
    max_term_cfg: int | None = None
    mutations: tuple[str, ...] = ()

    # ---- derived static bounds ------------------------------------------

    @property
    def S(self) -> int:
        return self.n_servers

    @property
    def V(self) -> int:
        return self.n_vals

    @property
    def T(self) -> int:
        """Max reachable currentTerm.

        Only ``BecomeCandidate`` increments a term (Raft.tla:111), gated by
        ``electionCount < MaxElection`` (Raft.tla:108); every term found in a
        message was copied from some server's term at send time, so all terms
        are <= MaxElection.
        """
        return self.max_election

    @property
    def L(self) -> int:
        """Max log length including the sentinel entry.

        Every log starts as ``<<[term |-> 0, val |-> None]>>`` (Raft.tla:97)
        and each value in Vals is appended at most once globally — ClientReq
        requires ``valSent[v] = None`` and is the only writer (Raft.tla:236-237).
        """
        return 1 + self.n_vals

    @property
    def majority(self) -> int:
        """MajoritySize == Cardinality(Servers) \\div 2 + 1 (Raft.tla:41)."""
        return self.n_servers // 2 + 1

    @property
    def median_index(self) -> int:
        """0-based index into the ascending-sorted matchIndex row that
        LeaderCanCommit commits at (Raft.tla:406).

        Correct Median (Raft.tla:70-75): the MajoritySize-th smallest.
        Under the planted "median-bug" mutation (descending-list
        ``pos == Len \\div 2`` instead of ``\\div 2 + 1``, Raft.tla:65-66)
        the picked order statistic shifts one higher — e.g. the *maximum*
        matchIndex for 3 servers, committing entries replicated nowhere.
        """
        if "median-bug" in self.mutations:
            return self.majority
        return self.majority - 1

    @property
    def n_perms(self) -> int:
        return math.factorial(self.n_servers) if self.symmetry else 1

    def server_perms(self) -> list[tuple[int, ...]]:
        """All |Servers|! permutations (or just identity when symmetry off).

        Each perm is a tuple p of length S with p[s-1] = image of server s
        (servers are 1-based). This is ``Permutations(Servers)``
        (Raft.tla:21) activated by ``SYMMETRY symmServers`` (Raft.cfg:24).
        """
        servers = tuple(range(1, self.n_servers + 1))
        if not self.symmetry:
            return [servers]
        return [tuple(p) for p in itertools.permutations(servers)]

    def describe(self) -> str:
        return (
            f"S={self.S} V={self.V} MaxElection={self.max_election} "
            f"MaxRestart={self.max_restart} T={self.T} L={self.L} "
            f"majority={self.majority} symmetry={self.symmetry} "
            f"view={self.use_view} invariants={list(self.invariants)}"
        )


# The reference configuration, Raft.cfg as-is.
REFERENCE_CONFIG = RaftConfig(
    n_servers=3,
    n_vals=2,
    max_election=3,
    max_restart=3,
    symmetry=True,
    use_view=True,
    invariants=("Inv",),
    max_term_cfg=3,
)
