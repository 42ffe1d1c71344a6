"""Shared inputs of the tests/test_torch_*.py parity tests: reachable
states from the reference oracle's BFS, encoded once as numpy arrays and
handed to both packages."""

import functools

import numpy as np
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.models.raft import from_oracle as ref_from_oracle
from tla_raft_tpu.oracle.explicit import collect_reachable
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import msgs_to_ids
from tla_raft_tpu_torch.models.raft import Frontier, from_oracle
from tla_raft_tpu_torch.ops.msg_universe import get_universe

CONFIGS = {
    "s2": (2, 1, 1, 1),
    "s3v1": (3, 1, 1, 1),
    "ref": (3, 2, 3, 3),
}
MUTATIONS = ("median-bug", "double-vote", "legacy-append", "become-follower")
MUT_ARGS = (3, 1, 2, 1)


def configs(args, muts=()):
    return RefConfig(*args, mutations=tuple(muts)), RaftConfig(*args, mutations=tuple(muts))


@functools.lru_cache(maxsize=None)
def states(args, muts=(), n=400, tail=0):
    """The first ``n`` reachable states in BFS order, then (``tail``) the
    last ``tail`` of a walk ``4 * n`` long: deeper states with more
    messages, leaders with logs and commits."""
    rc, _ = configs(args, muts)
    head = collect_reachable(rc, n)
    if tail:
        head = head + collect_reachable(rc, 4 * n)[-tail:]
    return head


def batches(args, muts=(), n=400, tail=0, cap_m=96):
    """(reference RaftState, port RaftState, port Frontier) of one corpus."""
    rc, pc = configs(args, muts)
    sts = states(args, tuple(muts), n, tail)
    port = from_oracle(pc, sts, "cpu")
    ids, ovf = msgs_to_ids(port.msgs, get_universe(pc).M, cap_m, torch.int16)
    assert not bool(ovf.any())
    fr = Frontier(msg_ids=ids, **{f: getattr(port, f) for f in Frontier._fields[:-1]})
    return ref_from_oracle(rc, sts), port, fr


def u64(t) -> np.ndarray:
    """A port int64 tensor of u64 bits -> numpy uint64."""
    return t.cpu().numpy().view(np.uint64)
