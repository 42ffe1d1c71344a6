"""The port's invariant and probe predicates against the reference's, on
the same reachable states (Inv, the six probes, and ``~Name``)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from tla_raft_tpu.engine.invariants import resolve_invariant_kernel as ref_resolve
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, resolve_invariant_kernel
from tla_raft_tpu_torch.ops.successor import GuardTables
from torch_port_corpus import CONFIGS, MUT_ARGS, batches, configs

NAMES = sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]
CORPORA = [(CONFIGS["ref"], ()), (MUT_ARGS, ("median-bug",))]


@pytest.mark.parametrize("args,muts", CORPORA, ids=["ref", "median-bug"])
def test_invariants_match_reference(args, muts):
    rc, pc = configs(args, muts)
    ref_st, port, _fr = batches(args, muts, n=300, tail=300)
    ref_tables = get_kernel(rc, mxu=True).tables
    tables = GuardTables(pc, "cpu")
    seen_false = set()
    for name in NAMES:
        want = np.asarray(ref_resolve(name)(rc, ref_st, ref_tables))
        got = resolve_invariant_kernel(name)(pc, port, tables).numpy()
        assert np.array_equal(got, want), name
        if not got.all():
            seen_false.add(name)
    # the corpus exercises both outcomes of the probes, not just "holds"
    assert {"RaftCanCommt", "ExistLeaderAndCandidate", "~NoSplitVote"} <= seen_false
