"""The plain twins of the message-set conversion kernels (inflate /
deflate) and of the invariant-scan kernel against the reference's
``_ids_to_msgs`` / ``_msgs_to_ids`` / ``_inv_scan_impl``, on reachable
states, including rows past ``cap_m`` (deflate's overflow) and the
scan's row offset and fold."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import numpy as np
import pytest
import torch

from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.engine.invariants import inv_scan_plain
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops.successor import GuardTables
from torch_port_corpus import CONFIGS, MUT_ARGS, batches, configs


def _ref(rc, cap_m=96):
    return JaxChecker(rc, megakernel=False, superstep=1, use_hashstore=True, cap_m=cap_m)


def _mixed(ref_st, port, seed=0):
    """Both packages' batches with every field taken from an independently
    chosen row, and in one row of eight server 1 made a leader whose log
    is shorter than server 2's commit: reachable values in combinations
    that break Inv (reachable states never do outside a mutation's
    counterexample)."""
    g = np.random.default_rng(seed)
    n = port.role.shape[0]
    picks = [g.integers(0, n, n) for _ in port]
    arrs = {f: np.asarray(x)[i].copy() for f, x, i in zip(port._fields, ref_st, picks)}
    rows = g.random(n) < 0.125
    L = arrs["log_term"].shape[-1]
    arrs["role"][rows, 0] = 2  # LEADER
    arrs["log_len"][rows, 0] = 1
    arrs["current_term"][rows, 1] = 0
    arrs["commit_index"][rows, 1] = L
    ref = type(ref_st)(**arrs)
    arrs_i32 = dict(arrs, msgs=arrs["msgs"].view(np.int32))  # the port keeps words as int32
    mine = type(port)(**{f: torch.from_numpy(a) for f, a in arrs_i32.items()})
    return ref, mine


@pytest.mark.parametrize("cap_m", [96, 6])
def test_inflate_deflate_match_reference(cap_m):
    """ids -> words -> ids round trip on both sides; at cap_m = 6 many
    deep states hold more ids than fit (their rows overflow)."""
    rc, pc = configs(CONFIGS["ref"])
    ref_st, port, fr = batches(CONFIGS["ref"], n=300, tail=300)
    ref = _ref(rc, cap_m)
    words = bfs.ids_to_msgs_plain(fr.msg_ids, ref.uni_words)
    want = np.asarray(ref._ids_to_msgs(fr.msg_ids.numpy())).view(np.int32)
    assert np.array_equal(words.numpy(), want)
    assert np.array_equal(words.numpy(), port.msgs.numpy())
    ids, ovf = bfs.msgs_to_ids_plain(port.msgs, ref.kern.uni.M, ref.cap_m, torch.int16)
    r_ids, r_ovf = ref._msgs_to_ids(np.asarray(ref_st.msgs))
    assert np.array_equal(ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(ovf.numpy(), np.asarray(r_ovf))
    assert bool(ovf.any()) == (cap_m == 6)


@pytest.mark.parametrize("args,muts,invs", [
    (CONFIGS["ref"], (), ("Inv",)),
    (MUT_ARGS, ("median-bug",), ("Inv",)),
    (CONFIGS["ref"], (), ("~NoAllCommit", "~ExistLeaderAndCandidate")),
], ids=["ref-Inv", "median-bug-Inv", "ref-probes"])
def test_inv_scan_matches_reference(args, muts, invs):
    """The first bad row of each prefix of the corpus (n_valid masks the
    rest), as the reference's scan finds it."""
    rc, pc = configs(args, muts)
    rc = dataclasses.replace(rc, invariants=invs)
    pc = dataclasses.replace(pc, invariants=invs)
    ref_st, port = _mixed(*batches(args, muts, n=300, tail=300)[:2])
    ref = _ref(rc)
    tables = GuardTables(pc, "cpu")
    n = port.role.shape[0]
    found = set()
    for n_valid in (1, n // 3, n):
        want = int(ref._inv_scan_impl(ref_st, n_valid))
        sub = type(port)(*(x[:n_valid] for x in port))
        got = int(inv_scan_plain(pc, sub, invs, tables))
        assert got == want, n_valid
        found.add(got >= 0)
    assert True in found  # the corpus holds a bad row for each case


def test_inv_scan_offset_and_fold():
    """The checker's scan adds the row offset, and a fold keeps the
    smaller bad row (-1 = none) of two slices."""
    chk = TorchChecker(configs(MUT_ARGS, ("median-bug",))[1], device="cpu")
    _ref_st, port = _mixed(*batches(MUT_ARGS, ("median-bug",), n=300, tail=300)[:2])
    ids, _ovf = bfs.msgs_to_ids_plain(port.msgs, chk.uni.M, 96, torch.int16)
    fr = Frontier(msg_ids=ids, **{f: getattr(port, f) for f in Frontier._fields[:-1]})
    first = int(chk.inv_scan(fr))
    assert first >= 0
    head = Frontier(*(x[:first] for x in fr))
    tail = Frontier(*(x[first:] for x in fr))
    assert int(chk.inv_scan(head)) == -1
    assert int(chk.inv_scan(tail, offset=first)) == first
    none = chk.inv_scan(head)
    assert int(chk.inv_scan(tail, offset=first, into=none)) == first
    assert int(chk.inv_scan(head, into=chk.inv_scan(tail, offset=first))) == first
