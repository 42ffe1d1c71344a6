"""Kernel K2 (materialize + sorted id insertion): the port's plain twin
against the reference's ``materialize_added`` followed by
``JaxChecker._ids_insert``, on every slot of reachable parents, with and
without a forced ``cap_m`` overflow."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops.msg_universe import get_universe
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand, ids_insert
from torch_port_corpus import CONFIGS, MUT_ARGS, MUTATIONS, batches, configs

from redesign_cases import K2_MERGE_CASES, ids_merge_by_rank, k2_merge_case

CASES = [(CONFIGS[k], ()) for k in CONFIGS] + [(MUT_ARGS, (m,)) for m in MUTATIONS]
IDS = list(CONFIGS) + list(MUTATIONS)


def _ref_ids_insert(uni, ids, added):
    """``JaxChecker._ids_insert`` without building a checker."""
    fake = types.SimpleNamespace(kern=types.SimpleNamespace(uni=uni), id_dtype=jnp.int16)
    return JaxChecker._ids_insert(fake, ids, added)


def _pick_parents(fr, k=4):
    """A handful of parents spread over the corpus, the deepest included."""
    n = fr.voted_for.shape[0]
    return np.unique(np.linspace(0, n - 1, k).astype(np.int64))


def _compare(args, muts, cap_m=None):
    rc, pc = configs(args, muts)
    kern = get_kernel(rc, mxu=True)
    mx = MXUExpand(pc, "cpu")
    ref_st, _port, fr = batches(args, muts, n=150, tail=100)
    rows = _pick_parents(fr)
    if cap_m is not None:  # full lists: every live insert overflows
        fr = fr._replace(msg_ids=fr.msg_ids[:, :cap_m].contiguous())
    K = mx.K
    pidx = torch.from_numpy(np.repeat(rows, K))
    slots = torch.arange(K, dtype=torch.int64).repeat(len(rows))
    child, added, ovf = mx.materialize(fr, pidx, slots)  # CPU: the plain twin
    sub = type(ref_st)(*(jnp.asarray(np.asarray(x)[np.repeat(rows, K)]) for x in ref_st))
    rchild, radded = kern.materialize_added(sub, jnp.asarray(slots.numpy()))
    rids, rovf = _ref_ids_insert(kern.uni, jnp.asarray(fr.msg_ids[pidx].numpy()), radded)
    for f in Frontier._fields[:-1]:
        a, b = getattr(child, f).numpy(), np.asarray(getattr(rchild, f))
        assert np.array_equal(a, b), (f, np.argwhere(a != b)[:5])
    assert np.array_equal(added.numpy(), np.asarray(radded))
    assert np.array_equal(child.msg_ids.numpy(), np.asarray(rids))
    assert np.array_equal(ovf.numpy(), np.asarray(rovf))
    return ovf


@pytest.mark.parametrize("args,muts", CASES, ids=IDS)
def test_materialize_matches_reference_every_slot(args, muts):
    assert not bool(_compare(args, muts).any())


def test_materialize_forced_cap_m_overflow():
    """A width that the parents' lists already fill: the reference and the
    twin agree on the truncated lists and flag the same rows."""
    _ref, _port, fr = batches(CONFIGS["ref"], n=150, tail=100)
    rows = _pick_parents(fr)
    width = int((fr.msg_ids[torch.from_numpy(rows)] >= 0).sum(1).max())
    ovf = _compare(CONFIGS["ref"], (), cap_m=max(width, 1))
    assert bool(ovf.any())


# -- K2's id lists as the card computes them: a merge by rank -----------------------

K2_CASES = [(3, k) for k in K2_MERGE_CASES if k != "s7_int32_high"] + \
    [(7, k) for k in K2_MERGE_CASES]


@pytest.mark.parametrize("S,kind", K2_CASES, ids=[f"s{S}-{k}" for S, k in K2_CASES])
def test_k2_merge_by_rank_model_matches_reference(S, kind):
    """The numpy model of K2's merge by rank (``redesign_cases.
    ids_merge_by_rank``) equals the reference's ``JaxChecker._ids_insert``
    and the port's ``ids_insert`` twin on ``k2_merge_case``'s lists: empty
    lists, full lists (the largest id drops, overflow), sent ids already
    present, two sent ids past the last id, A = 6 ids at and past 2^15 at
    S=7 (int32 ids), and random lists with ids at or past M."""
    pc = RaftConfig(n_servers=S)
    uni = get_universe(pc)
    dt = torch.int32 if uni.M >= 1 << 15 else torch.int16
    A = max(S - 1, 1)
    ids, sent = k2_merge_case(kind, uni.M, 24, A, 7 * S)
    want, want_ovf = ids_merge_by_rank(ids, sent, uni.M)
    fake = types.SimpleNamespace(kern=types.SimpleNamespace(uni=uni),
                                 id_dtype=jnp.int32 if dt == torch.int32 else jnp.int16)
    rids, rovf = JaxChecker._ids_insert(fake, jnp.asarray(ids.astype(np.int32)),
                                        jnp.asarray(sent.astype(np.int32)))
    pids, povf = ids_insert(torch.from_numpy(ids).to(dt), torch.from_numpy(sent).to(torch.int32),
                            uni.M)
    assert np.array_equal(np.asarray(rids).astype(np.int64), want)
    assert np.array_equal(np.asarray(rovf), want_ovf)
    assert np.array_equal(pids.numpy().astype(np.int64), want)
    assert np.array_equal(povf.numpy(), want_ovf)
    if kind == "full_drops_largest":
        assert want_ovf.all() and (want[:, -1] < ids[:, -1]).all()
    if kind == "already_present":
        assert np.array_equal(want, ids) and not want_ovf.any()
    if kind == "s7_int32_high":
        assert (want >= 1 << 15).any()
