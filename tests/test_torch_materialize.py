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
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
from torch_port_corpus import CONFIGS, MUT_ARGS, MUTATIONS, batches, configs

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
