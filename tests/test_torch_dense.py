"""The kernels of the reference's cross-check paths, plain twins against
the reference on the CPU, exactly (integers and u64 fingerprints):

* ``dense_expand`` (B18): ``DenseExpand.__call__`` with fingerprints
  (``SuccessorKernel.expand``) and guards-only (``_expand_guards``), on
  reachable states at S = 3 (the Raft.cfg constants and (3,1,1,1)), S = 2,
  a small S = 5 batch and the become-follower / legacy-append mutations,
  which change the dense terms; with the message hash, ``delta_hash`` and
  ``msg_coef_eff`` it uses;
* ``chunk_compact`` (B3 ``_chunk_compact``), with an overflow and with
  ``cap_x`` past the chunk's lanes;
* ``legacy_materialize`` (B20 ``materialize_legacy`` /
  ``materialize_added_legacy``) on every slot of sampled parents, and
  against the port's ``ScalarActions``.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.engine.bfs import _chunk_compact
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch.engine.bfs import chunk_compact, chunk_compact_plain
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops.dense_expand import DenseExpand
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.ops.msg_universe import get_universe
from tla_raft_tpu_torch.ops.successor import ScalarActions, get_layout, materialize_legacy_plain
from torch_port_corpus import CONFIGS, MUT_ARGS, batches, configs, u64

DENSE_CASES = {
    "ref": (CONFIGS["ref"], (), 60, 40),
    "s3v1": (CONFIGS["s3v1"], (), 120, 60),
    "s2": (CONFIGS["s2"], (), 60, 0),
    "become-follower": (MUT_ARGS, ("become-follower",), 60, 40),
    "legacy-append": (MUT_ARGS, ("legacy-append",), 60, 40),
    "s5": ((5, 1, 1, 0), (), 12, 0),
}


def _dense(key):
    args, muts, n, tail = DENSE_CASES[key]
    rc, pc = configs(args, muts)
    ref, port, _fr = batches(args, muts, n=n, tail=tail)
    fpr = Fingerprinter(pc, device="cpu")
    return rc, pc, ref, port, fpr, DenseExpand(pc, get_universe(pc), "cpu", fpr=fpr)


SLOW_DENSE = ("s3v1", "s5")


@pytest.mark.parametrize("key", [k if k not in SLOW_DENSE else
                                 pytest.param(k, marks=pytest.mark.slow) for k in DENSE_CASES])
def test_dense_expand_twin_matches_reference(key):
    """valid, mult, abort and (on every lane) fp_view / fp_full of the
    twin equal ``SuccessorKernel.expand``; the engine's form keeps the
    valid lanes' fingerprints and SENT elsewhere; guards-only equals
    ``_expand_guards``.  The S = 5 and (3,1,1,1) rows are slow (a jit of
    the reference's expand each); their fast siblings are the Raft.cfg
    and S = 2 rows, and tests/test_torch_audit.py's whole canon="expand"
    runs at (3,1,1,1)."""
    rc, _pc, ref, port, fpr, dx = _dense(key)
    kern = get_kernel(rc, mxu=False)
    rmsum = kern.fpr.msg_hash(ref.msgs)
    msum = fpr.msg_hash_plain(port.msgs)
    assert np.array_equal(msum.numpy().astype(np.uint32), np.asarray(rmsum))
    e = kern.expand(ref, rmsum)
    valid, mult, fv, ff, abort = dx(port, msum)
    rv = np.asarray(e.valid)
    assert rv.any()
    assert np.array_equal(valid.numpy(), rv)
    assert np.array_equal(np.where(rv, mult.numpy(), 0), np.asarray(e.mult))
    assert np.array_equal(abort.numpy(), np.asarray(e.abort))
    assert np.array_equal(u64(fv), np.asarray(e.fp_view))
    assert np.array_equal(u64(ff), np.asarray(e.fp_full))
    v2, m2, fv2, ff2, a2 = dx.expand(port)  # CPU: the twin, the engine's form
    sent = np.uint64(2**64 - 1)
    assert np.array_equal(m2.numpy(), np.asarray(e.mult))
    assert np.array_equal(u64(fv2), np.where(rv, np.asarray(e.fp_view), sent))
    assert np.array_equal(u64(ff2), np.where(rv, np.asarray(e.fp_full), sent))
    for a, b in zip(dx.guards(port), kern._expand_guards(ref)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.slow
def test_dense_expand_covers_the_abort():
    """The double-vote mutation reaches the split-brain Assert: rows that
    abort exist, and the twin flags the reference's.  Slow (its own jit);
    the fast sibling is test_torch_audit.py's double-vote run, whose
    abort stop and trace equal the reference's."""
    rc, _pc, ref, port, fpr, dx = _dense_mut("double-vote", n=400)
    e = get_kernel(rc, mxu=False)._expand_guards(ref)
    assert np.asarray(e[2]).any()
    _v, _m, abort = dx.guards(port)
    assert np.array_equal(abort.numpy(), np.asarray(e[2]))


def _dense_mut(mut, n=200):
    rc, pc = configs(MUT_ARGS, (mut,))
    ref, port, _fr = batches(MUT_ARGS, (mut,), n=n, tail=200)
    fpr = Fingerprinter(pc, device="cpu")
    return rc, pc, ref, port, fpr, DenseExpand(pc, get_universe(pc), "cpu", fpr=fpr)


@pytest.mark.parametrize("vals,ok", [(2, True), (18, True), (19, False)])
def test_dense_expand_refuses_configs_past_its_lane_lists(vals, ok):
    """The CUDA wrapper refuses a config whose FollowerAcceptEntry
    truncation (2L + 2 feature deltas, L = 1 + V) would overflow the
    kernel's per-lane delta list, instead of dropping deltas."""
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig

    cfg = RaftConfig(3, vals, 1, 1)
    if ok:
        kernels.check_dense_cfg(cfg)
    else:
        with pytest.raises(ValueError, match="feature deltas"):
            kernels.check_dense_cfg(cfg)
    kernels.check_dense_cfg(RaftConfig(8, 2, 1, 1))


def test_delta_hash_matches_reference():
    """``delta_hash`` (live and dead ids, -1 pads), ``msg_coef_eff`` and
    ``child_fingerprints``."""
    rc, pc = configs(CONFIGS["ref"])
    rf = get_kernel(rc, mxu=False).fpr
    fpr = Fingerprinter(pc, device="cpu")
    g = np.random.default_rng(5)
    ids = g.integers(-1, get_universe(pc).M, size=(64, 2)).astype(np.int32)
    live = (g.random((64, 2)) < 0.7) & (ids >= 0)
    got = fpr.delta_hash(torch.from_numpy(ids), torch.from_numpy(live)).numpy()
    want = np.asarray(rf.delta_hash(jnp.asarray(ids), jnp.asarray(live)))
    assert np.array_equal(got.astype(np.uint32), want)
    coef = fpr.msg_coef_eff(torch.from_numpy(ids.clip(0))).numpy()
    assert np.array_equal(coef.astype(np.uint32), np.asarray(rf.msg_coef_eff(jnp.asarray(ids.clip(0)))))
    # child_fingerprints: reachable states' features, their message hash and the ids
    ref, port, _fr = batches(CONFIGS["ref"], n=64)
    feats = fpr.spec.features(port)
    msum = fpr.msg_hash_plain(port.msgs)
    cv, cf = fpr.child_fingerprints(feats, msum, torch.from_numpy(ids), torch.from_numpy(live))
    rv, rff = rf.child_fingerprints(rf.spec.features(ref), rf.msg_hash(ref.msgs),
                                    jnp.asarray(ids), jnp.asarray(live))
    assert np.array_equal(u64(cv), np.asarray(rv)) and np.array_equal(u64(cf), np.asarray(rff))


@pytest.mark.parametrize("cap", [8, 64, 5000], ids=["overflow", "fits", "cap-past-lanes"])
def test_chunk_compact_twin_matches_reference(cap):
    g = np.random.default_rng(cap)
    C = 1200
    live = g.random(C) < 0.03
    fv = np.where(live, g.integers(0, 2**63, C, dtype=np.int64), -1).astype(np.int64)
    ff = np.where(live, g.integers(0, 2**63, C, dtype=np.int64), -1).astype(np.int64)
    base = 7 * 696
    pay = base + np.arange(C, dtype=np.int64)
    # the reference's top_k takes at most C lanes: past them the port pads
    rcap = min(cap, C)
    rv, rf, rp, rovf = _chunk_compact(jnp.asarray(fv.view(np.uint64)), jnp.asarray(ff.view(np.uint64)),
                                      jnp.asarray(pay), rcap)
    cv, cf, cp, ovf = chunk_compact(torch.from_numpy(fv), torch.from_numpy(ff), cap, base)
    assert np.array_equal(u64(cv)[:rcap], np.asarray(rv))
    assert np.array_equal(u64(cf)[:rcap], np.asarray(rf))
    assert np.array_equal(cp.numpy()[:rcap], np.asarray(rp))
    assert (cv[rcap:] == -1).all() and (cf[rcap:] == -1).all() and (cp[rcap:] == -1).all()
    assert bool(ovf) == bool(rovf) == (int(live.sum()) > cap)
    assert int(chunk_compact_plain(torch.from_numpy(fv), torch.from_numpy(ff), cap)[3]) == live.sum()


LEGACY_CASES = {
    "ref": (CONFIGS["ref"], ()),
    "s2": (CONFIGS["s2"], ()),
    "become-follower": (MUT_ARGS, ("become-follower",)),
    "legacy-append": (MUT_ARGS, ("legacy-append",)),
    "median-bug": (MUT_ARGS, ("median-bug",)),
}


@pytest.mark.parametrize("key", list(LEGACY_CASES))
def test_legacy_materialize_twin_matches_reference(key):
    """Every slot of sampled parents: the children's fields, the sent ids
    and the id lists equal ``materialize_added_legacy`` (+ the reference's
    id insertion); the packed children equal ``materialize_legacy``."""
    from test_torch_materialize import _ref_ids_insert

    args, muts = LEGACY_CASES[key]
    rc, pc = configs(args, muts)
    kern = get_kernel(rc, mxu=False)
    ref, _port, fr = batches(args, muts, n=150, tail=100)
    K = get_layout(pc).K
    rows = np.unique(np.linspace(0, fr.voted_for.shape[0] - 1, 5).astype(np.int64))
    pidx = torch.from_numpy(np.repeat(rows, K))
    slots = torch.arange(K, dtype=torch.int64).repeat(len(rows))
    child, added, ovf = materialize_legacy_plain(pc, fr, pidx, slots)
    sub = type(ref)(*(jnp.asarray(np.asarray(x)[np.repeat(rows, K)]) for x in ref))
    rchild, radded = kern.materialize_added_legacy(sub, jnp.asarray(slots.numpy()))
    rpacked = kern.materialize_legacy(sub, jnp.asarray(slots.numpy()))
    for f in Frontier._fields[:-1]:
        assert np.array_equal(getattr(child, f).numpy(), np.asarray(getattr(rchild, f))), f
        assert np.array_equal(getattr(child, f).numpy(), np.asarray(getattr(rpacked, f))), f
    assert np.array_equal(added.numpy(), np.asarray(radded))
    rids, rovf = _ref_ids_insert(kern.uni, jnp.asarray(fr.msg_ids[pidx].numpy()), radded)
    assert np.array_equal(child.msg_ids.numpy(), np.asarray(rids))
    assert np.array_equal(ovf.numpy(), np.asarray(rovf))


def test_legacy_materialize_twin_matches_scalar_actions():
    """The host transcription (``ScalarActions.apply``) on every slot of a
    few parents, the deepest included."""
    args = CONFIGS["ref"]
    _rc, pc = configs(args)
    _ref, port, fr = batches(args, n=150, tail=100)
    sa = ScalarActions(pc)
    K = get_layout(pc).K
    uni = get_universe(pc)
    for row in (0, fr.voted_for.shape[0] // 2, fr.voted_for.shape[0] - 1):
        child, added, _ovf = materialize_legacy_plain(
            pc, fr, torch.full((K,), row, dtype=torch.int64), torch.arange(K))
        st = {f: getattr(port, f)[row].numpy() for f in Frontier._fields[:-1]}
        for slot in range(K):
            want, sent = sa.apply(st, slot)
            for f in want:
                assert np.array_equal(getattr(child, f)[slot].numpy(), np.asarray(want[f])), \
                    (row, slot, f)
            assert added[slot].tolist() == sent
            ids = set(int(x) for x in fr.msg_ids[row].tolist() if x >= 0)
            ids |= {x for x in sent if 0 <= x < uni.M}
            assert [int(x) for x in child.msg_ids[slot].tolist() if x >= 0] == sorted(ids)
