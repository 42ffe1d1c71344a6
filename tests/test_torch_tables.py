"""The port's constant tables equal the reference's, bit for bit: the
message universe, the slot layout, the fingerprint plane tables and the
guard/materialize tables (MXUTables), for small and reference constants
and under each planted mutation; plus the carry.py round trip."""

import dataclasses

import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.ops.msg_universe import MsgUniverse as RefUniverse
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.ops.msg_universe import MsgUniverse
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand

MUTATIONS = ("median-bug", "double-vote", "legacy-append", "become-follower")
CASES = [((2, 1, 1, 1), ()), ((3, 1, 1, 1), ()), ((3, 2, 3, 3), ())] + [
    ((3, 1, 1, 1), (m,)) for m in MUTATIONS
]
IDS = ["s2", "s3v1", "ref"] + [f"s3v1-{m}" for m in MUTATIONS]


def _cfgs(args, muts):
    return RefConfig(*args, mutations=muts), RaftConfig(*args, mutations=muts)


def test_config_fields_match():
    ref, port = RefConfig(), RaftConfig()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for name in ("S", "V", "T", "L", "majority", "median_index", "n_perms"):
        assert getattr(ref, name) == getattr(port, name), name
    assert ref.server_perms() == port.server_perms()


@pytest.mark.parametrize("args,muts", CASES, ids=IDS)
def test_universe_matches(args, muts):
    rc, pc = _cfgs(args, muts)
    ru, pu = RefUniverse(rc), MsgUniverse(pc)
    for name in ("M", "n_words", "type_offsets", "type_strides", "ap_pli_min", "ap_npli"):
        assert getattr(ru, name) == getattr(pu, name), name
    for name in ("typ", "src", "dst", "term", "lli", "llt", "pli", "plt", "entry", "lc",
                 "succ", "perm_table", "pair_perm_table"):
        assert np.array_equal(getattr(ru, name), getattr(pu, name)), name


@pytest.mark.parametrize("args,muts", CASES, ids=IDS)
def test_slot_layout_and_mxu_tables_match(args, muts):
    rc, pc = _cfgs(args, muts)
    kern = get_kernel(rc, mxu=True)
    mx = MXUExpand(pc, "cpu")
    assert mx.K == kern.K and mx.A == kern.A
    assert np.array_equal(mx.layout.slot_family, kern.slot_family)
    assert np.array_equal(mx.layout.slot_coords, kern.slot_coords)
    assert [n for n, _ in mx.layout.families] == [n for n, _, _ in kern.families]
    rt, pt = kern.mxu.tables, mx.tables
    assert np.array_equal(np.asarray(rt.W), pt.W)
    assert np.array_equal(np.asarray(rt.theta), pt.theta)
    assert np.array_equal(np.asarray(rt.slot_ok), pt.slot_ok)
    assert np.array_equal(np.asarray(rt.BIG), pt.BIG)
    assert rt.col_off == pt.col_off and rt.feat_off == pt.feat_off
    # carried across, the reference's tables are the port's tensors
    got = carry.mxu_tables(rt.W, rt.theta, rt.slot_ok, rt.BIG, rt.col_off, "cpu")
    assert torch.equal(got["W"], mx.W) and torch.equal(got["theta"], mx.theta)
    assert torch.equal(got["slot_ok"], mx.slot_ok) and torch.equal(got["BIG"], mx.BIG)
    assert got["col_off"] == pt.col_off
    lay = carry.slot_layout(kern.slot_family, kern.slot_coords, "cpu")
    assert torch.equal(lay["slot_table"], mx.slot_table) and lay["K"] == mx.K


@pytest.mark.parametrize("args,muts", CASES[:3] + CASES[5:6], ids=IDS[:3] + IDS[5:6])
def test_fingerprint_tables_match(args, muts):
    rc, pc = _cfgs(args, muts)
    rf = get_kernel(rc, mxu=True).fpr
    pf = Fingerprinter(pc, device="cpu")
    assert rf.P == pf.P and rf.spec.F == pf.spec.F and rf.spec.F_view == pf.spec.F_view
    assert np.array_equal(np.asarray(rf.C_planes), pf.C_planes_np)
    assert np.array_equal(np.asarray(rf.G_planes), pf.G_planes_np)
    got = carry.fingerprint_tables(rf.C_planes, rf.G_planes, "cpu")
    assert torch.equal(got["C_planes"], pf.C_planes)
    assert torch.equal(got["G_planes"], pf.G_planes)


def test_universe_carry_round_trip():
    rc, pc = _cfgs((3, 2, 3, 3), ())
    a = carry.universe_tables(RefUniverse(rc), "cpu")
    b = carry.universe_tables(MsgUniverse(pc), "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("args,muts", [CASES[1], CASES[2], CASES[5]], ids=["s3v1", "ref", "legacy"])
def test_guard_tables_match(args, muts):
    from tla_raft_tpu_torch.ops.successor import GuardTables

    rc, pc = _cfgs(args, muts)
    rt, pt = get_kernel(rc, mxu=True).tables, GuardTables(pc, "cpu")
    for name in ("any_to", "aq_to", "vp_to", "vq_uptodate", "aq_block", "aq_plt"):
        got = getattr(pt, name).numpy().view(np.uint32)
        assert np.array_equal(got, np.asarray(getattr(rt, name))), name
