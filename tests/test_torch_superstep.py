"""The port's resident supersteps (engine/superstep.py, B12) on the CPU,
mirroring the reference's tests/test_superstep.py against its own
superstep arm: the (2,1,1,1) fixpoint in exactly 4 supersteps covering
13 levels, the --max-depth clamp, every stop class of the commit
algebra (superstep.py:258-300) stopping uncommitted and replaying
through the per-level fused program, the ring's high water, and the
abort and violation stop points with the reference's traces."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import hashlib

import numpy as np
import pytest
import torch

import tla_raft_tpu.ops.hashstore as ref_hs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine import superstep as ref_ss
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine import superstep as ss
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.ops import hashstore as hs

from test_torch_engine import BUGS

S2 = (2, 1, 1, 1)
S3V1 = (3, 1, 1, 1)


def _port(args, **kw):
    kw.setdefault("chunk", 64)
    return TorchChecker(RaftConfig(*args), device="cpu", **kw)


def _sha(trace) -> str:
    return hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()


@pytest.fixture(scope="module")
def ref_s2():
    chk = JaxChecker(RefConfig(*S2), chunk=64, superstep=4)
    return chk.run(), dict(chk._ss_stats)


def test_superstep_s2_fixpoint_in_four_supersteps(ref_s2):
    ref, ref_stats = ref_s2
    chk = _port(S2)
    got = chk.run()
    assert got == ref
    assert (got.distinct, got.generated, got.depth) == (50, 97, 12)
    assert chk._ss_stats == ref_stats == dict(supersteps=4, levels=13, stops=0, ring_stops=0)
    assert chk.routes == dict(superstep=12, fused=0, grouped=0, staged=0)
    # all four windows fit one static shape (the ring size is a device
    # word): one program, built once
    assert chk.graph_stats["programs"] == 1


def test_superstep_max_depth_clamps_span():
    chk = _port(S2)
    res = chk.run(max_depth=6)
    assert res.depth == 6 and res.level_sizes == (1, 1, 1, 1, 1, 3, 6)
    assert chk._ss_stats["levels"] == 6  # one span-4 superstep + a span-2 remainder


def test_superstep_s3v1_fixpoint_equals_reference():
    ref = JaxChecker(RefConfig(*S3V1), chunk=256, superstep=4).run()
    chk = _port(S3V1, chunk=256)
    got = chk.run()
    assert got == ref and got.distinct == 545
    assert chk._ss_stats["supersteps"] > 0 and chk._ss_stats["stops"] == 0


def test_cap_x_stop_replays_per_level():
    chk = _port(S2, cap_x=16)
    res = chk.run()
    assert (res.distinct, res.generated, res.depth) == (50, 97, 12)
    assert chk._ss_stats["stops"] > 0 and chk._mega_stats["redo_x"] > 0 and chk.cap_x > 16
    assert chk.routes["fused"] > 0  # the stopped level replayed per level


def test_cap_m_stop_replays_per_level():
    chk = _port(S3V1, chunk=256, cap_m=4)
    res = chk.run()
    assert (res.distinct, res.depth) == (545, 19)
    assert chk._ss_stats["stops"] > 0 and chk._mega_stats["redo_m"] > 0 and chk.cap_m > 4


def test_slab_stop_replays_per_level(monkeypatch):
    for mod in (hs, ref_hs):
        monkeypatch.setattr(mod, "MIN_CAP", 16)
        monkeypatch.setattr(mod.DeviceHashStore, "need_grow", lambda self, extra=0: False)
    want = JaxChecker(RefConfig(*S2), chunk=64, superstep=4).run()
    chk = _port(S2)
    assert chk.run() == want
    assert chk._ss_stats["stops"] > 0 and chk._mega_stats["redo_slab"] > 0


def test_out_seat_stop_replays_per_level(monkeypatch):
    """A frontier seat (cap_f) too small for a level: FLAG_OVF_OUT stops
    the window and the level replays per level."""
    def small_seat(self, fut, span, n_rows, cap_cur):
        cap_f = max(4 * self.chunk, cap_cur)
        return cap_f, ss.ring_capacity(fut, span, cap_f, ref_ss.forecast.pow2ceil)

    monkeypatch.setattr(TorchChecker, "_superstep_shapes", small_seat)
    flags = []
    orig_grow = TorchChecker._grow_for_stop

    def spy(self, f, *rest):
        flags.append(f)
        return orig_grow(self, f, *rest)

    monkeypatch.setattr(TorchChecker, "_grow_for_stop", spy)
    chk = _port(S2, chunk=2)
    res = chk.run()
    assert (res.distinct, res.generated, res.depth) == (50, 97, 12)
    assert any(f & ss.FLAG_OVF_OUT for f in flags)


def test_ring_high_water_exits_early(monkeypatch):
    monkeypatch.setattr(ss, "ring_capacity", lambda fut, span, cap_f, pow2: 4)
    monkeypatch.setattr(ref_ss, "ring_capacity", lambda fut, span, cap_f, pow2: 4)
    want = JaxChecker(RefConfig(*S2), chunk=64, superstep=4)
    want_res = want.run()
    chk = _port(S2)
    assert chk.run() == want_res
    assert chk._ss_stats["ring_stops"] > 0
    assert chk._ss_stats == want._ss_stats


@pytest.mark.parametrize("mut", sorted(BUGS))
def test_stop_points_and_traces_equal_reference(mut):
    """The double-vote abort and the median-bug violation stop the
    superstep uncommitted; the per-level replay reports the reference's
    stop point and counterexample (pinned in test_torch_engine.py)."""
    want = BUGS[mut]
    chk = TorchChecker(RaftConfig(3, 1, 2, 0, mutations=(mut,)), device="cpu", chunk=256)
    res = chk.run()
    assert (res.ok, res.distinct, res.generated, res.depth, res.level_sizes) == want["result"]
    assert res.violation[0] == want["kind"] and _sha(res.violation[1]) == want["sha"]
    assert chk._ss_stats["stops"] == 1 and chk.routes["fused"] <= 1


def _lc(**kw):
    lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64)
    lc[mk.LC_ABORT] = mk.BIG
    lc[mk.LC_BAD] = -1
    for k, v in kw.items():
        lc[getattr(mk, "LC_" + k.upper())] = v
    return lc


@pytest.mark.parametrize("case,want_reason,want_flags", [
    (dict(n_new=5), ss.REASON_RUN, 0),
    (dict(n_new=0), ss.REASON_FIX, 0),
    (dict(n_new=5, abort=3), ss.REASON_STOP, ss.FLAG_ABORT),
    (dict(n_new=5, ovf_x=1), ss.REASON_STOP, ss.FLAG_OVF_X),
    (dict(n_new=5, ovf_slab=1), ss.REASON_STOP, ss.FLAG_OVF_SLAB),
    (dict(n_new=5, ovf_m=1), ss.REASON_STOP, ss.FLAG_OVF_M),
    (dict(n_new=0, ovf_m=1), ss.REASON_FIX, 0),  # ovf_m counts only with n_new > 0
    (dict(n_new=0, ovf_mx=1), ss.REASON_STOP, ss.FLAG_OVF_M),
    (dict(n_new=40), ss.REASON_STOP, ss.FLAG_OVF_OUT),
    (dict(n_new=5, bad=2), ss.REASON_STOP, ss.FLAG_BAD),
    (dict(n_new=5, tier_hits=1), ss.REASON_STOP, ss.FLAG_TIER),
    (dict(n_new=5, ovf_rounds=1), ss.REASON_STOP, ss.FLAG_OVF_ROUNDS),
    (dict(n_new=20), ss.REASON_RING, 0),
], ids=["run", "fixpoint", "abort", "cap_x", "slab", "cap_m", "cap_m-empty", "cap_m-expand",
        "out", "bad", "tier", "rounds", "ring"])
def test_commit_algebra(case, want_reason, want_flags):
    """The commit twin on each stop class of superstep.py:258-300 (the
    kernel is held to the twin on the card, tests/test_torch_cuda.py)."""
    K, span = 3, 4
    st = torch.zeros((ss.SS_LEN,), dtype=torch.int64)
    ss.op_ss_begin(st, torch.tensor([10, span, 20]))
    st[ss.SS_OFF] = 2  # a ring of 20 with 2 used: 19 new would overflow it
    mult = torch.arange(K, dtype=torch.int64) + 7
    meta_n = torch.zeros(span, dtype=torch.int64)
    meta_mult = torch.zeros((span, K), dtype=torch.int64)
    meta_rounds = torch.zeros(span, dtype=torch.int64)
    ss.op_ss_commit(st, _lc(n_run=10, **case), mult, 32, meta_n, meta_mult, meta_rounds)
    commit = want_reason in (ss.REASON_RUN, ss.REASON_FIX)
    n_new = case["n_new"]
    assert int(st[ss.SS_REASON]) == want_reason
    assert int(st[ss.SS_FLAGS]) == want_flags
    assert int(st[ss.SS_LEVELS]) == int(commit)
    assert int(st[ss.SS_APPEND]) == (2 if commit else -1)
    assert int(st[ss.SS_UNDO]) == int(not commit)
    assert int(st[ss.SS_OFF]) == 2 + (n_new if commit else 0)
    assert int(st[ss.SS_NF]) == (n_new if commit else 10)
    assert int(st[ss.SS_RUNNING]) == int(want_reason == ss.REASON_RUN)
    assert int(meta_n[0]) == n_new and torch.equal(meta_mult[0], mult)


def test_unpack_ring_matches_reference():
    g = np.random.default_rng(0)
    K, span, R = 5, 4, 32
    ctrl = np.array([3, ss.REASON_RING, 7, 12, 99, 0], np.int64)
    mn = np.array([4, 1, 7, 0], np.int64)
    mm = g.integers(0, 9, (span, K)).astype(np.int64)
    rf = g.integers(0, 1 << 62, R).astype(np.uint64)
    rp = g.integers(0, 1 << 31, R).astype(np.uint32)
    rs = g.integers(0, K, R).astype(np.uint16)
    a = ss.unpack_ring(ctrl, mn, mm, rf.view(np.int64), rp.view(np.int32), rs.view(np.int16))
    b = ref_ss.unpack_ring(ctrl, mn, mm, rf, rp, rs)
    assert a[1:] == b[1:]
    assert len(a[0]) == len(b[0]) == 3
    for x, y in zip(a[0], b[0]):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("fut,span,cap_f", [
    ([], 4, 256), ([900, 2000], 4, 65536), ([10_000] * 4, 4, 1 << 20), ([5], 2, 1 << 17),
])
def test_ring_capacity_matches_reference(fut, span, cap_f):
    pow2 = ref_ss.forecast.pow2ceil
    assert ss.ring_capacity(fut, span, cap_f, pow2) == ref_ss.ring_capacity(fut, span, cap_f, pow2)
