"""Whole runs of the port's cross-check arms against the reference on the
CPU: ``canon="expand"`` (the dense expand's delta-hash fingerprints and
the chunk compaction), ``use_mxu=False`` (the legacy per-lane kernels),
both, and ``audit=8`` (the sampled re-expansion), on the (3,1,1,1) and
(2,1,1,1) constants: the same CheckResult (counts, level sizes, action
counts), the same ``audit_stats``, and under canon="expand" the slab's
bytes equal to the reference's and to the port's own late run's.  Then
the ``tensor.flip`` drill (the same AuditFailStop level and message in
both packages; the CLI exits 4), the grouped route of every arm, and the
orbit refusal.  The reference runs are module-scoped and shared."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.resilience import faults as ref_faults
from tla_raft_tpu.resilience.integrity import AuditFailStop as RefFailStop
from tla_raft_tpu_torch import carry, check
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.resilience import faults
from tla_raft_tpu_torch.resilience.integrity import AuditFailStop

S3 = (3, 1, 1, 1)
S2 = (2, 1, 1, 1)
ARMS = {
    "expand": dict(canon="expand"),
    "legacy": dict(use_mxu=False),
    "expand-legacy": dict(canon="expand", use_mxu=False),
    "audit": dict(audit=8),
}


@pytest.fixture(scope="module")
def refs():
    """The reference's run of each (constants, arm), once."""
    cache = {}

    def get(args, arm):
        if (args, arm) not in cache:
            chk = JaxChecker(RefConfig(*args), chunk=64, **ARMS[arm])
            cache[args, arm] = (chk, chk.run())
        return cache[args, arm]

    return get


def _port(args, **kw):
    chk = TorchChecker(RaftConfig(*args), device="cpu", chunk=64, **kw)
    return chk, chk.run()


def _same(res, ref):
    assert (res.ok, res.distinct, res.generated, res.depth) == (
        ref.ok, ref.distinct, ref.generated, ref.depth)
    assert tuple(res.level_sizes) == tuple(ref.level_sizes)
    assert res.action_counts == ref.action_counts


SLOW_ROWS = {(S2, "expand"), (S2, "legacy"), (S2, "audit"), (S3, "expand-legacy")}


@pytest.mark.parametrize("args,arm", [
    (a, arm) if (a, arm) not in SLOW_ROWS else pytest.param(a, arm, marks=pytest.mark.slow)
    for a in (S3, S2) for arm in ARMS
], ids=[f"{'s3' if a == S3 else 's2'}-{arm}" for a in (S3, S2) for arm in ARMS])
def test_arm_matches_reference(refs, args, arm):
    """The arm's whole run equals the reference's (its default routes:
    supersteps, or per-level fused levels under audit).  Each reference
    run costs about 10 s of jit, so four rows are slow: their fast
    siblings are the (3,1,1,1) row of each arm alone and the S = 2 row of
    both arms together."""
    rchk, ref = refs(args, arm)
    chk, res = _port(args, **ARMS[arm])
    _same(res, ref)
    assert chk.audit_stats == rchk.audit_stats
    if chk.canon == "expand":
        assert np.array_equal(carry.slab_to_numpy(chk.hstore.slab), np.asarray(rchk.hstore.slab))
    if arm == "audit":
        assert chk.audit_stats["levels"] == res.depth and chk.routes["superstep"] == 0


def test_expand_slab_equals_late_slab():
    """canon="expand" fingerprints every lane by delta hash, canon="late"
    its candidates by K3's whole-state form: the same slab bytes."""
    a, _ = _port(S3, canon="expand")
    b, _ = _port(S3)
    assert np.array_equal(carry.slab_to_numpy(a.hstore.slab), carry.slab_to_numpy(b.hstore.slab))


@pytest.mark.parametrize("kw", [
    dict(canon="expand", superstep=1), dict(canon="expand", megakernel=False),
    dict(use_mxu=False, superstep=1), dict(use_mxu=False, megakernel=False),
    dict(audit=8, megakernel=False),
], ids=["expand-fused", "expand-staged", "legacy-fused", "legacy-staged", "audit-staged"])
def test_every_route_of_every_arm(kw):
    """The per-level fused program and the staged chain of each arm give
    the default run's result (the reference's counts: 545 / 2,028 / 19)."""
    _base, want = _port(S3)
    chk, res = _port(S3, **kw)
    _same(res, want)
    assert res.distinct == 545 and res.generated == 2028 and res.depth == 19


@pytest.mark.parametrize("kw", [dict(canon="expand"), dict(use_mxu=False), dict(audit=8)],
                         ids=["expand", "legacy", "audit"])
def test_grouped_route(kw):
    """With G lowered so that levels group (as tests/test_torch_group.py
    does: here levels 13-15 of (3,1,1,1), 17-19 chunks of 4 parents), each
    arm's grouped levels give the ungrouped run's result."""
    _base, want = _port(S3, **kw)
    chk = TorchChecker(RaftConfig(*S3), device="cpu", chunk=4, **kw)
    chk.G = 1
    chk.cap_g = chk.G * chk.cap_x // 2
    res = chk.run()
    _same(res, want)
    assert chk.routes["grouped"] > 0


FLIP = "tensor.flip:flip@4"


def _flip_stop(make, fail_stop, plan):
    plan.install(FLIP)
    try:
        with pytest.raises(fail_stop) as e:
            make().run()
    finally:
        plan.reset()
    return str(e.value)


# the reference's AuditFailStop for the drill below, pinned from
# JaxChecker(RaftConfig(3, 1, 1, 1), chunk=64, audit=8) under FLIP (the
# slow row below reruns the reference)
FLIP_STOP = (
    "audit mismatch at level 5 with no checkpoint directory to rewind to — fail-stop; "
    "first problem: row 0: materialized frontier row re-fingerprints to 0x881833cfb10cf06 "
    "!= recorded 0x2083c782df2f3e63 (corrupted frontier tensor)")


def test_flip_drill_matches_pinned_reference():
    """``TLA_RAFT_FAULT=tensor.flip:flip@4`` with audit=8: the fourth
    level's first row flips on the device and the audit of that level
    (the reference's numbering: level 5) stops the run with the
    reference's message, on the fused and the staged route."""
    for kw in (dict(), dict(megakernel=False)):
        got = _flip_stop(lambda: TorchChecker(RaftConfig(*S3), device="cpu", chunk=64, audit=8,
                                              **kw), AuditFailStop, faults)
        assert got == FLIP_STOP


@pytest.mark.slow
def test_flip_drill_matches_reference_rerun():
    """The pinned message above, from a rerun of the reference (slow: a
    jit; the fast sibling is test_flip_drill_matches_pinned_reference)."""
    want = _flip_stop(lambda: JaxChecker(RefConfig(*S3), chunk=64, audit=8), RefFailStop,
                      ref_faults)
    assert want == FLIP_STOP
    for kw in (dict(), dict(megakernel=False)):
        got = _flip_stop(lambda: TorchChecker(RaftConfig(*S3), device="cpu", chunk=64, audit=8,
                                              **kw), AuditFailStop, faults)
        assert got == want


@pytest.mark.parametrize("spec", ["mdelta.tmp:kill@1", "tensor.flip:kill@1", "tensor.flip",
                                  "tensor.flip:fail@1", "hashstore.grow:flip@1"])
def test_fault_spec_refuses_what_the_port_does_not_poll(spec):
    """A spec naming a site the port never fires, or an action its site
    does not perform, is refused at parse time rather than testing
    nothing."""
    with pytest.raises(ValueError):
        faults.FaultPlan(spec)
    assert faults.FaultPlan("tensor.flip:flip@4").triggers == [("tensor.flip", "flip", 4)]
    assert faults.FaultPlan("hashstore.grow:fail").triggers == [("hashstore.grow", "fail", 1)]


def test_flip_drill_retries_budget():
    """With one retry the first strike is the budget's: the reference's
    "reproduced" fail-stop."""
    faults.install(FLIP)
    try:
        with pytest.raises(AuditFailStop, match="reproduced 1 time"):
            TorchChecker(RaftConfig(*S3), device="cpu", chunk=64, audit=8,
                         audit_retries=1).run()
    finally:
        faults.reset()


def test_cli_flags_and_exit_codes(capsys, monkeypatch):
    """``--canon expand``, ``--no-mxu-expand`` / ``--mxu-expand 0`` and
    ``--audit 8`` print the reference's counts and the ``mxu`` / ``audit``
    fields; the flip drill exits 4."""
    import json

    base = ["--servers", "3", "--vals", "1", "--max-election", "1", "--max-restart", "1",
            "--device", "cpu", "--chunk", "256", "--json", "--log", "-"]
    for extra, mxu in ((["--canon", "expand"], True), (["--no-mxu-expand"], False),
                       (["--mxu-expand", "0", "--audit", "8", "--audit-retries", "2"], False)):
        assert check.main(base + extra) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (line["distinct"], line["generated"], line["depth"]) == (545, 2028, 19)
        assert line["mxu"] is mxu
        if "--audit" in extra:
            assert line["audit"] == dict(levels=19, sampled=114, mismatches=0, rewinds=0)
    monkeypatch.setenv("TLA_RAFT_FAULT", FLIP)
    faults.reset()
    monkeypatch.setattr(faults, "_PLAN", None)  # re-armed from the environment
    try:
        assert check.main(base + ["--audit", "8"]) == 4
    finally:
        faults.reset()
    assert "Integrity fail-stop: audit mismatch at level 5" in capsys.readouterr().out


def test_orbit_refuses_expand(monkeypatch):
    """canon="expand" under orbit pruning raises, as in the reference."""
    with pytest.raises(ValueError, match="requires canon='late'"):
        TorchChecker(RaftConfig(*S2), device="cpu", orbit=True, canon="expand")
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
    with pytest.raises(ValueError, match="requires canon='late'"):
        TorchChecker(RaftConfig(*S2), device="cpu", canon="expand")
    with pytest.raises(ValueError, match="requires canon='late'"):
        JaxChecker(RefConfig(*S2), chunk=64, canon="expand")
