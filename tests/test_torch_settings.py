"""The reference's settings, read by the port where the reference reads
them, an explicit argument winning: ``TLA_RAFT_MEGAKERNEL=0`` (the staged
chain, megakernel.py:91-94), ``TLA_RAFT_SUPERSTEP=N`` (the superstep span;
<= 1 per-level fused levels, superstep.py:133-142), ``TLA_RAFT_CAP_M``
(replaces only the default cap_m of 96, bfs.py:536-546) and
``TLA_RAFT_MXU=0`` (the legacy per-lane kernels, mxu_expand.py:72)."""

import pytest

from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker

S2 = RaftConfig(2, 1, 1, 1)
GOLD = (50, 97, 12)


def _run(**kw):
    chk = TorchChecker(S2, device="cpu", chunk=64, **kw)
    res = chk.run()
    assert (res.distinct, res.generated, res.depth) == GOLD
    return chk


def test_megakernel_setting(monkeypatch):
    monkeypatch.setenv("TLA_RAFT_MEGAKERNEL", "0")
    chk = _run()
    assert not chk.megakernel and chk.superstep_span == 1
    assert chk.routes["staged"] == 12
    assert _run(megakernel=True).routes["superstep"] == 12  # the argument wins
    monkeypatch.setenv("TLA_RAFT_MEGAKERNEL", "1")
    assert _run().megakernel


@pytest.mark.parametrize("env,span", [("1", 1), ("2", 2), ("0", 1)])
def test_superstep_setting(monkeypatch, env, span):
    monkeypatch.setenv("TLA_RAFT_SUPERSTEP", env)
    chk = _run()
    assert chk.superstep_span == span
    if span == 1:
        assert chk.routes["fused"] == 12 and chk.routes["superstep"] == 0
    else:
        assert chk._ss_stats["supersteps"] > 0
    assert TorchChecker(S2, device="cpu", superstep=4).superstep_span == 4


def test_superstep_default_without_setting(monkeypatch):
    """No setting and no tuner: the span is DEFAULT_SPAN (4)."""
    monkeypatch.delenv("TLA_RAFT_SUPERSTEP", raising=False)
    assert TorchChecker(S2, device="cpu").superstep_span == 4


def test_cap_m_setting(monkeypatch):
    monkeypatch.setenv("TLA_RAFT_CAP_M", "40")  # S = 2 has M = 46 ids
    assert TorchChecker(S2, device="cpu").cap_m == 40
    assert TorchChecker(S2, device="cpu", cap_m=30).cap_m == 30  # explicit wins
    chk = _run()
    assert chk.cap_m == 40 and chk.frontier.msg_ids.shape[1] == 40


def test_mxu_setting(monkeypatch):
    monkeypatch.setenv("TLA_RAFT_MXU", "0")
    chk = _run()
    assert not chk.use_mxu and chk.dx is not None
    assert _run(use_mxu=True).use_mxu  # the argument wins
    monkeypatch.setenv("TLA_RAFT_MXU", "1")
    assert TorchChecker(S2, device="cpu").use_mxu


def test_audit_turns_supersteps_off():
    chk = _run(audit=4)
    assert chk.superstep_span == 1 and chk.routes["fused"] == 12
    assert chk.audit_stats["levels"] == 12
