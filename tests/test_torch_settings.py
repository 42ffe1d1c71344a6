"""The reference's settings, read by the port where the reference reads
them, an explicit argument winning: ``TLA_RAFT_MEGAKERNEL=0`` (the staged
chain, megakernel.py:91-94), ``TLA_RAFT_SUPERSTEP=N`` (the superstep span;
<= 1 per-level fused levels, superstep.py:133-142), ``TLA_RAFT_CAP_M``
(replaces only the default cap_m of 96, bfs.py:536-546) and
``TLA_RAFT_MXU=0`` (the legacy per-lane kernels, mxu_expand.py:72) and
``TLA_RAFT_HASHSTORE=0`` (the sorted visited store, hashstore.py:116),
``TLA_RAFT_PIPELINE``, ``TLA_RAFT_PIPELINE_WINDOW``, ``TLA_RAFT_PREWARM``
and ``TLA_RAFT_PRESIZE`` (bfs.py:651-714, against ``JaxChecker``'s); and
the CLI's reference flags: ``--config`` (TLC's Raft.cfg, through the
port's copy of cfgparse.py, the spec beside it validated by its copy of
tla_frontend.py), ``--invariant``, ``--no-symmetry``, ``--no-view``,
``--no-hashstore``, each against the reference's ``check.py --json``,
and ``--no-pipeline``, ``--pipeline-window`` and ``--prewarm`` (refused
with ``--mesh``)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json

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


def test_hashstore_setting(monkeypatch):
    """``TLA_RAFT_HASHSTORE=0`` (hashstore.py:116) selects the sorted store,
    and with it the staged chain; the argument wins."""
    monkeypatch.setenv("TLA_RAFT_HASHSTORE", "0")
    chk = _run()
    assert not chk.use_hashstore and not chk.megakernel and chk.routes["staged"] == 12
    assert chk.hstore is None and int((chk.visited != -1).sum()) == GOLD[0]
    assert _run(use_hashstore=True).routes["superstep"] == 12
    monkeypatch.setenv("TLA_RAFT_HASHSTORE", "1")
    assert TorchChecker(S2, device="cpu").use_hashstore


# -- the CLI reads TLC's Raft.cfg (check.py:815-1015) -------------------------------------


def test_cfgparse_and_frontend_are_the_references():
    """The port's copies of cfgparse.py and tla_frontend.py parse, lower and
    validate as the reference's do."""
    from tla_raft_tpu import cfgparse as ref_cfg
    from tla_raft_tpu import tla_frontend as ref_fe
    from tla_raft_tpu_torch import cfgparse, tla_frontend

    from test_cfgparse import REFERENCE_CFG

    a, b = cfgparse.parse_cfg(REFERENCE_CFG), ref_cfg.parse_cfg(REFERENCE_CFG)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (dataclasses.asdict(cfgparse.to_raft_config(a))
            == dataclasses.asdict(ref_cfg.to_raft_config(b)))
    assert tla_frontend.SEMANTIC_HASHES == ref_fe.SEMANTIC_HASHES
    for name in ("EXPECTED_ACTIONS", "EXPECTED_CONSTANTS", "EXPECTED_VARIABLES",
                 "EXPECTED_VIEW"):
        assert getattr(tla_frontend, name) == getattr(ref_fe, name)


@pytest.fixture
def cfg_file(tmp_path):
    from test_cfgparse import REFERENCE_CFG

    path = tmp_path / "Raft.cfg"
    path.write_text(REFERENCE_CFG)
    return path


def _json_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


KEYS = ("ok", "distinct", "generated", "depth", "level_sizes", "violation")


@pytest.mark.parametrize("flags", [
    [], ["--no-hashstore"], ["--invariant", "~Inv"], ["--no-symmetry", "--no-view"],
], ids=["cfg", "no-hashstore", "negated-inv", "no-symmetry-no-view"])
def test_cli_config_equals_the_reference_cli(cfg_file, capsys, flags):
    """``--config`` from the reference's Raft.cfg text, with the reference's
    flags: the ``--json`` line's counts and verdict and the exit code equal
    the reference's ``check.py --json`` on the same cfg and flags (the
    reference's --no-hashstore run and its default give the same line, so
    the two port arms share the reference's default); the port's line also
    says which store ran."""
    from tla_raft_tpu.check import main as ref_main
    from tla_raft_tpu_torch.check import main

    depth = "3" if "--no-view" in flags else "4"
    ref_flags = [f for f in flags if f != "--no-hashstore"]
    rc_ref = ref_main(["--config", str(cfg_file), "--max-depth", depth, "--json", "--log", "-",
                       *ref_flags])
    want = _json_of(capsys.readouterr().out)
    rc = main(["--log", "-",
               "--config", str(cfg_file), "--max-depth", depth, "--json", "--device", "cpu",
               "--chunk", "256", *flags])
    out = capsys.readouterr().out
    got = _json_of(out)
    assert rc == rc_ref and {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert f"Config {cfg_file}: S=3 V=2" in out
    assert got["hashstore"] == ("--no-hashstore" not in flags) and "degraded_at" not in got
    if "~Inv" in flags:
        assert rc == 1 and got["violation"] == "Invariant ~Inv is violated"


def test_cli_refuses_a_spec_that_diverges(cfg_file, capsys):
    """A Raft.tla beside the cfg that is not the compiled spec: exit 2, as
    the reference; ``--spec ''`` skips the check."""
    from tla_raft_tpu_torch.check import main

    (cfg_file.parent / "Raft.tla").write_text("---- MODULE Raft ----\nVARIABLES x\n====\n")
    assert main(["--log", "-",
                 "--config", str(cfg_file), "--device", "cpu", "--max-depth", "1"]) == 2
    assert "SPEC MISMATCH" in capsys.readouterr().out
    assert main(["--log", "-",
                 "--config", str(cfg_file), "--device", "cpu", "--max-depth", "1", "--spec",
                 ""]) == 0


def test_cli_degrade_line(capsys, monkeypatch):
    """A grow failure on the CLI's run: the ``--json`` line says the store
    ended sorted and at which depth it degraded."""
    from tla_raft_tpu_torch.check import main
    from tla_raft_tpu_torch.ops import hashstore as hs
    from tla_raft_tpu_torch.resilience import faults

    monkeypatch.setattr(hs, "MIN_CAP", 16)
    faults.install("hashstore.grow:fail@1")
    try:
        rc = main(["--log", "-",
                   "--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
                   "--device", "cpu", "--chunk", "64", "--json"])
    finally:
        faults.reset()
    got = _json_of(capsys.readouterr().out)
    assert rc == 0 and (got["distinct"], got["generated"], got["depth"]) == GOLD
    assert got["hashstore"] is False and got["degraded_at"] >= 1


def test_cli_cap_x(capsys, monkeypatch):
    """``--cap-x`` is the reference's mesh budget (its check.py reads it on
    the distributed path only): accepted, and on one device it changes
    nothing -- the checker is built without it, and the counts are the
    run's without the flag."""
    from tla_raft_tpu_torch.check import main

    kws = []
    real = TorchChecker.__init__

    def init(self, *a, **kw):
        kws.append(kw)
        real(self, *a, **kw)

    monkeypatch.setattr(TorchChecker, "__init__", init)
    rc = main(["--log", "-",
               "--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
               "--device", "cpu", "--chunk", "64", "--cap-x", "8", "--superstep", "1",
               "--json"])
    got = _json_of(capsys.readouterr().out)
    assert rc == 0 and (got["distinct"], got["generated"], got["depth"]) == GOLD
    assert len(kws) == 1 and "cap_x" not in kws[0]


# -- the async pipeline, the prewarm and the presize (bfs.py:651-714) ---------------------


@pytest.mark.parametrize("env", [
    {}, {"TLA_RAFT_PIPELINE": "0"}, {"TLA_RAFT_PIPELINE_WINDOW": "4"},
    {"TLA_RAFT_PIPELINE_WINDOW": "0"}, {"TLA_RAFT_PREWARM": "1", "TLA_RAFT_PRESIZE": "1"},
    {"TLA_RAFT_PREWARM": "0", "TLA_RAFT_PRESIZE": "0"},
], ids=["unset", "pipeline-0", "window-4", "window-0", "on", "off"])
def test_pipeline_prewarm_presize_settings_are_the_references(monkeypatch, env):
    """``TLA_RAFT_PIPELINE``, ``TLA_RAFT_PIPELINE_WINDOW``,
    ``TLA_RAFT_PREWARM`` and ``TLA_RAFT_PRESIZE`` resolve as the reference
    resolves them (bfs.py:651-714) on the CPU, where the reference's
    default for the last two (a tunneled backend) is off, as the port's is
    off the card; an explicit argument wins."""
    from tla_raft_tpu.config import RaftConfig as RefConfig
    from tla_raft_tpu.engine.bfs import JaxChecker

    for k in ("TLA_RAFT_PIPELINE", "TLA_RAFT_PIPELINE_WINDOW", "TLA_RAFT_PREWARM",
              "TLA_RAFT_PRESIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = JaxChecker(RefConfig(2, 1, 1, 1), chunk=64)
    chk = TorchChecker(S2, device="cpu", chunk=64)
    assert (chk.pipeline, chk.pipeline_window, chk.prewarm, chk.presize) == \
        (ref.pipeline, ref.pipeline_window, ref.prewarm, ref.presize)
    arg = TorchChecker(S2, device="cpu", pipeline=True, pipeline_window=3, prewarm=True,
                       presize=False)
    assert (arg.pipeline, arg.pipeline_window, arg.prewarm, arg.presize) == (True, 3, True, False)


@pytest.mark.parametrize("flags,want", [
    ([], dict(pipeline=True, pipeline_window=2, prewarm=False)),
    (["--no-pipeline"], dict(pipeline=False, pipeline_window=0, prewarm=False)),
    (["--pipeline-window", "4"], dict(pipeline=True, pipeline_window=4, prewarm=False)),
    (["--pipeline-window", "0"], dict(pipeline=False, pipeline_window=0, prewarm=False)),
    (["--prewarm", "1"], dict(pipeline=True, pipeline_window=2, prewarm=True)),
], ids=["default", "no-pipeline", "window-4", "window-0", "prewarm"])
def test_cli_pipeline_flags(capsys, monkeypatch, flags, want):
    """``--no-pipeline``, ``--pipeline-window`` and ``--prewarm`` (check.py:
    907-920, :1157-1160) reach the checker, and the counts stay the run's."""
    from tla_raft_tpu_torch.check import main

    for k in ("TLA_RAFT_PIPELINE", "TLA_RAFT_PIPELINE_WINDOW", "TLA_RAFT_PREWARM"):
        monkeypatch.delenv(k, raising=False)
    rc = main(["--log", "-",
               "--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
               "--device", "cpu", "--chunk", "64", "--json", *flags])
    got = _json_of(capsys.readouterr().out)
    assert rc == 0 and (got["distinct"], got["generated"], got["depth"]) == GOLD
    assert {k: got[k] for k in want} == want


def test_cli_refuses_prewarm_on_a_mesh(capsys):
    """``--prewarm 1`` with ``--mesh`` is refused (exit 2): the mesh's level
    loops capture their programs in line (check.py:1109-1111)."""
    from tla_raft_tpu_torch.check import PREWARM_MESH_REFUSAL, main

    rc = main(["--log", "-",
               "--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
               "--device", "cpu", "--mesh", "2", "--prewarm", "1"])
    assert rc == 2 and PREWARM_MESH_REFUSAL in capsys.readouterr().out
    rc = main(["--log", "-",
               "--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
               "--device", "cpu", "--mesh", "2", "--cap-x", "512", "--prewarm", "0",
               "--no-pipeline", "--json"])
    assert rc == 0 and _json_of(capsys.readouterr().out)["distinct"] == GOLD[0]
