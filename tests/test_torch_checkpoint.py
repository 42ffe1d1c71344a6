"""Checkpoint/resume of the port against the reference on the CPU: the delta
log (``delta_NNNN.npz``), the slab snapshot (``hslab.npz``) and the
manifest writer.

A run killed or corrupted at any level resumes to the uninterrupted run's
counts, level sizes and delta records on every route of the port (staged,
fused, supersteps, grouped, the sorted store); a log and slab written by
``JaxChecker`` resume on ``TorchChecker`` and the reverse, under both
fingerprint definitions (``TLA_RAFT_ORBIT`` 0 and 1), and a dumped slab
loads byte-equal in the other package; ``_check_fp_def`` refuses a log of
the other definition; the median-bug trace after a resume is the
reference's; a crash matrix over the writer sites (``delta.*``,
``hslab.*``, ``manifest.commit`` x torn / flip / fail in-process, and a
SIGKILL in a subprocess) converges; the audit's flip drill rewinds to the
log; the CLI's ``--checkpoint-dir`` / ``--recover`` / ``--fault`` and its
exit codes 2 and 75.  Every output is an integer: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import tla_raft_tpu.check as ref_check
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.ops.hashstore import DeviceHashStore as RefHashStore
from tla_raft_tpu.resilience import faults as ref_faults
from tla_raft_tpu_torch import check, resilience
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.ops.hashstore import DeviceHashStore
from tla_raft_tpu_torch.resilience import faults

from test_torch_engine import BUGS, _sha

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2 = (2, 1, 1, 1)  # 50 distinct / 97 generated / depth 12
S3 = (3, 1, 1, 1)  # 545 / 2,028 / 19
S2_FIXPOINT = (True, 50, 97, 12, (1, 1, 1, 1, 1, 3, 6, 9, 9, 7, 6, 4, 1))


def _deltas(d: str) -> list:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "delta_*.npz"))):
        with np.load(f) as z:
            out.append((os.path.basename(f), {k: z[k].copy() for k in z.files}))
    return out


def _same_log(a: str, b: str) -> None:
    da, db = _deltas(a), _deltas(b)
    assert [n for n, _ in da] == [n for n, _ in db]
    for (n, x), (_, y) in zip(da, db):
        assert sorted(x) == sorted(y), n
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (n, k)


def _counts(r) -> tuple:
    return (r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes))


def _crash(fn, spec: str) -> None:
    """Run ``fn`` under the fault ``spec``; a ``fail`` raises FaultError
    mid-run, the others run on over a corrupted artifact."""
    faults.install(spec)
    try:
        fn()
    except faults.FaultError:
        pass
    finally:
        faults.reset()


ROUTES = {
    "superstep": (S3, 8, None, {}),
    "fused": (S3, 8, None, dict(superstep=1)),
    "staged": (S3, 8, None, dict(megakernel=False)),
    "sorted": (S3, 8, None, dict(use_hashstore=False)),
    "grouped": ((3, 1, 2, 0), 8, 11, dict(G=1)),  # levels 9-11 grouped
}


def _checker(cfg, chunk, kw):
    kw = dict(kw)
    g = kw.pop("G", None)
    chk = TorchChecker(RaftConfig(*cfg), device="cpu", chunk=chunk, **kw)
    if g:
        chk.G = g
        chk.cap_g = chk.G * chk.cap_x // 2
    return chk


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_resume_equals_an_uninterrupted_run(tmp_path, route):
    """A run stopped by a failed delta commit at level 7 (the record renamed,
    not manifested: adopted on resume) resumes to the uninterrupted run's
    counts, level sizes and every delta record's arrays."""
    cfg, chunk, depth, kw = ROUTES[route]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    clean = _checker(cfg, chunk, kw)
    want = clean.run(max_depth=depth, checkpoint_dir=a)
    if route == "grouped":
        assert clean.routes["grouped"] == 3
    _crash(lambda: _checker(cfg, chunk, kw).run(max_depth=depth, checkpoint_dir=b),
           "delta.commit:fail@7")
    assert len(_deltas(b)) == 7
    got = _checker(cfg, chunk, kw).run(max_depth=depth, checkpoint_dir=b, resume_from=b)
    assert _counts(got) == _counts(want)
    assert got.action_counts == want.action_counts
    _same_log(a, b)


@pytest.fixture(params=["0", "1"], ids=["fold", "orbit"])
def fp_def(request, monkeypatch):
    monkeypatch.setenv("TLA_RAFT_ORBIT", request.param)
    return int(request.param)


def test_logs_and_slabs_cross_between_the_packages(tmp_path, fp_def):
    """A delta log and slab written by JaxChecker to depth 6 resume on
    TorchChecker to the reference's fixpoint (the (2,1,1,1) counts every
    suite pins), and the reverse; each
    package's hslab.npz loads byte-equal in the other; the records of the
    two writers are equal array for array."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxChecker(RefConfig(*S2), chunk=64).run(max_depth=6, checkpoint_dir=jd)
    TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(max_depth=6, checkpoint_dir=td)
    _same_log(jd, td)
    for src in (jd, td):
        with np.load(os.path.join(src, "hslab.npz")) as z:
            slab, meta = z["slab"].copy(), z["meta"].copy()
        assert list(meta) == [1, 6, sum(S2_FIXPOINT[4][:7]), len(slab), fp_def]
        mine = DeviceHashStore.load(os.path.join(src, "hslab.npz"), 6, int(meta[2]), fp_def,
                                    device="cpu")
        theirs = RefHashStore.load(os.path.join(src, "hslab.npz"), 6, int(meta[2]), fp_def)
        assert np.array_equal(mine.slab.numpy().view(np.uint64), slab)
        assert np.array_equal(np.asarray(theirs.slab), slab)
    port = TorchChecker(RaftConfig(*S2), device="cpu", chunk=64)
    got = port.run(checkpoint_dir=jd, resume_from=jd)
    assert _counts(got) == S2_FIXPOINT
    back = JaxChecker(RefConfig(*S2), chunk=64).run(checkpoint_dir=td, resume_from=td)
    assert _counts(back) == S2_FIXPOINT
    _same_log(jd, td)


def test_fp_def_guard_refuses_the_other_definition(tmp_path, monkeypatch):
    """Orbit and min-over-P fingerprints never share a store: a log of one
    definition resumed under the other raises, as the reference does."""
    d = str(tmp_path / "ck")
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")  # an orbit log (the reference's bytes, above)
    TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(max_depth=4, checkpoint_dir=d)
    monkeypatch.setenv("TLA_RAFT_ORBIT", "0")
    with pytest.raises(ValueError, match="fingerprint-definition mismatch"):
        TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(resume_from=d)
    with pytest.raises(ValueError, match="fingerprint-definition mismatch"):
        TorchChecker(RaftConfig(*S2), device="cpu", chunk=64)._check_fp_def(1, d)


def test_median_bug_trace_after_resume_is_the_references(tmp_path):
    """The port's mirror of tests/test_checkpoint.py:36: a violation found
    after a delta-log resume (from depth 8 of the median-bug mutation)
    carries the full-depth counterexample: the reference's counts and
    trace, pinned in tests/test_torch_engine.py (whose slow sibling
    re-derives them from the reference)."""
    want = BUGS["median-bug"]
    cfg = RaftConfig(3, 1, 2, 0, mutations=("median-bug",))
    d = str(tmp_path / "ck")
    TorchChecker(cfg, device="cpu", chunk=64).run(max_depth=8, checkpoint_dir=d)
    got = TorchChecker(cfg, device="cpu", chunk=64).run(checkpoint_dir=d, resume_from=d)
    assert (got.ok, got.distinct, got.generated, got.depth, got.level_sizes) == want["result"]
    assert got.violation[0] == want["kind"]
    assert _sha(got.violation[1]) == want["sha"]


@pytest.mark.slow
def test_resumed_trace_equals_a_reference_rerun(tmp_path):
    """Slow sibling of test_median_bug_trace_after_resume_is_the_references
    (a JAX run): the reference's own resume-and-trace case
    (tests/test_checkpoint.py:36), trace for trace."""
    cfg = dict(n_servers=3, n_vals=1, max_election=1, max_restart=0,
               invariants=("~RaftCanCommt",))
    want = JaxChecker(RefConfig(**cfg), chunk=64).run()
    assert not want.ok
    d = str(tmp_path / "ck")
    TorchChecker(RaftConfig(**cfg), device="cpu", chunk=64).run(max_depth=want.depth - 2,
                                                                 checkpoint_dir=d)
    got = TorchChecker(RaftConfig(**cfg), device="cpu", chunk=64).run(resume_from=d)
    assert _counts(got) == _counts(want)
    assert (check.trace_doc(RaftConfig(**cfg), got.violation[1])
            == ref_check.trace_doc(RefConfig(**cfg), want.violation[1]))


WRITER_SITES = ("delta.tmp", "delta.commit", "hslab.tmp", "hslab.commit", "manifest.commit")


@pytest.fixture(scope="module")
def clean_s2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("clean"))
    res = TorchChecker(RaftConfig(*S2), device="cpu", chunk=64, superstep=1).run(
        checkpoint_dir=d)
    return res, d


@pytest.mark.parametrize("action", ["torn", "flip", "fail"])
@pytest.mark.parametrize("site", WRITER_SITES)
def test_crash_matrix_converges(tmp_path, clean_s2, site, action):
    """A torn, flipped or failed write at the fifth hit of each writer site:
    the resume heals the directory (quarantines what fails its digest or
    read-back, adopts what was renamed but not manifested, truncates to
    the good prefix) and converges to the clean run's counts and records."""
    want, clean_dir = clean_s2
    d = str(tmp_path / "ck")
    _crash(lambda: TorchChecker(RaftConfig(*S2), device="cpu", chunk=64, superstep=1).run(
        checkpoint_dir=d), f"{site}:{action}@5")
    got = TorchChecker(RaftConfig(*S2), device="cpu", chunk=64, superstep=1).run(
        checkpoint_dir=d, resume_from=d)
    assert _counts(got) == _counts(want)
    _same_log(clean_dir, d)
    assert not glob.glob(os.path.join(d, ".tmp_*"))
    if site.startswith("delta") and action in ("torn", "flip"):
        assert os.listdir(os.path.join(d, "quarantine"))


def test_heal_rows_adopt_refuse_and_sweep(tmp_path):
    """The remaining heal rows: an unmanifested record is adopted, a
    directory of another run configuration is refused (RunMismatch), a
    stale tmp file is swept, and a fresh run refuses a directory that
    already holds a log."""
    d = str(tmp_path / "ck")
    _crash(lambda: TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(checkpoint_dir=d),
           "delta.commit:fail@3")
    m = resilience.Manifest.load(d)
    assert "delta_0003.npz" not in m.artifacts and os.path.exists(os.path.join(d,
                                                                               "delta_0003.npz"))
    open(os.path.join(d, ".tmp_delta_0004.npz"), "wb").write(b"torn")
    with pytest.raises(resilience.RunMismatch):
        TorchChecker(RaftConfig(2, 1, 1, 0), device="cpu", chunk=64).run(resume_from=d)
    with pytest.raises(ValueError, match="holds checkpoints from a previous run"):
        TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(checkpoint_dir=d)
    got = TorchChecker(RaftConfig(*S2), device="cpu", chunk=64).run(checkpoint_dir=d,
                                                                    resume_from=d)
    assert _counts(got)[1:4] == (50, 97, 12)
    assert "delta_0003.npz" in resilience.Manifest.load(d).artifacts
    assert not os.path.exists(os.path.join(d, ".tmp_delta_0004.npz"))


def _cli(*args, env=None):
    e = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.check", *args, "--log", "-"],
                          cwd=REPO,
                          env=e, capture_output=True, text=True)


def test_sigkill_and_recover_in_a_subprocess(tmp_path, clean_s2):
    """``--fault delta.commit:kill@6`` ends the process by SIGKILL; the
    ``--recover`` run converges to the clean run's counts and records."""
    want, clean_dir = clean_s2
    d = str(tmp_path / "ck")
    base = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
            "--device", "cpu", "--chunk", "64", "--superstep", "1", "--json",
            "--checkpoint-dir", d]
    p = _cli(*base, "--fault", "delta.commit:kill@6")
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])
    p = _cli(*base, "--recover", d)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert (line["distinct"], line["generated"], line["depth"], tuple(line["level_sizes"])) == (
        _counts(want)[1:])
    _same_log(clean_dir, d)


def test_flip_drill_with_checkpoints_rewinds(tmp_path):
    """``tensor.flip:flip@4`` under ``--audit 8`` with a checkpoint
    directory: the mismatched level is quarantined, the run rewinds to the
    delta log (one rewind) and ends with the reference's counts; with
    ``audit_retries=1`` the first strike fail-stops."""
    d = str(tmp_path / "ck")
    faults.install("tensor.flip:flip@4")
    try:
        chk = TorchChecker(RaftConfig(*S3), device="cpu", chunk=64, audit=8)
        got = chk.run(checkpoint_dir=d)
    finally:
        faults.reset()
    assert _counts(got)[1:4] == (545, 2028, 19)
    assert chk.audit_stats["rewinds"] == 1 and chk.audit_stats["mismatches"] >= 1
    faults.install("tensor.flip:flip@4")
    try:
        with pytest.raises(resilience.integrity.AuditFailStop, match="reproduced 1 time"):
            TorchChecker(RaftConfig(*S3), device="cpu", chunk=64, audit=8,
                         audit_retries=1).run(checkpoint_dir=str(tmp_path / "ck1"))
    finally:
        faults.reset()


def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    """--dev-bytes with --checkpoint-dir refuses with exit 2; a preemption
    request stops at a level boundary with exit 75 and the resume hint."""
    base = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
            "--device", "cpu", "--chunk", "64", "--checkpoint-dir", str(tmp_path / "ck"),
            "--log", str(tmp_path / "raft.log")]
    assert check.main(base + ["--dev-bytes", "8192"]) == 2
    assert "Refusing --dev-bytes with --checkpoint-dir" in capsys.readouterr().out
    monkeypatch.setattr(resilience, "install_signal_handlers", lambda: None)
    resilience.request_preempt()
    try:
        assert check.main(base) == 75
    finally:
        resilience.clear_preempt()
    assert f"Resume with --recover {tmp_path / 'ck'}" in capsys.readouterr().out


def test_fault_sites_parse_as_the_references():
    """Every writer and runtime site the port polls parses with the
    reference's grammar and keeps its name."""
    for site in ("delta.tmp", "delta.commit", "hslab.tmp", "hslab.commit", "manifest.commit",
                 "job.tmp", "jobstate.commit", "result.tmp", "lease.commit", "bstate.commit",
                 "level.start", "bucket.level", "lease.renew"):
        assert site in ref_faults.FAULT_SITES
        assert faults.FaultPlan(f"{site}:kill@2").triggers == [(site, "kill", 2)]


@pytest.mark.parametrize("algo", ["xxh64", "blake2b64"])
def test_digests_of_both_algorithms_verify_in_both_packages(tmp_path, monkeypatch, algo):
    """The manifest's digest: xxh64 with the xxhash wheel, blake2b64
    without it (the algorithm rides in the entry); a record of either
    verifies in both packages, and a recorded xxh64 that the environment
    cannot compute falls back to the structural read."""
    from tla_raft_tpu.resilience import manifest as ref_manifest
    from tla_raft_tpu_torch.resilience import manifest

    if algo == "blake2b64":
        monkeypatch.setattr(manifest, "_xxhash", None)
    elif manifest._xxhash is None:
        pytest.skip("the xxhash wheel is not installed")
    d = str(tmp_path)
    resilience.commit_npz(d, "delta_0001.npz", dict(a=np.arange(5)), kind="delta", depth=1)
    entry = resilience.Manifest.load(d).artifacts["delta_0001.npz"]
    assert entry["algo"] == algo
    assert resilience.Manifest.load(d).verify("delta_0001.npz") == "ok"
    assert ref_manifest.Manifest.load(d).verify("delta_0001.npz") == "ok"
    if algo == "xxh64":
        monkeypatch.setattr(manifest, "_xxhash", None)
        with pytest.raises(LookupError):
            manifest._hasher("xxh64")
        assert resilience.Manifest.load(d).verify("delta_0001.npz") == "ok"
