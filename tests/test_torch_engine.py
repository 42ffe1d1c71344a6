"""Whole runs of the port's checker (TorchChecker on the CPU, through the
plain twins) against the reference: golden counts, level sizes, coverage,
grow-and-redo of every lane budget, chunk-size independence, a mid-run
handoff of the reference's frontier and slab, and the counterexample
traces of two planted bugs."""

import hashlib

import numpy as np
import pytest

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import hashstore as hs


def _ref_checker(cfg, chunk=64):
    """The reference's staged single-device chain (the port's path)."""
    return JaxChecker(cfg, chunk=chunk, megakernel=False, superstep=1, use_hashstore=True)


def _port(cfg, **kw):
    kw.setdefault("chunk", 64)
    return TorchChecker(cfg, device="cpu", **kw)


def _sha(trace) -> str:
    return hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()


@pytest.mark.parametrize("args,depth,want", [
    ((2, 1, 1, 1), None, (50, 97, 12)),
    ((3, 2, 3, 3), 8, (1505, 3044, 8)),
], ids=["s2-fixpoint", "ref-depth8"])
def test_golden_counts(args, depth, want):
    res = _port(RaftConfig(*args)).run(max_depth=depth)
    assert res.ok and (res.distinct, res.generated, res.depth) == want


def test_s3v1_fixpoint_matches_reference():
    ref = _ref_checker(RefConfig(3, 1, 1, 1)).run()
    got = _port(RaftConfig(3, 1, 1, 1)).run()
    assert (got.distinct, got.depth) == (545, 19)
    assert got == ref  # ok, counts, level_sizes, no violation, action_counts


def test_chunk_size_does_not_change_results():
    a = _port(RaftConfig(3, 1, 1, 1), chunk=16).run()
    b = _port(RaftConfig(3, 1, 1, 1), chunk=512).run()
    assert a == b


def test_grow_and_redo_every_budget(monkeypatch):
    """Tiny cap_x and cap_m, and a slab that only grows on a probe
    overflow: every budget overflows, grows, redoes — same counts.  The
    staged chain (a superstep reserves its span's slab room up front;
    tests/test_torch_superstep.py drills the fused arms' stops)."""
    monkeypatch.setattr(hs.DeviceHashStore, "need_grow", lambda self, extra=0: False)
    chk = _port(RaftConfig(), cap_x=8, cap_m=4, megakernel=False)
    res = chk.run(max_depth=8)
    assert (res.distinct, res.generated, res.depth) == (1505, 3044, 8)
    assert res.level_sizes == (1, 1, 3, 9, 22, 57, 136, 345, 931)
    assert all(chk.redos[k] > 0 for k in ("cap_x", "slab", "cap_m")), chk.redos


def test_handoff_from_reference_mid_run():
    """The reference's level-6 frontier and slab, carried across, expand
    one level on the port exactly as on the reference: n_new, the new
    fingerprints and payloads, the multiplicities and the slab bytes."""
    rc = RefConfig()
    ref = _ref_checker(rc)
    frontiers = []
    orig = ref._materialize_grow

    def spy(*a, **k):
        out = orig(*a, **k)
        frontiers.append(out[0])
        return out

    ref._materialize_grow = spy
    res = ref.run(max_depth=6)
    n_f = res.level_sizes[-1]
    fr_ref = frontiers[-1]
    slab_ref = np.asarray(ref.hstore.slab)
    (n_new, new_fps, new_pay, abort_at, ovf, ovf_g, ovf_h, mult) = ref._expand_level(
        fr_ref, n_f, None
    )
    assert not (ovf or ovf_g or ovf_h) and abort_at >= n_f
    slab2_ref = np.asarray(ref._hs_pending)

    fr = carry.frontier({f: np.asarray(getattr(fr_ref, f))[:n_f] for f in Frontier._fields}, "cpu")
    out = _port(RaftConfig(), cap_x=4096).expand_level(fr, n_f, carry.slab(slab_ref, "cpu"))
    assert not (out["ovf_x"] or out["ovf_h"] or out["ovf_m"])
    assert out["n_new"] == int(n_new) == 345
    assert np.array_equal(carry.slab_to_numpy(out["new_fps"])[:n_new],
                          np.asarray(new_fps)[:n_new])
    assert np.array_equal(out["new_payload"].numpy()[:n_new], np.asarray(new_pay)[:n_new])
    assert np.array_equal(out["mult"], np.asarray(mult))
    assert np.array_equal(carry.slab_to_numpy(out["slab"]), slab2_ref)


# The reference's counterexamples (JaxChecker staged chain), pinned; the
# @slow siblings below re-derive them from the reference.
MEDIAN_BUG = dict(
    result=(False, 2556, 5912, 11, (1, 1, 3, 6, 12, 21, 43, 93, 204, 398, 691, 1083)),
    kind="Invariant Inv is violated",
    sha="bacbf70789c240c765b1b5a4220d64ca33bc919f3232d9814244f10f4632c757",
)
DOUBLE_VOTE = dict(
    result=(False, 359, 707, 8, (1, 1, 3, 6, 12, 22, 44, 90, 180)),
    kind='Assert "split brain" (Raft.tla:185)',
    sha="54144ebf556e93bb8f6c0f2eab315032283bd583ed12112600368de2d9e73662",
)
BUGS = {"median-bug": MEDIAN_BUG, "double-vote": DOUBLE_VOTE}


@pytest.mark.parametrize("mut", sorted(BUGS))
def test_counterexample_matches_pinned_reference(mut):
    want = BUGS[mut]
    res = _port(RaftConfig(3, 1, 2, 0, mutations=(mut,))).run()
    assert (res.ok, res.distinct, res.generated, res.depth, res.level_sizes) == want["result"]
    kind, trace = res.violation
    assert kind == want["kind"]
    assert _sha(trace) == want["sha"]


@pytest.mark.slow
@pytest.mark.parametrize("mut", sorted(BUGS))
def test_counterexample_matches_reference_rerun(mut):
    """Slow sibling of test_counterexample_matches_pinned_reference: the
    reference run itself (about 15 s of JAX compiles per mutation)."""
    ref = _ref_checker(RefConfig(3, 1, 2, 0, mutations=(mut,))).run()
    got = _port(RaftConfig(3, 1, 2, 0, mutations=(mut,))).run()
    assert got[:5] == ref[:5]
    assert got.violation[0] == ref.violation[0]
    assert _sha(got.violation[1]) == _sha(ref.violation[1]) == BUGS[mut]["sha"]


def test_cli_json_line(capsys):
    from tla_raft_tpu_torch import check

    rc = check.main(["--servers", "2", "--vals", "1", "--max-election", "1",
                     "--max-restart", "1", "--device", "cpu", "--chunk", "64",
                     "--coverage", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Model checking completed. No error has been found." in out
    assert "97 states generated, 50 distinct states found, depth 12." in out
    import json

    summary = json.loads(out.strip().splitlines()[-1])
    assert (summary["distinct"], summary["generated"], summary["depth"]) == (50, 97, 12)
    assert summary["level_sizes"] == [1, 1, 1, 1, 1, 3, 6, 9, 9, 7, 6, 4, 1]
    assert summary["violation"] is None


def test_cli_prints_the_trace_on_a_violation(capsys):
    from tla_raft_tpu_torch import check

    rc = check.main(["--servers", "3", "--vals", "1", "--max-election", "2",
                     "--max-restart", "0", "--mutate", "median-bug", "--device", "cpu",
                     "--chunk", "256"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Error: Invariant Inv is violated." in out
    assert "STATE 12: <UpdateTerm(1)>" in out
    assert "5912 states generated, 2556 distinct states found, depth 11." in out
