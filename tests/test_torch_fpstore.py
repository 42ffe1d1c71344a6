"""The external store route (``--fpstore-dir``) of the port against the
reference on the CPU.

The port's native store (its copy of ``native/fpstore.cpp`` and the ctypes
binding) against the reference's on the same seeded streams; B19
``group_unique``'s twin against ``_group_unique_impl``; whole runs of
``TorchChecker(host_store=...)`` against ``JaxChecker(host_store=...)`` at
chunk 32 on (3,2,2,2) to depth 12, whose deepest expanded level spans 92 >
4 * G chunks, chunk by chunk and through the group program
(``span_min_chunk`` lowered): results, the store's size and the delta
records; segment paging under a 1-byte budget with 256-row segments; the
mid-level crash (partials of completed groups, a resume that expands only
the rest) within the port and across the packages both ways; stale and
torn partials; the planted bugs' traces and an orbit run on the store; the
CLI's ``--json`` line against the reference CLI's; the refusals and the
store's RAM budget.  Every output is an integer: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import glob
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import tla_raft_tpu.engine.bfs as ref_bfs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.native import HostFPStore as RefStore
from tla_raft_tpu_torch import check, native
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.native import HostFPStore

from test_torch_engine import BUGS, _sha

REPO = Path(__file__).resolve().parent.parent
KEY = (3, 2, 2, 2)  # level sizes 1, 1, 3, 6, 12, 23, 60, 170, 439, 940, 1721, 2925, 5028
DEPTH = 12
CHUNK = 32
CRASH_LEVEL = 12  # 2,925 parents: 92 chunks, 6 groups of 16
BUDGET = 1 << 12  # the stores' RAM buffer: every run spills sorted runs to disk


def _counts(r) -> tuple:
    return (r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes), r.action_counts)


def _deltas(d) -> dict:
    out = {}
    for f in sorted(glob.glob(os.path.join(str(d), "delta_*.npz"))):
        with np.load(f) as z:
            out[os.path.basename(f)] = {k: z[k].copy() for k in z.files}
    return out


def _same_log(a, b) -> None:
    da, db = _deltas(a), _deltas(b)
    assert sorted(da) == sorted(db) and da
    for name in da:
        assert sorted(da[name]) == sorted(db[name]), name
        for k, v in da[name].items():
            assert v.dtype == db[name][k].dtype and np.array_equal(v, db[name][k]), (name, k)


def _port(d, key=KEY, chunk=CHUNK, **kw) -> TorchChecker:
    return TorchChecker(RaftConfig(*key), device="cpu", chunk=chunk,
                        host_store=HostFPStore(str(d), mem_budget_entries=BUDGET), **kw)


def _ref(d, key=KEY, chunk=CHUNK) -> JaxChecker:
    return JaxChecker(RefConfig(*key), chunk=chunk,
                      host_store=RefStore(str(d), mem_budget_entries=BUDGET))


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's external store run of (3,2,2,2) to depth 12 at chunk
    32, with its delta log."""
    d = tmp_path_factory.mktemp("ref_fpstore")
    chk = _ref(d / "fps")
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(d / "ck"))
    assert -(-res.level_sizes[DEPTH - 1] // CHUNK) > 4 * chk.G  # the many-group shape
    return dict(res=res, entries=len(chk.host_store), runs=chk.host_store.num_runs,
                ck=d / "ck")


# -- the native store -----------------------------------------------------------------


def test_native_store_equals_the_references(tmp_path):
    """The same seeded batches (repeats inside a batch and across batches)
    into both stores with a 4,096-entry buffer: every insert verdict,
    membership answer, count, run count and bloom skip equal; spilled runs
    keep every fingerprint (no false negative); ``compact`` merges them to
    one run in both."""
    mine = HostFPStore(str(tmp_path / "a"), mem_budget_entries=BUDGET)
    ref = RefStore(str(tmp_path / "b"), mem_budget_entries=BUDGET)
    g = np.random.default_rng(7)
    seen = []
    for i in range(24):
        batch = g.integers(0, 1 << 18, 3000).astype(np.uint64) | np.uint64(i % 2 << 63)
        assert np.array_equal(mine.insert(batch), ref.insert(batch))
        seen.append(batch)
        assert (len(mine), mine.num_runs, mine.bloom_skips) == (
            len(ref), ref.num_runs, ref.bloom_skips)
    assert mine.num_runs >= 2
    allv = np.unique(np.concatenate(seen))
    probe = np.concatenate([allv, g.integers(1 << 18, 1 << 20, 5000).astype(np.uint64)])
    assert mine.contains(allv).all() and ref.contains(allv).all()
    assert np.array_equal(mine.contains(probe), ref.contains(probe))
    assert mine.bloom_skips == ref.bloom_skips > 0
    mine.compact()
    ref.compact()
    assert mine.num_runs == ref.num_runs == 1 and len(mine) == len(ref) == len(allv)
    assert np.array_equal(mine.contains(probe), ref.contains(probe))
    mine.clear()
    assert len(mine) == 0 and not glob.glob(str(tmp_path / "a" / "run_*.fp"))
    mine.close()
    ref.close()


def test_native_library_builds_into_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is built under build/native/<digest>/ at the repo root,
    never beside its source; a source g++ refuses raises with g++'s
    output."""
    path = Path(native.build_native())
    assert path.name == "libfpstore.so" and (REPO / "build" / "native") in path.parents
    assert not list(Path(native.__file__).parent.glob("*.so"))
    bad = tmp_path / "fpstore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build") as e:
        native.build_native()
    assert "error" in str(e.value)


# -- B19 group_unique -------------------------------------------------------------------


def _unique_case(name: str, n: int = 3000):
    g = np.random.default_rng(len(name))
    top = np.where(g.random(n) < 0.5, np.uint64(1 << 63), np.uint64(0))
    cv = g.integers(0, 1 << 62, n, dtype=np.uint64) | top
    cf = g.integers(0, 1 << 62, n, dtype=np.uint64) | top[::-1]
    cp = g.permutation(n).astype(np.int64) * 5
    if name == "ties":
        cv = cv[g.integers(0, 40, n)]  # runs of equal fp_view
        cf[g.random(n) < 0.5] = cf[0]  # ties in (fp_view, fp_full): the payload decides
    if name in ("ties", "sent"):
        pad = g.random(n) < 0.3
        cv[pad], cf[pad], cp[pad] = np.uint64(2**64 - 1), np.uint64(2**64 - 1), -1
    if name == "all_sent":
        cv[:], cf[:], cp[:] = np.uint64(2**64 - 1), np.uint64(2**64 - 1), -1
    if name == "one_lane":
        cv, cf, cp = cv[:1], cf[:1], cp[:1]
    return cv, cf, cp


@pytest.mark.parametrize("case", ["sent", "ties", "all_sent", "one_lane"])
def test_group_unique_twin_equals_the_reference(case):
    """``group_unique_plain`` against the reference's ``_group_unique``
    (XLA on the CPU): n_u and the three padded outputs, SENT / -1 tail
    included."""
    import jax.numpy as jnp

    cv, cf, cp = _unique_case(case)
    want = ref_bfs._group_unique(jnp.asarray(cv), jnp.asarray(cf), jnp.asarray(cp))
    got = bfs.group_unique_plain(*(torch.from_numpy(x.view(np.int64).copy())
                                   for x in (cv, cf, cp)))
    assert int(got[0]) == int(want[0])
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b).view(np.int64))


# -- whole runs -------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["chunks", "program"])
def test_host_route_equals_the_reference(ref_run, tmp_path, path):
    """(3,2,2,2) to depth 12 at chunk 32 on the port's external store
    route, chunk by chunk (the reference's per-chunk path at small chunks)
    and through the group program (``span_min_chunk`` lowered to the
    chunk: every full group inside a segment): the result, the store's
    size and every delta record equal the reference's."""
    chk = _port(tmp_path / "fps")
    if path == "program":
        chk.span_min_chunk = CHUNK
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(tmp_path / "ck"))
    assert _counts(res) == _counts(ref_run["res"])
    assert len(chk.host_store) == ref_run["entries"] == res.distinct
    assert chk.host_store.num_runs == ref_run["runs"] >= 1
    _same_log(ref_run["ck"], tmp_path / "ck")
    hs = chk.host_stats
    assert chk.routes["host"] == DEPTH and chk.paged_out == 0
    assert (hs["graph_groups"] > 0) == (path == "program") and hs["chunk_groups"] > 0
    assert not glob.glob(str(tmp_path / "ck" / "partial_*.npz"))


def test_paged_run_equals_the_reference(ref_run, tmp_path, monkeypatch):
    """Segments of 256 rows and a 1-byte budget: every sealed segment pages
    out to host RAM and back, and the result and delta records still equal
    the reference's (fast sibling of
    ``test_paged_run_equals_the_paged_reference``); without a budget the
    same segments never page."""
    monkeypatch.setattr(bfs, "SEG_ROWS", 256)
    chk = _port(tmp_path / "fps")
    chk.dev_budget = 1
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(tmp_path / "ck"))
    assert chk.paged_out > 0 and len(chk.frontier_segs) > 1
    assert _counts(res) == _counts(ref_run["res"])
    _same_log(ref_run["ck"], tmp_path / "ck")
    plain = _port(tmp_path / "fps2")
    assert plain.dev_budget == 0
    assert plain.run(max_depth=10).level_sizes == ref_run["res"].level_sizes[:11]
    assert plain.paged_out == 0 and len(plain.frontier_segs) > 1


@pytest.mark.slow
def test_paged_run_equals_the_paged_reference(tmp_path, monkeypatch):
    """Slow sibling of ``test_paged_run_equals_the_reference``: (3,1,2,0) to
    depth 14 at chunk 64 with 256-row segments and a 1-byte budget in both
    packages (the reference's tests/test_host_paging.py shape): equal
    results, delta records and paged-out segment counts."""
    monkeypatch.setattr(bfs, "SEG_ROWS", 256)
    monkeypatch.setattr(ref_bfs, "SEG_ROWS", 256)
    key = (3, 1, 2, 0)
    ref = _ref(tmp_path / "rfps", key, 64)
    ref.dev_budget = 1
    want = ref.run(max_depth=14, checkpoint_dir=str(tmp_path / "rck"))
    chk = _port(tmp_path / "fps", key, 64)
    chk.dev_budget = 1
    got = chk.run(max_depth=14, checkpoint_dir=str(tmp_path / "ck"))
    assert _counts(got) == _counts(want)
    assert chk.paged_out == ref.paged_out > 0
    _same_log(tmp_path / "rck", tmp_path / "ck")


# -- the mid-level crash -----------------------------------------------------------------


class Crash(RuntimeError):
    pass


def _crash_after_partials(chk, n: int) -> None:
    """``chk`` (either package) raises right after its ``n``-th partial of
    level CRASH_LEVEL is committed: the groups before are saved, the rest of
    the level is not."""
    real, saved = chk._save_partial, []

    def save(ckdir, level, gi, *a):
        real(ckdir, level, gi, *a)
        if level == CRASH_LEVEL:
            saved.append(gi)
            if len(saved) == n:
                raise Crash(f"crashed after partials {saved} of level {level}")

    chk._save_partial = save


def _count_chunks(chk) -> list:
    """The chunk starts ``chk`` expands from here on."""
    real, starts = chk._expand_chunk, []

    def expand(part, start, *a):
        starts.append(int(np.asarray(start)))
        return real(part, start, *a)

    chk._expand_chunk = expand
    return starts


def _crashed_dir(d, maker) -> Path:
    """A checkpoint directory whose run (``maker(dir)``: a checker of either
    package) crashed after two saved groups of level CRASH_LEVEL."""
    chk = maker(d / "fps")
    _crash_after_partials(chk, 2)
    with pytest.raises(Crash):
        chk.run(max_depth=DEPTH, checkpoint_dir=str(d / "ck"))
    names = sorted(os.path.basename(f) for f in glob.glob(str(d / "ck" / "partial_*.npz")))
    assert names == [f"partial_{CRASH_LEVEL:04d}_{g:05d}.npz" for g in (0, 1)]
    return d / "ck"


def _resumed_starts(ref_run, chk, ck) -> None:
    """Resume ``chk`` from ``ck``: only the unsaved groups' chunks of level
    CRASH_LEVEL are expanded (groups 2-5: chunks 32-91; the fresh checker's
    cap_x overflows there and redoes the level, with the groups saved in
    between loaded, as in the reference), the result and the delta records
    equal the uninterrupted reference run's, no partial is left."""
    starts = _count_chunks(chk)
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(ck), resume_from=str(ck))
    assert sorted(set(starts)) == [CHUNK * c for c in range(32, 92)]
    assert _counts(res) == _counts(ref_run["res"])
    assert len(chk.host_store) == res.distinct
    _same_log(ref_run["ck"], ck)
    assert not glob.glob(str(Path(ck) / "partial_*.npz"))


def test_mid_level_crash_resumes_bit_identical(ref_run, tmp_path):
    """The port crashes after two saved groups of level 12; its resume
    replays the log, loads the two partials and expands only the other
    four groups, with the uninterrupted run's records."""
    ck = _crashed_dir(tmp_path, lambda d: _port(d))
    _resumed_starts(ref_run, _port(tmp_path / "fps2"), ck)


def test_partials_and_logs_cross_between_the_packages(ref_run, tmp_path):
    """A reference run crashed mid-level resumes on the port, and a port run
    crashed mid-level resumes on the reference (same chunk and G): each
    loads the other's partials and log and expands only the unsaved
    groups."""
    ref = _ref(tmp_path / "a" / "fps")
    _crash_after_partials(ref, 2)
    with pytest.raises(Crash):
        ref.run(max_depth=DEPTH, checkpoint_dir=str(tmp_path / "a" / "ck"))
    _resumed_starts(ref_run, _port(tmp_path / "a" / "fps2"), tmp_path / "a" / "ck")
    ck = _crashed_dir(tmp_path / "b", lambda d: _port(d))
    ref._save_partial = type(ref)._save_partial.__get__(ref)  # the same compiled checker
    _resumed_starts(ref_run, ref, ck)


def test_stale_and_torn_partials_are_wiped(tmp_path):
    """A partial whose meta does not match the level in flight (another
    chunk) and a torn one are wiped, never loaded: the run equals a run
    without them."""
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(str(ck / "partial_0001_00000.npz"), hv=np.arange(50, dtype=np.uint64),
             hf=np.arange(50, dtype=np.uint64), hp=np.zeros(50, np.int64),
             mult=np.zeros(1, np.int64), meta=np.asarray([1, 0, 999, 4, 16, 1, 1], np.int64))
    (ck / "partial_0002_00099.npz").write_bytes(b"not an npz")
    got = _port(tmp_path / "fps", (2, 1, 1, 1), 8).run(checkpoint_dir=str(ck))
    want = TorchChecker(RaftConfig(2, 1, 1, 1), device="cpu", chunk=8).run()
    assert _counts(got) == _counts(want)
    assert not list(ck.glob("partial_*.npz"))


# -- traces, orbit, the CLI --------------------------------------------------------------


@pytest.mark.parametrize("mut", sorted(BUGS))
def test_planted_bugs_on_the_store_equal_the_pinned_reference(tmp_path, mut):
    """The median-bug (an invariant violation, found post-filter) and the
    double vote (the split-brain abort, before anything reaches the store)
    on the external store route at chunk 32: the reference's pinned
    results and traces (tests/test_torch_engine.py); the slow sibling
    ``test_planted_bugs_on_the_store_equal_the_reference`` reruns the
    reference's store route."""
    want = BUGS[mut]
    res = TorchChecker(RaftConfig(3, 1, 2, 0, mutations=(mut,)), device="cpu", chunk=CHUNK,
                       host_store=HostFPStore(str(tmp_path / "fps"),
                                              mem_budget_entries=256)).run()
    assert (res.ok, res.distinct, res.generated, res.depth, res.level_sizes) == want["result"]
    assert res.violation[0] == want["kind"] and _sha(res.violation[1]) == want["sha"]


@pytest.mark.slow
@pytest.mark.parametrize("mut", sorted(BUGS))
def test_planted_bugs_on_the_store_equal_the_reference(tmp_path, mut):
    """Slow sibling of ``test_planted_bugs_on_the_store_equal_the_pinned_reference``:
    ``JaxChecker(host_store=...)`` itself."""
    ref = JaxChecker(RefConfig(3, 1, 2, 0, mutations=(mut,)), chunk=CHUNK,
                     host_store=RefStore(str(tmp_path / "r"), mem_budget_entries=256)).run()
    got = TorchChecker(RaftConfig(3, 1, 2, 0, mutations=(mut,)), device="cpu", chunk=CHUNK,
                       host_store=HostFPStore(str(tmp_path / "p"), mem_budget_entries=256)).run()
    assert got[:5] == ref[:5] and got.violation[0] == ref.violation[0]
    assert _sha(got.violation[1]) == _sha(ref.violation[1])


def test_orbit_run_on_the_store_equals_the_staged_route(tmp_path, monkeypatch):
    """``TLA_RAFT_ORBIT=1`` on the external store route ((3,1,1,1) to its
    fixpoint at chunk 8 with G = 2: the per-chunk path, as under orbit in
    the reference) against the port's own staged chain under orbit, which
    tests/test_torch_orbit.py holds to the reference: the same result and
    delta records (orbit fingerprints, payload order on both routes).  The
    slow sibling ``test_orbit_run_on_the_store_equals_the_reference`` runs
    the reference's store route itself."""
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
    want = TorchChecker(RaftConfig(3, 1, 1, 1), device="cpu", chunk=8, megakernel=False).run(
        checkpoint_dir=str(tmp_path / "sck"))
    chk = _port(tmp_path / "fps", (3, 1, 1, 1), 8)
    chk.G, chk.span_min_chunk = 2, 8  # orbit keeps the per-chunk path all the same
    got = chk.run(checkpoint_dir=str(tmp_path / "ck"))
    assert chk.orbit and _counts(got) == _counts(want)
    assert chk.host_stats["graph_groups"] == 0 and chk.host_stats["groups"] > got.depth
    _same_log(tmp_path / "sck", tmp_path / "ck")


@pytest.mark.slow
def test_orbit_run_on_the_store_equals_the_reference(tmp_path, monkeypatch):
    """Slow sibling of ``test_orbit_run_on_the_store_equals_the_staged_route``:
    the reference's store route under ``TLA_RAFT_ORBIT=1`` ((3,1,1,1) at
    chunk 8, G = 2): the same result and delta records."""
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
    ref = _ref(tmp_path / "rfps", (3, 1, 1, 1), 8)
    ref.G = 2
    want = ref.run(checkpoint_dir=str(tmp_path / "rck"))
    chk = _port(tmp_path / "fps", (3, 1, 1, 1), 8)
    chk.G, chk.span_min_chunk = 2, 8  # orbit keeps the per-chunk path all the same
    got = chk.run(checkpoint_dir=str(tmp_path / "ck"))
    assert chk.orbit and _counts(got) == _counts(want)
    assert chk.host_stats["graph_groups"] == 0
    _same_log(tmp_path / "rck", tmp_path / "ck")


def _json_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_json_equals_the_reference_cli(tmp_path, capsys):
    """``--fpstore-dir`` on both CLIs: the ``--json`` line's counts, verdict
    and route flags equal the reference's; the port says where the store
    is and reports it."""
    from test_cfgparse import REFERENCE_CFG
    from tla_raft_tpu.check import main as ref_main

    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(REFERENCE_CFG)
    args = ["--config", str(cfg), "--servers", "3", "--vals", "1", "--max-election", "1",
            "--max-restart", "1", "--chunk", "16", "--json", "--warm-bytes", "2048"]
    assert ref_main(args + ["--fpstore-dir", str(tmp_path / "r"), "--log", "-"]) == 0
    want = _json_of(capsys.readouterr().out)
    assert check.main(args + ["--fpstore-dir", str(tmp_path / "p"), "--device", "cpu",
                              "--log", "-"]) == 0
    out = capsys.readouterr().out
    got = _json_of(out)
    keys = ("ok", "distinct", "generated", "depth", "level_sizes", "violation", "mxu",
            "megakernel", "superstep")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert f"Native FP store: {tmp_path / 'p'}" in out
    hs = got["host_store"]
    assert hs["entries"] == got["distinct"] and hs["mem_budget_entries"] == 256
    assert hs["runs"] >= 1 and got["routes"]["host"] == got["depth"]


# -- refusals and settings ---------------------------------------------------------------


def test_segment_settings_the_port_does_not_run_are_refused(tmp_path, monkeypatch, capsys):
    """TLA_RAFT_DEV_BYTES without an external store (the reference's
    segment-streamed fused level) and any TLA_RAFT_FSEG_BYTES (spilled
    segments) are refused, by the engine and by the CLI (exit 2), not
    ignored; TLA_RAFT_DEV_BYTES with a store is the paging budget; a chunk
    past SEG_ROWS is refused with a store."""
    small = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
             "--device", "cpu", "--chunk", "8", "--log", "-"]
    monkeypatch.setenv("TLA_RAFT_DEV_BYTES", "4096")
    with pytest.raises(ValueError, match="ROADMAP A.5"):
        TorchChecker(RaftConfig(2, 1, 1, 1), device="cpu", chunk=8)
    assert check.main(small) == 2 and "ROADMAP A.5" in capsys.readouterr().out
    chk = _port(tmp_path / "a", (2, 1, 1, 1), 8)
    assert chk.dev_budget == 4096
    assert check.main(small + ["--fpstore-dir", str(tmp_path / "b"), "--json"]) == 0
    assert _json_of(capsys.readouterr().out)["host_store"]["dev_budget"] == 4096
    monkeypatch.delenv("TLA_RAFT_DEV_BYTES")
    monkeypatch.setenv("TLA_RAFT_FSEG_BYTES", "1e6")
    with pytest.raises(ValueError, match="TLA_RAFT_FSEG_BYTES"):
        _port(tmp_path / "c", (2, 1, 1, 1), 8)
    assert check.main(small + ["--fpstore-dir", str(tmp_path / "d")]) == 2
    capsys.readouterr()
    monkeypatch.delenv("TLA_RAFT_FSEG_BYTES")
    monkeypatch.setattr(bfs, "SEG_ROWS", 4)
    with pytest.raises(ValueError, match="SEG_ROWS"):
        _port(tmp_path / "e", (2, 1, 1, 1), 8)


def test_dev_bytes_with_the_store_builds_no_tier(tmp_path, capsys):
    """``--dev-bytes`` with ``--fpstore-dir`` and ``--checkpoint-dir`` is
    accepted and builds no tier (the tier needs the hash store, bfs.py:4131);
    without the store the pair is refused (exit 2)."""
    small = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1",
             "--device", "cpu", "--chunk", "8", "--dev-bytes", "8192", "--log", "-",
             "--checkpoint-dir"]
    assert check.main(small + [str(tmp_path / "a")]) == 2
    capsys.readouterr()
    assert check.main(small + [str(tmp_path / "b"), "--fpstore-dir", str(tmp_path / "f"),
                               "--json"]) == 0
    got = _json_of(capsys.readouterr().out)
    assert got["distinct"] == 50 and "tiered" not in got and got["hashstore"] is False


@pytest.mark.parametrize("warm,env,entries", [(4096, None, 512), (None, "800", 100),
                                               (4, None, 1), (None, None, 0)])
def test_warm_bytes_reach_the_store(tmp_path, monkeypatch, warm, env, entries):
    """``--warm-bytes`` / ``TLA_RAFT_WARM_BYTES`` (the argument first) bound
    the store's RAM buffer at ``max(bytes // 8, 1)`` fingerprints; neither
    keeps the native 64 MiB default (0)."""
    if env is None:
        monkeypatch.delenv("TLA_RAFT_WARM_BYTES", raising=False)
    else:
        monkeypatch.setenv("TLA_RAFT_WARM_BYTES", env)
    s = check.run_check(RaftConfig(2, 1, 1, 1), max_depth=3, chunk=8, device="cpu",
                        fpstore_dir=str(tmp_path / "f"), warm_bytes=warm)
    assert s["_chk"].host_store.mem_budget_entries == entries
    assert s["host_store"]["mem_budget_entries"] == entries and s["distinct"] == 4
    shutil.rmtree(tmp_path / "f")
