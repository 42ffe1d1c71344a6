"""The port's async pipeline and forecast prewarm (engine/pipeline.py, the
presize and the prewarm plan of engine/bfs.py) on the CPU, against the
reference (tests/test_pipeline.py and tests/test_forecast.py name each
counterpart).

The window's mechanics (bounded in-flight groups, order, window 0 serial,
``discard``); the ``Prewarmer`` (dedupe, counts, a failing thunk, the
pruning to the newest plan); ``shape_plan``, ``pow2_ladder`` and
``forecast_final_distinct`` against the reference's; whole runs of
``TorchChecker`` with the pipeline off and at windows 2 and 4, on the hash
and the sorted store, and with presize and prewarm on and off, against
``JaxChecker`` on (3,1,2,1) to depth 9 (level sizes, distinct, generated,
action counts and every level's (pidx, slot) records); the plan from the
golden prefix at the reference constants and chunk 16,384 (host only: no
program is built); a small run that crosses supersteps, fused and grouped
levels with the prewarm on; the external store's window (drained at every
store insert; equal records at windows 0, 2 and 4; a ``pipeline.window``
kill mid-window, then ``--recover``).  Every output is an integer:
equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine import forecast as ref_fc
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import forecast as fc
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine import pipeline as gpipe
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.native import HostFPStore
from tla_raft_tpu_torch.ops.hashstore import DeviceHashStore

REPO = Path(__file__).resolve().parent.parent
S3121 = (3, 1, 2, 1)
DEPTH = 9
CHUNK = 256
# the reference constants' level sizes (bench.py GOLDEN_LEVELS[(3,2,3,3)])
GOLDEN = [1, 1, 3, 9, 22, 57, 136, 345, 931, 2468, 5881, 12505, 24705, 47599, 91014, 169607,
          301664, 511609, 839797, 1353766, 2150466, 3350017, 5099018, 7596394, 11125029,
          16077143]


def _counts(r) -> tuple:
    return (r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes), r.action_counts)


# -- the window (tests/test_pipeline.py) ------------------------------------------------


def test_window_bounded_inflight_and_order():
    """``test_window_bounded_inflight_and_order``: five groups at window 2
    leave two open, the three oldest consumed in order; the peak is
    window + 1 (the newest group's copies start before the oldest
    completes)."""
    win = gpipe.AsyncFetchWindow(2)
    done = []
    for i in range(5):
        win.submit([torch.tensor([i])], lambda h, i=i: done.append((i, int(h[0][0]))))
        assert win.inflight <= 2
    assert done == [(0, 0), (1, 1), (2, 2)]
    assert gpipe.AsyncFetchWindow.live == 2
    win.drain()
    assert done == [(i, i) for i in range(5)]
    assert win.inflight == 0 and gpipe.AsyncFetchWindow.live == 0
    assert win.max_inflight == 3 and win.submitted == 5


def test_window_zero_is_serial():
    """``test_window_zero_is_serial``: window 0 consumes at submit."""
    win = gpipe.AsyncFetchWindow(0)
    done = []
    win.submit([torch.tensor([7])], lambda h: done.append(int(h[0][0])))
    assert done == [7] and win.inflight == 0


def test_window_discard_completes_without_consume():
    """``test_window_discard_completes_without_consume``."""
    win = gpipe.AsyncFetchWindow(3)
    done = []
    win.submit([torch.tensor([1])], lambda h: done.append(1))
    win.submit([torch.tensor([2])], lambda h: done.append(2))
    win.discard()
    assert done == [] and win.inflight == 0 and gpipe.AsyncFetchWindow.live == 0


def test_window_reads_are_counted_and_copied():
    """``test_window_fetches_device_arrays``: a group is one counted read of
    all its tensors, returned as numpy arrays; on the CPU the copies are
    made at submit, so a source overwritten after it does not show."""
    from tla_raft_tpu_torch import device

    device.READS.pop("t_window", None)
    win = gpipe.AsyncFetchWindow(1)
    got = {}
    a, b = torch.arange(4), torch.tensor(2.0)
    win.submit([a, b], lambda h: got.update(h=h), what="t_window")
    a.fill_(9)
    win.drain()
    assert list(got["h"][0]) == [0, 1, 2, 3] and float(got["h"][1]) == 2.0
    assert isinstance(got["h"][0], np.ndarray) and device.READS["t_window"] == 1
    d = gpipe.DeferredFetch(True, [torch.tensor([5, 6])], what="t_window")
    assert list(d.get()[0]) == [5, 6] and device.READS["t_window"] == 2


def test_prewarmer_dedupes_counts_and_survives_failures():
    """``test_prewarmer_dedupes_counts_and_survives_failures``."""
    pw = gpipe.Prewarmer()
    ran = []

    def ok(k):
        return lambda: ran.append(k)

    def boom():
        raise RuntimeError("planted")

    assert pw.submit([("a", ok("a")), ("b", ok("b")), ("bad", boom)]) == 3
    assert pw.submit([("a", ok("a")), ("c", ok("c"))]) == 1  # known keys queue nothing
    pw.join(30)
    assert sorted(ran) == ["a", "b", "c"]
    assert pw.n_ok == 3 and pw.n_failed == 1 and pw.failures[0][0] == "bad"
    pw.shutdown()
    assert pw.stopped and pw.submit([("d", ok("d"))]) == 1 and pw.pending == 1
    pw.join(1)
    assert "d" not in ran  # a stopped prewarmer runs nothing more


def test_prewarmer_retains_the_newest_plan():
    """The port's pruning: queued keys the newest plan does not name are
    dropped, and may be queued again by a later plan."""
    import threading

    gate = threading.Event()
    pw = gpipe.Prewarmer()
    ran = []
    pw.submit([("hold", gate.wait), ("x", lambda: ran.append("x")),
               ("y", lambda: ran.append("y"))])
    assert pw.retain(["hold", "y"]) == 1
    assert pw.submit([("x", lambda: ran.append("x2"))]) == 1  # x is unseen again
    gate.set()
    pw.join(30)
    assert ran == ["y", "x2"]
    pw.shutdown()


# -- the forecast (tests/test_forecast.py) ---------------------------------------------------


@pytest.mark.parametrize("d", [6, 9, 14, 20])
def test_shape_plan_and_ladder_equal_the_references(d):
    """The prewarm's rows (``shape_plan``), the capacity steps
    (``pow2_ladder``) and ``forecast_final_distinct``
    (``test_forecast_final_distinct_bounds``) equal the reference's."""
    sizes, distinct = GOLDEN[:d + 1], sum(GOLDEN[:d + 1])
    for tgt in (25, None):
        assert fc.shape_plan(sizes, tgt) == ref_fc.shape_plan(sizes, tgt)
        assert fc.forecast_final_distinct(sizes, distinct, tgt) == \
            ref_fc.forecast_final_distinct(sizes, distinct, tgt)
    for lo, hi in ((0, 1), (4, 4), (4096, 5000), (1 << 20, 3 << 22), (100, 50)):
        assert fc.pow2_ladder(lo, hi) == ref_fc.pow2_ladder(lo, hi)


# -- whole runs against the reference -------------------------------------------------------


def _ref_records(tmp_path_factory, **kw):
    """The reference on (3,1,2,1) to depth 9 at chunk 256: its result and
    every level's (pidx, slot) (its delta records)."""
    chk = JaxChecker(RefConfig(*S3121), chunk=CHUNK, **kw)
    recs = {}

    def spy(ckdir, depth, pidx, slot, fps, mult, n_new):
        recs[depth] = (np.asarray(pidx, np.int64), np.asarray(slot, np.int64))

    chk._save_delta = spy
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(tmp_path_factory.mktemp("ref")))
    return res, [recs[d] for d in sorted(recs)]


@pytest.fixture(scope="module")
def ref_hash(tmp_path_factory):
    return _ref_records(tmp_path_factory)


@pytest.fixture(scope="module")
def ref_sorted(tmp_path_factory):
    return _ref_records(tmp_path_factory, use_hashstore=False)


def _same_records(chk, ref_recs) -> None:
    assert len(chk.trace_levels) == len(ref_recs) == DEPTH
    for (p, s), (rp, rs) in zip(chk.trace_levels, ref_recs):
        assert np.array_equal(np.asarray(p, np.int64), rp)
        assert np.array_equal(np.asarray(s, np.int64), rs)


@pytest.mark.parametrize("store", ["hash", "sorted"])
@pytest.mark.parametrize("pipe", [dict(pipeline=False), dict(pipeline_window=2),
                                  dict(pipeline_window=4)], ids=["off", "w2", "w4"])
def test_pipelined_runs_equal_the_reference(ref_hash, ref_sorted, store, pipe):
    """``test_engine_parity_3121_prefix_pipelined``: the pipeline off, at
    window 2 and at window 4, on both stores: the reference's result and
    records."""
    ref, recs = ref_hash if store == "hash" else ref_sorted
    chk = TorchChecker(RaftConfig(*S3121), device="cpu", chunk=CHUNK,
                       use_hashstore=store == "hash", **pipe)
    assert chk.pipeline == ("pipeline_window" in pipe)
    got = chk.run(max_depth=DEPTH)
    assert _counts(got) == _counts(ref)
    _same_records(chk, recs)
    if store == "hash":
        assert chk.routes["superstep"] > 0


@pytest.mark.parametrize("store", ["hash", "sorted"])
@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_presize_and_prewarm_equal_the_reference(ref_hash, ref_sorted, tmp_path_factory,
                                                 monkeypatch, store, on):
    """``test_jax_checker_presize_parity``: presize and prewarm on against
    off, on both stores: the same counts and records, and (presize on) the
    same as ``JaxChecker`` with ``TLA_RAFT_PRESIZE=1``."""
    ref, recs = ref_hash if store == "hash" else ref_sorted
    chk = TorchChecker(RaftConfig(*S3121), device="cpu", chunk=CHUNK,
                       use_hashstore=store == "hash", presize=on, prewarm=on)
    got = chk.run(max_depth=DEPTH)
    assert _counts(got) == _counts(ref)
    _same_records(chk, recs)
    st = chk.pipeline_stats()
    assert st["failed"] == 0 and (st["thunks"] > 0) == (on and store == "hash")
    if on and store == "hash":
        assert chk.presize_log and chk._presize_entries > 0
        # one reserve to the forecast's entries: the level-by-level grows are gone
        assert chk.hstore.cap >= 2 * got.distinct
    if on and store == "sorted":
        assert chk.visited.shape[0] >= chk._presize_vcap > 0
        monkeypatch.setenv("TLA_RAFT_PRESIZE", "1")
        ref_on = JaxChecker(RefConfig(*S3121), chunk=CHUNK, use_hashstore=False)
        assert _counts(ref_on.run(max_depth=DEPTH)) == _counts(got)
        assert ref_on._presize_vcap == chk._presize_vcap
        assert ref_on._presize_merge == chk._presize_merge


def test_the_plan_names_the_captured_shapes():
    """Host only, the reference constants at chunk 16,384: the plans from
    each golden prefix past ``MIN_LEVELS`` name every program shape the
    card's depth-25 run captured (PERF.md §5; the superstep capacities
    65,536, 393,216, 786,432 and 4,194,304, the fused level out of the
    4,194,304-row window, the grouped levels of 24, 32 and 48 groups)
    except the fused level at 393,216, which a stopped window forced."""
    chk = TorchChecker(RaftConfig(), device="cpu", chunk=16384, prewarm=True, presize=True)
    chk.hstore = DeviceHashStore(1 << 12, 0, "cpu")

    class Rows:  # the plan reads a frontier's row count only
        def __init__(self, n):
            self.voted_for = torch.zeros((n,))

    named = set()
    cap = chk.chunk
    for d in range(fc.MIN_LEVELS, 25):
        plan = chk._prewarm_plan(GOLDEN[:d + 1], 25, Rows(cap))
        keys = [k[:-9] for k, _t in plan]  # the signature's nine fields off
        assert all(callable(t) for _k, t in plan)
        named.update(k[:2] for k in keys)
        first = [k for k in keys if k[0] in ("superstep", "level")]
        if first:
            cap = first[0][1]  # the next plan reads from the window's buffer
    want = {("superstep", c) for c in (65536, 393216, 786432, 4194304)}
    want |= {("level", 4194304)} | {("group", g) for g in (24, 32, 48)}
    assert want <= named, sorted(want - named)


def test_prewarmed_run_hits_and_names_its_misses():
    """A small run that crosses supersteps, fused and grouped levels (chunk
    16, G = 2) with the prewarm on: some programs are prewarm hits, and
    every program the main thread requests after the first plan is a hit,
    one it used before, or logged as a miss ("planned" or "unplanned");
    the counts are the prewarm-off run's."""
    cfg = RaftConfig(*S3121)

    def make(on):
        chk = TorchChecker(cfg, device="cpu", chunk=16, prewarm=on, presize=on)
        chk.G, chk.cap_g = 2, chk.cap_x
        return chk

    off = make(False)
    want = off.run(max_depth=12)
    chk = make(True)
    cache = chk._progs
    real_get, requests = cache.get, []

    def get(key, build, planned=None):
        state = ("hit" if key in cache.fresh else "cached" if key in cache.progs else "built")
        n_miss = len(cache.misses)
        prog = real_get(key, build, planned)
        requests.append((state, planned is not None, len(cache.misses) - n_miss))
        return prog

    cache.get = get
    got = chk.run(max_depth=12)
    assert _counts(got) == _counts(want)
    assert all(chk.routes[r] > 0 for r in ("superstep", "fused", "grouped"))
    st = chk.pipeline_stats()
    assert st["hits"] > 0 and st["failed"] == 0 and st["thunks"] > 0
    for state, after_plan, logged in requests:
        if after_plan and state == "built":
            assert logged == 1
        else:
            assert logged == 0
    assert all(how in ("planned", "unplanned") for _k, how in cache.misses)
    assert st["hits"] == sum(1 for s, _a, _l in requests if s == "hit")


def test_program_cache_keeps_fresh_programs_and_drops_stale_ones():
    """The cache's prewarm side: a prewarmed program survives the LRU until
    its first use; a stale one is never filed; ``drop_stale`` and
    ``retain_fresh`` count what they drop as wasted."""

    class Prog:
        device = torch.device("cpu")
        graph = None

        def __init__(self, key):
            self.key = key

        def capture(self, thread):
            return True  # as a program's on the CPU

        def nbytes(self):
            return 0

        def release(self):
            pass

    cache = mk.ProgramCache()
    sig = ("s",)
    cache.drop_stale(sig)
    assert cache.prewarm(("p",) + sig, lambda: Prog(("p",) + sig))
    assert not cache.prewarm(("p",) + sig, lambda: Prog(("p",) + sig))  # cached: skipped
    assert not cache.prewarm(("q", "old"), lambda: Prog(("q", "old")))  # stale: not built
    for i in range(mk._PROG_CACHE_MAX + 4):
        cache.get((i,) + sig, lambda i=i: Prog((i,) + sig))
    assert ("p",) + sig in cache.progs and len(cache.progs) == mk._PROG_CACHE_MAX
    assert (0,) + sig not in cache.progs  # the oldest used one went instead
    cache.get(("p",) + sig, lambda: Prog(None), planned=set())
    assert cache.stats["prewarm_hits"] == 1 and not cache.fresh
    assert cache.prewarm(("r",) + sig, lambda: Prog(("r",) + sig))
    cache.retain_fresh([])
    assert ("r",) + sig not in cache.progs and cache.stats["prewarm_wasted"] == 1
    assert cache.prewarm(("t",) + sig, lambda: Prog(("t",) + sig))
    cache.drop_stale(("new",))
    assert not cache.progs and cache.stats["prewarm_wasted"] == 2
    cache.get(("u", "new"), lambda: Prog(("u", "new")), planned={("u",)})
    assert cache.misses == [(("u",), "planned")]


# -- the external store's window --------------------------------------------------------------


HOST_KEY = (3, 1, 1, 1)  # 545 distinct, depth 19
HOST_CHUNK = 4


def _host_run(d, window, **kw):
    chk = TorchChecker(RaftConfig(*HOST_KEY), device="cpu", chunk=HOST_CHUNK,
                       host_store=HostFPStore(str(d)), pipeline=window > 0,
                       pipeline_window=window, **kw)
    chk.G, chk.span_min_chunk = 2, HOST_CHUNK  # many groups, through the group program
    return chk


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
        for k, v in da[name].items():
            assert np.array_equal(v, db[name][k]), (name, k)


def test_window_drains_before_store_insert(tmp_path, monkeypatch):
    """``test_window_drains_before_store_insert`` and
    ``test_engine_parity_hosted_pipelined``: no store insert runs with a
    group in flight, and windows 0, 2 and 4 give the same result and delta
    records."""
    seen = []
    real_insert = HostFPStore.insert

    def checked_insert(self, fps):
        seen.append(gpipe.AsyncFetchWindow.live)
        return real_insert(self, fps)

    monkeypatch.setattr(HostFPStore, "insert", checked_insert)
    results = []
    for w in (0, 2, 4):
        chk = _host_run(tmp_path / f"fps{w}", w)
        res = chk.run(checkpoint_dir=str(tmp_path / f"ck{w}"))
        assert chk.host_stats["graph_groups"] > 0 and chk.host_stats["groups"] > 40
        results.append(_counts(res))
    assert results[0] == results[1] == results[2]
    assert results[0][1:4] == (545, 2028, 19)
    assert seen and set(seen) == {0}, f"an insert ran with the window open: {seen}"
    _same_log(tmp_path / "ck0", tmp_path / "ck2")
    _same_log(tmp_path / "ck0", tmp_path / "ck4")


def _run_cli(args, fault=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TLA_RAFT_FAULT", None)
    if fault is not None:
        env["TLA_RAFT_FAULT"] = fault
    return subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.check", *args, "--log", "-"],
                          env=env,
                          capture_output=True, text=True, timeout=timeout, cwd=str(REPO))


def test_kill_mid_window_resumes_to_the_same_records(tmp_path):
    """``test_crash_mid_window_recovers_bit_identical``: SIGKILL at a
    ``pipeline.window`` submit in the middle of a level (some of its
    groups' partials saved, a window of groups launched and not read),
    then ``--recover``: the uninterrupted run's result and delta records."""
    # chunk 1: level 14's 73 parents are 5 groups of 16, its reads the
    # window's submits 29-33; the kill at 32 leaves group 0 saved, groups 1
    # and 2 launched and open
    common = ["--servers", "3", "--vals", "1", "--max-election", "1", "--max-restart", "1",
              "--device", "cpu", "--chunk", "1", "--pipeline-window", "2", "--json"]
    clean = _run_cli(common + ["--fpstore-dir", str(tmp_path / "fa"),
                               "--checkpoint-dir", str(tmp_path / "ca")])
    assert clean.returncode == 0, clean.stderr[-2000:]
    ck = str(tmp_path / "ck")
    args = common + ["--fpstore-dir", str(tmp_path / "fb"), "--checkpoint-dir", ck]
    killed = _run_cli(args, fault="pipeline.window:kill@32")
    assert killed.returncode != 0, "the planted kill never fired"
    assert glob.glob(os.path.join(ck, "partial_*.npz")), "the kill landed between levels"
    rec = _run_cli(args + ["--recover", ck])
    assert rec.returncode == 0, rec.stdout[-2000:] + rec.stderr[-2000:]
    got = json.loads(rec.stdout.strip().splitlines()[-1])
    want = json.loads(clean.stdout.strip().splitlines()[-1])
    assert (got["distinct"], got["generated"], got["depth"], got["level_sizes"]) == \
        (want["distinct"], want["generated"], want["depth"], want["level_sizes"]) == \
        (545, 2028, 19, want["level_sizes"])
    _same_log(tmp_path / "ca", ck)
    assert not glob.glob(os.path.join(ck, "partial_*.npz"))
