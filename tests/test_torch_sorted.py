"""The sorted visited store against the reference on the CPU: B19's
``_group_filter``, ``_level_dedup`` and ``_merge_sorted`` (the port's
``group_filter``, ``level_dedup`` and ``merge_sorted`` twins, which the
kernels of csrc/sortstore.cu are held to on the card), whole runs of
``TorchChecker(use_hashstore=False)`` against ``JaxChecker(use_hashstore=
False)`` (counts, level sizes, action counts, every level's (pidx, slot)
records in the sorted path's fp_view order, the store at every merge and
at the end), a grouped level with G lowered, the planted bugs' stop points
and traces, the orbit, ``canon="expand"`` and legacy arms, and the
mid-run fallback from the hash slab when a grow fails
(``hashstore.grow:fail``) on every arm.  Inputs are seeded numpy arrays
handed to both packages; every output is an integer, so equality is
exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import hashlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tla_raft_tpu.engine.bfs as ref_bfs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch import kernels
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.resilience import faults

from redesign_cases import DEDUP_KINDS, dedup_case
from test_torch_engine import _sha

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
TOP = np.uint64(1 << 63)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _j(a: np.ndarray):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def lanes():
    """A sorted store (half its values with the top bit set, SENT pads at
    its end) and a level's lanes: repeated fp_view with other (fp_full,
    payload), hits on the store's first, last and middle slots, SENT pads
    (fp_full SENT, payload -1), top-bit fp_full values."""
    g = np.random.default_rng(11)
    vals = np.unique(g.integers(0, 1 << 63, 700, dtype=np.uint64) | (g.random(700) < 0.5) * TOP)
    store = np.concatenate([vals, np.full(64, SENT)])
    n = 6000
    cv = g.integers(0, 1 << 63, n, dtype=np.uint64) | (g.random(n) < 0.5) * TOP
    dup = g.random(n) < 0.5
    cv[dup] = cv[g.integers(0, n, int(dup.sum()))]
    hit = g.random(n) < 0.2
    cv[hit] = vals[g.integers(0, len(vals), int(hit.sum()))]
    cv[:3] = vals[0], vals[-1], vals[len(vals) // 2]
    cf = g.integers(0, 1 << 63, n, dtype=np.uint64) | (g.random(n) < 0.5) * TOP
    cf[g.random(n) < 0.3] = cf[5]  # ties on fp_full: the payload decides
    cp = (g.permutation(n) * 5).astype(np.int64)
    pad = g.random(n) < 0.1
    cv[pad], cf[pad], cp[pad] = SENT, SENT, -1
    return store, cv, cf, cp


def test_sorted_member_equals_reference(lanes):
    store, cv, _cf, _cp = lanes
    pos = np.asarray(jnp.searchsorted(_j(store), _j(cv)))
    want = store[np.clip(pos, 0, len(store) - 1)] == cv  # bfs.py:368-369
    got = bfs.member_plain(_t(store), _t(cv)).numpy()
    assert 0 < want.sum() < len(cv) and np.array_equal(got, want)
    assert got[:3].all()  # the first, last and a middle slot


@pytest.mark.parametrize("width", [6000, 4096], ids=["lanes", "prefix"])
def test_level_dedup_equals_reference(lanes, width):
    store, cv, cf, cp = (x[:width] if x is not lanes[0] else x for x in lanes)
    n_w, fps_w, pay_w = ref_bfs._level_dedup(_j(cv), _j(cf), _j(cp), _j(store))
    n_g, fps_g, pay_g = bfs.level_dedup(_t(cv), _t(cf), _t(cp), _t(store))
    assert int(n_g) == int(n_w) > 0
    assert np.array_equal(_u(fps_g), np.asarray(fps_w))
    assert np.array_equal(pay_g.numpy(), np.asarray(pay_w))
    # fp_view ascending as unsigned, top-bit values past the others
    live = _u(fps_g)[: int(n_g)]
    assert (np.diff(live.astype(object)) > 0).all() and (live >= TOP).any()


@pytest.mark.parametrize("cap_g", [6000, 2048], ids=["fits", "overflows"])
def test_group_filter_equals_reference(lanes, cap_g):
    store, cv, cf, cp = lanes
    want = ref_bfs._group_filter(_j(cv), _j(cf), _j(cp), _j(store), cap_g)
    got = bfs.group_filter(_t(cv), _t(cf), _t(cp), _t(store), cap_g)
    assert np.array_equal(_u(got[0]), np.asarray(want[0]))
    assert np.array_equal(_u(got[1]), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[3]) == bool(want[3]) == (cap_g == 2048)


def test_merge_sorted_equals_reference(lanes):
    """The level's survivors into the store: the reference sorts the
    concatenation, the port merges two sorted arrays; trimmed as the run
    trims it."""
    store, cv, cf, cp = lanes
    _n, fps, _pay = ref_bfs._level_dedup(_j(cv), _j(cf), _j(cp), _j(store))
    want = np.asarray(ref_bfs._merge_sorted(_j(store), fps))
    for n_out in (len(want), ref_bfs._cap4(len(store) - 64 + int(_n) + 1) // 2, 0):
        got = bfs.merge_sorted(_t(store), _t(np.asarray(fps)), n_out)
        assert np.array_equal(_u(got), want[:n_out])


# -- the level dedup's route on the card, as a model --------------------------------


def _onesweep_pass(keys, lanes, shift, first, tile, warp):
    """One stable pass of ``level_dedup``'s radix sort as its kernel makes
    it: tiles of ``tile`` pairs in order, each warp's ``warp`` contiguous
    pairs ranked in lane order among their digit, a pair placed at its
    digit's first position (``first``, from the up-front histogram) + the
    earlier tiles' count of the digit (the look-back's sum) + the earlier
    warps' + its rank."""
    dg = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    out_k, out_l = np.empty_like(keys), np.empty_like(lanes)
    earlier = np.zeros(256, np.int64)
    for t0 in range(0, keys.shape[0], tile):
        d = dg[t0:t0 + tile]
        ranks = np.empty(d.shape[0], np.int64)
        counts = []
        for w0 in range(0, d.shape[0], warp):
            seen = np.zeros(256, np.int64)
            for j, x in enumerate(d[w0:w0 + warp]):
                ranks[w0 + j] = seen[x]
                seen[x] += 1
            counts.append(seen)
        wc = np.array(counts)
        before = np.cumsum(wc, 0) - wc
        pos = first[d] + earlier[d] + before[np.arange(d.shape[0]) // warp, d] + ranks
        out_k[pos] = keys[t0:t0 + tile]
        out_l[pos] = lanes[t0:t0 + tile]
        earlier += wc.sum(0)
    return out_k, out_l


def _level_dedup_model(cv, cf, cp, store, tile=64, warp=16):
    """``level_dedup``'s route in numpy: (a) the live lanes (fp_view not
    SENT) in lane order; (b) 8 stable passes by fp_view's 8-bit digits, the
    digit offsets of every pass from one histogram; (c) at the head of each
    run of equal views not in the store, the run's least (fp_full
    unsigned, payload signed) pair's payload; (d) the survivors packed in
    view order, padded SENT and -1."""
    n = cv.shape[0]
    lanes = np.flatnonzero(cv != SENT).astype(np.int64)
    keys = cv[lanes]
    hist = [np.bincount(((keys >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64),
                        minlength=256) for d in range(8)]
    for d in range(8):
        keys, lanes = _onesweep_pass(keys, lanes, 8 * d, np.cumsum(hist[d]) - hist[d], tile,
                                     warp)
    assert (keys[1:] >= keys[:-1]).all()
    head = np.ones(keys.shape[0], bool)
    head[1:] = keys[1:] != keys[:-1]
    pos = np.clip(np.searchsorted(store, keys), 0, store.shape[0] - 1)
    keep = head & (store[pos] != keys)
    run = np.cumsum(head) - 1
    order = np.lexsort((cp[lanes], cf[lanes], run))  # each run's least pair first
    least = np.empty(int(head.sum()), np.int64)
    first = np.ones(order.shape[0], bool)
    first[1:] = run[order][1:] != run[order][:-1]
    least[run[order][first]] = cp[lanes][order][first]
    m = int(keep.sum())
    fps = np.full(n, SENT)
    pay = np.full(n, -1, np.int64)
    fps[:m] = keys[keep]
    pay[:m] = least[run[keep]]
    return m, fps, pay


@pytest.mark.parametrize("kind", DEDUP_KINDS)
def test_level_dedup_route_equals_reference(kind):
    """The model of ``level_dedup``'s kernel route (live lanes, a one-sweep
    radix sort by fp_view alone, each run's least pair, the store, the
    pack) equals the reference's jitted ``_level_dedup`` and the port's
    twin, on seeded lanes of each edge kind (runs past a 4,096-lane tile,
    ties on fp_full with payloads of both signs, top-bit views, an empty
    store, a store hitting every head, all SENT)."""
    store, cv, cf, cp = dedup_case(kind, 9000, DEDUP_KINDS.index(kind))
    n_w, fps_w, pay_w = ref_bfs._level_dedup(_j(cv), _j(cf), _j(cp), _j(store))
    m, fps, pay = _level_dedup_model(cv, cf, cp.astype(np.int64), store)
    assert m == int(n_w)
    assert np.array_equal(fps, np.asarray(fps_w)) and np.array_equal(pay, np.asarray(pay_w))
    n_g, fps_g, pay_g = bfs.level_dedup(_t(cv), _t(cf), _t(cp), _t(store))
    assert int(n_g) == m and np.array_equal(_u(fps_g), fps) and np.array_equal(pay_g.numpy(), pay)
    live = int((cv != SENT).sum())
    if kind == "all_sent":
        assert m == 0 and live == 0
    elif kind == "store_every_head":
        assert m == 0 and live > 0
    elif kind == "long_runs":
        assert m > 0 and np.bincount(np.unique(cv, return_inverse=True)[1]).max() > 4096
    else:
        assert m > 0
    if kind == "signed_ties":
        assert (pay[:m] < 0).any() and (pay[:m] >= 0).any()


# -- whole runs ------------------------------------------------------------------------


def _ref_sorted_run(cfg, tmp_path, g=None, use_hashstore=False, **kw):
    """The reference on the sorted store (from the root, or from its
    degrade with ``use_hashstore=True``): (result, {level: (pidx, slot)}
    from its delta records, [(store, new fps)] at every merge, the final
    store)."""
    chk = JaxChecker(cfg, use_hashstore=use_hashstore, **kw)
    if g is not None:
        chk.G = g
        chk.cap_g = chk.G * chk.cap_x // 2
    recs, merges, outs = {}, [], []

    def spy_delta(ckdir, depth, pidx, slot, fps, mult, n_new):
        recs[depth] = (np.asarray(pidx, np.int64), np.asarray(slot, np.int64))

    real = ref_bfs._merge_sorted

    def spy_merge(visited, new_fps):
        merges.append((np.asarray(visited), np.asarray(new_fps)))
        outs.append(real(visited, new_fps))
        return outs[-1]

    chk._save_delta = spy_delta
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_bfs, "_merge_sorted", spy_merge)
        res = chk.run(checkpoint_dir=str(tmp_path))
    final = np.asarray(outs[-1])[: ref_bfs._cap4(res.distinct + 1)]
    return res, recs, merges, final


def _port_sorted(cfg, g=None, use_hashstore=False, **kw):
    """The port on the sorted store (from the root, or from its degrade
    with ``use_hashstore=True``): (checker, result, [(store, new fps)] at
    every merge)."""
    chk = TorchChecker(cfg, device="cpu", use_hashstore=use_hashstore, **kw)
    if g is not None:
        chk.G = g
        chk.cap_g = chk.G * chk.cap_x // 2
    merges = []
    real = bfs.merge_sorted

    def spy(visited, new_fps, n_out):
        merges.append((_u(visited).copy(), _u(new_fps).copy()))
        return real(visited, new_fps, n_out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bfs, "merge_sorted", spy)
        res = chk.run()
    return chk, res, merges


def _same_records(chk, recs) -> None:
    assert sorted(recs) == list(range(1, len(recs) + 1))
    for d, (rp, rs) in recs.items():
        p, s = chk.trace_levels[d - 1]
        assert np.array_equal(np.asarray(p, np.int64), rp)
        assert np.array_equal(np.asarray(s, np.int64), rs)


@pytest.mark.parametrize("args,gold", [((2, 1, 1, 1), (50, 97, 12)),
                                       ((3, 1, 1, 1), (545, 2028, 19))], ids=["s2", "s3v1"])
def test_sorted_run_equals_reference(args, gold, tmp_path):
    """To the fixpoint: the result, every level's records (fp_view order,
    not payload order: the next frontier's rows are the survivors in
    sorted order), the store at every merge and the final store."""
    ref, recs, ref_merges, ref_final = _ref_sorted_run(RefConfig(*args), tmp_path, chunk=64)
    chk, got, merges = _port_sorted(RaftConfig(*args), chunk=64)
    assert (got.distinct, got.generated, got.depth) == gold
    assert got == ref  # ok, counts, level sizes, no violation, action counts
    assert not chk.use_hashstore and chk.hstore is None
    assert not chk.megakernel and chk.superstep_span == 1 and chk.routes["staged"] == got.depth
    _same_records(chk, recs)
    assert len(merges) == len(ref_merges) == got.depth
    for (v, f), (rv, rf) in zip(merges, ref_merges):
        assert np.array_equal(v, rv) and np.array_equal(f, rf)
    assert np.array_equal(_u(chk.visited), ref_final)
    assert int((chk.visited != -1).sum()) == got.distinct


# the reference's sorted store on (3,1,2,0) with a planted bug, chunk 8 and
# G = 1 (levels past 16 chunks, 128 parents, run grouped): its result, the
# sha256 of its counterexample (test_torch_engine._sha) and of its levels'
# (pidx, slot) records, levels 1-10 (the violating level has none); from
# JaxChecker(cfg, chunk=8, use_hashstore=False) with G lowered, on the CPU
SORTED_BUGS = {
    "median-bug": dict(
        result=(False, 2556, 5912, 11, (1, 1, 3, 6, 12, 21, 43, 93, 204, 398, 691, 1083)),
        kind="Invariant Inv is violated",
        sha="cdb66020ff8b31aad26ddff9712e66bdbd3336296f3812f7b1589e793ef051fd",
        records="e4a44d5a0167399c47eee617c9d038178454038221f30b14fd260ea97102edcc"),
}


def _records_sha(levels) -> str:
    h = hashlib.sha256()
    for p, s in levels:
        h.update(np.asarray(p, np.int64).tobytes())
        h.update(np.asarray(s, np.int64).tobytes())
    return h.hexdigest()


def _grouped_bug_run(mut):
    return _port_sorted(RaftConfig(3, 1, 2, 0, mutations=(mut,)), g=1, chunk=8)


def test_grouped_sorted_run_equals_pinned_reference():
    """The median-bug violation on the sorted store with grouped levels
    (9-11; each group filtered by ``group_filter`` against the store, the
    level's lanes deduped by ``level_dedup``): the reference's pinned
    stop, trace and records.  The reference re-run is the slow sibling
    test_grouped_sorted_pins_match_reference."""
    want = SORTED_BUGS["median-bug"]
    chk, res, _merges = _grouped_bug_run("median-bug")
    assert (res.ok, res.distinct, res.generated, res.depth, res.level_sizes) == want["result"]
    assert res.violation[0] == want["kind"] and _sha(res.violation[1]) == want["sha"]
    assert _records_sha(chk.trace_levels[:10]) == want["records"]
    assert chk.routes["grouped"] == 3 and chk.routes["staged"] == 8


@pytest.mark.slow
def test_grouped_sorted_pins_match_reference(tmp_path):
    """Slow sibling of test_grouped_sorted_run_equals_pinned_reference: the
    reference run itself (about 35 s at chunk 8), against the pins and
    against the port level by level, stores included."""
    want = SORTED_BUGS["median-bug"]
    cfg = RefConfig(3, 1, 2, 0, mutations=("median-bug",))
    ref, recs, ref_merges, _final = _ref_sorted_run(cfg, tmp_path, g=1, chunk=8)
    assert ref[:5] == want["result"] and ref.violation[0] == want["kind"]
    assert _sha(ref.violation[1]) == want["sha"]
    assert _records_sha(recs[d] for d in sorted(recs)) == want["records"]
    chk, got, merges = _grouped_bug_run("median-bug")
    assert got[:5] == ref[:5] and _sha(got.violation[1]) == _sha(ref.violation[1])
    _same_records(chk, recs)
    for (v, f), (rv, rf) in zip(merges, ref_merges):
        assert np.array_equal(v, rv) and np.array_equal(f, rf)


@pytest.fixture(scope="module")
def s2_ref(tmp_path_factory):
    """The reference's sorted-store run of (2,1,1,1) to its fixpoint."""
    return _ref_sorted_run(RefConfig(2, 1, 1, 1), tmp_path_factory.mktemp("s2"), chunk=64)


@pytest.mark.parametrize("arm", ["orbit", "expand", "legacy"])
def test_sorted_arms_equal_reference(arm, s2_ref, tmp_path, monkeypatch):
    """One (2,1,1,1) run a cross-check arm on the sorted store.  The canon
    and legacy arms fingerprint as K3 does: the reference's default sorted
    run's result, records and final store.  Orbit pruning fingerprints by
    the canonical relabel, so the store's values and with them the sorted
    frontier order differ: it is held against the reference's own sorted
    run under ``TLA_RAFT_ORBIT=1``."""
    kw = dict(orbit={"orbit": True}, expand={"canon": "expand"}, legacy={"use_mxu": False})[arm]
    if arm == "orbit":
        monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
        ref, recs, _merges, ref_final = _ref_sorted_run(RefConfig(2, 1, 1, 1), tmp_path,
                                                        chunk=64)
        assert not np.array_equal(ref_final, s2_ref[3])  # other fingerprint values
    else:
        ref, recs, _merges, ref_final = s2_ref
    chk, got, _m = _port_sorted(RaftConfig(2, 1, 1, 1), chunk=64, **kw)
    assert got == ref
    _same_records(chk, recs)
    assert np.array_equal(_u(chk.visited), ref_final)


# -- the grow-failure fallback (bfs.py:3369) ----------------------------------------------


DRILL_SITES = dict(staged="between levels", staged_redo="staged", grouped_redo="grouped",
                   fused="fused", superstep_stop="superstep", superstep_reserve="superstep",
                   tiered="between levels")


@pytest.mark.parametrize("arm", sorted(DRILL_SITES))
def test_grow_failure_degrades_to_the_sorted_store(arm, monkeypatch):
    """``hashstore.grow:fail@1`` with the slab floor at 16 slots, so that
    small runs grow (reference tests/test_resilience.py:325,
    tests/test_megakernel.py:134).  A slab grow fails on each arm: the
    first one between levels on the staged chain, in the staged and in the
    grouped chain's slab redo (the between-level grow held off, so the slab
    overflows inside the level; the grouped arm at chunk 4 with G = 1,
    armed at its first grouped level), in the fused level's slab redo (held
    off likewise), in a stopped superstep's slab redo, in a superstep's
    reserve of its span's room (on (3,1,1,1)), and under a device budget
    (``--dev-bytes``) the first one after a generation was demoted (every
    level grows, so that one comes): the sorted store takes the slab's and
    every generation's fingerprints.  The run carries on from the sorted
    store to the result of a run that never degraded; the fused level, the
    supersteps and the captured programs are gone, and every level after
    the degrade runs staged (or grouped, past 16 * G chunks).  Everything
    of the hash store -- the failing grow's slab, the programs, the tiers,
    the sieve's device copy, the representative's scratch -- is released
    before the sorted store is allocated."""
    big = arm in ("superstep_reserve", "tiered", "grouped_redo")
    cfg = RaftConfig(3, 1, 1, 1) if big else RaftConfig(2, 1, 1, 1)
    want = TorchChecker(cfg, device="cpu", chunk=64, megakernel=False).run()
    kw = dict(staged=dict(megakernel=False), staged_redo=dict(megakernel=False),
              grouped_redo=dict(megakernel=False), fused=dict(superstep=1), superstep_stop={},
              superstep_reserve={}, tiered=dict(megakernel=False, store_bytes=2048))[arm]
    monkeypatch.setattr(hs, "MIN_CAP", 16)
    if arm in ("fused", "tiered", "staged_redo", "grouped_redo"):
        monkeypatch.setattr(hs.DeviceHashStore, "need_grow",
                            lambda self, extra=0: arm == "tiered")
    routes = []
    chk = TorchChecker(cfg, device="cpu", chunk=4 if arm == "grouped_redo" else 64,
                       progress=lambda s: routes.append(s["route"]), **kw)
    # the failing grow's slab, and what is still alive when the sorted
    # store is allocated: on a full card the upload must not need both
    slabs, at_upload = [], []
    real_grow, real_upload = hs.DeviceHashStore.grow, bfs.upload_sorted_store

    def grow(self, *a, **k):
        slabs.append(weakref.ref(self.slab))
        return real_grow(self, *a, **k)

    def upload(*a):
        at_upload.append(dict(slab=slabs[-1]() is not None, hstore=chk.hstore is not None,
                              progs=bool(chk._progs.progs), tiered=chk.tiered is not None,
                              sieve=chk._sieve_dev is not None, scratch=bool(kernels._SCRATCH)))
        return real_upload(*a)

    monkeypatch.setattr(hs.DeviceHashStore, "grow", grow)
    monkeypatch.setattr(bfs, "upload_sorted_store", upload)
    demoted = []
    if arm == "tiered":
        real = chk._demote_generation

        def demote(*a, **k):
            real(*a, **k)
            if not demoted:  # armed at the first demotion
                faults.install("hashstore.grow:fail@1")
            demoted.append(chk.tiered.spilled_distinct())

        chk._demote_generation = demote
    elif arm == "grouped_redo":
        chk.G = 1
        chk.cap_g = chk.G * chk.cap_x // 2
        real_level = chk._expand_level_grouped

        def grouped(*a, **k):
            faults.install("hashstore.grow:fail@1")  # armed at the first grouped level
            chk._expand_level_grouped = real_level
            return real_level(*a, **k)

        chk._expand_level_grouped = grouped
    else:
        faults.install("hashstore.grow:fail@1")
    try:
        res = chk.run()
        fired = faults.plan().fired
    finally:
        faults.reset()
    assert res == want and fired
    assert not chk.use_hashstore and not chk.megakernel and chk.superstep_span == 1
    assert chk.hstore is None and not chk._progs.progs
    d = chk.degraded_at
    assert d is not None and chk.degraded_site == DRILL_SITES[arm]
    assert set(routes[d:]) == ({"staged", "grouped"} if arm == "grouped_redo" else {"staged"})
    assert int((chk.visited != -1).sum()) == res.distinct
    assert at_upload == [dict(slab=False, hstore=False, progs=False, tiered=False, sieve=False,
                              scratch=False)]
    if arm == "tiered":
        assert demoted and chk.tiered is None  # the generations went into the store


# the reference's own drill under the same fault and slab floor; the port's
# arm and the reference's settings for it
DEGRADE_ARMS = dict(staged=(dict(megakernel=False), dict(megakernel=False)),
                    fused=(dict(superstep=1), dict(megakernel=True, superstep=1)),
                    superstep=({}, dict(megakernel=True)))


@pytest.mark.parametrize("arm", sorted(DEGRADE_ARMS))
def test_degraded_run_equals_reference(arm, tmp_path, monkeypatch):
    """``hashstore.grow:fail@1`` at a 16-slot slab floor on (2,1,1,1), in
    both packages (reference tests/test_resilience.py:325,
    tests/test_megakernel.py:134): the same result, every level's (pidx,
    slot) records -- in payload order before the degrade, fp_view order
    after it --, the store at every merge and the final store."""
    from tla_raft_tpu.ops import hashstore as ref_hs
    from tla_raft_tpu.resilience import faults as ref_faults

    port_kw, ref_kw = DEGRADE_ARMS[arm]
    for mod in (hs, ref_hs):
        monkeypatch.setattr(mod, "MIN_CAP", 16)
        if arm == "fused":  # no grow between levels: the slab overflows inside the level
            monkeypatch.setattr(mod.DeviceHashStore, "need_grow", lambda self, extra=0: False)
    ref_faults.install("hashstore.grow:fail@1")
    try:
        ref, recs, ref_merges, ref_final = _ref_sorted_run(
            RefConfig(2, 1, 1, 1), tmp_path, use_hashstore=True, chunk=64, **ref_kw)
    finally:
        ref_faults.install("")
    faults.install("hashstore.grow:fail@1")
    try:
        chk, got, merges = _port_sorted(RaftConfig(2, 1, 1, 1), use_hashstore=True, chunk=64,
                                        **port_kw)
    finally:
        faults.reset()
    assert got == ref and (got.distinct, got.depth) == (50, 12)
    assert chk.degraded_at is not None and 0 < len(merges) < got.depth
    _same_records(chk, recs)
    assert len(merges) == len(ref_merges)
    for (v, f), (rv, rf) in zip(merges, ref_merges):
        assert np.array_equal(v, rv) and np.array_equal(f, rf)
    assert np.array_equal(_u(chk.visited), ref_final)
