"""The port's device mesh (``tla_raft_tpu_torch.parallel``) against the
reference on the CPU.

B8 ``insert_only``'s twin against ``insert_only_impl`` (slab bits, count,
overflow: a full probe window, a load past 1/2) and the grow on it; B15's
routing twin against a jnp transcription of the reference's routing lines
(sharded.py:659-684, the winner grouping :506-518, the verdict map
:725-726); the port's ``ShardedChecker`` against ``OracleChecker`` at D = 2
and 8 in both exchange modes and the host-store mode, against the
reference's own ``ShardedChecker`` on its virtual CPU mesh (the
``CheckResult``, each owner's slab as a set, the per-level rows of each
shard), the growth paths (vcap, cap_x, the cap_w boost, presize), the
invariant and split-brain traces, ``use_mxu=False``, and the CLI's mesh
line and refusals.  Every output is an integer: equality is exact.  The
reference's mesh pays XLA compiles, so only its D = 2 depth-5 row runs in
the fast tier; the slow rows name their fast siblings."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.oracle import OracleChecker
from tla_raft_tpu.oracle.explicit import SplitBrainAbort, successors
from tla_raft_tpu.ops import hashstore as ref_hs
from tla_raft_tpu_torch import check
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.native import HostFPStore
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh
from tla_raft_tpu_torch.parallel import sharded

SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)
CFGS = {"s2": (2, 1, 1, 1), "s3": (3, 1, 1, 0)}


def _cfg(key, **kw):
    return RaftConfig(n_servers=key[0], n_vals=key[1], max_election=key[2],
                      max_restart=key[3], **kw)


def _ref_cfg(key, **kw):
    return RefConfig(n_servers=key[0], n_vals=key[1], max_election=key[2],
                     max_restart=key[3], **kw)


@functools.lru_cache(maxsize=None)
def _oracle(key, depth=None, **kw):
    return OracleChecker(_ref_cfg(key, **dict(kw))).run(max_depth=depth)


def _counts(r) -> tuple:
    return (r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes), r.action_counts)


def _mesh(D):
    return make_mesh(D, device="cpu")


def _rand(g, n):
    return g.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)


# -- B8 insert_only ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "full_window", "load", "duplicates"])
def test_insert_only_twin_equals_the_reference(case):
    """The claim rounds alone: equal slab bits, n_inserted and overflow;
    a lane homed in a run of 200 full slots is skipped (overflow), and a
    load past 1/2 raises the overflow after inserting."""
    g = np.random.default_rng(len(case))
    cap = 1 << 12
    slab = np.full(cap, SENT64, np.uint64)
    if case == "full_window":
        slab[100:300] = np.arange(1, 201, dtype=np.uint64)
    n = {"random": 1500, "full_window": 1800, "load": 2600, "duplicates": 900}[case]
    fps = _rand(g, n)
    fps[::9] = SENT64
    if case == "duplicates":
        fps[450:] = fps[:450]
    r_slab, r_n, r_ovf = ref_hs.insert_only(jnp.asarray(slab), jnp.asarray(fps))
    p_slab, p_n, p_ovf = hs.insert_only_plain(torch.from_numpy(slab.view(np.int64).copy()),
                                              torch.from_numpy(fps.view(np.int64)))
    assert np.array_equal(p_slab.numpy().view(np.uint64), np.asarray(r_slab))
    assert int(p_n) == int(r_n) and bool(p_ovf) == bool(r_ovf)
    assert bool(p_ovf) == (case in ("full_window", "load"))


@pytest.mark.parametrize("n", [300, 1500])
def test_grow_through_insert_only_matches_the_reference(n):
    """``HashStore.grow`` rehashes through insert_only: the reference's
    layout, to the doubled capacity and to a larger ``min_cap``."""
    fps = _rand(np.random.default_rng(n), n)
    st = hs.DeviceHashStore.from_fps(fps, device="cpu")
    ref = ref_hs.DeviceHashStore.from_fps(fps)
    for min_cap in (None, st.cap * 8):
        st.grow(min_cap=min_cap)
        ref.grow(min_cap=min_cap)
        assert st.cap == ref.cap
        assert np.array_equal(st.slab.numpy().view(np.uint64), np.asarray(ref.slab))


def test_rebuild_np_matches_the_reference():
    g = np.random.default_rng(3)
    shards = [_rand(g, k) for k in (0, 40, 300)]
    assert np.array_equal(hs.rebuild_np(shards, 1024), ref_hs.rebuild_np(shards, 1024))


# -- B15 routing ---------------------------------------------------------------------


def _ref_route(cv, cf, cp, D, cap_r):
    """The reference's routing lines, sharded.py:659-684, transcribed."""
    SENT = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    cap_x = cv.shape[0]
    owner = jnp.where(cv == SENT, D, (cv % jnp.uint64(D)).astype(jnp.int64))
    oorder = jnp.argsort(owner, stable=True)
    ov, of_, op, oo = cv[oorder], cf[oorder], cp[oorder], owner[oorder]
    counts = jnp.bincount(oo, length=D + 1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(cap_x) - starts[oo]
    overflow = counts[:D].max() > cap_r
    idx = jnp.clip(starts[:D, None] + jnp.arange(cap_r, dtype=starts.dtype)[None, :], 0,
                   cap_x - 1)
    in_row = jnp.arange(cap_r)[None, :] < counts[:D, None]
    sendv = jnp.where(in_row, ov[idx], SENT)
    sendf = jnp.where(in_row, of_[idx], SENT)
    sendp = jnp.where(in_row, op[idx], -1)
    return sendv, sendf, sendp, counts, oorder, oo, rank, overflow


def _route_case(seed, n, D):
    g = np.random.default_rng(seed)
    cv = _rand(g, n)
    cv[g.random(n) < 0.3] = SENT64
    if D > 2:
        cv[(cv % np.uint64(D) == np.uint64(D - 1)) & (cv != SENT64)] = SENT64  # an empty owner
    cf = _rand(g, n)
    cp = g.integers(0, 1 << 40, n).astype(np.int64)
    return cv, cf, cp


@pytest.mark.parametrize("D", [1, 2, 8, 5])
@pytest.mark.parametrize("cap", ["n", "small"])
def test_route_twin_equals_the_reference_lines(D, cap):
    """Rows, counts, each lane's owner and rank, overflow; SENT lanes, an
    empty owner, and owners past cap (the small capacity)."""
    n = 3000
    cv, cf, cp = _route_case(D, n, D)
    cap_r = n if cap == "n" else max(1, n // (3 * D))
    sv, sf, sp, counts, oorder, oo, rank, ovf = _ref_route(
        jnp.asarray(cv), jnp.asarray(cf), jnp.asarray(cp), D, cap_r)
    rows, p_counts, lane_owner, lane_rank, p_ovf = sharded.route_plain(
        [torch.from_numpy(x.view(np.int64)) for x in (cv, cf, cp)], [-1, -1, -1], D, cap_r)
    for a, b in zip(rows, (sv, sf, sp)):
        assert np.array_equal(a.numpy(), np.asarray(b).view(np.int64))
    assert np.array_equal(p_counts.numpy(), np.asarray(counts))
    order = np.asarray(oorder)
    assert np.array_equal(lane_owner.numpy()[order], np.asarray(oo))
    assert np.array_equal(lane_rank.numpy()[order], np.asarray(rank))
    assert bool(p_ovf) == bool(ovf) == (cap == "small")


@pytest.mark.parametrize("D", [2, 8])
def test_winner_grouping_and_verdict_map_equal_the_reference(D):
    """The verdicts back to the origin's lanes (:725-726) and the winners'
    grouping into [D, cap_w] rows (:506-518), against their transcriptions."""
    n, cap_w = 2000, 64
    cv, cf, cp = _route_case(D + 1, n, D)
    sv, sf, sp, counts, oorder, oo, rank, _ovf = _ref_route(
        jnp.asarray(cv), jnp.asarray(cf), jnp.asarray(cp), D, n)
    g = np.random.default_rng(D)
    back = g.random((D, n)) < 0.5
    rr = jnp.clip(rank, 0, n - 1)
    ok_lane = (jnp.asarray(cv)[oorder] != jnp.uint64(SENT64)) & (rank < n)
    win_sorted = jnp.asarray(back)[jnp.clip(oo, 0, D - 1), rr] & ok_lane
    # the winner grouping, :506-518
    op = jnp.asarray(cp)[oorder]
    wcounts = jnp.bincount(jnp.where(win_sorted, oo, D), length=D + 1)
    wstarts = jnp.cumsum(wcounts) - wcounts
    worder = jnp.argsort(jnp.where(win_sorted, oo, D), stable=True)
    idx = jnp.clip(wstarts[:D, None] + jnp.arange(cap_w)[None, :], 0, n - 1)
    in_row = jnp.arange(cap_w)[None, :] < wcounts[:D, None]
    spay = jnp.where(in_row, op[worder[idx]], -1)
    cols = [torch.from_numpy(x.view(np.int64)) for x in (cv, cf, cp)]
    _rows, _c, lane_owner, lane_rank, _o = sharded.route_plain(cols, [-1, -1, -1], D, n)
    win = sharded.route_back_plain(torch.from_numpy(back), lane_owner, lane_rank, D, n)
    assert np.array_equal(win.numpy()[np.asarray(oorder)], np.asarray(win_sorted))
    (w_rows,), w_counts, _lo, _lr, w_ovf = sharded.route_plain(
        [cols[2]], [-1], D, cap_w, owner=lane_owner, mask=win)
    assert np.array_equal(w_rows.numpy(), np.asarray(spay))
    assert np.array_equal(w_counts.numpy(), np.asarray(wcounts))
    assert bool(w_ovf) == bool(wcounts[:D].max() > cap_w)


def test_owner_of_fp_is_the_unsigned_modulus():
    v = _rand(np.random.default_rng(9), 5000)
    v[::11] = SENT64
    for D in (1, 3, 8, 13):
        want = np.where(v == SENT64, D, (v % np.uint64(D)).astype(np.int64))
        got = sharded.owner_of_fp(torch.from_numpy(v.view(np.int64)), D).numpy()
        assert np.array_equal(got, want)


# -- the mesh against the oracle and the reference ---------------------------------


@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather"])
@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("key", ["s2", "s3"])
def test_mesh_equals_the_oracle(key, D, exchange):
    """The reference's test_sharded_parity: counts, depth, level sizes and
    action counts at D = 2 and 8, both exchanges, to the fixpoint."""
    want = _oracle(CFGS[key])
    got = ShardedChecker(_cfg(CFGS[key]), _mesh(D), cap_x=512, vcap=4096,
                         exchange=exchange).run()
    assert _counts(got) == _counts(want)


def _ref_mesh_run(key, D, depth, **kw):
    """The reference's ShardedChecker on its virtual CPU mesh, with each
    level's per-shard new rows and the last level's slab shards kept."""
    from tla_raft_tpu.parallel import ShardedChecker as RefSharded
    from tla_raft_tpu.parallel import make_mesh as ref_make_mesh

    ref = RefSharded(_ref_cfg(key), ref_make_mesh(D), **kw)
    rows, slabs = [], {}
    note = ref.skew.note

    def keep_rows(level, rows_=None, seconds=None):
        rows.append(np.asarray(rows_).tolist())
        note(level, rows=rows_, seconds=seconds)

    ref.skew.note = lambda level, rows=None, seconds=None: keep_rows(level, rows, seconds)
    step = ref.level_step

    def keep_slab(*a):
        out = step(*a)
        slabs["visited"] = out.visited
        return out

    ref.__dict__["level_step"] = keep_slab
    res = ref.run(max_depth=depth)
    vis = np.asarray(slabs["visited"]).reshape(D, -1)
    return ref, res, rows, [set(v[v != SENT64].tolist()) for v in vis]


def _port_rows(chk):
    return [lv["rows"] for lv in chk.level_log]


def test_mesh_equals_the_reference_sharded_checker():
    """D = 2, depth 5 (tests/test_mesh_smoke.py's shape): the CheckResult,
    each owner's slab as a set, and every level's new rows per shard."""
    key = CFGS["s2"]
    ref, want, ref_rows, ref_sets = _ref_mesh_run(key, 2, 5, cap_x=128, vcap=1024)
    chk = ShardedChecker(_cfg(key), _mesh(2), cap_x=128, vcap=1024)
    got = chk.run(max_depth=5)
    assert tuple(got) == tuple(want)
    assert [set(s.tolist()) for s in chk.slab_contents()] == ref_sets
    assert _port_rows(chk) == ref_rows
    for o, s in enumerate(ref_sets):
        assert all(fp % 2 == o for fp in s)
    assert (chk.cap_x, chk.vcap, chk.reactive_grows) == (ref.cap_x, ref.vcap, 0)


@pytest.mark.slow
@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather"])
def test_mesh_equals_the_reference_at_eight_shards(exchange):
    """Slow sibling of test_mesh_equals_the_reference_sharded_checker: D =
    8, (3,1,1,0) to its fixpoint, both exchanges."""
    key = CFGS["s3"]
    from tla_raft_tpu.parallel import ShardedChecker as RefSharded
    from tla_raft_tpu.parallel import make_mesh as ref_make_mesh

    want = RefSharded(_ref_cfg(key), ref_make_mesh(8), cap_x=512, vcap=4096,
                      exchange=exchange).run()
    chk = ShardedChecker(_cfg(key), _mesh(8), cap_x=512, vcap=4096, exchange=exchange)
    assert tuple(chk.run()) == tuple(want)


# -- growth ----------------------------------------------------------------------------


def test_vcap_growth():
    """The reference's test_sharded_vcap_growth: a 16-slot slab shard grows
    (host rebuild), the counts stay the oracle's, and each shard holds only
    its own fingerprints."""
    key = CFGS["s2"]
    chk = ShardedChecker(_cfg(key), _mesh(2), cap_x=512, vcap=16)
    got = chk.run()
    assert _counts(got) == _counts(_oracle(key))
    assert chk.vcap > 16
    sets = chk.slab_contents()
    assert sum(len(s) for s in sets) == got.distinct
    assert all((s % np.uint64(2) == np.uint64(o)).all() for o, s in enumerate(sets))


@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather", "hosted"])
def test_cap_x_overflow_grows_reactively(exchange, tmp_path):
    """cap_x = 4: every early level overflows the candidate lanes, grows
    and is redone; the counts stay the oracle's."""
    key = CFGS["s3"]
    kw = (dict(host_store_dir=str(tmp_path)) if exchange == "hosted"
          else dict(exchange=exchange))
    chk = ShardedChecker(_cfg(key), _mesh(2), cap_x=4, vcap=4096, **kw)
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(key))
    assert chk.reactive_grows > 0 and chk.cap_x > 4


@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather", "hosted"])
def test_cap_m_overflow_widens_and_redoes(exchange, tmp_path):
    """Message-id lists of 2: a candidate overflows cap_m, its fingerprint
    is void, and the level is redone wider (the slab shards put back, the
    stores not yet touched); the counts stay the oracle's."""
    key = CFGS["s3"]
    kw = (dict(host_store_dir=str(tmp_path)) if exchange == "hosted"
          else dict(exchange=exchange))
    chk = ShardedChecker(_cfg(key), _mesh(2), cap_x=512, vcap=4096, **kw)
    for kit in chk._kits.values():
        kit.cap_m = 2
    got = chk.run()
    assert _counts(got) == _counts(_oracle(key))
    assert chk.kit0.cap_m > 2 and chk.kit0.redos["cap_m"] > 0 and chk.reactive_grows == 0


class _NarrowShip(ShardedChecker):
    """cap_w without its 256-row floor, so a small config overflows it."""

    @property
    def cap_w(self):
        return max(2, self.cap_x // 256) * self._cap_w_boost


def test_cap_w_boost_in_host_store_mode(tmp_path):
    """The host-store mode's shipping overflow boosts cap_w for the level
    and resets it after (:974, :982); the counts stay the oracle's."""
    key = CFGS["s3"]
    chk = _NarrowShip(_cfg(key), _mesh(2), cap_x=512, host_store_dir=str(tmp_path))
    boosts = []
    winners = chk._winners

    def spy(*a):
        boosts.append(chk._cap_w_boost)
        return winners(*a)

    chk._winners = spy
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(key))
    assert max(boosts) > 1 and chk._cap_w_boost == 1 and chk.reactive_grows > 0


def test_shipping_overflow_folds_into_cap_x_on_the_resident_mesh():
    """On the resident all_to_all mesh ovf_w folds into overflow_x
    (:742-744): cap_x grows and the counts stay the oracle's."""
    key = CFGS["s3"]
    chk = _NarrowShip(_cfg(key), _mesh(2), cap_x=512, vcap=4096)
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(key))
    assert chk.reactive_grows > 0 and chk.cap_x > 512


def test_presize_prevents_reactive_growth():
    """The reference's test_sharded_presize_prevents_reactive_growth: the
    Raft.cfg constants on 8 shards from cap_x 512 and vcap 128 to depth
    10, golden; the forecast grows both at level boundaries, so no level
    grows reactively."""
    chk = ShardedChecker(RaftConfig(), _mesh(8), cap_x=512, vcap=128)
    res = chk.run(max_depth=10)
    assert res.ok and list(res.level_sizes) == [1, 1, 3, 9, 22, 57, 136, 345, 931, 2468, 5881]
    assert chk.cap_x > 512 and chk.vcap > 128
    assert chk.reactive_grows == 0
    # the owner-shipping exchange spreads the frontier over every owner
    assert all(r > 0 for r in chk.level_log[7]["rows"])


# -- traces ------------------------------------------------------------------------------


def _valid_trace(cfg_ref, trace):
    for (_a, a), (act, b) in zip(trace, trace[1:]):
        assert any(ch == b for _n, _s, _d, ch in successors(cfg_ref, a)), act


VIOLATION = dict(key=(3, 1, 1, 0), kw=dict(invariants=("~RaftCanCommt",)))
SPLIT_BRAIN = dict(key=(3, 1, 2, 0), kw=dict(mutations=("double-vote",)))


@pytest.mark.parametrize("case", ["violation", "split_brain"])
def test_mesh_traces_are_genuine(case):
    """Fast sibling of test_mesh_traces_equal_the_reference: the reference's
    test_sharded_violation_trace and test_sharded_split_brain_abort_trace
    on 4 shards against the oracle: the verdict, the depth, the level
    sizes and a trace of real transitions from Init."""
    c = VIOLATION if case == "violation" else SPLIT_BRAIN
    want = _oracle(c["key"], **{k: v for k, v in c["kw"].items()})
    got = ShardedChecker(_cfg(c["key"], **c["kw"]), _mesh(4), cap_x=512, vcap=4096).run()
    assert not got.ok and not want.ok
    assert got.depth == want.depth and got.level_sizes == want.level_sizes
    kind, trace = got.violation
    assert trace[0][0] == "Init"
    ref_cfg = _ref_cfg(c["key"], **c["kw"])
    _valid_trace(ref_cfg, trace)
    if case == "violation":
        assert "RaftCanCommt" in kind and any(ci > 1 for ci in trace[-1][1].commit_index)
    else:
        assert "split brain" in kind
        with pytest.raises(SplitBrainAbort):
            successors(ref_cfg, trace[-1][1])


@pytest.mark.slow
@pytest.mark.parametrize("case", ["violation", "split_brain"])
def test_mesh_traces_equal_the_reference(case):
    """Slow sibling of test_mesh_traces_are_genuine: the port's verdict and
    trace equal the reference ShardedChecker's on 4 shards."""
    from tla_raft_tpu.parallel import ShardedChecker as RefSharded
    from tla_raft_tpu.parallel import make_mesh as ref_make_mesh

    c = VIOLATION if case == "violation" else SPLIT_BRAIN
    want = RefSharded(_ref_cfg(c["key"], **c["kw"]), ref_make_mesh(4), cap_x=512,
                      vcap=4096).run()
    got = ShardedChecker(_cfg(c["key"], **c["kw"]), _mesh(4), cap_x=512, vcap=4096).run()
    assert tuple(got) == tuple(want)


# the median-bug mutation on (3,1,2,0) over 8 shards: chip_smoke.py's mesh_trace
# phase pins this trace (the mesh's first violating state is the first owner's
# first bad row, so it is not the single-device path's; it is the reference
# mesh's, which test_median_bug_mesh_trace_equals_the_reference holds)
MEDIAN_BUG_KEY = (3, 1, 2, 0)


def _trace_sha(trace) -> str:
    import hashlib

    return hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()


@pytest.mark.slow
def test_median_bug_mesh_trace_equals_the_reference():
    """The median-bug counterexample on 8 shards equals the reference
    ShardedChecker's, and its digest is the one chip_smoke.py pins."""
    from tla_raft_tpu.parallel import ShardedChecker as RefSharded
    from tla_raft_tpu.parallel import make_mesh as ref_make_mesh

    import chip_smoke

    want = RefSharded(_ref_cfg(MEDIAN_BUG_KEY, mutations=("median-bug",)), ref_make_mesh(8),
                      cap_x=512, vcap=4096).run()
    got = ShardedChecker(_cfg(MEDIAN_BUG_KEY, mutations=("median-bug",)), _mesh(8), cap_x=512,
                         vcap=4096).run()
    assert tuple(got) == tuple(want)
    assert [a for a, _ in got.violation[1]] == chip_smoke.MESH_MEDIAN_BUG["actions"]
    assert _trace_sha(got.violation[1]) == chip_smoke.MESH_MEDIAN_BUG["trace_sha256"]


# -- the host-store mode ---------------------------------------------------------------


def _all_fps(key):
    """Every reachable fingerprint, from a single-device run's slab."""
    chk = TorchChecker(_cfg(key), device="cpu", chunk=256)
    chk.run()
    s = chk.hstore.slab.numpy().view(np.uint64)
    return s[s != SENT64]


@pytest.mark.parametrize("D", [2, 8])
def test_host_store_mode_equals_the_oracle(D, tmp_path):
    """One store per owner under shard_OO/: the oracle's counts; each
    store holds exactly the reachable fingerprints it owns (fp % D), so
    the stores' sizes sum to distinct and their union is the single-device
    run's set; the conservation checks pass every level."""
    key = CFGS["s3"]
    chk = ShardedChecker(_cfg(key), _mesh(D), cap_x=512, host_store_dir=str(tmp_path),
                         warm_bytes=8 * 64 * D)
    got = chk.run()
    assert _counts(got) == _counts(_oracle(key))
    fps = _all_fps(key)
    assert len(fps) == got.distinct
    assert sum(len(s) for s in chk.host_stores) == got.distinct
    for o, st in enumerate(chk.host_stores):
        mine = fps % np.uint64(D) == np.uint64(o)
        assert np.array_equal(st.contains(fps), mine)
        assert len(st) == int(mine.sum())
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"shard_{o:02d}" for o in range(D)]
    assert chk._store_budget_entries() == 64
    assert len(chk.meter.levels) == got.depth + 1  # the last level's filter finds nothing new


@pytest.mark.slow
def test_host_store_union_equals_the_reference_single_device_store(tmp_path):
    """Slow sibling of test_host_store_mode_equals_the_oracle: the union of
    the owners' stores is the reference JaxChecker(host_store=...)'s."""
    from tla_raft_tpu.engine.bfs import JaxChecker
    from tla_raft_tpu.native import HostFPStore as RefStore

    key = CFGS["s3"]
    ref_store = RefStore(str(tmp_path / "ref"))
    JaxChecker(_ref_cfg(key), host_store=ref_store, chunk=64).run()
    chk = ShardedChecker(_cfg(key), _mesh(8), cap_x=512, host_store_dir=str(tmp_path / "p"))
    chk.run()
    fps = _all_fps(key)
    assert ref_store.contains(fps).all() and len(ref_store) == len(fps)
    assert sum(len(s) for s in chk.host_stores) == len(fps)


def test_host_store_clears_a_crashed_runs_files(tmp_path):
    """A fresh run starts from empty stores: a store left with entries (a
    crashed process's) is cleared, and the counts stay the oracle's."""
    key = CFGS["s2"]
    stale = HostFPStore(str(tmp_path / "shard_00"))
    stale.insert(np.arange(1, 100, dtype=np.uint64))
    stale.compact()
    stale.close()
    chk = ShardedChecker(_cfg(key), _mesh(2), cap_x=512, host_store_dir=str(tmp_path))
    assert _counts(chk.run()) == _counts(_oracle(key))


# -- arms, refusals, the CLI -----------------------------------------------------------


def test_legacy_kernels_on_the_mesh_equal_the_default():
    key = CFGS["s3"]
    a = ShardedChecker(_cfg(key), _mesh(2), cap_x=512, vcap=4096, use_mxu=False)
    b = ShardedChecker(_cfg(key), _mesh(2), cap_x=512, vcap=4096)
    assert not a.use_mxu and b.use_mxu
    ra, rb = a.run(), b.run()
    assert tuple(ra) == tuple(rb)
    assert a.slab_contents()[0].tolist() == b.slab_contents()[0].tolist()


def test_refusals_name_the_roadmap(tmp_path, monkeypatch):
    """What the port refuses: its own gaps name the ROADMAP item; the deep
    sweep's settings the reference refuses (sharded.py:295-305) raise the
    reference's errors, and deep runs refuse checkpoints too."""
    cfg, mesh = _cfg(CFGS["s2"]), _mesh(2)
    deep = dict(deep=True, host_store_dir=str(tmp_path))
    for kw, what in ((dict(deep=True), "requires host_store_dir"),
                     (dict(deep, exchange="all_gather"), "requires exchange='all_to_all'"),
                     (dict(deep, canon="expand"), "requires canon='late'"),
                     (dict(deep, seg_rows=3), "even"),
                     (dict(canon="expand"), "A.7"),
                     (dict(use_hashstore=False), "A.7"), (dict(watchdog=object()), "A.1"),
                     (dict(exchange="all_gather", host_store_dir=str(tmp_path)), "all_to_all")):
        with pytest.raises(ValueError, match=what):
            ShardedChecker(cfg, mesh, **kw)
    for chk in (ShardedChecker(cfg, mesh), ShardedChecker(cfg, mesh, **deep)):
        for kw in (dict(checkpoint_dir=str(tmp_path)), dict(resume_from=str(tmp_path))):
            with pytest.raises(ValueError, match="A.7"):
                chk.run(**kw)
    monkeypatch.setenv("TLA_RAFT_HASHSTORE", "0")
    with pytest.raises(ValueError, match="A.7"):
        ShardedChecker(cfg, mesh)
    # all_gather and the host-store mode keep no slab: the setting is moot there
    assert ShardedChecker(cfg, mesh, exchange="all_gather").exchange == "all_gather"


def test_make_mesh():
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_mesh(2, devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2)


SMALL = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1"]


def _json_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_mesh_line(tmp_path, capsys):
    """Fast sibling of test_cli_mesh_line_equals_the_reference_cli: the
    port's --mesh 8 --json line holds the oracle's counts and the
    straggler block of the same run in process; --fpstore-dir on the mesh
    names its owner-sharded stores."""
    args = SMALL + ["--device", "cpu", "--mesh", "8", "--cap-x", "512", "--json", "--log", "-"]
    assert check.main(args) == 0
    got = _json_of(capsys.readouterr().out)
    want = _oracle(CFGS["s2"])
    assert (got["ok"], got["distinct"], got["generated"], got["depth"]) == (
        want.ok, want.distinct, want.generated, want.depth)
    assert got["level_sizes"] == list(want.level_sizes)
    assert got["megakernel"] is None and got["superstep"] is None
    chk = ShardedChecker(_cfg(CFGS["s2"]), _mesh(8), cap_x=512)
    chk.run()
    assert got["straggler"] == chk.skew.summary() and got["cap_x"] == chk.cap_x
    fps = tmp_path / "fps"
    assert check.main(args + ["--fpstore-dir", str(fps), "--warm-bytes", "4096"]) == 0
    out = capsys.readouterr().out
    assert f"Native FP store (owner-sharded x8): {fps}" in out
    assert sum(_json_of(out)["host_store"]["entries"]) == want.distinct


@pytest.mark.slow
def test_cli_mesh_line_equals_the_reference_cli(tmp_path, capsys):
    """Slow sibling of test_cli_mesh_line: --device cpu --mesh 8 --json on
    both CLIs, the reference's on its 8-device virtual mesh."""
    from test_cfgparse import REFERENCE_CFG
    from tla_raft_tpu.check import main as ref_main

    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(REFERENCE_CFG)
    args = ["--config", str(cfg)] + SMALL + ["--mesh", "8", "--json"]
    assert ref_main(args + ["--log", "-"]) == 0
    want = _json_of(capsys.readouterr().out)
    assert check.main(args + ["--device", "cpu", "--log", "-"]) == 0
    got = _json_of(capsys.readouterr().out)
    keys = ("ok", "distinct", "generated", "depth", "level_sizes", "violation", "mxu",
            "megakernel", "superstep", "straggler")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("extra,needle", [
    (["--mesh-deep"], "requires --mesh N"),
    (["--mesh", "2", "--mesh-deep"], "--mesh-deep requires --fpstore-dir"),
    (["--mesh", "2", "--checkpoint-dir", "CK"], "A.7"),
    (["--mesh", "2", "--recover", "CK"], "A.7"),
    (["--mesh", "2", "--audit", "4"], "--audit applies to the single-device engine"),
    (["--mesh", "2", "--no-hashstore"], "A.7"),
    (["--mesh", "2", "--canon", "expand"], "A.7"),
])
def test_cli_refusals_exit_2(extra, needle, tmp_path, capsys):
    extra = [str(tmp_path / "ck") if x == "CK" else x for x in extra]
    assert check.main(SMALL + ["--device", "cpu", "--log", "-"] + extra) == 2
    assert needle in capsys.readouterr().out


def test_cli_mesh_no_hashstore_on_all_gather_runs(capsys):
    """--no-hashstore is refused only where a slab would hold the visited
    set: all_gather keeps its replicated sorted store."""
    args = SMALL + ["--device", "cpu", "--mesh", "2", "--no-hashstore", "--exchange",
                    "all_gather", "--json", "--log", "-"]
    assert check.main(args) == 0
    assert _json_of(capsys.readouterr().out)["distinct"] == 50
