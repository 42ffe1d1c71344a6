"""The port's grouped level (engine/group.py) against the reference's
grouped chain on the CPU, where the group program runs its plain twins:
the membership probe (``hashstore.probe_impl``), the filter compaction
(``bfs._filter_compact``) and their composition
(``bfs._group_filter_hash``) on seeded inputs, then whole runs with G
lowered after construction (as tests/test_span_expand.py lowers
``span_min_chunk``) so that grouping engages at test scale, on both arms,
held against ``JaxChecker`` with the same G: counts, level sizes, action
counts, every level's trace pidx/slot, the slab bytes, a ``cap_g``
overflow and its redo, and the mutations' stop points and traces.  All
outputs are integers: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tla_raft_tpu.engine.bfs as ref_bfs
import tla_raft_tpu.ops.hashstore as ref_hs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import group
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.ops import hashstore as hs

from test_torch_engine import BUGS, _sha

S3121 = (3, 1, 2, 1)
CHUNK, G, DEPTH = 64, 2, 16  # levels 14-16 (2,612-4,844 parents) run grouped


def _lower_g(chk, g=G):
    chk.G = g
    chk.cap_g = chk.G * chk.cap_x // 2
    return chk


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64).copy())


@pytest.fixture(scope="module")
def lanes():
    """A slab built by the reference's insert_np, and lanes mixing slab
    members (hits), misses and SENT, with fp_full keys and payloads."""
    g = np.random.default_rng(7)
    members = g.integers(1, 1 << 63, 1500, dtype=np.uint64)
    slab = ref_hs.insert_np(np.full(4096, ref_hs.SENT, np.uint64), members)
    n = 3000
    cv = g.integers(1, 1 << 63, n, dtype=np.uint64)
    take = g.random(n) < 0.4
    cv[take] = members[g.integers(0, len(members), int(take.sum()))]
    cv[g.random(n) < 0.1] = ref_hs.SENT
    cf = g.integers(1, 1 << 63, n, dtype=np.uint64)
    cf[cv == ref_hs.SENT] = ref_hs.SENT
    cp = np.where(cv == ref_hs.SENT, -1, g.permutation(n) * 7).astype(np.int64)
    return slab, cv, cf, cp


def test_probe_equals_reference(lanes):
    slab, cv, _cf, _cp = lanes
    want = np.asarray(ref_hs.probe_impl(jnp.asarray(slab), jnp.asarray(cv)))
    got = hs.probe(_t(slab), _t(cv)).numpy()
    assert 0 < want.sum() < len(cv) and np.array_equal(got, want)


@pytest.mark.parametrize("cap_g", [2048, 1024], ids=["fits", "overflows"])
def test_filter_compact_equals_reference(lanes, cap_g):
    _slab, cv, cf, cp = lanes
    hit = np.random.default_rng(1).random(len(cv)) < 0.5
    want = ref_bfs._filter_compact(jnp.asarray(hit), jnp.asarray(cv), jnp.asarray(cf),
                                   jnp.asarray(cp), cap_g)
    got = group.filter_compact(torch.from_numpy(hit), _t(cv), _t(cf), _t(cp), cap_g)
    assert np.array_equal(_u64(got[0]), np.asarray(want[0]))
    assert np.array_equal(_u64(got[1]), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[3]) == bool(want[3]) == (cap_g == 1024)


@pytest.mark.parametrize("cap_g", [2048, 1024], ids=["fits", "overflows"])
def test_group_filter_hash_equals_reference(lanes, cap_g):
    slab, cv, cf, cp = lanes
    want = ref_bfs._group_filter_hash(jnp.asarray(cv), jnp.asarray(cf), jnp.asarray(cp),
                                      jnp.asarray(slab), cap_g)
    got = group.group_filter_hash(_t(cv), _t(cf), _t(cp), _t(slab), cap_g)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(_u64(a), np.asarray(b))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[3]) == bool(want[3]) == (cap_g == 1024)


def test_group_program_writes_its_slice_with_global_payloads(lanes):
    """The filter compaction as the group graph runs it: the kept lanes at
    the group's lane offset, the group's payload base added, the rest of
    the slice padded, the totals and the cap_g overflow in the control
    words."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    slab, cv, cf, cp = (_t(x) for x in lanes)
    keep = (cv != -1) & ~hs.probe(slab, cv)
    for cap_g, ovf in ((2048, 0), (512, 1)):
        out = tuple(torch.full((3 * cap_g,), 5, dtype=torch.int64) for _ in range(3))
        lc = torch.zeros(mk.LC_LEN, dtype=torch.int64)
        lc[group.LC_GROUP] = 1
        lc[mk.LC_N_RUN] = 10_000
        group.group_step_plain(lc, torch.zeros(1, dtype=torch.int64), 1, 1000, 7, cap_g)
        group.op_filter_compact(keep, cv, cf, cp, out, cap_g, lc, None)
        gv, gf, gp, o = group.filter_compact_plain(~keep, cv, cf, cp, cap_g)
        n = min(int(keep.sum()), cap_g)
        assert int(lc[group.LC_G_TOTAL]) == int(keep.sum()) and int(lc[group.LC_OVF_G]) == ovf
        s = slice(cap_g, 2 * cap_g)
        assert torch.equal(out[0][s], gv) and torch.equal(out[1][s], gf)
        assert torch.equal(out[2][s][:n], gp[:n] + 1000 * 7) and bool((out[2][s][n:] == -1).all())
        assert bool((out[0][:cap_g] == 5).all()) and bool((out[0][2 * cap_g:] == 5).all())


@pytest.fixture(scope="module")
def ref_grouped(tmp_path_factory):
    """The reference with G lowered to 2 on (3,1,2,1) to depth 16: its
    result, every level's (pidx, slot) (its delta records), its slab and
    its budgets."""
    chk = _lower_g(JaxChecker(RefConfig(*S3121), chunk=CHUNK))
    recs = {}

    def spy(ckdir, depth, pidx, slot, fps, mult, n_new):
        recs[depth] = (np.asarray(pidx, np.int64), np.asarray(slot, np.int64))

    chk._save_delta = spy
    res = chk.run(max_depth=DEPTH, checkpoint_dir=str(tmp_path_factory.mktemp("ref")))
    return res, [recs[d] for d in sorted(recs)], np.asarray(chk.hstore.slab), chk


@pytest.mark.parametrize("arm", [{}, dict(megakernel=False)], ids=["default", "staged"])
def test_grouped_run_equals_reference(ref_grouped, arm):
    ref, ref_traces, ref_slab, ref_chk = ref_grouped
    chk = _lower_g(TorchChecker(RaftConfig(*S3121), device="cpu", chunk=CHUNK, **arm))
    got = chk.run(max_depth=DEPTH)
    assert got == ref  # ok, counts, level sizes, action counts
    assert chk.routes["grouped"] == 3
    assert [g["level"] for g in chk.group_log] == [14, 15, 16]
    assert len(chk.trace_levels) == len(ref_traces) == DEPTH
    for (p, s), (rp, rs) in zip(chk.trace_levels, ref_traces):
        assert np.array_equal(np.asarray(p, np.int64), rp)
        assert np.array_equal(np.asarray(s, np.int64), rs)
    # the slab after the last (grouped) level: the reference's bytes
    assert np.array_equal(_u64(chk.hstore.slab), ref_slab)
    assert chk.hstore.occupancy() == chk.hstore.count == got.distinct
    # the grouped levels overflowed cap_g once and redid (as the reference did)
    assert (chk.cap_x, chk.cap_g) == (ref_chk.cap_x, ref_chk.cap_g)
    assert chk.redos["cap_g"] >= 1


def test_forced_cap_g_overflow_redoes_to_the_same_result(ref_grouped):
    ref, ref_traces, _slab, _chk = ref_grouped
    # cap_x at its final size, so no cap_x growth lifts cap_g first
    chk = _lower_g(TorchChecker(RaftConfig(*S3121), device="cpu", chunk=CHUNK, cap_x=384,
                                superstep=1))
    chk.cap_g = 24
    got = chk.run(max_depth=DEPTH)
    assert got == ref
    assert chk.redos["cap_g"] == 5 and chk.cap_g == 768  # 24 -> 48 -> ... -> 768
    for (p, s), (rp, rs) in zip(chk.trace_levels, ref_traces):
        assert np.array_equal(np.asarray(p, np.int64), rp)
        assert np.array_equal(np.asarray(s, np.int64), rs)


@pytest.mark.parametrize("mut", sorted(BUGS))
def test_stop_points_and_traces_on_grouped_levels(mut):
    """G = 1 at chunk 8: levels of more than 128 parents run grouped, so
    the double-vote abort (level 9, 180 parents) and the median-bug
    violation (levels 9-11 grouped) stop there with the reference's
    pinned counts and traces (test_torch_engine.py)."""
    want = BUGS[mut]
    chk = _lower_g(TorchChecker(RaftConfig(3, 1, 2, 0, mutations=(mut,)), device="cpu",
                                chunk=8), g=1)
    res = chk.run()
    assert (res.ok, res.distinct, res.generated, res.depth, res.level_sizes) == want["result"]
    assert res.violation[0] == want["kind"] and _sha(res.violation[1]) == want["sha"]
    # committed grouped levels; the double-vote abort expands 180 parents
    assert chk.routes["grouped"] == sum(n > 16 * 8 for n in res.level_sizes[:-1])
    assert chk.routes["grouped"] == 3 if mut == "median-bug" else res.level_sizes[-1] > 16 * 8
