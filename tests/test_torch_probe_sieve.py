"""B8 ``hs_probe`` and the grouped level's visited pre-filter (B19
``_group_filter_hash``: the probe, then the filter compaction), and B13
``sieve`` as redesigned for the H100 (csrc/sieve.cu: bounded by the live
count, 4 lanes a thread, one atomic a block).  The numpy models
(tests/redesign_cases.py: the probe's walk, the sieve's per-block counts),
the port's twins and the port's grouped level are held exactly against the
reference's jitted ``hashstore.probe``, ``bfs._group_filter_hash`` and
``sieve.probe_impl`` on seeded inputs: slabs at load 1/2 built by the
reference's insert, walks near ``PROBE_DEPTH`` and past it, walks that
wrap past the slab's last slot, top-bit fingerprints, SENT lanes and
per-chunk dead tails, a ``cap_g`` overflow; the sieve with the sentinel,
2^20 random words and all-ones words, live counts of 0, 1, odd and the
whole buffer, views at odd offsets.  All outputs are integers: equality
is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redesign_cases as rc
import tla_raft_tpu.engine.bfs as ref_bfs
import tla_raft_tpu.ops.hashstore as ref_hs
import tla_raft_tpu.ops.sieve as ref_sieve
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import group
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.ops import sieve

SENT = int(rc.SENT)
CAP = rc.PROBE_CAP
_ref_probe = jax.jit(ref_hs.probe_impl)
_ref_sieve = jax.jit(ref_sieve.probe_impl)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint64)).view(np.int64).copy())


@pytest.fixture(scope="module", params=rc.PROBE_KINDS)
def case(request):
    slab, lanes = rc.probe_case(request.param, ref_hs.insert_np)
    walks = [rc.probe_walk(slab, int(x)) for x in lanes[0] if x != rc.SENT]
    return request.param, slab, lanes, walks


def test_probe_cases_hold_what_they_claim(case):
    kind, slab, (cv, _cf, _cp), walks = case
    steps = [s for _f, s in walks]
    assert 0.3 < np.mean([f for f, _s in walks]) < 0.8
    assert max(steps) > 3  # walks past their home slot's sector
    if kind == "half":
        assert abs((slab != rc.SENT).mean() - 0.5) < 0.05
    if kind == "near_depth":
        assert max(steps) >= 56
    if kind == "full_window":
        assert max(steps) == rc.HS_PROBE_DEPTH
        assert [rc.probe_walk(slab, int(x)) for x in cv[:3]] == [(True, 63), (False, 64),
                                                                 (False, 64)]
    if kind == "wrap":  # walks from the slab's last slots on into slot 0 and past
        homes = rc.probe_homes(cv[:40][20:], CAP)
        assert any(h + s >= CAP + 4 for h, (_f, s) in zip(homes, walks[20:40]))
    if kind == "top_bit":
        live = cv[cv != rc.SENT]
        assert (live >= rc.TOP).all()


@pytest.mark.parametrize("live", ["all", "odd", "one", "none"])
def test_probe_model_equals_reference(case, live):
    """hs_probe's walk, a lane at a time; lanes past the live count neither
    hit nor kept."""
    _kind, slab, (cv, _cf, _cp), _w = case
    n = cv.shape[0]
    nl = dict(all=n, odd=n // 2 + 1, one=1, none=0)[live]
    ref = np.asarray(_ref_probe(jnp.asarray(slab), jnp.asarray(cv)))
    got = rc.probe_model(slab, cv, live=nl)
    below = np.arange(n) < nl
    assert np.array_equal(got["hit"], ref & below)
    assert np.array_equal(got["keep"], (cv != rc.SENT) & ~ref & below)


def test_probe_twin_equals_reference(case):
    _kind, slab, (cv, _cf, _cp), _w = case
    ref = np.asarray(ref_hs.probe(jnp.asarray(slab), jnp.asarray(cv)))
    assert np.array_equal(hs.probe(_t(slab), _t(cv)).numpy(), ref)


def _ref_filter(slab, cv, cf, cp, cap: int):
    got = ref_bfs._group_filter_hash(jnp.asarray(cv), jnp.asarray(cf), jnp.asarray(cp),
                                     jnp.asarray(slab), cap)
    gv, gf, gp, ovf = (np.asarray(x) for x in got)
    return gv.view(np.int64), gf.view(np.int64), gp, bool(ovf)


@pytest.mark.parametrize("fit", ["fits", "overflows"])
def test_group_filter_twins_equal_reference(case, fit):
    """The CPU twins of B19 and of the group program's ops (the probe's
    keep flags, then the filter compaction): the kept lanes in the group's
    slice of the level's lane buffer, the payload base added, the total and
    the cap_g overflow in the control words."""
    _kind, slab, (cv, cf, cp), _w = case
    kept = int(((cv != rc.SENT) & ~np.asarray(_ref_probe(jnp.asarray(slab),
                                                           jnp.asarray(cv)))).sum())
    cap = kept + 5 if fit == "fits" else kept // 3
    gv, gf, gp, ovf = _ref_filter(slab, cv, cf, cp, cap)
    got = group.group_filter_hash(_t(cv), _t(cf), torch.from_numpy(cp), _t(slab), cap)
    assert np.array_equal(got[0].numpy(), gv) and np.array_equal(got[1].numpy(), gf)
    assert np.array_equal(got[2].numpy(), gp) and bool(got[3]) == ovf
    out = tuple(torch.full((3 * cap,), 9, dtype=torch.int64) for _ in range(3))
    lc = torch.zeros(mk.LC_LEN, dtype=torch.int64)
    lc[mk.LC_N_RUN] = 10_000
    lc[group.LC_GROUP] = 1
    group.group_step_plain(lc, torch.zeros(1, dtype=torch.int64), 1, 100, 7, cap)
    keep = torch.zeros(cv.shape[0], dtype=torch.bool)
    group.op_probe_keep(_t(slab), _t(cv), keep)
    group.op_filter_compact(keep, _t(cv), _t(cf), torch.from_numpy(cp), out, cap, lc, None)
    n = min(kept, cap)
    s = slice(cap, 2 * cap)
    assert np.array_equal(out[0][s].numpy(), gv) and np.array_equal(out[1][s].numpy(), gf)
    assert np.array_equal(out[2][s][:n].numpy(), gp[:n] + 700)
    assert int(lc[group.LC_G_TOTAL]) == kept and int(lc[group.LC_OVF_G]) == int(ovf)


def test_grouped_level_filter_equals_reference():
    """The port's grouped levels (G lowered to 2 on (3,1,2,1) at chunk 64,
    levels 14 and 15 grouped, cap_g forced small so a group overflows and
    the level redoes): every group's pre-filter, as the program ran it (the
    probe against the program's slab, then the filter compaction), equals
    the reference's ``_group_filter_hash`` of the same lanes against the
    same slab, in the group's slice with its payload base."""
    chk = TorchChecker(RaftConfig(3, 1, 2, 1), device="cpu", chunk=64, cap_x=384, superstep=1)
    chk.G, chk.cap_g = 2, 48
    calls, slabs = [], []
    real_probe, real_filter = group.op_probe_keep, group.op_filter_compact

    def probe_spy(slab, cv, keep):
        slabs.append(slab.clone())
        real_probe(slab, cv, keep)

    def filter_spy(keep, cv, cf, cp, out, cap_g, lc, tile):
        before = (slabs[-1], cv.clone(), cf.clone(), cp.clone(), int(lc[group.LC_G_OUT]),
                  int(lc[group.LC_G_PAY]))
        real_filter(keep, cv, cf, cp, out, cap_g, lc, tile)
        calls.append((before, cap_g, tuple(o.clone() for o in out), int(lc[group.LC_G_TOTAL]),
                      int(lc[group.LC_OVF_G])))

    group.op_probe_keep, group.op_filter_compact = probe_spy, filter_spy
    try:
        res = chk.run(max_depth=15)
    finally:
        group.op_probe_keep, group.op_filter_compact = real_probe, real_filter
    assert res.depth == 15 and chk.routes["grouped"] == 2
    assert chk.redos["cap_g"] >= 1 and len(calls) >= 6
    overflowed = 0
    for (slab, cv, cf, cp, off, pay), cap, out, total, ovf in calls:
        gv, gf, gp, rovf = _ref_filter(slab.numpy().view(np.uint64), cv.numpy().view(np.uint64),
                                       cf.numpy().view(np.uint64), cp.numpy(), cap)
        n = min(total, cap)
        assert np.array_equal(out[0][off:off + cap].numpy(), gv)
        assert np.array_equal(out[1][off:off + cap].numpy(), gf)
        assert np.array_equal(out[2][off:off + n].numpy(), gp[:n] + pay)
        overflowed += rovf
        assert not rovf or ovf == 1
    assert overflowed >= 1


# -- B13 ---------------------------------------------------------------------------


def _words(kind: str) -> np.ndarray:
    g = np.random.default_rng(11)
    if kind == "sentinel":
        return np.zeros(1, np.uint64)
    if kind == "all_ones":
        return np.full(1024, rc.SENT, np.uint64)
    m = 1 << 20
    return g.integers(0, 1 << 64, m, dtype=np.uint64) & g.integers(0, 1 << 64, m, dtype=np.uint64)


@pytest.fixture(scope="module", params=["sentinel", "random_2e20", "all_ones"])
def words(request):
    return request.param, _words(request.param)


@pytest.fixture(scope="module")
def fps_buf():
    """A fused level's new_fps buffer (with one lane before it, for views
    at an odd offset): fresh fingerprints, some with the top bit, some
    SENT inside, SENT past the end."""
    g = np.random.default_rng(12)
    n = 3001
    f = g.integers(0, 1 << 64, n + 1, dtype=np.uint64)
    f[g.random(n + 1) < 0.02] = rc.SENT
    f[-200:] = rc.SENT
    return f


def _ref_count(words_np, fps, live: int) -> tuple:
    hit = np.asarray(_ref_sieve(jnp.asarray(words_np), jnp.asarray(fps)))
    lv = np.arange(fps.shape[0]) < live
    return hit & lv, int((hit & lv & (fps != rc.SENT)).sum())


@pytest.mark.parametrize("live", ["none", "one", "odd", "all"])
@pytest.mark.parametrize("offset", [0, 1])
def test_sieve_model_equals_reference(words, fps_buf, live, offset):
    """csrc/sieve.cu's schedule: groups of 4 lanes, the scalar head of an
    odd view and its tail, per-block counts summed (the sum the same on
    another grid), bounded by the live count (flags past it 0)."""
    kind, w = words
    fps = fps_buf[offset:offset + 3000]
    nl = dict(none=0, one=1, odd=1777, all=3000)[live]
    want_hit, want = _ref_count(w, fps, nl)
    got = rc.sieve_blocks_model(w, fps, live=nl, offset=offset, seed=5)
    assert got["count"] == want and np.array_equal(got["hit"], want_hit)
    counted = rc.sieve_blocks_model(w, fps, live=nl, offset=offset, with_hit=False, blocks=2,
                                    seed=6)
    assert counted["count"] == want and counted["atomics"] <= counted["block_counts"].shape[0]
    if kind == "all_ones":
        assert want == int((fps[:nl] != rc.SENT).sum())
    if kind == "sentinel":
        assert want == 0
    if live == "all":
        assert got["vector_groups"] == (3000 - offset) // 4


@pytest.mark.parametrize("live", ["none", "one", "odd", "all"])
@pytest.mark.parametrize("offset", [0, 1])
def test_sieve_twins_equal_reference(words, fps_buf, live, offset):
    """The port's probe and the fused level's bounded count on the CPU."""
    _kind, w = words
    base = _t(fps_buf)
    fps = base[offset:offset + 3000]
    nl = dict(none=0, one=1, odd=1777, all=3000)[live]
    want_hit, want = _ref_count(w, fps_buf[offset:offset + 3000], nl)
    hit_all = np.asarray(_ref_sieve(jnp.asarray(w), jnp.asarray(fps_buf[offset:offset + 3000])))
    assert np.array_equal(sieve.probe(_t(w), fps).numpy(), hit_all)
    count = torch.zeros((), dtype=torch.int64)
    sieve.count_hits(_t(w), fps, count, torch.tensor(nl))
    assert int(count) == want
    count.zero_()
    sieve.count_hits(_t(w), fps, count)
    assert int(count) == _ref_count(w, fps_buf[offset:offset + 3000], 3000)[1]
