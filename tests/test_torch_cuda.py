"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the CPU tier
runs the twins against the reference instead).  On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -q``, or, where JAX is not
installed (tests/conftest.py imports it),
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_cuda.py -q``.
``chip_smoke.py`` holds the same kernels against their twins at the main
path's full shapes.
"""

import numpy as np
import pytest
import torch

from tla_raft_tpu_torch import kernels
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker, compact_payloads
from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, inv_scan_plain
from tla_raft_tpu_torch.models.raft import Frontier, RaftState, core_of
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.ops.hashstore import probe_and_insert, probe_and_insert_plain
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def run():
    """A short reference-constants run on the card: its last frontier and
    slab are the kernels' inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=1024)
    res = chk.run(max_depth=10)
    assert res.level_sizes[-1] == 5881
    return chk


def test_guards_kernel_equals_twin(run):
    st = run.inflate(run.frontier)
    for a, b in zip(run.mx.guards(st), run.mx.guards_plain(st)):
        assert torch.equal(a, b)


def test_materialize_kernel_equals_twin(run):
    fr = run.frontier
    g = np.random.default_rng(0)
    pidx = torch.from_numpy(g.integers(0, fr.voted_for.shape[0], 8192)).cuda()
    slots = torch.from_numpy(g.integers(0, run.K, 8192)).cuda()
    kc, ka, ko = run.mx.materialize(fr, pidx, slots)
    pc, pa, po = run.mx.materialize_plain(fr, pidx, slots)
    assert all(torch.equal(x, y) for x, y in zip(kc, pc))
    assert torch.equal(ka, pa) and torch.equal(ko, po)


def test_fingerprint_kernel_equals_twin(run):
    fr = run.frontier
    for a, b in zip(run.fpr.state_fingerprints(fr), run.fpr.state_fingerprints_plain(fr)):
        assert torch.equal(a, b)


def _u64s(g, n):
    return torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)).cuda()


def _k4_dev(slab, fps, keys, pays, budget=1 << 30):
    """K4 through the fused level's wrapper (no host read), the live count
    all lanes: (fresh, lc, the call's control words)."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    n = fps.shape[0]
    lc = torch.zeros(mk.LC_LEN, dtype=torch.int64, device="cuda")
    lc[mk.LC_LIVE_LANES] = n
    lanes = kernels.k4_lanes(n, "cuda")
    fresh = kernels.probe_and_insert_dev(slab, fps, keys, pays, lc,
                                         lanes + kernels.rep_scratch("cuda", slab.shape[0]),
                                         budget)
    torch.cuda.synchronize()
    return fresh, lc.cpu(), lanes[-1].cpu()


def _hs_case(run, case):
    """(slab, fps, keys, pays) of one K4 case on the card."""
    g = np.random.default_rng(3)
    if case == "level":
        fr = run.frontier
        cv, cf, cp, *_ = run._expand_chunk(Frontier(*(x[:1024] for x in fr)), 0)
        return run.hstore.slab, cv, cf, cp
    # a list longer than the finisher takes: 24,000 lanes of 12,000 new
    # fingerprints into a slab of 2^15 slots a quarter full
    slab = hs.make_slab(1 << 15, "cuda")
    hs.insert_only(slab, _u64s(g, 1 << 13))
    pool = _u64s(g, 12_000)
    fps = pool[torch.from_numpy(g.integers(0, 12_000, 24_000)).cuda()]
    fps[::50] = -1
    keys = _u64s(g, 3)[torch.from_numpy(g.integers(0, 3, 24_000)).cuda()]  # many tied keys
    return slab, fps, keys, torch.from_numpy(g.permutation(24_000)).cuda()


@pytest.mark.parametrize("case", ["level", "long_list", "epoch_wrap"])
def test_hashstore_kernel_equals_twin(run, case):
    """K4 against its twin: a real chunk's candidates into the run's slab; a
    pending list longer than the finisher's threshold (grid rounds, then
    the finisher; the rounds those of the numpy model); and a call whose
    epoch wraps over words a stale epoch 1 left (key 0, payload 0: they
    would win if the wrap did not clear them)."""
    from redesign_cases import HS_EPOCH_MAX, hs_rounds_model

    slab, cv, cf, cp = _hs_case(run, "level" if case == "level" else "long_list")
    if case == "epoch_wrap":
        words, ep = kernels.rep_scratch("cuda", slab.shape[0])
        words.view(-1, 2)[::3, 1] = 1
        words.view(-1, 2)[::3, 0] = 0
        ep.fill_(HS_EPOCH_MAX)
    k = probe_and_insert(slab.clone(), cv, cf, cp)
    p = probe_and_insert_plain(slab.clone(), cv, cf, cp)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert int(k[2]) == int(p[2]) and bool(k[3]) == bool(p[3])
    if case == "epoch_wrap":
        assert int(kernels.rep_scratch("cuda", slab.shape[0])[1]) == 1
    if case == "long_list":
        u = lambda t: t.cpu().numpy().view(np.uint64)  # noqa: E731
        m = hs_rounds_model(u(slab).copy(), u(cv), u(cf), cp.cpu().numpy())
        assert kernels.K4_ROUNDS[-1] == m["rounds"]
        fresh, lc, ctl = _k4_dev(slab.clone(), cv, cf, cp)
        assert torch.equal(fresh.cpu(), p[1].cpu())
        assert ctl[kernels.KC_FIRST] == m["lists"][0] > kernels.FIN_LANES
        assert ctl[kernels.KC_GRID] >= 1 and ctl[kernels.KC_FIN] >= 1
        assert ctl[kernels.KC_GRID] + ctl[kernels.KC_FIN] == m["rounds"]
        # the group lanes, counted from the inputs: live and not in the slab
        keep = torch.zeros(cv.shape[0], dtype=torch.bool, device="cuda")
        kernels.hs_probe(slab, cv, keep=keep)
        assert int(keep.sum()) == int(m["group"].sum()) >= int(ctl[kernels.KC_FIRST])


@pytest.mark.parametrize("case", ["full", "long_list", "epoch_wrap"])
def test_hashstore_kernel_overflow_leaves_the_slab(run, case):
    """A nearly full slab, or a long list with a full window in its slab:
    the kernel's insert overflows and undoes its claims, and its fresh
    lanes and counts still equal the twin's (the overflowed lanes' slot 0
    included), the epoch wrapping or not."""
    from redesign_cases import HS_EPOCH_MAX

    g = np.random.default_rng(1)
    if case == "full":
        slab = _u64s(g, 1024)
        slab[torch.from_numpy(g.choice(1024, 3, replace=False)).cuda()] = -1
        fps = _u64s(g, 200)
        keys, pays = fps.clone(), torch.arange(200, device="cuda")
    else:
        slab, fps, keys, pays = _hs_case(run, "long_list")
        slab[5000:5400] = _u64s(g, 400)  # lanes homed there find their window full
        if case == "epoch_wrap":
            kernels.rep_scratch("cuda", slab.shape[0])[1].fill_(HS_EPOCH_MAX - 1)
    before = slab.clone()
    k = probe_and_insert(slab, fps, keys, pays)
    p = probe_and_insert_plain(before.clone(), fps, keys, pays)
    assert bool(k[3]) and bool(p[3])
    assert torch.equal(slab, before) and torch.equal(k[1], p[1]) and int(k[2]) == int(p[2])


def test_hashstore_kernel_raises_on_a_wide_payload(run):
    """A live lane's payload outside the representative word's 44 bits (or
    below 0) raises after the call, as the fused level's static bound does
    at its construction."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    g = np.random.default_rng(9)
    slab = hs.make_slab(1 << 12, "cuda")
    fps = _u64s(g, 300)
    for bad in (1 << kernels.PAY_BITS, -7):
        pays = torch.arange(300, device="cuda")
        pays[100] = bad
        with pytest.raises(ValueError, match="payload"):
            probe_and_insert(slab.clone(), fps, fps, pays)
    with pytest.raises(ValueError, match="44 bits"):
        mk.K4Scratch(16, slab, (1 << kernels.PAY_BITS) + 1)


def test_hslab_after_a_grow_on_the_card_equals_the_cpu(run, tmp_path):
    """A slab grown on the card (insert_only's rehash) and snapshot to
    hslab.npz holds the CPU twin's bytes, and the reference's layout."""
    g = np.random.default_rng(11)
    fps = g.integers(0, (1 << 64) - 2, 3000, dtype=np.uint64)
    arrays = {}
    for dev in ("cuda", "cpu"):
        st = hs.DeviceHashStore.from_fps(fps, device=dev)
        st.grow()
        st.grow(min_cap=st.cap * 4)
        (tmp_path / dev).mkdir()
        st.dump(str(tmp_path / dev / "hslab.npz"), depth=3)
        with np.load(tmp_path / dev / "hslab.npz") as z:
            arrays[dev] = (z["slab"].copy(), z["meta"].copy())
    assert np.array_equal(arrays["cuda"][0], arrays["cpu"][0])
    assert np.array_equal(arrays["cuda"][1], arrays["cpu"][1])
    want = hs.insert_np(np.full(arrays["cpu"][0].shape[0], hs.SENT_U64, np.uint64), fps)
    assert np.array_equal(arrays["cuda"][0], want)


def test_compaction_keeps_lane_order_on_the_card(run):
    valid = torch.rand(100_000, device="cuda") < 0.01
    pay = torch.arange(100_000, device="cuda")
    cp, lane, ovf = compact_payloads(valid, pay, 4096)
    assert torch.equal(cp[lane], pay[valid]) and not bool(ovf)


@pytest.mark.parametrize("cap", [1, 700, 4096, 300_000])
def test_compaction_kernel_equals_twins(run, cap):
    g = np.random.default_rng(cap)
    valid = torch.from_numpy(g.random(250_000) < 0.01).cuda()
    pay = torch.from_numpy(g.integers(0, 1 << 40, 250_000)).cuda()
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 250_000, dtype=np.int64)).cuda()
    for a, b in zip(compact_payloads(valid, pay, cap), bfs.compact_payloads_plain(valid, pay, cap)):
        assert torch.equal(a, b)
    for a, b in zip(hs.compact_fresh(valid, fps, pay, cap),
                    hs.compact_fresh_plain(valid, fps, pay, cap)):
        assert torch.equal(a, b)


def test_inflate_deflate_kernels_equal_twins(run):
    fr, uni = run.frontier, run.uni
    msgs = bfs.ids_to_msgs(fr.msg_ids, uni.n_words)
    assert torch.equal(msgs, bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words))
    for cap_m in (96, 8):  # 8: most rows overflow
        a = bfs.msgs_to_ids(msgs, uni.M, cap_m, torch.int16)
        b = bfs.msgs_to_ids_plain(msgs, uni.M, cap_m, torch.int16)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_inv_scan_kernel_equals_twin(run):
    """Every predicate, and two negations, on the frontier and on a batch
    of mixed rows (fields from different states), which break Inv."""
    fr = run.frontier
    g = np.random.default_rng(2)
    n = fr.voted_for.shape[0]
    mixed = Frontier(*(x[torch.from_numpy(g.integers(0, n, n)).cuda()].contiguous() for x in fr))
    for case in (fr, mixed):
        st = run.inflate(case)
        for name in sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]:
            want = int(inv_scan_plain(run.cfg, st, [name], run.tables, 5))
            assert int(run.inv_scan(case, offset=5, names=[name])) == want, name
    assert int(run.inv_scan(mixed)) >= 0


# -- the fused level (B11), supersteps (B12) and the sieve (B13) ----------------


def _result_tuple(r):
    return (r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes), r.action_counts)


@pytest.mark.parametrize("arm", [dict(megakernel=False), dict(superstep=1), dict()],
                         ids=["staged", "fused", "superstep"])
def test_arms_on_the_card_equal_the_cpu(run, arm):
    cfg = RaftConfig(3, 1, 1, 1)
    cpu = TorchChecker(cfg, device="cpu", chunk=256, **arm).run()
    chk = TorchChecker(cfg, device="cuda", chunk=256, **arm)
    got = chk.run()
    assert _result_tuple(got) == _result_tuple(cpu) and got.distinct == 545
    # one graph launch per superstep, per fused level and per redo
    redos = sum(v for k, v in chk._mega_stats.items() if k.startswith("redo"))
    want = chk._ss_stats["supersteps"] + chk._mega_stats["levels"] + redos
    launches = chk.graph_stats["level_launches"] + chk.graph_stats["superstep_launches"]
    assert launches == (0 if arm.get("megakernel") is False else want)


def _carry(run, device):
    """The depth-10 frontier and slab of the ``run`` fixture, on ``device``,
    under a fresh checker of the same budgets."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    chk = TorchChecker(RaftConfig(), device=device, chunk=1024, cap_x=run.cap_x, cap_m=run.cap_m)
    chk.hstore = hs.DeviceHashStore(run.hstore.cap, run.hstore.count, device)
    chk.hstore.slab = run.hstore.slab.to(device).clone()
    n_f = run.frontier.voted_for.shape[0]
    chk.hstore.reserve(chk.hstore.count + 16 * n_f)  # room for the levels after
    fr = Frontier(*(x.to(device) for x in run.frontier))
    return chk, fr, n_f, mk


def test_level_program_equals_twin(run):
    outs = {}
    for device in ("cuda", "cpu"):
        chk, fr, n_f, mk = _carry(run, device)
        cap_f = -(-n_f // chk.chunk) * chk.chunk
        cap_out = chk._frontier_cap(4 * n_f)
        prog = mk.LevelProgram(chk, ("test",), cap_f, cap_out, mk.DEFAULT_ROUNDS)
        mk.copy_rows(prog.fr_in, fr, n_f)
        prog.run(n_f)
        outs[device] = [t.cpu() for t in (prog.ctrl, prog.mult, prog.fps_out, prog.pidx,
                                          prog.slot, chk.hstore.slab)]
        n_new = int(prog.ctrl[0])
        outs[device] += [x[:n_new].cpu() for x in prog.fr_out]
    assert int(outs["cuda"][0][0]) == 12505  # the golden level 11
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)


def test_superstep_program_equals_twin(run):
    from tla_raft_tpu_torch.engine import superstep as ss

    outs = {}
    for device in ("cuda", "cpu"):
        chk, fr, n_f, mk = _carry(run, device)
        cap_f = chk._frontier_cap(64 * n_f)
        prog = ss.SuperstepProgram(chk, ("test",), cap_f, 4 * cap_f, 4, mk.DEFAULT_ROUNDS)
        mk.copy_rows(prog.fr[0], fr, n_f)
        prog.run(n_f, 3, 4 * cap_f)
        outs[device] = [t.cpu() for t in (prog.ss[:ss.SS_CTRL], prog.meta_n, prog.meta_mult,
                                          prog.ring_fps, prog.ring_pidx, prog.ring_slot,
                                          chk.hstore.slab)]
    assert outs["cuda"][1].tolist()[:3] == [12505, 24705, 47599]  # golden levels 11-13
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)


def test_commit_kernel_equals_twin(run):
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.engine import superstep as ss

    fields = ("n_new", "abort", "ovf_x", "ovf_slab", "ovf_m", "ovf_mx", "bad", "tier_hits",
              "ovf_rounds")
    g = np.random.default_rng(5)
    for _ in range(64):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64)
        lc[mk.LC_N_RUN] = 10
        lc[mk.LC_ABORT] = mk.BIG if g.random() < 0.8 else int(g.integers(0, 12))
        lc[mk.LC_BAD] = -1 if g.random() < 0.8 else int(g.integers(0, 5))
        for f in fields[2:6] + fields[7:]:
            lc[getattr(mk, "LC_" + f.upper())] = int(g.random() < 0.15)
        lc[mk.LC_N_NEW] = int(g.integers(0, 40))
        outs = []
        for device in ("cuda", "cpu"):
            st = torch.zeros((ss.SS_LEN,), dtype=torch.int64, device=device)
            ss.op_ss_begin(st, torch.tensor([10, 4, 20], device=device))
            mult = torch.arange(7, dtype=torch.int64, device=device)
            mn = torch.zeros(4, dtype=torch.int64, device=device)
            mm = torch.zeros((4, 7), dtype=torch.int64, device=device)
            mr = torch.zeros(4, dtype=torch.int64, device=device)
            ss.op_ss_commit(st, lc.to(device), mult, 32, mn, mm, mr)
            outs.append([x.cpu() for x in (st, mn, mm, mr)])
        assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_level_control_kernels_equal_twins(run):
    from tla_raft_tpu_torch.engine import megakernel as mk

    g = np.random.default_rng(6)
    totals = torch.from_numpy(g.integers(0, 300, 9))
    slab = run.hstore.slab
    pay = torch.from_numpy(np.concatenate([g.integers(0, 1 << 40, 500), [-1] * 12]))
    outs = []
    for device in ("cuda", "cpu"):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=device)
        mult = torch.ones(11, dtype=torch.int64, device=device)
        mk.op_level_begin(lc, mult, torch.tensor(1500, device=device))
        lc[mk.LC_ABORT] = 1400
        mk.op_level_gate(lc, totals.to(device), 256, 128)
        a = lc.clone()
        lc[mk.LC_N_NEW] = 700
        mk.op_level_decide(lc, 512)
        mk.op_slab_live(slab.to(device), lc[mk.LC_SLAB_LIVE])
        ctrl = torch.zeros(8, dtype=torch.int64, device=device)
        pidx = torch.zeros(pay.shape[0], dtype=torch.int32, device=device)
        slot = torch.zeros(pay.shape[0], dtype=torch.int16, device=device)
        mk.op_level_finalize(lc, ctrl, pay.to(device), 696, pidx, slot)
        outs.append([x.cpu() for x in (a, lc, mult, ctrl, pidx, slot)])
    assert int(outs[0][1][mk.LC_SLAB_LIVE]) == run.hstore.count
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_sieve_kernel_equals_twin(run):
    from tla_raft_tpu_torch.ops import sieve

    g = np.random.default_rng(4)
    words = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 1024, dtype=np.int64)
                             & g.integers(-(1 << 63), (1 << 63) - 1, 1024, dtype=np.int64))
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 100_000, dtype=np.int64))
    fps[::97] = -1
    assert torch.equal(sieve.probe(words.cuda(), fps.cuda()).cpu(), sieve.probe_plain(words, fps))
    for w in (words, sieve.empty_sieve("cpu")):
        c = torch.zeros((), dtype=torch.int64, device="cuda")
        sieve.count_hits(w.cuda(), fps.cuda(), c)
        want = torch.zeros((), dtype=torch.int64)
        sieve.count_hits(w, fps, want)
        assert int(c) == int(want)


# -- the grouped level (B8 probe, B3 filter, B19) and the tiered store (B16) ------


def test_probe_and_filter_kernels_equal_twins(run):
    from tla_raft_tpu_torch.engine import group

    fr = run.frontier
    cvs, cfs, cps = [], [], []
    for start in range(0, fr.voted_for.shape[0], 1024):
        cv, cf, cp, *_ = run._expand_chunk(Frontier(*(x[start:start + 1024] for x in fr)), start)
        cvs.append(cv)
        cfs.append(cf)
        cps.append(cp)
    cv, cf, cp = torch.cat(cvs), torch.cat(cfs), torch.cat(cps)
    slab = run.hstore.slab
    hit = hs.probe(slab, cv)
    assert torch.equal(hit, hs.probe_plain(slab, cv)) and 0 < int(hit.sum()) < cv.shape[0]
    for cap_g in (cv.shape[0], 256):  # fits, overflows
        for a, b in zip(group.filter_compact(hit, cv, cf, cp, cap_g),
                        group.filter_compact_plain(hit, cv, cf, cp, cap_g)):
            assert torch.equal(a, b)
        for a, b in zip(group.group_filter_hash(cv, cf, cp, slab, cap_g),
                        group.group_filter_hash(cv.cpu(), cf.cpu(), cp.cpu(), slab.cpu(), cap_g)):
            assert torch.equal(a.cpu(), b)


def _port_insert(slab: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """A slab built by the port's insert (its CPU twin)."""
    t = torch.from_numpy(slab.view(np.int64).copy())
    hs.insert_only(t, torch.from_numpy(np.asarray(keys, np.uint64).view(np.int64).copy()))
    return t.numpy().view(np.uint64)


def _replayed(fn) -> None:
    """``fn`` captured into a CUDA graph and replayed (after one eager call
    that loads its kernels)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()


def _dev(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int64).copy()).cuda()


@pytest.mark.parametrize("live", ["all", "odd", "one", "none"])
@pytest.mark.parametrize("kind", ["half", "near_depth", "wrap", "top_bit", "full_window"])
def test_probe_kernel_edges_equal_twin(run, kind, live):
    """hs_probe under graph replay with a device live count: slabs at load
    1/2, walks near and at PROBE_DEPTH, walks that wrap past the last slot,
    top-bit fingerprints, SENT lanes and dead chunk tails
    (redesign_cases.probe_case), against the numpy model of the walk and
    the twin."""
    from redesign_cases import probe_case, probe_model

    slab, (cv, _cf, _cp) = probe_case(kind, _port_insert)
    n = cv.shape[0]
    nl = dict(all=n, odd=n // 2 + 1, one=1, none=0)[live]
    s, f = _dev(slab), _dev(cv)
    hit = torch.zeros(n, dtype=torch.bool, device="cuda")
    keep = torch.zeros(n, dtype=torch.bool, device="cuda")
    cnt = torch.tensor(nl, dtype=torch.int64, device="cuda")
    _replayed(lambda: kernels.hs_probe(s, f, hit=hit, keep=keep, cnt=cnt))
    m = probe_model(slab, cv, live=nl)
    assert np.array_equal(hit.cpu().numpy(), m["hit"])
    assert np.array_equal(keep.cpu().numpy(), m["keep"])
    twin = hs.probe_plain(s.cpu(), f.cpu()).numpy() & (np.arange(n) < nl)
    assert np.array_equal(m["hit"], twin)
    # odd views: the lanes from 1, and the slab's whole width
    odd = f[1:]
    assert torch.equal(hs.probe(s, odd).cpu(), hs.probe_plain(s.cpu(), odd.cpu()))


@pytest.mark.parametrize("fit", ["fits", "overflows"])
@pytest.mark.parametrize("kind", ["half", "near_depth", "wrap", "top_bit", "full_window"])
def test_group_filter_kernels_edges_equal_twin(run, kind, fit):
    """The grouped level's pre-filter as its graph runs it (hs_probe's keep
    flags, then the filter compaction into a slice of a larger buffer at a
    device offset with a device payload base) under graph replay, on the
    probe's edge cases, against the twins."""
    from tla_raft_tpu_torch.engine import group
    from redesign_cases import probe_case

    slab, (cv, cf, cp) = probe_case(kind, _port_insert)
    s, v, ff, p = _dev(slab), _dev(cv), _dev(cf), _dev(cp)
    kept = int(((v != -1) & ~hs.probe_plain(s, v)).sum())
    cap = kept + 5 if fit == "fits" else kept // 3
    off, pay = 11, 1_000
    bufs = tuple(torch.full((cap + 2 * off,), 9, dtype=torch.int64, device="cuda")
                 for _ in range(3))
    keep = torch.zeros(v.shape[0], dtype=torch.bool, device="cuda")
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    ovf = torch.zeros((), dtype=torch.int64, device="cuda")
    off_t = torch.tensor(off, device="cuda")
    pay_t = torch.tensor(pay, device="cuda")
    tile = torch.zeros((kernels.compact_tiles(v.shape[0]),), dtype=torch.int64, device="cuda")

    def call():
        kernels.hs_probe(s, v, keep=keep)
        kernels.filter_compact(keep, v, ff, p, cap, out=bufs, total=total, out_off=off_t,
                               pay_off=pay_t, ovf=ovf, tile=tile)

    _replayed(call)
    gv, gf, gp, o = group.filter_compact_plain(hs.probe_plain(s, v), v, ff, p, cap)
    n = min(kept, cap)
    assert torch.equal(bufs[0][off:off + cap], gv) and torch.equal(bufs[1][off:off + cap], gf)
    assert torch.equal(bufs[2][off:off + n], gp[:n] + pay)
    assert bool((bufs[2][off + n:off + cap] == -1).all())
    assert all(bool((b[:off] == 9).all()) and bool((b[off + cap:] == 9).all()) for b in bufs)
    assert int(total) == kept and bool(o) == bool(ovf) == (fit == "overflows")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("live", ["none", "one", "odd", "all"])
@pytest.mark.parametrize("words", ["sentinel", "random_2e20", "all_ones"])
def test_sieve_kernel_edges_equal_twin(run, words, live, offset):
    """B13 under graph replay, bounded by a device live count: the
    sentinel, 2^20 random words and all-ones words; live counts of 0, 1,
    odd and the whole buffer; views at an odd offset (a scalar head lane)
    and hit flags at odd byte offsets; the hit flags and the count against
    the numpy model of the blocks and against the twin."""
    from redesign_cases import SENT, sieve_blocks_model
    from tla_raft_tpu_torch.ops import sieve

    g = np.random.default_rng(12)
    w = dict(sentinel=np.zeros(1, np.uint64), all_ones=np.full(1024, SENT, np.uint64),
             random_2e20=g.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
             & g.integers(0, 1 << 64, 1 << 20, dtype=np.uint64))[words]
    base = g.integers(0, 1 << 64, 50_003, dtype=np.uint64)
    base[g.random(base.shape[0]) < 0.02] = SENT
    n = 50_000
    nl = dict(none=0, one=1, odd=33_333, all=n)[live]
    fps = base[offset:offset + n]
    wd, bd = _dev(w), _dev(base)
    fd = bd[offset:offset + n]
    hit_buf = torch.zeros(n + 1, dtype=torch.bool, device="cuda")
    hit = hit_buf[offset:offset + n]
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    cnt = torch.tensor(nl, dtype=torch.int64, device="cuda")
    _replayed(lambda: kernels.sieve_probe(wd, fd, hit=hit, count=count, cnt=cnt))
    m = sieve_blocks_model(w, fps, live=nl, offset=offset)
    assert np.array_equal(hit.cpu().numpy(), m["hit"])
    assert int(count) == 2 * m["count"]  # the eager call and the replay
    want = torch.zeros((), dtype=torch.int64)
    sieve.count_hits(_dev(w).cpu(), fd.cpu(), want, torch.tensor(nl))
    assert int(want) == m["count"]
    if words == "all_ones":
        assert m["count"] == int((fps[:nl] != SENT).sum())


def test_group_control_kernels_equal_twins(run):
    """``lv_group_step`` a group (the previous group closed: one with its
    chunk totals past cap_x, another with an abort) and the tail gate that
    closes the last group, against their twins, word for word after every
    launch."""
    from tla_raft_tpu_torch.engine import group
    from tla_raft_tpu_torch.engine import megakernel as mk

    group_totals = ([10, 0, 0], [10, 200, 5], [10, 300, 5], [7, 0, 0])
    outs = []
    for device in ("cuda", "cpu"):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=device)
        mk.op_level_begin(lc, torch.zeros(7, dtype=torch.int64, device=device),
                          torch.tensor(3500, device=device))
        buf = torch.zeros(3, dtype=torch.int64, device=device)  # the program's chunk totals
        rows = []
        for g, tot in enumerate(group_totals):
            group.op_group_step(lc, buf, 256, 1000, 7, 64)
            rows.append(lc.clone())
            # the group's chunks: its totals and its abort
            buf.copy_(torch.tensor(tot, device=device))
            lc[group.LC_G_ABORT] = 900 if g == 1 else mk.BIG
        group.op_tail_gate(lc, buf, 256, 1000, len(group_totals) * 64)
        outs.append([x.cpu() for x in rows + [lc]])
    last = outs[0][-1]
    assert int(last[mk.LC_ABORT]) == 1900 and int(last[mk.LC_OVF_X]) == 1
    assert int(last[group.LC_GROUP]) == 4 and int(last[mk.LC_LIVE_LANES]) == 0
    assert [int(r[group.LC_G_RUN]) for r in outs[0][:4]] == [1000, 1000, 1000, 500]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_level_finalize_writes_only_the_survivors(run):
    """The bounded ``lv_finalize``: pidx / slot of the first n_new lanes from
    their payloads, the lanes past n_new as they were, as its twin."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    g = np.random.default_rng(9)
    pay = torch.from_numpy(g.integers(-5, 1 << 40, 70_000))
    outs = []
    for n_new in (0, 300, 65_537, 90_000):
        for device in ("cuda", "cpu"):
            lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=device)
            lc[mk.LC_N_NEW] = n_new
            ctrl = torch.zeros(8, dtype=torch.int64, device=device)
            pidx = torch.full((pay.shape[0],), 12_345, dtype=torch.int32, device=device)
            slot = torch.full((pay.shape[0],), 77, dtype=torch.int16, device=device)
            mk.op_level_finalize(lc, ctrl, pay.to(device), 696, pidx, slot)
            outs.append([x.cpu() for x in (ctrl, pidx, slot)])
        (kc, kp, ks), (pc, pp, ps) = outs[-2:]
        assert torch.equal(kc, pc) and torch.equal(kp, pp) and torch.equal(ks, ps)
        live = min(n_new, pay.shape[0])
        assert bool((kp[live:] == 12_345).all()) and bool((ks[live:] == 77).all())
        q = torch.div(pay[:live], 696, rounding_mode="floor")
        assert torch.equal(kp[:live], q.to(torch.int32))


def _plant(fr, src, at: int, row: int):
    """``fr`` with row ``at`` replaced by row ``row`` of ``src``."""
    out = Frontier(*(x.clone() for x in fr))
    for o, s in zip(out, src):
        o[at] = s[row]
    return out


def test_inv_scan_graph_replay_equals_twin(run):
    """inv_scan captured once in a CUDA graph with its live count a device
    word, replayed at live counts 0, < one tile, many tiles, and around a
    bad row planted in the last tile, with int16 and int32 ids, the id
    lists staged (narrow) and read from device memory (wide), against the
    twin over the live rows."""
    fr = run.frontier
    assert int(inv_scan_plain(run.cfg, run.inflate(fr), ["Inv"], run.tables)) == -1
    mixed = _mixed_rows(fr, 11)
    bad = int(inv_scan_plain(run.cfg, run.inflate(mixed), ["Inv"], run.tables))
    assert bad >= 0
    big = Frontier(*(torch.cat([x] * 8).contiguous() for x in fr))  # 92 tiles of 512
    N = big.voted_for.shape[0]
    big = _plant(big, mixed, N - 5, bad)
    counts = (0, 100, 256, 3000, N - 6, N - 5, N - 4, N)
    cases = {
        "int16": big,
        "int32": big._replace(msg_ids=big.msg_ids.to(torch.int32)),
        "narrow_ids": big._replace(msg_ids=big.msg_ids[:, :16].contiguous()),
    }
    for label, case in cases.items():
        st = run.inflate(case)
        for names in (["Inv"], ["NoAllCommit"], ["~CommitAll", "Inv"]):
            cnt = torch.zeros((), dtype=torch.int64, device="cuda")
            into = torch.full((), -1, dtype=torch.int64, device="cuda")

            def call():
                into.fill_(-1)
                kernels.inv_scan(run.cfg, run.uni, case, names, 7, into, cnt=cnt)

            call()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                call()
            for c in counts:
                cnt.fill_(c)
                graph.replay()
                torch.cuda.synchronize()
                sub = RaftState(*(x[:c] for x in st))
                want = int(inv_scan_plain(run.cfg, sub, names, run.tables, 7)) if c else -1
                assert int(into) == want, (label, names, c)
    # the planted row is found where it is, and the earlier result folds in
    assert int(run.inv_scan(big, names=["Inv"])) == N - 5
    earlier = torch.tensor(40, dtype=torch.int64, device="cuda")
    assert int(run.inv_scan(big, offset=9, into=earlier)) == 40


def test_inv_scan_persistent_tiles(run):
    """A block's later tiles: over 1,176,200 rows (more than four tiles a
    block of the largest persistent grid, so every block walks several,
    the next tile's copy in flight), one bad row planted in a block's
    later tile, in the last partial tile, or both (the later blocks stop
    past the first), replayed at live counts before, at and past it,
    against the known answer (the run's frontier has no bad row) and the
    twin."""
    fr = run.frontier
    mixed = _mixed_rows(fr, 11)
    bad = int(inv_scan_plain(run.cfg, run.inflate(mixed), ["Inv"], run.tables))
    assert bad >= 0
    big = Frontier(*(torch.cat([x] * 200).contiguous() for x in fr))
    N, R = big.voted_for.shape[0], kernels.INV_ROWS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert N // R >= 4 * (2048 // R) * sms and N % R
    later, last = (N // R * 3 // 4) * R + 17, N - 2
    for planted in ((later,), (last,), (later, last)):
        case = big
        for at in planted:
            case = _plant(case, mixed, at, bad)
        first = planted[0]
        cnt = torch.zeros((), dtype=torch.int64, device="cuda")
        into = torch.full((), -1, dtype=torch.int64, device="cuda")

        def call():
            into.fill_(-1)
            kernels.inv_scan(run.cfg, run.uni, case, ["Inv"], 3, into, cnt=cnt)

        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        for c in (R * sms, first - 1, first, first + 1, N - 1, N):
            cnt.fill_(c)
            graph.replay()
            torch.cuda.synchronize()
            assert int(into) == (first + 3 if c > first else -1), (planted, c)
        assert int(inv_scan_plain(run.cfg, case, ["Inv"], run.tables, 3)) == first + 3
        assert int(run.inv_scan(case, offset=3, names=["Inv"])) == first + 3


def _synthetic_frontier(cfg, uni, n: int, cap_m: int, seed: int):
    """``n`` rows of plausible field values for ``cfg``: no leader in most
    (Inv holds there), one leader in 2 % of them and the pattern
    NoAllCommit's message test starts from (a leader, two followers, the
    commit and match indices it names) in 1 %; random int32 id lists."""
    from tla_raft_tpu_torch.config import CANDIDATE, FOLLOWER, LEADER
    from tla_raft_tpu_torch.kernels import _field_shapes

    g = np.random.default_rng(seed)
    S, L, T = cfg.S, cfg.L, cfg.T
    f = {k: g.integers(0, 4, (n, *sh)).astype(np.uint8) for k, sh in _field_shapes(cfg).items()}
    f["current_term"] = g.integers(0, T + 1, (n, S)).astype(np.uint8)
    f["log_term"] = g.integers(0, 2, (n, S, L)).astype(np.uint8)
    f["log_val"] = g.integers(0, 2, (n, S, L)).astype(np.uint8)
    f["log_len"] = g.integers(1, L + 1, (n, S)).astype(np.uint8)
    f["commit_index"] = g.integers(0, L + 1, (n, S)).astype(np.uint8)
    f["role"] = np.where(g.random((n, S)) < 0.9, FOLLOWER, CANDIDATE).astype(np.uint8)
    rows = np.flatnonzero(g.random(n) < 0.02)
    f["role"][rows, g.integers(0, S, rows.size)] = LEADER
    for r in np.flatnonzero(g.random(n) < 0.01):
        s1, s2, s3 = g.choice(S, 3, replace=False)
        f["role"][r, [s1, s2, s3]] = LEADER, FOLLOWER, FOLLOWER
        f["current_term"][r, s3] = f["current_term"][r, s1]
        f["commit_index"][r, [s1, s2, s3]] = 2, 2, 1
        f["match_index"][r, s1, [s2, s3]] = 2
    ids = _random_ids(uni, n, cap_m, torch.int32, seed)
    return Frontier(msg_ids=ids, **{k: torch.from_numpy(v).cuda() for k, v in f.items()})


@pytest.mark.parametrize("V", [2, 4])
def test_inv_scan_wide_dims(V):
    """Dimensions whose fields do not all fit the stage buffers: at 7
    servers Inv with ~NoAllCommit (matchIndex, 49 B a state, read from
    device memory at V = 2, the log's 5 entries a server at V = 4), and
    Inv alone at V = 4 (commitIndex from device memory), with wide
    (device memory) and narrow (staged) id lists, on views at odd row
    offsets; every bad row found: the scan restarted past each one finds
    the next, as the twin's predicates mark them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from tla_raft_tpu_torch.engine.invariants import resolve_invariant_kernel
    from tla_raft_tpu_torch.ops.msg_universe import get_universe
    from tla_raft_tpu_torch.ops.successor import GuardTables

    cfg = RaftConfig(n_servers=7, n_vals=V)
    uni, tables = get_universe(cfg), GuardTables(cfg, "cuda")
    n = 4 * kernels.INV_ROWS + 77
    for cap_m in (24, 4):
        fr = _synthetic_frontier(cfg, uni, n, cap_m, V + cap_m)
        # the twin's message sets by the plain inflate: the kernel's rows in
        # shared memory do not fit the universe of 7 servers at V = 4
        st = RaftState(msgs=bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words), **core_of(fr))
        for names in (["Inv", "~NoAllCommit"], ["Inv"],
                      ["NoSplitVote", "~ExistLeaderAndCandidate", "Inv"]):
            mask = torch.zeros((n,), dtype=torch.bool, device="cuda")
            for nm in names:
                mask |= ~resolve_invariant_kernel(nm)(cfg, st, tables)
            bad = torch.nonzero(mask).flatten().tolist()
            assert 0 < len(bad) < n // 4, (names, len(bad))
            for a in [0, 1, 3] + [b + 1 for b in bad]:
                view = Frontier(*(x[a:] for x in fr))
                nxt = next((b for b in bad if b >= a), None)
                got = int(kernels.inv_scan(cfg, uni, view, names, 5))
                assert got == (-1 if nxt is None else nxt - a + 5), (cap_m, names, a)
            assert int(inv_scan_plain(cfg, st, names, tables)) == bad[0]


def test_one_inv_scan_and_one_group_control_launch_a_level(run, monkeypatch):
    """Launch counts by path: one inv_scan a fused level, a superstep level
    and a grouped level (its materialize), none in a group's graph; one
    level-control launch a group's graph, plus the level's begin and its
    tail (gate, decide, slab count, finalize)."""
    from tla_raft_tpu_torch.engine import megakernel as mk

    per_kind = {}
    launch = mk.GraphProgram.launch

    def tallied(prog):  # each program's launches a replay, as it launches
        launch(prog)
        per_kind.setdefault(prog.kind, set()).add(
            (prog.tally.per_replay["inv_scan"], prog.tally.per_replay["level"],
             getattr(prog, "span", 1)))

    monkeypatch.setattr(mk.GraphProgram, "launch", tallied)
    for arm in ({}, dict(superstep=1)):
        chk = TorchChecker(RaftConfig(3, 1, 2, 1), device="cuda", chunk=64, **arm)
        chk.G = 2
        chk.cap_g = chk.G * chk.cap_x // 2
        res = chk.run(max_depth=16)
        assert res.ok and chk.routes["grouped"] == 3
    assert per_kind["group"] == {(0, 1, 1)}
    assert {(i, s) for i, _l, s in per_kind["superstep"]} == {(4, 4)}
    assert {i for i, _l, _s in per_kind["level"]} == {1}
    # one grouped level from the last frontier, warm (its programs captured)
    fr, n = chk.frontier, chk.frontier.voted_for.shape[0]
    groups = -(-n // (chk.G * chk.chunk))
    before, replays = kernels.launch_counts(), chk.graph_stats["group_launches"]
    out, fr = chk._expand_level_grouped(fr, n, 16)
    chk.materialize_level(fr, out["new_payload"], out["n_new"])
    after = kernels.launch_counts()
    attempts = (chk.graph_stats["group_launches"] - replays) // groups
    assert attempts >= 1 and out["n_new"] > 0
    assert after["inv_scan"] - before["inv_scan"] == 1
    assert after["level"] - before["level"] == attempts * (groups + 5)


def test_drop_rows_kernel_equals_twin(run):
    from tla_raft_tpu_torch.store import tiered

    fr = run.frontier
    g = np.random.default_rng(8)
    for p in (0.0, 0.5, 1.0):
        keep = torch.from_numpy(g.random(fr.voted_for.shape[0]) < p)
        n_keep = int(keep.sum())
        a = tiered.drop_rows(fr, keep.cuda(), n_keep)
        b = tiered.drop_rows_plain(Frontier(*(x.cpu() for x in fr)), keep, n_keep)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.parametrize("arm", [dict(megakernel=False), dict()], ids=["staged", "default"])
def test_grouped_and_tiered_runs_on_the_card_equal_the_cpu(run, arm):
    """G = 1 at chunk 64 on (3,1,2,1) to depth 13 (levels 12-13 grouped),
    hot-only and under an 8 KiB hot budget."""
    def go(device, **kw):
        chk = TorchChecker(RaftConfig(3, 1, 2, 1), device=device, chunk=64, **arm, **kw)
        chk.G, chk.cap_g = 1, chk.cap_x // 2
        return chk, chk.run(max_depth=13)

    _c, want = go("cpu")
    chk, got = go("cuda")
    assert _result_tuple(got) == _result_tuple(want) and chk.routes["grouped"] == 2
    # one graph launch per group and attempt; one control read per attempt,
    # then the materialize read and the trace read: none per K4 claim round
    for g in chk.group_log:
        attempts = g["graph_launches"] // g["groups"]
        assert g["graph_launches"] == attempts * g["groups"] and g["reads"] == attempts + 2
    tchk, tgot = go("cuda", store_bytes=8 * 1024)
    assert _result_tuple(tgot) == _result_tuple(want)
    assert tchk.tiered.stats["demotions"] >= 2


# -- 5 and 7 servers: K3 at P = 120 and 5,040, its factored mode, int32 ids --------

# golden level sizes of the Raft.cfg constants at 5 and 7 servers
# (docs/BENCH_S5_r05.json.log, docs/BENCH_S7_r05b.log)
GOLDEN_S5 = (1, 1, 3, 9, 24, 66, 169, 401, 859)
GOLDEN_S7 = (1, 1, 3, 9, 24, 66, 171, 418)


@pytest.fixture(scope="module")
def scale():
    """Default-path runs on the card: S=5 to depth 8 and S=7 to depth 7,
    each golden; their last frontiers are the kernels' inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    out = {}
    for S, golden in ((5, GOLDEN_S5), (7, GOLDEN_S7)):
        chk = TorchChecker(RaftConfig(n_servers=S), device="cuda")
        res = chk.run(max_depth=len(golden) - 1)
        assert res.ok and res.level_sizes == golden
        out[S] = chk
    return out


def _mixed_rows(fr, seed):
    g = np.random.default_rng(seed)
    n = fr.voted_for.shape[0]
    return Frontier(*(x[torch.from_numpy(g.integers(0, n, n)).cuda()].contiguous() for x in fr))


def _random_ids(uni, n, cap_m, dtype, seed):
    """Ascending -1-padded random id lists (ids >= 2^15 where M allows)."""
    g = np.random.default_rng(seed)
    ids = np.full((n, cap_m), -1, np.int64)
    for i, k in enumerate(g.integers(0, cap_m + 1, n)):
        ids[i, :k] = np.sort(g.choice(uni.M, k, replace=False))
    return torch.from_numpy(ids).to(dtype).cuda()


@pytest.mark.parametrize("S", [5, 7])
def test_scale_fingerprint_kernel_equals_twin(scale, S):
    """K3 (the pair-digit form at S=5, factored at S=7) on the frontier, on
    mixed rows and on random id lists equals the plain twin, and the
    launches land on its counters."""
    from tla_raft_tpu_torch import kernels

    chk = scale[S]
    fr = chk.frontier
    rnd = fr._replace(msg_ids=_random_ids(chk.uni, fr.voted_for.shape[0], fr.msg_ids.shape[1],
                                          chk.id_dtype, S))
    before = kernels.launch_counts()
    for case in (fr, _mixed_rows(fr, S), rnd):
        for a, b in zip(chk.fpr.state_fingerprints(case), chk.fpr.state_fingerprints_plain(case)):
            assert torch.equal(a, b)
    after = kernels.launch_counts()
    assert after["fingerprint"] - before["fingerprint"] == 3
    assert after["msg_hash_factored"] - before["msg_hash_factored"] == (3 if S == 7 else 0)


@pytest.mark.parametrize("S", [3, 5])
def test_factored_kernel_equals_monolithic(scale, run, S):
    """K3 in its forced factored mode equals K3 with the monolithic message
    hash and the twin."""
    from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter

    chk = run if S == 3 else scale[5]
    fact = Fingerprinter(chk.cfg, device="cuda", force_factored=True)
    fr = _mixed_rows(chk.frontier, 11)
    mono = chk.fpr.state_fingerprints(fr)
    for a, b, c in zip(fact.state_fingerprints(fr), mono, fact.state_fingerprints_plain(fr)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_counted_fingerprint_launch_leaves_dead_lanes_sent(scale):
    """Lanes past the device count stay SENT (the fused level's counted
    launch)."""
    chk = scale[7]
    fr = chk.frontier
    n = fr.voted_for.shape[0]
    out = (torch.zeros(n, dtype=torch.int64, device="cuda"),
           torch.zeros(n, dtype=torch.int64, device="cuda"))
    from tla_raft_tpu_torch import kernels

    kernels.fingerprints(chk.fpr, fr, out=out, cnt=torch.tensor(n // 3, device="cuda"))
    pv, pf = chk.fpr.state_fingerprints_plain(Frontier(*(x[: n // 3] for x in fr)))
    assert torch.equal(out[0][: n // 3], pv) and torch.equal(out[1][: n // 3], pf)
    assert bool((out[0][n // 3:] == -1).all()) and bool((out[1][n // 3:] == -1).all())


@pytest.mark.parametrize("S", [5, 7])
def test_scale_kernels_equal_twins(scale, S):
    """K1 at K = 1,900 / 3,696, K2 with int16 / int32 ids (ids >= 2^15 at
    S=7), inflate and deflate with the config's id width, and inv_scan."""
    chk = scale[S]
    fr, uni = chk.frontier, chk.uni
    assert fr.msg_ids.dtype == (torch.int32 if S == 7 else torch.int16)
    st = chk.inflate(fr)
    for a, b in zip(chk.mx.guards(st), chk.mx.guards_plain(st)):
        assert torch.equal(a, b)
    g = np.random.default_rng(S)
    n = fr.voted_for.shape[0]
    rnd = fr._replace(msg_ids=_random_ids(uni, n, fr.msg_ids.shape[1], chk.id_dtype, S + 1))
    for par in (fr, rnd):
        pidx = torch.from_numpy(g.integers(0, n, 4096)).cuda()
        slots = torch.from_numpy(g.integers(0, chk.K, 4096)).cuda()
        kc, ka, ko = chk.mx.materialize(par, pidx, slots)
        pc, pa, po = chk.mx.materialize_plain(par, pidx, slots)
        assert all(torch.equal(x, y) for x, y in zip(kc, pc))
        assert torch.equal(ka, pa) and torch.equal(ko, po)
        msgs = bfs.ids_to_msgs(par.msg_ids, uni.n_words)
        assert torch.equal(msgs, bfs.ids_to_msgs_plain(par.msg_ids, uni.n_words))
        for cap_m in (par.msg_ids.shape[1], 6):  # 6: rows overflow
            a = bfs.msgs_to_ids(msgs, uni.M, cap_m, chk.id_dtype)
            b = bfs.msgs_to_ids_plain(msgs, uni.M, cap_m, chk.id_dtype)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if S == 7:
        assert int(rnd.msg_ids.max()) >= 1 << 15
    mixed = _mixed_rows(fr, S + 2)
    for case in (fr, mixed):
        cst = chk.inflate(case)
        for name in sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]:
            want = int(inv_scan_plain(chk.cfg, cst, [name], chk.tables, 3))
            assert int(chk.inv_scan(case, offset=3, names=[name])) == want, name


# -- orbit pruning (B17): the orbit kernel, K3's indexed mode, the chunk path ------


def _tied_rows(fr, k):
    """The first k rows made server-symmetric (every server's data equal to
    server 1's, votedFor None, no messages): their colours tie."""
    out = [x.clone() for x in fr]
    f = Frontier(*out)
    for name in ("current_term", "role", "log_len", "commit_index", "log_term", "log_val"):
        t = getattr(f, name)
        t[:k] = t[:k, :1]
    for name in ("match_index", "next_index", "pending"):
        t = getattr(f, name)
        t[:k] = t[:k, :1, 1:2]
    f.voted_for[:k] = 0
    f.msg_ids[:k] = -1
    return f


def _orbit_cases(chk, seed):
    fr = chk.frontier
    n = fr.voted_for.shape[0]
    rnd = fr._replace(msg_ids=_random_ids(chk.uni, n, fr.msg_ids.shape[1], chk.id_dtype, seed))
    return [fr, _mixed_rows(fr, seed), rnd, _tied_rows(_mixed_rows(fr, seed + 1), n // 4)]


@pytest.mark.parametrize("S", [3, 5, 7])
def test_orbit_kernel_equals_twin(scale, run, S):
    """The orbit kernel (monolithic tables at S = 3, 5, factored at 7) on
    the frontier, mixed rows, random id lists and tied rows: fp_view,
    fp_full, discrete and rank equal the twin's on every row; a counted
    launch leaves the rows past its count SENT."""
    from tla_raft_tpu_torch import kernels

    chk = run if S == 3 else scale[S]
    fpr = chk.fpr
    before = kernels.launch_counts()["orbit"]
    cases = _orbit_cases(chk, 20 + S)
    for case in cases:
        fv, ff, disc, rank = fpr.state_fingerprints_orbit(case)
        pv, pf, pd, pr = fpr.state_fingerprints_orbit_plain(Frontier(*(x.cpu() for x in case)))
        assert torch.equal(fv.cpu(), pv) and torch.equal(ff.cpu(), pf)
        assert torch.equal(disc.cpu(), pd) and torch.equal(rank.cpu().long(), pr)
    assert kernels.launch_counts()["orbit"] - before == len(cases)
    assert not bool(disc[: cases[-1].voted_for.shape[0] // 4].any())
    fr = cases[1]
    n = fr.voted_for.shape[0]
    fv, ff, disc, rank = kernels.orbit(fpr, fr, cnt=torch.tensor(n // 3, device="cuda"))
    pv, pf, _pd, _pr = fpr.state_fingerprints_orbit_plain(Frontier(*(x[: n // 3].cpu() for x in fr)))
    assert torch.equal(fv[: n // 3].cpu(), pv) and torch.equal(ff[: n // 3].cpu(), pf)
    assert bool((fv[n // 3:] == -1).all()) and not bool(disc[n // 3:].any())


@pytest.mark.parametrize("S", [3, 5, 7])
def test_indexed_fold_equals_k3(scale, run, S):
    """K3's indexed mode folds exactly the indexed rows under its device
    count (their values equal K3's over all rows), leaves every other
    output as it was, counts as orbit_fold, and sets its overflow word when
    the count passes its index rows."""
    from tla_raft_tpu_torch import kernels

    chk = run if S == 3 else scale[S]
    fr = _mixed_rows(chk.frontier, 30 + S)
    n = fr.voted_for.shape[0]
    want = chk.fpr.state_fingerprints(fr)
    g = np.random.default_rng(S)
    idx = torch.from_numpy(np.sort(g.choice(n, min(n, 200), replace=False))).cuda()
    for count, cap in ((idx.shape[0] // 2, idx.shape[0]), (idx.shape[0], idx.shape[0] // 2)):
        out = (torch.full((n,), 7, dtype=torch.int64, device="cuda"),
               torch.full((n,), 9, dtype=torch.int64, device="cuda"))
        ovf = torch.zeros((), dtype=torch.int64, device="cuda")
        before = kernels.launch_counts()
        kernels.fingerprints(chk.fpr, fr, out=out, idx=idx[:cap].contiguous(),
                             cnt=torch.tensor(count, device="cuda"), ovf=ovf)
        after = kernels.launch_counts()
        hit = idx[: min(count, cap)]
        mask = torch.zeros(n, dtype=torch.bool, device="cuda")
        mask[hit] = True
        for o, w, fill in ((out[0], want[0], 7), (out[1], want[1], 9)):
            assert torch.equal(o[mask], w[mask]) and bool((o[~mask] == fill).all())
        assert int(ovf) == int(count > cap)
        assert after["orbit_fold"] - before["orbit_fold"] == 1
        assert after["fingerprint"] == before["fingerprint"]
        assert after["msg_hash_factored"] - before["msg_hash_factored"] == int(S == 7)


@pytest.mark.parametrize("S", [3, 7])
def test_orbit_chunk_path_equals_twin(scale, run, S):
    """The chunk path on the card (orbit kernel, tied compaction, indexed
    fold, under a device count) equals ``orbit_chunk_fps_plain`` on its live
    rows, with the tied rows within the budget and past it (the overflow
    word set, the first cap_nd tied rows folded, as the twin).  At S=7 most
    rows of a shallow frontier tie, so the budgets follow the tied count."""
    chk = run if S == 3 else scale[S]
    fr = _tied_rows(_mixed_rows(chk.frontier, 40 + S), 64)
    n = fr.voted_for.shape[0]
    live = n - n // 5
    lane = torch.arange(n, device="cuda") < live
    _v, _f, disc, _r = chk.fpr.state_fingerprints_orbit_plain(fr)
    tied = int((lane & ~disc).sum())
    assert tied >= 64
    for cap_nd in (tied, tied // 2):
        fv, ff, ovf = chk.fpr.orbit_chunk_fps(fr, cap_nd, torch.tensor(live, device="cuda"))
        pv, pf, po = chk.fpr.orbit_chunk_fps_plain(fr, lane, cap_nd)  # the twin on the card
        assert torch.equal(fv[:live], pv[:live]) and torch.equal(ff[:live], pf[:live])
        assert bool((fv[live:] == -1).all()) and bool((ff[live:] == -1).all())
        assert int(ovf) == int(bool(po)) == int(cap_nd < tied)


def test_orbit_runs_on_the_card_equal_the_cpu(run):
    """(3,1,2,1) to depth 13 under orbit with G = 1 at chunk 64 (levels
    12-13 grouped: the orbit op inside the group graph) and all staged, on
    the card and on the CPU: the same result and visited set."""
    def go(device, G=None):
        chk = TorchChecker(RaftConfig(3, 1, 2, 1), device=device, chunk=64, orbit=True)
        if G:
            chk.G, chk.cap_g = G, G * chk.cap_x // 2
        res = chk.run(max_depth=13)
        slab = chk.hstore.slab.cpu()
        return chk, res, torch.sort(slab[slab != -1]).values

    _c, want, want_set = go("cpu")
    for G in (None, 1):
        chk, got, got_set = go("cuda", G)
        assert _result_tuple(got) == _result_tuple(want) and torch.equal(got_set, want_set)
        assert chk.routes["grouped"] == (2 if G else 0)


# -- the cross-check arms' kernels: dense_expand, chunk_compact, legacy ---------


def _dense_of(chk):
    from tla_raft_tpu_torch.ops.dense_expand import DenseExpand

    return DenseExpand(chk.cfg, chk.uni, "cuda", fpr=chk.fpr)


@pytest.mark.parametrize("S", [3, 5])
def test_dense_expand_kernel_equals_twin(scale, run, S):
    """Both modes over a frontier's rows (S = 3: the depth-10 frontier of
    the Raft.cfg constants; S = 5: the scale run's), and the counted form
    folding mult and the abort with dead rows past the count."""
    chk = run if S == 3 else scale[S]
    dx = _dense_of(chk)
    fr = Frontier(*(x[:2048] for x in chk.frontier))
    st = chk.inflate(fr)
    for a, b in zip(dx.expand(st), dx.expand_plain(st)):
        assert torch.equal(a, b)
    for a, b in zip(dx.guards(st), dx.guards_plain(st)):
        assert torch.equal(a, b)
    n = st.msgs.shape[0]
    live = n - 100
    valid = torch.zeros((n, dx.K), dtype=torch.bool, device="cuda")
    mult = torch.zeros((dx.K,), dtype=torch.int64, device="cuda")
    abort = torch.full((), 1 << 62, dtype=torch.int64, device="cuda")
    kernels.dense_expand(dx, st, False, valid=valid, per_row=False, cnt=torch.tensor(
        live, device="cuda"), mult_acc=mult, abort_acc=abort, base=5)
    pv, pm, pa = dx.guards_plain(type(st)(*(x[:live] for x in st)))
    assert torch.equal(valid[:live], pv) and not bool(valid[live:].any())
    assert torch.equal(mult, pm.to(torch.int64).sum(0))
    assert int(abort) == (5 + int(torch.argmax(pa.to(torch.int32))) if bool(pa.any()) else 1 << 62)


@pytest.mark.parametrize("S", [3, 5])
def test_chunk_compact_kernel_equals_twin(scale, run, S):
    """The fan-out of real parents into cap_x, a small cap (overflow) and a
    cap past the lanes, and the counted form over the live rows' lanes."""
    run = run if S == 3 else scale[S]
    dx = _dense_of(run)
    st = run.inflate(Frontier(*(x[:1024] for x in run.frontier)))
    _v, _m, fv, ff, _a = dx.expand(st)
    fv, ff = fv.reshape(-1), ff.reshape(-1)
    live = int((fv != -1).sum())
    for cap in (4 * live, live // 2, fv.shape[0] + 7):
        k = bfs.chunk_compact(fv, ff, cap, 3 * run.K)
        p = bfs.chunk_compact_plain(fv, ff, cap, 3 * run.K)
        assert all(torch.equal(a, b) for a, b in zip(k[:3], p[:3]))
        assert bool(k[3]) == (live > cap)
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    rows = 600
    out = kernels.chunk_compact(fv, ff, 4 * live, cnt=torch.tensor(rows, device="cuda"),
                                mul=run.K, total=total)
    p = bfs.chunk_compact_plain(fv[: rows * run.K], ff[: rows * run.K], 4 * live)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], p[:3])) and int(total) == int(p[3])


@pytest.mark.parametrize("S", [3, 5])
def test_legacy_materialize_kernel_equals_twin(scale, run, S):
    """Every slot of a few parents (valid and garbage lanes alike), and
    random lanes, against ``materialize_legacy_plain`` on the card."""
    from tla_raft_tpu_torch.ops.successor import materialize_legacy_plain

    chk = run if S == 3 else scale[S]
    fr = chk.frontier
    n, K = fr.voted_for.shape[0], chk.K
    rows = torch.linspace(0, n - 1, 6, device="cuda").long()
    pidx = rows.repeat_interleave(K)
    slots = torch.arange(K, device="cuda").repeat(rows.shape[0])
    g = np.random.default_rng(S)
    for pi, sl in ((pidx, slots), (torch.from_numpy(g.integers(0, n, 4096)).cuda(),
                                   torch.from_numpy(g.integers(0, K, 4096)).cuda())):
        kc, ka, ko = chk.materialize(fr, pi, sl, legacy=True)
        pc, pa, po = materialize_legacy_plain(chk.cfg, fr, pi, sl)
        assert all(torch.equal(a, b) for a, b in zip(kc, pc))
        assert torch.equal(ka, pa) and torch.equal(ko, po)


def test_canon_expand_run_is_golden(run):
    """canon="expand" to depth 12 on the card: 47,064 / 112,939, with the
    dense expand and the chunk compaction launched and K1 not."""
    kernels.reset_launches()
    res = TorchChecker(RaftConfig(), device="cuda", canon="expand").run(max_depth=12)
    assert (res.distinct, res.generated) == (47_064, 112_939)
    counts = kernels.launch_counts()
    assert counts["dense_expand"] > 0 and counts["chunk_compact"] > 0 and counts["guards"] == 0


# -- B19: the sorted visited store (csrc/sortstore.cu) ---------------------------------


def _sorted_store(fps: torch.Tensor, pad: int = 64) -> torch.Tensor:
    """The live fingerprints of ``fps`` as a sorted store with SENT pads."""
    live = fps[fps != -1]
    return torch.cat([bfs.sort_u64_plain(torch.unique(live)),
                      torch.full((pad,), -1, dtype=torch.int64, device=fps.device)])


def _level_lanes(chk, chunks: int):
    """The lanes of ``chunks`` chunks of the run's last frontier (real
    (fp_view, fp_full, payload) candidates with their pads), and a store of
    the run's visited set with a third of the candidates added."""
    fr, B = chk.frontier, chk.chunk
    parts = [chk._expand_chunk(Frontier(*(x[i * B:(i + 1) * B] for x in fr)), i * B)
             for i in range(chunks) if i * B < fr.voted_for.shape[0]]
    cv, cf, cp = (torch.cat([p[j] for p in parts]) for j in range(3))
    slab = chk.hstore.slab
    store = _sorted_store(torch.cat([slab, cv[::3]]))
    return cv, cf, cp, store


@pytest.mark.parametrize("S", [3, 5])
def test_sortstore_kernels_equal_twins(scale, run, S):
    """sorted_member, level_dedup, group_filter (sorted_member then the
    filter compaction) and merge_sorted against their twins: on the lanes of
    real chunks (S = 3: the depth-10 frontier of the Raft.cfg constants; S =
    5: the scale run's) against a store of the run's visited set, and on
    seeded lanes with top-bit values, repeats and SENT pads."""
    chk = run if S == 3 else scale[S]
    cases = [_level_lanes(chk, 4)]
    g = np.random.default_rng(S)
    n = 300_000
    def top(k):
        return np.where(g.random(k) < 0.5, np.uint64(1 << 63), np.uint64(0))

    cv = g.integers(0, 1 << 63, n, dtype=np.uint64) | top(n)
    dup = g.random(n) < 0.5
    cv[dup] = cv[g.integers(0, n, int(dup.sum()))]
    cv[g.random(n) < 0.05] = cv[0]  # one long run of a fp_view
    cf = g.integers(0, 1 << 63, n, dtype=np.uint64) | top(n)
    cp = g.permutation(n).astype(np.int64) * 7
    pad = g.random(n) < 0.1
    cv[pad], cf[pad], cp[pad] = np.uint64(2**64 - 1), np.uint64(2**64 - 1), -1
    t = [torch.from_numpy(x.view(np.int64).copy()).cuda() for x in (cv, cf)]
    cases.append((t[0], t[1], torch.from_numpy(cp).cuda(), _sorted_store(t[0][::4])))
    for cv, cf, cp, store in cases:
        hit = kernels.sorted_member(store, cv)
        assert torch.equal(hit, bfs.member_plain(store, cv)) and bool(hit.any())
        keep = torch.empty_like(hit)
        kernels.sorted_member(store, cv, keep=keep)
        assert torch.equal(keep, (cv != -1) & ~hit)
        k = bfs.level_dedup(cv, cf, cp, store)
        p = bfs.level_dedup_plain(cv, cf, cp, store)
        assert int(k[0]) == int(p[0]) > 0 and torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
        n_keep = int(keep.sum())
        for cap in (n_keep + 5, n_keep // 2):
            kg = bfs.group_filter(cv, cf, cp, store, cap)
            pg = bfs.group.filter_compact_plain(bfs.member_plain(store, cv), cv, cf, cp, cap)
            assert all(torch.equal(a, b) for a, b in zip(kg[:3], pg[:3]))
            assert bool(kg[3]) == bool(pg[3]) == (cap < n_keep)
        new = k[1][: max(int(k[0]), 1)]
        for n_out in (store.shape[0] + new.shape[0], store.shape[0] // 2 + 3, 1):
            assert torch.equal(bfs.merge_sorted(store, new, n_out),
                               bfs.merge_sorted_plain(store, new, n_out))


def test_sorted_runs_on_the_card_equal_the_cpu(run):
    """The sorted store on the card: (3,1,2,1) to depth 13 at chunk 64 with
    G = 1 (levels 12-13 grouped) equals the CPU's run level by level, store
    included; the three sorted-store kernels run and K4 never does."""
    def go(device):
        chk = TorchChecker(RaftConfig(3, 1, 2, 1), device=device, chunk=64, use_hashstore=False)
        chk.G, chk.cap_g = 1, chk.cap_x // 2
        return chk, chk.run(max_depth=13)

    cc, want = go("cpu")
    kernels.reset_launches()
    chk, got = go("cuda")
    counts = kernels.launch_counts()
    assert _result_tuple(got) == _result_tuple(want) and chk.routes["grouped"] == 2
    for (p, s), (q, r) in zip(chk.trace_levels, cc.trace_levels):
        assert np.array_equal(np.asarray(p, np.int64), np.asarray(q, np.int64))
        assert np.array_equal(np.asarray(s, np.int64), np.asarray(r, np.int64))
    assert torch.equal(chk.visited.cpu(), cc.visited)
    assert all(counts[k] > 0 for k in kernels.SORTED_PATH)
    assert counts["hashstore"] == 0 and counts["level"] == 0 and counts["superstep"] == 0


def test_grow_failure_degrades_on_the_card(run, monkeypatch):
    """``hashstore.grow:fail@1`` on the default path (slab floor 16 slots):
    the run degrades to the sorted store with the CPU's counts, and no
    captured program is launched after the degrade.  When the sorted store
    is allocated, the failing grow's slab, every program (and its graph
    pool) and the representative's scratch are already freed."""
    import weakref

    from tla_raft_tpu_torch.resilience import faults

    want = TorchChecker(RaftConfig(3, 1, 1, 1), device="cpu", chunk=64).run()
    monkeypatch.setattr(hs, "MIN_CAP", 16)
    chk = TorchChecker(RaftConfig(3, 1, 1, 1), device="cuda", chunk=64)
    slabs, at_upload = [], []
    real_grow, real_upload = hs.DeviceHashStore.grow, bfs.upload_sorted_store

    def grow(self, *a, **k):
        slabs.append(weakref.ref(self.slab))
        return real_grow(self, *a, **k)

    def upload(*a):
        at_upload.append((slabs[-1]() is None, chk.hstore, bool(chk._progs.progs),
                          bool(kernels._SCRATCH)))
        return real_upload(*a)

    monkeypatch.setattr(hs.DeviceHashStore, "grow", grow)
    monkeypatch.setattr(bfs, "upload_sorted_store", upload)
    faults.install("hashstore.grow:fail@1")
    try:
        got = chk.run()
    finally:
        faults.reset()
    assert at_upload == [(True, None, False, False)]
    assert _result_tuple(got) == _result_tuple(want)
    assert not chk.use_hashstore and chk.degraded_at is not None
    assert chk._graph_launches() == chk.graph_launches_at_degrade
    assert int((chk.visited != -1).sum()) == got.distinct


# -- B14: the sweep service's bucket kernels (csrc/bucket.cu) -------------------------


def _bucket_inputs(seed: int, rows: int, K: int, C: int):
    """Random bucket-kernel inputs from a numpy seed (CPU tensors)."""
    g = np.random.default_rng(seed)
    t = torch.from_numpy
    return dict(
        valid=t(g.random((rows, K)) < 0.3), mult=t(g.integers(0, 3, (rows, K), dtype=np.int32)),
        abort=t(g.random(rows) < 0.05), fpv=t(g.integers(-(1 << 63), (1 << 63) - 1, (rows, K))),
        crow=t(np.sort(g.integers(0, C, rows))), rc=t(g.integers(0, 4, rows, dtype=np.uint8)),
        fam_rs=t((g.random(K) < 0.1).astype(np.uint8)), mr=t(g.integers(0, 4, C, dtype=np.int32)),
        salt=t(g.integers(-(1 << 63), (1 << 63) - 1, C)),
        done=t((g.random(C) < 0.25).astype(np.int64)),
        gen=t(g.integers(0, 9, C)), abort_c=t((g.random(C) < 0.2).astype(np.int64)))


def _on(d: dict, dev) -> dict:
    return {k: v.clone().to(dev) for k, v in d.items()}


@pytest.mark.parametrize("sub", [0, 300])
def test_bucket_refine_kernel_equals_twin(run, sub):
    from tla_raft_tpu_torch.service import bucket as bk

    a = _bucket_inputs(7 + sub, 1024, run.K, 4)
    cnt = torch.tensor(900)
    outs = []
    for dev, fn in (("cuda", kernels.bucket_refine), ("cpu", bk.bucket_refine_plain)):
        x = _on(a, dev)
        fn(x["valid"], x["mult"], x["abort"], x["fpv"], x["crow"], x["rc"], x["fam_rs"], x["mr"],
           x["salt"], x["done"], x["gen"], x["abort_c"], cnt=cnt.to(dev), sub=sub)
        outs.append([x[k].cpu() for k in ("fpv", "gen", "abort_c")])
    assert all(torch.equal(p, q) for p, q in zip(*outs))


def test_bucket_tally_kernel_equals_twin(run):
    from tla_raft_tpu_torch.service import bucket as bk

    g = np.random.default_rng(3)
    n, K, C, rows = 8192, run.K, 4, 512
    base = _bucket_inputs(3, rows, 8, C)
    fresh = torch.from_numpy(g.random(n) < 0.4)
    pay = torch.from_numpy(g.integers(0, rows * K, n))
    ins = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, n))
    outs = []
    for dev, fn in (("cuda", kernels.bucket_tally), ("cpu", bk.bucket_tally_plain)):
        new_c = torch.zeros(C, dtype=torch.int64, device=dev)
        keep = torch.zeros(n, dtype=torch.bool, device=dev)
        ring = torch.full((3000,), -1, dtype=torch.int64, device=dev)
        fn(fresh.to(dev), pay.to(dev), torch.tensor(7000).to(dev), base["crow"].to(dev), K,
           base["done"].to(dev), base["abort_c"].to(dev), new_c, keep, ins.to(dev),
           torch.tensor(2900).to(dev), ring, torch.tensor(200).to(dev))
        outs.append([new_c.cpu(), keep.cpu(), ring.cpu()])
    assert all(torch.equal(p, q) for p, q in zip(*outs))


@pytest.mark.parametrize("case", range(6))
def test_bucket_ctrl_kernel_equals_twin(run, case):
    """Each phase, and the commit algebra under each stop class."""
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.service import bucket as bk

    g = np.random.default_rng(case)
    C, K, g_cap, span = 8, run.K, 512, 4
    a = _bucket_inputs(case, 64, K, C)
    lc = torch.zeros(mk.LC_LEN, dtype=torch.int64)
    lc[mk.LC_LIVE_LANES], lc[mk.LC_N_NEW], lc[mk.LC_BAD] = 900, int(g.integers(0, 600)), -1
    stop_word = [None, mk.LC_OVF_SLAB, mk.LC_OVF_X, mk.LC_OVF_ROUNDS, mk.LC_OVF_M, None][case]
    if stop_word is not None:
        lc[stop_word] = 1
    bs = torch.zeros(bk.BS_LEN, dtype=torch.int64)
    bs[bk.BS_RUNNING], bs[bk.BS_LEVELS], bs[bk.BS_OFF], bs[bk.BS_SPAN] = 1, 1, 40, span
    bs[bk.BS_RING], bs[bk.BS_NG] = 1000 if case != 5 else 100, int(g.integers(0, g_cap + 50))
    vec = dict(args=torch.tensor([77, span, 4096]), depth=torch.from_numpy(g.integers(0, 9, C)),
               cap=torch.from_numpy(g.integers(-1, 9, C)), done1=torch.zeros(C, dtype=torch.int64),
               new_c=torch.from_numpy(g.integers(0, 3, C)), crow_in=a["crow"],
               crow_out=torch.zeros(g_cap, dtype=torch.int64),
               pay=torch.from_numpy(g.integers(0, 64 * K, g_cap)))
    meta = [torch.zeros((span, C), dtype=torch.int64) for _ in range(3)] + [
        torch.zeros(span, dtype=torch.int64) for _ in range(2)]
    for phase in (bk.BC_BEGIN, bk.BC_PRE, bk.BC_POST, bk.BC_LEVEL):
        outs = []
        for dev, fn in (("cuda", kernels.bucket_ctrl), ("cpu", bk.bucket_ctrl_plain)):
            x = _on(dict(a, **vec, lc=lc, bs=bs), dev)
            m = [t.clone().to(dev) for t in meta]
            fn(phase, x["bs"], x["lc"], x["args"], x["done"], x["done1"], x["depth"], x["cap"],
               x["gen"], x["new_c"], x["abort_c"], m, g_cap, x["crow_in"], x["crow_out"],
               x["pay"], K)
            outs.append([x[k].cpu() for k in ("bs", "done", "done1", "depth", "gen", "new_c",
                                              "abort_c", "crow_out")] + [t.cpu() for t in m])
        assert all(torch.equal(p, q) for p, q in zip(*outs)), phase


def test_bucket_runs_on_the_card_equal_the_cpu(run):
    """BatchedChecker on the card (supersteps, and the fused level) equals
    the CPU twins' run, config by config, with the bucket kernels launched."""
    from tla_raft_tpu_torch.service.bucket import BatchedChecker

    cfgs = [RaftConfig(3, 1, 1, m) for m in (0, 1)] + [RaftConfig(3, 1, 2, 1)]
    for kw in (dict(), dict(superstep=1)):
        kernels.reset_launches()
        got = BatchedChecker(cfgs[:2], device="cuda", chunk=256, **kw).run()
        counts = kernels.launch_counts()
        want = BatchedChecker(cfgs[:2], device="cpu", chunk=256, **kw).run()
        keys = ("ok", "distinct", "generated", "depth", "level_sizes", "violation")
        assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
        assert all(counts[k] > 0 for k in kernels.BUCKET_PATH)


# -- the external store route (--fpstore-dir) ----------------------------------------


def _unique_cases(run):
    """group_unique inputs: a real group's lanes (the depth-10 frontier's
    chunks of the Raft.cfg constants, padded to G chunks), seeded lanes with
    ties in fp_view (other fp_full and payloads), top-bit values and SENT
    pads, all-SENT, one lane, and no lane."""
    cv, cf, cp, _store = _level_lanes(run, 4)
    cases = [(cv, cf, cp)]
    g = np.random.default_rng(9)
    n = 1 << 20
    top = np.where(g.random(n) < 0.5, np.uint64(1 << 63), np.uint64(0))
    pool = g.integers(0, 1 << 63, 4096, dtype=np.uint64) | top[:4096]
    v = pool[g.integers(0, 4096, n)]
    f = g.integers(0, 1 << 63, n, dtype=np.uint64) | top
    f[g.random(n) < 0.3] = f[0]  # ties in (fp_view, fp_full): the payload decides
    p = g.integers(0, 1 << 40, n).astype(np.int64)
    pad = g.random(n) < 0.3
    v[pad], f[pad], p[pad] = np.uint64(2**64 - 1), np.uint64(2**64 - 1), -1
    cases.append(tuple(torch.from_numpy(x.view(np.int64).copy()).cuda() for x in (v, f, p)))
    sent = torch.full((4096,), -1, dtype=torch.int64, device="cuda")
    cases.append((sent, sent.clone(), sent.clone()))
    one = torch.tensor([123456789], dtype=torch.int64, device="cuda")
    cases.append((one, one * 3, one * 5))
    empty = torch.empty((0,), dtype=torch.int64, device="cuda")
    cases.append((empty, empty, empty))
    return cases


def test_group_unique_kernel_equals_twin(run):
    """group_unique against its twin: n_u and the three padded outputs equal
    (the SENT / -1 tail included) on real and adversarial lanes, into
    caller buffers too."""
    for cv, cf, cp in _unique_cases(run):
        k = bfs.group_unique(cv, cf, cp)
        p = bfs.group_unique_plain(cv, cf, cp)
        assert int(k[0]) == int(p[0]) and all(torch.equal(a, b) for a, b in zip(k[1:], p[1:]))
        n = cv.shape[0]
        out = tuple(torch.full((n,), 7, dtype=torch.int64, device="cuda") for _ in range(3))
        n_u = torch.zeros((), dtype=torch.int64, device="cuda")
        kernels.group_unique(cv, cf, cp, out=out, n_u=n_u,
                             scratch=kernels.GroupUniqueScratch(n, cv.device))
        assert int(n_u) == int(p[0]) and all(torch.equal(a, b) for a, b in zip(out, p[1:]))


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_host_store_runs_on_the_card_equal_the_cpu(run, tmp_path, monkeypatch, paged):
    """The external store route on the card: (3,1,2,1) to depth 13 at chunk
    64 with G = 2 and the group program engaged (``span_min_chunk`` 64),
    equal to the CPU's run level by level, the store's size and the delta
    records included; ``group_unique`` runs and the device store's kernels
    do not.  Paged: segments of 256 rows and a 1-byte budget, so every
    sealed segment pages out to host RAM."""
    import glob

    from tla_raft_tpu_torch.native import HostFPStore

    if paged:
        monkeypatch.setattr(bfs, "SEG_ROWS", 256)

    def go(device):
        chk = TorchChecker(RaftConfig(3, 1, 2, 1), device=device, chunk=64,
                           host_store=HostFPStore(str(tmp_path / device / "fps")))
        chk.G, chk.span_min_chunk = 2, 64
        chk.dev_budget = 1 if paged else 0
        return chk, chk.run(max_depth=13, checkpoint_dir=str(tmp_path / device / "ck"))

    cc, want = go("cpu")
    kernels.reset_launches()
    chk, got = go("cuda")
    counts = kernels.launch_counts()
    assert _result_tuple(got) == _result_tuple(want) and chk.routes["host"] == 13
    assert len(chk.host_store) == len(cc.host_store) == got.distinct
    assert chk.paged_out == cc.paged_out and (chk.paged_out > 0) == paged
    assert chk.host_stats["graph_groups"] == cc.host_stats["graph_groups"] > 0
    for f in sorted(glob.glob(str(tmp_path / "cpu" / "ck" / "delta_*.npz"))):
        with np.load(f) as a, np.load(f.replace("/cpu/", "/cuda/")) as b:
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert counts["group_unique"] > 0
    assert all(counts[k] == 0 for k in ("hashstore", "hs_probe", "level", "superstep",
                                        "level_dedup"))


# -- the mesh's routing, insert_only, and an 8-shard mesh on one card ------------------


def _route_inputs(seed: int, n: int, D: int):
    g = np.random.default_rng(seed)
    v = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    v[g.random(n) < 0.25] = -1  # SENT lanes go to the virtual owner D
    if D > 2:
        # no lane owned by D - 1: an empty owner
        own = (v.view(np.uint64) % np.uint64(D)).astype(np.int64)
        v[(own == D - 1) & (v != -1)] = -1
    f = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    p = g.integers(0, 1 << 40, n, dtype=np.int64)
    return [torch.from_numpy(x).cuda() for x in (v, f, p)]


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("cap", ["n", "small"])
def test_route_kernel_equals_twin(run, D, cap):
    """Random lanes with SENT lanes and an empty owner, at the worst-case
    capacity and at one past which owners overflow."""
    from tla_raft_tpu_torch.parallel import sharded

    n = 50_000
    cols = _route_inputs(D, n, D)
    c = n if cap == "n" else n // (2 * D)
    a = kernels.route(cols, [-1, -1, -1], D, c)
    b = sharded.route_plain([x.cpu() for x in cols], [-1, -1, -1], D, c)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x.cpu(), y)
    for x, y in zip(a[1:4], b[1:4]):
        assert torch.equal(x.cpu(), y)
    assert bool(a[4]) == bool(b[4]) == (cap == "small")


@pytest.mark.parametrize("D", [2, 8])
def test_route_given_owners_and_route_back_equal_twins(run, D):
    """The winners' grouping (given owners where a mask holds) and the
    verdict map back."""
    from tla_raft_tpu_torch.parallel import sharded

    n = 40_000
    cols = _route_inputs(D + 10, n, D)
    rows, counts, lane_owner, lane_rank, _ovf = kernels.route(cols, [-1, -1, -1], D, n)
    g = np.random.default_rng(D)
    back = torch.from_numpy(g.random((D, n)) < 0.5).cuda()
    win = kernels.route_back(back, lane_owner, lane_rank, D, n)
    assert torch.equal(win.cpu(), sharded.route_back_plain(back.cpu(), lane_owner.cpu(),
                                                            lane_rank.cpu(), D, n))
    for cap in (n, 256):
        a = kernels.route([cols[2]], [-1], D, cap, owner=lane_owner, mask=win)
        b = sharded.route_plain([cols[2].cpu()], [-1], D, cap, owner=lane_owner.cpu(),
                                mask=win.cpu())
        assert torch.equal(a[0][0].cpu(), b[0][0]) and torch.equal(a[1].cpu(), b[1])
        assert bool(a[4]) == bool(b[4])


@pytest.mark.parametrize("case", ["random", "full_window", "load", "long_list", "rehash_2_20"])
def test_insert_only_kernel_equals_twin(run, case):
    """insert_only against its twin: random lanes, a full window, a load
    past 1/2, a list longer than the finisher's threshold (the rounds those
    of the numpy model), and a 2^20-entry slab rehashed into 2^21 slots
    (the twin on the card)."""
    from redesign_cases import hs_rounds_model

    g = np.random.default_rng(7)
    cap = 1 << 12
    if case == "rehash_2_20":
        old = hs.make_slab(1 << 21, "cuda")
        hs.insert_only(old, _u64s(g, 1 << 20))
        slab, fps = hs.make_slab(1 << 22, "cuda"), old
        b = hs.insert_only_plain(slab.clone(), fps)
        a = kernels.insert_only(slab, fps)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
        assert bool(a[2]) == bool(b[2])
        return
    if case == "long_list":
        cap = 1 << 15
    slab = hs.make_slab(cap, "cuda")
    if case == "full_window":
        # 200 slots in a row taken: lanes homed there find their window full
        slab[100:300] = torch.arange(1, 201, device="cuda")
    n = {"random": 1500, "full_window": 1800, "load": 2600, "long_list": 14_000}[case]
    fps = _u64s(g, n)
    fps[::9] = -1
    a = kernels.insert_only(slab.clone(), fps)
    c = kernels.INSERT_CTL.cpu()
    b = hs.insert_only_plain(slab.cpu().clone(), fps.cpu())
    assert torch.equal(a[0].cpu(), b[0])
    assert int(a[1]) == int(b[1]) and bool(a[2]) == bool(b[2])
    assert bool(b[2]) == (case in ("full_window", "load"))
    m = hs_rounds_model(slab.cpu().numpy().view(np.uint64).copy(),
                        fps.cpu().numpy().view(np.uint64))
    assert c[kernels.KC_ROUNDS] == m["rounds"] and c[kernels.KC_FIRST] == m["lists"][0]
    assert int((fps != -1).sum()) == int(m["live"]) >= int(c[kernels.KC_FIRST])
    if case == "long_list":
        assert c[kernels.KC_GRID] >= 1 and c[kernels.KC_FIN] >= 1


def test_eight_shard_mesh_on_one_card_equals_the_cpu(run, tmp_path):
    """(3,1,1,0) to its fixpoint on 8 shards of one card, each mode, equal
    to the same run on the CPU; every mesh kernel launched."""
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    cfg = RaftConfig(n_servers=3, n_vals=1, max_election=1, max_restart=0)
    for mode in ("all_to_all", "all_gather", "hosted"):
        kw = (dict(host_store_dir=str(tmp_path / "fps")) if mode == "hosted"
              else dict(exchange=mode))
        kernels.reset_launches()
        got = ShardedChecker(cfg, make_mesh(8, devices=["cuda"] * 8), cap_x=512, vcap=4096,
                             **kw).run()
        counts = kernels.launch_counts()
        want = ShardedChecker(cfg, make_mesh(8, device="cpu"), cap_x=512, vcap=4096,
                              **kw).run()
        assert got == want
        assert (counts["route"] > 0) == (mode != "all_gather")
        assert (counts["hashstore"] > 0) == (mode == "all_to_all")
        assert counts["group_unique"] > 0 and counts["materialize"] > 0


# -- slice 11: the sharded deep sweep's kernels (csrc/deep.cu, sortstore.cu) ---------------


def _sorted_u64(g, n):
    v = np.unique(g.integers(0, np.iinfo(np.uint64).max, n + 64, dtype=np.uint64,
                             endpoint=True))[:n]
    return torch.from_numpy(v.view(np.int64).copy())


@pytest.mark.parametrize("n", [0, 1, 4097, 50_000])
def test_pack_deltas_kernel_equals_twin(run, n):
    from tla_raft_tpu_torch.parallel.exchange import pack_fp_deltas_plain, unpack_fp_deltas

    g = np.random.default_rng(n)
    cap = 50_002
    fps = torch.full((cap,), -1, dtype=torch.int64)
    fps[:n] = _sorted_u64(g, n)
    if n > 2:
        fps[1] = fps[0] + 1  # a one-byte delta beside eight-byte ones
    fps = fps.cuda()
    a = kernels.pack_deltas(fps, n)
    b = pack_fp_deltas_plain(fps.cpu(), n)
    assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])
    assert int(a[2]) == int(b[2])
    c = kernels.pack_deltas(fps, torch.tensor(n, device="cuda"))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    got = unpack_fp_deltas(a[0].cpu().numpy(), a[1].cpu().numpy(), n, verify=True)
    assert np.array_equal(got.view(np.int64), fps[:n].cpu().numpy())


@pytest.mark.parametrize("n_u", [0, 9, 30_000])
def test_deep_verdict_kernel_equals_twin(run, n_u):
    from tla_raft_tpu_torch.parallel.sharded import deep_verdict_plain

    g = np.random.default_rng(n_u)
    n_recv = 40_000
    gp = torch.full((n_recv,), -1, dtype=torch.int64)
    gp[:n_u] = torch.from_numpy(g.permutation(n_recv)[:n_u])
    bits = torch.from_numpy(g.integers(0, 256, (n_u + 7) // 8 + 3, dtype=np.uint8))
    a = kernels.deep_verdict(bits.cuda(), gp.cuda(), n_u, n_recv)
    b = deep_verdict_plain(bits, gp, n_u, n_recv)
    assert torch.equal(a.cpu(), b)
    c = kernels.deep_verdict(bits.cuda(), gp.cuda(), torch.tensor(n_u, device="cuda"), n_recv)
    assert torch.equal(a, c)


def test_deep_repack_kernel_equals_twin(run):
    from tla_raft_tpu_torch.parallel.sharded import repack_plain

    fr = run.frontier
    n = fr.voted_for.shape[0]
    g = np.random.default_rng(3)
    rows = torch.arange(n, device="cuda")
    half = n // 2
    sources = [tuple(x[:half] for x in fr) + (rows[:half] * 7, rows[:half] % 5),
               tuple(x[half:] for x in fr) + (rows[half:] * 7, rows[half:] % 5)]
    segs = []
    for _ in range(12):  # blocks of either source, any rows, in any order
        s = int(g.integers(0, 2))
        m = sources[s][0].shape[0]
        a = int(g.integers(0, m))
        segs.append((s, a, int(g.integers(0, m - a + 1))))
    got = kernels.deep_repack(sources, segs)
    want = repack_plain(sources, segs)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="outside"):
        kernels.deep_repack(sources, [(0, half, 5)])


@pytest.mark.parametrize("case", ["fits", "overflow", "holes", "large"])
def test_sieve_merge_kernel_equals_twin(run, case):
    """``large``: scap 2^20 and 3.5 M candidate lanes (half a million of
    them live, spread among holes), so the first compaction (the
    candidates' live lanes, 8,192-lane tiles) takes more status words than
    the S + n merge's 16,384-lane tiles on the same scratch."""
    from tla_raft_tpu_torch.parallel.sharded import sieve_merge_plain

    g = np.random.default_rng(len(case))
    scap = 1 << (20 if case == "large" else 14)
    sieve = torch.full((scap,), -1, dtype=torch.int64)
    n_live = {"overflow": scap - 100, "large": 600_000}.get(case, 9000)
    live = _sorted_u64(g, n_live)
    sieve[:live.shape[0]] = live[torch.argsort(live ^ (-(1 << 63)))]
    cv = torch.cat([live[::3], _sorted_u64(g, 300_000 if case == "large" else 5000)])
    cv = cv[torch.argsort(cv ^ (-(1 << 63)))]
    if case == "holes":
        cv[torch.from_numpy(g.random(cv.shape[0]) < 0.4)] = -1
    if case == "large":
        spread = torch.full((3_500_000,), -1, dtype=torch.int64)
        spread[torch.from_numpy(np.sort(g.choice(3_500_000, cv.shape[0], replace=False)))] = cv
        cv = spread
    cv = torch.cat([cv, torch.full((77,), -1, dtype=torch.int64)])
    a = kernels.sieve_merge(sieve.cuda(), cv.cuda())
    b = sieve_merge_plain(sieve, cv)
    assert torch.equal(a[0].cpu(), b[0]) and bool(a[1]) == bool(b[1])
    assert bool(b[1]) == (case == "overflow")


@pytest.mark.parametrize("arm", ["hash", "sorted", "nosieve"])
def test_deep_mesh_on_one_card_equals_the_cpu(run, tmp_path, arm):
    """(3,1,1,0) to its fixpoint on the deep sweep over 8 shards of one
    card at seg_rows 16, equal to the same run on the CPU: the result, the
    exchange ledger and the per-owner stores; the deep kernels launched."""
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    cfg = RaftConfig(n_servers=3, n_vals=1, max_election=1, max_restart=0)
    kw = dict(cap_x=512, deep=True, seg_rows=16, use_hashstore=arm != "sorted",
              sieve=arm != "nosieve", compress=arm != "sorted")
    kernels.reset_launches()
    card = ShardedChecker(cfg, make_mesh(8, devices=["cuda"] * 8),
                          host_store_dir=str(tmp_path / "c"), **kw)
    got = card.run()
    counts = kernels.launch_counts()
    cpu = ShardedChecker(cfg, make_mesh(8, device="cpu"), host_store_dir=str(tmp_path / "p"),
                         **kw)
    want = cpu.run()
    assert got == want
    assert card.meter.summary() == cpu.meter.summary()
    assert [len(s) for s in card.host_stores] == [len(s) for s in cpu.host_stores]
    assert counts["deep_verdict"] > 0 and counts["deep_repack"] > 0 and counts["route"] > 0
    assert (counts["pack_deltas"] > 0) == (arm != "sorted")
    assert (counts["sieve_merge"] > 0) == (arm == "sorted")
    assert (counts["insert_only"] > 0) == (arm == "hash")
    assert counts["hashstore"] == 0


# -- the redesigned kernels on their edge inputs ------------------------------------


@pytest.mark.parametrize("n", [1, 4095, 4097, 1 << 24])
def test_level_dedup_edges_equal_twin(run, n):
    """``level_dedup`` (live lanes, the one-sweep radix sort by fp_view,
    the run heads, the pack) against its twin at 1, 4,095, 4,097 and 2^24
    lanes on every edge kind of ``redesign_cases.dedup_case`` (all SENT, no
    repeats, runs past a tile, ties on fp_full with payloads of both
    signs, top-bit views, an empty store, a store hitting every head), and
    its launches a call."""
    from redesign_cases import DEDUP_KINDS, dedup_case

    for i, kind in enumerate(DEDUP_KINDS):
        store, cv, cf, cp = dedup_case(kind, n, 100 + i)
        tv, tf, ts = (torch.from_numpy(x.view(np.int64).copy()).cuda() for x in (cv, cf, store))
        tp = torch.from_numpy(cp).cuda()
        before = kernels.launch_counts()["level_dedup"]
        k = bfs.level_dedup(tv, tf, tp, ts)
        assert kernels.launch_counts()["level_dedup"] - before == kernels.level_dedup_launches(n)
        p = bfs.level_dedup_plain(tv, tf, tp, ts)
        assert int(k[0]) == int(p[0]), kind
        assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2]), kind


@pytest.mark.parametrize("mode", ["full", "counted", "indexed"])
def test_factored_kernel_edges_equal_twin(scale, mode):
    """K3's factored message part at S=7 against the twin on the edge id
    lists of ``redesign_cases.k3_id_lists`` (no ids, one digit carried by
    every id, every digit present, ids >= 2^15 only, full and random
    lists) over the frontier's rows: every row, under a device count, and
    in the indexed mode (``orbit_fold``) with a count inside its index rows
    and one past them (the overflow word)."""
    from redesign_cases import k3_id_lists

    chk = scale[7]
    fr = _mixed_rows(chk.frontier, 12)
    n, cap_m = fr.voted_for.shape[0], fr.msg_ids.shape[1]
    ids = torch.from_numpy(k3_id_lists(chk.uni, n, cap_m, 7)).to(chk.id_dtype).cuda()
    fr = fr._replace(msg_ids=ids)
    want = chk.fpr.state_fingerprints_plain(fr)
    if mode == "full":
        got = kernels.fingerprints(chk.fpr, fr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    if mode == "counted":
        out = (torch.zeros(n, dtype=torch.int64, device="cuda"),
               torch.zeros(n, dtype=torch.int64, device="cuda"))
        kernels.fingerprints(chk.fpr, fr, out=out, cnt=torch.tensor(n - 5, device="cuda"))
        assert torch.equal(out[0][: n - 5], want[0][: n - 5])
        assert torch.equal(out[1][: n - 5], want[1][: n - 5])
        assert bool((out[0][n - 5:] == -1).all()) and bool((out[1][n - 5:] == -1).all())
        return
    g = np.random.default_rng(8)
    idx = torch.from_numpy(g.permutation(n)[: n // 2].copy()).cuda()
    for count, cap in ((idx.shape[0], idx.shape[0]), (idx.shape[0], idx.shape[0] // 3)):
        out = (torch.full((n,), 7, dtype=torch.int64, device="cuda"),
               torch.full((n,), 9, dtype=torch.int64, device="cuda"))
        ovf = torch.zeros((), dtype=torch.int64, device="cuda")
        before = kernels.launch_counts()
        kernels.fingerprints(chk.fpr, fr, out=out, idx=idx[:cap].contiguous(),
                             cnt=torch.tensor(count, device="cuda"), ovf=ovf)
        after = kernels.launch_counts()
        mask = torch.zeros(n, dtype=torch.bool, device="cuda")
        mask[idx[: min(count, cap)]] = True
        for o, w, fill in ((out[0], want[0], 7), (out[1], want[1], 9)):
            assert torch.equal(o[mask], w[mask]) and bool((o[~mask] == fill).all())
        assert int(ovf) == int(count > cap)
        assert after["orbit_fold"] - before["orbit_fold"] == 1
        assert after["msg_hash_factored"] - before["msg_hash_factored"] == 1


# -- K1 and K2 as redesigned: a group of parents a block, the merge by rank ---------


def _rows(fr, n, seed):
    """``n`` rows drawn from ``fr`` (repeats allowed), contiguous."""
    g = np.random.default_rng(seed)
    idx = torch.from_numpy(g.integers(0, fr.voted_for.shape[0], n)).cuda()
    return Frontier(*(x[idx].contiguous() for x in fr))


def _guards_twin(chk, part):
    """The twin's (valid, mult, abort), in row slices."""
    n = part.voted_for.shape[0]
    out = [chk.mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 2048] for x in part))))
           for i in range(0, n, 2048)]
    return [torch.cat(x) for x in zip(*out)]


@pytest.fixture(scope="module")
def double_vote():
    """A double-vote run on the card to its abort: the frontier holds an
    aborting parent (the split-brain Assert)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    chk = TorchChecker(RaftConfig(n_vals=1, max_election=2, max_restart=1,
                                  mutations=("double-vote",)), device="cuda", chunk=256)
    res = chk.run(max_depth=30)
    assert not res.ok
    return chk


@pytest.fixture(scope="module")
def mutated():
    """Runs on the card under the become-follower mutation (with
    double-vote, so that two leaders of one term occur: to depth 12) and
    the legacy-append mutation (to depth 16); their last frontiers are
    K1's inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    out = {}
    for name, muts, depth in (("become-follower", ("double-vote", "become-follower"), 12),
                              ("legacy-append", ("legacy-append",), 16)):
        chk = TorchChecker(RaftConfig(n_vals=1, max_election=2, max_restart=1, mutations=muts),
                           device="cuda", chunk=256)
        assert chk.run(max_depth=depth).ok
        out[name] = chk
    return out


@pytest.mark.parametrize("S", [3, 5, 7, "double-vote", "become-follower", "legacy-append"])
def test_guards_edges_equal_twin(run, scale, double_vote, mutated, S):
    """K1 against its twin in both forms at B = 1, 7, one block's parents
    (of either form) -1, +0, +1 and 16,384 rows: the per-row form whole; the counted form
    with rows past the device count dead (their valid rows untouched),
    ``mult_acc`` added onto nonzero words, and the first abort (+ base).
    The mutations' cases show their branches taken: under become-follower
    rows that would abort without it; under legacy-append valid
    FollowerAppendEntry slots."""
    chk = {3: run, "double-vote": double_vote}.get(S) or {**scale, **mutated}[S]
    mx, K = chk.mx, chk.K
    from redesign_cases import DIMS, k1_group_parents

    d = dict(zip(DIMS, kernels.dims_array(chk.cfg, chk.uni)))
    edges = {1, 7, 16384}
    for per_row in (True, False):
        per_block = kernels.guards_group_parents(mx, per_row)
        assert per_block == k1_group_parents(d, K, mx.layout.accept_runs[1], per_row)
        edges |= {max(per_block - 1, 1), per_block, per_block + 1}
    for B in sorted(edges):
        part = _rows(chk.frontier, B, B)
        st = chk.inflate(part)
        want = _guards_twin(chk, part)
        got = kernels.guards(mx, st)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (S, B)
        live = max(B - 5, 1)
        valid = torch.ones((B, K), dtype=torch.bool, device="cuda")
        acc = torch.full((K,), 3, dtype=torch.int64, device="cuda")
        first = torch.full((), 1 << 62, dtype=torch.int64, device="cuda")
        kernels.guards(mx, st, valid=valid, per_row=False, cnt=torch.tensor(live + 11).cuda(),
                       sub=11, mult_acc=acc, abort_acc=first, base=1000)
        assert torch.equal(valid[:live], want[0][:live]) and bool(valid[live:].all()), (S, B)
        assert torch.equal(acc, want[1][:live].to(torch.int64).sum(0) + 3), (S, B)
        ab = want[2][:live]
        wf = 1000 + int(torch.nonzero(ab)[0, 0]) if bool(ab.any()) else 1 << 62
        assert int(first) == wf, (S, B)
    if S == "double-vote":
        assert bool(_guards_twin(chk, chk.frontier)[2].any())  # the abort was exercised
    if S == "become-follower":
        st = chk.inflate(chk.frontier)
        without = MXUExpand(RaftConfig(n_vals=1, max_election=2, max_restart=1,
                                       mutations=("double-vote",)), device="cuda")
        assert bool(without.guards_plain(st)[2].any()) and not bool(mx.guards(st)[2].any())
    if S == "legacy-append":
        k7, n7 = mx.layout.accept_runs
        assert bool(_guards_twin(chk, chk.frontier)[0][:, k7:k7 + n7].any())


@pytest.mark.parametrize("S", [3, 7])
def test_materialize_edges_equal_twin(run, scale, S):
    """K2 against its twin at G = 1, 127, 129 and cap_x lanes on int16
    (S=3) and int32 (S=7) ids, on the frontier's lists and on lists cut to
    the widest one (full lists: the largest id drops, ``ovf`` set): the
    (pidx, slot) form; payloads (parent + base) * K + slot with a negative
    base (negative payloads, floor division); and lanes past a device count
    dead (untouched), with ``ovf_any``."""
    chk = run if S == 3 else scale[S]
    mx, K, A = chk.mx, chk.K, chk.mx.A
    fr = chk.frontier
    n = fr.voted_for.shape[0]
    widest = int((fr.msg_ids >= 0).sum(1).max())
    full = fr._replace(msg_ids=fr.msg_ids[:, :widest].contiguous())
    g = np.random.default_rng(S)
    overflowed = False
    for par in (fr, full):
        for G in (1, 127, 129, chk.cap_x):
            pi = torch.from_numpy(g.integers(0, n, G)).cuda()
            sl = torch.from_numpy(g.integers(0, K, G)).cuda()
            want = mx.materialize_plain(par, pi, sl)
            got = mx.materialize(par, pi, sl)
            assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), (S, G)
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), (S, G)
            base = -(n // 2)
            got = kernels.materialize(mx, par, None, None, pay=(pi + base) * K + sl,
                                      pay_base=base)
            assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), (S, G)
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), (S, G)
            live = G - G // 3
            out = (Frontier(*(torch.full((G, *x.shape[1:]), 0x5A, dtype=x.dtype, device="cuda")
                              for x in par)),
                   torch.full((G, A), 77, dtype=torch.int32, device="cuda"),
                   torch.zeros((G,), dtype=torch.bool, device="cuda"))
            ovf_any = torch.zeros((), dtype=torch.int64, device="cuda")
            kernels.materialize(mx, par, pi, sl, out=out, cnt=torch.tensor(live + 4).cuda(),
                                sub=4, ovf_any=ovf_any)
            for a, b in zip(out[0], want[0]):
                assert torch.equal(a[:live], b[:live]) and bool((a[live:] == 0x5A).all())
            assert torch.equal(out[1][:live], want[1][:live]) and bool((out[1][live:] == 77).all())
            assert torch.equal(out[2][:live], want[2][:live]) and not bool(out[2][live:].any())
            assert int(ovf_any) == int(want[2][:live].any())
            overflowed |= bool(want[2].any())
    assert overflowed  # the full lists overflowed somewhere


# -- K3's S <= 3 form and the one-pass compaction (slice 14) -------------------------


@pytest.fixture(scope="module")
def small():
    """Default-path runs on the card at 2 and 4 servers (short depths):
    their frontiers' rows are K3's inputs at S = 2 and 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    out = {}
    for S, args, depth in ((2, dict(n_vals=1, max_election=1, max_restart=1), 8),
                           (4, {}, 7)):
        chk = TorchChecker(RaftConfig(n_servers=S, **args), device="cuda")
        chk.run(max_depth=depth)
        out[S] = chk
    return out


def _k3_case(chk, n, seed):
    """``n`` rows of ``chk``'s frontier with runs of sibling id lists
    (``redesign_cases.k3pairs_sibling_lists``: a parent's list with ids
    added or taken out) in the first half and edge id lists
    (``k3pairs_id_lists``: none, cap_m of them, random, the universe's
    highest ids, one, one pair digit only, every digit) in the second, in
    the frontier's id width."""
    from redesign_cases import k3pairs_id_lists, k3pairs_sibling_lists

    fr = _rows(chk.frontier, n, seed)
    uni, cap_m = chk.uni, fr.msg_ids.shape[1]
    ids = np.concatenate([k3pairs_sibling_lists(uni.M, n // 2, cap_m, seed),
                          k3pairs_id_lists(uni.M, uni.type_offsets, uni.type_strides,
                                           n - n // 2, cap_m, seed)])
    return fr._replace(msg_ids=torch.from_numpy(ids).to(fr.msg_ids.dtype).cuda())


@pytest.mark.parametrize("S", [2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["full", "counted", "indexed"])
def test_k3_written_once_equals_twin(run, scale, small, S, mode):
    """K3 at S = 2 and 3 (``fingerprint_s3``: a persistent grid of 64-state
    groups, staged fields and id lists, a thread a (state, permutation) on
    the message part, each state written once) and at S = 4 and 5
    (``fingerprint_pairs``: the same groups, the message part a warp a
    state through the R rows of its pair digits and the PPERM fold, every
    permutation in one block, each state written once) against the twin on
    the frontier's rows with edge id lists (at S = 4, 5 also one pair
    digit only and every digit): every row; under a device count (the rows
    past it, whole 64-state groups among them and a group cut by it, SENT
    over a buffer that held other values); and at S = 3, 4 and 5 in the
    indexed mode (only the outputs at the index rows below the count
    change; the overflow word)."""
    chk = {2: small[2], 3: run, 4: small[4], 5: scale[5]}[S]
    if mode == "indexed" and S == 2:
        pytest.skip("the indexed mode's S <= 3 form is held at S = 3")
    assert chk.fpr.ktab["form"] == ("s3" if S <= 3 else "pairs")
    n = 1000
    fr = _k3_case(chk, n, S)
    want = chk.fpr.state_fingerprints_plain(fr)
    before = kernels.launch_counts()
    if mode == "full":
        got = kernels.fingerprints(chk.fpr, fr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    elif mode == "counted":
        live = n // 3  # 667 of 1,000 rows dead: group 5 cut, groups 6-15 wholly past live
        out = (torch.full((n,), 7, dtype=torch.int64, device="cuda"),
               torch.full((n,), 9, dtype=torch.int64, device="cuda"))
        kernels.fingerprints(chk.fpr, fr, out=out, cnt=torch.tensor(live + 4, device="cuda"),
                             sub=4)
        assert torch.equal(out[0][:live], want[0][:live])
        assert torch.equal(out[1][:live], want[1][:live])
        assert bool((out[0][live:] == -1).all()) and bool((out[1][live:] == -1).all())
    else:
        g = np.random.default_rng(8)
        idx = torch.from_numpy(g.permutation(n)[: n // 2].copy()).cuda()
        for count, cap in ((idx.shape[0] - 3, idx.shape[0]), (idx.shape[0], idx.shape[0] // 3)):
            out = (torch.full((n,), 7, dtype=torch.int64, device="cuda"),
                   torch.full((n,), 9, dtype=torch.int64, device="cuda"))
            ovf = torch.zeros((), dtype=torch.int64, device="cuda")
            kernels.fingerprints(chk.fpr, fr, out=out, idx=idx[:cap].contiguous(),
                                 cnt=torch.tensor(count, device="cuda"), ovf=ovf)
            mask = torch.zeros(n, dtype=torch.bool, device="cuda")
            mask[idx[: min(count, cap)]] = True
            for o, w, fill in ((out[0], want[0], 7), (out[1], want[1], 9)):
                assert torch.equal(o[mask], w[mask]) and bool((o[~mask] == fill).all())
            assert int(ovf) == int(count > cap)
    after = kernels.launch_counts()
    name = "orbit_fold" if mode == "indexed" else "fingerprint"
    assert after[name] - before[name] == (2 if mode == "indexed" else 1)


@pytest.mark.parametrize("S,form", [(5, "s3"), (7, "pairs")])
def test_k3_refuses_a_form_past_its_limits(scale, S, form):
    """``launch_fingerprints`` takes its form from the caller and refuses
    one asked past that form's limits (the S <= 3 form at S=5's 120
    permutations, the pair-digit form at S=7's 5,040) rather than read the
    table it was given in another layout; nothing is launched."""
    chk = scale[S]
    fr = _k3_case(chk, 64, S)
    saved = chk.fpr.ktab
    chk.fpr.ktab = dict(saved, form=form)
    before = kernels.launch_counts()
    try:
        with pytest.raises(RuntimeError, match="failed to launch"):
            kernels.fingerprints(chk.fpr, fr)
    finally:
        chk.fpr.ktab = saved
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("S", [3, 5, 7])
def test_guards_from_ids_under_graph_replay_equals_inflate_and_k1(run, scale, S):
    """K1's id-list form (the inflate folded into its staging: int16 ids at
    S = 3 and 5, int32 ids >= 2^15 at S = 7) in the counted form a fused
    level launches, captured once into a CUDA graph with a device count and
    replayed at three live counts (a block's group cut, whole groups dead,
    every row), against the inflate kernel followed by K1 on the mask under
    the same counts: the same valid rows (dead rows untouched), per-slot
    sums and first abort; the per-row form from the id lists equals the
    twin's; and each replay adds one ``guards`` launch and no inflate."""
    chk = run if S == 3 else scale[S]
    mx, K, uni = chk.mx, chk.K, chk.uni
    n = 3000
    fr = _rows(chk.frontier, n, S)
    if S == 7:
        fr = fr._replace(msg_ids=_random_ids(uni, n, fr.msg_ids.shape[1], chk.id_dtype, 70))
        assert int(fr.msg_ids.max()) >= 1 << 15
    want = _guards_twin(chk, fr)
    got = kernels.guards(mx, fr)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = RaftState(msgs=bfs.ids_to_msgs(fr.msg_ids, uni.n_words), **core_of(fr))
    cnt = torch.zeros((), dtype=torch.int64, device="cuda")

    def buffers():
        return (torch.ones((n, K), dtype=torch.bool, device="cuda"),
                torch.full((K,), 3, dtype=torch.int64, device="cuda"),
                torch.full((), 1 << 62, dtype=torch.int64, device="cuda"))

    ids_bufs, mask_bufs = buffers(), buffers()
    g = torch.cuda.CUDAGraph()
    tally = kernels.Tally()
    with torch.cuda.graph(g):
        kernels.guards(mx, fr, valid=ids_bufs[0], per_row=False, cnt=cnt, sub=5,
                       mult_acc=ids_bufs[1], abort_acc=ids_bufs[2], base=100)
    tally.take()
    per_block = kernels.guards_group_parents(mx, False)
    for live in (per_block + 3, n // 2, n):
        cnt.fill_(live + 5)
        for b, fresh in zip(ids_bufs + mask_bufs, buffers() + buffers()):
            b.copy_(fresh)
        before = kernels.launch_counts()
        g.replay()
        tally.replay()
        after = kernels.launch_counts()
        assert after["guards"] - before["guards"] == 1
        assert after["inflate"] == before["inflate"]
        msgs = kernels.inflate(fr.msg_ids, uni.n_words, cnt=cnt, sub=5)
        kernels.guards(mx, st._replace(msgs=msgs), valid=mask_bufs[0], per_row=False, cnt=cnt,
                       sub=5, mult_acc=mask_bufs[1], abort_acc=mask_bufs[2], base=100)
        torch.cuda.synchronize()
        assert torch.equal(ids_bufs[0], mask_bufs[0]), (S, live)
        assert torch.equal(ids_bufs[0][:live], want[0][:live]) and bool(ids_bufs[0][live:].all())
        assert torch.equal(ids_bufs[1], mask_bufs[1]), (S, live)
        assert torch.equal(ids_bufs[1], want[1][:live].to(torch.int64).sum(0) + 3), (S, live)
        ab = want[2][:live]
        wf = 100 + int(torch.nonzero(ab)[0, 0]) if bool(ab.any()) else 1 << 62
        assert int(ids_bufs[2]) == int(mask_bufs[2]) == wf, (S, live)


def test_compaction_under_graph_replay_equals_twin(run):
    """The one-pass compaction captured in a CUDA graph (its scratch's
    ticket and status words carried from replay to replay, never reset by
    the host) and replayed with three different live counts: the B3 chunk
    form (rows * K flag lanes under a row count), B9's two-array form and
    the filter form (device lane and payload offsets, the overflow word),
    each equal to its twin after every replay."""
    g = np.random.default_rng(14)
    K, rows, cap = 97, 3000, 40_000
    n = rows * K
    flags = torch.from_numpy(g.random(n) < 0.12).cuda()
    pay = torch.arange(n, dtype=torch.int64, device="cuda")
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)).cuda()
    cnt = torch.zeros((), dtype=torch.int64, device="cuda")
    outs = [torch.empty((cap,), dtype=torch.int64, device="cuda") for _ in range(3)]
    bufs = [torch.full((3 * cap,), 5, dtype=torch.int64, device="cuda") for _ in range(3)]
    totals = [torch.empty((), dtype=torch.int64, device="cuda") for _ in range(3)]
    off = torch.tensor(cap, dtype=torch.int64, device="cuda")
    pay_off = torch.tensor(1 << 33, dtype=torch.int64, device="cuda")
    ovf = torch.zeros((), dtype=torch.int64, device="cuda")
    tiles = [torch.zeros((kernels.compact_tiles(n),), dtype=torch.int64, device="cuda")
             for _ in range(3)]
    keep = flags.clone()

    def calls():
        kernels.compact(flags, None, -1, cap, out_a=outs[0], total=totals[0], cnt=cnt, mul=K,
                        tile=tiles[0])
        kernels.compact(flags, fps, -1, cap, vb=pay, pad_b=-1, out_a=outs[1], out_b=outs[2],
                        total=totals[1], cnt=cnt, mul=K, tile=tiles[1])
        kernels.filter_compact(keep, fps, fps, pay, cap, out=bufs, total=totals[2],
                               out_off=off, pay_off=pay_off, ovf=ovf, tile=tiles[2])

    cnt.fill_(rows)
    calls()  # warm, outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls()
    for live_rows in (rows, 1234, 2999):
        cnt.fill_(live_rows)
        ovf.zero_()
        for b in bufs:
            b.fill_(5)
        graph.replay()
        torch.cuda.synchronize()
        m = live_rows * K
        a = bfs.compact_payloads_plain(flags[:m], pay[:m], cap)
        assert torch.equal(outs[0], a[0]) and int(totals[0]) == int(flags[:m].sum())
        f, p = hs.compact_fresh_plain(flags[:m], fps[:m], pay[:m], cap)
        assert torch.equal(outs[1], f) and torch.equal(outs[2], p)
        w = _keep_twin(keep, (fps, fps, pay + (1 << 33)), (-1, -1, -1), cap)
        for buf, x in zip(bufs, w):
            assert torch.equal(buf[cap:2 * cap], x)
            assert bool((buf[:cap] == 5).all()) and bool((buf[2 * cap:] == 5).all())
        assert int(ovf) == int(int(keep.sum()) > cap)
    del graph


def test_compaction_one_scratch_across_tile_sizes(run):
    """One scratch sized by ``compact_tiles`` for the largest call, through
    compactions on both sides of 2^22 lanes (16,384-lane tiles above it,
    8,192-lane tiles below it: more status words than the larger call's),
    each equal to its twin, and the words past the scratch untouched."""
    g = np.random.default_rng(22)
    big, under = (1 << 22) + 16384 + 9, (1 << 22) - 1
    flags = torch.from_numpy(g.random(big) < 0.01).cuda()
    pay = torch.from_numpy(g.integers(0, 1 << 40, big)).cuda()
    words = kernels.compact_tiles(big)
    assert all(kernels.compact_tiles(m) <= words for m in (under, big - 1, 1, 0))
    guard = torch.zeros((words + 64,), dtype=torch.int64, device="cuda")
    guard[words:] = 12345
    tile = guard[:words]
    for n in (big, under, big, (1 << 21) + 3, under):
        a = kernels.compact(flags[:n], pay[:n], -1, 60_000, tile=tile)
        p = bfs.compact_payloads_plain(flags[:n], pay[:n], 60_000)
        assert torch.equal(a[0], p[0]) and int(a[3]) == int(flags[:n].sum())
        assert bool((guard[words:] == 12345).all())


def _keep_twin(keep, vals, pads, cap):
    """The kept lanes' values in lane order into ``cap`` lanes, each array
    padded with its pad past them."""
    idx = torch.nonzero(keep).reshape(-1)[:cap]
    outs = []
    for v, pad in zip(vals, pads):
        o = torch.full((cap,), pad, dtype=torch.int64, device=v.device)
        o[: idx.shape[0]] = v[idx]
        outs.append(o)
    return outs


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 300_001])
def test_compaction_callers_equal_twins(run, n):
    """Every form of the one-pass compaction against its twin at tile edges:
    ``compact`` with one and two arrays (a lane mask, a live count with
    ``mul``), ``filter_compact`` with device offsets and the overflow word,
    ``chunk_compact`` (flags read from fp_view), and each call's launches
    (``kernels.compact_launches``); flags from unaligned views too."""
    from tla_raft_tpu_torch.engine.group import filter_compact_plain

    g = np.random.default_rng(n)
    raw = torch.from_numpy(g.random(n + 3) < 0.4).cuda()
    flags = raw[3:]  # a view 3 bytes past the allocation: the bytewise loads
    flags_c = flags.contiguous()
    pay = torch.from_numpy(g.integers(0, 1 << 40, n)).cuda()
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)).cuda()
    fps[torch.from_numpy(g.random(n) < 0.3).cuda()] = -1
    for cap in (max(n // 3, 1), n + 5):
        for fl in (flags, flags_c):
            before = kernels.launch_counts()
            a = kernels.compact(fl, pay, -1, cap, want_lane=True)
            assert kernels.launch_counts()["compact"] - before["compact"] == \
                kernels.compact_launches(n)
            p = bfs.compact_payloads_plain(fl, pay, cap)
            assert torch.equal(a[0], p[0]) and torch.equal(a[2], p[1])
            assert int(a[3]) == int(fl.sum())
        f, q = hs.compact_fresh(flags, fps, pay, cap)
        wf, wq = hs.compact_fresh_plain(flags, fps, pay, cap)
        assert torch.equal(f, wf) and torch.equal(q, wq)
        live = n // 2
        c = kernels.compact(flags_c, None, -1, cap, cnt=torch.tensor(live, device="cuda"),
                            iota_base=11)
        p = bfs.compact_payloads_plain(flags_c[:live], 11 + torch.arange(
            live, dtype=torch.int64, device="cuda"), cap)
        assert torch.equal(c[0], p[0]) and int(c[3]) == int(flags_c[:live].sum())
        hit = torch.from_numpy(g.random(n) < 0.3).cuda()
        outs = tuple(torch.full((2 * cap + 1,), 5, dtype=torch.int64, device="cuda")
                     for _ in range(3))
        ovf = torch.zeros((), dtype=torch.int64, device="cuda")
        kernels.filter_compact((fps != -1) & ~hit, fps, fps, pay, cap, out=outs,
                               out_off=torch.tensor(cap, device="cuda"),
                               pay_off=torch.tensor(7, device="cuda"), ovf=ovf)
        wv, wf2, wp, wo = filter_compact_plain(hit, fps, fps, pay, cap)
        for o, w in zip(outs, (wv, wf2, torch.where(wp >= 0, wp + 7, wp))):
            assert torch.equal(o[cap:2 * cap], w) and bool((o[:cap] == 5).all())
        assert int(ovf) == int(bool(wo))
        k = bfs.chunk_compact(fps, fps, cap, 5)
        w = bfs.chunk_compact_plain(fps, fps, cap, 5)
        assert all(torch.equal(x, y) for x, y in zip(k[:3], w[:3]))
        assert bool(k[3]) == (int(w[3]) > cap)


# -- captures on the prewarm thread (engine/megakernel.py, engine/bfs.py) -------------------


def _level_case(depth: int = 10):
    """A reference-constants checker run to ``depth`` on the card (prewarm
    off), with its frontier, the key and builder of the next fused level's
    program, and the programs' signature."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph captures have no CPU mode)")
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=1024, prewarm=False)
    chk.run(max_depth=depth)
    fr = chk.frontier
    n_f = fr.voted_for.shape[0]
    cap_f = chk._rows_cap(fr)
    cap_out = chk._mega_cap_out(n_f, [1] * (depth + 1), None, (cap_f // chk.chunk) * chk.cap_x, 0)
    key = ("level", cap_f, cap_out, chk.chunk)

    def make(eng, k):
        return mk.LevelProgram(eng, k, cap_f, cap_out, eng.k4_rounds)

    sig = chk._sig()
    chk._progs.drop_stale(sig)  # the signature as the next launch would set it
    return chk, fr, n_f, key, make, sig


def _level_outputs(chk, prog, fr, n_f, slab0):
    """One launch of a fused-level program from ``fr`` against the slab as it
    was (restored in place after): its control words and survivors."""
    mk.copy_rows(prog.fr_in, fr, n_f)
    prog.run(n_f)
    out = [x.clone() for x in (prog.ctrl, prog.mult, prog.fps_out, prog.pidx, prog.slot)]
    chk.hstore.slab.copy_(slab0)
    return out


def test_prewarm_thread_capture_keeps_counts_exact():
    """A fused level captured on the prewarm thread while the main thread
    replays an in-line-captured graph of the same shape and launches kernels
    eagerly: the process-wide launch counts are exactly the main thread's
    (the capture's launches go to its own tally), the two graphs launch the
    same kernels a replay, and the prewarmed graph's outputs equal the in-line
    graph's."""
    import threading

    chk, fr, n_f, key, make, sig = _level_case()
    slab0 = chk.hstore.slab.clone()
    inline = make(chk, key + sig)
    inline.capture("main")
    want = _level_outputs(chk, inline, fr, n_f, slab0)
    kernels.reset_launches()
    th = threading.Thread(target=chk._plan_entry(key, make, sig)[1])
    th.start()
    replays = eager = 0
    while th.is_alive() or replays < 3:
        _level_outputs(chk, inline, fr, n_f, slab0)
        replays += 1
        chk.inv_scan(fr)  # one eager launch of inv_scan
        eager += 1
    th.join()
    counts = kernels.launch_counts()
    expect = {k: replays * v for k, v in inline.tally.per_replay.items()}
    expect["inv_scan"] += eager
    assert counts == expect
    pre = chk._progs.progs[key + sig]
    assert pre.graph is not None and pre.tally.per_replay == inline.tally.per_replay
    assert chk.graph_stats["prewarm_captures"] == 1
    got = _level_outputs(chk, pre, fr, n_f, slab0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert chk._progs.get(key + sig, lambda: None, set()) is pre
    assert chk._progs.stats["prewarm_hits"] == 1


def test_drop_stale_during_a_prewarm_capture():
    """``drop_stale`` while the prewarm thread is capturing: the capture
    ends, the program is found stale and released (counted wasted), nothing
    waits to be released, and the device memory the program took is given
    back."""
    import threading

    chk, fr, n_f, key, make, sig = _level_case()
    chk._progs.clear()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    in_capture, go_on = threading.Event(), threading.Event()

    def slow_make(eng, k):
        prog = make(eng, k)
        record = prog.record

        def held():
            in_capture.set()
            go_on.wait(60)
            record()

        prog.record = held
        return prog

    th = threading.Thread(target=chk._plan_entry(key, slow_make, sig)[1])
    th.start()
    assert in_capture.wait(60)
    chk._progs.drop_stale(("another",) + sig[1:])
    go_on.set()
    th.join(120)
    assert not th.is_alive()
    assert key + sig not in chk._progs.progs and not chk._progs.capturing
    assert chk._progs.stats["prewarm_wasted"] == 1 and chk.graph_stats["prewarm_captures"] == 1
    assert not mk._RELEASE
    import gc

    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before


def test_main_capture_goes_first():
    """The main thread wants the capture lock while the prewarm thread is
    inside a capture: the prewarm capture gives way at its next launch
    (nothing filed, one yield counted), the main thread's capture runs,
    no launch is counted by either capture, and the main thread's graph
    gives the in-line graph's outputs."""
    import threading

    chk, fr, n_f, key, make, sig = _level_case()
    slab0 = chk.hstore.slab.clone()
    in_capture, go_on = threading.Event(), threading.Event()
    got = {}

    def slow_make(eng, k):
        prog = make(eng, k)
        record = prog.record

        def held():
            in_capture.set()
            go_on.wait(60)
            record()

        prog.record = held
        return prog

    def pre():
        got["res"] = chk._progs.prewarm(key + sig, lambda: slow_make(chk, key + sig))

    kernels.reset_launches()
    mains = chk.graph_stats["main_captures"]  # the run's own
    th = threading.Thread(target=pre)
    th.start()
    assert in_capture.wait(60)
    threading.Timer(0.5, go_on.set).start()
    mine = make(chk, key + sig)
    assert mine.capture("main")
    th.join(120)
    assert got["res"] == "yielded" and key + sig not in chk._progs.progs
    assert chk.graph_stats["prewarm_yields"] == 1
    assert chk.graph_stats["main_captures"] == mains + 1
    assert all(v == 0 for v in kernels.launch_counts().values())
    ref = make(chk, ("ref",) + sig)
    ref.capture("main")
    want = _level_outputs(chk, ref, fr, n_f, slab0)
    assert all(torch.equal(a, b) for a, b in zip(_level_outputs(chk, mine, fr, n_f, slab0), want))


def test_profile_records_device_lanes(tmp_path):
    """``--profile 1`` on the card (``run_check(profile=1)``): the capture
    of the first window (the superstep of levels 1-4), merged by ``obs
    trace``, holds the card's kernels by name, K1-K4 among them, on the
    hub's clock; the counts are the run's."""
    import json
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler's CUDA lanes)")
    from tla_raft_tpu_torch.check import run_check
    from tla_raft_tpu_torch.obs import tracefile

    d = str(tmp_path / "run")
    s = run_check(RaftConfig(), max_depth=8, chunk=1024, device="cuda", checkpoint_dir=d,
                  profile=1)
    assert s["level_sizes"] == [1, 1, 3, 9, 22, 57, 136, 345, 931]
    assert s["telemetry"]["profile_windows"] == 1
    out = str(tmp_path / "trace.json")
    st = tracefile.export(os.path.join(d, "events.jsonl"), out, run_dir=d)
    assert st["device_events"] > 0
    doc = json.load(open(out))
    lanes = [e for e in doc["traceEvents"]
             if e.get("pid", 0) >= tracefile.DEVICE_PID_BASE and e.get("ph") == "X"
             and (e.get("args") or {}).get("cat") == "kernel"]
    names = {e["name"] for e in lanes}
    for k in ("guards_kernel", "materialize_kernel", "fingerprint_s3", "probe_first"):
        assert any(k in n for n in names), (k, sorted(names)[:20])
    begin = next(e for e in doc["traceEvents"] if e["name"] == "profiler start")
    assert min(e["ts"] for e in lanes) >= begin["ts"] - 1000  # within 1 ms of the anchor
