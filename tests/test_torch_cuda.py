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

from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine.bfs import TorchChecker, compact_payloads
from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, inv_scan_plain
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.ops.hashstore import probe_and_insert, probe_and_insert_plain

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


def test_hashstore_kernel_equals_twin(run):
    fr = run.frontier
    cv, cf, cp, *_ = run._expand_chunk(Frontier(*(x[:1024] for x in fr)), 0)
    slab = run.hstore.slab
    k = probe_and_insert(slab.clone(), cv, cf, cp)
    p = probe_and_insert_plain(slab.clone(), cv, cf, cp)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert int(k[2]) == int(p[2]) and bool(k[3]) == bool(p[3])


def test_hashstore_kernel_overflow_leaves_the_slab(run):
    """A nearly full slab: the kernel's insert overflows and undoes its
    claims, and its fresh lanes and counts still equal the twin's."""
    g = np.random.default_rng(1)
    slab = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 1024, dtype=np.int64)).cuda()
    slab[torch.from_numpy(g.choice(1024, 3, replace=False)).cuda()] = -1
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 200, dtype=np.int64)).cuda()
    keys, pays = fps.clone(), torch.arange(200, device="cuda")
    before = slab.clone()
    k = probe_and_insert(slab, fps, keys, pays)
    p = probe_and_insert_plain(before.clone(), fps, keys, pays)
    assert bool(k[3]) and bool(p[3])
    assert torch.equal(slab, before) and torch.equal(k[1], p[1]) and int(k[2]) == int(p[2])


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


def test_group_control_kernels_equal_twins(run):
    from tla_raft_tpu_torch.engine import group
    from tla_raft_tpu_torch.engine import megakernel as mk

    totals = torch.tensor([10, 300, 5])
    outs = []
    for device in ("cuda", "cpu"):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=device)
        mk.op_level_begin(lc, torch.zeros(7, dtype=torch.int64, device=device),
                          torch.tensor(2500, device=device))
        rows = []
        for g in range(3):
            group.op_group_begin(lc, 1000, 7, 64)
            lc[group.LC_G_ABORT] = 900 if g == 1 else mk.BIG
            group.op_group_end(lc, totals.to(device) if g == 2 else totals[:1].to(device), 256,
                               1000)
            rows.append(lc.clone())
        group.op_tail_gate(lc, 192)
        outs.append([x.cpu() for x in rows + [lc]])
    assert int(outs[0][-1][mk.LC_ABORT]) == 1900 and int(outs[0][-1][mk.LC_OVF_X]) == 1
    assert all(torch.equal(a, b) for a, b in zip(*outs))


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
    """K3 (monolithic at S=5, factored at S=7) on the frontier, on mixed
    rows and on random id lists equals the plain twin, and the launches
    land on its counters."""
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
