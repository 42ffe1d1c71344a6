"""The invariant scan's persistent tiled walk (csrc/invariants.cu) and
the level control's one launch a group (csrc/level.cu), on the CPU
against the reference:

* a numpy model of the tiled scan (``redesign_cases.inv_tiles_model``:
  tiles in order up to a live count read from a device word, per-block
  minima, the skip past the running minimum, the row offset, the fold
  into an earlier result) over the port's predicates, against
  ``JaxChecker._inv_scan_impl`` over the reference's, for every predicate
  and two negations at 3, 5 and 7 servers, the first bad row in the first
  tile, a middle tile or the last partial tile, and a live count of 0;
* the fused level's single scan, and ``materialize_level``'s (on the
  fused rows and after a grouped level), against the reference's fused
  level on a level whose first violating row lies slices past the first;
* ``lv_group_step``'s twin against the reference's grouped level with one
  group's chunk past cap_x and another group's abort;
* ``lv_finalize``'s twin: pidx / slot over the first n_new lanes only.

All outputs are integers: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tla_raft_tpu.ops.hashstore as ref_hs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine import megakernel as ref_mk
from tla_raft_tpu.engine.bfs import Frontier as RefFrontier
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.engine.invariants import resolve_invariant_kernel as ref_resolve
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import group
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.engine.invariants import (INVARIANT_KERNELS, inv_scan_plain,
                                                  resolve_invariant_kernel)
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.ops.successor import GuardTables
from redesign_cases import IV_ROWS, inv_tiles_model
from torch_port_corpus import batches, configs

NAMES = sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]
SPACES = {3: (3, 1, 1, 1), 5: (5, 1, 1, 0), 7: (7, 1, 1, 0)}
N_ROWS = 3 * IV_ROWS + 77  # three whole tiles and a partial one
PLACES = {"first_tile": 5, "middle_tile": IV_ROWS + 100, "last_partial_tile": 3 * IV_ROWS + 50}


@functools.lru_cache(maxsize=None)
def _pool(S: int):
    """Reachable states at S servers and as many rows mixed from them (each
    field from its own state; in one row of eight server 1 a leader whose
    log is shorter than server 2's commit), in both packages' types, with
    each package's tables."""
    rc, pc = configs(SPACES[S])
    ref_st, port, _fr = batches(SPACES[S], n=300)
    g = np.random.default_rng(S)
    n = port.role.shape[0]
    both = {}
    for f, x in zip(port._fields, ref_st):
        a = np.asarray(x)
        both[f] = np.concatenate([a, a[g.integers(0, n, n)]])
    rows = np.concatenate([np.zeros(n, bool), g.random(n) < 0.125])
    L = both["log_term"].shape[-1]
    both["role"][rows, 0] = 2  # LEADER
    both["log_len"][rows, 0] = 1
    both["current_term"][rows, 1] = 0
    both["commit_index"][rows, 1] = L
    ref_pool = type(ref_st)(**both)
    port_pool = type(port)(**{f: torch.from_numpy(a.view(np.int32) if f == "msgs" else a)
                              for f, a in both.items()})
    return rc, pc, ref_pool, port_pool, get_kernel(rc, mxu=True).tables, GuardTables(pc, "cpu")


def _placed(bad: np.ndarray, place: int, seed: int):
    """Pool rows for a batch of N_ROWS whose first bad row is at ``place``
    (good rows before it, any rows after), or None where the pool has no
    good or no bad row for the predicate."""
    good, badi = np.flatnonzero(~bad), np.flatnonzero(bad)
    if not len(good) or not len(badi):
        return None
    g = np.random.default_rng(seed)
    return np.concatenate([g.choice(good, place), g.choice(badi, 1),
                           g.integers(0, bad.shape[0], N_ROWS - place - 1)])


def _fold(bad: int, earlier: int) -> int:
    """The checker's fold of a scan into an earlier result (-1: none)."""
    return earlier if earlier >= 0 and (bad < 0 or earlier < bad) else bad


@pytest.mark.parametrize("place", sorted(PLACES))
@pytest.mark.parametrize("S", [3, 5, 7])
def test_tiled_scan_model_equals_reference(S, place):
    rc, pc, ref_pool, port_pool, ref_tables, tables = _pool(S)
    at = PLACES[place]
    placed = 0
    for k, name in enumerate(NAMES):
        ref_bad = ~np.asarray(ref_resolve(name)(rc, ref_pool, ref_tables))
        assert np.array_equal(~resolve_invariant_kernel(name)(pc, port_pool, tables).numpy(),
                              ref_bad), name
        idx = _placed(ref_bad, at, 100 * S + k)
        if idx is None:
            continue
        placed += 1
        bad = ref_bad[idx]
        ref_rows = type(ref_pool)(*(np.asarray(x)[idx] for x in ref_pool))
        port_rows = type(port_pool)(*(x[torch.from_numpy(idx)] for x in port_pool))
        fake = types.SimpleNamespace(inv_fns=[(name, ref_resolve(name))], cfg=rc,
                                     kern=types.SimpleNamespace(tables=ref_tables))
        for live in (N_ROWS, at + 1, at, 100, 0):
            ref_first = int(JaxChecker._inv_scan_impl(fake, ref_rows, live))
            assert ref_first == (at if live > at else -1), (name, live)
            for offset in (0, 1000):
                want_scan = ref_first + offset if ref_first >= 0 else -1
                if live:
                    sub = type(port_rows)(*(x[:live] for x in port_rows))
                    port_scan = int(inv_scan_plain(pc, sub, [name], tables, offset))
                else:
                    port_scan = -1  # no live row: the twin is not called
                assert port_scan == want_scan, (name, live, offset)
                for earlier in (-1, 3, at + offset + 1, 10_000):
                    want = _fold(want_scan, earlier)
                    for grid in (1, 3, 64):
                        got, evaluated = inv_tiles_model(bad, offset, earlier, cnt=live + 7,
                                                         sub=7, grid=grid, seed=grid + live)
                        assert got == want, (name, live, offset, earlier, grid)
                        assert evaluated <= -(-live // IV_ROWS)
                        if 0 <= earlier <= offset:  # every tile starts past it
                            assert evaluated == 0
    assert placed >= 4


def test_tiled_scan_model_live_count_from_the_device_word():
    """The live count is min(n, max(0, cnt - sub)): rows past it are never
    scanned, a count below sub scans nothing, and no count scans all."""
    bad = np.zeros(N_ROWS, bool)
    bad[[40, 700]] = True
    assert inv_tiles_model(bad)[0] == 40
    assert inv_tiles_model(bad, cnt=40, grid=4)[0] == -1
    assert inv_tiles_model(bad, cnt=500, sub=460, grid=4)[0] == -1
    assert inv_tiles_model(bad, cnt=500, sub=459, offset=9)[0] == 49
    assert inv_tiles_model(bad, cnt=100, sub=400, grid=2) == (-1, 0)
    assert inv_tiles_model(bad, cnt=10 ** 9, grid=5)[0] == 40
    bad[40] = False
    assert inv_tiles_model(bad, cnt=701, grid=5, seed=3)[0] == 700
    assert inv_tiles_model(bad, cnt=700, grid=5, seed=3)[0] == -1


# -- the level's single scan against the reference's fused level --------------------

MEDIAN = (3, 1, 2, 0)
CHUNK = 16


@pytest.fixture(scope="module")
def violating_level():
    """(3,1,2,0) with the median bug to depth 10 at chunk 16: level 11's
    691 parents (a capacity of whole chunks, as numpy), their slab, the
    budgets, and the reference's fused level program over them (ctrl,
    pidx, slot) at cap_out 2048."""
    chk = TorchChecker(RaftConfig(*MEDIAN, mutations=("median-bug",)), device="cpu",
                       chunk=CHUNK)
    assert chk.run(max_depth=10).ok
    fr = chk.frontier
    n_f = fr.voted_for.shape[0]
    cap_f = -(-n_f // CHUNK) * CHUNK
    pad = mk.empty_frontier(chk.cfg, cap_f, chk.cap_m, "cpu")
    mk.copy_rows(pad, fr, n_f)
    fields = {f: getattr(pad, f).numpy() for f in Frontier._fields}
    slab = carry.slab_to_numpy(chk.hstore.slab)
    ref = JaxChecker(RefConfig(*MEDIAN, mutations=("median-bug",)), chunk=CHUNK, cap_x=chk.cap_x,
                     cap_m=chk.cap_m, megakernel=True, superstep=1)
    prog = ref_mk.build_level_program(ref, donate=False)
    _new, _slab2, ctrl, _mult, _fps, pidx, slot = prog(
        RefFrontier(*(jnp.asarray(fields[f]) for f in RefFrontier._fields)), jnp.asarray(slab),
        jnp.asarray(n_f, jnp.int64), jnp.zeros((1,), jnp.uint64), cap_out=2048)
    return dict(fields=fields, n_f=n_f, slab=slab, cap_x=chk.cap_x, cap_m=chk.cap_m,
                count=chk.hstore.count, ctrl=np.asarray(ctrl), pidx=np.asarray(pidx),
                slot=np.asarray(slot))


def _port_at(lv, **kw):
    chk = TorchChecker(RaftConfig(*MEDIAN, mutations=("median-bug",)), device="cpu",
                       chunk=CHUNK, cap_x=lv["cap_x"], cap_m=lv["cap_m"], **kw)
    chk.hstore = hs.DeviceHashStore(len(lv["slab"]), lv["count"], "cpu")
    chk.hstore.slab = carry.slab(lv["slab"], "cpu")
    return chk, carry.frontier(lv["fields"], "cpu")


def test_fused_level_single_scan_equals_reference(violating_level):
    """One scan over the level's whole output buffer after its materialize
    slices: the reference's first bad row (past two slices of 8 chunks),
    every ctrl slot, and pidx / slot of the n_new survivors."""
    lv = violating_level
    ctrl = lv["ctrl"]
    n_new, bad = int(ctrl[mk.CTRL_N_NEW]), int(ctrl[mk.CTRL_BAD])
    assert 0 < n_new <= 2048 and bad >= 2 * mk.mat_slice_width(2048, CHUNK)
    chk, fr = _port_at(lv, superstep=1)
    prog = mk.LevelProgram(chk, ("test",), fr.voted_for.shape[0], 2048, mk.DEFAULT_ROUNDS)
    mk.copy_rows(prog.fr_in, fr, fr.voted_for.shape[0])
    calls = []
    orig = mk.op_inv_scan

    def spy(eng, rows, offset, into, cnt, sub):
        calls.append((rows.voted_for.shape[0], offset, sub))
        return orig(eng, rows, offset, into, cnt, sub)

    mk.op_inv_scan = spy
    try:
        prog.run(lv["n_f"])
    finally:
        mk.op_inv_scan = orig
    assert calls == [(2048, 0, 0)]  # one scan a level, over the whole buffer
    assert np.array_equal(prog.ctrl.numpy(), ctrl)
    assert int(prog.lc[mk.LC_BAD]) == bad
    assert np.array_equal(prog.pidx.numpy().view(np.uint32)[:n_new], lv["pidx"][:n_new])
    assert np.array_equal(prog.slot.numpy().view(np.uint16)[:n_new], lv["slot"][:n_new])


def test_materialize_level_single_scan_equals_reference(violating_level):
    """``materialize_level`` (the staged and grouped levels' survivors, in
    slices of 8 chunks, then one scan): the reference fused level's bad
    row, from its survivors' payloads and from a grouped level's (G = 2:
    22 groups)."""
    lv = violating_level
    ctrl = lv["ctrl"]
    n_new, bad = int(ctrl[mk.CTRL_N_NEW]), int(ctrl[mk.CTRL_BAD])
    chk, fr = _port_at(lv)
    n_f = lv["n_f"]
    parents = mk.rows_of(fr, 0, n_f)
    K = chk.K
    pay = torch.from_numpy(lv["pidx"][:n_new].astype(np.int64) * K + lv["slot"][:n_new])
    scans = []
    orig = chk.inv_scan
    chk.inv_scan = lambda *a, **k: scans.append(a[0].voted_for.shape[0]) or orig(*a, **k)
    new, got, ovf = chk.materialize_level(parents, pay, n_new)
    assert (got, ovf, scans) == (bad, False, [n_new])
    assert n_new > 4 * 8 * CHUNK  # five or more slices
    chk2, fr2 = _port_at(lv)
    chk2.G = 2
    chk2.cap_g = chk2.G * chk2.cap_x // 2
    res, par = chk2._expand_level_grouped(mk.rows_of(fr2, 0, n_f), n_f, 10)
    assert res["groups"] == -(-n_f // (2 * CHUNK)) and res["n_new"] == n_new
    assert torch.equal(res["new_payload"][:n_new], pay)
    _new, got, _ovf = chk2.materialize_level(par, res["new_payload"], n_new)
    assert got == bad


# -- the group control against the reference's grouped level ------------------------

DOUBLE = (3, 1, 2, 0)


@pytest.fixture(scope="module")
def double_vote_level():
    """(3,1,2,0) with the double-vote bug to depth 8 at chunk 8: level 9's
    180 parents, whose expansion aborts at parent 36 (group 4 at G = 1)
    and whose chunk 16 holds 42 valid lanes, past a cap_x of 41 (each
    other chunk holds 40 or fewer)."""
    chk = TorchChecker(RaftConfig(*DOUBLE, mutations=("double-vote",)), device="cpu", chunk=8)
    assert chk.run(max_depth=8).ok
    fr = chk.frontier
    n_f = fr.voted_for.shape[0]
    pad = mk.empty_frontier(chk.cfg, -(-n_f // 8) * 8, chk.cap_m, "cpu")
    mk.copy_rows(pad, fr, n_f)
    return dict(fields={f: getattr(pad, f).numpy() for f in Frontier._fields}, n_f=n_f,
                slab=carry.slab_to_numpy(chk.hstore.slab), count=chk.hstore.count,
                cap_m=chk.cap_m)


def test_group_step_control_words_equal_reference_grouped_level(double_vote_level):
    """The grouped level with one control launch a group (``lv_group_step``
    closing the previous group, the tail gate closing the last): the
    reference grouped level's abort row, cap_x and cap_g overflows and
    mult, and a gate that inserts nothing."""
    lv = double_vote_level
    n_f, cap_x, cap_g = lv["n_f"], 41, 20
    ref = JaxChecker(RefConfig(*DOUBLE, mutations=("double-vote",)), chunk=8, cap_x=cap_x,
                     cap_m=lv["cap_m"])
    ref.G, ref.cap_g = 1, cap_g
    ref.hstore = ref_hs.DeviceHashStore(len(lv["slab"]), lv["count"])
    ref.hstore.slab = jnp.asarray(lv["slab"])
    frontier = RefFrontier(*(jnp.asarray(lv["fields"][f]) for f in RefFrontier._fields))
    _n, _fps, _pay, ab, ovf, ovf_g, _ovf_h, mult = ref._expand_level_device(frontier, n_f, None)
    assert ab == 36 and ovf
    chk = TorchChecker(RaftConfig(*DOUBLE, mutations=("double-vote",)), device="cpu", chunk=8,
                       cap_x=cap_x, cap_m=lv["cap_m"])
    chk.G, chk.cap_g = 1, cap_g
    chk.hstore = hs.DeviceHashStore(len(lv["slab"]), lv["count"], "cpu")
    chk.hstore.slab = carry.slab(lv["slab"], "cpu")
    fr = carry.frontier(lv["fields"], "cpu")
    steps = []
    orig = group.op_group_step
    group.op_group_step = lambda lc, *a: steps.append(int(lc[group.LC_GROUP])) or orig(lc, *a)
    try:
        res = group.expand_level_grouped(chk, fr, n_f, 23)
    finally:
        group.op_group_step = orig
    assert steps == list(range(23))  # one control launch a group
    assert (res["abort_at"], res["ovf_x"], res["ovf_g"]) == (ab, bool(ovf), bool(ovf_g))
    assert np.array_equal(res["mult"], np.asarray(mult))
    prog = next(iter(chk._progs.progs.values()))
    assert int(prog.lc[group.LC_GROUP]) == 23 and int(prog.lc[mk.LC_LIVE_LANES]) == 0
    assert res["n_new"] == 0 and np.array_equal(carry.slab_to_numpy(chk.hstore.slab), lv["slab"])


def test_group_step_twin_folds_each_group_once():
    """The twins' sequence: a step a group closes the group before it (its
    chunk totals and abort, at the rows before it), the tail gate closes
    the last; as the reference's grouped algebra (abort = the least global
    row, overflow = any chunk total past cap_x) over seeded groups."""
    g = np.random.default_rng(12)
    rows, K, cap_g, cap_x, G = 64, 5, 32, 40, 4
    for trial in range(20):
        n_groups = int(g.integers(1, 9))
        n_run = int(g.integers((n_groups - 1) * rows + 1, n_groups * rows + 1))
        totals = g.integers(0, cap_x + 1, (n_groups, G))
        aborts = np.where(g.random(n_groups) < 0.3, g.integers(0, rows, n_groups), -1)
        if trial % 3 == 0:
            totals[g.integers(n_groups), g.integers(G)] = cap_x + 1
        lc = torch.zeros(mk.LC_LEN, dtype=torch.int64)
        mk.level_begin_plain(lc, torch.zeros(K, dtype=torch.int64), torch.tensor(n_run))
        buf = torch.zeros(G, dtype=torch.int64)
        for i in range(n_groups):
            group.group_step_plain(lc, buf, cap_x, rows, K, cap_g)
            assert int(lc[group.LC_G_RUN]) == min(rows, n_run - i * rows)
            assert int(lc[group.LC_G_OUT]) == i * cap_g and int(lc[group.LC_G_PAY]) == i * rows * K
            buf.copy_(torch.from_numpy(totals[i]))
            if aborts[i] >= 0:
                lc[group.LC_G_ABORT] = int(aborts[i])
        group.tail_gate_plain(lc, buf, cap_x, rows, n_groups * cap_g)
        rows_hit = [i * rows + int(a) for i, a in enumerate(aborts) if a >= 0]
        ab = min(rows_hit) if rows_hit else mk.BIG
        ovf = bool((totals > cap_x).any())
        assert int(lc[mk.LC_ABORT]) == ab and bool(lc[mk.LC_OVF_X]) == ovf
        assert int(lc[group.LC_GROUP]) == n_groups
        gated = ovf or ab < n_run
        assert int(lc[mk.LC_LIVE_LANES]) == (0 if gated else n_groups * cap_g)


@pytest.mark.parametrize("n_new", [0, 300, 511, 512, 900])
def test_level_finalize_twin_writes_only_the_survivors(n_new):
    """pidx / slot of the first n_new lanes as the reference casts them
    (payload // K as u32, payload % K as u16), the lanes past n_new as
    they were, and ctrl in the reference's layout."""
    K = 696
    pay = np.random.default_rng(n_new).integers(-1, 1 << 40, 512)
    lc = torch.zeros(mk.LC_LEN, dtype=torch.int64)
    lc[mk.LC_N_NEW] = n_new
    lc[mk.LC_BAD] = 77
    ctrl = torch.zeros(mk.CTRL_LEN, dtype=torch.int64)
    pidx = torch.full((512,), 9, dtype=torch.int32)
    slot = torch.full((512,), 4, dtype=torch.int16)
    mk.level_finalize_plain(lc, ctrl, torch.from_numpy(pay), K, pidx, slot)
    live = min(n_new, 512)
    ref_p = np.asarray((jnp.asarray(pay) // K).astype(jnp.uint32))
    ref_s = np.asarray((jnp.asarray(pay) % K).astype(jnp.uint16))
    assert np.array_equal(pidx.numpy().view(np.uint32)[:live], ref_p[:live])
    assert np.array_equal(slot.numpy().view(np.uint16)[:live], ref_s[:live])
    assert bool((pidx[live:] == 9).all()) and bool((slot[live:] == 4).all())
    assert int(ctrl[mk.CTRL_N_NEW]) == n_new and int(ctrl[mk.CTRL_BAD]) == 77
