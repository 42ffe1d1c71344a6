"""The port at 5 and 7 servers (BASELINE.md configs 3 and 5): its tables,
its pair-block factored message hash, its state fingerprints, its int32
message ids and its BFS against the reference, on the CPU.

At S=7 the permutation-folded message table would be 2.7 GB, so both
packages pick the pair-block factored form there; at S=3 and S=5 the
forced factored form must equal the monolithic one bit for bit.  The K3
kernel's own tables (``kernel_tables_np``: effective u32 coefficients)
are held here against the plain twin through a numpy model of the
kernel's arithmetic; the kernel itself is held against the twin on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.models.raft import RaftState as RefState
from tla_raft_tpu.ops.fingerprint import Fingerprinter as RefFingerprinter
from tla_raft_tpu.ops.msg_universe import MsgUniverse as RefUniverse
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.check import main as check_main
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker, default_chunk
from tla_raft_tpu_torch.models.raft import Frontier, id_dtype
from tla_raft_tpu_torch.ops.fingerprint import FeatureSpec, Fingerprinter
from tla_raft_tpu_torch.ops.msg_universe import MsgUniverse
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand, ids_insert
from tla_raft_tpu_torch.u64 import _combine_planes_u32

from redesign_cases import k3_id_lists

# level sizes of the reference's runs at the Raft.cfg constants
# (docs/BENCH_S5_r05.json.log, docs/BENCH_S7_r05b.log)
GOLDEN_S5 = (1, 1, 3, 9, 24, 66, 169, 401)
GOLDEN_S7 = (1, 1, 3, 9, 24, 66, 171)
# the small spaces of tests/test_s5.py / tests/test_s7.py (V=1, E=1, R=0)
SMALL = dict(n_vals=1, max_election=1, max_restart=0)


def _cfgs(S, **kw):
    return RefConfig(n_servers=S, **kw), RaftConfig(n_servers=S, **kw)


@pytest.fixture(scope="module")
def fprs():
    """(reference, port) Fingerprinters at S=5 and S=7, built once."""
    out = {}
    for S in (5, 7):
        rc, pc = _cfgs(S)
        out[S] = (RefFingerprinter(rc), Fingerprinter(pc, device="cpu"))
    return out


@pytest.fixture(scope="module")
def frontiers():
    """The port's depth-6 frontier of the Raft.cfg constants at S=5 and
    S=7 (169 and 171 states), from a CPU BFS held to the golden prefix."""
    out = {}
    for S, golden in ((5, GOLDEN_S5[:7]), (7, GOLDEN_S7)):
        chk = TorchChecker(RaftConfig(n_servers=S), device="cpu")
        res = chk.run(max_depth=6)
        assert res.ok and res.level_sizes == golden
        out[S] = chk
    return out


def _packed(uni, rows: int, seed: int, density: float) -> np.ndarray:
    """Seeded random packed bitmasks u32 [rows, n_words] (no bits past M)."""
    g = np.random.default_rng(seed)
    bits = (g.random((rows, uni.n_words * 32)) < density).astype(np.uint64)
    bits[:, uni.M:] = 0
    words = (bits.reshape(rows, -1, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32)


def _bits(uni, packed: np.ndarray) -> np.ndarray:
    sh = np.arange(32, dtype=np.uint32)
    return ((packed[:, :, None] >> sh) & 1).reshape(packed.shape[0], -1)[:, : uni.M]


# -- tables ------------------------------------------------------------------------


@pytest.mark.parametrize("S", [5, 7])
def test_scale_tables_match(S, fprs):
    """Universe, symmetry group, feature layout, guard and materialize
    tables, and the fingerprint tables (monolithic at S=5, pair-block at
    S=7, carried across through carry.py) equal the reference's."""
    rc, pc = _cfgs(S)
    ru, pu = RefUniverse(rc), MsgUniverse(pc)
    for name in ("M", "n_words", "type_offsets", "type_strides", "ap_pli_min", "ap_npli"):
        assert getattr(ru, name) == getattr(pu, name), name
    for name in ("typ", "src", "dst", "term", "lli", "llt", "pli", "plt", "entry", "lc",
                 "succ", "pair_perm_table"):
        assert np.array_equal(getattr(ru, name), getattr(pu, name)), name
    assert rc.server_perms() == pc.server_perms()
    assert FeatureSpec(pc).F == {5: 159, 7: 277}[S]
    kern = get_kernel(rc, mxu=True)
    mx = MXUExpand(pc, "cpu")
    assert mx.K == kern.K == {5: 1900, 7: 3696}[S]
    assert np.array_equal(mx.layout.slot_family, kern.slot_family)
    assert np.array_equal(mx.layout.slot_coords, kern.slot_coords)
    rt, pt = kern.mxu.tables, mx.tables
    for name in ("W", "theta", "slot_ok", "BIG"):
        assert np.array_equal(np.asarray(getattr(rt, name)), getattr(pt, name)), name
    assert rt.col_off == pt.col_off and rt.feat_off == pt.feat_off
    rf, pf = fprs[S]
    assert rf.P == pf.P == {5: 120, 7: 5040}[S]
    assert rf.factored_msgs == pf.factored_msgs == (S == 7)
    assert np.array_equal(np.asarray(rf.C_planes), pf.C_planes_np)
    if S == 5:
        assert np.array_equal(np.asarray(ru.perm_table), pu.perm_table)
        assert np.array_equal(np.asarray(rf.G_planes), pf.G_planes_np)
        return
    got = carry.factored_tables(rf._Gt_planes, rf._ppfold, "cpu")
    assert len(got["Gt_planes"]) == len(pf.Gt_planes) == 4
    for a, b, c in zip(got["Gt_planes"], pf.Gt_planes, rf._Gt_planes):
        assert torch.equal(a, b) and np.array_equal(np.asarray(c), b.numpy())
    assert torch.equal(got["fold_index"], pf.fold_index)
    tabs = carry.universe_tables(pu, "cpu")
    assert "perm_table" not in tabs  # 680 MB, and the factored form needs none
    assert np.array_equal(tabs["pair_perm_table"].numpy(), ru.pair_perm_table)


def test_factored_bound_raises():
    """The reference's exactness bound of the factored fold (127 M < 2^24)
    holds the port too: a universe past it fails loudly."""
    fpr = Fingerprinter(RaftConfig(n_servers=3, n_vals=1, max_election=1, max_restart=1),
                        device="cpu")
    fpr.uni = types.SimpleNamespace(M=1 << 18)  # 127 M past 2^24
    with pytest.raises(ValueError, match="exactness bound"):
        fpr._build_pair_block_tables()


# -- the factored message hash -----------------------------------------------------


def test_factored_hash_matches_reference_s7(fprs):
    """The port's factored message hash (torch and numpy twins) equals the
    JAX ``_msg_hash_factored`` bit for bit at S=7, on seeded bitmasks whose
    set ids reach past 2^15 (M = 33,768)."""
    rf, pf = fprs[7]
    uni = pf.uni
    packed = np.concatenate([_packed(uni, 3, 11, 0.002), _packed(uni, 2, 12, 0.05)])
    bits = _bits(uni, packed)
    assert bits[:, 1 << 15:].any()  # ids >= 2^15 are set
    want = np.asarray(rf._msg_hash_factored(jnp.asarray(packed)))  # u32 [n, P, chan]
    planes = pf.msg_planes_factored(torch.from_numpy(bits.astype(np.int8)))
    got = _combine_planes_u32(planes).numpy().astype(np.uint32)
    assert np.array_equal(got, want)
    got_np = _combine_planes_u32(torch.from_numpy(pf.msg_planes_factored_np(bits)))
    assert np.array_equal(got_np.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("S", [3, 5])
def test_forced_factored_equals_monolithic(S):
    """Where both forms exist the forced factored message hash equals the
    monolithic one (the port's counterpart of
    tests/test_s7.py::test_factored_hash_bit_identical), on the same seeded
    masks, and equals the reference's forced factored hash."""
    rc, pc = _cfgs(S)
    mono = Fingerprinter(pc, device="cpu", force_factored=False)
    fact = Fingerprinter(pc, device="cpu", force_factored=True)
    assert not mono.factored_msgs and fact.factored_msgs
    packed = _packed(mono.uni, 13, 7, 0.5)
    bits = torch.from_numpy(_bits(mono.uni, packed).astype(np.int8))
    planes = torch.round(bits.double() @ mono.G_planes.double()).long()
    a = _combine_planes_u32(planes.reshape(13, mono.P, 4, 4))
    b = _combine_planes_u32(fact.msg_planes_factored(bits))
    assert torch.equal(a, b)
    ref = RefFingerprinter(rc, force_factored=True)
    want = np.asarray(ref._msg_hash_factored(jnp.asarray(packed)))
    assert np.array_equal(b.numpy().astype(np.uint32), want)


# -- state fingerprints ------------------------------------------------------------


def _ref_state(fr: Frontier, uni) -> RefState:
    msgs = bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words).numpy().view(np.uint32)
    core = {f: jnp.asarray(getattr(fr, f).numpy()) for f in Frontier._fields[:-1]}
    return RefState(msgs=jnp.asarray(msgs), **core)


def _mixed(fr: Frontier, seed: int) -> Frontier:
    """Every field from an independently chosen row: reachable values in new
    combinations (more distinct feature vectors and message sets)."""
    g = np.random.default_rng(seed)
    n = fr.voted_for.shape[0]
    return Frontier(*(x[torch.from_numpy(g.integers(0, n, n))] for x in fr))


@pytest.mark.parametrize("S", [5, 7])
def test_state_fingerprints_match_reference(S, fprs, frontiers):
    """The port's plain twin gives the reference's (fp_view, fp_full) on
    the depth-6 frontier of a short BFS and on mixed rows of it."""
    rf, pf = fprs[S]
    fr = frontiers[S].frontier
    assert fr.msg_ids.dtype == (torch.int32 if S == 7 else torch.int16)
    for case in (fr, _mixed(fr, S)):
        wv, wf, _msum = rf.state_fingerprints(_ref_state(case, pf.uni))
        gv, gf = pf.state_fingerprints_plain(case)
        assert np.array_equal(gv.numpy().view(np.uint64), np.asarray(wv))
        assert np.array_equal(gf.numpy().view(np.uint64), np.asarray(wf))


def _kernel_model(fpr: Fingerprinter, fr: Frontier):
    """The K3 kernel's arithmetic in numpy, from its own tables
    (``kernel_tables_np``): feature planes from the transposed table,
    combined per (perm, channel), plus one effective u32 per set id and
    permutation, then the unsigned minimum."""
    t = fpr.kernel_tables_np()
    P, F = fpr.P, fpr.spec.F
    feats = np.zeros((fr.msg_ids.shape[0], t["f_pad"]), np.float64)
    feats[:, :F] = fpr.spec.features(fr).numpy()
    # exact in float64: |sum| <= 384 * 127 * 128
    planes = np.round(feats @ t["ct"].T.astype(np.float64)).astype(np.int64).reshape(-1, P, 4, 4)
    h = _combine_planes_u32(torch.from_numpy(planes)).numpy().astype(np.uint64)
    uni = fpr.uni
    for i, row in enumerate(fr.msg_ids.numpy()):
        for m in row[row >= 0]:
            if not fpr.factored_msgs:
                h[i] += t["msg_eff"][m]
                continue
            ty = int(np.searchsorted(uni.type_offsets, m, side="right")) - 1
            q, r = divmod(int(m) - uni.type_offsets[ty], uni.type_strides[ty])
            h[i] += t["gt_eff"][t["row_base"][ty] + r][t["pperm"][:, q]]
    h &= np.uint64(0xFFFFFFFF)
    view = ((h[..., 0] << np.uint64(32)) | h[..., 1]).min(-1)
    full = ((h[..., 2] << np.uint64(32)) | h[..., 3]).min(-1)
    return view, full


@pytest.mark.parametrize("S,forced", [(3, None), (3, True), (5, None), (5, True), (7, None)],
                         ids=["s3", "s3-factored", "s5", "s5-factored", "s7"])
def test_kernel_tables(S, forced, fprs, frontiers):
    """K3's tables, through a numpy model of its arithmetic, give the
    plain twin's fingerprints (the kernel is held against the twin on the
    card)."""
    if S == 3:
        chk = TorchChecker(RaftConfig(), device="cpu")
        chk.run(max_depth=6)
        fr = chk.frontier
    else:
        fr = frontiers[S].frontier
    pc = RaftConfig(n_servers=S)
    fpr = (fprs[S][1] if forced is None and S > 3
           else Fingerprinter(pc, device="cpu", force_factored=forced))
    case = _mixed(fr, 3)
    v, f = _kernel_model(fpr, case)
    pv, pf = fpr.state_fingerprints_plain(case)
    assert np.array_equal(v, pv.numpy().view(np.uint64))
    assert np.array_equal(f, pf.numpy().view(np.uint64))


def _k3_factored_model(fpr: Fingerprinter, fr: Frontier, rw: int):
    """K3's factored route in numpy u32 arithmetic, from its own tables: per
    state and half of the channels (``gt_half``: 0-1, then 2-3), each id
    decoded once (type, pair digit q, gt row), the partial-sum rows R[q] of
    the digits present, ``rw`` rows a batch as a warp's shared memory holds
    them, folded by PPERM (sum over the batch of R[q][PPERM[p][q]]), plus
    the feature planes, then the unsigned minimum.  Returns (message sums
    u32 [n, P, chan], fp_view, fp_full)."""
    t = fpr.kernel_tables_np()
    uni, P, F, NP = fpr.uni, fpr.P, fpr.spec.F, fpr.NP
    feats = np.zeros((fr.msg_ids.shape[0], t["f_pad"]), np.float64)
    feats[:, :F] = fpr.spec.features(fr).numpy()
    planes = np.round(feats @ t["ct"].T.astype(np.float64)).astype(np.int64).reshape(-1, P, 4, 4)
    h = _combine_planes_u32(torch.from_numpy(planes)).numpy().astype(np.uint64)
    gt = t["gt_half"].astype(np.uint64)  # [rows, half, NP, 2]
    pperm = t["pperm"].astype(np.int64)
    offs = np.asarray(uni.type_offsets, np.int64)
    strides = np.asarray(uni.type_strides, np.int64)
    msum = np.zeros_like(h)
    for i, row in enumerate(fr.msg_ids.numpy().astype(np.int64)):
        ids = row[row >= 0]
        ty = np.searchsorted(offs, ids, side="right") - 1
        rel = ids - offs[ty]
        q = rel // strides[ty]
        grow = t["row_base"][ty] + rel - q * strides[ty]
        present = np.unique(q)  # the digit mask's bits, ascending
        slot = np.searchsorted(present, q)
        for half in range(2):
            for b0 in range(0, max(present.shape[0], 1), rw):
                nr = min(rw, present.shape[0] - b0)
                R = np.zeros((max(nr, 0), NP, 2), np.uint64)
                sel = (slot >= b0) & (slot < b0 + nr)
                np.add.at(R, slot[sel] - b0, gt[grow[sel], half])
                R &= np.uint64(0xFFFFFFFF)
                for s2 in range(nr):
                    msum[i, :, 2 * half:2 * half + 2] += R[s2][pperm[:, present[b0 + s2]]]
        msum[i] &= np.uint64(0xFFFFFFFF)
    h = (h + msum) & np.uint64(0xFFFFFFFF)
    view = ((h[..., 0] << np.uint64(32)) | h[..., 1]).min(-1)
    full = ((h[..., 2] << np.uint64(32)) | h[..., 3]).min(-1)
    return msum, view, full


@pytest.mark.parametrize("case,rw", [("edges", 28), ("edges-batches", 4), ("frontier", 28)])
def test_k3_factored_route_matches_reference(case, rw, fprs, frontiers):
    """The model of K3's factored route at S=7 (R rows of the digits present,
    folded by PPERM, in batches of ``rw`` rows; then the feature part and
    the minimum) equals the reference's ``_msg_hash_factored`` and its
    fingerprints (``finalize``), on the depth-6 frontier's rows with seeded
    id lists: no ids, one digit carried by every id, every digit present,
    ids >= 2^15 only, full and random lists; and on the frontier itself."""
    rf, pf = fprs[7]
    fr = frontiers[7].frontier
    cap_m = fr.msg_ids.shape[1]
    if case == "frontier":
        rows = fr
    else:
        ids = k3_id_lists(pf.uni, 12, cap_m, 5)
        rows = Frontier(*(x[:12] for x in fr))._replace(
            msg_ids=torch.from_numpy(ids).to(fr.msg_ids.dtype))
        assert (ids >= 1 << 15).any() and (ids < 0).all(1).any()
    msum, view, full = _k3_factored_model(pf, rows, rw)
    ref = _ref_state(rows, pf.uni)
    want = np.asarray(rf._msg_hash_factored(ref.msgs))
    assert np.array_equal(msum.astype(np.uint32), want)
    wv, wf, _m = rf.state_fingerprints(ref)
    assert np.array_equal(view, np.asarray(wv)) and np.array_equal(full, np.asarray(wf))


# -- int32 message ids -------------------------------------------------------------


def test_int32_id_twins_match_reference(fprs):
    """``_ids_insert``, inflate and deflate with int32 ids at M = 33,768:
    the port's twins equal the reference's, ids >= 2^15 included."""
    rf, pf = fprs[7]
    uni, cap_m = pf.uni, 24
    assert id_dtype(RaftConfig(n_servers=7)) == torch.int32
    assert id_dtype(RaftConfig(n_servers=5)) == torch.int16
    # ~13 ids a row, and rows of ~67 (past cap_m: deflate's overflow)
    packed = np.concatenate([_packed(uni, 36, 5, 0.0004), _packed(uni, 4, 6, 0.002)])
    fake = types.SimpleNamespace(kern=types.SimpleNamespace(uni=rf.uni), fpr=rf, cap_m=cap_m,
                                 id_dtype=jnp.int32, uni_words=uni.n_words)
    words = torch.from_numpy(packed.view(np.int32))
    ids, ovf = bfs.msgs_to_ids_plain(words, uni.M, cap_m, torch.int32)
    r_ids, r_ovf = JaxChecker._msgs_to_ids(fake, jnp.asarray(packed))
    assert ids.dtype == torch.int32 and int(ids.max()) >= 1 << 15
    assert np.array_equal(ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(ovf.numpy(), np.asarray(r_ovf)) and bool(ovf.any())
    back = bfs.ids_to_msgs_plain(ids, uni.n_words)
    assert np.array_equal(back.numpy().view(np.uint32),
                          np.asarray(JaxChecker._ids_to_msgs(fake, jnp.asarray(ids.numpy()))))
    g = np.random.default_rng(9)
    added = g.integers(-1, uni.M, (40, 6)).astype(np.int32)
    added[:, 0] = np.where(ids[:, 0].numpy() >= 0, ids[:, 0].numpy(), added[:, 0])  # present
    added[:, 1] = g.integers(1 << 15, uni.M, 40)  # past 2^15
    got, gov = ids_insert(ids, torch.from_numpy(added), uni.M)
    want, wov = JaxChecker._ids_insert(fake, jnp.asarray(ids.numpy()), jnp.asarray(added))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gov.numpy(), np.asarray(wov))


def test_frontier_buffers_take_the_id_width():
    """The fused programs' frontier buffers hold the config's id width:
    int16 at S=3 and S=5 (M = 4,824 and 16,080), int32 at S=7 (33,768)."""
    for S, dt in ((3, torch.int16), (5, torch.int16), (7, torch.int32)):
        fr = mk.empty_frontier(RaftConfig(n_servers=S), 2, 4, "cpu")
        assert fr.msg_ids.dtype == dt == id_dtype(RaftConfig(n_servers=S))


# -- the checker at scale ------------------------------------------------------------


def test_default_chunk_keeps_the_lane_budget():
    """16,384 parents at S=3 (K = 696), 4,096 at S=5, 2,048 at S=7: the
    S=3 lane count per guard launch."""
    assert [default_chunk(K) for K in (696, 1900, 3696, 50)] == [16384, 4096, 2048, 16384]
    chk = TorchChecker(RaftConfig(n_servers=7), device="cpu")
    assert (chk.K, chk.chunk, chk.fpr.factored_msgs) == (3696, 2048, True)


@functools.lru_cache(maxsize=None)
def _ref_run(cfg, depth):
    return JaxChecker(cfg, chunk=64).run(max_depth=depth)


@pytest.mark.parametrize("S,depth,arm", [
    (5, 9, {}), (7, 10, {}), (7, 10, dict(superstep=1)), (7, 10, dict(megakernel=False)),
], ids=["s5", "s7", "s7-fused", "s7-staged"])
def test_slice_parity_with_reference(S, depth, arm):
    """The port's BFS at the small 5- and 7-server spaces equals the
    reference's: level sizes, generated and action counts, on the default
    arm and (S=7) the per-level fused program and the staged chain."""
    rc, pc = _cfgs(S, **SMALL)
    want = _ref_run(rc, depth)
    # chunk 64 as the reference's: several chunks a level, and a staged
    # chain that fingerprints 256 lanes a chunk, not the default chunk's
    got = TorchChecker(pc, device="cpu", chunk=64, **arm).run(max_depth=depth)
    assert got.ok and want.ok
    assert got.level_sizes == want.level_sizes
    if S == 5:
        assert got.level_sizes == (1, 1, 1, 2, 2, 3, 3, 6, 15, 36)  # tests/test_s5.py:95
    assert (got.distinct, got.generated) == (want.distinct, want.generated)
    assert got.action_counts == want.action_counts


def test_cli_servers7_small(capsys):
    """``--servers 7`` through the CLI on the CPU (small constants): the
    reference's counts on the int32-id, factored-hash path, at the default
    chunk of its K."""
    K = MXUExpand(RaftConfig(n_servers=7, **SMALL), "cpu").K
    rc = check_main(["--servers", "7", "--vals", "1", "--max-election", "1",
                     "--max-restart", "0", "--max-depth", "8", "--device", "cpu", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["level_sizes"] == [1, 1, 1, 2, 2, 3, 3, 4, 4]
    assert (summary["distinct"], summary["generated"]) == (21, 90)
    assert f"{K} slots, chunk {default_chunk(K)}" in out


def test_s5_golden_prefix_and_s7_levels(frontiers):
    """The Raft.cfg constants at S=5 to depth 7 on the CPU give the
    reference's golden prefix (674 distinct); S=7's depth-6 prefix is held
    by the ``frontiers`` fixture."""
    res = TorchChecker(RaftConfig(n_servers=5), device="cpu").run(max_depth=7)
    assert res.ok and res.level_sizes == GOLDEN_S5 and res.distinct == 674
    assert frontiers[7].frontier.voted_for.shape[0] == GOLDEN_S7[-1]
