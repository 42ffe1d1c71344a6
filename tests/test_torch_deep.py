"""The port's sharded deep sweep (``ShardedChecker(deep=True)``,
``--mesh-deep``) against the reference on the CPU.

The kernels' twins against the reference's lines: ``pack_fp_deltas``
against its jnp function (and a round trip through ``unpack_fp_deltas``),
``sieve_merge`` against a jnp transcription of ``_deep_sieve_merge_body``
(sharded.py:1322-1339), ``deep_verdict`` (with the finalize's
``group_unique``) against ``_deep_verdict_body`` (:1159-1184), the repack
against ``_deep_repack_body`` (:1283-1320), and ``per_device_forecast``.
End to end: the whole ``CheckResult``, each owner's store, the
``ExchangeMeter`` summary, ``peak_dev_rows``, the reactive grows and every
level's per-owner (gpidx, slots) against the reference's deep
``ShardedChecker`` on its virtual CPU mesh; the counts against
``OracleChecker`` on every arm (the hash sieve, the sorted sieve,
``sieve=False``, ``compress=False``); the byte ledger against the plain
host-store mesh; traces; the growth paths; the fetch's retry; the CLI.
Every output is an integer: equality is exact.  The reference's deep mesh
pays XLA compiles, so only its S2 rows at D = 2 run in the fast tier; the
slow rows name their fast siblings."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.oracle import OracleChecker
from tla_raft_tpu.parallel.exchange import pack_fp_deltas as ref_pack
from tla_raft_tpu_torch import check
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import forecast
from tla_raft_tpu_torch.engine.bfs import TorchChecker, group_unique_plain
from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh
from tla_raft_tpu_torch.parallel import sharded
from tla_raft_tpu_torch.parallel.exchange import pack_fp_deltas, unpack_fp_deltas
from tla_raft_tpu_torch.resilience import faults

SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)
S2 = (2, 1, 1, 1)
S3 = (3, 1, 1, 0)
MEDIAN_BUG_KEY = (3, 1, 2, 0)


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


def _deep(key, D, tmp, **kw):
    kw.setdefault("cap_x", 256)
    return ShardedChecker(_cfg(key, **kw.pop("cfg", {})), _mesh(D), deep=True,
                          host_store_dir=str(tmp), **kw)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _rand(g, n):
    return g.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)


# -- pack_fp_deltas --------------------------------------------------------------------


def _pack_case(case):
    g = np.random.default_rng(len(case))
    cap = 64
    n = {"empty": 0, "one": 1, "odd": 37, "full": cap}.get(case, 50)
    if case == "one_byte":
        v = np.cumsum(g.integers(1, 256, cap)).astype(np.uint64)
    elif case == "eight_byte":
        v = (np.arange(1, cap + 1, dtype=np.uint64) * np.uint64(1 << 57)
             + g.integers(0, 1 << 20, cap).astype(np.uint64))
    elif case == "big_first":
        v = np.uint64(1 << 56) * np.uint64(200) + np.cumsum(g.integers(1, 1 << 20, cap)).astype(
            np.uint64)
    else:
        v = np.unique(_rand(g, cap + 8))[:cap]
    v = np.sort(v)
    v[n:] = SENT64
    return v, n


@pytest.mark.parametrize("case", ["empty", "one", "odd", "full", "one_byte", "eight_byte",
                                  "mixed", "big_first"])
def test_pack_fp_deltas_equals_the_reference(case):
    """Stream, nibbles and total bit-equal to the reference's jnp
    function; the decoder returns the prefix (verify=True)."""
    v, n = _pack_case(case)
    want = ref_pack(jnp.asarray(v), jnp.asarray(n))
    st, nib, total = pack_fp_deltas(_i64(v), n)
    assert np.array_equal(st.numpy(), np.asarray(want[0]))
    assert np.array_equal(nib.numpy(), np.asarray(want[1]))
    assert int(total) == int(want[2])
    assert np.array_equal(unpack_fp_deltas(st.numpy(), nib.numpy(), n, verify=True), v[:n])
    nb = (nib.numpy()[:, None] >> np.array([0, 4])) & 0xF
    if case == "one_byte" and n:
        assert int(total) == n and (nb.reshape(-1)[:n] == 1).all()
    if case == "eight_byte":
        assert (nb.reshape(-1)[:n] == 8).all()
    if case == "big_first":
        assert nb.reshape(-1)[0] == 8


def test_pack_fp_deltas_takes_a_tensor_count_and_refuses_odd_capacity():
    v, n = _pack_case("mixed")
    a = pack_fp_deltas(_i64(v), n)
    b = pack_fp_deltas(_i64(v), torch.tensor(n))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="even"):
        pack_fp_deltas(_i64(v[:63]), 10)


# -- the sorted sieve ------------------------------------------------------------------


def _ref_sieve_merge(sieve, cv):
    """sharded.py:1322-1339 (_deep_sieve_merge_body), transcribed."""
    scap = sieve.shape[0]
    merged = jnp.sort(jnp.concatenate([sieve, cv]))
    first = jnp.concatenate([jnp.ones((1,), bool), merged[1:] != merged[:-1]]) & (
        merged != jnp.uint64(0xFFFFFFFFFFFFFFFF))
    n_u = first.sum()
    comp = jnp.argsort(~first, stable=True)
    pref = jnp.arange(merged.shape[0]) < n_u
    out = jnp.where(pref, merged[comp], jnp.uint64(0xFFFFFFFFFFFFFFFF))[:scap]
    return np.asarray(out), bool(n_u > scap)


@pytest.mark.parametrize("case", ["duplicates", "holes", "overflow"])
def test_sieve_merge_twin_equals_the_reference_lines(case):
    """Rounds folded in one after another: duplicates across rounds, the
    post-drop SENT holes, and an overflow where the largest fall off."""
    g = np.random.default_rng(len(case))
    scap = 64 if case != "overflow" else 40
    sieve_r = np.full(scap, SENT64, np.uint64)
    sieve_p = _i64(sieve_r.copy())
    pool = np.unique(_rand(g, 200))
    for r in range(4):
        cv = np.sort(g.choice(pool[:60] if case != "overflow" else pool, 24, replace=False))
        cv = np.concatenate([cv, np.full(8, SENT64, np.uint64)])
        if case == "holes":
            cv[g.random(cv.shape[0]) < 0.3] = SENT64
        sieve_r, ovf_r = _ref_sieve_merge(jnp.asarray(sieve_r), jnp.asarray(cv))
        sieve_p, ovf_p = sharded.sieve_merge_plain(sieve_p, _i64(cv))
        assert np.array_equal(sieve_p.numpy().view(np.uint64), sieve_r)
        assert bool(ovf_p) == ovf_r
    assert ovf_r == (case == "overflow")


# -- the finalize and the verdict map ------------------------------------------------


def _ref_verdict(rv3, rf3, vb):
    """sharded.py:1129-1184 (_deep_finalize_body's order and
    _deep_verdict_body), transcribed."""
    SENT = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    Rq, D, cap_r = rv3.shape
    q, qf = rv3.reshape(-1), rf3.reshape(-1)
    qp = jnp.arange(q.shape[0], dtype=jnp.int64)
    order = jnp.lexsort((qp, qf, q))
    qsv = q[order]
    first = jnp.concatenate([jnp.ones((1,), bool), qsv[1:] != qsv[:-1]])
    keep = first & (qsv != SENT)
    rank = jnp.cumsum(keep) - 1
    need = q.shape[0] // 8 + 1
    if vb.shape[0] < need:
        vb = jnp.concatenate([vb, jnp.zeros((need - vb.shape[0],), jnp.uint8)])
    rr = jnp.clip(rank, 0, q.shape[0] - 1)
    bit = (vb[rr >> 3] >> (rr & 7).astype(jnp.uint8)) & 1
    win = (keep & (bit == 1))[jnp.argsort(order)]
    uq = jnp.where(jnp.arange(q.shape[0]) < keep.sum(), qsv[jnp.argsort(~keep, stable=True)],
                   SENT)
    return np.asarray(win).reshape(Rq, D, cap_r), np.asarray(uq)[:int(keep.sum())]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deep_verdict_twin_equals_the_reference_lines(seed):
    """Receive tiles [Rq, D, cap_r] with a live prefix a row, repeated
    views with ties in fp_full, and SENT padding: the port's finalize
    (``group_unique`` over the live lanes, payload = receive index) keeps
    the reference's unique stream, and ``deep_verdict`` maps random is-new
    bits to the reference's win flags."""
    g = np.random.default_rng(seed)
    Rq, D, cap_r = 4, 3, 16
    views = _rand(g, 20)
    rv3 = np.full((Rq, D, cap_r), SENT64, np.uint64)
    rf3 = np.full((Rq, D, cap_r), SENT64, np.uint64)
    for r in range(Rq - 1):  # the last round is padding
        for s in range(D):
            c = int(g.integers(0, cap_r + 1))
            rv3[r, s, :c] = g.choice(views, c)
            rf3[r, s, :c] = rv3[r, s, :c] ^ g.integers(0, 3, c).astype(np.uint64)
    live = rv3 != SENT64
    rv, rf = rv3[live], rf3[live]
    n_u, uq, _uf, ugp = group_unique_plain(_i64(rv), _i64(rf), torch.arange(len(rv)))
    vb = g.integers(0, 256, (int(n_u) + 7) // 8, dtype=np.uint8)
    want, want_uq = _ref_verdict(jnp.asarray(rv3), jnp.asarray(rf3), jnp.asarray(vb))
    assert np.array_equal(uq.numpy()[:int(n_u)].view(np.uint64), want_uq)
    win = sharded.deep_verdict_plain(torch.from_numpy(vb), ugp, int(n_u), len(rv))
    got = np.zeros(rv3.shape, bool)
    got[live] = win.numpy()
    assert np.array_equal(got, want)


# -- the repack -----------------------------------------------------------------------


def _ref_repack(n_out, seg, ch_stack, gp_stack, sl_stack):
    """sharded.py:1283-1320 (_deep_repack_body) on one device, transcribed
    (one child field stands for the state's)."""
    Rq, cap_c = gp_stack.shape
    gp, sl = gp_stack.reshape(-1), sl_stack.reshape(-1)
    validl = gp >= 0
    comp = jnp.argsort(~validl, stable=True)
    ntot = n_out * seg
    src = comp[jnp.clip(jnp.arange(ntot), 0, comp.shape[0] - 1)]
    lane = (jnp.arange(ntot) < validl.sum()) & (jnp.arange(ntot) < comp.shape[0])
    flat = ch_stack.reshape(Rq * cap_c, *ch_stack.shape[2:])
    out = jnp.where(lane.reshape((-1,) + (1,) * (flat.ndim - 1)), flat[src],
                    jnp.zeros_like(flat[src]))
    return (np.asarray(out), np.asarray(jnp.where(lane, gp[src], -1)),
            np.asarray(jnp.where(lane, sl[src], -1)), int(validl.sum()))


def test_deep_repack_twin_equals_the_reference_lines():
    """Five rounds of live child blocks (each a prefix of its cap_c block,
    as phase 2 compacts them) into n_out > 1 segments: the port's repack
    of the live blocks, taken as row ranges of two sources as the deep
    sweep gives them, is the reference's prefix, field by field."""
    g = np.random.default_rng(5)
    Rq, cap_c, seg = 5, 12, 4
    counts = [7, 0, 12, 3, 9]
    ch = g.integers(0, 256, (Rq, cap_c, 3, 2), dtype=np.uint8)
    gp = np.full((Rq, cap_c), -1, np.int64)
    sl = np.full((Rq, cap_c), -1, np.int64)
    for r, c in enumerate(counts):
        gp[r, :c] = g.integers(0, 1000, c)
        sl[r, :c] = g.integers(0, 30, c)
    n_out = -(-sum(counts) // seg)
    assert n_out > 1
    w_ch, w_gp, w_sl, n = _ref_repack(n_out, seg, jnp.asarray(ch), jnp.asarray(gp),
                                      jnp.asarray(sl))
    # rounds 0, 2, 4 from source 0 and rounds 1, 3 from source 1, each a
    # range of its source's rows
    sources, segs = [[], []], []
    for r, c in enumerate(counts):
        src = sources[r % 2]
        segs.append((r % 2, sum(len(b[1]) for b in src), c))
        src.append((ch[r, :c], gp[r, :c], sl[r, :c]))
    sources = [tuple(torch.from_numpy(np.concatenate([b[f] for b in src])) for f in range(3))
               for src in sources]
    o_ch, o_gp, o_sl = sharded.repack_plain(sources, segs)
    assert n == sum(counts) == o_gp.shape[0]
    assert np.array_equal(o_ch.numpy(), w_ch[:n]) and (w_ch[n:] == 0).all()
    assert np.array_equal(o_gp.numpy(), w_gp[:n]) and (w_gp[n:] == -1).all()
    assert np.array_equal(o_sl.numpy(), w_sl[:n])


@pytest.mark.parametrize("sizes", [[1, 1, 3, 9, 22, 57, 136, 345, 931],
                                   [1, 1, 3, 9, 20, 41, 70, 90, 95, 80],
                                   [1, 1, 2, 3]])
@pytest.mark.parametrize("target", [None, 12, 30])
def test_per_device_forecast_equals_the_reference(sizes, target):
    from tla_raft_tpu.engine.forecast import per_device_forecast as ref_fc

    for D in (1, 3, 8):
        assert forecast.per_device_forecast(sizes, sum(sizes), target, D) == ref_fc(
            sizes, sum(sizes), target, D)


# -- against the reference's deep mesh ---------------------------------------------------


def _ref_deep_run(key, D, tmp, depth=None, cfg=None, **kw):
    """The reference's deep ShardedChecker on its virtual CPU mesh, each
    level's per-owner live (gpidx, slots) kept."""
    from tla_raft_tpu.parallel import ShardedChecker as RefSharded
    from tla_raft_tpu.parallel import make_mesh as ref_make_mesh

    ref = RefSharded(_ref_cfg(key, **(cfg or {})), ref_make_mesh(D), deep=True,
                     host_store_dir=str(tmp), **kw)
    recs = []
    level = ref._deep_level

    def keep(*a, **k):
        out = level(*a, **k)
        if "gpidx" in out and out["n_new"]:
            ntot = len(out["segments"]) * ref.seg_rows
            nf = np.asarray(out["n_f"]).reshape(D)
            gp = np.asarray(out["gpidx"]).reshape(D, ntot)
            sl = np.asarray(out["slots"]).reshape(D, ntot)
            recs.append([(gp[o, :nf[o]].tolist(), sl[o, :nf[o]].tolist()) for o in range(D)])
        return out

    ref._deep_level = keep
    res = ref.run(max_depth=depth)
    return ref, res, recs


def _port_deep_run(chk, depth=None):
    recs = []
    level = chk._deep_level

    def keep(*a, **k):
        out = level(*a, **k)
        if "trace" in out and out["n_new"]:
            gps, sls = out["trace"]
            recs.append([(g.tolist(), s.tolist()) for g, s in zip(gps, sls)])
        return out

    chk._deep_level = keep
    return chk.run(max_depth=depth), recs


def _all_fps(key, **kw):
    chk = TorchChecker(_cfg(key, **kw), device="cpu", chunk=256)
    chk.run()
    s = chk.hstore.slab.numpy().view(np.uint64)
    return s[s != SENT64]


def _stores_equal(ref_stores, port_stores, fps):
    for r, p in zip(ref_stores, port_stores):
        assert len(r) == len(p)
        assert np.array_equal(r.contains(fps), p.contains(fps))


@pytest.mark.parametrize("arm", ["hash", pytest.param("sorted", marks=pytest.mark.slow)])
def test_deep_equals_the_reference_sharded_checker(arm, tmp_path):
    """S2 at D = 2, seg_rows 2, cap_x 256 (the reference's
    test_deep_multisegment_and_oracle_parity): the CheckResult, each
    owner's store, the ExchangeMeter summary whole, peak_dev_rows, the
    reactive grows and every level's per-owner (gpidx, slots).  The
    sorted sieve's row is slow (a second set of reference compiles); its
    fast sibling is the hash row."""
    kw = dict(cap_x=256, seg_rows=2, use_hashstore=arm == "hash")
    ref, want, ref_recs = _ref_deep_run(S2, 2, tmp_path / "ref", **kw)
    chk = _deep(S2, 2, tmp_path / "port", **kw)
    got, recs = _port_deep_run(chk)
    assert tuple(got) == tuple(want)
    assert chk.meter.summary() == ref.meter.summary()
    assert (chk.peak_dev_rows, chk.reactive_grows, chk.cap_x, chk.scap) == (
        ref.peak_dev_rows, ref.reactive_grows, ref.cap_x, ref.scap)
    assert recs == ref_recs
    _stores_equal(ref.host_stores, chk.host_stores, _all_fps(S2))
    keys = ("levels", "per_owner_rows", "peak_row_skew", "worst_owner")
    assert {k: chk.skew.summary()[k] for k in keys} == {k: ref.skew.summary()[k] for k in keys}
    assert any(lv["rounds"] > 1 for lv in chk.level_log)


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["hash", "sorted", "nosieve", "nocompress"])
def test_deep_equals_the_reference_at_eight_shards(arm, tmp_path):
    """Slow sibling of test_deep_equals_the_reference_sharded_checker: (3,1,1,0)
    to its fixpoint on 8 shards at seg_rows 16, every arm: the same
    record set."""
    kw = dict(cap_x=256, seg_rows=16, use_hashstore=arm != "sorted", sieve=arm != "nosieve",
              compress=arm != "nocompress")
    ref, want, ref_recs = _ref_deep_run(S3, 8, tmp_path / "ref", **kw)
    chk = _deep(S3, 8, tmp_path / "port", **kw)
    got, recs = _port_deep_run(chk)
    assert tuple(got) == tuple(want)
    assert chk.meter.summary() == ref.meter.summary()
    assert (chk.peak_dev_rows, chk.reactive_grows) == (ref.peak_dev_rows, ref.reactive_grows)
    assert recs == ref_recs
    _stores_equal(ref.host_stores, chk.host_stores, _all_fps(S3))


ARMS = {"hash": {}, "sorted": dict(use_hashstore=False), "nosieve": dict(sieve=False),
        "nocompress": dict(compress=False)}


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("key,D,seg", [(S2, 2, 2), (S2, 3, 8), (S3, 3, 16), (S3, 2, 8),
                                       pytest.param(S3, 8, 16, marks=pytest.mark.slow),
                                       pytest.param(S2, 8, 2, marks=pytest.mark.slow)])
def test_deep_equals_the_oracle(key, D, seg, arm, tmp_path):
    """The reference's test_deep_multisegment_and_oracle_parity on every
    arm: counts, depth, level sizes and action counts; the stores jointly
    hold the reachable set, each only what it owns."""
    chk = _deep(key, D, tmp_path, seg_rows=seg, **ARMS[arm])
    got = chk.run()
    assert _counts(got) == _counts(_oracle(key))
    fps = _all_fps(key)
    for o, st in enumerate(chk.host_stores):
        mine = fps % np.uint64(D) == np.uint64(o)
        assert np.array_equal(st.contains(fps), mine) and len(st) == int(mine.sum())
    s = chk.meter.summary()
    assert (s["sieved"] > 0) == (arm != "nosieve")
    if arm == "nocompress":
        assert all(lv["packed"] is False for lv in s["per_level"])


def test_deep_and_the_plain_host_store_mesh(tmp_path):
    """The reference's test_deep_matches_uncompressed_exchange: the same
    counts as the plain host-store mesh; on packed levels the raw ledger
    is the plain path's exchanged bytes; the fallback fires at tiny levels
    and its reduction never reads below 1."""
    plain = ShardedChecker(_cfg(S2), _mesh(4), cap_x=256, host_store_dir=str(tmp_path / "p"))
    want = plain.run()
    deep = _deep(S2, 4, tmp_path / "d", seg_rows=8)
    got = deep.run()
    assert _counts(got) == _counts(want)
    by_level = {lv["level"]: lv for lv in plain.meter.summary()["per_level"]}
    ds = deep.meter.summary()
    fallback = False
    for lv in ds["per_level"]:
        if lv["packed"]:
            assert lv["raw_bytes"] == by_level[lv["level"]]["exchanged_bytes"], lv
        else:
            fallback = True
            assert lv["reduction"] >= 1, lv
    assert fallback and ds["exchanged_bytes"] < ds["raw_bytes"]


# -- traces ------------------------------------------------------------------------------


TRACES = {
    "median_bug": (MEDIAN_BUG_KEY, dict(mutations=("median-bug",))),
    "violation": ((3, 1, 1, 0), dict(invariants=("~RaftCanCommt",))),
    "split_brain": ((3, 1, 2, 0), dict(mutations=("double-vote",))),
}


def _trace_sha(trace) -> str:
    return hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()


@pytest.mark.parametrize("case", ["violation", "split_brain"])
def test_deep_traces_are_genuine(case, tmp_path):
    """Fast sibling of test_deep_traces_equal_the_reference: the verdict,
    depth and level sizes of the oracle, and a trace of real transitions
    from Init on 3 shards at seg_rows 8."""
    from tla_raft_tpu.oracle.explicit import SplitBrainAbort, successors

    key, kw = TRACES[case]
    want = _oracle(key, **kw)
    got = _deep(key, 3, tmp_path, seg_rows=8, cfg=kw).run()
    assert not got.ok and got.depth == want.depth and got.level_sizes == want.level_sizes
    kind, trace = got.violation
    ref_cfg = _ref_cfg(key, **kw)
    for (_a, a), (act, b) in zip(trace, trace[1:]):
        assert any(ch == b for _n, _s, _d, ch in successors(ref_cfg, a)), act
    if case == "split_brain":
        assert "split brain" in kind
        with pytest.raises(SplitBrainAbort):
            successors(ref_cfg, trace[-1][1])
    else:
        assert "RaftCanCommt" in kind


@pytest.mark.slow
@pytest.mark.parametrize("case", list(TRACES))
def test_deep_traces_equal_the_reference(case, tmp_path):
    """Slow sibling of test_deep_traces_are_genuine: the whole CheckResult
    against the reference's deep mesh at D = 3 and seg_rows 8."""
    key, kw = TRACES[case]
    _ref, want, _recs = _ref_deep_run(key, 3, tmp_path / "ref", cfg=kw, cap_x=256, seg_rows=8)
    got = _deep(key, 3, tmp_path / "port", seg_rows=8, cfg=kw).run()
    assert tuple(got) == tuple(want)


@pytest.mark.slow
def test_deep_median_bug_trace_is_the_pinned_one(tmp_path):
    """The port's deep mesh on 8 shards at seg_rows 16 gives the trace
    chip_smoke.py pins (computed once from the reference's deep mesh)."""
    import chip_smoke

    pin = chip_smoke.MESH_DEEP_MEDIAN_BUG
    key, kw = TRACES["median_bug"]
    got = _deep(key, 8, tmp_path, cap_x=512, seg_rows=pin["seg_rows"], cfg=kw).run()
    kind, trace = got.violation
    assert "Inv" in kind
    assert [a for a, _ in trace] == pin["actions"]
    assert _trace_sha(trace) == pin["trace_sha256"]


# -- growth ------------------------------------------------------------------------------


def test_cap_x_overflow_redoes_phase_one(tmp_path):
    """cap_x = 4: phase 1 overflows and is redone (nothing written yet);
    the counts stay the oracle's and the stores hold distinct."""
    chk = _deep(S3, 2, tmp_path, cap_x=4, seg_rows=8)
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(S3))
    assert chk.reactive_grows > 0 and chk.cap_x > 4
    assert sum(len(s) for s in chk.host_stores) == got.distinct


class _NarrowPhase2(ShardedChecker):
    """cap_w without its 256-row floor and a quarter-size cap_c, so a small
    config overflows both in phase 2."""

    @property
    def cap_w(self):
        return max(1, self.cap_x // 256) * self._cap_w_boost

    @property
    def cap_c_deep(self):
        return max(1, self.cap_x // 64) * self._cap_c_boost


def test_phase_two_overflow_redoes_phase_two_alone(tmp_path):
    """A forced cap_w and cap_c overflow redoes phase 2 alone: the stores
    already hold the level (each inserted once: their sizes equal
    distinct), and the counts stay the oracle's."""
    chk = _NarrowPhase2(_cfg(S3), _mesh(3), cap_x=256, deep=True, seg_rows=16,
                        host_store_dir=str(tmp_path))
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(S3))
    assert chk._cap_w_boost > 1 and chk._cap_c_boost > 1 and chk.reactive_grows >= 2
    assert sum(len(s) for s in chk.host_stores) == got.distinct


@pytest.mark.parametrize("arm", ["hash", "sorted"])
def test_tiny_sieve_grows_by_four(arm, tmp_path):
    """scap = 4 overflows at once and grows x4 (rehashed, or padded); the
    counts stay the oracle's and the sieve keeps firing."""
    chk = _deep(S3, 2, tmp_path, seg_rows=8, scap=4, use_hashstore=arm == "hash")
    got = chk.run(presize=False)
    assert _counts(got) == _counts(_oracle(S3))
    assert chk.scap > 4 and bin(chk.scap).count("1") == 1 and (chk.scap.bit_length() - 3) % 2 == 0
    assert chk.meter.summary()["sieved"] > 0


def test_sieve_grow_failure_keeps_the_capacity(tmp_path):
    """A failed grow (hashstore.grow:fail@1) keeps the sieve as it is: it
    is a cache; the counts do not move."""
    faults.install("hashstore.grow:fail@1")
    try:
        chk = _deep(S3, 2, tmp_path, seg_rows=8, scap=4)
        got = chk.run(presize=False)
    finally:
        faults.install("")
    assert _counts(got) == _counts(_oracle(S3))


def test_presize_from_the_per_device_forecast(tmp_path):
    """The Raft.cfg constants on 8 shards to depth 10 from cap_x 64: the
    forecast (``per_device_forecast``) grows cap_x at a level boundary, so
    no level grows reactively; golden."""
    chk = ShardedChecker(RaftConfig(), _mesh(8), cap_x=64, deep=True, seg_rows=128,
                         host_store_dir=str(tmp_path))
    res = chk.run(max_depth=10)
    assert list(res.level_sizes) == [1, 1, 3, 9, 22, 57, 136, 345, 931, 2468, 5881]
    assert chk.cap_x > 64 and chk.reactive_grows == 0
    assert chk.peak_dev_rows < max(res.level_sizes)  # 1/D of the largest level, in segments


# -- the fetch, the CLI --------------------------------------------------------------------


def test_exchange_fetch_failure_retries(tmp_path):
    """exchange.fetch:fail@1: the fetch is retried with backoff and the
    counts do not move."""
    faults.install("exchange.fetch:fail@1")
    try:
        chk = _deep(S2, 2, tmp_path, seg_rows=2)
        got = chk.run()
        fired = faults.plan().fired
    finally:
        faults.install("")
    assert _counts(got) == _counts(_oracle(S2))
    assert any("exchange.fetch" in f for f in fired)


SMALL = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1"]


def _exchange_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(("Exchange:", "  level "))]


def test_cli_mesh_deep_line(tmp_path, capsys):
    """The verify recipe's line on a Raft.cfg: 1,505 distinct and 3,044
    generated at depth 8 on 8 CPU shards, with the Exchange lines."""
    from test_cfgparse import REFERENCE_CFG

    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(REFERENCE_CFG)
    args = ["--config", str(cfg), "--device", "cpu", "--mesh", "8", "--mesh-deep",
            "--fpstore-dir", str(tmp_path / "fps"), "--seg-rows", "128", "--cap-x", "512",
            "--max-depth", "8", "--json", "--log", "-"]
    assert check.main(args) == 0
    out = capsys.readouterr().out
    got = json.loads(out.strip().splitlines()[-1])
    assert (got["distinct"], got["generated"], got["depth"]) == (1505, 3044, 8)
    assert got["seg_rows"] == 128 and got["peak_dev_rows"] >= 128
    assert got["exchange_ledger"]["levels"] == 8
    lines = _exchange_lines(out)
    assert lines[0].startswith("Exchange: ") and len(lines) == 9


@pytest.mark.slow
def test_cli_mesh_deep_lines_equal_the_reference_cli(tmp_path, capsys):
    """Slow sibling of test_cli_mesh_deep_line: the Exchange lines letter
    for letter and the --json counts of the reference's CLI."""
    from test_cfgparse import REFERENCE_CFG
    from tla_raft_tpu.check import main as ref_main

    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(REFERENCE_CFG)
    args = ["--config", str(cfg), "--mesh", "8", "--mesh-deep", "--seg-rows", "128",
            "--cap-x", "512", "--max-depth", "8", "--json"]
    assert ref_main(args + ["--fpstore-dir", str(tmp_path / "r"), "--log", "-"]) == 0
    want = capsys.readouterr().out
    assert check.main(args + ["--fpstore-dir", str(tmp_path / "p"), "--device", "cpu",
                              "--log", "-"]) == 0
    got = capsys.readouterr().out
    assert _exchange_lines(got) == _exchange_lines(want)
    keys = ("ok", "distinct", "generated", "depth", "level_sizes", "violation")
    gj, wj = json.loads(got.strip().splitlines()[-1]), json.loads(want.strip().splitlines()[-1])
    assert {k: gj[k] for k in keys} == {k: wj[k] for k in keys}


def test_cli_mesh_deep_small(tmp_path, capsys):
    """--mesh 2 --mesh-deep on S2 with --no-sieve and --no-compress: the
    oracle's counts."""
    want = _oracle(S2)
    for extra in ([], ["--no-sieve"], ["--no-compress"], ["--no-hashstore"]):
        args = SMALL + ["--device", "cpu", "--mesh", "2", "--mesh-deep", "--fpstore-dir",
                        str(tmp_path / "fps"), "--seg-rows", "4", "--json", "--log", "-"] + extra
        assert check.main(args) == 0
        out = capsys.readouterr().out
        got = json.loads(out.strip().splitlines()[-1])
        assert (got["distinct"], got["generated"], got["depth"]) == (
            want.distinct, want.generated, want.depth)
        assert (got["exchange_ledger"]["sieved"] > 0) == (extra != ["--no-sieve"])
        assert got["compress"] == (extra != ["--no-compress"])
        assert got["sieve"] == (extra != ["--no-sieve"])
