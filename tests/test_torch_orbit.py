"""Orbit pruning (B17, ``TLA_RAFT_ORBIT=1``) in the port against the
reference, on the CPU.

The port's plain twins of the canonical-relabel fingerprint (per-pair
message hash, WL colours, Lehmer rank, the hash at the canonical
permutation) and of the chunk path (the tied rows' exact fold on a
``cap_nd`` budget, its overflow flag) are held bit for bit against the
reference's ``_orbit_pairh`` / ``_orbit_colors`` / ``_orbit_rank`` /
``state_fingerprints_orbit`` and ``JaxChecker._orbit_chunk_fps`` on
seeded random states (the reference test's recipe, tests/test_orbit.py)
and on symmetric ones, at 3, 5 and 7 servers.  The ``orbit`` kernel's
own route (K3's plane rows and message tables at the rank) is held
against the twin through a numpy model; the kernel itself is held
against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
Whole runs under orbit equal the reference's ``JaxChecker`` under
``TLA_RAFT_ORBIT=1`` (counts, level sizes, action counts, the visited
slab's fingerprint set) and the port's own runs on its other routes.
Every output is an integer: equality is exact.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.models.raft import RaftState as RefState
from tla_raft_tpu.ops.fingerprint import Fingerprinter as RefFingerprinter
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker, msgs_to_ids_plain
from tla_raft_tpu_torch.models.raft import Frontier, _CORE_FIELDS, id_dtype
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.u64 import SENT

from test_orbit import _permute_state, _random_states

SMALL = dict(n_vals=1, max_election=1, max_restart=0)
# rows of the random batches per server count (the S=7 reference hashes a
# 33,768-column bitmask per row)
ROWS = {3: 96, 5: 32, 7: 12}


def _symmetric(st, bits, n_sym: int, seed: int):
    """The first ``n_sym`` rows made server-symmetric (every server's data
    equal, votedFor None, no messages): every colour ties."""
    g = np.random.default_rng(seed)
    a = {f: np.array(getattr(st, f)) for f in RefState._fields}
    for k in range(n_sym):
        for f in ("current_term", "role", "log_len", "commit_index"):
            a[f][k] = a[f][k, 0]
        for f in ("log_term", "log_val"):
            a[f][k] = a[f][k, 0]
        for f in ("match_index", "next_index", "pending"):
            a[f][k] = g.integers(a[f][k].min(), a[f][k].max() + 1)
        a["voted_for"][k] = 0
    a["msgs"][:n_sym] = 0
    bits = bits.copy()
    bits[:n_sym] = 0
    return RefState(**{f: jnp.asarray(v) for f, v in a.items()}), bits


def _states(S: int, seed: int, n_sym: int = 4):
    """(reference RaftState, the port's Frontier of the same states, bits)."""
    rc = RefConfig(n_servers=S)
    st, bits = _random_states(rc, ROWS[S], seed=seed)
    st, bits = _symmetric(st, bits, n_sym, seed)
    return st, _frontier(RaftConfig(n_servers=S), st, bits), bits


def _frontier(pc, st, bits) -> Frontier:
    msgs = torch.from_numpy(np.asarray(st.msgs).view(np.int32).copy())
    ids, ovf = msgs_to_ids_plain(msgs, bits.shape[1], max(1, int(bits.sum(1).max())),
                                 id_dtype(pc))
    assert not bool(ovf.any())
    return Frontier(msg_ids=ids, **{f: torch.from_numpy(np.array(getattr(st, f)))
                                    for f in _CORE_FIELDS})


@pytest.fixture(scope="module")
def fprs():
    """(reference, port) Fingerprinters at S = 3, 5, 7, built once."""
    return {S: (RefFingerprinter(RefConfig(n_servers=S)),
                Fingerprinter(RaftConfig(n_servers=S), device="cpu")) for S in (3, 5, 7)}


def _u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64).view(np.int64)


@pytest.mark.parametrize("S", [3, 4])
def test_rank_is_the_index_in_server_perms(S):
    """Colours c[s] = p[s] - 1 sort to the permutation p itself: its rank
    is its index in ``server_perms()`` (tests/test_orbit.py:103)."""
    fpr = Fingerprinter(RaftConfig(n_servers=S, **SMALL), device="cpu")
    perms = RaftConfig(n_servers=S, **SMALL).server_perms()
    rank, disc = fpr.orbit_rank(torch.tensor(perms, dtype=torch.int64) - 1)
    assert bool(disc.all()) and rank.tolist() == list(range(len(perms)))


@pytest.mark.parametrize("S", [3, 5, 7])
def test_orbit_twins_equal_reference(fprs, S):
    """pairh, the colours, rank, ``discrete`` and both fingerprints of every
    row (random rows are discrete, the symmetric rows tied) equal the
    reference's."""
    rf, pf = fprs[S]
    st, fr, _bits = _states(S, seed=S)
    ph_r = np.asarray(rf._orbit_pairh(rf.unpack_bits(st.msgs))).astype(np.int64)
    ph = pf.orbit_pairh(fr.msg_ids)
    assert np.array_equal(ph.numpy(), ph_r)
    col_r = np.asarray(rf._orbit_colors(st, jnp.asarray(ph_r.astype(np.uint32))))
    col = pf.orbit_colors(fr, ph)
    assert np.array_equal(col.numpy(), col_r.astype(np.int64))
    rank_r, disc_r = rf._orbit_rank(jnp.asarray(col_r))
    fv_r, ff_r, d_r = rf.state_fingerprints_orbit(st)
    fv, ff, disc, rank = pf.state_fingerprints_orbit(fr)
    assert np.array_equal(rank.numpy(), np.asarray(rank_r))
    assert np.array_equal(disc.numpy(), np.asarray(disc_r)) and np.array_equal(
        disc.numpy(), np.asarray(d_r))
    assert 0 < int(disc.sum()) < len(disc)  # both kinds of row
    assert np.array_equal(fv.numpy(), _u64(fv_r)) and np.array_equal(ff.numpy(), _u64(ff_r))


def _kernel_route_np(fpr, fr, rank):
    """A numpy model of the ``orbit`` kernel's hash (csrc/orbit.cu (d)):
    the features against K3's 16 plane rows at ``rank`` of the transposed
    table, the message part from K3's effective coefficients at ``rank``."""
    tab = fpr.kernel_tables_np()
    ct = tab["ct"].astype(np.int64)
    feats = fpr.spec.features(fr).numpy().astype(np.int64)
    n = feats.shape[0]
    planes = np.stack([ct[r * 16:(r + 1) * 16, :feats.shape[1]] @ feats[i]
                       for i, r in enumerate(rank)])
    h = _combine_np(planes.reshape(n, 4, 4))
    uni = fpr.uni
    ids = fr.msg_ids.numpy().astype(np.int64)
    base = [sum(uni.type_strides[:t]) for t in range(4)]
    for i, r in enumerate(rank):
        for m in ids[i][ids[i] >= 0]:
            if fpr.factored_msgs:
                t = int(np.searchsorted(uni.type_offsets, m, side="right")) - 1
                q, rest = divmod(int(m) - uni.type_offsets[t], uni.type_strides[t])
                h[i] += tab["gt_eff"][base[t] + rest, tab["pperm"][r, q]].astype(np.int64)
            else:
                h[i] += tab["msg_eff"][m, r].astype(np.int64)
    h &= 0xFFFFFFFF
    return (h[:, 0] << 32) | h[:, 1], (h[:, 2] << 32) | h[:, 3]


def _combine_np(p):
    return (p[..., 0] + (p[..., 1] << 8) + (p[..., 2] << 16) + (p[..., 3] << 24)) & 0xFFFFFFFF


@pytest.mark.parametrize("S", [3, 5, 7])
def test_kernel_route_equals_twin(fprs, S):
    """The kernel's route to the hash (K3's tables at the rank: the
    reference's canonical-column identity, tests/test_orbit.py:117) gives
    the twin's bits on every row, monolithic at S = 3, 5 and factored at 7."""
    _rf, pf = fprs[S]
    _st, fr, _bits = _states(S, seed=10 + S)
    fv, ff, _disc, rank = pf.state_fingerprints_orbit_plain(fr)
    kv, kf = _kernel_route_np(pf, fr, rank.numpy())
    assert np.array_equal(kv.astype(np.uint64).view(np.int64), fv.numpy())
    assert np.array_equal(kf.astype(np.uint64).view(np.int64), ff.numpy())


def test_invariant_under_every_relabelling(fprs):
    """Every server relabelling of a state gives the same (fp_view,
    fp_full, discrete) on discrete rows (tests/test_orbit.py:143)."""
    rc, pc = RefConfig(n_servers=3), RaftConfig(n_servers=3)
    _rf, pf = fprs[3]
    st, bits = _random_states(rc, 64, seed=7)
    v0, f0, d0, _ = pf.state_fingerprints_orbit(_frontier(pc, st, bits))
    assert bool(d0.any())
    for p in itertools.permutations(range(1, 4)):
        stp, bits_p = _permute_state(rc, st, bits, p)
        v, f, d, _ = pf.state_fingerprints_orbit(_frontier(pc, stp, bits_p))
        assert torch.equal(d, d0)
        assert torch.equal(v[d0], v0[d0]) and torch.equal(f[d0], f0[d0])


def test_orbit_tables_carried_from_reference(fprs):
    """``carry.orbit_tables`` turns the reference's ``_orbit_tables`` into
    the port's, equal to ``Fingerprinter.orbit_tables`` at S = 3, 5, 7."""
    for S, (rf, pf) in fprs.items():
        tb = rf._orbit_tables
        got = carry.orbit_tables(*(np.asarray(tb[k]) for k in ("psi", "ppinv", "qidx")),
                                 [np.asarray(w) for w in tb["W"]], np.asarray(tb["fact"]), "cpu")
        mine = pf.orbit_tables
        for k in ("psi", "ppinv", "qidx", "fact"):
            assert torch.equal(got[k], mine[k]), (S, k)
        assert all(torch.equal(a, b) for a, b in zip(got["W"], mine["W"]))
        assert np.array_equal(mine["C0"].numpy(), np.asarray(tb["C0"]))
        assert np.array_equal(mine["G0"].numpy(), np.asarray(tb["G0"]))


@pytest.mark.parametrize("n_tied,want_ovf", [(40, False), (300, True)],
                         ids=["fits", "overflows"])
def test_orbit_chunk_fps_equals_reference(fprs, monkeypatch, n_tied, want_ovf):
    """The chunk path against ``JaxChecker._orbit_chunk_fps`` at cap_x =
    1,024 (cap_nd 256): every row's fingerprints and the overflow flag,
    with the tied live rows within the budget and past it."""
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
    rc, pc = RefConfig(3, 1, 1, 0), RaftConfig(3, 1, 1, 0)
    ref = JaxChecker(rc, chunk=64)
    ref.cap_x = 1024
    st, bits = _random_states(rc, 1024, seed=5)
    st, bits = _symmetric(st, bits, n_tied, seed=5)
    lane = np.arange(1024) < 1000
    fv_r, ff_r, ovf_r = ref._orbit_chunk_fps(st, jnp.asarray(lane))
    pf = Fingerprinter(pc, device="cpu")
    fv, ff, ovf = pf.orbit_chunk_fps_plain(_frontier(pc, st, bits), torch.from_numpy(lane),
                                           max(256, 1024 // 4))
    assert bool(ovf) == bool(ovf_r) == want_ovf
    assert np.array_equal(fv.numpy(), _u64(fv_r)) and np.array_equal(ff.numpy(), _u64(ff_r))
    # the counted form the engine calls: live rows only, SENT past them
    cv, cf, word = pf.orbit_chunk_fps(_frontier(pc, st, bits), 256, torch.tensor(1000))
    assert int(word) == int(want_ovf)
    assert torch.equal(cv[:1000], fv[:1000]) and bool((cv[1000:] == SENT).all())
    assert torch.equal(cf[:1000], ff[:1000]) and bool((cf[1000:] == SENT).all())


def _slab_set(slab) -> np.ndarray:
    a = np.asarray(slab).astype(np.uint64)
    return np.sort(a[a != np.uint64(SENT % (1 << 64))])


@pytest.mark.parametrize("args", [(2, 1, 1, 1), (3, 1, 1, 0)], ids=["s2", "s3"])
def test_run_equals_reference_under_orbit(monkeypatch, args):
    """To the fixpoint: the port's orbit run (staged chain) equals the
    reference's ``JaxChecker`` under ``TLA_RAFT_ORBIT=1`` — result, level
    sizes, action counts, and the visited slab's fingerprint set (orbit
    values, the root's fold included) — and the port's default-definition
    run's counts."""
    monkeypatch.setenv("TLA_RAFT_ORBIT", "1")
    ref = JaxChecker(RefConfig(*args), chunk=64)
    want = ref.run()
    chk = TorchChecker(RaftConfig(*args), device="cpu", chunk=64)  # the env var turns orbit on
    got = chk.run()
    assert chk.orbit and not chk.megakernel and chk.superstep_span == 1
    assert got == want
    assert np.array_equal(_slab_set(carry.slab_to_numpy(chk.hstore.slab)),
                          _slab_set(ref.hstore.slab))
    monkeypatch.delenv("TLA_RAFT_ORBIT")
    plain = TorchChecker(RaftConfig(*args), device="cpu", chunk=64)
    assert got == plain.run() and not plain.orbit
    assert not np.array_equal(_slab_set(carry.slab_to_numpy(plain.hstore.slab)),
                              _slab_set(carry.slab_to_numpy(chk.hstore.slab)))


def _run(args, depth=None, G=None, **kw):
    chk = TorchChecker(RaftConfig(*args), device="cpu", orbit=True, **kw)
    if G is not None:
        chk.G = G
        chk.cap_g = chk.G * chk.cap_x // 2
    return chk.run(max_depth=depth), chk


def test_grouped_route_equals_staged_route():
    """G = 1 at chunk 4: (3,1,1,1)'s levels past 64 parents run on the
    grouped chain, with the orbit fingerprints inside the group program;
    the result, traces and visited set equal the all-staged orbit run."""
    a, ca = _run((3, 1, 1, 1), chunk=4, G=1)
    b, cb = _run((3, 1, 1, 1), chunk=4)
    assert ca.routes["grouped"] == 3 and cb.routes["grouped"] == 0
    assert a == b
    for (p, s), (q, t) in zip(ca.trace_levels, cb.trace_levels):
        assert np.array_equal(np.asarray(p, np.int64), np.asarray(q, np.int64))
        assert np.array_equal(np.asarray(s, np.int64), np.asarray(t, np.int64))
    assert np.array_equal(_slab_set(ca.hstore.slab.numpy()), _slab_set(cb.hstore.slab.numpy()))


def test_tiered_store_equals_hot_only():
    """Under an 8 KiB hot budget ((3,1,2,1) to depth 10, as
    tests/test_torch_tiered.py) the orbit run demotes and equals the
    hot-only orbit run."""
    hot, _ = _run((3, 1, 2, 1), depth=10, chunk=256)
    tier, chk = _run((3, 1, 2, 1), depth=10, chunk=256, store_bytes=8 * 1024)
    assert tier == hot and chk.tiered.stats["demotions"] >= 2


def test_tied_budget_overflow_grows_cap_x(monkeypatch):
    """With the tied budget cut to cap_x / 128 (the real floor of 256 tied
    rows a chunk is not reached at test scale), chunks overflow it, the
    level redoes with a larger cap_x, and the result does not move."""
    want, c0 = _run((3, 1, 1, 1), chunk=64)
    assert c0.redos["cap_x"] == 0
    monkeypatch.setattr(TorchChecker, "cap_nd", property(lambda self: self.cap_x // 128))
    got, chk = _run((3, 1, 1, 1), chunk=64)
    assert got == want and chk.redos["cap_x"] > 0


def test_seven_servers_small_constants():
    """S = 7 (P = 5,040, factored, int32 ids) with the small constants to
    depth 8: the reference's level sizes (tests/test_torch_scale.py:343),
    equal to the default definition's run."""
    got, chk = _run((7, 1, 1, 0), depth=8, chunk=64)
    assert chk.fpr.factored_msgs
    assert list(got.level_sizes) == [1, 1, 1, 2, 2, 3, 3, 4, 4]
    assert got == TorchChecker(RaftConfig(7, 1, 1, 0), device="cpu", chunk=64).run(max_depth=8)
