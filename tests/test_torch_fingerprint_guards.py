"""Kernels K3 (fingerprints) and K1 (guards): the port's plain twins
against the reference on the same reachable states, exactly."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest

from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
from torch_port_corpus import CONFIGS, MUT_ARGS, MUTATIONS, batches, configs, u64

FP_CASES = [(CONFIGS["s2"], 200, 0), (CONFIGS["s3v1"], 300, 0), (CONFIGS["ref"], 300, 200)]


@pytest.mark.parametrize("args,n,tail", FP_CASES, ids=["s2", "s3v1", "ref"])
def test_fingerprints_match_reference(args, n, tail):
    rc, pc = configs(args)
    ref_st, _port, fr = batches(args, n=n, tail=tail)
    rv, rf, _msum = get_kernel(rc, mxu=True).fpr.state_fingerprints(ref_st)
    pv, pf = Fingerprinter(pc, device="cpu").state_fingerprints(fr)  # CPU: the plain twin
    assert np.array_equal(u64(pv), np.asarray(rv))
    assert np.array_equal(u64(pf), np.asarray(rf))


def test_fingerprints_match_reference_numpy_path():
    """The twin also equals the reference's host numpy path."""
    rc, pc = configs(CONFIGS["ref"])
    _ref, port, fr = batches(CONFIGS["ref"], n=300, tail=200)
    from tla_raft_tpu_torch.models.raft import state_to_np

    arrs = state_to_np(port)
    bits = Fingerprinter(pc, device="cpu").uni.unpack_bits(arrs["msgs"])
    rv, rf = get_kernel(rc, mxu=True).fpr.fingerprints_np(arrs, bits)
    pv, pf = Fingerprinter(pc, device="cpu").state_fingerprints(fr)
    assert np.array_equal(u64(pv), rv) and np.array_equal(u64(pf), rf)


GUARD_CASES = [(CONFIGS[k], ()) for k in CONFIGS] + [(MUT_ARGS, (m,)) for m in MUTATIONS]
GUARD_IDS = list(CONFIGS) + list(MUTATIONS)


@pytest.mark.parametrize("args,muts", GUARD_CASES, ids=GUARD_IDS)
def test_guards_match_reference(args, muts):
    rc, pc = configs(args, muts)
    ref_st, port, _fr = batches(args, muts, n=250, tail=150)
    rv, rm, ra = get_kernel(rc, mxu=True).expand_guards(ref_st)
    pv, pm, pa = MXUExpand(pc, "cpu").guards(port)  # CPU: the plain twin
    assert np.array_equal(pv.numpy(), np.asarray(rv)), np.argwhere(pv.numpy() != np.asarray(rv))[:5]
    assert np.array_equal(pm.numpy(), np.asarray(rm))
    assert np.array_equal(pa.numpy(), np.asarray(ra))


# -- K1 as the card computes it: groups, count tables, family-7 runs -------------

K1_MODEL_CASES = [(3, ()), (5, ()), (7, ()), (3, ("double-vote",)), (3, ("become-follower",)),
                  (3, ("legacy-append",))]


def _random_states(rc, pc, rows, seed):
    """Reachable field values in new combinations (each field from its own
    randomly chosen reachable state) and random message sets of several
    densities: (reference RaftState, port fields, bits u8 [rows, M])."""
    from tla_raft_tpu.models.raft import from_oracle as ref_from_oracle
    from tla_raft_tpu.oracle.explicit import collect_reachable
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops.msg_universe import get_universe

    g = np.random.default_rng(seed)
    ref = ref_from_oracle(rc, collect_reachable(rc, 300))
    n = np.asarray(ref.role).shape[0]
    fields = {f: np.asarray(getattr(ref, f))[g.integers(0, n, rows)]
              for f in Frontier._fields[:-1]}
    uni = get_universe(pc)
    dens = g.choice([0.0, 0.002, 0.01, 0.05], rows)[:, None]
    bits = (g.random((rows, uni.n_words * 32)) < dens).astype(np.uint8)
    bits[:, uni.M:] = 0
    words = (bits.reshape(rows, -1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    st = type(ref)(msgs=jnp.asarray(words), **{f: jnp.asarray(v) for f, v in fields.items()})
    return st, fields, bits[:, : uni.M]


@pytest.mark.parametrize("S,muts", K1_MODEL_CASES,
                         ids=["s3", "s5", "s7", "double-vote", "become-follower",
                              "legacy-append"])
def test_k1_group_model_matches_reference(S, muts):
    """The numpy model of K1's route (``redesign_cases.k1_group_model``:
    groups of ``k1_group_parents`` parents, the (pair, term) count tables,
    family 7 as runs of E * L mask bits, every other slot on its family,
    per-group sums of the multiplicities, the first abort) equals the
    reference's ``MXUExpand.guards`` on random states at S = 3, 5 and 7
    and under the double_vote, become_follower and legacy_append
    mutations, with the last rows dead (past the device count)."""
    from tla_raft_tpu.config import RaftConfig as RefConfig
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.ops.msg_universe import get_universe
    from tla_raft_tpu_torch.ops.successor import get_layout
    from redesign_cases import DIMS, k1_group_model, k1_group_parents

    rc, pc = RefConfig(n_servers=S, mutations=muts), RaftConfig(n_servers=S, mutations=muts)
    rows = 90
    st, fields, bits = _random_states(rc, pc, rows, S + len(muts))
    rv, rm, ra = (np.asarray(x) for x in get_kernel(rc, mxu=True).expand_guards(st))
    d = dict(zip(DIMS, kernels.dims_array(pc, get_universe(pc))))
    lay = get_layout(pc)
    tab = lay.slot_table_np
    live = rows - 3
    for per_row in (False, True):
        group = k1_group_parents(d, tab.shape[0], lay.accept_runs[1], per_row)
        valid, mult, abort, sums, first = k1_group_model(d, fields, bits, tab, lay.accept_runs,
                                                         group, live)
        assert np.array_equal(valid, rv[:live]), np.argwhere(valid != rv[:live])[:5]
        assert np.array_equal(mult, rm[:live])
        assert np.array_equal(abort, ra[:live])
        assert np.array_equal(sums.sum(0), rm[:live].astype(np.int64).sum(0))
        assert first == (int(np.argmax(ra[:live])) if ra[:live].any() else -1)
    assert rv.any() and ra[:live].any() == bool(abort.any())


# -- K3 at S <= 3 as the card computes it: staged fields, codes, (state, perm) sums ---

K3S3_CASES = [("s2", "frontier", 2), ("s2", "edges", 2), ("ref", "frontier", 2),
              ("ref", "edges", 2), ("ref", "edges", 4), ("ref", "dead", 2),
              ("ref", "indexed", 2)]


@pytest.mark.parametrize("cfg,case,id_bytes", K3S3_CASES,
                         ids=["s2", "s2-edges", "s3", "s3-edges", "s3-int32", "s3-dead",
                              "s3-indexed"])
def test_k3s3_model_matches_reference(cfg, case, id_bytes):
    """The numpy model of K3's S <= 3 form (``redesign_cases.k3s3_model``:
    groups of 64 states, the fields staged field-major and read through the
    features' codes, the feature table's used columns, the message part a
    (state, permutation) at a time with its four channels from one eff row,
    the three permutation sets' minima) equals the reference's
    ``Fingerprinter.state_fingerprints`` at S = 2 and 3: on mixed reachable
    rows with their own id lists; with edge id lists (none, cap_m of them,
    random, the universe's highest ids, one) as int16 and as int32 words;
    under a live count (the rows past it SENT, a whole group of 64 among
    them); and in the indexed mode (rows at a permutation of the states,
    the other outputs kept)."""
    import torch

    from tla_raft_tpu.models.raft import RaftState as RefState
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.models.raft import Frontier
    from redesign_cases import CORE_FIELDS, k3s3_id_lists, k3s3_model

    rc, pc = configs(CONFIGS[cfg])
    _ref, _port, fr = batches(CONFIGS[cfg], n=300, tail=200 if cfg == "ref" else 0)
    g = np.random.default_rng(len(case) + id_bytes)
    n = fr.voted_for.shape[0]
    rows = torch.from_numpy(g.integers(0, n, n))
    fr = Frontier(*(x[torch.from_numpy(g.integers(0, n, n))] for x in fr[:-1]),
                  fr.msg_ids[rows])
    fpr = Fingerprinter(pc, device="cpu")
    uni, cap_m = fpr.uni, fr.msg_ids.shape[1]
    if case in ("edges", "dead", "indexed"):
        ids = k3s3_id_lists(uni.M, n, cap_m, 11)
        fr = fr._replace(msg_ids=torch.from_numpy(ids).to(fr.msg_ids.dtype))
    msgs = bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words).numpy().view(np.uint32)
    ref = RefState(msgs=jnp.asarray(msgs),
                   **{f: jnp.asarray(getattr(fr, f).numpy()) for f in Frontier._fields[:-1]})
    rv, rf, _m = get_kernel(rc, mxu=True).fpr.state_fingerprints(ref)
    rv, rf = np.asarray(rv), np.asarray(rf)
    t = fpr.kernel_tables_np()
    fields = {f: getattr(fr, f).numpy() for f in CORE_FIELDS}
    ids = fr.msg_ids.numpy().astype(np.int64)
    args = (t["ct"], t["msg_eff"], pc.S, pc.L, fpr.spec.F)
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    if case == "indexed":
        idx = g.permutation(n)[: n // 2]
        before = (np.full(n, 7, np.uint64), np.full(n, 9, np.uint64))
        live = idx.shape[0] - 5
        v, f = k3s3_model(fields, ids, *args, live, id_bytes, idx=idx, out=before)
        hit = np.zeros(n, bool)
        hit[idx[:live]] = True
        assert np.array_equal(v[hit], rv[hit]) and np.array_equal(f[hit], rf[hit])
        assert (v[~hit] == 7).all() and (f[~hit] == 9).all()
        return
    live = n - 70 if case == "dead" else n
    v, f = k3s3_model(fields, ids, *args, live, id_bytes)
    assert np.array_equal(v[:live], rv[:live]) and np.array_equal(f[:live], rf[:live])
    assert (v[live:] == sent).all() and (f[live:] == sent).all()
