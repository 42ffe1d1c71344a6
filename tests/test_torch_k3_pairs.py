"""K3's pair-digit form at S = 4 and 5 (csrc/fingerprint.cu
``fingerprint_pairs``) and K1 from id lists (csrc/guards.cu, the inflate
folded into its staging), as the card computes them: numpy models of
their routes (tests/redesign_cases.py) and the port's CPU twins, against
the reference on the same inputs, exactly."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.models.raft import RaftState as RefState
from tla_raft_tpu.ops.fingerprint import Fingerprinter as RefFingerprinter
from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch import carry, kernels
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.kernels import _field_shapes
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.ops.msg_universe import get_universe
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
from tla_raft_tpu_torch.u64 import _combine_planes_u32

from redesign_cases import (CORE_FIELDS, DIMS, k1_group_model, k1_group_parents, k1_ids_words,
                            k3pairs_id_lists, k3pairs_model, k3pairs_sibling_lists)

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
_FPRS: dict = {}


def _fprs(S: int, forced=None):
    """(reference, port) Fingerprinters at S servers, built once."""
    if (S, forced) not in _FPRS:
        _FPRS[S, forced] = (RefFingerprinter(RefConfig(n_servers=S), force_factored=forced),
                            Fingerprinter(RaftConfig(n_servers=S), device="cpu",
                                          force_factored=forced))
    return _FPRS[S, forced]


def _fields(cfg, rows: int, seed: int) -> dict:
    """Seeded core fields (uint8, small values of every field's range, the
    votedFor one-hot's every value among them)."""
    g = np.random.default_rng(seed)
    shapes = _field_shapes(cfg)
    out = {}
    for f in CORE_FIELDS:
        hi = cfg.S + 1 if f == "voted_for" else 4
        out[f] = g.integers(0, hi, (rows, *shapes[f])).astype(np.uint8)
    return out


def _reference(rf, uni, fields: dict, ids: np.ndarray):
    """The reference's (fp_view, fp_full) u64 of the states (its msgs from
    the id lists by the port's plain inflate, which tests/test_torch_scale
    holds to the reference's ``_ids_to_msgs``)."""
    msgs = bfs.ids_to_msgs_plain(torch.from_numpy(ids), uni.n_words).numpy().view(np.uint32)
    st = RefState(msgs=jnp.asarray(msgs), **{f: jnp.asarray(v) for f, v in fields.items()})
    v, f, _m = rf.state_fingerprints(st)
    return np.asarray(v), np.asarray(f)


K3PAIRS_CASES = [(4, "rows"), (4, "dead"), (4, "indexed"), (4, "siblings"), (5, "rows"),
                 (5, "dead"), (5, "indexed"), (5, "int32"), (5, "siblings"),
                 (5, "siblings-indexed"), (3, "forced")]


@pytest.mark.parametrize("S,case", K3PAIRS_CASES,
                         ids=[f"s{S}-{c}" for S, c in K3PAIRS_CASES])
def test_k3pairs_model_matches_reference(S, case):
    """The numpy model of K3's pair-digit form (``redesign_cases.k3pairs_model``:
    groups of 64 states, features through their codes, a state's R rows of
    the pair digits its ids carry, the PPERM fold over every permutation
    with the four channels at once, each warp's run of 4 states updated by
    the ids that differ from the last state's or rebuilt, the warps'
    minima, each state written once with SENT past the live count) equals
    the reference's
    ``Fingerprinter.state_fingerprints`` at S = 4 and 5 (and at S = 3
    under the forced factored hash, which takes this form): on seeded
    states with edge id lists (none, cap_m of them, random, the highest
    ids of the universe, one, one pair digit only, every digit) and with
    runs of sibling lists (a parent's list with ids added or taken out:
    the incremental updates); under a live count whose tail holds whole
    groups of 64 (SENT there); in the indexed mode (only the outputs at the
    index rows below the count change); and with the id lists as int32
    words."""
    rf, pf = _fprs(S, True if case == "forced" else None)
    uni, cfg = pf.uni, pf.cfg
    n, cap_m = 200, 96
    fields = _fields(cfg, n, S)
    if case.startswith("siblings"):
        ids = k3pairs_sibling_lists(uni.M, n, cap_m, S)
    else:
        ids = k3pairs_id_lists(uni.M, uni.type_offsets, uni.type_strides, n, cap_m,
                               S + len(case))
    rv, rff = _reference(rf, uni, fields, ids)
    t = pf.kernel_tables_np()
    assert t["form"] == "pairs"
    args = (t["ct"], t["gt_eff"], t["pperm"], uni.type_offsets, uni.type_strides,
            t["row_base"], S, cfg.L, pf.spec.F)
    if case.endswith("indexed"):
        g = np.random.default_rng(9)
        idx = (np.sort(g.permutation(n)[: n // 2]) if case == "siblings-indexed"
               else g.permutation(n)[: n // 2])
        live = idx.shape[0] - 5
        v, f = k3pairs_model(fields, ids, *args, live, idx=idx,
                             out=(np.full(n, 7, np.uint64), np.full(n, 9, np.uint64)))
        hit = np.zeros(n, bool)
        hit[idx[:live]] = True
        assert np.array_equal(v[hit], rv[hit]) and np.array_equal(f[hit], rff[hit])
        assert (v[~hit] == 7).all() and (f[~hit] == 9).all()
        return
    live = n - 70 if case == "dead" else n  # rows 130-199: group 3 wholly past live
    v, f = k3pairs_model(fields, ids, *args, live, id_bytes=4 if case == "int32" else 2)
    assert np.array_equal(v[:live], rv[:live]) and np.array_equal(f[:live], rff[:live])
    assert (v[live:] == SENT).all() and (f[live:] == SENT).all()
    # the port's plain twin agrees on the same rows
    fr = Frontier(**{k: torch.from_numpy(x) for k, x in fields.items()},
                  msg_ids=torch.from_numpy(ids.astype(np.int16)))
    pv, pff = pf.state_fingerprints(Frontier(*(x[:live] for x in fr)))
    assert np.array_equal(pv.numpy().view(np.uint64), rv[:live])
    assert np.array_equal(pff.numpy().view(np.uint64), rff[:live])


@pytest.mark.parametrize("S", [4, 5])
def test_pair_tables_equal_the_reference_pair_blocks(S):
    """The pair-digit table the S = 4-5 form reads (``gt_eff``, built for
    every config now) is the reference's pair-block planes (its forced
    factored tables, carried across by ``carry.factored_tables``) with the
    four planes combined, and PPERM is the reference's one-hot fold;
    ``factored_msgs`` stays the reference's choice (False at S = 4, 5)."""
    rf, pf = _fprs(S)
    rff, _pff = _fprs(S, True)
    assert rf.factored_msgs is False and pf.factored_msgs is False
    got = carry.factored_tables(rff._Gt_planes, rff._ppfold, "cpu")
    t = pf.kernel_tables_np()
    NP = pf.NP
    # the four signed byte planes of a coefficient combine to its effective u32
    eff = torch.cat([_combine_planes_u32(g.to(torch.int64).reshape(-1, NP, 4, 4))
                     for g in got["Gt_planes"]])
    assert np.array_equal(eff.numpy().astype(np.uint32), t["gt_eff"])
    assert np.array_equal(got["fold_index"].numpy() % NP, t["pperm"].astype(np.int64))
    assert "msg_eff" in t  # the orbit kernel and the S <= 3 form read the folded table


K3_FORM_CASES = [(2, None, "s3"), (3, None, "s3"), (3, True, "pairs"), (4, None, "pairs"),
                 (5, None, "pairs"), (5, True, "pairs")]


@pytest.mark.parametrize("S,forced,form", K3_FORM_CASES,
                         ids=[f"s{S}{'-forced' if f else ''}" for S, f, _ in K3_FORM_CASES])
def test_k3_tables_follow_the_form(S, forced, form):
    """Each config's K3 form (the S <= 3 folded table, the pair-digit fold
    at S = 4, 5 and under the factored hash) and the tables built for it:
    the pair-digit rows and PPERM only past the S <= 3 form, the channel
    halves only for the factored form, the folded table wherever the hash
    is monolithic (the S <= 3 form and the orbit kernel read it)."""
    pf = _fprs(S, forced)[1]
    t = pf.kernel_tables_np()
    assert t["form"] == form == kernels.k3_form(pf.factored_msgs, pf.P, t["f_pad"])
    assert ("gt_eff" in t) == ("pperm" in t) == (form != "s3")
    assert "gt_half" not in t
    assert ("msg_eff" in t) == (not pf.factored_msgs) == (forced is None)


def test_k3_form_by_permutations_and_feature_width():
    """``kernels.k3_form``: the S <= 3 form up to 8 permutations and 128
    feature columns under the monolithic hash, the pair-digit fold up to
    120 permutations, the factored form past them (S = 6: 720, S = 7:
    5,040)."""
    assert kernels.k3_form(False, 6, 96) == "s3"
    assert kernels.k3_form(False, 8, 128) == "s3"
    assert kernels.k3_form(False, 6, 160) == "pairs"
    assert kernels.k3_form(True, 6, 96) == "pairs"
    assert kernels.k3_form(False, 24, 96) == "pairs"
    assert kernels.k3_form(False, 120, 192) == "pairs"
    assert kernels.k3_form(False, 720, 192) == "factored"
    assert kernels.k3_form(True, 5040, 256) == "factored"
    assert kernels.K3_FORMS == ("s3", "pairs", "factored")


# -- K1 from id lists: the inflate folded into its staging --------------------------

K1IDS_CASES = [(3, ()), (5, ()), (7, ()), (3, ("double-vote",))]


@pytest.mark.parametrize("S,muts", K1IDS_CASES, ids=["s3", "s5", "s7", "double-vote"])
def test_k1_ids_twin_matches_reference(S, muts):
    """K1's id-list form against the reference's ``_ids_to_msgs`` followed
    by its guards (``MXUExpand.guards``): the model of the masks K1 builds
    (``redesign_cases.k1_ids_words``: a group's words zeroed, each id ORed
    in) equals the reference's inflate, and through K1's group model gives
    the reference's valid rows, multiplicities and abort; the fused level's
    CPU twin (``megakernel.op_guards`` on a chunk's Frontier: the plain
    inflate, then the plain guards) gives the same valid rows, per-slot
    sums and first abort (+ base) over the rows below its device count,
    and leaves the dead rows' valid rows as they were.  Int16 ids at S = 3
    and 5, int32 ids >= 2^15 at S = 7."""
    rc, pc = RefConfig(n_servers=S, mutations=muts), RaftConfig(n_servers=S, mutations=muts)
    uni = get_universe(pc)
    rows, cap_m = 90, 48
    fields = _fields(pc, rows, S + 3)
    g = np.random.default_rng(S)
    ids = np.full((rows, cap_m), -1, np.int64)
    for i, k in enumerate(g.integers(0, cap_m + 1, rows)):
        ids[i, :k] = np.sort(g.choice(uni.M, k, replace=False))
    id_dtype = np.int32 if S == 7 else np.int16
    if S == 7:
        assert ids.max() >= 1 << 15
    fake = types.SimpleNamespace(uni_words=uni.n_words)
    words = np.asarray(JaxChecker._ids_to_msgs(fake, jnp.asarray(ids.astype(id_dtype))))
    mx = MXUExpand(pc, "cpu")
    d = dict(zip(DIMS, kernels.dims_array(pc, uni)))
    lay = mx.layout
    group = k1_group_parents(d, mx.K, lay.accept_runs[1], False)
    built = k1_ids_words(ids, uni.n_words, group)
    assert np.array_equal(built, words)
    st = RefState(msgs=jnp.asarray(words), **{f: jnp.asarray(v) for f, v in fields.items()})
    rv, rm, ra = (np.asarray(x) for x in get_kernel(rc, mxu=True).expand_guards(st))
    live = rows - 7
    bits = ((built[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(rows, -1)
    valid, mult, abort, sums, first = k1_group_model(
        d, fields, bits[:, : uni.M].astype(np.uint8), lay.slot_table_np, lay.accept_runs,
        group, live)
    assert np.array_equal(valid, rv[:live]) and np.array_equal(mult, rm[:live])
    assert np.array_equal(abort, ra[:live])
    # the fused level's twin on the chunk's Frontier, under a device count
    eng = types.SimpleNamespace(use_mxu=True, mx=mx, uni=uni)
    part = Frontier(**{k: torch.from_numpy(x) for k, x in fields.items()},
                    msg_ids=torch.from_numpy(ids.astype(id_dtype)))
    out = torch.ones((rows, mx.K), dtype=torch.bool)
    acc = torch.full((mx.K,), 3, dtype=torch.int64)
    ab = torch.full((), 1 << 62, dtype=torch.int64)
    mk.op_guards(eng, part, None, out, torch.tensor(live + 11), 11, acc, ab, 1000)
    assert np.array_equal(out[:live].numpy(), rv[:live]) and bool(out[live:].all())
    assert np.array_equal(acc.numpy(), rm[:live].astype(np.int64).sum(0) + 3)
    want = 1000 + int(np.argmax(ra[:live])) if ra[:live].any() else 1 << 62
    assert int(ab) == want and first == (want - 1000 if ra[:live].any() else -1)
    assert rv[:live].any()
