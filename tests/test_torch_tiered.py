"""The port's tiered visited store (store/tiered.py, ops/sieve.py and the
engine's tier hooks) against the reference's on the CPU: the row
compaction ``drop_rows`` (B16) against ``drop_rows_impl``; ``SpillSieve``,
its sizing and the warm ``TieredVisitedStore`` against the reference's on
the same demote and probe sequence; whole runs of (3,1,2,1) under an
8 KiB hot budget (a 1,024-slot slab, 511 resident entries, against 1,609
distinct states at depth 10, as tests/test_tiered.py runs the reference)
on every arm, equal to the hot-only run and to the reference's tiered run
level for level and stat for stat; a budgeted run through grouped levels;
and the CLI's ``--dev-bytes``.  All outputs are integers: equality is
exact."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu.ops import sieve as ref_sieve
from tla_raft_tpu.store import tiered as ref_tiered
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import sieve
from tla_raft_tpu_torch.store import tiered

from torch_port_corpus import batches

S3121 = (3, 1, 2, 1)
BUDGET = 8 * 1024
DEPTH = 10
HOT_SIZES = [1, 1, 3, 6, 12, 22, 49, 112, 241, 443, 719]  # (3,1,2,1) to depth 10
# the stats the engine computes (the reference's keys; probe_wait_s is a
# time, sieve_skips the port's own count of host probes the sieve saved)
STAT_KEYS = ("demotions", "spilled", "probes", "probe_lanes", "probe_hits", "sieve_hits",
             "warm_hits", "reheats", "tier_redos")


# -- B16 drop_rows --------------------------------------------------------------------


@pytest.mark.parametrize("p_keep", [0.0, 0.3, 0.9, 1.0])
def test_drop_rows_equals_reference(p_keep):
    _ref_st, _port_st, fr = batches((3, 1, 1, 1), n=300)
    rows = fr.voted_for.shape[0]
    keep = np.random.default_rng(int(p_keep * 10)).random(rows) < p_keep
    n_keep = int(keep.sum())
    tree = {f: jnp.asarray(getattr(fr, f).numpy()) for f in Frontier._fields}
    want = ref_tiered.drop_rows_impl(tree, jnp.asarray(keep), jnp.asarray(n_keep))
    got = tiered.drop_rows(fr, torch.from_numpy(keep), n_keep)
    for f in Frontier._fields:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(want[f])), f


# -- the spill sieve and the warm store --------------------------------------------------


def test_spill_sieve_equals_reference():
    g = np.random.default_rng(3)
    a, b = ref_sieve.SpillSieve(1024), sieve.SpillSieve(1024)
    for n in (500, 2000, 1):
        fps = g.integers(0, 1 << 64, n, dtype=np.uint64)
        a.add(fps)
        b.add(fps)
        assert np.array_equal(a.words, b.words)
        assert (a.version, a.n_added) == (b.version, b.n_added)
    probe = g.integers(0, 1 << 64, 5000, dtype=np.uint64)
    assert np.array_equal(a.contains(probe), b.contains(probe))
    # the device probe's twin against the host mirror on the same words
    hit = sieve.probe_plain(torch.from_numpy(b.words.view(np.int64)),
                            torch.from_numpy(probe.view(np.int64)))
    assert np.array_equal(hit.numpy(), b.contains(probe))
    for budget in (8 * 1024, 64 << 20, 10**9 + 7):
        assert sieve.sieve_words_for(budget) == ref_sieve.sieve_words_for(budget)


def test_warm_store_equals_reference():
    g = np.random.default_rng(5)
    a = ref_tiered.TieredVisitedStore(BUDGET)
    b = tiered.TieredVisitedStore(BUDGET)
    assert (a.hot_slot_budget(), a.max_hot_entries) == (b.hot_slot_budget(), b.max_hot_entries)
    caps = (512, 1024, 2048)
    assert [a.slab_fits(c) for c in caps] == [b.slab_fits(c) for c in caps]
    seen = np.empty(0, np.uint64)
    for depth in range(4):
        gen = g.integers(0, 1 << 64, 400, dtype=np.uint64)
        gen[:50] = gen[50:100]  # duplicates inside a run
        a.demote(np.concatenate([gen, [ref_tiered.SENT]]), depth=depth)
        b.demote(np.concatenate([gen, [ref_tiered.SENT]]))
        seen = np.union1d(seen, gen)
        probe = np.concatenate([g.choice(seen, 300),
                                g.integers(0, 1 << 64, 300, dtype=np.uint64), [ref_tiered.SENT]])
        ha, hb = a.probe(probe, level=depth), b.probe(probe)
        assert np.array_equal(ha, hb) and ha[:300].all() and not ha[-1]
    assert set(b.stats) == set(STAT_KEYS) | {"probe_wait_s", "sieve_skips"}
    assert {k: a.stats[k] for k in STAT_KEYS} == {k: b.stats[k] for k in STAT_KEYS}
    assert np.array_equal(a.spill_sieve.words, b.spill_sieve.words)
    assert np.array_equal(a.sieve, b.sieve)
    assert [g.fps.tolist() for g in a.gens] == [g.fps.tolist() for g in b.gens]
    assert a.spilled_distinct() == b.spilled_distinct() and len(a.gens) == len(b.gens) == 4


def test_store_bytes_from_env(monkeypatch):
    monkeypatch.setenv("TLA_RAFT_STORE_BYTES", "64e6")
    assert tiered.store_bytes_from_env() == ref_tiered.store_bytes_from_env() == 64_000_000
    chk = TorchChecker(RaftConfig(2, 1, 1, 1), device="cpu", chunk=64)
    assert chk.store_bytes == 64_000_000
    monkeypatch.delenv("TLA_RAFT_STORE_BYTES")
    assert tiered.store_bytes_from_env() == 0


# -- whole runs under the budget ----------------------------------------------------------


@pytest.fixture(scope="module")
def hot():
    return TorchChecker(RaftConfig(*S3121), device="cpu", chunk=256).run(max_depth=DEPTH)


@pytest.fixture(scope="module")
def ref_tiered_run():
    chk = JaxChecker(RefConfig(*S3121), chunk=256, store_bytes=BUDGET)
    return chk.run(max_depth=DEPTH), chk


@pytest.mark.parametrize("arm", [{}, dict(superstep=1), dict(megakernel=False)],
                         ids=["supersteps", "fused", "staged"])
def test_tiered_run_equals_hot_and_reference(hot, ref_tiered_run, arm):
    ref, ref_chk = ref_tiered_run
    occupancy = []
    chk = TorchChecker(RaftConfig(*S3121), device="cpu", chunk=256, store_bytes=BUDGET, **arm)
    if arm:  # each level adopts before its progress record: the hot count is exact there
        chk.progress = lambda s: occupancy.append((chk.hstore.occupancy(), chk.hstore.count))
    got = chk.run(max_depth=DEPTH)
    assert got == hot == ref
    st = chk.tiered.stats
    assert st["demotions"] >= 2 and st["probe_hits"] > 0 and st["reheats"] == st["probe_hits"]
    assert st["sieve_hits"] + st["warm_hits"] == st["probe_hits"]
    assert {k: st[k] for k in STAT_KEYS} == {k: ref_chk.tiered.stats[k] for k in STAT_KEYS}
    assert got.distinct > 3 * chk.tiered.max_hot_entries
    assert chk.hstore.occupancy() == chk.hstore.count
    assert chk.hstore.count + chk.tiered.spilled_distinct() >= got.distinct
    assert all(a == b for a, b in occupancy) and len(occupancy) == (DEPTH if arm else 0)
    assert chk.tier_soft_seats > 0  # one level's fresh set seated past the budget
    if not arm:
        # a superstep level with sieve hits stopped the window and replayed alone
        assert chk._ss_stats == ref_chk._ss_stats and chk._ss_stats["sieve_stops"] >= 1
        assert chk.routes["fused"] >= chk._ss_stats["sieve_stops"]
        # the fused programs probe the spill sieve's words, refreshed in place
        # before the next program runs (the last demotion followed the last level)
        ptr = chk._sieve_dev.data_ptr()
        words = chk._sieve_operand()
        assert words.data_ptr() == ptr
        assert np.array_equal(words.numpy().view(np.uint64), chk.tiered.spill_sieve.words)
        spilled = np.concatenate([g.fps for g in chk.tiered.gens])
        fps = np.random.default_rng(0).choice(spilled, 200)
        hit = sieve.probe_plain(chk._sieve_dev, torch.from_numpy(fps.view(np.int64)))
        assert hit.numpy().all()
        assert np.array_equal(hit.numpy(), chk.tiered.spill_sieve.contains(fps))


def test_tiered_run_through_grouped_levels():
    """G = 1 at chunk 64: levels of more than 1,024 parents run grouped;
    under the 8 KiB budget their tails probe the generations too."""
    def run(**kw):
        chk = TorchChecker(RaftConfig(*S3121), device="cpu", chunk=64, **kw)
        chk.G, chk.cap_g = 1, chk.cap_x // 2
        return chk.run(max_depth=13), chk

    want, _ = run()
    got, chk = run(store_bytes=BUDGET)
    assert got == want and chk.routes["grouped"] == 2
    st = chk.tiered.stats
    assert st["demotions"] >= 2 and st["reheats"] == st["probe_hits"] > 0
    assert st["probes"] >= chk.routes["grouped"]


def test_cli_dev_bytes(capsys):
    from tla_raft_tpu_torch import check

    args = ["--servers", "3", "--vals", "1", "--max-election", "2", "--max-restart", "1",
            "--device", "cpu", "--chunk", "256", "--max-depth", str(DEPTH), "--json"]
    summaries = []
    for extra in ([], ["--dev-bytes", str(BUDGET)]):
        assert check.main(args + extra) == 0
        summaries.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    plain, tier = summaries
    keys = ("distinct", "generated", "depth", "level_sizes")
    assert [tier[k] for k in keys] == [plain[k] for k in keys] == [1609, 3605, 10, HOT_SIZES]
    assert "tiered" not in plain
    assert tier["tiered"]["dev_bytes"] == BUDGET and tier["tiered"]["demotions"] >= 2
    assert tier["tiered"]["reheats"] == tier["tiered"]["probe_hits"] > 0
