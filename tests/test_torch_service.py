"""The port's sweep service against the reference on the CPU: B14's bucket
core (the plain twins of ``bucket_refine``, ``bucket_tally`` and
``bucket_ctrl`` inside the port's bucket level and superstep, which the
kernels of csrc/bucket.cu are held to on the card) against the reference's
jitted ``_level_step`` / ``_fused_level`` / ``_superstep`` on a seeded
stacked frontier; the port's ``BatchedChecker`` against the reference's and
against sequential runs, config by config; ``bstate`` snapshots crossing
between the packages; and the service itself in subprocesses (submit, run
``--once``, results, the two SIGKILL drills of tests/test_service.py:297 and
:336, the reference's queue served by the port).  Every output is an
integer: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.ops import hashstore as ref_hs
from tla_raft_tpu.resilience import faults as ref_faults
from tla_raft_tpu.service import bucket as ref_bucket
from tla_raft_tpu.service.queue import JobQueue as RefQueue
from tla_raft_tpu_torch.check import run_check, summary_public
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.resilience import faults
from tla_raft_tpu_torch.service import bucket as bk
from tla_raft_tpu_torch.service.daemon import Scheduler
from tla_raft_tpu_torch.service.queue import JobQueue, cfg_to_doc
from tla_raft_tpu_torch.service.synth import synth_jobs

from torch_port_corpus import batches, u64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))  # the reference's queue_synth
PARITY = ("ok", "distinct", "generated", "depth", "level_sizes", "violation")


def _key(rows) -> list:
    return [{k: r[k] for k in PARITY} for r in rows]


def _seq(cfg, depth=None) -> dict:
    r = TorchChecker(cfg, device="cpu", chunk=64).run(max_depth=depth)
    return dict(ok=r.ok, distinct=r.distinct, generated=r.generated, depth=r.depth,
                level_sizes=list(r.level_sizes),
                violation=r.violation[0] if r.violation else None)


# -- the bucket level against the reference's jitted programs ----------------------


def test_salts_and_keys_equal_the_references():
    assert np.array_equal(bk.config_salts(16), ref_bucket.config_salts(16))
    c = RaftConfig(3, 1, 2, 2)
    assert cfg_to_doc(bk.bucket_key(c)) == cfg_to_doc(ref_bucket.bucket_key(RefConfig(3, 1, 2, 2)))


@pytest.fixture(scope="module")
def stacked():
    """A stacked frontier of 600 reachable double-vote states (four aborting
    rows among the last 200, all of config 2) for a 3-config bucket,
    MaxRestart (0, 1, 1), its rows' configs sorted at random from a numpy
    seed and config 1 done."""
    ref_st, _port, fr = batches((3, 1, 2, 1), ("double-vote",), n=400, tail=200)
    g = np.random.default_rng(5)
    B = fr.voted_for.shape[0]
    crow = np.sort(g.integers(0, 3, B)).astype(np.int64)
    done = np.array([False, True, False, True])
    cfgs = [RaftConfig(3, 1, 2, m, mutations=("double-vote",)) for m in (0, 1, 1)]
    return ref_st, fr, crow, done, cfgs


def _port_level(bc, fr, crow, n_run, done, g_cap):
    """One port bucket level (the fused program, eagerly on the CPU)."""
    cap_in = -(-n_run // bc.eng.chunk) * bc.eng.chunk
    prog = bk.BucketLevelProgram(bc, ("t",), cap_in, g_cap)
    mk.copy_rows(prog.fr_in, fr, n_run)
    prog.crow_in[:n_run] = torch.from_numpy(crow[:n_run])
    bc.vec.upload(done, np.zeros(bc.C_pad, np.int64), np.full(bc.C_pad, -1))
    prog.run(n_run)
    return prog


def test_bucket_level_equals_the_reference_step(stacked):
    """_level_step and _fused_level on the same stacked frontier and slab:
    the valid lanes' salted fps, the fresh lanes, gen / new / abort per
    config, the slab bytes after the insert, and the survivors' (row, slot)
    in lane order.  Two levels: the second into the slab the first left."""
    ref_st, fr, crow, done, cfgs = stacked
    B = fr.voted_for.shape[0]
    kcfg = RefConfig(3, 1, 2, 1, mutations=("double-vote",))
    progs = ref_bucket._get_programs(kcfg, True, 4)
    K = progs.K
    mr = np.array([0, 1, 1, 0], np.int32)
    salt = bk.config_salts(4)
    bc = bk.BatchedChecker(cfgs, device="cpu", chunk=64)
    assert bc.K == K
    bc.eng.cap_x = bc.eng.chunk * K  # no chunk can overflow (the runs redo one that does)
    ref_slab = ref_hs.make_slab(1 << 16)
    bc._set_slab(torch.full((1 << 16,), -1, dtype=torch.int64))
    aborted = []
    for n_run in (150, B):
        live = (np.arange(B) < n_run) & ~done[crow]
        out = progs.step(ref_st, jnp.asarray(live), jnp.asarray(crow), jnp.asarray(mr),
                         jnp.asarray(salt), ref_slab)
        fused = progs.fused(ref_st, jnp.asarray(live), jnp.asarray(crow), jnp.asarray(mr),
                            jnp.asarray(salt), ref_slab, jnp.asarray(done), g_cap=8192)
        slab2, fresh, fps, gen_c, new_c, abort_c, ovf = (np.asarray(x) for x in out)
        assert not ovf
        prog = _port_level(bc, fr, crow, n_run, done, 8192)
        Bf = prog.B
        live_lanes = int(prog.lc[mk.LC_LIVE_LANES])
        cp = Bf.cp[:live_lanes].numpy()
        on = cp >= 0
        # every valid lane, salted, and nothing else
        assert np.array_equal(np.nonzero(fps != ref_hs.SENT)[0], cp[on])
        assert np.array_equal(u64(Bf.cv[:live_lanes])[on], fps[cp[on]])
        # the fresh lanes (the min-(fp_full, payload) representatives)
        assert np.array_equal(np.nonzero(fresh)[0], cp[Bf.k4.fresh[:live_lanes].numpy()])
        for mine, ref in ((bc.vec.gen, gen_c), (bc.vec.new, new_c), (bc.vec.abort, abort_c)):
            assert np.array_equal(mine.numpy()[:3], np.asarray(ref, np.int64)[:3])
        aborted.append(bool(abort_c.any()))
        assert np.array_equal(u64(bc.slab), slab2)
        # the survivors: fresh & ~(done | abort)[config], in lane order
        n_g = int(prog.bs[bk.BS_NG])
        assert n_g == int(fused[-1])
        rows = np.asarray(fused[3])[:n_g]
        assert np.array_equal(prog.B.surv_pay[:n_g].numpy() // K, rows)
        assert np.array_equal(prog.crow_out[:n_g].numpy(), crow[rows])
        ref_slab = jnp.asarray(slab2)
    assert aborted == [False, True]  # the whole corpus holds aborting rows


def test_bucket_superstep_equals_the_reference():
    """_superstep from a 3-config bucket's initial frontier, span 6, one
    member depth-capped at 2: the committed levels, the per-level meta rows
    (new, gen, abort, inserted, survivors) and the ring of inserted salted
    fps, equal to the port's superstep program's."""
    cfgs = [RaftConfig(2, 1, 1, m) for m in (0, 1, 2)]
    kcfg = RefConfig(2, 1, 1, 2)
    progs = ref_bucket._get_programs(kcfg, True, 4)
    salt = bk.config_salts(4)
    bc = bk.BatchedChecker(cfgs, device="cpu", chunk=64)
    fr1, _ = bc.eng.deflate(bk.init_batch(bc.kcfg, 1, "cpu"))
    fp0 = np.uint64(bc.eng.fpr.state_fingerprints(fr1)[0].numpy().view(np.uint64)[0])
    slab0 = ref_hs.insert_np(np.full(1 << 12, ref_hs.SENT, np.uint64),
                             (fp0 ^ salt[:3]).astype(np.uint64))
    B0, g_cap, span, ring = 8, 512, 6, 4096
    crow = np.minimum(np.arange(B0), 2).astype(np.int64)
    done = np.array([False, False, False, True])
    depth = np.zeros(4, np.int64)
    cap = np.array([2, -1, -1, -1], np.int64)
    from tla_raft_tpu.models.raft import init_batch as ref_init

    res = progs.sstep(ref_init(kcfg, B0), jnp.asarray(np.arange(B0) < 3), jnp.asarray(crow),
                      jnp.asarray(np.array([0, 1, 2, 0], np.int32)), jnp.asarray(salt),
                      jnp.asarray(slab0), jnp.asarray(done), jnp.asarray(depth), jnp.asarray(cap),
                      g_cap=g_cap, span=span, ring=ring)
    ctrl, m_new, m_gen, m_abort, m_ins, m_ng, rf = (np.asarray(x) for x in res[6:])
    levels = int(ctrl[0])
    assert levels == span
    bc._set_slab(torch.from_numpy(slab0.view(np.int64).copy()))
    prog = bk.BucketSuperstepProgram(bc, ("t",), g_cap, span, ring)
    fr, _ = bc.eng.deflate(bk.init_batch(bc.kcfg, B0, "cpu"))
    mk.copy_rows(prog.fr[0], fr, B0)
    prog.crow[0][:B0] = torch.from_numpy(crow)
    bc.vec.upload(done, depth, cap)
    prog.run(3, span, ring)
    bs = prog.bs.numpy()
    assert (int(bs[bk.BS_LEVELS]), int(bs[bk.BS_REASON]), int(bs[bk.BS_OFF])) == (
        levels, int(ctrl[1]), int(ctrl[2]))
    mine = [t.numpy() for t in prog.meta]
    for a, b in zip(mine[:3], (m_new, m_gen, m_abort)):
        assert np.array_equal(a[:levels, :3], np.asarray(b, np.int64)[:levels, :3])
    assert np.array_equal(mine[3][:levels], m_ins[:levels])
    assert np.array_equal(mine[4][:levels], m_ng[:levels])
    off = int(ctrl[2])
    assert np.array_equal(u64(prog.ring[:off]), rf[:off])


# -- whole buckets -----------------------------------------------------------------


def _ref_bucket(cfgs, depths=None, ckdir=None):
    return ref_bucket.BatchedChecker([RefConfig(**dataclasses.asdict(c)) for c in cfgs],
                                     max_depths=depths).run(checkpoint_dir=ckdir)


def test_pair_bucket_equals_the_reference_and_sequential_runs():
    """(2,1,1,{0,1,2}) with depth caps (5, none, 8): results and per-level
    ledgers equal the reference's BatchedChecker and each member's
    sequential run; the result schema is the reference's, key for key."""
    cfgs = [RaftConfig(2, 1, 1, m) for m in (0, 1, 2)]
    depths = [5, None, 8]
    got = bk.BatchedChecker(cfgs, max_depths=depths, device="cpu", chunk=64).run()
    want = _ref_bucket(cfgs, depths)
    assert _key(got) == _key(want)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert _key(got) == [_seq(c, d) for c, d in zip(cfgs, depths)]
    per_level = bk.BatchedChecker(cfgs, max_depths=depths, device="cpu", chunk=64,
                                  superstep=1).run()
    assert _key(per_level) == _key(want)


def test_windows_wider_than_the_superstep_seat_run_per_level(monkeypatch):
    """A window whose seat would pass SS_MAX_CHUNKS chunks runs per-level
    fused programs (a superstep level runs every chunk of its seat): with
    the limit at one chunk of 64, (3,1,1,{0,1}) mixes both routes and its
    answers stay the sequential runs'."""
    monkeypatch.setattr(bk, "SS_MAX_CHUNKS", 1)
    cfgs = [RaftConfig(3, 1, 1, m) for m in (0, 1)]
    bc = bk.BatchedChecker(cfgs, device="cpu", chunk=64)
    got = bc.run()
    st = bc.stats
    assert st["supersteps"] > 0 and 0 < st["superstep_levels"] < st["levels"]
    assert _key(got) == [_seq(c) for c in cfgs]


# the reference's BatchedChecker on these two buckets, pinned (the slow rows
# below rerun it): per member (ok, distinct, generated, depth, violation);
# an invariant violation (~RaftCanCommt) and the split-brain abort
CAN_COMMIT_BUCKET = [(False, 78, 181, 9, "Invariant ~RaftCanCommt is violated"),
                     (False, 128, 291, 9, "Invariant ~RaftCanCommt is violated")]
DOUBLE_VOTE_BUCKET = [(False, 359, 707, 8, 'Assert "split brain" (Raft.tla:185)'),
                      (False, 494, 950, 8, 'Assert "split brain" (Raft.tla:185)')]
VIOLATION_BUCKETS = {"can-commit": CAN_COMMIT_BUCKET, "double-vote": DOUBLE_VOTE_BUCKET}


def _violation_cfgs(kind):
    if kind == "can-commit":  # an invariant violation: ~RaftCanCommt (3,1,1,{0,1})
        return [RaftConfig(3, 1, 1, m, invariants=("~RaftCanCommt",)) for m in (0, 1)]
    return [RaftConfig(3, 1, 2, m, mutations=(kind,)) for m in (0, 1)]


def _brief(rows):
    return [(r["ok"], r["distinct"], r["generated"], r["depth"], r["violation"]) for r in rows]


@pytest.mark.parametrize("mut", sorted(VIOLATION_BUCKETS))
def test_violation_buckets_equal_pinned_reference_and_sequential(mut):
    """(3,1,1,{0,1}) with ~RaftCanCommt (an invariant violation per member)
    and (3,1,2,{0,1}) under double-vote (the split-brain abort): each member stops where its
    sequential run stops, with the same counts and violation string, and
    where the reference's bucket stopped (pinned; the slow sibling
    test_violation_buckets_equal_the_reference reruns it)."""
    cfgs = _violation_cfgs(mut)
    want = [_seq(c) for c in cfgs]
    for kw in (dict(), dict(superstep=1)):  # supersteps; per-level fused levels
        got = bk.BatchedChecker(cfgs, device="cpu", chunk=64, **kw).run()
        assert _brief(got) == VIOLATION_BUCKETS[mut]
        assert _key(got) == want


@pytest.mark.slow
@pytest.mark.parametrize("mut", sorted(VIOLATION_BUCKETS))
def test_violation_buckets_equal_the_reference(mut):
    """The pinned rows above, from a rerun of the reference's bucket (slow:
    its jit at S = 3; the fast sibling is
    test_violation_buckets_equal_pinned_reference_and_sequential)."""
    cfgs = _violation_cfgs(mut)
    want = _ref_bucket(cfgs)
    assert _brief(want) == VIOLATION_BUCKETS[mut]
    assert _key(bk.BatchedChecker(cfgs, device="cpu", chunk=64).run()) == _key(want)


@pytest.fixture(scope="module")
def s2_bucket():
    """(2,1,1,{0,1,2}) and the port's uninterrupted bucket answers."""
    cfgs = [RaftConfig(2, 1, 1, m) for m in (0, 1, 2)]
    return cfgs, _key(bk.BatchedChecker(cfgs, device="cpu", chunk=64).run())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bstate_resumes_in_the_other_package(tmp_path, s2_bucket, writer):
    """A bucket stopped by a failed bstate commit at level 4 (renamed, not
    manifested) resumes in the other package to the uninterrupted answers."""
    cfgs, want = s2_bucket
    d = str(tmp_path / "b")
    if writer == "jax":
        ref_faults.install("bstate.commit:fail@4")
        try:
            with pytest.raises(ref_faults.FaultError):
                _ref_bucket(cfgs, ckdir=d)
        finally:
            ref_faults.install("")
        assert glob.glob(os.path.join(d, "bstate_*.npz"))
        got = bk.BatchedChecker(cfgs, device="cpu", chunk=64).run(checkpoint_dir=d)
    else:
        faults.install("bstate.commit:fail@4")
        try:
            with pytest.raises(faults.FaultError):
                bk.BatchedChecker(cfgs, device="cpu", chunk=64, superstep=1).run(checkpoint_dir=d)
        finally:
            faults.reset()
        assert glob.glob(os.path.join(d, "bstate_0004.npz"))
        got = _ref_bucket(cfgs, ckdir=d)
    assert _key(got) == want


# -- the service in subprocesses -----------------------------------------------------


def _service(*args, env=None, check=True):
    e = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    e.update(env or {})
    p = subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.service", *args], cwd=REPO,
                       env=e, capture_output=True, text=True)
    if check:
        assert p.returncode == 0, (p.returncode, p.stdout, p.stderr[-3000:])
    return p


S2_SUBMIT = ["--servers", "2", "--vals", "1", "--max-election", "1", "--chunk", "64"]
GOLDEN_S2 = {0: (27, 11), 1: (50, 12), 2: (50, 12)}


def _cli(capsys, *args) -> tuple:
    """The service CLI in process: (exit code, stdout)."""
    from tla_raft_tpu_torch.service.__main__ import main

    capsys.readouterr()
    rc = main(list(args))
    return rc, capsys.readouterr().out


def test_submit_run_results_on_the_cpu(tmp_path, capsys):
    """submit / status / run --once --device cpu (a subprocess) / results
    --json: a 3-member bucket and a depth-capped singleton; the results are
    the sequential runs' and the batched records carry the reference's
    keys; --supervise, --worker and chaos say they are not ported (exit 2)."""
    root = str(tmp_path / "q")
    jids = [json.loads(_cli(capsys, "submit", "--root", root, *S2_SUBMIT, "--max-restart",
                            str(m), "--json")[1])["submitted"][0] for m in (0, 1, 2)]
    solo = _cli(capsys, "submit", "--root", root, "--servers", "2", "--vals", "2",
                "--max-election", "1", "--max-restart", "1", "--max-depth", "4",
                "--chunk", "64")[1].strip()
    assert json.loads(_cli(capsys, "status", "--root", root, "--json")[1])["submitted"] == 4
    assert _cli(capsys, "results", "--root", root, solo, "--json")[0] == 4
    p = _service("run", "--root", root, "--once", "--device", "cpu")
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    assert (stats["buckets"], stats["batched_jobs"], stats["sequential_jobs"]) == (1, 3, 1)
    assert stats["counts"]["done"] == 4
    for jid, m in zip(jids, (0, 1, 2)):
        res = json.loads(_cli(capsys, "results", "--root", root, jid, "--json")[1])
        assert {k: res[k] for k in PARITY} == _seq(RaftConfig(2, 1, 1, m))
        assert res["batched"] is True and res["bucket_configs"] == 3
    res = json.loads(_cli(capsys, "results", "--root", root, solo, "--json")[1])
    want = summary_public(run_check(RaftConfig(2, 2, 1, 1), max_depth=4, chunk=64, device="cpu"))
    assert {k: res[k] for k in PARITY} == {k: want[k] for k in PARITY}
    for cmd in (["chaos", "--base", root], ["run", "--root", root, "--supervise", "2"],
                ["run", "--root", root, "--worker", "w1"]):
        assert _cli(capsys, *cmd)[0] == 2


def test_sigkill_mid_bucket_recovers_and_converges(tmp_path, capsys):
    """tests/test_service.py:297 on the port: SIGKILL at the 4th bstate
    commit; a second pass requeues the stale-leased jobs, resumes the
    bucket from its adopted snapshot and converges (the submits run in
    process, both passes in subprocesses)."""
    root = str(tmp_path / "q")
    for m in (0, 1, 2):
        assert _cli(capsys, "submit", "--root", root, *S2_SUBMIT, "--max-restart", str(m))[0] == 0
    p = _service("run", "--root", root, "--once", "--device", "cpu",
                 env={"TLA_RAFT_FAULT": "bstate.commit:kill@4"}, check=False)
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])
    q = JobQueue(root, lease_ttl=0.0)
    assert q.counts()["running"] == 3
    assert len(os.listdir(os.path.join(root, "buckets"))) == 1
    p = _service("run", "--root", root, "--once", "--lease-ttl", "0.1", "--device", "cpu")
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    assert stats["recovered"] == 3
    assert stats["counts"] == dict(submitted=0, running=0, done=3, failed=0)
    for jid in q.list_jobs():
        res = q.load_result(jid)
        assert res["ok"] is True
        assert (res["distinct"], res["depth"]) == GOLDEN_S2[q.job_cfg(jid).max_restart]


def test_sigkill_mid_sequential_job_resumes(tmp_path, capsys):
    """tests/test_service.py:336 on the port: a singleton job killed at its
    5th delta commit resumes from its per-job delta log (the submit runs in
    process, both passes in subprocesses)."""
    root = str(tmp_path / "q")
    assert _cli(capsys, "submit", "--root", root, *S2_SUBMIT, "--max-restart", "1")[0] == 0
    p = _service("run", "--root", root, "--once", "--device", "cpu",
                 env={"TLA_RAFT_FAULT": "delta.commit:kill@5"}, check=False)
    assert p.returncode == -signal.SIGKILL
    q = JobQueue(root)
    (jid,) = q.list_jobs()
    assert any(f.startswith("delta_") for f in os.listdir(q.ck_dir(jid)))
    p = _service("run", "--root", root, "--once", "--lease-ttl", "0.1", "--device", "cpu")
    assert "(resuming)" in p.stderr, p.stderr[-2000:]
    res = q.load_result(jid)
    assert res["ok"] is True and (res["distinct"], res["depth"]) == (50, 12)


def test_the_references_queue_is_served_by_the_port(tmp_path):
    """A queue written by the reference's JobQueue (its job schema) drains
    through the port's Scheduler, batched and --no-batch alike, with the
    same per-job answers; the synthetic sweep mix is the reference's."""
    ref_jobs = __import__("queue_synth", fromlist=["synth_jobs"]).synth_jobs(12, 1, 3, 64)
    jobs = synth_jobs(12, seed=1, mr_width=3, chunk=64)
    assert [(cfg_to_doc(c), d, o) for c, d, o in jobs] == [
        (cfg_to_doc(RaftConfig(**dataclasses.asdict(c))), d, o) for c, d, o in ref_jobs]
    out = {}
    for arm in (True, False):
        rq = RefQueue(str(tmp_path / str(arm)))
        jids = [rq.submit(RefConfig(**dataclasses.asdict(c)), max_depth=d, options=o)
                for c, d, o in jobs[:6]]
        stats = Scheduler(JobQueue(str(tmp_path / str(arm))), batch=arm, device="cpu",
                          out=open(os.devnull, "w")).run_once()
        assert stats["jobs_done"] == 6
        out[arm] = [{k: rq.load_result(j)[k] for k in PARITY} for j in jids]
    assert out[True] == out[False]


@pytest.mark.slow
def test_the_service_phases_pinned_counts_are_the_references():
    """chip_smoke.py's SERVICE_REF, the witness its service phase holds
    every job to, from the reference's sequential runs of the same queue
    (slow: 42 JaxChecker runs at S <= 3)."""
    from chip_smoke import SERVICE_REF
    from tla_raft_tpu.engine.bfs import JaxChecker

    jobs = synth_jobs(40, seed=1, mr_width=16, chunk=64) + [
        (RaftConfig(3, 1, 2, m, mutations=("median-bug",)), None, dict(chunk=64)) for m in (0, 1)]
    got = []
    for c, d, _o in jobs:
        r = JaxChecker(RefConfig(**dataclasses.asdict(c)), chunk=64).run(max_depth=d)
        got.append((bool(r.ok), int(r.distinct), int(r.generated), int(r.depth)))
    assert got == SERVICE_REF
