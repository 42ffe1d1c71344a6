"""The sweep scheduler: bucket packing, execution, crash recovery.

The port of ``tla_raft_tpu/service/daemon.py``.  The port has no tuner yet:
the bucket-size floor is the reference's hand-set default (2) or
``--min-bucket``, and no plan is installed around a bucket; counts never
depend on either.  Jobs the port cannot run (another backend, a mesh, an
external store) fail with the reason recorded.

One scheduler pass (:meth:`Scheduler.run_once`):

1. **Recover** — requeue every running job whose worker lease went
   stale (a SIGKILL'd worker's jobs come back; their checkpoint dirs
   are intact so the retry resumes, not restarts).
2. **Pack** — group the pending jobs by shape bucket
   (:func:`bucket.bucket_key`); buckets are executed largest-first so
   the device stream carries as many configs per launch as the queue
   allows (the packing that amortizes the per-launch cost and the
   program captures).
3. **Execute** — a bucket of >= ``min_bucket`` batchable jobs runs
   through :class:`bucket.BatchedChecker` (one dispatch stream, bucket
   bstate checkpoint under ``root/buckets/<fp>/``); everything else
   (mesh jobs, oracle jobs, singletons) runs sequentially through
   :func:`check.run_check` with its per-job delta-log checkpoint dir.

Degradation ladder: batched bucket -> on an
unexpected batched-core error, per-job sequential fallback -> on a
sequential error, the job fails with the error recorded.  Preemption
(SIGTERM) finishes the in-flight bucket level / job, releases
unstarted claims and exits 75, exactly like ``check.py``.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import time

from .. import resilience
from ..check import run_check, summary_public, trace_doc
from ..obs import metrics as obs_metrics
from .bucket import BatchedChecker, bucket_key
from .queue import JobQueue, LeaseLost, doc_to_cfg


class _Beater:
    """Background lease renewal while a bucket/job runs.

    Heartbeats every ttl/3 from a timer thread, so a long kernel build
    or level can never age a LIVE worker's lease past the TTL and hand
    its job to a second scheduler mid-run.  This thread is the lease's
    ONLY writer during the run — a per-level callback beating
    concurrently would race two writers onto one tmp path.  Writes files
    only; never launches device work."""

    def __init__(self, q: JobQueue, jids):
        self.q = q
        self.jids = list(jids)
        # jobs whose lease fencing fired mid-run: the claim was lost
        # (worker paused past the TTL, job requeued) — stop renewing,
        # and the terminal commit will re-verify and abandon too.
        # Written by the beater thread, read by the scheduler after
        # join(); the GIL covers the set ops and __exit__ is the
        # happens-before edge
        self.lost: set[str] = set()
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._run, name="lease-beater", daemon=True
        )

    def __enter__(self):
        self._beat()
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(5.0)

    def _beat(self):
        for j in self.jids:
            if j in self.lost:
                continue
            try:
                self.q.heartbeat(j)
            except LeaseLost:
                self.lost.add(j)  # zombie fenced: abandon renewals
            except OSError:
                pass  # lease swept mid-write: staleness logic decides

    def _run(self):
        period = max(0.5, self.q.lease_ttl / 3.0)
        while not self._stop.wait(period):
            self._beat()


def _has_checkpoints(ckdir: str) -> bool:
    import glob

    return bool(
        glob.glob(os.path.join(ckdir, "delta_*.npz"))
        or glob.glob(os.path.join(ckdir, "mdelta_*.npz"))
        or os.path.exists(os.path.join(ckdir, "base.npz"))
    )


class Scheduler:
    """Drains a :class:`JobQueue` onto the local device stream."""

    def __init__(
        self,
        queue: JobQueue,
        batch: bool = True,
        min_bucket: int | None = None,
        out=None,
        use_mxu: bool | None = None,
        registry=None,
        admit_configs: int | None = None,
        admit_bytes: float | None = None,
        device=None,
    ):
        self.q = queue
        self.device = device  # None: the card (raises without CUDA); "cpu"
        self.batch = batch
        # None = the reference's hand-set default of 2 (it would consult
        # its tuned plan cache, which the port does not have); an explicit
        # argument (or --min-bucket) pins one floor for every bucket
        self.min_bucket = (
            max(1, int(min_bucket)) if min_bucket is not None else None
        )
        self.out = out if out is not None else sys.stderr
        self.use_mxu = use_mxu
        # pool membership (service/pool.py): registered/beaten/swept
        # once per pass when the daemon runs as a named pool worker
        self.registry = registry
        # admission control: requeue-later instead of OOM-looping.
        # admit_configs caps how many tenant configs one batched bucket
        # claims per pass (the rest stay pending for this or another
        # worker's next pass); admit_bytes defers tiered jobs whose
        # DECLARED device budget exceeds what this worker can serve
        # (they stay pending for a bigger worker instead of OOM-looping
        # this one into the poison quarantine)
        if admit_configs is None:
            admit_configs = int(
                os.environ.get("TLA_RAFT_ADMIT_CONFIGS", "0")
            )
        if admit_bytes is None:
            admit_bytes = float(
                os.environ.get("TLA_RAFT_ADMIT_BYTES", "0")
            )
        self.admit_configs = max(0, int(admit_configs))
        self.admit_bytes = max(0.0, float(admit_bytes))
        self.stats = dict(
            jobs_done=0, jobs_failed=0, buckets=0, batched_jobs=0,
            sequential_jobs=0, max_bucket=0, dispatches=0, programs=0,
            recovered=0, config_dispatch_weight=0, poisoned=0,
            tiered_jobs=0, fenced=0, deferred=0, traces=0,
        )
        # service metrics registry (obs/metrics.py): snapshots commit
        # atomically to <root>/metrics.json after every scheduler pass
        # — `service status --metrics` and external scrapers read a
        # digest-verified document, never a torn one
        self.metrics = obs_metrics.Metrics()
        self._t0 = time.monotonic()
        self.progress = None  # per-level stats callback (run --progress)

    def _say(self, msg: str) -> None:
        print(f"[service] {msg}", file=self.out)
        self.out.flush()

    # -- packing -------------------------------------------------------

    def _batchable(self, spec: dict) -> bool:
        opt = spec.get("options") or {}
        return (
            opt.get("backend", "jax") == "jax"
            and not opt.get("mesh")
            and not opt.get("fpstore_dir")
            # tiered jobs (a declared device-memory budget) run
            # sequentially: the batched bucket core shares ONE hash
            # slab across tenants, which a per-job hot budget cannot
            # partition — the scheduler still packs them into the same
            # queue, so configs whose visited sets exceed HBM flow
            # through the service like any other job
            and not opt.get("dev_bytes")
        )

    def plan(self, job_ids: list[str]):
        """(buckets, singles): buckets maps a shape key to the job list
        that can ride one compiled program."""
        buckets: dict = {}
        singles: list[tuple[str, dict]] = []
        for jid in job_ids:
            spec = self.q.load_spec(jid)
            if spec is None:
                # unreadable spec (submit died mid-commit / torn file):
                # fail it now — a silently-skipped pending job would
                # keep serve() from ever draining to idle
                self._say(f"job {jid}: unreadable spec — failing")
                self.q.fail_unreadable(jid, "unreadable job spec")
                self.stats["jobs_failed"] += 1
                continue
            opt = spec.get("options") or {}
            if (
                self.admit_bytes
                and opt.get("dev_bytes")
                and float(opt["dev_bytes"]) > self.admit_bytes
            ):
                # admission control: this worker cannot serve the job's
                # declared device budget — leave it pending (requeue-
                # later for a bigger worker) instead of OOM-looping it
                # into the poison quarantine
                self.stats["deferred"] += 1
                continue
            cfg = doc_to_cfg(spec["config"])
            if self.batch and self._batchable(spec):
                buckets.setdefault(bucket_key(cfg), []).append((jid, spec))
            else:
                singles.append((jid, spec))
        # sub-minimum buckets execute sequentially (no amortization to
        # be had); largest buckets first = best packing under a
        # preemption that cuts the pass short
        out = []
        for key, jobs in buckets.items():
            if len(jobs) >= self._min_bucket_for(jobs[0][1]):
                out.append((key, jobs))
            else:
                singles.extend(jobs)
        out.sort(key=lambda kv: -len(kv[1]))
        return out, singles

    def _min_bucket_for(self, spec: dict) -> int:
        """Bucket-size floor: ``--min-bucket`` when given, else 2 (the
        reference's default where its plan cache has no tuned value)."""
        return self.min_bucket if self.min_bucket is not None else 2

    # -- execution -----------------------------------------------------

    def _bucket_ck(self, run_fp_src: str) -> str:
        h = hashlib.blake2b(run_fp_src.encode(), digest_size=8).hexdigest()
        return os.path.join(self.q.root, "buckets", h)

    def _run_bucket(self, key, jobs) -> None:
        if self.admit_configs and len(jobs) > self.admit_configs:
            # bucket-width admission: claim only what fits this
            # worker's budget; the tail stays pending for the next
            # pass (or another pool worker's)
            self.stats["deferred"] += len(jobs) - self.admit_configs
            jobs = jobs[: self.admit_configs]
        claimed = [(j, s) for j, s in jobs if self.q.claim(j)]
        if not claimed:
            return
        jids = [j for j, _ in claimed]
        cfgs = [doc_to_cfg(s["config"]) for _, s in claimed]
        depths = [s.get("max_depth") for _, s in claimed]
        self._say(
            f"bucket {key.describe()}: {len(claimed)} configs "
            f"(MaxRestart {sorted(c.max_restart for c in cfgs)})"
        )
        # the port's bucket expands in chunks: the jobs' sequential-path
        # chunk option sizes it too (counts do not depend on it)
        chunks = [int((s.get("options") or {}).get("chunk") or 0) for _, s in claimed]
        bc = BatchedChecker(
            cfgs, max_depths=depths, use_mxu=self.use_mxu,
            progress=self.progress, device=self.device,
            chunk=min(chunks) if all(chunks) else None,
        )
        bdir = self._bucket_ck(bc._run_fp)
        try:
            with _Beater(self.q, jids):
                summaries = bc.run(checkpoint_dir=bdir)
        except resilience.Preempted:
            for j in jids:
                self.q.release(j, note="preempted mid-bucket")
            raise
        except Exception as e:  # noqa: BLE001 - degradation rung: any batched-core failure falls back to per-job sequential runs
            self._say(
                f"batched bucket failed ({type(e).__name__}: {e}); "
                "degrading to sequential"
            )
            for j, s in claimed:
                self.q.release(j, note="bucket degraded to sequential")
                if self.q.claim(j):
                    self._run_one(j, s)
            return
        for (j, s), summary in zip(claimed, summaries):
            if not summary.get("ok") and summary.get("violation"):
                summary = self._with_trace(j, s, summary)
            try:
                self.q.complete(j, summary)
            except LeaseLost as e:
                # fenced at the terminal commit: the job was requeued
                # while this worker was paused/stalled and may already
                # run under a new owner — abandon, never double-commit
                self._say(f"job {j}: abandoned ({e})")
                continue
            self.stats["jobs_done" if summary["ok"] else "jobs_failed"] += 1
        self.stats["buckets"] += 1
        self.stats["batched_jobs"] += len(claimed)
        self.stats["max_bucket"] = max(
            self.stats["max_bucket"], len(claimed)
        )
        self.stats["dispatches"] += bc.stats["dispatches"]
        # configs-per-dispatch numerator: every device dispatch of this
        # bucket carried len(claimed) tenant configs
        self.stats["config_dispatch_weight"] += (
            len(claimed) * bc.stats["dispatches"]
        )
        # total NEW traces across the queue (per-run deltas: reuse of
        # another bucket's cached programs adds nothing — that reuse is
        # the amortization being measured)
        self.stats["programs"] += bc.stats["programs"]
        # the bucket converged: its snapshots are spent (a later bucket
        # of the same key gets a fresh run_fp-checked record anyway,
        # but leaving them costs disk per drained bucket)
        import glob as _glob

        for p in _glob.glob(os.path.join(bdir, "bstate_*.npz")):
            try:
                os.remove(p)
            except OSError:
                pass

    def _with_trace(self, jid: str, spec: dict, summary: dict) -> dict:
        """Service-side counterexample trace for a violating batched
        member: the bucket core retires the config with the violation
        KIND but spools no per-config trace, so the worker re-runs that
        one config sequentially — it stops at the violation level,
        writing its delta log into the job's ck dir (the same machinery
        ``check.py --recover`` replays) — and commits the reconstructed
        trace into ``result.json``.  Closes ROADMAP item 3's "today:
        re-run the config through check.py" gap on the service side."""
        if str(summary.get("violation") or "").startswith("error:"):
            return summary
        cfg = doc_to_cfg(spec["config"])
        opt = spec.get("options") or {}
        self._say(f"job {jid}: reconstructing counterexample trace")
        try:
            full = run_check(
                cfg,
                max_depth=spec.get("max_depth"),
                chunk=int(opt["chunk"]) if opt.get("chunk") else None,
                checkpoint_dir=self.q.ck_dir(jid),
                use_mxu=self.use_mxu,
                device=self.device,
            )
        except Exception as e:  # noqa: BLE001 - the trace is best-effort enrichment; the verdict commits without it
            self._say(
                f"job {jid}: trace reconstruction failed "
                f"({type(e).__name__}: {e})"
            )
            return summary
        res = full.get("_res")
        if res is not None and res.violation and res.violation[1]:
            self.stats["traces"] += 1
            return dict(
                summary, trace=trace_doc(cfg, res.violation[1])
            )
        return summary

    def _run_one(self, jid: str, spec: dict) -> None:
        cfg = doc_to_cfg(spec["config"])
        opt = spec.get("options") or {}
        ck = self.q.ck_dir(jid)
        recover = ck if _has_checkpoints(ck) else None
        self._say(
            f"job {jid}: sequential {cfg.describe()}"
            + (" (resuming)" if recover else "")
        )
        try:
            with _Beater(self.q, [jid]):
                unported = [k for k in ("mesh", "fpstore_dir", "mesh_deep") if opt.get(k)]
                if opt.get("backend", "jax") != "jax" or unported:
                    raise ValueError(
                        f"job options {unported or [opt.get('backend')]} are not in the port")
                summary = run_check(
                    cfg,
                    max_depth=spec.get("max_depth"),
                    chunk=int(opt["chunk"]) if opt.get("chunk") else None,
                    checkpoint_dir=ck,
                    recover=recover,
                    use_mxu=self.use_mxu,
                    dev_bytes=(
                        int(opt["dev_bytes"])
                        if opt.get("dev_bytes") else None
                    ),
                    device=self.device,
                )
        except resilience.Preempted:
            self.q.release(jid, note="preempted mid-job")
            raise
        except Exception as e:  # noqa: BLE001 - last ladder rung: the job fails with the error recorded, the queue keeps draining
            self._say(f"job {jid} errored: {type(e).__name__}: {e}")
            try:
                self.q.complete(
                    jid,
                    dict(
                        ok=False, distinct=0, generated=0, depth=0,
                        level_sizes=[], mxu=None, seconds=None,
                        violation=f"error: {type(e).__name__}: {e}",
                    ),
                )
            except LeaseLost as le:
                self._say(f"job {jid}: abandoned ({le})")
                return
            self.stats["jobs_failed"] += 1
            return
        pub = summary_public(summary)
        res = summary.get("_res")
        if res is not None and res.violation and res.violation[1]:
            # sequential jobs carry the live trace already — serialize
            # it straight into result.json (no re-run needed)
            pub["trace"] = trace_doc(cfg, res.violation[1])
            self.stats["traces"] += 1
        try:
            self.q.complete(jid, pub)
        except LeaseLost as e:
            self._say(f"job {jid}: abandoned ({e})")
            return
        self.stats["sequential_jobs"] += 1
        if opt.get("dev_bytes"):
            self.stats["tiered_jobs"] += 1
        self.stats["jobs_done" if summary["ok"] else "jobs_failed"] += 1

    # -- metrics -------------------------------------------------------

    def _commit_metrics(self) -> None:
        """Fold the pass's stats into the registry and commit the
        snapshot atomically (one fresh scan: the pass just mutated the
        queue, so the pre-pass ``states`` map is stale by now)."""
        m = self.metrics
        by: dict[str, int] = {}
        ages: list[float] = []
        for jid, st in self.q.scan().items():
            by[st["status"]] = by.get(st["status"], 0) + 1
            if st["status"] == "running":
                age = self.q.lease_age(jid)
                if age is not None:
                    ages.append(age)
        for s in ("submitted", "running", "done", "failed"):
            m.gauge(f"queue_{s}").set(by.get(s, 0))
        m.gauge("queue_depth").set(by.get("submitted", 0))
        m.gauge("lease_age_max_s").set(round(max(ages), 3) if ages
                                       else 0.0)
        hours = max(time.monotonic() - self._t0, 1e-9) / 3600.0
        m.gauge("jobs_per_hour").set(
            round(self.stats["jobs_done"] / hours, 2)
        )
        # fencing abandons: the queue's counter is authoritative (the
        # beater thread fences heartbeats there too, not just the
        # scheduler's terminal commits)
        self.stats["fenced"] = self.q.fenced
        for k in ("jobs_done", "jobs_failed", "poisoned", "buckets",
                  "batched_jobs", "sequential_jobs", "dispatches",
                  "programs", "recovered", "tiered_jobs", "fenced",
                  "deferred", "traces"):
            m.counter(k).set(self.stats[k])
        if self.registry is not None:
            wc = self.registry.counts()
            for s in ("active", "draining", "dead"):
                m.gauge(f"workers_{s}").set(wc.get(s, 0))
        try:
            m.commit(self.q.root)
        except OSError as e:
            # metrics are observability, not correctness: a full disk
            # must not take the scheduler down
            self._say(f"metrics commit failed: {e}")

    # -- passes --------------------------------------------------------

    def run_once(self) -> dict:
        """One scheduler pass: recover, pack, drain what was pending.
        One queue scan feeds the whole pass (recover + pending +
        packing) — each helper re-scanning would re-digest every
        state.json several times per poll."""
        if self.registry is not None:
            # pool membership liveness: bump this worker's heartbeat
            # serial and mark peers whose process died without
            # deregistering (their JOBS come back via requeue_stale
            # below — the roster sweep is bookkeeping, not recovery)
            self.registry.beat()
            swept = self.registry.sweep()
            if swept:
                self._say(f"marked dead worker(s): {swept}")
        states = self.q.scan()
        recovered = self.q.requeue_stale(states)
        if recovered:
            self.stats["recovered"] += len(recovered)
            self._say(f"requeued {len(recovered)} stale job(s): "
                      f"{recovered}")
        poisoned = getattr(self.q, "poisoned_last", [])
        if poisoned:
            # poison-job quarantine: these workers' deaths exhausted the
            # retry budget — failed with the accumulated failure log and
            # moved to failed/, so the queue drains instead of looping
            self.stats["poisoned"] += len(poisoned)
            self.stats["jobs_failed"] += len(poisoned)
            self._say(
                f"poisoned {len(poisoned)} job(s) (worker died >= "
                f"{self.q.max_attempts}x; moved to failed/): {poisoned}"
            )
        pending = self.q.pending(states)
        buckets, singles = self.plan(pending)
        try:
            for key, jobs in buckets:
                if resilience.preempt_requested():
                    raise resilience.Preempted(None, 0)
                self._run_bucket(key, jobs)
            for jid, spec in singles:
                if resilience.preempt_requested():
                    raise resilience.Preempted(None, 0)
                if self.q.claim(jid):
                    self._run_one(jid, spec)
        finally:
            # commit metrics even on a preempted pass: the snapshot a
            # scraper reads should reflect the work actually done
            self._commit_metrics()
        return dict(self.stats)

    def serve(self, poll: float = 2.0, max_idle: float | None = None):
        """Poll the queue until preempted (or idle past ``max_idle``).

        Every pass ends in ``sleep(poll)`` — even when jobs stay
        pending (claims held by another live worker): re-passing
        without the sleep would spin the scheduler at 100% CPU against
        a queue it cannot drain."""
        idle_since = None
        while True:
            self.run_once()
            if self.q.pending():
                idle_since = None
            else:
                if idle_since is None:
                    idle_since = time.monotonic()
                if (
                    max_idle is not None
                    and time.monotonic() - idle_since > max_idle
                ):
                    return dict(self.stats)
            if resilience.preempt_requested():
                raise resilience.Preempted(None, 0)
            time.sleep(poll)
