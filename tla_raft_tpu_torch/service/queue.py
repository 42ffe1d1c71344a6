"""Directory-backed job queue: crash-safe state machine for sweep jobs.

The port's copy of ``tla_raft_tpu/service/queue.py``: the records, their
schema and the layout are the reference's byte for byte, so a queue
directory written by either package is served by the other.

Layout (``root`` is the queue directory, one subdir per job):

    root/jobs/<job_id>/
        job.json      the immutable job spec (config constants +
                      run options), committed once at submit
        state.json    the current state-machine record
                      {status, attempt, worker, note}; every
                      transition is a fresh atomic commit
        lease.json    the claiming worker's lease (pid + heartbeat
                      serial); REWRITTEN on every heartbeat, atomic
                      but unmanifested (loss is benign — a missing
                      lease just reads as stale)
        ck/           the per-job checkpoint directory: sequential
                      jobs write the engine delta log here, batched
                      buckets the bstate snapshot — either way a
                      SIGKILL'd worker's job RESUMES from it
        result.json   the final summary (check.py --json schema),
                      committed exactly once

State machine::

    submitted --claim--> running --complete--> done | failed
        ^                   |
        +---requeue (stale lease / preemption / crash,
        |            attempt < max_attempts)-------------+
        +---poison  (stale lease, attempt >= max_attempts):
                     failed, job dir moved to root/failed/

**Poison-job quarantine**: a job whose worker dies ``max_attempts``
times (default 3) is not requeued forever — the stale-lease sweep
fails it with the accumulated per-attempt failure log (worker, note,
timestamp, carried in ``state.json`` across requeues), commits a
``result.json`` recording the poisoning, and moves the whole job
directory to ``root/failed/``, out of the scheduler's pending scan.
Status/result reads follow it there.

Every JSON record commits through ``resilience.commit_json`` (the
atomic tmp -> digest -> rename -> MANIFEST.json writer), so a kill at any byte boundary leaves either the old record or
the new one, never a torn file; readers go through
``load_json_verified`` and treat corrupt records as absent.  Claims
are mutually exclusive via O_CREAT|O_EXCL lease creation; a worker
that dies holds its claim only until the lease goes stale
(``lease_ttl`` seconds without a heartbeat), after which any scheduler
pass requeues the job — attempt count incremented, checkpoint dir
intact, so the retry resumes instead of restarting.

**Lease fencing** (the zombie-worker defence): every claim mints a
fencing token (worker name + a per-claim serial) written into the
lease record, and every transition that touches a claimed job —
heartbeat, ``complete``, ``release`` — re-parses the on-disk lease and
verifies it still carries THIS worker's (name, token) before writing
anything.  A worker paused past the TTL (SIGSTOP, GC stall, swap
storm) wakes up believing it owns its jobs; by then the staleness
sweep has requeued them and another worker's claim minted a new token,
so the zombie's next heartbeat or terminal commit raises
:class:`LeaseLost` and the worker ABANDONS the job instead of
double-committing over the new owner's work.  Mtime alone cannot give
this guarantee — a fresh mtime only proves *somebody* beat recently.
The residual verify-then-commit window (ownership lost between the
re-check and the rename) can at worst duplicate an identical,
deterministic result commit, never lose or corrupt one — the same
"duplicate work, never a wrong verdict" contract ``complete`` always
had.  Abandons are counted in ``JobQueue.fenced`` for the scheduler's
metrics and the chaos gate.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import threading
import time
import uuid

from .. import resilience
from ..config import RaftConfig

JOB = "job.json"
STATE = "state.json"
LEASE = "lease.json"
RESULT = "result.json"
CKDIR = "ck"

# one schema version for all queue records
QUEUE_SCHEMA = 1

# job spec fields that map 1:1 onto RaftConfig constants
_CFG_FIELDS = (
    "n_servers", "n_vals", "max_election", "max_restart",
    "symmetry", "use_view", "invariants", "mutations",
)

STATUSES = ("submitted", "running", "done", "failed")


def cfg_to_doc(cfg: RaftConfig) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in d.items() if k in _CFG_FIELDS}


def doc_to_cfg(doc: dict) -> RaftConfig:
    kw = {k: doc[k] for k in _CFG_FIELDS if k in doc}
    for k in ("invariants", "mutations"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return RaftConfig(**kw)


FAILED_DIR = "failed"


class LeaseLost(RuntimeError):
    """This worker's lease no longer names it: the job was requeued
    (TTL aged out while the worker was paused/hung) and possibly
    reclaimed by another worker.  The only safe move is to abandon the
    transition — the current lease holder's commit is the one that
    counts."""

    def __init__(self, job_id: str, holder=None):
        self.job_id = job_id
        self.holder = holder  # the lease doc found on disk (or None)
        who = (
            f"now held by {holder.get('worker')!r}"
            if isinstance(holder, dict) else "lease gone"
        )
        super().__init__(f"lease lost for job {job_id} ({who})")


class JobQueue:
    """The queue API both the client CLI and the daemon go through."""

    def __init__(self, root: str, worker: str | None = None,
                 lease_ttl: float = 30.0, max_attempts: int = 3):
        self.root = root
        self.jobs_dir = os.path.join(root, "jobs")
        self.failed_dir = os.path.join(root, FAILED_DIR)
        self.worker = worker or f"w{os.getpid()}"
        self.lease_ttl = float(lease_ttl)
        # poison-job retry budget: a job whose worker dies this many
        # times moves to failed/ instead of requeueing forever
        self.max_attempts = max(1, int(max_attempts))
        # fencing state: job_id -> the token this instance's claim
        # minted; `fenced` counts transitions abandoned because the
        # on-disk lease no longer carried (worker, token).  The lock
        # covers the counter: heartbeats fence from the daemon's
        # lease-beater thread while complete/release fence from the
        # main thread
        self._tokens: dict[str, str] = {}
        self._fence_lock = threading.Lock()
        self.fenced = 0

    # -- paths ---------------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        jd = os.path.join(self.jobs_dir, job_id)
        if not os.path.isdir(jd):
            # poisoned jobs move wholesale to failed/; status and
            # result reads follow them there
            fd = os.path.join(self.failed_dir, job_id)
            if os.path.isdir(fd):
                return fd
        return jd

    def ck_dir(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), CKDIR)

    # -- submit --------------------------------------------------------

    def submit(self, cfg: RaftConfig, *, max_depth: int | None = None,
               options: dict | None = None,
               job_id: str | None = None) -> str:
        """Create a job; returns its id.  The spec commits first, the
        state record second — a crash between the two leaves a spec
        with no state, which ``scan`` reads as submitted (the state
        record is re-derivable; the spec is not)."""
        job_id = job_id or uuid.uuid4().hex[:12]
        jd = self.job_dir(job_id)
        if os.path.exists(os.path.join(jd, JOB)):
            raise FileExistsError(f"job {job_id} already exists")
        spec = dict(
            schema=QUEUE_SCHEMA,
            job_id=job_id,
            config=cfg_to_doc(cfg),
            max_depth=max_depth,
            options=dict(options or {}),
        )
        resilience.commit_json(jd, JOB, spec, kind="job")
        self._set_state(job_id, "submitted", attempt=0)
        return job_id

    # -- reads ---------------------------------------------------------

    def load_spec(self, job_id: str) -> dict | None:
        return resilience.load_json_verified(self.job_dir(job_id), JOB)

    def load_state(self, job_id: str) -> dict:
        jd = self.job_dir(job_id)
        if not os.path.isdir(jd):
            # distinguish "never existed" from the submit crash window
            # below: a typo'd id must error, not read as a live
            # pending job that tooling then polls forever
            raise FileNotFoundError(f"no such job: {job_id}")
        st = resilience.load_json_verified(jd, STATE)
        if st is None:
            # spec-without-state (crash inside submit, or torn record):
            # the job exists, so it is submitted
            return dict(status="submitted", attempt=0, worker=None)
        return st

    def load_result(self, job_id: str) -> dict | None:
        return resilience.load_json_verified(self.job_dir(job_id), RESULT)

    def list_jobs(self) -> list[str]:
        out = set()
        for base in (self.jobs_dir, self.failed_dir):
            try:
                out.update(
                    d for d in os.listdir(base)
                    if os.path.isdir(os.path.join(base, d))
                )
            except FileNotFoundError:
                pass
        return sorted(out)

    def job_cfg(self, job_id: str) -> RaftConfig | None:
        spec = self.load_spec(job_id)
        return doc_to_cfg(spec["config"]) if spec else None

    # -- state machine -------------------------------------------------

    def _set_state(self, job_id: str, status: str, *, attempt: int,
                   worker: str | None = None, note: str | None = None,
                   failures: list | None = None):
        assert status in STATUSES, status
        doc = dict(schema=QUEUE_SCHEMA, status=status, attempt=int(attempt),
                   worker=worker, note=note)
        if failures:
            # the accumulated per-attempt failure log (requeue reasons);
            # rides every later transition so the poison record carries
            # the job's whole failure history
            doc["failures"] = list(failures)
        resilience.commit_json(
            self.job_dir(job_id), STATE, doc,
            kind="jobstate",
        )

    def _lease_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), LEASE)

    def lease_age(self, job_id: str) -> float | None:
        """Seconds since the lease's last heartbeat; None = no lease."""
        try:
            return time.time() - os.stat(self._lease_path(job_id)).st_mtime
        except OSError:
            return None

    def claim(self, job_id: str) -> bool:
        """Exclusive claim via O_EXCL lease creation.  False = someone
        else holds a live lease (or won the race)."""
        st = self.load_state(job_id)
        if st["status"] not in ("submitted",):
            return False
        path = self._lease_path(job_id)
        age = self.lease_age(job_id)
        if (
            age is not None and age <= self.lease_ttl
            and not self._lease_dead(job_id)
        ):
            return False
        if age is not None:
            # stale takeover must be rename-then-create: the rename of
            # the stale inode has exactly ONE winner, so a racing
            # claimant can never unlink a FRESH lease another worker
            # just created between our staleness check and our sweep
            # (the unlink-based sweep's TOCTOU)
            stale = path + f".stale-{uuid.uuid4().hex[:8]}"
            try:
                os.rename(path, stale)
            except OSError:
                return False  # another worker swept or replaced it
            try:
                os.unlink(stale)
            except OSError:
                pass
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError as e:
            if e.errno == errno.EEXIST:
                return False
            raise
        token = uuid.uuid4().hex[:16]
        with os.fdopen(fd, "w") as fh:
            # real JSON (escaped worker name): _lease_dead parses this;
            # a kill mid-write leaves an unparsable lease, which reads
            # as pid-unknown and falls back to the TTL — still safe
            json.dump(
                dict(worker=self.worker, pid=os.getpid(), beats=0,
                     token=token),
                fh,
            )
            fh.write("\n")
        self._tokens[job_id] = token
        self._set_state(
            job_id, "running", attempt=int(st.get("attempt", 0)) + 1,
            worker=self.worker, failures=st.get("failures"),
        )
        return True

    def lease_holder(self, job_id: str) -> dict | None:
        """The lease record on disk, or None (absent/torn)."""
        try:
            with open(self._lease_path(job_id), encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def verify_owned(self, job_id: str, what: str = "transition") -> str:
        """Fencing check: the on-disk lease must still carry THIS
        worker's (name, token).  Returns the token; raises
        :class:`LeaseLost` (and counts the abandon in ``fenced``)
        when the claim was lost — requeued after a pause past the TTL,
        swept, or reclaimed by another worker."""
        tok = self._tokens.get(job_id)
        doc = self.lease_holder(job_id)
        if (
            tok is None
            or doc is None
            or doc.get("worker") != self.worker
            or doc.get("token") != tok
        ):
            self._tokens.pop(job_id, None)
            with self._fence_lock:
                self.fenced += 1
            raise LeaseLost(job_id, doc)
        return tok

    def heartbeat(self, job_id: str, beats: int = 0) -> None:
        """Refresh the lease mtime (atomic rewrite, unmanifested).

        Fenced: the rewrite happens only after :meth:`verify_owned`
        proves the on-disk lease still names this worker's claim — a
        zombie's heartbeat must not resurrect a lease another worker
        now owns (the rewrite is a rename, not O_EXCL, so without the
        check it would clobber the new owner's record).

        Retried with exponential backoff + jitter: a transient FS
        error (NFS brownout, ENOSPC blip) on one heartbeat must not
        age a HEALTHY worker's lease past the TTL and hand its job to
        a second scheduler.  The write is idempotent (same lease doc),
        so the retry is safe; jitter decorrelates a fleet of workers
        all beating against the same brownout."""
        from ..resilience import faults

        faults.fire("lease.renew")
        token = self.verify_owned(job_id, "heartbeat")
        resilience.with_retry(
            lambda: resilience.commit_json(
                self.job_dir(job_id), LEASE,
                dict(worker=self.worker, pid=os.getpid(),
                     beats=int(beats), token=token),
                kind="lease", manifest=False,
            ),
            f"lease renewal ({job_id})",
            attempts=3, base_delay=0.05, jitter=True,
        )

    def _lease_dead(self, job_id: str) -> bool:
        """True when the lease's recorded pid no longer exists on this
        host — a crashed worker's claim is released IMMEDIATELY instead
        of waiting out the TTL (a HUNG worker, pid alive, still ages
        out via the TTL; cross-host leases carry no local pid and fall
        back to the TTL too)."""
        try:
            with open(self._lease_path(job_id), encoding="utf-8") as fh:
                pid = json.load(fh).get("pid")
        except (OSError, ValueError):
            return False  # torn heartbeat: age decides
        if not isinstance(pid, int):
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:
            return False
        return False

    def complete(self, job_id: str, summary: dict) -> None:
        """Commit the result, flip the state, release the lease —
        in that order, so a crash can duplicate work but never lose a
        committed verdict.  Fenced: ownership is re-verified BEFORE
        the result commit, so a zombie worker (paused past the TTL,
        its job requeued and reclaimed) abandons with
        :class:`LeaseLost` instead of double-committing."""
        self.verify_owned(job_id, "complete")
        st = self.load_state(job_id)
        resilience.commit_json(
            self.job_dir(job_id), RESULT,
            dict(schema=QUEUE_SCHEMA, **summary),
            kind="result",
        )
        self._set_state(
            job_id, "done" if summary.get("ok") else "failed",
            attempt=int(st.get("attempt", 0)), worker=self.worker,
            note=summary.get("violation"), failures=st.get("failures"),
        )
        self._tokens.pop(job_id, None)
        try:
            os.unlink(self._lease_path(job_id))
        except OSError:
            pass

    def release(self, job_id: str, note: str | None = None) -> None:
        """Return a claimed job to the queue (preemption / shutdown).

        Fenced, but ABANDON-quietly rather than raise: a release after
        the lease was lost means the job is already back in the queue
        (or running under its new owner) — unlinking the lease or
        resetting the state here would sabotage the new claim, and the
        caller is shutting down anyway."""
        try:
            self.verify_owned(job_id, "release")
        except LeaseLost:
            return
        st = self.load_state(job_id)
        self._set_state(
            job_id, "submitted", attempt=int(st.get("attempt", 0)),
            note=note, failures=st.get("failures"),
        )
        self._tokens.pop(job_id, None)
        try:
            os.unlink(self._lease_path(job_id))
        except OSError:
            pass

    def fail_unreadable(self, job_id: str, note: str) -> None:
        """Surface a job whose spec cannot be read (a submit that died
        inside the job.json commit window, or a torn spec) as FAILED —
        otherwise it would sit pending forever and the scheduler could
        never drain the queue to idle."""
        st = self.load_state(job_id)
        self._set_state(
            job_id, "failed", attempt=int(st.get("attempt", 0)),
            note=note,
        )

    def scan(self) -> dict:
        """{job_id: state} in one pass — the per-pass digest-verified
        read each caller shares, instead of every helper re-walking
        and re-hashing the whole queue (at 1k jobs an idle poll was
        3-4 full scans per pass)."""
        return {jid: self.load_state(jid) for jid in self.list_jobs()}

    def requeue_stale(self, states: dict | None = None) -> list[str]:
        """Requeue every running job whose lease is stale or missing —
        the crash-recovery sweep each scheduler pass runs first.  The
        job's checkpoint dir is left intact: the retry RESUMES.

        A job whose worker has now died ``max_attempts`` times is
        POISONED instead (``_poison``): failed with the accumulated
        failure log and moved to ``root/failed/`` — a config that
        reliably kills its worker (OOM, a crashing kernel) must not
        starve the queue by being requeued forever.  Poisoned ids land
        in ``self.poisoned_last`` for the scheduler's stats.

        Mutates ``states`` (when given) to reflect the transitions."""
        out = []
        self.poisoned_last: list[str] = []
        states = self.scan() if states is None else states
        for jid, st in states.items():
            if st["status"] != "running":
                continue
            age = self.lease_age(jid)
            if age is None or age > self.lease_ttl or self._lease_dead(jid):
                attempt = int(st.get("attempt", 0))
                failures = list(st.get("failures") or [])
                failures.append(dict(
                    attempt=attempt,
                    worker=st.get("worker"),
                    note="worker died (stale/dead lease)",
                    time=time.time(),
                ))
                try:
                    os.unlink(self._lease_path(jid))
                except OSError:
                    pass
                if attempt >= self.max_attempts:
                    self._poison(jid, attempt, failures)
                    states[jid] = dict(st, status="failed")
                    self.poisoned_last.append(jid)
                    continue
                self._set_state(
                    jid, "submitted", attempt=attempt,
                    note=f"requeued (stale lease, worker "
                         f"{st.get('worker')})",
                    failures=failures,
                )
                states[jid] = dict(st, status="submitted")
                out.append(jid)
        return out

    def _poison(self, job_id: str, attempt: int, failures: list) -> None:
        """Quarantine a job that kills its workers: fail it with the
        accumulated failure log, commit a result record, and move the
        whole job directory to ``root/failed/`` (same-filesystem
        rename — atomic), out of the pending scan."""
        note = (
            f"poisoned: worker died {attempt} time(s) "
            f"(retry budget {self.max_attempts})"
        )
        self._set_state(
            job_id, "failed", attempt=attempt, note=note,
            failures=failures,
        )
        resilience.commit_json(
            self.job_dir(job_id), RESULT,
            dict(
                schema=QUEUE_SCHEMA, ok=False, distinct=0, generated=0,
                depth=0, level_sizes=[], mxu=None, seconds=None,
                violation=note, failures=failures,
            ),
            kind="result",
        )
        src = os.path.join(self.jobs_dir, job_id)
        dst = os.path.join(self.failed_dir, job_id)
        if os.path.isdir(src):
            os.makedirs(self.failed_dir, exist_ok=True)
            try:
                # whole-directory quarantine move (jobs/ -> failed/),
                # not a checkpoint commit; the records inside were all
                # committed atomically already
                os.replace(src, dst)
            except OSError:
                pass  # cross-device or racing sweep: failed-in-place
                # still drains (status is terminal either way)

    def pending(self, states: dict | None = None) -> list[str]:
        """Jobs ready to claim (after the stale-lease sweep)."""
        states = self.scan() if states is None else states
        return [
            jid for jid, st in states.items()
            if st["status"] == "submitted"
        ]

    def counts(self) -> dict:
        c = dict.fromkeys(STATUSES, 0)
        for jid in self.list_jobs():
            c[self.load_state(jid)["status"]] += 1
        return c
