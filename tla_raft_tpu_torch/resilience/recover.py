"""Self-healing resume: tmp sweeping, quarantine, prefix truncation (the
port's copy of ``tla_raft_tpu/resilience/recover.py``; the mesh's
``mdelta`` logs it also heals come with the port's mesh).

The delta/mdelta logs are strictly append-only chains written by a
single ordered writer, so after any crash the directory can only be in
one of a few shapes, each with one right answer:

* **orphaned ``.tmp_*`` files** — a writer died between the payload
  write and the rename.  Swept unconditionally: a tmp file is by
  definition uncommitted (and a leaked one would shadow names and leak
  disk; a ``glob`` that picked one up would poison record ordering).
* **a corrupt/torn record** (digest mismatch, unreadable zip) —
  quarantined into ``<ckdir>/quarantine/`` and the chain truncated to
  the last good contiguous prefix; the resumed run simply re-expands
  the lost levels.
* **an unmanifested record** (renamed but the crash beat the manifest
  commit — or a pre-manifest record in a partially-manifested legacy
  directory): the rename is atomic and the zip CRCs prove the bytes,
  so a structurally-verified record is **adopted** into the ledger;
  only an unreadable one quarantines.
* **an interior hole** — a record depth missing from disk entirely
  while deeper records exist.  The ordered writer cannot produce this;
  it means tampering or mixed directories, so it stays FATAL.

``heal_log`` implements that policy for both engines; the side slabs
(``hslab.npz``, ``sieve_slab.npz``) are pure resume accelerators, so a
bad one is quarantined and the existing rebuild-from-log paths take
over.  Also here: bounded retry-with-backoff for transient failures
and the cooperative SIGTERM/SIGINT preemption flag the level loops
poll (flush-and-exit-resumable instead of dying mid-level).
"""

from __future__ import annotations

import glob
import os
import sys
import time

from . import faults
from .manifest import (
    Manifest,
    TMP_PREFIX,
    npz_readable,
    artifact_depth,
    digest_file,
)

QUARANTINE_DIR = "quarantine"


def _note(msg: str):
    print(f"[resilience] {msg}", file=sys.stderr)


def sweep_tmp(ckdir: str) -> list[str]:
    """Remove orphaned ``.tmp_*`` files (crashed writers' leftovers)."""
    swept = []
    for f in sorted(glob.glob(os.path.join(ckdir, TMP_PREFIX + "*"))):
        if os.path.isfile(f):
            os.unlink(f)
            swept.append(os.path.basename(f))
    if swept:
        _note(f"swept {len(swept)} orphaned tmp file(s) in {ckdir}: "
              + ", ".join(swept))
    return swept


def quarantine(ckdir: str, name: str, reason: str,
               m: Manifest | None = None) -> None:
    """Move a bad artifact aside (never delete: post-mortem evidence)."""
    src = os.path.join(ckdir, name)
    qdir = os.path.join(ckdir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, name)
    if os.path.exists(src):
        os.replace(src, dst)
    _note(f"quarantined {name} ({reason}) -> {QUARANTINE_DIR}/")
    if m is not None:
        m.forget(name)


def heal_log(
    ckdir: str,
    prefix: str,
    *,
    run_fp: str | None = None,
    slabs: tuple[str, ...] = (),
    start_depth: int = 1,
    legacy_run_fps: tuple[str, ...] = (),
) -> list[str]:
    """Verify + heal a checkpoint directory; return the usable records.

    ``prefix`` is ``"delta"`` or ``"mdelta"``; ``slabs`` names the
    optional side snapshots to verify alongside (bad ones are
    quarantined — their loaders already fall back to rebuild-from-log).
    ``start_depth`` is where the chain is expected to begin (after a
    ``base.npz`` monolith it is base depth + 1).  ``legacy_run_fps``
    names fingerprint variants of the SAME semantic run from older
    digest schemas (the mesh resume passes its D-pinned pre-elastic
    forms): a manifest bound to one migrates to ``run_fp`` and the
    migration commits with the heal, so later appends bind cleanly.
    Returns the sorted paths of the surviving contiguous records.
    Raises ``ValueError`` on an interior hole and ``RunMismatch`` when
    the manifest belongs to a genuinely different run configuration.
    """
    sweep_tmp(ckdir)
    m = Manifest.load(ckdir)
    migrated = (
        m.exists and run_fp is not None and m.run_fp is not None
        and m.run_fp != run_fp and m.run_fp in legacy_run_fps
    )
    m.bind_run(run_fp, accept=legacy_run_fps)
    if migrated:
        _note(
            f"migrated {ckdir} manifest run fingerprint from a legacy "
            "digest schema (pre-elastic D-pinned form)"
        )
    dirty = migrated

    files = sorted(glob.glob(os.path.join(ckdir, f"{prefix}_*.npz")))
    good: dict[int, str] = {}
    bad_depths: set[int] = set()
    for f in files:
        name = os.path.basename(f)
        d = artifact_depth(name)
        status = m.verify(name)
        if status == "unmanifested" and npz_readable(f):
            # a record that renamed before the manifest commit landed
            # (the crash window between the two), or a pre-manifest
            # record in a directory another commit has since
            # manifested: the rename is atomic and the zip CRCs prove
            # the bytes, so ADOPT it — rebuild the ledger from what
            # verifies instead of destroying a valid log
            algo, dig = digest_file(f)
            m.record(name, kind=prefix, depth=d, algo=algo, digest=dig,
                     nbytes=os.path.getsize(f))
            _note(f"adopted verified unmanifested record {name}")
            status = "ok"
            dirty = True
        elif status == "ok" and not npz_readable(f):
            # a digest can match torn bytes when the tear landed before
            # the digest pass (a write the kernel never flushed): log
            # records are small, so the structural read-back is cheap
            # insurance the replay would otherwise crash on
            status = "corrupt"
        if status == "ok":
            good[d] = f
        else:
            quarantine(ckdir, name, f"{status} record", m)
            bad_depths.add(d)
            dirty = True

    for slab in slabs:
        sf = os.path.join(ckdir, slab)
        if not os.path.exists(sf):
            continue
        status = m.verify(slab)
        if status == "unmanifested" and npz_readable(sf):
            algo, dig = digest_file(sf)
            m.record(slab, kind=slab.split("_")[0].split(".")[0],
                     depth=-1, algo=algo, digest=dig,
                     nbytes=os.path.getsize(sf))
            _note(f"adopted verified unmanifested slab {slab}")
            dirty = True
        elif status != "ok":
            quarantine(ckdir, slab, f"{status} slab snapshot", m)
            dirty = True

    kept: list[str] = []
    expected = start_depth
    for d in sorted(good):
        if d == expected:
            kept.append(good[d])
            expected += 1
            continue
        # a hole before ``d``: records beyond it cannot replay.  If the
        # hole is of our own making (we just quarantined that level, or
        # the level after the last good one) the deeper records are
        # orphans of a healed tail — truncate them.  A hole nobody
        # quarantined means the directory was not produced by the
        # ordered writer: fatal.
        hole = range(expected, d)
        if bad_depths.intersection(hole):
            for dd in sorted(good):
                if dd >= d:
                    quarantine(
                        ckdir, os.path.basename(good[dd]),
                        f"beyond healed level {expected - 1}", m,
                    )
                    dirty = True
            break
        raise ValueError(
            f"{prefix} log interior gap: level {expected} is missing "
            f"from {ckdir} but level {d} exists — the append-only "
            "writer cannot produce this; refusing to guess (clear or "
            "repair the directory)"
        )

    if dirty:
        # also when the directory had no (or a torn) manifest: the
        # adopted entries become the rebuilt ledger
        m.commit()
        lost = len(files) - len(kept)
        _note(
            f"healed {ckdir}: resuming from {len(kept)} verified "
            f"record(s), {lost} truncated/quarantined"
        )
    return kept


def discard_artifacts(ckdir: str, names) -> None:
    """Unlink superseded artifacts (wiped partials) and drop their
    manifest entries in ONE manifest commit."""
    m = Manifest.load(ckdir)
    dirty = False
    for name in names:
        p = os.path.join(ckdir, name)
        if os.path.exists(p):
            os.unlink(p)
        if name in m.artifacts:
            m.forget(name)
            dirty = True
    if dirty and m.exists:
        m.commit()


# -- bounded retry for transient failures ---------------------------------

def with_retry(fn, what: str, attempts: int = 4, base_delay: float = 0.05,
               retry_on: tuple = (faults.FaultError, OSError),
               jitter: bool = True):
    """Call ``fn()`` with exponential backoff + jitter on transient errors.

    Only for IDEMPOTENT operations (re-fetching a device array,
    re-reading a file, rewriting a lease); the last failure propagates.
    ``jitter`` draws each delay uniformly from [0.5, 1.5) of the
    exponential step: when many workers hit one shared filesystem (the
    sweep service's lease renewals), synchronized retries re-collide at
    exactly the backoff boundaries — decorrelating them is what lets a
    transient FS brownout clear instead of resonating.
    """
    import random

    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i == attempts - 1:
                raise
            delay = base_delay * (2 ** i)
            if jitter:
                delay *= 0.5 + random.random()
            _note(
                f"transient failure in {what} (attempt {i + 1}/"
                f"{attempts}): {e} — retrying in {delay:.2f}s"
            )
            time.sleep(delay)


# -- cooperative preemption (SIGTERM/SIGINT -> flush and exit) ------------

class Preempted(Exception):
    """Raised by the level loops after a preemption request; the run is
    resumable from its checkpoint directory."""

    def __init__(self, checkpoint_dir: str | None, depth: int):
        self.checkpoint_dir = checkpoint_dir
        self.depth = depth
        where = (
            f"state through level {depth} is durable in {checkpoint_dir}"
            if checkpoint_dir else "no checkpoint directory configured"
        )
        super().__init__(f"preempted — {where}")


_PREEMPT = {"requested": False, "signum": None}


def preempt_requested() -> bool:
    return _PREEMPT["requested"]


def request_preempt(signum=None) -> None:
    _PREEMPT["requested"] = True
    _PREEMPT["signum"] = signum


def clear_preempt() -> None:
    _PREEMPT["requested"] = False
    _PREEMPT["signum"] = None


def install_signal_handlers() -> None:
    """SIGTERM/SIGINT set the preemption flag; a second signal of the
    same kind falls through to the default action (a stuck run must
    still be killable).  CLI entry points only — libraries and tests
    poll the flag without touching process-global handler state."""
    import signal

    def handler(signum, frame):
        if _PREEMPT["requested"]:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        request_preempt(signum)
        _note(
            f"signal {signal.Signals(signum).name}: finishing the "
            "current level, flushing checkpoints, then exiting "
            "resumable (send again to kill immediately)"
        )

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
