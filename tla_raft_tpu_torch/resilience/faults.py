"""Deterministic fault injection: the part of tla_raft_tpu/resilience/faults.py
that the port polls.

A :class:`FaultPlan` is a parsed list of ``site:action@n`` triggers armed
from the environment (``TLA_RAFT_FAULT``), the CLI (``--fault``) or by
:func:`install`; the instrumented code path calls :func:`fire` (or
:func:`fire_flag`) at a named site, and the plan performs the action when
that site's hit counter reaches ``n``:

* ``kill``  — SIGKILL the process (no cleanup, no atexit: the closest
  userspace approximation of a power cut; the CUDA context dies with it),
* ``torn``  — truncate the artifact at the site to half its bytes and
  continue,
* ``flip``  — flip one byte in the middle of the artifact and continue (at
  ``tensor.flip``: the caller flips one bit of the first live frontier row
  on the device, the ``--audit`` drill),
* ``fail``  — raise :class:`FaultError`,
* ``pause`` — SIGSTOP the whole process until something SIGCONTs it (the
  zombie worker whose lease ages out).

Writer sites follow the artifact kinds of the atomic writers
(``resilience.manifest.commit_npz`` / ``commit_json``): ``<kind>.tmp``
fires after the tmp file is written but before digest and rename,
``<kind>.commit`` after the rename but before the manifest entry lands;
``manifest.commit`` between the manifest's tmp write and its rename.  The
other sites are ``level.start`` (the top of each BFS level),
``bucket.level`` (the top of each batched-bucket level), ``lease.renew``
(a lease heartbeat), ``tensor.flip``, ``hashstore.grow`` (the Nth slab
grow: ``fail`` turns the run onto the sorted visited store),
``exchange.fetch`` (the deep sweep's prefix fetch: ``fail`` is retried)
and ``pipeline.window`` (each read group an async window takes in).
The reference's tier, pool and device sites come with those parts of the
port.  A spec that names a site the port does not
poll, or an action its site cannot perform (``torn``/``flip`` need an
artifact), is refused at parse time: a typo must not silently test
nothing.

Determinism: counters are per-site and in-process; the Nth hit is the
Nth call.  The no-plan fast path is one attribute load and a truthiness
check.
"""

from __future__ import annotations

import os
import signal
import sys

_WRITER = ("kill", "torn", "flip", "fail", "pause")
_RUNTIME = ("kill", "fail", "pause")

# site registry: name -> (what firing there means, the actions it performs)
FAULT_SITES = {
    "delta.tmp": ("single-device delta record: tmp written, not renamed", _WRITER),
    "delta.commit": ("single-device delta record: renamed, not manifested", _WRITER),
    "partial.tmp": ("intra-level partial record: tmp written, not renamed", _WRITER),
    "partial.commit": ("intra-level partial record: renamed, not manifested", _WRITER),
    "hslab.tmp": ("hash-slab snapshot: tmp written, not renamed", _WRITER),
    "hslab.commit": ("hash-slab snapshot: renamed, not manifested", _WRITER),
    "manifest.commit": ("manifest json: tmp written, not renamed", _WRITER),
    "job.tmp": ("service job spec: tmp written, not renamed", _WRITER),
    "job.commit": ("service job spec: renamed, not manifested", _WRITER),
    "jobstate.tmp": ("service state record: tmp written, not renamed", _WRITER),
    "jobstate.commit": ("service state record: renamed, not manifested", _WRITER),
    "result.tmp": ("service result record: tmp written, not renamed", _WRITER),
    "result.commit": ("service result record: renamed, not manifested", _WRITER),
    "lease.tmp": ("service worker lease: tmp written, not renamed", _WRITER),
    "lease.commit": ("service worker lease: renamed (unmanifested kind)", _WRITER),
    "bstate.tmp": ("bucket snapshot: tmp written, not renamed", _WRITER),
    "bstate.commit": ("bucket snapshot: renamed, not manifested", _WRITER),
    "metrics.tmp": ("service metrics snapshot: tmp written, not renamed", _WRITER),
    "metrics.commit": ("service metrics snapshot: renamed, not manifested", _WRITER),
    "level.start": ("top of a BFS level", _RUNTIME),
    "bucket.level": ("top of each batched-bucket level (`kill` dies mid-bucket "
                     "with the bstate snapshot behind)", _RUNTIME),
    "lease.renew": ("top of a lease heartbeat, before the ownership re-check",
                    _RUNTIME),
    "tensor.flip": ("single-device level end: one bit of the first live "
                    "frontier row flips on device (action `flip`; the "
                    "--audit cross-check catches it and rewinds)", ("flip",)),
    "hashstore.grow": ("the Nth visited-slab grow/rehash (action `fail`: the "
                       "run degrades to the sorted visited store; on the deep "
                       "sweep's sieve the capacity stays)", ("fail",)),
    "exchange.fetch": ("deep-mode quantized-prefix host fetch (action `fail`: "
                       "the fetch retries with backoff)", _RUNTIME),
    "pipeline.window": ("async-pipeline read-group submit (the Nth group entering "
                        "the in-flight window)", _RUNTIME),
}


class FaultError(RuntimeError):
    """An injected transient failure (``fail`` action)."""


class FaultPlan:
    """Parsed ``site:action@n`` triggers with per-site hit counters."""

    def __init__(self, spec: str = ""):
        self.triggers: list[tuple[str, str, int]] = []
        self.counts: dict[str, int] = {}
        self.fired: list[str] = []
        for item in spec.replace(";", ",").split(","):
            item = item.strip()
            if not item:
                continue
            try:
                site, action = item.split(":", 1)
            except ValueError:
                raise ValueError(
                    f"fault spec {item!r}: expected site:action[@n]"
                ) from None
            n = 1
            if "@" in action:
                action, ns = action.split("@", 1)
                n = int(ns)
            site, action = site.strip(), action.strip()
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (known: "
                    f"{', '.join(sorted(FAULT_SITES))})"
                )
            if action not in FAULT_SITES[site][1]:
                raise ValueError(
                    f"fault action {action!r} is not one {site} performs (known: "
                    f"{', '.join(FAULT_SITES[site][1])})"
                )
            if n < 1:
                raise ValueError(f"fault occurrence must be >= 1, got {n}")
            self.triggers.append((site, action, n))

    def fire(self, site: str, path: str | None = None) -> None:
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        for tsite, action, tn in self.triggers:
            if tsite != site or tn != n:
                continue
            self.fired.append(f"{site}:{action}@{n}")
            self._perform(site, action, n, path)

    def fire_flag(self, site: str) -> bool:
        """Hit a site whose ``flip`` the caller applies: True when an
        armed trigger fires at this hit."""
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        hit = False
        for tsite, action, tn in self.triggers:
            if tsite != site or tn != n:
                continue
            self.fired.append(f"{site}:{action}@{n}")
            print(f"[fault] {site}:{action}@{n} — caller applies the "
                  "in-memory flip", file=sys.stderr)
            hit = True
        return hit

    def _perform(self, site, action, n, path):
        note = f"[fault] {site}:{action}@{n}"
        if action == "kill":
            print(f"{note} — SIGKILL", file=sys.stderr)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "pause":
            print(f"{note} — SIGSTOP (waiting for SIGCONT)", file=sys.stderr)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGSTOP)
            print(f"{note} — resumed", file=sys.stderr)
            return
        if action == "fail":
            raise FaultError(f"injected transient failure at {site} (#{n})")
        if path is None or not os.path.exists(path):
            raise ValueError(
                f"fault {site}:{action} needs an artifact path but the "
                "site fired without one"
            )
        size = os.path.getsize(path)
        if action == "torn":
            print(f"{note} — truncating {path} to {size // 2} B", file=sys.stderr)
            with open(path, "r+b") as fh:
                fh.truncate(size // 2)
        elif action == "flip":
            print(f"{note} — flipping byte {size // 2} of {path}", file=sys.stderr)
            with open(path, "r+b") as fh:
                fh.seek(size // 2)
                b = fh.read(1)
                fh.seek(size // 2)
                fh.write(bytes([b[0] ^ 0xFF]))


# The process-wide plan.  ``None`` means "not yet armed from the env";
# an EMPTY plan (no triggers) is the normal production state.
_PLAN: FaultPlan | None = None


def plan() -> FaultPlan:
    global _PLAN
    if _PLAN is None:
        _PLAN = FaultPlan(os.environ.get("TLA_RAFT_FAULT", ""))
    return _PLAN


def install(spec: str) -> FaultPlan:
    """Arm a plan explicitly (the CLI's ``--fault``; tests, chip_smoke.py)."""
    global _PLAN
    _PLAN = FaultPlan(spec)
    return _PLAN


def reset() -> None:
    """Disarm (tests)."""
    global _PLAN
    _PLAN = FaultPlan("")


def fire(site: str, path: str | None = None) -> None:
    """Hit a fault site (a no-op unless a plan targets it)."""
    p = plan()
    if p.triggers:
        p.fire(site, path)


def fire_flag(site: str) -> bool:
    """Hit a caller-applied site; True = perform the flip now."""
    p = plan()
    if p.triggers:
        return p.fire_flag(site)
    return False
