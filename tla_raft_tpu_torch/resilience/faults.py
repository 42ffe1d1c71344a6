"""Deterministic fault injection: the part of tla_raft_tpu/resilience/faults.py
that the port polls.

A :class:`FaultPlan` is a parsed list of ``site:action@n`` triggers armed
from the environment (``TLA_RAFT_FAULT``) or by :func:`install`; the
instrumented code path calls :func:`fire_flag` or :func:`fire` at a named
site, and the plan fires when that site's hit counter reaches ``n``.

The port has two sites: ``tensor.flip``, the engine's level end, where the
caller flips one bit of the first live frontier row on the device (the
``--audit`` drill); and ``hashstore.grow``, the hash slab's grow, whose
``fail`` raises :class:`FaultError` there (:func:`fire`) and turns the run
onto the sorted visited store (reference ``resilience/faults.py:87``).  The
reference's file-writer, service and mesh sites and their actions (kill,
torn, lost, hang, pause) come with the checkpoints, the sweep service and
the mesh.  A spec that names anything
else is refused at parse time: a typo, or a site the port does not poll,
must not silently test nothing.

Determinism: counters are per-site and in-process; the Nth hit is the
Nth call.  The no-plan fast path is one attribute load and a truthiness
check.
"""

from __future__ import annotations

import os
import sys

# site registry: name -> what firing there means
FAULT_SITES = {
    "tensor.flip": "single-device level end: one bit of the first live "
                   "frontier row flips on device (action `flip`; the "
                   "--audit cross-check catches it)",
    "hashstore.grow": "the Nth visited-slab grow/rehash (action `fail`: the "
                      "run degrades to the sorted visited store)",
}

# the actions each site performs (the caller's flip; fire's FaultError)
_ACTIONS = {"tensor.flip": ("flip",), "hashstore.grow": ("fail",)}


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
            if action not in _ACTIONS[site]:
                raise ValueError(
                    f"fault action {action!r} is not one {site} performs (known: "
                    f"{', '.join(_ACTIONS[site])})"
                )
            if n < 1:
                raise ValueError(f"fault occurrence must be >= 1, got {n}")
            self.triggers.append((site, action, n))

    def fire(self, site: str) -> None:
        """Hit a site whose action is ``fail``: an armed trigger raises
        ``FaultError`` at this hit."""
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        for tsite, action, tn in self.triggers:
            if tsite != site or tn != n:
                continue
            self.fired.append(f"{site}:{action}@{n}")
            raise FaultError(f"injected transient failure at {site} (#{n})")

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


# The process-wide plan.  ``None`` means "not yet armed from the env";
# an EMPTY plan (no triggers) is the normal production state.
_PLAN: FaultPlan | None = None


def plan() -> FaultPlan:
    global _PLAN
    if _PLAN is None:
        _PLAN = FaultPlan(os.environ.get("TLA_RAFT_FAULT", ""))
    return _PLAN


def install(spec: str) -> FaultPlan:
    """Arm a plan explicitly (tests, chip_smoke.py)."""
    global _PLAN
    _PLAN = FaultPlan(spec)
    return _PLAN


def reset() -> None:
    """Disarm (tests)."""
    global _PLAN
    _PLAN = FaultPlan("")


def fire(site: str) -> None:
    """Hit a fault site (a no-op unless a plan targets it)."""
    p = plan()
    if p.triggers:
        p.fire(site)


def fire_flag(site: str) -> bool:
    """Hit a caller-applied site; True = perform the flip now."""
    p = plan()
    if p.triggers:
        return p.fire_flag(site)
    return False
