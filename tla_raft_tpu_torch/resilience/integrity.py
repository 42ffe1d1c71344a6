"""Conservation checks and the sampled recomputation audit's sample and
fail-stop: the port's copy of ``tla_raft_tpu/resilience/integrity.py``
(``reconcile``, ``occupancy_check``, ``audit_indices`` and the
exceptions), without the telemetry hooks and the mesh's skew meter.

``--audit N``: every level, a deterministic sample of N new-frontier rows
is re-expanded through the legacy per-lane kernels and cross-checked three
ways (engine/bfs.py ``_audit_level``): the legacy guard admits the
recorded slot, the legacy child re-fingerprints to the recorded level
fingerprint, and the frontier row as materialized on the device
re-fingerprints to it too (the ``tensor.flip`` fault's catch).  With a
checkpoint directory a mismatch quarantines the level and rewinds to the
delta log; after ``audit_retries`` strikes at one level (or 4x that many
rewinds in all) it fail-stops with ``AuditFailStop`` (CLI exit 4), as it
does at once without checkpoints.
"""

from __future__ import annotations

import numpy as np


class IntegrityError(RuntimeError):
    """An always-on conservation invariant failed: counts upstream of
    the final answer no longer reconcile."""


class AuditMismatch(IntegrityError):
    """The sampled recomputation audit caught a divergence; the level
    is quarantined and the run rewinds to the last committed
    checkpoint."""


class AuditFailStop(IntegrityError):
    """The audit mismatch reproduced across ``audit_retries`` rewinds:
    deterministic corruption — fail-stop (CLI exit 4)."""


def reconcile(what: str, admitted: int, materialized: int,
              level: int | None = None) -> None:
    """Owner-side admissions must equal origin-side materializations."""
    if int(admitted) != int(materialized):
        at = f" at level {level}" if level is not None else ""
        raise IntegrityError(
            f"conservation check failed{at}: {what} admitted "
            f"{int(admitted)} new state(s) but {int(materialized)} were "
            "materialized — counts no longer reconcile across the "
            "exchange (corrupt exchange buffer, store, or verdict map)"
        )


def occupancy_check(what: str, occupancy: int, distinct: int,
                    level: int | None = None) -> None:
    """A visited structure's live entries must count the distinct set."""
    if int(occupancy) != int(distinct):
        at = f" at level {level}" if level is not None else ""
        raise IntegrityError(
            f"occupancy check failed{at}: {what} holds {int(occupancy)} "
            f"live entrie(s) for {int(distinct)} distinct state(s) — a "
            "fingerprint slab/store diverged from the run's counts"
        )


def audit_indices(n_new: int, n_sample: int) -> np.ndarray:
    """The deterministic per-level audit sample: ``n_sample`` rows
    evenly spread over ``[0, n_new)``, always including row 0 (the
    ``tensor.flip`` site's target)."""
    n = int(min(max(n_sample, 0), n_new))
    if n <= 0:
        return np.empty(0, np.int64)
    idx = (np.arange(n, dtype=np.int64) * n_new) // n
    return np.unique(np.clip(idx, 0, n_new - 1))
