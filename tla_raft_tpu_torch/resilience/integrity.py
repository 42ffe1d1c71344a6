"""Conservation checks and the sampled recomputation audit's sample and
fail-stop: the port's copy of ``tla_raft_tpu/resilience/integrity.py``
(``reconcile``, ``occupancy_check``, ``audit_indices``, the exceptions
and the mesh's ``SkewMeter``); a failed check publishes an ``integrity``
event to the flight recorder before it raises.

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

from ..obs import telemetry as _obs


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
        _obs.integrity(f"reconcile: {what}{at}")
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
        _obs.integrity(f"occupancy: {what}{at}")
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


class SkewMeter:
    """Per-owner level size (and time) skew: the straggler metrics of the
    mesh, the ``--json`` ``straggler`` block (reference integrity.py:98).
    Each level notes the new rows each owner holds (and, where measured,
    per-owner seconds); ``summary()`` gives the per-owner totals, the peak
    max/mean skew over the run and the owner that caused each peak."""

    def __init__(self, D: int):
        self.D = int(D)
        self.levels = 0
        self.rows = np.zeros(self.D, np.int64)
        self.seconds = np.zeros(self.D, np.float64)
        self.peak_row_skew = 0.0
        self.peak_time_skew = 0.0
        self.worst_owner = None
        self.worst_owner_time = None
        self._saw_seconds = False

    @staticmethod
    def _skew(vals) -> float:
        vals = np.asarray(vals, np.float64)
        mean = vals.mean() if vals.size else 0.0
        return float(vals.max() / mean) if mean > 0 else 0.0

    def note(self, level: int, rows=None, seconds=None) -> None:
        self.levels += 1
        if rows is not None:
            rows = np.asarray(rows, np.int64).reshape(-1)[: self.D]
            self.rows[: len(rows)] += rows
            s = self._skew(rows)
            if s > self.peak_row_skew:
                self.peak_row_skew = s
                self.worst_owner = int(np.argmax(rows))
        if seconds is not None:
            self._saw_seconds = True
            seconds = np.asarray(seconds, np.float64).reshape(-1)[: self.D]
            self.seconds[: len(seconds)] += seconds
            s = self._skew(seconds)
            if s > self.peak_time_skew:
                self.peak_time_skew = s
                self.worst_owner_time = int(np.argmax(seconds))

    def summary(self) -> dict:
        out = dict(
            levels=self.levels,
            per_owner_rows=[int(x) for x in self.rows],
            peak_row_skew=round(self.peak_row_skew, 3),
            worst_owner=self.worst_owner,
        )
        if self._saw_seconds:
            out["per_owner_seconds"] = [round(float(x), 4) for x in self.seconds]
            out["peak_time_skew"] = round(self.peak_time_skew, 3)
            out["worst_owner_time"] = self.worst_owner_time
        return out
