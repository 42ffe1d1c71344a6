"""The sampled recomputation audit's sample and fail-stop (the port's copy
of ``tla_raft_tpu/resilience/integrity.py:86-95`` and its exceptions,
without the telemetry hooks).

``--audit N``: every level, a deterministic sample of N new-frontier rows
is re-expanded through the legacy per-lane kernels and cross-checked three
ways (engine/bfs.py ``_audit_level``): the legacy guard admits the
recorded slot, the legacy child re-fingerprints to the recorded level
fingerprint, and the frontier row as materialized on the device
re-fingerprints to it too (the ``tensor.flip`` fault's catch).  The port
has no checkpoints yet, so a mismatch fail-stops with ``AuditFailStop``
(CLI exit 4): the reference's branch for a run without a checkpoint
directory.
"""

from __future__ import annotations

import numpy as np


class IntegrityError(RuntimeError):
    """A count or fingerprint upstream of the answer no longer reconciles."""


class AuditFailStop(IntegrityError):
    """An audit mismatch that no rewind can repair: fail-stop (CLI exit 4)."""


def audit_indices(n_new: int, n_sample: int) -> np.ndarray:
    """The deterministic per-level audit sample: ``n_sample`` rows
    evenly spread over ``[0, n_new)``, always including row 0 (the
    ``tensor.flip`` site's target)."""
    n = int(min(max(n_sample, 0), n_new))
    if n <= 0:
        return np.empty(0, np.int64)
    idx = (np.arange(n, dtype=np.int64) * n_new) // n
    return np.unique(np.clip(idx, 0, n_new - 1))
