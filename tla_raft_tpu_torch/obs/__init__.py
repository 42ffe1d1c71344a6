"""Observability: the run record (the port's copy of the reference's
jax-free ``obs/`` modules).

* ``telemetry`` — the process-wide event hub + crash-tolerant
  ``events.jsonl`` flight recorder the level loop publishes into.
* ``tracefile`` — Chrome trace-event (Perfetto) timeline export, with the
  ``--profile`` capture's lanes merged in.
* ``progress``  — live progress line + fixpoint ETA forecasting.
* ``metrics``   — counter/gauge/histogram snapshots for the service.

Nothing under ``obs/`` imports torch or the device code: telemetry
observes the run, it never takes part in it.  Module imports are stdlib
only.
"""

from . import metrics, progress, telemetry, tracefile  # noqa: F401
