"""Fault tolerance: the port's copy of ``tla_raft_tpu/resilience/``
(less ``elastic``, the mesh's device-loss handling and watchdog).

* ``manifest``  — digests, per-directory ``MANIFEST.json``, and
  ``commit_npz`` / ``commit_json``, the atomic writers every checkpoint
  producer routes through.
* ``recover``   — tmp sweeping, quarantine, truncate-to-good-prefix
  healing, bounded retry, cooperative preemption.
* ``faults``    — the deterministic ``FaultPlan`` (``TLA_RAFT_FAULT`` /
  ``--fault``) that makes all of the above testable on the CPU.
* ``integrity`` — the conservation checks and the ``--audit`` sample
  with its rewind / fail-stop.
"""

from . import integrity  # noqa: F401
from .faults import (  # noqa: F401
    FAULT_SITES,
    FaultError,
    FaultPlan,
)
from .faults import fire as fault_fire  # noqa: F401
from .faults import fire_flag as fault_flag  # noqa: F401
from .faults import install as fault_install  # noqa: F401
from .manifest import (  # noqa: F401
    Manifest,
    RunMismatch,
    adopt_file,
    commit_json,
    commit_npz,
    digest_file,
    load_json_verified,
    run_config_fingerprint,
)
from .recover import (  # noqa: F401
    Preempted,
    clear_preempt,
    discard_artifacts,
    heal_log,
    install_signal_handlers,
    preempt_requested,
    quarantine,
    request_preempt,
    sweep_tmp,
    with_retry,
)
