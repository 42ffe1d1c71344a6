"""The sweep service (the port of ``tla_raft_tpu/service``): a crash-safe
directory job queue (``queue.py``), the scheduler that packs pending jobs
into shape buckets (``daemon.py``), the batched bucket core on the card
(``bucket.py``, B14) and the CLI (``python -m tla_raft_tpu_torch.service``).
The worker pool, ``--supervise`` and the chaos campaign are not in the
port yet."""

from .bucket import BatchedChecker, bucket_key  # noqa: F401
from .queue import JobQueue  # noqa: F401
