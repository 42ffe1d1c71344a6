"""The device mesh: a sharded frontier and the fingerprint exchange
(the port of ``tla_raft_tpu/parallel``)."""

from .mesh import make_mesh  # noqa: F401
from .sharded import ShardedChecker  # noqa: F401
