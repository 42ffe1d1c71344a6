"""Synthetic sweep-queue generator: the port's copy of
``scripts/queue_synth.synth_jobs`` on the port's ``RaftConfig``.

Production sweep traffic is huge numbers of small configs: CI matrices and
parameter sweeps that vary one CONSTANT at a time around a few base models.
The generator reproduces that shape deterministically: a few (S, Vals,
MaxElection) base keys, each swept across a MaxRestart window (the
service's free bucket axis) and a mix of depth caps, so a queue of N jobs
lands in a handful of shape buckets.  ``synth_jobs(40, seed=1,
mr_width=16, chunk=64)`` is the reference bench's default queue
(bench.py ``_bench_service_arm``).
"""

from __future__ import annotations

from ..config import RaftConfig

# base model keys (S, V, MaxElection), smallest first
BASE_KEYS = [
    (2, 1, 1),
    (2, 1, 2),
    (3, 1, 1),
    (2, 2, 1),
]
# depth-cap mix: most sweeps run to fixpoint, some are shallow CI runs
DEPTH_CAPS = [None, None, None, 6, 9]


def synth_jobs(n: int, seed: int = 1, mr_width: int = 16, chunk: int = 64):
    """Deterministic job list: [(cfg, max_depth, options)] * n."""
    out = []
    x = seed & 0x7FFFFFFF
    for i in range(n):
        # xorshift steps keep the mix deterministic per (seed, i)
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        s, v, me = BASE_KEYS[i % len(BASE_KEYS)]
        mr = i // len(BASE_KEYS) % mr_width
        cap = DEPTH_CAPS[x % len(DEPTH_CAPS)]
        cfg = RaftConfig(n_servers=s, n_vals=v, max_election=me, max_restart=mr)
        out.append((cfg, cap, dict(chunk=chunk)))
    return out
