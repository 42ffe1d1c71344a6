"""Fault injection and the sampled recomputation audit: the port's copies
of the ``tensor.flip`` part of ``tla_raft_tpu/resilience/faults.py`` and of
``integrity.py``'s audit sample and fail-stop."""
