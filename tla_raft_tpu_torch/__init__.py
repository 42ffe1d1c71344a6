"""tla_raft_tpu_torch: the Raft model checker in PyTorch, with CUDA kernels.

The port of ``tla_raft_tpu`` (JAX) to PyTorch and hand-written CUDA for an
NVIDIA H100.  It imports nothing of the JAX package; the reference stays
beside it and the tests hold the two bit for bit equal.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
