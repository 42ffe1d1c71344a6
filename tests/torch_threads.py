"""One intra-op thread for torch in the port's CPU tests.

The suite runs in several worker processes on a machine with few cores.
Torch's CPU ops default to one OpenMP thread per core in every process, and
OpenMP threads of several processes contending for the same cores spin
instead of sleeping: a CPU run of the checker that takes 10 s alone took
over 700 s as one of six concurrent workers.  With one thread a process the
same six runs take 10-11 s each.  Every tests/test_torch_*.py module imports
this one, so each worker sets it while it collects the tests."""

import torch

torch.set_num_threads(1)
