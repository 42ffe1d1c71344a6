"""The scalar per-lane transcriptions (ops/successor.py ScalarActions), the
definition kernels K1 and K2 implement lane by lane, against the plain
twins on every slot of reachable states, under each mutation."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

from tla_raft_tpu_torch.models.raft import Frontier, state_to_np
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
from tla_raft_tpu_torch.ops.successor import ScalarActions
from torch_port_corpus import CONFIGS, MUT_ARGS, MUTATIONS, batches, configs

CASES = [(CONFIGS[k], ()) for k in CONFIGS] + [(MUT_ARGS, (m,)) for m in MUTATIONS]
IDS = list(CONFIGS) + list(MUTATIONS)


def _rows(arrs, i):
    return {k: v[i] for k, v in arrs.items() if k != "msgs"}


@pytest.mark.parametrize("args,muts", CASES, ids=IDS)
def test_scalar_actions_match_twins(args, muts):
    _rc, pc = configs(args, muts)
    _ref, port, fr = batches(args, muts, n=12, tail=12)
    mx = MXUExpand(pc, "cpu")
    sa = ScalarActions(pc)
    K = mx.K
    valid, mult, abort = mx.guards(port)
    n = fr.voted_for.shape[0]
    child, added, _ovf = mx.materialize(
        fr, torch.arange(n).repeat_interleave(K), torch.arange(K).repeat(n)
    )
    arrs = state_to_np(port)
    ids_np = fr.msg_ids.numpy()
    for i in range(n):
        st = _rows(arrs, i)
        ids = frozenset(int(x) for x in ids_np[i] if x >= 0)
        ab = False
        for k in range(K):
            v, m, a = sa.guard(st, ids, k)
            ab |= a
            assert (v, m) == (bool(valid[i, k]), int(mult[i, k])), (i, k)
            kid, sent = sa.apply(st, k)
            lane = i * K + k
            for f in Frontier._fields[:-1]:
                assert np.array_equal(np.asarray(kid[f], np.uint8),
                                      getattr(child, f)[lane].numpy()), (i, k, f)
            assert sent == added[lane].tolist(), (i, k)
        assert ab == bool(abort[i]), i
