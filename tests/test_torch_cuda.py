"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the CPU tier
runs the twins against the reference instead).  On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -q``, or, where JAX is not
installed (tests/conftest.py imports it),
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_cuda.py -q``.
``chip_smoke.py`` holds the same kernels against their twins at the main
path's full shapes.
"""

import numpy as np
import pytest
import torch

from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import bfs
from tla_raft_tpu_torch.engine.bfs import TorchChecker, compact_payloads
from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, inv_scan_plain
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import hashstore as hs
from tla_raft_tpu_torch.ops.hashstore import probe_and_insert, probe_and_insert_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def run():
    """A short reference-constants run on the card: its last frontier and
    slab are the kernels' inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=1024)
    res = chk.run(max_depth=10)
    assert res.level_sizes[-1] == 5881
    return chk


def test_guards_kernel_equals_twin(run):
    st = run.inflate(run.frontier)
    for a, b in zip(run.mx.guards(st), run.mx.guards_plain(st)):
        assert torch.equal(a, b)


def test_materialize_kernel_equals_twin(run):
    fr = run.frontier
    g = np.random.default_rng(0)
    pidx = torch.from_numpy(g.integers(0, fr.voted_for.shape[0], 8192)).cuda()
    slots = torch.from_numpy(g.integers(0, run.K, 8192)).cuda()
    kc, ka, ko = run.mx.materialize(fr, pidx, slots)
    pc, pa, po = run.mx.materialize_plain(fr, pidx, slots)
    assert all(torch.equal(x, y) for x, y in zip(kc, pc))
    assert torch.equal(ka, pa) and torch.equal(ko, po)


def test_fingerprint_kernel_equals_twin(run):
    fr = run.frontier
    for a, b in zip(run.fpr.state_fingerprints(fr), run.fpr.state_fingerprints_plain(fr)):
        assert torch.equal(a, b)


def test_hashstore_kernel_equals_twin(run):
    fr = run.frontier
    cv, cf, cp, *_ = run._expand_chunk(Frontier(*(x[:1024] for x in fr)), 0)
    slab = run.hstore.slab
    k = probe_and_insert(slab.clone(), cv, cf, cp)
    p = probe_and_insert_plain(slab.clone(), cv, cf, cp)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert int(k[2]) == int(p[2]) and bool(k[3]) == bool(p[3])


def test_hashstore_kernel_overflow_leaves_the_slab(run):
    """A nearly full slab: the kernel's insert overflows and undoes its
    claims, and its fresh lanes and counts still equal the twin's."""
    g = np.random.default_rng(1)
    slab = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 1024, dtype=np.int64)).cuda()
    slab[torch.from_numpy(g.choice(1024, 3, replace=False)).cuda()] = -1
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 200, dtype=np.int64)).cuda()
    keys, pays = fps.clone(), torch.arange(200, device="cuda")
    before = slab.clone()
    k = probe_and_insert(slab, fps, keys, pays)
    p = probe_and_insert_plain(before.clone(), fps, keys, pays)
    assert bool(k[3]) and bool(p[3])
    assert torch.equal(slab, before) and torch.equal(k[1], p[1]) and int(k[2]) == int(p[2])


def test_compaction_keeps_lane_order_on_the_card(run):
    valid = torch.rand(100_000, device="cuda") < 0.01
    pay = torch.arange(100_000, device="cuda")
    cp, lane, ovf = compact_payloads(valid, pay, 4096)
    assert torch.equal(cp[lane], pay[valid]) and not bool(ovf)


@pytest.mark.parametrize("cap", [1, 700, 4096, 300_000])
def test_compaction_kernel_equals_twins(run, cap):
    g = np.random.default_rng(cap)
    valid = torch.from_numpy(g.random(250_000) < 0.01).cuda()
    pay = torch.from_numpy(g.integers(0, 1 << 40, 250_000)).cuda()
    fps = torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 250_000, dtype=np.int64)).cuda()
    for a, b in zip(compact_payloads(valid, pay, cap), bfs.compact_payloads_plain(valid, pay, cap)):
        assert torch.equal(a, b)
    for a, b in zip(hs.compact_fresh(valid, fps, pay, cap),
                    hs.compact_fresh_plain(valid, fps, pay, cap)):
        assert torch.equal(a, b)


def test_inflate_deflate_kernels_equal_twins(run):
    fr, uni = run.frontier, run.uni
    msgs = bfs.ids_to_msgs(fr.msg_ids, uni.n_words)
    assert torch.equal(msgs, bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words))
    for cap_m in (96, 8):  # 8: most rows overflow
        a = bfs.msgs_to_ids(msgs, uni.M, cap_m, torch.int16)
        b = bfs.msgs_to_ids_plain(msgs, uni.M, cap_m, torch.int16)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_inv_scan_kernel_equals_twin(run):
    """Every predicate, and two negations, on the frontier and on a batch
    of mixed rows (fields from different states), which break Inv."""
    fr = run.frontier
    g = np.random.default_rng(2)
    n = fr.voted_for.shape[0]
    mixed = Frontier(*(x[torch.from_numpy(g.integers(0, n, n)).cuda()].contiguous() for x in fr))
    for case in (fr, mixed):
        st = run.inflate(case)
        for name in sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]:
            want = int(inv_scan_plain(run.cfg, st, [name], run.tables, 5))
            assert int(run.inv_scan(case, offset=5, names=[name])) == want, name
    assert int(run.inv_scan(mixed)) >= 0
