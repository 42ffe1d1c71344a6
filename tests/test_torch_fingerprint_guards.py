"""Kernels K3 (fingerprints) and K1 (guards): the port's plain twins
against the reference on the same reachable states, exactly."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from tla_raft_tpu.ops.successor import get_kernel
from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
from torch_port_corpus import CONFIGS, MUT_ARGS, MUTATIONS, batches, configs, u64

FP_CASES = [(CONFIGS["s2"], 200, 0), (CONFIGS["s3v1"], 300, 0), (CONFIGS["ref"], 300, 200)]


@pytest.mark.parametrize("args,n,tail", FP_CASES, ids=["s2", "s3v1", "ref"])
def test_fingerprints_match_reference(args, n, tail):
    rc, pc = configs(args)
    ref_st, _port, fr = batches(args, n=n, tail=tail)
    rv, rf, _msum = get_kernel(rc, mxu=True).fpr.state_fingerprints(ref_st)
    pv, pf = Fingerprinter(pc, device="cpu").state_fingerprints(fr)  # CPU: the plain twin
    assert np.array_equal(u64(pv), np.asarray(rv))
    assert np.array_equal(u64(pf), np.asarray(rf))


def test_fingerprints_match_reference_numpy_path():
    """The twin also equals the reference's host numpy path."""
    rc, pc = configs(CONFIGS["ref"])
    _ref, port, fr = batches(CONFIGS["ref"], n=300, tail=200)
    from tla_raft_tpu_torch.models.raft import state_to_np

    arrs = state_to_np(port)
    bits = Fingerprinter(pc, device="cpu").uni.unpack_bits(arrs["msgs"])
    rv, rf = get_kernel(rc, mxu=True).fpr.fingerprints_np(arrs, bits)
    pv, pf = Fingerprinter(pc, device="cpu").state_fingerprints(fr)
    assert np.array_equal(u64(pv), rv) and np.array_equal(u64(pf), rf)


GUARD_CASES = [(CONFIGS[k], ()) for k in CONFIGS] + [(MUT_ARGS, (m,)) for m in MUTATIONS]
GUARD_IDS = list(CONFIGS) + list(MUTATIONS)


@pytest.mark.parametrize("args,muts", GUARD_CASES, ids=GUARD_IDS)
def test_guards_match_reference(args, muts):
    rc, pc = configs(args, muts)
    ref_st, port, _fr = batches(args, muts, n=250, tail=150)
    rv, rm, ra = get_kernel(rc, mxu=True).expand_guards(ref_st)
    pv, pm, pa = MXUExpand(pc, "cpu").guards(port)  # CPU: the plain twin
    assert np.array_equal(pv.numpy(), np.asarray(rv)), np.argwhere(pv.numpy() != np.asarray(rv))[:5]
    assert np.array_equal(pm.numpy(), np.asarray(rm))
    assert np.array_equal(pa.numpy(), np.asarray(ra))
