"""The port's sieve probe (ops/sieve.py, B13) against the reference's
``probe_impl`` and ``SpillSieve.contains`` (tla_raft_tpu/ops/sieve.py) on
numpy-seeded filters and fingerprints, on the CPU: exact equality of
every lane's hit, and the all-miss sentinel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.ops import sieve as ref_sieve
from tla_raft_tpu_torch.ops import sieve

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _fps(g, n):
    return g.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) + g.integers(
        0, 2, n).astype(np.uint64)


@pytest.mark.parametrize("words,added", [(1, 0), (64, 30), (1024, 4000), (4096, 100)])
def test_probe_equals_reference(words, added):
    g = np.random.default_rng(words + added)
    spill = ref_sieve.SpillSieve(words)
    spill.add(_fps(g, added))
    probe = np.concatenate([_fps(g, 3000), g.choice(_fps(g, added) if added else _fps(g, 1),
                                                    500), [SENT]])
    want_dev = np.asarray(ref_sieve.probe_impl(jnp.asarray(spill.words), jnp.asarray(probe)))
    got = sieve.probe(torch.from_numpy(spill.words.view(np.int64)),
                      torch.from_numpy(probe.view(np.int64))).numpy()
    assert np.array_equal(got, want_dev)
    assert np.array_equal(got, spill.contains(probe))
    count = torch.zeros((), dtype=torch.int64)
    sieve.count_hits(torch.from_numpy(spill.words.view(np.int64)),
                     torch.from_numpy(probe.view(np.int64)), count)
    assert int(count) == int((want_dev & (probe != SENT)).sum())


def test_word_and_mask_equals_reference():
    g = np.random.default_rng(7)
    fps = np.concatenate([_fps(g, 2000), [SENT, np.uint64(0)]])
    w, m = sieve.word_and_mask(torch.from_numpy(fps.view(np.int64)))
    rw, rm = ref_sieve._word_and_mask(fps, np)
    assert np.array_equal(w.numpy().view(np.uint64), rw)
    assert np.array_equal(m.numpy().view(np.uint64), rm)


def test_empty_sentinel_never_hits():
    g = np.random.default_rng(3)
    fps = torch.from_numpy(_fps(g, 10_000).view(np.int64))
    empty = sieve.empty_sieve("cpu")
    assert empty.shape == (1,) and not bool(sieve.probe(empty, fps).any())
    ref_empty = np.asarray(ref_sieve.empty_device_sieve())
    assert np.array_equal(empty.numpy().view(np.uint64), ref_empty)
    count = torch.zeros((), dtype=torch.int64)
    sieve.count_hits(empty, fps, count)
    assert int(count) == 0
