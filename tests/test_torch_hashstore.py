"""Kernel K4 (probe-and-insert) and the compaction steps: the port's plain
twins against the reference's jitted programs, on adversarial batches —
a small capacity, crowded homes, in-batch duplicates with different keys
and payloads, SENT lanes, members of the slab, and a probe-depth
overflow — comparing the slab bytes, fresh lanes, n_new and overflow."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tla_raft_tpu.engine import bfs as ref_bfs
from tla_raft_tpu.ops import hashstore as ref_hs
from tla_raft_tpu_torch.engine.bfs import compact_payloads
from tla_raft_tpu_torch.ops import hashstore as hs

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
_ref_pai = jax.jit(ref_hs.probe_and_insert_impl)


def _t(a_u64):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a_u64, np.uint64)).view(np.int64))


def _rand_u64(rng, n):
    return rng.integers(0, 2**64 - 2, n, dtype=np.uint64, endpoint=True)


def _home(fps, cap):
    return ref_hs.mix64(fps) & np.uint64(cap - 1)


def _case(name, rng):
    """(slab u64[cap], fps, keys u64, pays i64) of one adversarial case."""
    if name == "small_cap":
        cap, n = 16, 12
        slab = np.full(cap, SENT, np.uint64)
        fps = _rand_u64(rng, n)
    elif name == "crowded_homes":
        cap = 1024
        pool = _rand_u64(rng, 200_000)
        fps = pool[_home(pool, cap) < np.uint64(3)][:50]  # 50 fps, 3 homes
        slab = np.full(cap, SENT, np.uint64)
        ref_hs.insert_np(slab, fps[:20])
    elif name == "duplicates_sent_members":
        cap = 1024
        slab = np.full(cap, SENT, np.uint64)
        members = _rand_u64(rng, 150)
        ref_hs.insert_np(slab, members)
        base = np.concatenate([_rand_u64(rng, 100), members[:40]])
        fps = base[rng.integers(0, len(base), 600)]  # many in-batch duplicates
        fps[rng.random(600) < 0.1] = SENT
    else:  # "depth_overflow": a full slab leaves no empty slot in reach
        cap = 1024
        slab = np.full(cap, SENT, np.uint64)
        ref_hs.insert_np(slab, _rand_u64(rng, 511))
        full = _rand_u64(rng, 4 * cap)
        slab[slab == SENT] = full[: int((slab == SENT).sum())]
        fps = np.concatenate([_rand_u64(rng, 30), slab[:10]])
    n = len(fps)
    keys = _rand_u64(rng, n)
    keys[: n // 3] = keys[0]  # key ties resolved by payload
    pays = rng.permutation(10 * n)[:n].astype(np.int64)
    return slab, fps, keys, pays


CASES = ["small_cap", "crowded_homes", "duplicates_sent_members", "depth_overflow"]


@pytest.mark.parametrize("name", CASES)
def test_probe_and_insert_matches_reference(name):
    rng = np.random.default_rng(CASES.index(name) + 1)
    slab, fps, keys, pays = _case(name, rng)
    r_slab, r_fresh, r_n, r_ovf = _ref_pai(
        jnp.asarray(slab), jnp.asarray(fps), jnp.asarray(keys), jnp.asarray(pays)
    )
    t_slab = _t(slab)
    before = t_slab.clone()
    p_slab, p_fresh, p_n, p_ovf = hs.probe_and_insert(t_slab, _t(fps), _t(keys),
                                                      torch.from_numpy(pays))
    assert p_slab is t_slab, "the insert lands in the slab it was given"
    if bool(p_ovf):
        # the reference's caller discards its slab' on overflow; the
        # port's insert leaves the slab as it was instead
        assert torch.equal(t_slab, before), "an overflowed insert must leave the slab"
    else:
        assert np.array_equal(p_slab.numpy().view(np.uint64), np.asarray(r_slab))
    assert np.array_equal(p_fresh.numpy(), np.asarray(r_fresh))
    assert int(p_n) == int(r_n)
    assert bool(p_ovf) == bool(r_ovf) == (name == "depth_overflow")


def test_probe_matches_reference():
    rng = np.random.default_rng(9)
    slab, fps, _k, _p = _case("duplicates_sent_members", rng)
    want = np.asarray(jax.jit(ref_hs.probe_impl)(jnp.asarray(slab), jnp.asarray(fps)))
    assert np.array_equal(hs.probe(_t(slab), _t(fps)).numpy(), want)


def test_grow_and_from_fps_match_reference_layout():
    rng = np.random.default_rng(4)
    fps = _rand_u64(rng, 700)
    st = hs.DeviceHashStore.from_fps(fps, device="cpu")
    ref = ref_hs.DeviceHashStore.from_fps(fps)
    assert st.cap == ref.cap and st.count == ref.count
    assert np.array_equal(st.slab.numpy().view(np.uint64), np.asarray(ref.slab))
    st.grow()
    ref.grow()
    assert st.cap == ref.cap
    assert np.array_equal(st.slab.numpy().view(np.uint64), np.asarray(ref.slab))
    assert np.array_equal(hs.insert_np(np.full(st.cap, SENT, np.uint64), fps),
                          np.asarray(ref.slab))


@pytest.mark.parametrize("n_out", [100, 600, 1000])
def test_compact_fresh_matches_reference(n_out):
    """n_out = 100 holds fewer lanes than are fresh: the rest drop."""
    rng = np.random.default_rng(n_out)
    fresh = rng.random(600) < 0.3
    fps = _rand_u64(rng, 600)
    pays = rng.integers(0, 1 << 40, 600).astype(np.int64)
    rf, rp = ref_hs.compact_fresh(jnp.asarray(fresh), jnp.asarray(fps), jnp.asarray(pays),
                                  n_out)
    pf, pp = hs.compact_fresh(torch.from_numpy(fresh), _t(fps), torch.from_numpy(pays), n_out)
    n = min(int(fresh.sum()), n_out)
    assert np.array_equal(pf.numpy().view(np.uint64)[:n_out], np.asarray(rf))
    assert np.array_equal(pp.numpy()[:n], np.asarray(rp)[:n])


@pytest.mark.parametrize("cap_x", [64, 480, 512, 900])
def test_compact_payloads_matches_reference(cap_x):
    """cap_x below the live count (overflow), at it, and above the lane
    count C (the reference pads); the valid prefix, its mask and the
    overflow flag agree (lanes past the prefix are unspecified)."""
    rng = np.random.default_rng(cap_x)
    C = 512
    valid = rng.random(C) < 0.6
    payload = (np.arange(C) * 7 + 3).astype(np.int64)
    rcp, rlane, rovf = ref_bfs._compact_payloads(jnp.asarray(valid), jnp.asarray(payload),
                                                 cap_x)
    pcp, plane, povf = compact_payloads(torch.from_numpy(valid), torch.from_numpy(payload), cap_x)
    rlane = np.asarray(rlane)
    assert np.array_equal(plane.numpy(), rlane)
    assert np.array_equal(pcp.numpy()[rlane], np.asarray(rcp)[rlane])
    assert bool(povf) == bool(rovf)
