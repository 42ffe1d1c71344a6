"""The order-keeping compaction as the card runs it (csrc/compact.cuh: tiles
taken by ticket, ranks from the warps' ballots, a decoupled look-back over
epoch-flagged status words, then the pad): its numpy model
(``redesign_cases.compact_model``) against the reference's
``_compact_payloads``, ``_filter_compact`` and ``compact_fresh``, with the
tiles finishing in a shuffled order and the scratch left by earlier calls.
The kernel itself is held against the port's twins on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest

from tla_raft_tpu.engine.bfs import _compact_payloads, _filter_compact
from tla_raft_tpu.ops.hashstore import compact_fresh

from redesign_cases import (CP_EPOCHS, CP_ITEMS, CP_THREADS, CP_LARGE, compact_model, cp_scratch_words,
                            cp_stale_scratch)

SENT = -1
# (lanes, kept share, cap, live count or None), at the kernel's tile of
# 8,192 lanes (16,384 from 2^22 lanes: ``large``, a chunk's flags) and at a
# 256-lane tile (8 threads), which gives tens of tiles and look-backs over
# several 32-word windows
CASES = {
    "empty": (0, 0.5, 64, None),
    "ragged": (3 * 8192 + 77, 0.3, 9000, None),
    "all_kept": (8192 + 33, 1.0, 12000, None),
    "overflow": (2 * 8192 + 5, 0.4, 1000, None),
    "live_count": (4 * 8192 + 11, 0.35, 10000, 2 * 8192 + 700),
    "many_tiles": (70 * 256 + 19, 0.25, 3000, None),
    "large": ((1 << 22) + 16384 * 3 + 5, 0.007, 98304, None),
}


def _case(name: str, seed: int):
    n, share, cap, live = CASES[name]
    g = np.random.default_rng(seed)
    flags = g.random(n) < share
    threads = 8 if name == "many_tiles" else 256
    nt = -(-n // (threads * (64 if n >= CP_LARGE else CP_ITEMS)))
    scratch = cp_stale_scratch(nt, int(g.integers(5, CP_EPOCHS)), seed)
    return g, flags, cap, live, threads, scratch


def _run(flags, vals, pads, cap, live, threads, scratch, seed, **kw):
    out = compact_model(flags, vals, pads, cap, live=live, threads=threads, scratch=scratch,
                        seed=seed, **kw)
    # the pad leaves the scratch for the next call: ticket 0, the next epoch
    assert out["scratch"][0] == 0
    assert out["scratch"][1] == (int(scratch[1]) + 1) % CP_EPOCHS
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_compact_payloads_model_matches_reference(name):
    """B3 ``_compact_payloads``: the valid lanes' payloads (the lane itself
    plus a base, no value array) to cap lanes, the lane mask and the
    overflow; a live count bounds the flag lanes as the fused level's does."""
    g, flags, cap, live, threads, scratch = _case(name, 1)
    base = 7 * 98304
    out = _run(flags, [None], [-1], cap, live, threads, scratch, 2, iota_base=base)
    nl = flags.shape[0] if live is None else live
    f = flags[:nl]
    payload = base + np.arange(nl, dtype=np.int64)
    if nl:
        cp, lane, ovf = (np.asarray(x) for x in _compact_payloads(jnp.asarray(f),
                                                                   jnp.asarray(payload), cap))
    else:
        cp, lane, ovf = np.full(cap, -1), np.zeros(cap, bool), False
    assert np.array_equal(out["lane"], lane)
    assert np.array_equal(out["outs"][0][lane], cp[lane])
    assert (out["outs"][0][~lane] == -1).all()
    assert out["total"] == int(f.sum()) and out["ovf"] == int(bool(ovf))


@pytest.mark.parametrize("name", list(CASES))
def test_filter_compact_model_matches_reference(name):
    """B3 ``_filter_compact``: the unvisited live lanes' (fp_view, fp_full,
    payload) to cap lanes at a lane offset of a larger buffer (the group's
    slice), the payload offset added to the kept payloads, the overflow
    word; the buffer outside the slice untouched."""
    g, _flags, cap, live, threads, scratch = _case(name, 3)
    n = _flags.shape[0]
    cv = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    cv[g.random(n) < 0.2] = SENT
    cf = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    cp = g.integers(0, 1 << 40, n).astype(np.int64)
    hit = g.random(n) < 0.3
    keep = (cv != SENT) & ~hit
    nl = n if live is None else live
    cap = min(cap, nl) if nl else cap  # the reference's top_k takes at most its lanes
    off, pay_off = cap // 2 + 3, 1 << 35
    bufs = [np.full(2 * cap + 9, 5, np.int64) for _ in range(3)]
    out = _run(keep, [cv, cf, cp], [-1, -1, -1], cap, live, threads, scratch, 4, outs=bufs,
               out_off=off, add=pay_off)
    if nl:
        rv, rf, rp, ovf = (np.asarray(x) for x in _filter_compact(
            jnp.asarray(hit[:nl]), jnp.asarray(cv[:nl].view(np.uint64)),
            jnp.asarray(cf[:nl].view(np.uint64)), jnp.asarray(cp[:nl]), cap))
    else:
        rv = rf = np.full(cap, -1, np.int64).view(np.uint64)
        rp, ovf = np.full(cap, -1, np.int64), False
    lane = rp != -1
    want = (rv.view(np.int64), rf.view(np.int64), np.where(lane, rp + pay_off, -1))
    for o, w in zip(out["outs"], want):
        assert np.array_equal(o[off:off + cap], w)
        assert (o[:off] == 5).all() and (o[off + cap:] == 5).all()
    assert out["ovf"] == int(bool(ovf))


@pytest.mark.parametrize("name", list(CASES))
def test_compact_fresh_model_matches_reference(name):
    """B9 ``compact_fresh``: the fresh lanes' (fingerprint, payload) packed
    to a prefix of n_out lanes, SENT and -1 past it."""
    g, fresh, cap, live, threads, scratch = _case(name, 5)
    n = fresh.shape[0]
    fps = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    pays = g.integers(0, 1 << 40, n).astype(np.int64)
    out = _run(fresh, [fps, pays], [SENT, -1], cap, live, threads, scratch, 6)
    nl = n if live is None else live
    if nl:
        rf, rp = (np.asarray(x) for x in compact_fresh(
            jnp.asarray(fresh[:nl]), jnp.asarray(fps[:nl].view(np.uint64)),
            jnp.asarray(pays[:nl]), cap))
    else:
        rf, rp = np.full(cap, -1, np.int64).view(np.uint64), np.full(cap, -1, np.int64)
    assert np.array_equal(out["outs"][0], rf.view(np.int64))
    assert np.array_equal(out["outs"][1], rp)


def test_compact_model_status_words_carry_over():
    """One scratch through three calls of different live counts and
    interleavings (as a captured graph replays a compaction): each call
    reads only its own epoch's status words, and each equals the
    reference."""
    g = np.random.default_rng(9)
    n, cap = 50 * 256 + 3, 3000
    scratch = np.zeros(2 + -(-n // 256), np.uint64)
    payload = np.arange(n, dtype=np.int64)
    for k, live in enumerate((n, 17 * 256 + 40, 31 * 256)):
        flags = g.random(n) < 0.3
        out = _run(flags, [None], [-1], cap, live, 8, scratch, 10 + k)
        cp, lane, ovf = (np.asarray(x) for x in _compact_payloads(
            jnp.asarray(flags[:live]), jnp.asarray(payload[:live]), cap))
        assert np.array_equal(out["lane"], lane)
        assert np.array_equal(out["outs"][0][lane], cp[lane])
        assert out["ovf"] == int(bool(ovf))
        scratch = out["scratch"]
    assert int(scratch[1]) == 3


def test_compact_model_one_scratch_across_tile_sizes():
    """One scratch sized for the largest call (``cp_scratch_words``) through
    compactions on both sides of ``CP_LARGE``: 16,384-lane tiles, then just
    under 2^22 lanes in 8,192-lane tiles (more tiles than the larger call
    has, as the sorted sieve's merge compacts its n live lanes on the
    scratch of its S + n), then both again; each equals the reference."""
    g = np.random.default_rng(21)
    big, under = CP_LARGE + 16384 + 9, CP_LARGE - 1
    words = cp_scratch_words(big)
    assert all(cp_scratch_words(m) <= words for m in (under, big - 1, 1, 0))
    # the larger tiles alone would size the scratch for fewer words than
    # the call below it takes
    assert 2 + -(-big // (CP_THREADS * 64)) < 2 + -(-under // (CP_THREADS * CP_ITEMS))
    scratch = np.zeros(words, np.uint64)
    for k, n in enumerate((big, under, big, (1 << 21) + 3)):
        flags = g.random(n) < 0.004
        payload = np.arange(n, dtype=np.int64)
        cap = 20000
        out = compact_model(flags, [None], [-1], cap, scratch=scratch, seed=30 + k)
        cp, lane, ovf = (np.asarray(x) for x in _compact_payloads(
            jnp.asarray(flags), jnp.asarray(payload), cap))
        assert np.array_equal(out["lane"], lane)
        assert np.array_equal(out["outs"][0][lane], cp[lane])
        assert out["ovf"] == int(bool(ovf))
        scratch = out["scratch"]
    assert int(scratch[1]) == 4
