"""Device-resident open-addressing fingerprint store (kernel K4).

The port of ``tla_raft_tpu/ops/hashstore.py``, with the same slab layout
byte for byte, so slabs move between the two packages:

* one power-of-two **slab** of u64 fingerprint slots (int64 bit patterns;
  ``SENT`` = -1 = empty);
* home slot ``mix64(fp) & (cap - 1)``, linear probing over at most
  ``PROBE_DEPTH`` slots (an insert that would need more reports overflow,
  and the caller grows the slab and redoes the batch);
* batch inserts resolve in **rounds**: every pending lane probes the slab
  as it stood at the round's start, claims its empty slot with an
  unsigned atomic minimum, then checks whether it won.  The rounds are
  what make the slab layout independent of thread timing and equal to
  the reference's;
* the representative lane of each new fingerprint is the min-(key,
  payload) lane of its slot group (two slab-sized scratch minima);
* the insert works on the slab in place; after a probe-depth overflow
  the slab is left as it was, and the caller grows it and redoes the batch.

``probe_and_insert`` is kernel K4 (csrc/hashstore.cu) on the card and its
plain twin ``probe_and_insert_plain`` on the CPU; growth rehashes through
it too.  ``probe`` (the membership test, B8 ``probe_impl``) is the
``hs_probe`` kernel of the same source on the card and ``probe_plain`` on
the CPU.  ``compact_fresh`` is the compaction kernel (csrc/compact.cu) on
the card; ``insert_np`` (the host-side build of a slab from a fingerprint
array) is numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..u64 import SENT, mix64, mix64_np, ukey

BIGP = 1 << 62
PROBE_DEPTH = 64
PROBE_WINDOW = 8
MIN_CAP = 1 << 10
SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def slab_rows(expected: int, load: float = 0.5) -> int:
    """Power-of-two capacity holding ``expected`` entries at ``load``."""
    need = max(MIN_CAP, int(expected / load) + 1)
    return 1 << (need - 1).bit_length()


def make_slab(cap: int, device=None) -> torch.Tensor:
    device = resolve_device(device)
    if cap & (cap - 1) or cap < MIN_CAP:
        raise ValueError(f"slab capacity must be a power of two >= {MIN_CAP}, got {cap}")
    return torch.full((cap,), SENT, dtype=torch.int64, device=device)


def _probe_rounds(slab: torch.Tensor, fps: torch.Tensor, depth: int = PROBE_DEPTH):
    """Depth-bounded probe walk of every lane: (idx, found, settled).

    ``idx`` is the slot holding the lane's fp (found) or the first empty
    slot on its path; ``settled`` is False for SENT lanes and for lanes
    whose whole window is full of other fingerprints (probe overflow)."""
    cap = slab.shape[0]
    live = fps != SENT
    h0 = mix64(fps) & (cap - 1)
    woff = torch.arange(PROBE_WINDOW, dtype=torch.int64, device=fps.device)[None, :]
    idx = torch.zeros_like(fps)
    found = torch.zeros_like(live)
    done = ~live
    for d in range(0, depth, PROBE_WINDOW):
        cur = (h0[:, None] + d + woff) & (cap - 1)
        v = slab[cur]
        hitw = v == fps[:, None]
        stopw = hitw | (v == SENT)
        one = stopw & (torch.cumsum(stopw.to(torch.int64), 1) == 1)
        cand = (cur * one).sum(1)
        is_hit = (hitw & one).any(1)
        settle = ~done & stopw.any(1)
        idx = torch.where(settle, cand, idx)
        found = found | (settle & is_hit)
        done = done | stopw.any(1)
    return idx, found, done & live


def probe_plain(slab: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``probe``: fps[i] (!= SENT) is in the slab."""
    return _probe_rounds(slab, fps)[1]


def probe(slab: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Membership mask bool[N]: fps[i] (!= SENT) is in the slab.  The
    ``hs_probe`` kernel on the card, the plain twin on the CPU."""
    if fps.device.type == "cpu":
        return probe_plain(slab, fps)
    return kernels.hs_probe(slab, fps)


def _scatter_umin(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """dst[idx] = unsigned min(dst[idx], vals) (duplicates reduce)."""
    k = ukey(dst)
    k.scatter_reduce_(0, idx, ukey(vals), "amin", include_self=True)
    return ukey(k)


def _claim_loop(slab: torch.Tensor, fps: torch.Tensor):
    """Probe-and-claim rounds for every live lane: (slab', slot, overflow)."""
    live = fps != SENT
    pending = live.clone()
    slot = torch.zeros_like(fps)
    ovf = torch.zeros((), dtype=torch.bool, device=fps.device)
    while bool(pending.any()):
        pf = torch.where(pending, fps, torch.full_like(fps, SENT))
        idx, found, settled = _probe_rounds(slab, pf)
        slot = torch.where(pending & found, idx, slot)
        want = pending & ~found & settled
        slab = _scatter_umin(slab, idx[want], fps[want])
        got = want & (slab[idx] == fps)
        slot = torch.where(got, idx, slot)
        dead = pending & ~found & ~settled
        pending = pending & ~found & ~got & ~dead
        ovf = ovf | dead.any()
    return slab, slot, ovf


def probe_and_insert_plain(slab, fps, keys, pays):
    """Plain twin of K4: (slab, fresh bool[N], n_new i64, overflow bool).

    fps u64[N] (SENT = dead lane), keys u64[N] (fp_full, the tie-break
    key), pays i64[N] (unique payloads).  ``fresh`` marks one lane per
    fingerprint newly inserted by this call: the min-(key, payload) lane
    of its slot group.  The insert lands in ``slab`` in place; on overflow
    ``slab`` is left as it was, and the caller grows it and redoes the
    batch."""
    cap = slab.shape[0]
    orig = slab
    live = fps != SENT
    new, slot, ovf = _claim_loop(slab.clone(), fps)
    _i, pre_found, _s = _probe_rounds(orig, fps)
    grp_new = live & ~pre_found
    m1 = _scatter_umin(
        torch.full((cap,), SENT, dtype=torch.int64, device=fps.device),
        slot[grp_new], keys[grp_new],
    )
    is1 = grp_new & (m1[slot] == keys)
    m2 = torch.full((cap,), BIGP, dtype=torch.int64, device=fps.device)
    m2.scatter_reduce_(0, slot[is1], pays[is1], "amin", include_self=True)
    fresh = is1 & (m2[slot] == pays)
    if not bool(ovf):
        slab.copy_(new)
    return slab, fresh, fresh.sum(), ovf


def probe_and_insert(slab, fps, keys, pays):
    """(slab, fresh, n_new, overflow): kernel K4 on the card, the plain
    twin on the CPU.  Inserts into ``slab`` in place, and leaves it as it
    was when the insert overflows."""
    if slab.device.type == "cpu":
        return probe_and_insert_plain(slab, fps, keys, pays)
    return kernels.probe_and_insert(slab, fps, keys, pays)


def compact_fresh(fresh, fps, pays, n_out: int):
    """Fresh lanes packed to a prefix in lane order: (fps[n_out] SENT
    padded, pays[n_out] -1 padded).  The compaction kernel on the card,
    the plain twin on the CPU."""
    if fresh.device.type == "cpu":
        return compact_fresh_plain(fresh, fps, pays, n_out)
    out_f, out_p, _lane, _total = kernels.compact(fresh, fps, SENT, n_out, vb=pays, pad_b=-1)
    return out_f, out_p


def compact_fresh_plain(fresh, fps, pays, n_out: int):
    """Plain twin of ``compact_fresh``: cumsum + trash-slot scatter; fresh
    lanes past ``n_out`` are dropped, as the reference's scatter drops them."""
    dest = torch.cumsum(fresh.to(torch.int64), 0) - 1
    tgt = torch.where(fresh & (dest < n_out), dest, torch.full_like(dest, n_out))
    out_f = torch.full((n_out + 1,), SENT, dtype=torch.int64, device=fps.device)
    out_p = torch.full((n_out + 1,), -1, dtype=torch.int64, device=fps.device)
    out_f.scatter_(0, tgt, fps)
    out_p.scatter_(0, tgt, pays)
    return out_f[:n_out], out_p[:n_out]


def insert_np(slab: np.ndarray, fps: np.ndarray) -> np.ndarray:
    """Pure-numpy insert with the identical slab layout (uint64 arrays):
    the same rounds, with ``np.minimum.at`` as the claim.  Raises on a
    probe overflow — callers size the slab from the entry count."""
    cap = len(slab)
    fps = np.asarray(fps, np.uint64)
    fps = fps[fps != SENT_U64]
    pending = np.unique(fps)
    h0 = (mix64_np(pending) & np.uint64(cap - 1)).astype(np.int64)
    while len(pending):
        idx = np.full(len(pending), -1, np.int64)
        found = np.zeros(len(pending), bool)
        done = np.zeros(len(pending), bool)
        for d in range(PROBE_DEPTH):
            if done.all():
                break
            cur = (h0 + d) & (cap - 1)
            v = slab[cur]
            hit = v == pending
            empty = v == SENT_U64
            settle = ~done & (hit | empty)
            idx[settle] = cur[settle]
            found |= ~done & hit
            done |= hit | empty
        if not done.all():
            raise ValueError(
                f"insert_np probe overflow (cap {cap}, "
                f"{int((~done).sum())} unresolved) — slab undersized"
            )
        want = done & ~found
        np.minimum.at(slab, idx[want], pending[want])
        got = want & (slab[np.clip(idx, 0, cap - 1)] == pending)
        keep = ~(found | got)
        pending, h0 = pending[keep], h0[keep]
    return slab


class DeviceHashStore:
    """One slab on a device, with growth by rehash.

    ``probe_and_insert`` leaves the slab as it was when it overflows, so a
    level whose insert overflowed is redone against the grown slab;
    ``adopt`` accepts a level's slab once the level is final."""

    def __init__(self, cap: int = MIN_CAP, count: int = 0, device=None):
        self.device = resolve_device(device)
        self.cap = max(MIN_CAP, cap)
        self.count = count
        self.slab = make_slab(self.cap, self.device)

    @classmethod
    def from_fps(cls, fps: np.ndarray, cap: int | None = None, device=None):
        fps = np.asarray(fps, np.uint64)
        fps = fps[fps != SENT_U64]
        n = len(np.unique(fps)) if len(fps) else 0
        st = cls(cap or slab_rows(n), n, device)
        arr = np.full(st.cap, SENT_U64, np.uint64)
        if n:
            insert_np(arr, fps)
        st.slab = torch.from_numpy(arr.view(np.int64)).to(st.device)
        return st

    def occupancy(self) -> int:
        """Live (non-SENT) slots of the slab, counted on its device."""
        return int((self.slab != SENT).sum())

    def need_grow(self, extra: int = 0) -> bool:
        return (self.count + extra) * 2 > self.cap

    def reserve(self, expected: int) -> None:
        """Grow (never shrink) to hold ``expected`` entries at the <= 1/2
        load (hashstore.py:533): a superstep reserves its whole span's
        forecast inserts before it starts."""
        want = slab_rows(expected)
        if want > self.cap:
            self.grow(min_cap=want)

    def adopt(self, slab: torch.Tensor, n_new: int) -> None:
        self.slab = slab
        self.count += int(n_new)

    def grow(self, min_cap: int | None = None) -> None:
        """Rehash into a slab of twice the capacity (or ``min_cap``): the
        old slab's slots go through ``probe_and_insert`` into an empty slab
        as one batch (SENT slots are dead lanes) — the reference's
        ``insert_only`` rounds, so the layout is the reference's; doubles
        again on a probe overflow."""
        want = max(self.cap * 2, min_cap or 0)
        want = 1 << (want - 1).bit_length()
        pays = torch.arange(self.cap, dtype=torch.int64, device=self.device)
        while True:
            slab2, _fresh, _n, ovf = probe_and_insert(
                make_slab(want, self.device), self.slab, self.slab, pays
            )
            if not bool(ovf):
                break
            want *= 2
        self.cap = want
        self.slab = slab2
