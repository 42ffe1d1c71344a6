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
  the reference's; on the card they run over a list of the pending lanes
  (a few grid-wide rounds, then a one-block finisher), with no host read;
* the representative lane of each new fingerprint is the min-(key,
  payload) lane of its slot group (on the card a 16-byte CAS-min into an
  epoch-tagged word a slot);
* the insert works on the slab in place; after a probe-depth overflow
  the slab is left as it was, and the caller grows it and redoes the batch.

``probe_and_insert`` is kernel K4 (csrc/hashstore.cu) on the card and its
plain twin ``probe_and_insert_plain`` on the CPU.  ``insert_only`` (B8
``insert_only_impl``: the claim rounds alone, with the live-count delta)
is the ``insert_only`` kernel of the same source on the card and
``insert_only_plain`` on the CPU; growth rehashes through it, as the
reference's does.  ``probe`` (the membership test, B8 ``probe_impl``) is the
``hs_probe`` kernel of the same source on the card and ``probe_plain`` on
the CPU.  ``compact_fresh`` is the compaction kernel (csrc/compact.cu) on
the card; ``insert_np`` (the host-side build of a slab from a fingerprint
array) and ``rebuild_np`` (the mesh's per-shard rebuild on it) are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..obs import telemetry as _obs
from ..u64 import SENT, mix64, mix64_np, ukey

BIGP = 1 << 62
PROBE_DEPTH = 64
PROBE_WINDOW = 8
MIN_CAP = 1 << 10
SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
# hslab.npz's format version (meta[0]; reference hashstore.py)
SLAB_VERSION = 1


def enabled_by_env() -> bool:
    """The ``TLA_RAFT_HASHSTORE`` default (on unless "0"; reference
    hashstore.py:116)."""
    import os

    return bool(int(os.environ.get("TLA_RAFT_HASHSTORE", "1")))


def dump_interval(slab_bytes: int) -> int:
    """Slab-snapshot cadence in levels (0 = off; reference hashstore.py:123):
    ``TLA_RAFT_SLAB_DUMP`` overrides; the default dumps every level while
    the slab is at most 256 MB and every 16th level beyond."""
    import os

    env = os.environ.get("TLA_RAFT_SLAB_DUMP")
    if env is not None:
        return int(env)
    return 1 if slab_bytes <= (1 << 28) else 16


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


def insert_only_plain(slab: torch.Tensor, fps: torch.Tensor):
    """Plain twin of ``insert_only``: (slab, n_inserted i64 0-d, overflow
    bool 0-d).  The claim loop, with n_inserted the live-count delta and the
    overflow also set when the load passes 1/2 (hashstore.py:325-343).
    Writes into ``slab`` in place, as the kernel does."""
    cap = slab.shape[0]
    before = (slab != SENT).sum()
    new, _slot, ovf = _claim_loop(slab.clone(), fps)
    slab.copy_(new)
    after = (slab != SENT).sum()
    return slab, after - before, ovf | (after * 2 > cap)


def insert_only(slab: torch.Tensor, fps: torch.Tensor):
    """(slab, n_inserted, overflow): the ``insert_only`` kernel on the
    card, the plain twin on the CPU.  Inserts into ``slab`` in place; a lane
    whose probe window is full is skipped (overflow), and nothing is
    undone."""
    if slab.device.type == "cpu":
        return insert_only_plain(slab, fps)
    return kernels.insert_only(slab, fps)


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


def rebuild_np(per_shard, cap: int) -> np.ndarray:
    """[D, cap] slab rows rebuilt on the host from per-shard contents (old
    slab rows or fingerprint arrays; SENT lanes skipped): the mesh's vcap
    growth and its rehash of the slab shards (reference hashstore.py:137)."""
    out = np.full((len(per_shard), cap), SENT_U64, np.uint64)
    for o, rows in enumerate(per_shard):
        rows = np.asarray(rows, np.uint64)
        live = rows[rows != SENT_U64]
        if len(live):
            insert_np(out[o], live)
    return out


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
        _obs.buffer("hslab", self.cap * 8)

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
        old slab's slots go through ``insert_only`` into an empty slab as
        one batch (SENT slots are dead lanes), as the reference's grow does,
        so the layout is the reference's; doubles again on its overflow (a
        full probe window, or the load past 1/2).

        May raise (an allocation failure on a full card, or an injected
        ``hashstore.grow`` fault, reference hashstore.py:521) and leaves the
        slab as it was: the engine then turns the run onto the sorted
        visited store."""
        from ..resilience import faults

        faults.fire("hashstore.grow")
        want = max(self.cap * 2, min_cap or 0)
        want = 1 << (want - 1).bit_length()
        while True:
            slab2, _n, ovf = insert_only(make_slab(want, self.device), self.slab)
            if not bool(ovf):
                break
            want *= 2
        self.cap = want
        self.slab = slab2
        # the live device-memory gauge: every capacity change re-registers
        # the slab (8 B a slot; hashstore.py:472)
        _obs.buffer("hslab", self.cap * 8)

    # -- the slab snapshot (hslab.npz; reference hashstore.py:542, :566) --

    def dump(self, path: str, depth: int, fp_def: int = 0, run_fp: str | None = None) -> None:
        """Atomic slab snapshot next to the delta records, through the
        manifest writer: ``slab`` u64[cap] and ``meta = [SLAB_VERSION,
        depth, count, cap, fp_def]``, the reference's bytes."""
        import os

        from ..resilience import commit_npz

        slab = self.slab.cpu().numpy().view(np.uint64)
        commit_npz(
            os.path.dirname(path) or ".", os.path.basename(path),
            dict(slab=slab, meta=np.asarray([SLAB_VERSION, depth, self.count, self.cap, fp_def],
                                            np.int64)),
            kind="hslab", depth=depth, run_fp=run_fp,
        )

    @classmethod
    def load(cls, path: str, depth: int, count: int, fp_def: int = 0, device=None):
        """The dumped slab if it matches the resume point exactly (version,
        depth, count, fingerprint definition, capacity), else None: the
        caller rebuilds from the replayed fingerprints (the dump is an
        optimization, never the source of truth)."""
        import os
        import zipfile

        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                ver, d, cnt, cap, fpd = (int(x) for x in z["meta"])
                slab = z["slab"]
                if (ver != SLAB_VERSION or d != depth or cnt != count or fpd != fp_def
                        or cap != len(slab)):
                    return None
                st = cls.__new__(cls)
                st.device = resolve_device(device)
                st.cap, st.count = cap, cnt
                st.slab = torch.from_numpy(np.ascontiguousarray(slab).view(np.int64)).to(st.device)
                return st
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None
