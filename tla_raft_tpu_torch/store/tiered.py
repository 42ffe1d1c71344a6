"""The tiered visited store: the hot slab on the card, warm generations on
the host.

The port of the hot and warm tiers of ``tla_raft_tpu/store/tiered.py``
(``TieredVisitedStore`` :204-665, ``Generation`` :142,
``store_bytes_from_env`` :128) and of its one device program,
``drop_rows_impl`` (:810, kernel B16).

* **hot**: the open-addressing slab (ops/hashstore.py), under a device
  byte budget (``--dev-bytes`` / ``TLA_RAFT_STORE_BYTES``).  When the
  slab's growth would pass the budget, the engine demotes the slab's
  fingerprints as one generation and restarts the slab empty
  (engine/bfs.py ``_slab_grow_or_demote``, ``_tier_drain``).
* **warm**: host-RAM generations, each a sorted unique run of u64
  fingerprints.  Eviction is by generation, never by entry, so a probe
  is a ``searchsorted`` per run and the union of the tiers is exactly the
  visited set.

**Probe protocol.**  Every route probes and inserts against the hot slab
alone, so a level's fresh states may hold revisits of demoted
fingerprints.  The host probes those fingerprints (``probe``: the cache
of confirmed revisits first, then the warm runs) and the engine drops the
hits from the materialized frontier with ``drop_rows``, keeping the order
of the rest; the hit fingerprints stay in the hot slab (the re-heat).
Every demoted fingerprint also goes into the ``SpillSieve``
(ops/sieve.py), whose device copy the fused levels probe, so a level with
no sieve hit needs no host probe.

With no spill directory nothing goes cold, as in the reference without
one: the cold tier, the per-run side-car filters, LSM compaction and the
frontier pager are not ported (they write through the checkpoint writer,
which comes with checkpoint/resume).  This module imports nothing of the
JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import kernels
from ..models.raft import Frontier
from ..ops import sieve as sieve_mod

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)

# confirmed spilled revisits kept sorted for the first probe step; past
# it the low half is dropped (a cache: a miss costs a run probe only)
SIEVE_MAX = 1 << 20


def store_bytes_from_env() -> int:
    """The hot tier's device budget: ``TLA_RAFT_STORE_BYTES`` (bytes; 0 or
    unset = no budget, tiering off)."""
    v = os.environ.get("TLA_RAFT_STORE_BYTES")
    return int(float(v)) if v else 0


class Generation:
    """One demoted run: sorted unique u64 fingerprints, with its [lo, hi]
    range for a free reject."""

    __slots__ = ("gid", "n", "lo", "hi", "fps")

    def __init__(self, gid: int, fps: np.ndarray):
        fps = np.asarray(fps, np.uint64)
        self.gid = gid
        self.n = len(fps)
        self.lo = np.uint64(fps[0]) if self.n else SENT
        self.hi = np.uint64(fps[-1]) if self.n else np.uint64(0)
        self.fps = fps


class TieredVisitedStore:
    """The generations below the hot slab, and their probes.  The slab
    itself stays the engine's (``DeviceHashStore``)."""

    def __init__(self, dev_bytes: int):
        self.dev_bytes = int(dev_bytes)
        self.gens: list[Generation] = []
        self._next_gid = 0
        self.sieve = np.empty(0, np.uint64)  # confirmed revisits, sorted
        # one bloom over every demoted fingerprint, at full size from the
        # first demotion on (the device copy's address never changes)
        self.spill_sieve = None
        self.stats = dict(
            demotions=0, spilled=0, probes=0, probe_lanes=0, probe_hits=0,
            sieve_hits=0, warm_hits=0, probe_wait_s=0.0, reheats=0, tier_redos=0,
            sieve_skips=0,
        )

    # -- policy -------------------------------------------------------------

    @property
    def active(self) -> bool:
        """At least one generation exists: level tails must probe."""
        return bool(self.gens)

    @property
    def max_hot_entries(self) -> int:
        """Entries the hot slab may hold inside the budget at the <= 1/2
        load (0: no budget); one under the half-slot mark, since exactly
        cap/2 entries would ask for a slab twice the budget."""
        if not self.dev_bytes:
            return 0
        return max(self.hot_slot_budget() // 2 - 1, 1)

    def hot_slot_budget(self) -> int:
        """The largest power-of-two slab (slots) inside the budget."""
        if not self.dev_bytes:
            return 0
        slots = self.dev_bytes // 8
        return 1 << max(slots.bit_length() - 1, 0) if slots else 1

    def slab_fits(self, cap: int) -> bool:
        """May a slab of ``cap`` u64 slots live in the budget?"""
        return not self.dev_bytes or cap * 8 <= self.dev_bytes

    def spilled_distinct(self) -> int:
        """Fingerprints across the generations (an upper bound of their
        union: a re-heated fingerprint may be demoted again)."""
        return sum(g.n for g in self.gens)

    # -- demotion -------------------------------------------------------------

    def demote(self, fps: np.ndarray) -> Generation:
        """Seal the hot slab's live fingerprints (host-side) as one
        generation, and add them to the spill sieve."""
        fps = np.asarray(fps, np.uint64)
        fps = np.unique(fps[fps != SENT])
        gen = Generation(self._next_gid, fps)
        self._next_gid += 1
        if gen.n:
            if self.spill_sieve is None:
                self.spill_sieve = sieve_mod.SpillSieve(sieve_mod.sieve_words_for(self.dev_bytes))
            self.spill_sieve.add(fps)
            self.gens.append(gen)
        self.stats["demotions"] += 1
        self.stats["spilled"] += gen.n
        return gen

    # -- probes ----------------------------------------------------------------

    def probe(self, fps: np.ndarray) -> np.ndarray:
        """hit bool[n]: which fingerprints some generation holds.  The
        confirmed-revisit cache first, then the runs oldest first, each
        behind its [lo, hi] reject; hits join the cache."""
        t0 = time.monotonic()
        fps = np.asarray(fps, np.uint64)
        hit = np.zeros(len(fps), bool)
        live = fps != SENT
        self.stats["probes"] += 1
        self.stats["probe_lanes"] += int(live.sum())
        if len(self.sieve):
            pos = np.searchsorted(self.sieve, fps)
            sh = live & (self.sieve[np.clip(pos, 0, len(self.sieve) - 1)] == fps)
            self.stats["sieve_hits"] += int(sh.sum())
            hit |= sh
        pending = live & ~hit
        for g in self.gens:
            if not pending.any():
                break
            inr = pending & (fps >= g.lo) & (fps <= g.hi)
            if not inr.any():
                continue
            pos = np.searchsorted(g.fps, fps[inr])
            gh = g.fps[np.clip(pos, 0, g.n - 1)] == fps[inr]
            if gh.any():
                idx = np.nonzero(inr)[0][gh]
                hit[idx] = True
                pending[idx] = False
                self.stats["warm_hits"] += int(gh.sum())
        n_hit = int(hit.sum())
        self.stats["probe_hits"] += n_hit
        if n_hit:
            self._sieve_add(fps[hit])
        self.stats["probe_wait_s"] += time.monotonic() - t0
        return hit

    def _sieve_add(self, fps: np.ndarray) -> None:
        merged = np.union1d(self.sieve, fps)
        if len(merged) > SIEVE_MAX:
            merged = merged[len(merged) // 2:]
        self.sieve = merged


# -- B16: the frontier row compaction (csrc/tiered.cu) -----------------------------


def drop_rows_plain(fr: Frontier, keep: torch.Tensor, n_keep: int) -> Frontier:
    """Plain twin of ``drop_rows``: the kept rows in order (a stable
    argsort), every row from ``n_keep`` on zero."""
    rows = keep.shape[0]
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    live = torch.arange(rows, device=keep.device) < int(n_keep)

    def one(x):
        m = live.reshape((rows,) + (1,) * (x.dim() - 1))
        return torch.where(m, x[order], torch.zeros_like(x))

    return Frontier(*(one(x) for x in fr))


def drop_rows(fr: Frontier, keep: torch.Tensor, n_keep: int) -> Frontier:
    """B16 ``drop_rows_impl``: a new Frontier of the same capacity holding
    the ``keep`` rows (bool[rows]) of ``fr`` in order, then zeros;
    ``n_keep`` is their count.  Kernel ``drop_rows`` on the card, the plain
    twin on the CPU."""
    if keep.device.type == "cpu":
        return drop_rows_plain(fr, keep, n_keep)
    out = Frontier(*(torch.empty_like(x) for x in fr))
    kernels.drop_rows(keep, fr, out)
    return out
