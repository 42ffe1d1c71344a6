"""The spill sieve: a blocked bloom filter over spilled fingerprints.

The port of ``tla_raft_tpu/ops/sieve.py``: the hash pipeline
``word_and_mask`` (the reference's ``_word_and_mask`` / ``_mix`` /
``_SALT``), one 64-bit block word per key with ``K_BITS`` = 4 bit
positions taken from disjoint 6-bit fields of a second mix.  Blooms have
no false negatives, so a level whose fresh lanes score zero hits provably
revisits nothing that was spilled.

* ``SpillSieve`` (sieve.py:124), host-side numpy: the filter the tiered
  store (store/tiered.py) fills at every demotion; ``contains`` is the
  host mirror the device probe is held against.  ``sieve_words_for``
  (:95) sizes it from the hot tier's device budget.
* ``probe`` (``probe_impl`` :194): kernel B13 (csrc/sieve.cu) on the card,
  ``probe_plain`` on the CPU.  The fused level probes its fresh lanes
  every level (engine/megakernel.py), bounded by its device n_new, and
  counts the hits into its control words: against the 1-word all-zero
  sentinel ``empty_sieve()`` while nothing is spilled (every lane misses),
  and against the device copy of the spill sieve's words after the first
  demotion (engine/bfs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..u64 import SENT, srl, to_i64

K_BITS = 4
_SALT = to_i64(0x9E3779B97F4A7C15)
_C1 = to_i64(0xBF58476D1CE4E5B9)
_C2 = to_i64(0x94D9ECA592EAF335)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The sieve's 64-bit mix on int64 bits (its second constant differs
    from the slab's ``mix64``)."""
    x = (x ^ srl(x, 30)) * _C1
    x = (x ^ srl(x, 27)) * _C2
    return x ^ srl(x, 31)


def word_and_mask(fps: torch.Tensor):
    """(word hash, bit mask) per fingerprint, as int64 bit patterns."""
    h1 = _mix(fps)
    h2 = _mix(fps ^ _SALT)
    mask = torch.zeros_like(h2)
    one = torch.ones_like(h2)
    for i in range(K_BITS):
        mask = mask | (one << (srl(h2, 6 * i) & 63))
    return h1, mask


def probe_plain(words: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Plain twin of B13: hit bool[n] per lane of ``fps`` against the
    filter ``words`` (int64[M], M a power of two)."""
    m = words.shape[0]
    if m & (m - 1):
        raise ValueError(f"sieve words must be a power of two, got {m}")
    h1, mask = word_and_mask(fps)
    return (words[h1 & (m - 1)] & mask) == mask


def probe(words: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """hit bool[n]: kernel B13 on the card, the plain twin on the CPU."""
    if fps.device.type == "cpu":
        return probe_plain(words, fps)
    hit = torch.empty(fps.shape, dtype=torch.bool, device=fps.device)
    kernels.sieve_probe(words, fps, hit=hit)
    return hit


def count_hits(words: torch.Tensor, fps: torch.Tensor, count: torch.Tensor,
               live: torch.Tensor | None = None) -> None:
    """``count`` (int64 0-d) += the live lanes (fp != SENT) that hit; with
    ``live`` (int64 0-d, the level's n_new) only the first ``live`` lanes
    are probed."""
    if fps.device.type == "cpu":
        n = fps.shape[0] if live is None else max(0, min(fps.shape[0], int(live)))
        count += (probe_plain(words, fps[:n]) & (fps[:n] != SENT)).sum()
    else:
        kernels.sieve_probe(words, fps, count=count, cnt=live)


def empty_sieve(device) -> torch.Tensor:
    """The 1-word all-miss sentinel the fused level probes while nothing
    is spilled."""
    return torch.zeros((1,), dtype=torch.int64, device=device)


# -- the host filter (numpy uint64) ---------------------------------------------


def _word_and_mask_np(fps: np.ndarray):
    """(word hash, bit mask) per fingerprint, numpy uint64: the same
    pipeline as ``word_and_mask``."""
    u = np.uint64
    fps = np.asarray(fps, u)

    def mix(x):
        with np.errstate(over="ignore"):
            x = (x ^ (x >> u(30))) * u(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> u(27))) * u(0x94D9ECA592EAF335)
        return x ^ (x >> u(31))

    h1 = mix(fps)
    h2 = mix(fps ^ u(0x9E3779B97F4A7C15))
    mask = np.zeros_like(h2)
    for i in range(K_BITS):
        mask |= u(1) << ((h2 >> u(6 * i)) & u(63))
    return h1, mask


def sieve_words_for(dev_bytes: int) -> int:
    """Filter words (a power of two) for a hot-tier device budget: 1/8 of
    the budget, at least 8 KiB."""
    words = max(max(int(dev_bytes) >> 3, 1 << 13) // 8, 1)
    return 1 << max(words.bit_length() - 1, 0)


class SpillSieve:
    """Host-side blocked bloom over spilled fingerprints.  ``words`` is
    the filter image the engine copies to the device; ``version`` rises
    with every add, so the device copy is refreshed exactly when the
    image changed."""

    __slots__ = ("words", "version", "n_added")

    def __init__(self, n_words: int):
        if n_words & (n_words - 1):
            raise ValueError(f"sieve words must be a power of two, got {n_words}")
        self.words = np.zeros(n_words, np.uint64)
        self.version = 0
        self.n_added = 0

    def _index(self, fps):
        w, m = _word_and_mask_np(fps)
        return (w & np.uint64(len(self.words) - 1)).astype(np.int64), m

    def add(self, fps: np.ndarray) -> None:
        fps = np.asarray(fps, np.uint64)
        if not len(fps):
            return
        idx, m = self._index(fps)
        np.bitwise_or.at(self.words, idx, m)
        self.n_added += len(fps)
        self.version += 1

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """The host mirror of the device probe: hit bool[n]."""
        fps = np.asarray(fps, np.uint64)
        if not len(fps):
            return np.zeros(0, bool)
        idx, m = self._index(fps)
        return (self.words[idx] & m) == m

