"""The spill sieve's device probe (kernel B13): a blocked bloom filter.

The port of the device half of ``tla_raft_tpu/ops/sieve.py``: the hash
pipeline ``word_and_mask`` (the reference's ``_word_and_mask`` / ``_mix`` /
``_SALT``) and ``probe`` (``probe_impl``), one 64-bit block word per key
with ``K_BITS`` = 4 bit positions taken from disjoint 6-bit fields of a
second mix.  Blooms have no false negatives, so a level whose fresh lanes
score zero hits provably revisits nothing that was spilled.

The fused level probes its fresh lanes every level (engine/megakernel.py)
and counts the hits into its control words.  The tiered store that would
fill the filter is not ported yet, so the filter is always
``empty_sieve()``, the 1-word all-zero sentinel on which every lane
misses, as in the reference whenever nothing has been spilled.  The
host-side ``SpillSieve`` waits for that store.

``probe`` is kernel B13 (csrc/sieve.cu) on the card and ``probe_plain`` on
the CPU.
"""

from __future__ import annotations

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


def count_hits(words: torch.Tensor, fps: torch.Tensor, count: torch.Tensor) -> None:
    """``count`` (int64 0-d) += the live lanes (fp != SENT) that hit."""
    if fps.device.type == "cpu":
        count += (probe_plain(words, fps) & (fps != SENT)).sum()
    else:
        kernels.sieve_probe(words, fps, count=count)


def empty_sieve(device) -> torch.Tensor:
    """The 1-word all-miss sentinel the fused level probes while nothing
    is spilled."""
    return torch.zeros((1,), dtype=torch.int64, device=device)
