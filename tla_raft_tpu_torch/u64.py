"""Unsigned 64- and 32-bit arithmetic on int64 tensors.

PyTorch has no usable unsigned 64-bit type: ``>>`` is missing for
uint64/uint32, uint64 ``min``/``amin``/``scatter_reduce(amin)``/``>`` are
missing, and ``int8 @ int8`` wraps in int8.  The port therefore keeps
every u64 (fingerprints, hash slab) as int64 holding the same bit
pattern, and every u32 as int64 masked to its low 32 bits, with the
unsigned operations spelled out here, once:

* logical shift right = arithmetic shift, then a mask;
* unsigned order = signed order after XOR with ``1 << 63``;
* ``SENT`` (the all-ones u64 marker) is ``-1``;
* multiplication wraps modulo 2^64 in int64, which is the u64 product's
  bit pattern; u32 products are masked back to 32 bits.

``mix64``, ``_mix32``, ``_eff_u32`` and ``_combine_planes_u32`` are the
torch forms of ``tla_raft_tpu/ops/hashstore.py`` and
``tla_raft_tpu/ops/fingerprint.py``; ``_u32_to_i8_planes`` and the
``*_np`` helpers are the numpy forms the table-building code uses.
"""

from __future__ import annotations

import numpy as np
import torch

SENT = -1  # u64 0xFFFF_FFFF_FFFF_FFFF as int64
SIGN = -(1 << 63)  # u64 1 << 63 as int64
MASK32 = 0xFFFFFFFF


def to_i64(u: int) -> int:
    """A Python int in [0, 2^64) -> the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= (1 << 63) else u


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of an int64 holding a u64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ukey(x: torch.Tensor) -> torch.Tensor:
    """A signed key whose order is the unsigned order of ``x``."""
    return x ^ SIGN


def umin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unsigned minimum along ``dim``."""
    return ukey(ukey(x).amin(dim))


_C1 = to_i64(0xBF58476D1CE4E5B9)
_C2 = to_i64(0x94D049BB133111EB)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (ops/hashstore.py ``mix64``) on int64 bits."""
    x = (x ^ srl(x, 30)) * _C1
    x = (x ^ srl(x, 27)) * _C2
    return x ^ srl(x, 31)


def mix64_np(x: np.ndarray) -> np.ndarray:
    """numpy uint64 form (host slab rebuilds)."""
    u = np.uint64
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> u(30))) * u(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> u(27))) * u(0x94D049BB133111EB)
    return x ^ (x >> u(31))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style finalizer on u32 values held in int64."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    u = np.uint32
    x = np.asarray(x).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> u(16))
        x = x * u(0x7FEB352D)
        x = x ^ (x >> u(15))
        x = x * u(0x846CA68B)
    return x ^ (x >> u(16))


def _eff_u32(x: torch.Tensor) -> torch.Tensor:
    """The signed-byte-plane linearization of a u32 coefficient."""
    return (
        x
        - (((x >> 7) & 1) << 8)
        - (((x >> 15) & 1) << 16)
        - (((x >> 23) & 1) << 24)
    ) & MASK32


def _u32_to_i8_planes(c: np.ndarray) -> np.ndarray:
    """u32[..., n] -> i8[..., n, 4] signed byte planes (LSB first)."""
    b = np.stack([(c >> (8 * k)) & 0xFF for k in range(4)], axis=-1)
    return b.astype(np.uint8).astype(np.int8)


def _combine_planes_u32(planes: torch.Tensor) -> torch.Tensor:
    """Integer plane sums [..., 4] -> u32 hash [...] held in int64."""
    p = planes.to(torch.int64)
    h = p[..., 0] + (p[..., 1] << 8) + (p[..., 2] << 16) + (p[..., 3] << 24)
    return h & MASK32

