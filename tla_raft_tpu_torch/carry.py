"""Carry the reference's tables and state across to the port.

Functions that turn arrays the JAX package produced — handed over as
numpy, so this module imports nothing of it — into the port's tensors on
a chosen device.  The tables play the part weights play elsewhere: the
port builds its own from the config with its copied code, and the tests
check that both routes give identical tensors.  A frontier and a hash
slab carried across let a run started by the reference continue here
(the fingerprint definition and the slab layout are shared bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.raft import Frontier, _CORE_FIELDS


def _t(a, device, dtype=None) -> torch.Tensor:
    device = resolve_device(device)
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def fingerprint_tables(c_planes, g_planes, device=None) -> dict:
    """The reference Fingerprinter's ``C_planes`` / ``G_planes`` (int8)."""
    return dict(C_planes=_t(c_planes, device, torch.int8), G_planes=_t(g_planes, device, torch.int8))


def mxu_tables(W, theta, slot_ok, BIG, col_off, device=None) -> dict:
    """The reference MXUTables: guard matrix, threshold, static slot mask,
    the per-slot constant block (as int64) and its column slices."""
    return dict(
        W=_t(W, device, torch.float32),
        theta=_t(theta, device, torch.float32),
        slot_ok=_t(slot_ok, device, torch.bool),
        BIG=_t(BIG, device, torch.int64),
        col_off={k: slice(v.start, v.stop) for k, v in col_off.items()},
    )


def slot_layout(slot_family, slot_coords, device=None) -> dict:
    """The reference slot grid as the port's [K, 6] slot table."""
    tab = np.concatenate(
        [np.asarray(slot_family, np.int32)[:, None], np.asarray(slot_coords, np.int32)], axis=1
    )
    return dict(slot_table=_t(tab, device, torch.int32), K=int(tab.shape[0]))


def universe_tables(uni, device=None) -> dict:
    """Decode tables and the permutation table of a message universe
    (either package's: both expose the same numpy attributes)."""
    names = ("typ", "src", "dst", "term", "lli", "llt", "pli", "plt", "entry", "lc", "succ")
    out = {n: _t(getattr(uni, n), device, torch.int64) for n in names}
    out["perm_table"] = _t(uni.perm_table, device, torch.int64)
    return out


def frontier(fields: dict, device=None) -> Frontier:
    """A reference Frontier as a dict of numpy arrays (``msg_ids`` int16
    or int32, the 13 core fields uint8) -> the port's Frontier."""
    core = {f: _t(fields[f], device, torch.uint8) for f in _CORE_FIELDS}
    ids = np.asarray(fields["msg_ids"])
    return Frontier(msg_ids=_t(ids, device), **core)


def slab(slab_u64, device=None) -> torch.Tensor:
    """A reference hash slab (uint64) -> int64 bit patterns."""
    return _t(np.asarray(slab_u64, np.uint64).view(np.int64), device)


def slab_to_numpy(slab_i64: torch.Tensor) -> np.ndarray:
    """The port's slab back to the reference's uint64 layout."""
    return slab_i64.cpu().numpy().view(np.uint64)
