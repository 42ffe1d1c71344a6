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


def factored_tables(gt_planes, ppfold, device=None) -> dict:
    """The reference Fingerprinter's pair-block tables (``_Gt_planes``, one
    i8 [stride_t, NP * chan * 4] table per message type) and its P-fold
    one-hot ``_ppfold`` (f32 [P, NP * NP]) -> the port's ``Gt_planes`` and
    ``fold_index`` ([P, NP]: the one-hot's column q * NP + PPERM[p, q] for
    each (p, q))."""
    oh = np.asarray(ppfold)
    P, cols = oh.shape
    NP = int(round(cols ** 0.5))
    rows, idx = np.nonzero(oh)  # row-major: each row's columns ascending in q
    if (NP * NP != cols or not np.all(oh[rows, idx] == 1)
            or not np.array_equal(np.bincount(rows, minlength=P), np.full(P, NP))):
        raise ValueError("ppfold is not a one-hot with NP ones per row")
    return dict(Gt_planes=[_t(g, device, torch.int8) for g in gt_planes],
                fold_index=_t(idx.reshape(P, NP), device, torch.int64))


def orbit_tables(psi, ppinv, qidx, W, fact, device=None) -> dict:
    """The reference Fingerprinter's ``_orbit_tables`` (orbit pruning:
    ``psi`` [P, F], ``ppinv`` [P, NP], ``qidx`` [S, S], the per-type
    pair-hash coefficients ``W`` (int32), ``fact`` [S]) -> the port's
    ``Fingerprinter.orbit_tables`` entries of the same names (int64 index
    tables, int32 ``W``)."""
    return dict(psi=_t(psi, device, torch.int64), ppinv=_t(ppinv, device, torch.int64),
                qidx=_t(qidx, device, torch.int64), W=[_t(w, device, torch.int32) for w in W],
                fact=_t(fact, device, torch.int64))


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
    """Decode tables, the pair-permutation table and, where the fingerprints
    fold messages through it (the monolithic form: P * M * 16 B <= 64 MiB),
    the permutation table of a message universe (either package's: both
    expose the same numpy attributes).  At S = 7 the [P, M] permutation
    table would take 680 MB, and the factored form does not use it."""
    names = ("typ", "src", "dst", "term", "lli", "llt", "pli", "plt", "entry", "lc", "succ")
    out = {n: _t(getattr(uni, n), device, torch.int64) for n in names}
    out["pair_perm_table"] = _t(uni.pair_perm_table, device, torch.int64)
    P = uni.pair_perm_table.shape[0]
    if P * 16 * uni.M <= (64 << 20):
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
