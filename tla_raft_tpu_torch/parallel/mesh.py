"""The device mesh of one process: a list of shard devices and the
collectives over it.

The reference's mesh is one process driving every local device (a
``jax.Mesh`` and ``shard_map``, tla_raft_tpu/parallel/sharded.py:77-110).
The port's is the same in PyTorch: shard ``d`` is a device in a list, its
tensors live there, and the host loop runs each shard's kernels in turn.
The collectives move tensors between the shards' devices:

* ``all_to_all`` -- the reference's tiled ``lax.all_to_all`` on axis 0:
  shard ``o`` receives row ``o`` of every shard's ``[D, ...]`` tiles,
  stacked in shard order (``dst[o][s] = src[s][o]``);
* ``gather_rows`` -- the same exchange of the live lanes alone: shard
  ``o`` receives the live prefix of row ``o`` of every shard's tile, in
  shard order (the deep sweep's routing, which holds only live lanes);
* ``all_gather`` -- every shard receives the concatenation of all
  shards' arrays, in shard order;
* ``psum`` / ``pmax`` are sums and maxima of per-shard scalars, which the
  checker reads in its one control fetch a level.

These copies stand in for the interconnect: data movement, not a kernel's
arithmetic.  When every shard shares a device (the tests' CPU mesh, and
``chip_smoke.py`` placing D shards on one card) ``all_to_all`` stacks the
tiles into one ``[D, D, ...]`` tensor and exchanges with one transposing
copy; across devices each tile is one copy (a peer copy between cards).
Each collective adds its copies to ``stats["exchange_copies"]``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def make_mesh(n: int, device=None, devices=None) -> list:
    """The D shard devices of an ``n``-shard mesh.

    ``devices`` (a list, devices may repeat) wins: the tests and
    ``chip_smoke.py`` place every shard on one device with it.  Else on
    ``cpu`` the n shards share the CPU (the counterpart of the reference's
    virtual CPU mesh), and on ``cuda`` (the default) the first n visible
    GPUs are the shards; with fewer visible, this raises the reference's
    ``ValueError`` (sharded.py:100-109)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {n}-shard mesh needs {n} devices, got {len(devs)}")
        for d in devs:
            resolve_device(d)
        return devs
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    visible = torch.cuda.device_count()
    if visible < n:
        names = [f"cuda:{i}" for i in range(visible)]
        raise ValueError(
            f"requested a {n}-device mesh but only {visible} device(s) are visible "
            f"({names}); pass devices=[...] to place several shards on one card, or "
            f"device='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def shared_device(devices: list):
    """The one device every shard is on, or None."""
    first = devices[0]
    return first if all(d == first for d in devices) else None


def all_to_all(tiles: list, devices: list, stats: dict) -> list:
    """``tiles[s]`` is shard s's ``[D, ...]`` send tile; returns ``out[o]``
    = ``[D, ...]`` with ``out[o][s] = tiles[s][o]``, on shard o's device."""
    D = len(tiles)
    if shared_device(devices) is not None:
        out = torch.stack(tiles).transpose(0, 1).contiguous()
        stats["exchange_copies"] = stats.get("exchange_copies", 0) + 2
        return list(out.unbind(0))
    out = []
    for o in range(D):
        dst = torch.empty((D, *tiles[0].shape[1:]), dtype=tiles[0].dtype, device=devices[o])
        for s in range(D):
            dst[s].copy_(tiles[s][o])
        out.append(dst)
    stats["exchange_copies"] = stats.get("exchange_copies", 0) + D * D
    return out


def gather_rows(tiles: list, counts, devices: list, stats: dict) -> list:
    """The all_to_all of the live lanes only: ``tiles[s]`` is shard s's
    ``[D, cap]`` send tile whose row o holds ``counts[s][o]`` live lanes
    first; returns ``out[o]``, the concatenation over s (shard order) of
    those lanes of row o, on shard o's device.  The reference's tiled
    all_to_all moves the whole rows, fill included; the lanes and their
    order are the same."""
    D = len(tiles)
    out = []
    for o in range(D):
        parts = [tiles[s][o, :int(counts[s][o])].to(devices[o]) for s in range(D)]
        out.append(torch.cat(parts))
    stats["exchange_copies"] = stats.get("exchange_copies", 0) + D
    return out


def all_gather(xs: list, devices: list, stats: dict) -> list:
    """Every shard's copy of the concatenation of ``xs`` (shard order)."""
    if shared_device(devices) is not None:
        cat = torch.cat(xs)
        stats["exchange_copies"] = stats.get("exchange_copies", 0) + 1
        return [cat] * len(xs)
    out = [torch.cat([x.to(d) for x in xs]) for d in devices]
    stats["exchange_copies"] = stats.get("exchange_copies", 0) + len(xs) * len(devices)
    return out
