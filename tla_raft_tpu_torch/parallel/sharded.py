"""Mesh-parallel BFS: the port of ``tla_raft_tpu/parallel/sharded.py``.

The frontier is sharded over D shard devices (parallel/mesh.py: one
process drives every shard, as the reference's ``shard_map`` mesh does).
Each shard expands its own parents; the candidates' fingerprints are
exchanged for the dedup; the states come out owner-sharded by ``fp % D``.
Three modes, as in the reference:

* ``all_to_all`` (the default): the visited set is hash-sharded, owner
  ``o`` holding the fingerprints ``fp % D == o`` in a hash-slab shard
  (K4).  Per level, per shard (``_expand_local`` :420): K1 ``guards``
  chunk by chunk, ``compact`` of the valid (parent, slot) lanes into
  ``cap_x``, K2 ``materialize``, K3 ``fingerprint`` and ``group_unique``
  (the local pre-dedup: the min (fp_full, payload) lane of each fp_view,
  fp_view-ascending).  Then (:652-745) ``route`` writes each shard's
  ``[D, cap_r]`` send rows of (fp_view, fp_full, payload), the exchange
  moves them, each owner runs K4 over its ``D * cap_r`` received lanes in
  receive order, the verdicts go back, ``route_back`` maps them to the
  origin's lanes, ``route`` groups the winners' payloads by owner into
  ``[D, cap_w]`` rows, K2 materializes them at the origin and the rows
  travel to their owner, which concatenates them in (origin, row) order
  and scans the invariants (``inv_scan``).
* ``all_gather`` (:615-650): each shard's pre-deduped lanes not in the
  replicated sorted store (``sorted_member``) are gathered, one
  ``group_unique`` over the ``D * cap_x`` lanes picks the level's winners,
  each origin keeps those it generated (``compact``), K2, ``inv_scan``,
  and ``merge_sorted`` folds the new fingerprints into the store, trimmed
  by the host with the forecast floor (:3105-3123).  No ``route`` runs.
  Children stay on their parents' shard, as in the reference.
* host-store (``host_store_dir``; :747-1023): the ``all_to_all`` level with
  the visited filter on the host: one ``native.HostFPStore`` per owner
  under ``shard_OO/``; the host lexsorts each owner's received lanes,
  inserts the representatives, and the verdicts go back to the shards.
  The owners' reads go through one ``AsyncFetchWindow`` of D groups (all
  started, then completed in owner order; the reference's
  ``DeferredFetch``, :933).

Payloads are global: ``(dev * cap_f + row) * K + slot``, ``cap_f`` the
frontier block of the level (the ``cap_x`` the previous level ran with,
1 at the root), so the min (fp_full, payload) representative, the counts
and the counterexample traces are the reference's for any D.  The port's
frontier rows are deflated (sparse message ids), and a shard holds only
its live rows; the block size is kept for the payloads and the traces.

Growth as in the reference's run loop (:2766-3195): ``vcap`` x4 before a
level past ``D * vcap / 2`` and on a slab overflow (rebuilt on the host by
``rebuild_np``), ``cap_x`` x2 on a candidate, routing or shipping overflow,
the host-store mode's ``cap_w`` boost for one level, at most 8 grows a
level; a level that grows is redone from its parents (the slab shards are
put back first).  ``maybe_presize`` sizes ``cap_x`` and ``vcap`` from the
forecast once enough levels are seen.  A cap_m overflow of a candidate
(the port's sparse message ids) widens the frontier and redoes the level.

The sharded deep sweep (``deep=True``, :996-2330; ``run_deep``): each
shard holds the states it owns (fp % D) as ``seg_rows``-row segments, and
a level runs segment round by segment round.  Phase 1 (:1075) expands a
round's segment on every shard (K1, ``compact``, K2, K3, ``group_unique``),
drops the candidates the shard's sieve proves visited (``hs_probe`` on the
hash sieve, ``sorted_member`` on the sorted one) and routes (fp_view,
fp_full) to the owners (``route``; payloads stay at the origin).  The
finalize (:1129) is the owner's exact level dedup over every round it
received (``group_unique``, payload = the receive index: the reference's
receive-order tie-break) and the delta-packed stream of its unique
fingerprints (``pack_deltas``); one prefix fetch, the D store inserts in a
thread pool, the verdict bits back on the received lanes
(``deep_verdict``), then phase 2 (:1254) per round: ``route_back`` and the
winners' grouping (``route``), K2 at the origin, and the next level's
segments (``deep_repack``, round-major), ``inv_scan``.  At the level's end
each round's candidates go into the origin's sieve (``insert_only``, or
``sieve_merge`` on the sorted sieve).  A shard holds only live rows and
live received lanes; the reference's capacities (cap_x, cap_w, cap_c, the
[Rq, D, cap_r] receive stack) are kept as numbers for the growth rules,
the ledger and the payloads.

Refused, with the ROADMAP item: the mesh's delta log (``checkpoint_dir`` /
``resume_from``, deep or not), ``canon="expand"``, ``all_to_all`` over
sorted shards (``use_hashstore=False`` or ``TLA_RAFT_HASHSTORE=0``) and a
watchdog (device loss and hangs, A.1).
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels
from .. import resilience
from ..config import RaftConfig
from ..device import fetch
from ..engine import forecast
from ..engine import pipeline as gpipe
from ..engine.bfs import (BIG, CheckResult, TorchChecker, compact_payloads,
                          compact_payloads_plain, group_unique, member_plain, merge_sorted)
from ..models.raft import Frontier, init_batch
from ..ops import hashstore
from ..ops.hashstore import SENT_U64, insert_np, probe_and_insert, rebuild_np
from ..resilience import faults
from ..resilience.integrity import SkewMeter, occupancy_check, reconcile
from ..u64 import SENT, srl, ukey
from . import mesh as meshlib
from .exchange import ExchangeMeter, pack_fp_deltas, packed_quantum, unpack_fp_deltas

I64 = torch.int64

CHECKPOINT_REFUSAL = ("mesh checkpoints (the mdelta log, its resume and the elastic "
                      "re-shard) are not ported yet (ROADMAP A.7)")
SORTED_REFUSAL = ("exchange='all_to_all' over sorted visited shards (use_hashstore=False, "
                  "--no-hashstore, TLA_RAFT_HASHSTORE=0) is not ported yet (ROADMAP A.7)")
CANON_REFUSAL = "canon='expand' on the mesh is not ported yet (ROADMAP A.7)"


# -- B15's routing: the kernels' callers and their plain twins ------------------------


def owner_of_fp(v: torch.Tensor, D: int) -> torch.Tensor:
    """``fp % D`` (unsigned) of int64-held u64 fingerprints, SENT -> D."""
    u = (srl(v, 1) % D * 2 + (v & 1)) % D
    return torch.where(v == SENT, torch.full_like(u, D), u)


def route_plain(cols, fills, D: int, cap: int, owner=None, mask=None):
    """Plain twin of ``kernels.route``: the reference's routing lines
    (:659-684, :506-518) with a stable argsort, a bincount and gathers."""
    v = cols[0]
    n, dev = v.shape[0], v.device
    if owner is None:
        g = owner_of_fp(v, D)
    else:
        g = torch.where(mask, owner.to(I64), torch.full((n,), D, dtype=I64, device=dev))
    order = torch.argsort(g, stable=True)
    counts = torch.bincount(g, minlength=D + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty((n,), dtype=I64, device=dev)
    rank[order] = torch.arange(n, dtype=I64, device=dev) - starts[g[order]]
    slot = torch.arange(cap, dtype=I64, device=dev)[None, :]
    in_row = slot < counts[:D, None]
    idx = (starts[:D, None] + slot).clamp(0, max(n - 1, 0))
    rows = []
    for c, fill in zip(cols, fills):
        if n == 0:
            rows.append(torch.full((D, cap), fill, dtype=I64, device=dev))
            continue
        rows.append(torch.where(in_row, c[order][idx], torch.full_like(idx, fill)))
    return rows, counts, g.to(torch.int32), rank, counts[:D].max() > cap


def route(cols, fills, D: int, cap: int, owner=None, mask=None):
    """(rows, counts, lane_owner, lane_rank, overflow): the ``route``
    kernel on the card, the plain twin on the CPU."""
    if cols[0].device.type == "cpu":
        return route_plain(cols, fills, D, cap, owner, mask)
    return kernels.route(cols, fills, D, cap, owner=owner, mask=mask)


def route_back_plain(back, lane_owner, lane_rank, D: int, cap: int):
    """Plain twin of ``kernels.route_back``: ``back[owner, rank] &
    ok_lane`` (:725-726)."""
    g = lane_owner.to(I64)
    ok = (g < D) & (lane_rank < cap)
    return ok & back[g.clamp(max=D - 1), lane_rank.clamp(0, cap - 1)]


def route_back(back, lane_owner, lane_rank, D: int, cap: int):
    """The origin's winner mask: the ``route_back`` kernel on the card, the
    plain twin on the CPU."""
    if back.device.type == "cpu":
        return route_back_plain(back, lane_owner, lane_rank, D, cap)
    return kernels.route_back(back, lane_owner, lane_rank, D, cap)


def _compact_lanes(flags: torch.Tensor, base: int, cap: int):
    """The flagged lanes' payloads ``base + lane`` packed to ``cap`` lanes
    in lane order, and the number of flagged lanes (0-d)."""
    if flags.device.type == "cpu":
        pay = base + torch.arange(flags.shape[0], dtype=I64)
        out, _lane, _ovf = compact_payloads_plain(flags, pay, cap)
        return out, flags.sum()
    out, _ob, _lane, total = kernels.compact(flags, None, -1, cap, iota_base=base)
    return out, total


def _member(visited: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    if fps.device.type == "cpu":
        return member_plain(visited, fps)
    return kernels.sorted_member(visited, fps)


# -- B15's deep bodies: the kernels' callers and their plain twins --------------------


def deep_verdict_plain(bits, gp, n_u: int, n_recv: int):
    """Plain twin of ``kernels.deep_verdict``: win[gp[i]] = bit i of
    ``bits`` (LSB first) for i < n_u, False on every other lane."""
    idx = torch.arange(min(n_u, 8 * bits.shape[0]), dtype=I64, device=gp.device)
    win = torch.zeros((n_recv,), dtype=torch.bool, device=gp.device)
    win[gp[:idx.shape[0]]] = ((bits.to(I64)[idx >> 3] >> (idx & 7)) & 1).bool()
    return win


def deep_verdict(bits, gp, n_u, n_recv: int):
    """The owner's is-new bits on its received lanes (``_deep_verdict_body``,
    :1159): the ``deep_verdict`` kernel on the card, the twin on the CPU."""
    if gp.device.type == "cpu":
        return deep_verdict_plain(bits, gp, int(n_u), n_recv)
    return kernels.deep_verdict(bits, gp, n_u, n_recv)


def sieve_merge_plain(sieve, cv):
    """Plain twin of ``kernels.sieve_merge`` (:1322-1339): the sorted
    concatenation, first of each run, SENT dropped, the first scap kept;
    the overflow when more were unique."""
    scap = sieve.shape[0]
    merged = torch.cat([sieve, cv])
    merged = merged[torch.argsort(ukey(merged), stable=True)]
    first = torch.ones_like(merged, dtype=torch.bool)
    first[1:] = merged[1:] != merged[:-1]
    keep = merged[first & (merged != SENT)]
    out = torch.full((scap,), SENT, dtype=I64, device=sieve.device)
    m = min(scap, keep.shape[0])
    out[:m] = keep[:m]
    return out, torch.tensor(keep.shape[0] > scap, device=sieve.device)


def sieve_merge(sieve, cv):
    """The sorted sieve's update by one round's candidates: the
    ``sieve_merge`` kernel on the card, the twin on the CPU."""
    if sieve.device.type == "cpu":
        return sieve_merge_plain(sieve, cv)
    return kernels.sieve_merge(sieve, cv)


def repack_plain(sources: list, segs):
    """Plain twin of ``kernels.deep_repack``: each field's blocks (source,
    first row, rows) concatenated in block order."""
    return tuple(torch.cat([sources[s][f][r:r + n] for s, r, n in segs])
                 for f in range(len(sources[0])))


def repack(sources: list, segs):
    """The rounds' shipped children (and gpidx, slots) into one owner's
    next segments, round-major (``_deep_repack_body``, :1283): ``segs``
    lists the blocks (source, first row, rows) in output order.  The
    ``deep_repack`` kernel on the card, the twin on the CPU."""
    if sources[0][0].device.type == "cpu":
        return repack_plain(sources, segs)
    return kernels.deep_repack(sources, segs)


def _rows(fr: Frontier, a: int, b: int) -> Frontier:
    return Frontier(*(x[a:b] for x in fr))


def _cat_frontiers(parts: list, like: Frontier, device) -> Frontier:
    if not parts:
        return Frontier(*(x[:0].to(device) for x in like))
    return Frontier(*(torch.cat([getattr(p, f).to(device) for p in parts])
                      for f in Frontier._fields))


class ShardedChecker:
    """The model checker over a D-shard mesh (``make_mesh``).

    Parameters (the reference's, sharded.py:249): ``cap_x`` per-shard
    candidate lanes a level (grows), ``vcap`` per-shard slab slots
    (all_to_all; grows), ``exchange`` "all_to_all" or "all_gather",
    ``progress`` a per-level callback, ``canon`` "late" only,
    ``host_store_dir`` the per-owner external stores, ``cap_x_max`` a
    ceiling for the presize forecast, ``use_hashstore`` (None:
    ``TLA_RAFT_HASHSTORE``; on the deep sweep it picks the sieve: the hash
    slab or the sorted array), ``use_mxu`` (None: ``TLA_RAFT_MXU``: off
    takes the legacy per-lane kernels), ``warm_bytes`` the stores' RAM
    budget split across the D owners.  The deep sweep: ``deep``,
    ``seg_rows`` (rows a segment, even), ``sieve`` (the pre-routing sieve),
    ``compress`` (the delta-packed fetch), ``scap`` and ``scap_max`` (the
    sieve's capacity and its ceiling).  ``pipeline`` and
    ``pipeline_window`` (None: ``TLA_RAFT_PIPELINE`` and
    ``TLA_RAFT_PIPELINE_WINDOW``): the host-store mesh's filter reads go
    through an async window, the deep sweep's prefix and trace reads
    through ``DeferredFetch``; off (or a window below 1), every read is
    serial.  The counts are the same either way.
    ``chunk`` (the port's): parents per guard launch.
    """

    def __init__(self, cfg: RaftConfig, mesh: list, cap_x: int = 4096, vcap: int = 1 << 16,
                 exchange: str = "all_to_all", progress=None, canon: str = "late",
                 host_store_dir: str | None = None, cap_x_max: int | None = None,
                 deep: bool = False, seg_rows: int = 1 << 15, sieve: bool = True,
                 compress: bool = True, scap: int = 1 << 12, scap_max: int = 1 << 22,
                 use_hashstore: bool | None = None, pipeline: bool | None = None,
                 pipeline_window: int | None = None, use_mxu: bool | None = None,
                 watchdog=None, warm_bytes: int | None = None, chunk: int | None = None):
        if exchange not in ("all_to_all", "all_gather"):
            raise ValueError(f"exchange must be 'all_to_all' or 'all_gather', got {exchange!r}")
        if canon not in ("late", "expand"):
            raise ValueError(f"canon must be 'late' or 'expand', got {canon!r}")
        if deep:
            if host_store_dir is None:
                raise ValueError("deep=True requires host_store_dir (the sharded deep sweep "
                                 "filters through per-owner external stores)")
            if canon != "late":
                raise ValueError("deep=True requires canon='late'")
            if exchange != "all_to_all":
                raise ValueError("deep=True requires exchange='all_to_all'")
            if seg_rows % 2:
                raise ValueError("seg_rows must be even")
        if host_store_dir is not None and exchange != "all_to_all":
            raise ValueError("host_store_dir requires exchange='all_to_all' (the store is "
                             "owner-sharded by fp % D)")
        if canon != "late":
            raise ValueError(CANON_REFUSAL)
        if use_hashstore is None:
            use_hashstore = hashstore.enabled_by_env()
        if exchange == "all_to_all" and host_store_dir is None and not use_hashstore:
            raise ValueError(SORTED_REFUSAL)
        if watchdog is not None:
            raise ValueError("the per-level watchdog (device loss and hangs) is not ported "
                             "yet (ROADMAP A.1)")
        self.cfg = cfg
        if pipeline is None:
            pipeline = gpipe.enabled_by_env()
        if pipeline_window is None:
            pipeline_window = gpipe.window_from_env()
        self.pipeline_window = int(pipeline_window)
        self.pipeline = bool(pipeline) and self.pipeline_window >= 1
        self.devices = [torch.device(d) for d in mesh]
        self.D = len(self.devices)
        self.exchange = exchange
        self.canon = canon
        self.host_store_dir = host_store_dir
        self.host_stores = None  # built in run()
        self.warm_bytes = warm_bytes
        # the resident all_to_all's slab shards; on the deep sweep, the sieve's form
        self.use_hashstore = (bool(use_hashstore) if deep else
                              exchange == "all_to_all" and host_store_dir is None)
        self.deep = deep
        self.seg_rows = int(seg_rows)
        self.sieve = sieve
        self.compress = compress
        self.scap = int(scap)
        self.scap_max = int(scap_max)
        self._cap_c_boost = 1  # the deep phase 2's owner block grows alone
        self.peak_dev_rows = 0
        self.cap_x = int(cap_x)
        self.cap_x_max = cap_x_max
        self.vcap = int(vcap)
        self.progress = progress
        # one set of tables and kernels a device (shards on one device share it)
        self._kits: dict = {}
        for dev in self.devices:
            if str(dev) not in self._kits:
                self._kits[str(dev)] = TorchChecker(
                    cfg, device=dev, chunk=chunk, megakernel=False, orbit=False,
                    use_mxu=use_mxu, use_hashstore=True, store_bytes=0)
        self.kit0 = self._kits[str(self.devices[0])]
        self.use_mxu = self.kit0.use_mxu
        self.K = self.kit0.K
        self.chunk = self.kit0.chunk
        self.reactive_grows = 0
        self._cap_w_boost = 1
        self.skew = SkewMeter(self.D)
        self.meter = ExchangeMeter()
        self.stats: dict = {}  # the collectives' copies (mesh.py)
        self.level_log: list = []  # per level: seconds, copies, rows a shard, capacities

    # -- capacities ------------------------------------------------------------

    @property
    def cap_r(self) -> int:
        """Routing lanes per (origin, owner) pair: cap_x, worst-case exact
        (an owner's share never exceeds the origin's candidates; :2257)."""
        return self.cap_x

    @property
    def cap_w(self) -> int:
        """Shipped rows per (origin, owner) pair (:575)."""
        return max(256, self.cap_x // 2) * self._cap_w_boost

    def _store_budget_entries(self) -> int:
        """Per-owner in-RAM entries of the external stores: --warm-bytes
        split across the D owners (0: the native default; :396)."""
        if not self.warm_bytes:
            return 0
        return max(int(self.warm_bytes) // 8 // self.D, 1)

    def _kit(self, d: int) -> TorchChecker:
        return self._kits[str(self.devices[d])]

    def _grow_cap_m(self, frontiers: list) -> list:
        """Widen every shard's message-id lists (a candidate overflowed
        cap_m): every device's tables take the new width."""
        for kit in self._kits.values():
            kit._grow_cap_m(frontiers[0])
        return [self._kit(d).widen(fr) for d, fr in enumerate(frontiers)]

    def _reactive(self, depth: int, what: str) -> None:
        self.reactive_grows += 1
        print(f"[mesh] REACTIVE grow at level {depth + 1}: {what} (cap_x={self.cap_x}, "
              f"cap_r={self.cap_r}, vcap={self.vcap})", file=sys.stderr)

    # -- one level: the shards' expand and pre-dedup ----------------------------------

    def _expand_local_seg(self, d: int, fr: Frontier, a: int, b: int, base_pay: int) -> tuple:
        """K1 chunk by chunk over rows [a, b) of shard d's frontier (all of
        it, or a deep sweep's segment: ``_expand_local_seg`` :1029 up to the
        compaction), then the valid lanes' payloads (``base_pay`` + row * K
        + slot, rows from a) compacted into cap_x: (payloads, the valid-lane
        total, the first aborting row or BIG, the slots' mult), device
        tensors."""
        kit, dev, K = self._kit(d), fr.voted_for.device, self.K
        flags = []
        mult = torch.zeros((K,), dtype=I64, device=dev)
        abort_at = torch.full((), BIG, dtype=I64, device=dev)
        for start in range(a, b, self.chunk):
            part = _rows(fr, start, min(start + self.chunk, b))
            valid, m, ab = kit.guards(kit.inflate(part))
            flags.append(valid.reshape(-1))
            mult = mult + m.to(I64).sum(0)
            first = start + torch.argmax(ab.to(torch.int32)).to(I64)
            abort_at = torch.minimum(abort_at, torch.where(ab.any(), first,
                                                           torch.full_like(first, BIG)))
        flag = torch.cat(flags) if flags else torch.zeros((0,), dtype=torch.bool, device=dev)
        cp, total = _compact_lanes(flag, base_pay, self.cap_x)
        return cp, total, abort_at, mult

    def _expand_all(self, exp: list, what: str) -> np.ndarray:
        """One read of the shards' ``_expand_local_seg`` controls: i64[2D + K]
        of the valid-lane totals, the first aborting rows and the summed
        per-slot multiplicities."""
        dev0 = self.devices[0]
        (ctl,) = fetch(torch.cat([torch.stack([e[1].to(dev0) for e in exp]),
                                  torch.stack([e[2].to(dev0) for e in exp]),
                                  sum(e[3].to(dev0) for e in exp)]), what=what)
        return ctl.copy()

    def _expand_guards(self, frontiers: list, n_f: list, cap_f: int) -> dict:
        """Per shard: K1 chunk by chunk over its live parents, then the valid
        (parent, slot) lanes' global payloads compacted into cap_x lanes.
        One read: each shard's valid-lane total, its first aborting parent,
        the level's per-slot multiplicities."""
        D, K = self.D, self.K
        exp = [self._expand_local_seg(d, fr, 0, n_f[d], d * cap_f * K)
               for d, fr in enumerate(frontiers)]
        ctl = self._expand_all(exp, "mesh_expand")
        return dict(cp=[e[0] for e in exp], totals=ctl[:D], abort_at=ctl[D:2 * D],
                    mult=ctl[2 * D:])

    def _pre_dedup(self, frontiers: list, cps: list, totals, cap_f: int) -> tuple:
        """Per shard: K2 over the live candidate lanes, K3, then the local
        pre-dedup (``group_unique``).  Returns the per-shard (gv, gf, gp) and
        a device control i64[D, 2] of (cap_m overflow, unique candidates),
        which each mode reads with its next control read: a candidate whose
        child overflowed cap_m has a void fingerprint, so the level is redone
        wider before anything it wrote is kept."""
        K = self.K
        outs, ctl = [], []
        for d, fr in enumerate(frontiers):
            kit, dev = self._kit(d), self.devices[d]
            n_live = int(min(totals[d], self.cap_x))
            if n_live == 0:
                empty = torch.full((0,), SENT, dtype=I64, device=dev)
                outs.append((empty, empty, empty))
                ctl.append(torch.zeros((2,), dtype=I64, device=self.devices[0]))
                continue
            cp = cps[d][:n_live]
            kids, _added, ovf = kit.materialize(fr, torch.div(cp, K, rounding_mode="floor")
                                                - d * cap_f, cp % K)
            fv, ff = kit.fpr.state_fingerprints(kids)
            del kids
            n_u, gv, gf, gp = group_unique(fv, ff, cp)
            outs.append((gv, gf, gp))
            ctl.append(torch.stack([ovf.any().to(I64), n_u.to(I64)]).to(self.devices[0]))
        return outs, torch.stack(ctl)

    def _route_candidates(self, lanes: list):
        """Per shard: ``route`` the pre-deduped lanes to their owners'
        ``[D, cap_r]`` send rows; then the exchange.  Returns (the owners'
        received rows per column, each origin's (lane owner, lane rank), the
        routing's counts i64[D + 1] per origin)."""
        D, cap_r = self.D, self.cap_r
        sends = [[], [], []]
        lane_meta, counts = [], []
        for gv, gf, gp in lanes:
            rows, cnt, lane_owner, lane_rank, _ovf = route(
                [gv, gf, gp], [SENT, SENT, -1], D, cap_r)
            for k in range(3):
                sends[k].append(rows[k])
            lane_meta.append((lane_owner, lane_rank))
            counts.append(cnt)
        recv = [meshlib.all_to_all(sends[k], self.devices, self.stats) for k in range(3)]
        return recv, lane_meta, counts

    def _winners(self, back: list, lanes: list, lane_meta: list) -> list:
        """Per origin: ``route_back`` the returned verdicts to its lanes, then
        ``route`` its winners' payloads to their owners' ``[D, cap_w]``
        rows.  Returns per origin (rows i64[D, cap_w], counts i64[D + 1],
        overflow)."""
        D, cap_r, cap_w = self.D, self.cap_r, self.cap_w
        out = []
        for s, ((_gv, _gf, gp), (lane_owner, lane_rank)) in enumerate(zip(lanes, lane_meta)):
            win = route_back(back[s], lane_owner, lane_rank, D, cap_r)
            (rows,), counts, _o, _r, ovf = route([gp], [-1], D, cap_w, owner=lane_owner,
                                                 mask=win)
            out.append((rows, counts, ovf))
        return out

    def _blocks(self, wins: list, wcounts: np.ndarray) -> list:
        """Each origin's live rows of its ``[D, cap_w]`` winner rows."""
        return [[(o, rows[o, :int(wcounts[s, o])]) for o in range(self.D)]
                for s, (rows, _c, _ovf) in enumerate(wins)]

    def _ship(self, frontiers: list, pays_of: list, cap_f: int) -> dict:
        """K2 of each origin's winners, their rows to the owners in (origin,
        row) order, and the owners' invariant scan.  ``pays_of[s]`` lists
        origin s's (owner, winners' payloads) blocks, owners ascending."""
        D, K = self.D, self.K
        blocks = [[None] * D for _ in range(D)]  # [origin][owner] -> (rows, gp, slot)
        for s, live in enumerate(pays_of):
            live = [(o, p) for o, p in live if p.shape[0]]
            if not live:
                continue
            pays = torch.cat([p for _o, p in live])
            pidx = torch.div(pays, K, rounding_mode="floor") - s * cap_f
            kids, _added, _ovf = self._kit(s).materialize(frontiers[s], pidx, pays % K)
            gp = s * cap_f + pidx
            sl = pays % K
            a = 0
            for o, p in live:
                c = p.shape[0]
                blocks[s][o] = (_rows(kids, a, a + c), gp[a:a + c], sl[a:a + c])
                a += c
        children, gps, slots, bads = [], [], [], []
        like = frontiers[0]
        for o in range(D):
            dev = self.devices[o]
            got = [blocks[s][o] for s in range(D) if blocks[s][o] is not None]
            self.stats["exchange_copies"] = self.stats.get("exchange_copies", 0) + len(got)
            fr = _cat_frontiers([b[0] for b in got], like, dev)
            children.append(fr)
            empty = torch.zeros((0,), dtype=I64, device=dev)
            gps.append(torch.cat([b[1].to(dev) for b in got]) if got else empty)
            slots.append(torch.cat([b[2].to(dev) for b in got]) if got else empty)
            bads.append(self._kit(o).inv_scan(fr).reshape(1).to(self.devices[0]) if got else
                        torch.full((1,), -1, dtype=I64, device=self.devices[0]))
        got = fetch(torch.cat(bads), *[g.to(self.devices[0]) for g in gps],
                    *[s_.to(self.devices[0]) for s_ in slots], what="mesh_trace")
        bad = got[0].copy()
        trace = ([g.copy() for g in got[1:1 + D]], [s_.copy() for s_ in got[1 + D:]])
        return dict(children=children, bad=bad, trace=trace)

    # -- the three modes' levels ------------------------------------------------------

    def _front(self, frontiers, n_f, cap_f, depth):
        """The shards' expand, with the candidate-capacity redo: (expand
        control, pre-deduped lanes, their device control (``_pre_dedup``),
        frontiers, grows), or the expand control alone when a shard
        aborted."""
        grows = 0
        while True:
            ex = self._expand_guards(frontiers, n_f, cap_f)
            if (ex["totals"] > self.cap_x).any():
                grows = self._grow_x(grows, depth)
                continue
            if (ex["abort_at"] < BIG).any():
                return ex, None, None, frontiers, grows
            lanes, dctl = self._pre_dedup(frontiers, ex["cp"], ex["totals"], cap_f)
            return ex, lanes, dctl, frontiers, grows

    def _grow_x(self, grows: int, depth: int) -> int:
        if grows >= 8:
            raise RuntimeError(f"capacity overflow at level {depth + 1} (cap_x={self.cap_x}, "
                               f"cap_r={self.cap_r}, vcap={self.vcap})")
        self._reactive(depth, "cap_x")
        self.cap_x *= 2
        return grows + 1

    def _level_a2a(self, frontiers, n_f, cap_f, depth) -> dict:
        """One all_to_all level over the hash-slab shards (:652-745)."""
        D = self.D
        grows = 0
        while True:
            ex, lanes, dctl, frontiers, g0 = self._front(frontiers, n_f, cap_f, depth)
            grows += g0
            if lanes is None:
                return dict(ex=ex, frontiers=frontiers)
            recv, lane_meta, _counts = self._route_candidates(lanes)
            prev = [s.clone() for s in self.slabs]
            verdicts, ctl = [], []
            for o in range(D):
                rv, rf, rp = (recv[k][o].reshape(-1) for k in range(3))
                slab, fresh, n_new, ovf_h = probe_and_insert(self.slabs[o], rv, rf, rp)
                self.slabs[o] = slab
                ovf_v = ovf_h | ((self.live[o] + n_new) * 2 > self.vcap)
                verdicts.append(fresh.reshape(D, self.cap_r))
                ctl.append(torch.stack([n_new.to(I64), ovf_v.to(I64)]).to(self.devices[0]))
            back = meshlib.all_to_all(verdicts, self.devices, self.stats)
            wins = self._winners(back, lanes, lane_meta)
            wctl = [torch.cat([c, ovf.reshape(1).to(I64)]).to(self.devices[0])
                    for _r, c, ovf in wins]
            c_own, c_win, c_d = fetch(torch.stack(ctl), torch.stack(wctl), dctl,
                                      what="mesh_verdict")
            if c_d[:, 0].any():
                self.slabs = prev  # a void fingerprint went in: redo the level wider
                frontiers = self._grow_cap_m(frontiers)
                continue
            n_u = c_d[:, 1].copy()
            n_own, ovf_v = c_own[:, 0].copy(), bool(c_own[:, 1].any())
            wcounts, ovf_w = c_win[:, :D].copy(), bool(c_win[:, D + 1].any())
            ovf_c = bool((np.minimum(wcounts, self.cap_w).sum(0) > self.cap_x).any())
            if not (ovf_v or ovf_w or ovf_c):
                break
            self.slabs = prev  # the level is redone from the slabs it started with
            if grows >= 8:
                raise RuntimeError(f"capacity overflow at level {depth + 1} "
                                   f"(cap_x={self.cap_x}, cap_r={self.cap_r}, vcap={self.vcap})")
            grows += 1
            if ovf_v:
                self._reactive(depth, "vcap")
                self._grow_visited(self.vcap * 4)
            else:
                self._reactive(depth, "cap_x")
                self.cap_x *= 2
        for o in range(D):
            self.live[o] += int(n_own[o])
        shipped = self._ship(frontiers, self._blocks(wins, wcounts), cap_f)
        return dict(ex=ex, frontiers=frontiers, n_new=int(n_own.sum()),
                    nloc=wcounts.sum(0), cand=int(n_u.max()), **shipped)

    def _level_gather(self, frontiers, n_f, cap_f, depth) -> dict:
        """One all_gather level over the replicated sorted store (:615-650)."""
        D, K = self.D, self.K
        ex, lanes, dctl, frontiers, _g = self._front(frontiers, n_f, cap_f, depth)
        if lanes is None:
            return dict(ex=ex, frontiers=frontiers)
        filt = []
        for d, (gv, gf, gp) in enumerate(lanes):
            hit = _member(self.visited[d], gv)
            filt.append((torch.where(hit, torch.full_like(gv, SENT), gv), gf, gp))
        gathered = [meshlib.all_gather([f[k] for f in filt], self.devices, self.stats)
                    for k in range(3)]
        # every shard's dedup of the gathered lanes is the same: once a device
        per_dev: dict = {}
        for d, dev in enumerate(self.devices):
            if str(dev) not in per_dev:
                per_dev[str(dev)] = group_unique(gathered[0][d], gathered[1][d], gathered[2][d])
        n_new_t, sv, _sf, sp = per_dev[str(self.devices[0])]
        ar = torch.arange(sp.shape[0], dtype=I64, device=sp.device)
        mine = [(torch.div(per_dev[str(dev)][3], K * cap_f, rounding_mode="floor") == d)
                & (ar.to(dev) < per_dev[str(dev)][0].to(dev)) for d, dev in enumerate(self.devices)]
        c, c_d = fetch(torch.stack([n_new_t.to(I64)] + [m.sum().to(self.devices[0])
                                                      for m in mine]), dctl, what="mesh_gather")
        if c_d[:, 0].any():
            return self._level_gather(self._grow_cap_m(frontiers), n_f, cap_f, depth)
        n_new, nloc, n_u = int(c[0]), c[1:].copy(), c_d[:, 1].copy()
        # each origin keeps its own winners, in the gathered (fp_view) order;
        # its children stay on its shard, as in the reference
        pays_of = []
        for d, dev in enumerate(self.devices):
            sp_d, n_d = per_dev[str(dev)][3], int(nloc[d])
            pay = compact_payloads(mine[d], sp_d, n_d)[0] if n_d else sp_d[:0]
            pays_of.append([(d, pay)])
        shipped = self._ship(frontiers, pays_of, cap_f)
        return dict(ex=ex, frontiers=frontiers, n_new=n_new, nloc=nloc, cand=int(n_u.max()),
                    new_sorted={k: v[1] for k, v in per_dev.items()}, **shipped)

    def _host_filter(self, recv: list, cnt: np.ndarray) -> tuple:
        """Each owner's received lanes through its external store (:810):
        lexsort by (fp_view, fp_full, payload), the first lane of each
        fp_view is the representative, the store's is-new verdict on it.
        Returns (verdict tiles bool[D, cap_r] per owner, on its device;
        n_new).  A received row holds its live lanes first (``cnt[origin,
        owner]``, the routing's counts), so only those are fetched and
        sorted: the SENT lanes sort last in the reference's lexsort and are
        never new."""
        D, cap_r = self.D, self.cap_r
        rows = []
        # every owner's read started, then completed in owner order
        win = gpipe.AsyncFetchWindow(D if self.pipeline else 0)
        for o in range(D):
            live = [torch.cat([recv[k][o][s, :cnt[s, o]] for s in range(D)]) for k in range(3)]
            win.submit(live, lambda h: rows.append((h[0].view(np.uint64).copy(),
                                                    h[1].view(np.uint64).copy(), h[2].copy())),
                       what="mesh_host_filter")
        win.drain()
        n_routed = int(cnt.sum())
        off_diag = (D - 1) / D
        self.meter.begin_level(len(self.meter.levels) + 1)
        self.meter.add(n_candidates=n_routed, n_unique=n_routed,
                       a2a_bytes=int(n_routed * 25 * off_diag),
                       raw_a2a_bytes=int(n_routed * 25 * off_diag),
                       host_bytes=n_routed * 25, raw_host_bytes=n_routed * 25)
        self.meter.end_level()
        verdicts, n_new = [], 0
        t0 = time.perf_counter()
        for o, (rv, rf, rp) in enumerate(rows):
            order = np.lexsort((rp, rf, rv))
            sv = rv[order]
            first = np.ones(len(sv), bool)
            first[1:] = sv[1:] != sv[:-1]
            uniq = sv[first]
            is_new = self.host_stores[o].insert(uniq) if len(uniq) else np.zeros(0, bool)
            vs = np.zeros(len(rv), bool)
            vs[order[first]] = is_new
            n_new += int(is_new.sum())
            # the live lanes' verdicts back into the receive layout [origin, row]
            dev = self.devices[o]
            v_live = torch.from_numpy(vs).to(dev)
            tile = torch.zeros((D, cap_r), dtype=torch.bool, device=dev)
            a = 0
            for s_ in range(D):
                tile[s_, :cnt[s_, o]] = v_live[a:a + cnt[s_, o]]
                a += int(cnt[s_, o])
            verdicts.append(tile)
        self.host_seconds += time.perf_counter() - t0
        return verdicts, n_new

    def _level_hosted(self, frontiers, n_f, cap_f, depth) -> dict:
        """One host-store level (:901): the shards' expand and routing, the
        host's filter through the per-owner stores, the verdicts back, the
        winners' routing (the cap_w boost on its overflow) and the ship."""
        D = self.D
        ex, lanes, dctl, frontiers, grows = self._front(frontiers, n_f, cap_f, depth)
        if lanes is None:
            return dict(ex=ex, frontiers=frontiers)
        recv, lane_meta, counts = self._route_candidates(lanes)
        cnt, c_d = fetch(torch.stack([c.to(self.devices[0]) for c in counts]), dctl,
                         what="mesh_sent_counts")
        if c_d[:, 0].any():  # before the stores see a void fingerprint
            return self._level_hosted(self._grow_cap_m(frontiers), n_f, cap_f, depth)
        n_u = c_d[:, 1].copy()
        verdicts, n_new = self._host_filter(recv, cnt[:, :self.D].copy())
        back = meshlib.all_to_all(verdicts, self.devices, self.stats)
        boosted = False
        while True:
            wins = self._winners(back, lanes, lane_meta)
            (c_win,) = fetch(torch.stack([torch.cat([c, ovf.reshape(1).to(I64)])
                                          .to(self.devices[0]) for _r, c, ovf in wins]),
                             what="mesh_verdict")
            wcounts, ovf_w = c_win[:, :D].copy(), bool(c_win[:, D + 1].any())
            ovf_c = bool((np.minimum(wcounts, self.cap_w).sum(0) > self.cap_x).any())
            if not (ovf_w or ovf_c):
                break
            if grows >= 8:
                raise RuntimeError(f"shipping overflow (cap_w={self.cap_w}, "
                                   f"cap_x={self.cap_x})")
            grows += 1
            self.reactive_grows += 1
            if ovf_c:
                # an owner received more new states than its cap_x block:
                # grow cap_x and redo the whole level (:961-969)
                self.cap_x *= 2
                return self._level_hosted(frontiers, n_f, cap_f, depth)
            boosted = True
            self._cap_w_boost *= 2
        if boosted:
            self._cap_w_boost = 1  # the boost absorbs one concentrated level (:977-982)
        n2 = int(wcounts.sum())
        reconcile("host-store verdict map", n_new, n2)
        shipped = self._ship(frontiers, self._blocks(wins, wcounts), cap_f)
        return dict(ex=ex, frontiers=frontiers, n_new=n2, nloc=wcounts.sum(0),
                    cand=int(n_u.max()), **shipped)

    # -- the sharded deep sweep (:996-2330) --------------------------------------------

    @property
    def cap_c_deep(self) -> int:
        """Phase 2's owner block (winners shipped to one owner in one round);
        grows alone on its overflow (:1024)."""
        return self.cap_x * self._cap_c_boost

    def _grow_deep(self, what: str) -> None:
        """The deep path's reactive growth (:1535)."""
        self.reactive_grows += 1
        if what == "cap_x":
            self.cap_x *= 2
        elif what == "cap_c":
            self._cap_c_boost *= 2
        else:
            self._cap_w_boost *= 2

    def _grow_sieve(self, new_scap: int) -> None:
        """Every shard's sieve to ``new_scap`` slots (:1546-1578): rehashed on
        the host (``rebuild_np``) in hash mode, SENT-padded in sorted mode.  A
        failed grow keeps the capacity: the sieve is only a cache."""
        new_scap = min(int(new_scap), self.scap_max)
        if new_scap <= self.scap:
            return
        arr = [s_.cpu().numpy().view(np.uint64) for s_ in self.sieves]
        try:
            faults.fire("hashstore.grow")
            if self.use_hashstore:
                new = rebuild_np(arr, new_scap)
            else:
                pad = np.full((self.D, new_scap - self.scap), SENT_U64, np.uint64)
                new = np.concatenate([np.stack(arr), pad], axis=1)
        except Exception as e:  # noqa: BLE001 -- a cache: keep it as it is
            print(f"[resilience] sieve grow to {new_scap} failed ({e}); keeping the current "
                  "sieve capacity", file=sys.stderr)
            return
        self.scap = new_scap
        self.sieves = [torch.from_numpy(np.ascontiguousarray(new[d]).view(np.int64)).to(dev)
                       for d, dev in enumerate(self.devices)]

    def _deep_phase1(self, frontiers: list, n_f: list, R: int, capf: int, parts: dict):
        """Phase 1 (:1075) for every round: each shard's segment expanded,
        pre-deduped, sieved and routed; the owners' live received lanes.
        Returns a dict, or ("cap_x",) / ("cap_m",) for a redo, or ("abort",
        gidx, mult) (the first round with an aborting parent, its first
        shard: :1683-1691)."""
        D, K, seg, dev0 = self.D, self.K, self.seg_rows, self.devices[0]
        t0 = time.perf_counter()
        mult = np.zeros(K, np.int64)
        abort = None
        rounds = []
        for r in range(R):
            exp = []
            for d, fr in enumerate(frontiers):
                a, b = r * seg, min((r + 1) * seg, n_f[d])
                exp.append(self._expand_local_seg(d, fr, a, max(a, b), (d * capf + a) * K))
            c1 = self._expand_all(exp, "deep_expand")
            totals, aborts = c1[:D], c1[D:2 * D]
            if (totals > self.cap_x).any():
                parts["phase1"] += time.perf_counter() - t0
                return ("cap_x",)
            mult += c1[2 * D:]
            if abort is None and (aborts < BIG).any():
                dv = int(np.nonzero(aborts < BIG)[0][0])
                abort = dv * capf + int(aborts[dv])
            if abort is not None:
                continue  # only the overflow check of the later rounds counts now
            pre, dctl = self._pre_dedup(frontiers, [e[0] for e in exp], totals, capf)
            lanes, ctl, sends = [], [], [[], []]
            for d, (cv, cf, cp) in enumerate(pre):
                if self.sieve and cv.shape[0]:
                    # a candidate this shard routed in an earlier level is in the
                    # store: drop it before the routing
                    hit = (hashstore.probe(self.sieves[d], cv) if self.use_hashstore
                           else _member(self.sieves[d], cv))
                    cv = torch.where(hit, torch.full_like(cv, SENT), cv)
                    cf = torch.where(hit, torch.full_like(cf, SENT), cf)
                    cp = torch.where(hit, torch.full_like(cp, -1), cp)
                rows, cnt, lane_owner, lane_rank, _ovf = route([cv, cf], [SENT, SENT], D,
                                                               self.cap_r)
                for k in range(2):
                    sends[k].append(rows[k])
                lanes.append((cv, cp, lane_owner, lane_rank))
                ctl.append(torch.cat([(cv != SENT).sum().reshape(1).to(dev0), cnt.to(dev0)]))
            c2, c_d = fetch(torch.stack(ctl), dctl, what="deep_route")
            if c_d[:, 0].any():  # a void fingerprint: widen before the stores see it
                parts["phase1"] += time.perf_counter() - t0
                return ("cap_m",)
            cnt = c2[:, 1:1 + D].copy()
            recv = [meshlib.gather_rows(sends[k], cnt, self.devices, self.stats)
                    for k in range(2)]
            rounds.append(dict(lanes=lanes, cnt=cnt, recv=recv, n_pre=c_d[:, 1].copy(),
                               n_post=c2[:, 0].copy()))
        parts["phase1"] += time.perf_counter() - t0
        if abort is not None:
            return ("abort", abort, mult)
        return dict(rounds=rounds, mult=mult)

    def _deep_finalize(self, rounds: list) -> list:
        """The owner's exact level dedup (:1129): ``group_unique`` over its
        live received lanes in (round, origin, row) order with payload = the
        receive index (the reference's tie-break), then the packed stream.
        Per owner: (unique fps, winners' receive lanes, n_u, stream,
        nibbles, total, n_recv), device tensors but n_recv."""
        out = []
        for o, dev in enumerate(self.devices):
            rv = torch.cat([rd["recv"][0][o] for rd in rounds])
            rf = torch.cat([rd["recv"][1][o] for rd in rounds])
            n = rv.shape[0]
            n_u, uq, _uf, ugp = group_unique(rv, rf, torch.arange(n, dtype=I64, device=dev))
            st = nib = total = None
            if self.compress:
                even = uq if n % 2 == 0 else torch.cat([uq, torch.full((1,), SENT, dtype=I64,
                                                                       device=dev)])
                st, nib, total = pack_fp_deltas(even, n_u)
            out.append((uq, ugp, n_u, st, nib, total, n))
        return out

    @property
    def _io_pool(self):
        """Per-owner store-insert workers (:1504): the ctypes insert releases
        the GIL, so the D inserts run at once.  Workers touch no device."""
        if getattr(self, "_pool", None) is None:
            self._pool = ThreadPoolExecutor(max_workers=max(2, min(self.D, os.cpu_count() or 2)))
        return self._pool

    def _deep_exchange(self, fin: list, n_pre: int, n_post: int, Rq: int, parts: dict):
        """The ledger, the quantized-prefix fetch (retried on transient
        failures), the concurrent store inserts and the verdict bits back
        (:1714-1815).  Returns (the is-new bits u8[D, vq], inserted i64[D],
        the inserts' seconds f64[D])."""
        D, cap_r, meter = self.D, self.cap_r, self.meter
        t0 = time.perf_counter()
        dev0 = self.devices[0]
        ctl = [torch.stack([f[2].to(I64)] + ([f[5]] if self.compress else [])).to(dev0)
               for f in fin]
        (c,) = fetch(torch.stack(ctl), what="deep_finalize")
        n_us = c[:, 0].copy()
        totals = c[:, 1].copy() if self.compress else np.zeros(D, np.int64)
        cap_acc = Rq * D * cap_r
        cap8, capnib = cap_acc * 8, cap_acc // 2
        off_diag = (D - 1) / D
        meter.add(n_candidates=n_pre, n_sieved=n_pre - n_post, n_unique=int(n_us.sum()),
                  a2a_bytes=int(n_post * 17 * off_diag), raw_a2a_bytes=int(n_pre * 25 * off_diag),
                  raw_host_bytes=n_pre * 25)
        max_nu = int(n_us.max()) if D else 0
        vq = packed_quantum(max(1, (max_nu + 7) // 8))
        qf = min(packed_quantum(max(max_nu, 1)), cap_acc)
        qb = min(packed_quantum(max(int(totals.max()), 1)), cap8)
        qn = min(packed_quantum(max((max_nu + 1) // 2, 1)), capnib)
        packed_ok = self.compress and (qb + qn) < qf * 8

        def fetch_prefixes():
            """One idempotent unit: a transient failure retries it."""
            faults.fire("exchange.fetch")
            if packed_ok:
                got = gpipe.DeferredFetch(
                    self.pipeline, [f[3][:int(totals[o])] for o, f in enumerate(fin)]
                    + [f[4][:(int(n_us[o]) + 1) // 2] for o, f in enumerate(fin)],
                    what="deep_prefix").get()
                return [g.copy() for g in got], D * (qb + qn)
            got = gpipe.DeferredFetch(
                self.pipeline, [f[0][:int(n_us[o])] for o, f in enumerate(fin)],
                what="deep_prefix").get()
            return [g.copy() for g in got], D * qf * 8

        got, fetch_bytes = resilience.with_retry(fetch_prefixes, "deep exchange prefix fetch")
        parts["finalize"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        inserted = np.zeros(D, np.int64)
        insert_secs = np.zeros(D, np.float64)
        bits = np.zeros((D, vq), np.uint8)

        def insert_one(o):
            t_o = time.monotonic()
            n_o = int(n_us[o])
            if n_o == 0:
                return
            if packed_ok:
                fps = unpack_fp_deltas(got[o], got[D + o], n_o, verify=True)
            else:
                fps = got[o].view(np.uint64)
            is_new = self.host_stores[o].insert(fps)
            inserted[o] = int(is_new.sum())
            pb = np.packbits(is_new, bitorder="little")
            bits[o, :len(pb)] = pb[:vq]
            insert_secs[o] = time.monotonic() - t_o

        list(self._io_pool.map(insert_one, range(D)))
        meter.note_packed(packed_ok)
        meter.add(host_bytes=fetch_bytes + D * vq + 16 * D)
        parts["inserts"] += time.perf_counter() - t0
        return bits, inserted, insert_secs

    def _deep_verdict(self, fin: list, bits: np.ndarray) -> list:
        """The is-new bits back on each owner's received lanes (:1159): the
        win mask over its live lanes in receive order."""
        return [deep_verdict(torch.from_numpy(bits[o]).to(dev), f[1], f[2], f[6])
                for o, (f, dev) in enumerate(zip(fin, self.devices))]

    def _deep_phase2(self, rounds: list, wins: list, parts: dict) -> tuple:
        """Phase 2 (:1254): each round's verdicts back to its origins
        (``route_back``), the winners grouped by owner (``route``), with
        the cap_w / cap_c regrowth and redo (:1826-1849).  Returns per round
        and origin (winner payload rows [D, cap_w]) and the counts
        i64[R, D, D]."""
        D, cap_r = self.D, self.cap_r
        t0 = time.perf_counter()
        # the receive position of round r, origin s in owner o's lanes
        pos = np.zeros(D, np.int64)
        masks = []
        for rd in rounds:
            ms = []
            for s_, (cv, cp, lane_owner, lane_rank) in enumerate(rd["lanes"]):
                dev = self.devices[s_]
                back = torch.zeros((D, cap_r), dtype=torch.bool, device=dev)
                for o in range(D):
                    c = int(rd["cnt"][s_, o])
                    if c:
                        back[o, :c] = wins[o][pos[o]:pos[o] + c].to(dev)
                    pos[o] += c
                ms.append(route_back(back, lane_owner, lane_rank, D, cap_r))
            masks.append(ms)
        grows = 0
        while True:
            cap_w = self.cap_w
            ship, ctl = [], []
            for rd, ms in zip(rounds, masks):
                row = []
                for (cv, cp, lane_owner, _rank), win in zip(rd["lanes"], ms):
                    (rows,), counts, _o, _r, ovf = route([cp], [-1], D, cap_w, owner=lane_owner,
                                                         mask=win)
                    row.append(rows)
                    ctl.append(torch.cat([counts, ovf.reshape(1).to(I64)]).to(self.devices[0]))
                ship.append(row)
            (c,) = fetch(torch.stack(ctl), what="deep_verdict")
            c = c.reshape(len(rounds), D, D + 2)
            wcounts = c[:, :, :D].copy()
            ovf_w = bool(c[:, :, D + 1].any())
            ovf_c = bool((np.minimum(wcounts, cap_w).sum(1) > self.cap_c_deep).any())
            if not (ovf_w or ovf_c):
                break
            if grows >= 8:
                raise RuntimeError(f"deep shipping overflow (cap_w={self.cap_w}, "
                                   f"cap_c={self.cap_c_deep})")
            grows += 1
            self._grow_deep("cap_c" if ovf_c else "cap_w")
        parts["phase2"] += time.perf_counter() - t0
        return ship, wcounts

    def _ship_winners_deep(self, frontiers: list, capf: int, ship: list,
                           wcounts: np.ndarray) -> list:
        """K2 of every origin's winners at the origin (:1186; all its rounds
        in one launch, grouped by owner, rounds in order), with their global
        gpidx and slots: [owner][origin] the rows it ships there, or None."""
        D, K = self.D, self.K
        R = len(ship)
        sources = [[None] * D for _ in range(D)]
        for s_ in range(D):
            live = [ship[r][s_][o, :int(wcounts[r, s_, o])] for o in range(D) for r in range(R)
                    if wcounts[r, s_, o]]
            if not live:
                continue
            pays = torch.cat(live)
            gp = torch.div(pays, K, rounding_mode="floor")
            sl = pays % K
            kids, _added, _ovf = self._kit(s_).materialize(frontiers[s_], gp - s_ * capf, sl)
            a = 0
            for o in range(D):
                n = int(wcounts[:, s_, o].sum())
                if n:
                    sources[o][s_] = tuple(x[a:a + n] for x in kids) + (gp[a:a + n], sl[a:a + n])
                a += n
        return sources

    def _deep_repack(self, sources: list, wcounts: np.ndarray, like: Frontier) -> dict:
        """The shipped rows to their owners and the next level's segments,
        round-major (:1283), with gpidx and slots; the owners' invariant
        scan.  The violation the reference reports is the first round's,
        then the first owner's, then that block's first row (:1862-1876)."""
        D, R = self.D, wcounts.shape[0]
        children, gps, sls, bads, nl, starts = [], [], [], [], [], []
        for o, dev in enumerate(self.devices):
            srcs = [(s_, src) for s_, src in enumerate(sources[o]) if src is not None]
            self.stats["exchange_copies"] = self.stats.get("exchange_copies", 0) + len(srcs)
            if srcs:
                index = {s_: i for i, (s_, _src) in enumerate(srcs)}
                pos = [0] * D
                segs = []
                for r in range(R):  # round-major, then origin
                    for s_ in range(D):
                        c = int(wcounts[r, s_, o])
                        if c:
                            segs.append((index[s_], pos[s_], c))
                            pos[s_] += c
                fields = repack([tuple(x.to(dev) for x in src) for _s, src in srcs], segs)
                fr = Frontier(*fields[:-2])
                gp_o, sl_o = fields[-2], fields[-1]
            else:
                fr = Frontier(*(x[:0].to(dev) for x in like))
                gp_o = sl_o = torch.zeros((0,), dtype=I64, device=dev)
            children.append(fr)
            gps.append(gp_o)
            sls.append(sl_o)
            nl.append(int(fr.voted_for.shape[0]))
            # the first row of each round in this owner's segments
            starts.append(np.cumsum([0] + [int(wcounts[r, :, o].sum()) for r in range(R)]))
            bads.append(self._kit(o).inv_scan(fr).reshape(1).to(self.devices[0]) if srcs else
                        torch.full((1,), -1, dtype=I64, device=self.devices[0]))
        got = gpipe.DeferredFetch(self.pipeline, [torch.cat(bads)]
                                  + [g.to(self.devices[0]) for g in gps]
                                  + [x.to(self.devices[0]) for x in sls], what="deep_trace").get()
        bad = got[0].copy()
        trace = ([g.copy() for g in got[1:1 + D]], [x.copy() for x in got[1 + D:]])
        inv = None
        first = [(int(np.searchsorted(starts[o], bad[o], side="right")) - 1, o)
                 for o in range(D) if bad[o] >= 0]
        if first:
            _r, o = min(first)
            inv = (o, int(bad[o]))
        return dict(children=children, trace=trace, nl=np.asarray(nl, np.int64), inv=inv)

    def _deep_sieve_update(self, rounds: list, depth: int, parts: dict) -> None:
        """The level's candidates into each origin's sieve, round by round,
        at the level's end (the level's own candidates never sieve each
        other; :1912-1931); the sieve grows x4 on an overflow."""
        t0 = time.perf_counter()
        if self.sieve and self.scap:
            ovfs = []
            for rd in rounds:
                for d, (cv, _cp, _lo, _lr) in enumerate(rd["lanes"]):
                    if self.use_hashstore:
                        self.sieves[d], _n, ovf = hashstore.insert_only(self.sieves[d], cv)
                    else:
                        self.sieves[d], ovf = sieve_merge(self.sieves[d], cv)
                    ovfs.append(ovf.reshape(1).to(self.devices[0]))
            if ovfs:
                (o,) = fetch(torch.cat(ovfs), what="deep_sieve")
                if o.any() and self.scap < self.scap_max:
                    print(f"[mesh-deep] sieve cache full at level {depth + 1}: scap "
                          f"{self.scap} -> {self.scap * 4}", file=sys.stderr)
                    self._grow_sieve(self.scap * 4)
        parts["sieve"] += time.perf_counter() - t0

    def _deep_level(self, frontiers: list, n_f: list, depth: int) -> dict:
        """One level of the sharded deep sweep (:1640): phase 1 round by round
        (redone whole on a cap_x overflow, widened on a cap_m one), the
        owners' finalize, the fetch and the store inserts, the verdicts,
        phase 2 (redone alone on a cap_w / cap_c overflow: the stores and
        the verdicts stay), the repack and the sieve update."""
        D, seg = self.D, self.seg_rows
        R = max(1, -(-max(n_f) // seg))
        capf = R * seg
        self.meter.begin_level(depth + 1)
        parts = dict(phase1=0.0, finalize=0.0, inserts=0.0, phase2=0.0, repack=0.0, sieve=0.0)
        grows = 0
        while True:
            p1 = self._deep_phase1(frontiers, n_f, R, capf, parts)
            if isinstance(p1, dict):
                break
            if p1[0] == "abort":
                return dict(abort_gidx=p1[1], mult=p1[2], frontiers=frontiers)
            if p1[0] == "cap_m":
                frontiers = self._grow_cap_m(frontiers)
                continue
            if grows >= 8:
                raise RuntimeError(f"deep candidate overflow (cap_x={self.cap_x})")
            grows += 1
            print(f"[mesh-deep] REACTIVE cap_x grow at level {depth + 1} ({self.cap_x} -> "
                  f"{self.cap_x * 2})", file=sys.stderr)
            self._grow_deep("cap_x")
        rounds = p1["rounds"]
        n_pre = int(sum(rd["n_pre"].sum() for rd in rounds))
        n_post = int(sum(rd["n_post"].sum() for rd in rounds))
        Rq = 1 << max(0, R - 1).bit_length()
        t0 = time.perf_counter()
        fin = self._deep_finalize(rounds)
        parts["finalize"] += time.perf_counter() - t0
        bits, inserted, insert_secs = self._deep_exchange(fin, n_pre, n_post, Rq, parts)
        t0 = time.perf_counter()
        wins = self._deep_verdict(fin, bits)
        parts["finalize"] += time.perf_counter() - t0
        fin = None
        ship, wcounts = self._deep_phase2(rounds, wins, parts)
        n_new, n2 = int(inserted.sum()), int(wcounts.sum())
        reconcile("deep owner exchange", n_new, n2, level=depth + 1)
        self.skew.note(depth + 1, rows=inserted, seconds=insert_secs)
        t0 = time.perf_counter()
        sources = self._ship_winners_deep(frontiers, capf, ship, wcounts)
        ship = None
        parts["phase2"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rp = self._deep_repack(sources, wcounts, frontiers[0])
        sources = None
        parts["repack"] += time.perf_counter() - t0
        self._deep_sieve_update(rounds, depth, parts)
        stats = self.meter.end_level()
        self._cand_hist.append(int(max(rd["n_pre"].max() for rd in rounds)))
        return dict(n_new=n_new, frontiers=frontiers, mult=p1["mult"], capf=capf, R=R,
                    stats=stats, parts=parts, **rp)

    def run_deep(self, max_depth: int | None = None, presize: bool = True) -> CheckResult:
        """The sharded deep sweep's run loop (:1946): levels of
        ``_deep_level`` from the root, the presize of cap_x and the sieve
        from ``per_device_forecast`` once enough levels are seen, the
        store-occupancy check every level."""
        cfg, D, K, seg = self.cfg, self.D, self.K, self.seg_rows
        t0 = time.monotonic()
        if self.host_stores is None:
            from ..native import HostFPStore

            self.host_stores = [
                HostFPStore(os.path.join(self.host_store_dir, f"shard_{o:02d}"),
                            mem_budget_entries=self._store_budget_entries())
                for o in range(D)]
            for s_ in self.host_stores:
                s_.clear()
        self.sieves = [torch.full((self.scap,), SENT, dtype=I64, device=dev)
                       for dev in self.devices]
        self._cand_hist = []
        self.peak_dev_rows = 0
        kit0, dev0 = self.kit0, self.devices[0]
        fr0, ovf0 = kit0.deflate(init_batch(cfg, 1, dev0))
        if bool(ovf0.any()):
            raise RuntimeError(f"initial state's message set exceeds cap_m={kit0.cap_m}")
        fv, _ff = kit0._fp_states(fr0)
        fp0 = np.asarray([int(fv[0])], np.int64).view(np.uint64)
        self.host_stores[int(fp0[0] % np.uint64(D))].insert(fp0)
        frontiers = [fr0] + [Frontier(*(x[:0].to(d) for x in fr0)) for d in self.devices[1:]]
        n_f = [1] + [0] * (D - 1)
        distinct, generated, depth = 1, 0, 0
        level_sizes = [1]
        trace_levels: list = []
        mult_total = np.zeros(K, np.int64)
        if int(kit0.inv_scan(fr0)) >= 0:
            name = kit0.bad_invariant_name(fr0, 0)
            return CheckResult(False, 1, 0, 0, (1,),
                               (f"Invariant {name} is violated", self._trace([], 0, 0)), {})
        try:
            while True:
                faults.fire("level.start")
                if resilience.preempt_requested():
                    raise resilience.Preempted(None, depth)
                if max_depth is not None and depth >= max_depth:
                    break
                if presize and len(level_sizes) > forecast.MIN_LEVELS:
                    self._presize_deep(level_sizes, distinct, max_depth)
                t_level, copies0 = time.perf_counter(), self.stats.get("exchange_copies", 0)
                out = self._deep_level(frontiers, n_f, depth)
                frontiers = out["frontiers"]
                if "abort_gidx" in out:
                    return CheckResult(False, distinct, generated, depth, tuple(level_sizes), (
                        'Assert "split brain" (Raft.tla:185)',
                        self._trace(trace_levels, depth, out["abort_gidx"])))
                mult_total += out["mult"]
                generated += int(out["mult"].sum())
                n_new = out["n_new"]
                if n_new == 0:
                    break
                nl = out["nl"]
                n_out = max(1, -(-int(nl.max()) // seg))
                ntot = n_out * seg  # the next level's frontier block (capf)
                self.peak_dev_rows = max(self.peak_dev_rows, ntot)
                distinct += n_new
                occupancy_check("deep per-owner stores",
                                sum(len(s_) for s_ in self.host_stores), distinct,
                                level=depth + 1)
                level_sizes.append(n_new)
                depth += 1
                gps, sls = out["trace"]
                trace_levels.append((gps, sls, ntot))
                frontiers, n_f = out["children"], [int(x) for x in nl]
                st = out["stats"]
                self.level_log.append(dict(
                    level=depth, seconds=time.perf_counter() - t_level,
                    exchange_copies=self.stats.get("exchange_copies", 0) - copies0,
                    rows=[int(x) for x in nl], rounds=out["R"], segments=n_out,
                    parts=out["parts"], cap_x=self.cap_x, cap_w=self.cap_w,
                    cap_c=self.cap_c_deep, scap=self.scap, vcap=None))
                if self.progress is not None:
                    self.progress(dict(level=depth, frontier=n_new, distinct=distinct,
                                       generated=generated, elapsed=time.monotonic() - t0,
                                       exchange_bytes=st["exchanged_bytes"],
                                       exchange_raw_bytes=st["raw_bytes"],
                                       exchange_reduction=st["reduction"]))
                if out["inv"] is not None:
                    o, row = out["inv"]
                    trace = self._trace(trace_levels, depth, o * ntot + row)
                    name = self._kit(o).bad_invariant_name(frontiers[o], row)
                    return CheckResult(False, distinct, generated, depth, tuple(level_sizes),
                                       (f"Invariant {name} is violated", trace))
        finally:
            if getattr(self, "_pool", None) is not None:
                self._pool.shutdown()
                self._pool = None
        return CheckResult(True, distinct, generated, depth, tuple(level_sizes), None,
                           kit0.layout.action_counts(mult_total))

    def _presize_deep(self, level_sizes, distinct: int, max_depth) -> None:
        """cap_x from the measured per-round candidate peak, floored by the
        forecast, and the sieve from the forecast's final share
        (:2102-2144)."""
        fc = forecast.per_device_forecast(level_sizes, distinct, max_depth, self.D)
        if fc is None:
            return
        pow2ceil = forecast.pow2ceil
        if self._cand_hist:
            want_x = pow2ceil(max(int(1.35 * max(self._cand_hist[-3:])),
                                  4 * min(fc["peak_rows"], self.seg_rows)) + 1)
            if self.cap_x_max is not None:
                want_x = min(want_x, self.cap_x_max)
            want_x = min(want_x, 1 << 22, pow2ceil(fc["budget"] // (48 * self.D)) // 2)
            if want_x > self.cap_x:
                print(f"[mesh-deep] presize: cap_x {self.cap_x} -> {want_x}", file=sys.stderr)
                self.cap_x = want_x
        want_s = min(pow2ceil(int(2.2 * fc["final_rows"]) + 1), pow2ceil(fc["budget"] // 8),
                     self.scap_max)
        if want_s > self.scap:
            print(f"[mesh-deep] presize: scap {self.scap} -> {want_s}", file=sys.stderr)
            self._grow_sieve(want_s)

    # -- the visited stores ---------------------------------------------------------

    def _upload_slabs(self, arr: np.ndarray) -> None:
        self.slabs = [torch.from_numpy(np.ascontiguousarray(arr[o]).view(np.int64)).to(dev)
                      for o, dev in enumerate(self.devices)]

    def _grow_visited(self, new_vcap: int) -> None:
        """Every slab shard rehashed on the host into ``new_vcap`` slots
        (``rebuild_np``, :2892-2930).  A failed rehash raises: the
        reference's degrade to sorted shards is not ported (ROADMAP A.7)."""
        faults.fire("hashstore.grow")
        arr = [s.cpu().numpy().view(np.uint64) for s in self.slabs]
        self.vcap = int(new_vcap)
        self._upload_slabs(rebuild_np(arr, self.vcap))

    def slab_contents(self) -> list:
        """Each owner's live fingerprints (u64, sorted)."""
        out = []
        for s in self.slabs:
            a = s.cpu().numpy().view(np.uint64)
            out.append(np.sort(a[a != SENT_U64]))
        return out

    def _maybe_presize(self, level_sizes, distinct: int, max_depth) -> None:
        """Size cap_x and vcap for the forecast horizon once (:2951-2997)."""
        sig = forecast.horizon_forecast(level_sizes, distinct, max_depth)
        if sig is None:
            return
        peak_new, final_distinct, budget = sig
        D = self.D
        r_cd = max(self._cand_hist[-3:]) if self._cand_hist else 4.0 / D
        want_x = forecast.pow2ceil(int(r_cd * peak_new * forecast.cap_margin()) + 1)
        if self.cap_x_max is not None:
            want_x = min(want_x, self.cap_x_max)
        want_x = min(want_x, 1 << 22, forecast.pow2ceil(budget // (48 * D)) // 2)
        if want_x > self.cap_x:
            print(f"[mesh] presize: cap_x {self.cap_x} -> {want_x} (forecast peak "
                  f"{peak_new}/level, measured cand/new ratio {r_cd:.2f})", file=sys.stderr)
            self.cap_x = want_x
        if self.host_stores is None and self.exchange == "all_to_all":
            want_v = forecast.pow2ceil(int(2.2 * final_distinct / D) + 1)
            want_v = min(want_v, forecast.pow2ceil(budget // (8 * D)))
            if want_v > self.vcap:
                print(f"[mesh] presize: vcap {self.vcap} -> {want_v} (forecast "
                      f"{final_distinct} final distinct)", file=sys.stderr)
                self._grow_visited(want_v)
        elif self.host_stores is None:
            self._gather_keep = max(self._gather_keep, min(
                forecast.pow2ceil(int(1.05 * final_distinct)), forecast.pow2ceil(budget // 8)))

    def _merge_gathered(self, distinct: int, new_sorted: dict) -> None:
        """The replicated store merged with the level's new fingerprints
        (``new_sorted``: per device, ascending, SENT-padded) and trimmed to
        the tightest power of two past ``distinct`` (at least 4,096 and the
        forecast floor; :3105-3123)."""
        keep = max(4096, 1 << distinct.bit_length(), self._gather_keep)
        merged: dict = {}
        for d, dev in enumerate(self.devices):
            if str(dev) not in merged:
                v, new = self.visited[d], new_sorted[str(dev)]
                m = merge_sorted(v, new, min(keep, v.shape[0] + new.shape[0]))
                if m.shape[0] < keep:
                    m = torch.cat([m, torch.full((keep - m.shape[0],), SENT, dtype=I64,
                                                 device=dev)])
                merged[str(dev)] = m
        self.visited = [merged[str(dev)] for dev in self.devices]

    # -- the run loop -------------------------------------------------------------

    def _trace(self, trace_levels: list, level: int, gidx: int) -> list:
        """Walk the (gpidx, slot) records back to Init (:2292); a level's
        index is ``owner * cap_c + row``."""
        chain = []
        d, j = level, gidx
        while d > 0:
            gps, sls, cap_c = trace_levels[d - 1]
            o, r = divmod(j, cap_c)
            chain.append(int(sls[o][r]))
            j = int(gps[o][r])
            d -= 1
        chain.reverse()
        return self.kit0.replay(chain)

    def run(self, max_depth: int | None = None, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1, resume_from: str | None = None,
            presize: bool = True) -> CheckResult:
        """Check to ``max_depth`` (None: the fixpoint).  ``presize`` sizes
        capacities from the forecast; checkpoints are refused (the mesh's
        delta log is ROADMAP A.7)."""
        if (checkpoint_dir and checkpoint_every) or resume_from is not None:
            raise ValueError(CHECKPOINT_REFUSAL)
        if self.deep:
            return self.run_deep(max_depth=max_depth, presize=presize)
        cfg, D, K = self.cfg, self.D, self.K
        t0 = time.monotonic()
        self.host_seconds = 0.0
        if self.host_store_dir is not None and self.host_stores is None:
            from ..native import HostFPStore

            self.host_stores = [
                HostFPStore(os.path.join(self.host_store_dir, f"shard_{o:02d}"),
                            mem_budget_entries=self._store_budget_entries())
                for o in range(D)]
            for s in self.host_stores:
                s.clear()  # run files a crashed process left behind
        kit0, dev0 = self.kit0, self.devices[0]
        fr0, ovf0 = kit0.deflate(init_batch(cfg, 1, dev0))
        if bool(ovf0.any()):
            raise RuntimeError(f"initial state's message set exceeds cap_m={kit0.cap_m}")
        fv, _ff = kit0._fp_states(fr0)
        fp0 = np.asarray([int(fv[0])], np.int64).view(np.uint64)
        own0 = int(fp0[0] % np.uint64(D))
        if self.host_stores is not None:
            self.host_stores[own0].insert(fp0)
        elif self.exchange == "all_to_all":
            vis = np.full((D, self.vcap), SENT_U64, np.uint64)
            insert_np(vis[own0], fp0)
            self._upload_slabs(vis)
            self.live = [0] * D
            self.live[own0] = 1
        else:
            vis = np.full(self.vcap, SENT_U64, np.uint64)
            vis[0] = fp0[0]
            st = torch.from_numpy(np.sort(vis).view(np.int64))
            per: dict = {}
            self.visited = [per.setdefault(str(d), st.to(d)) for d in self.devices]
        frontiers = [fr0] + [Frontier(*(x[:0].to(d) for x in fr0)) for d in self.devices[1:]]
        n_f = [1] + [0] * (D - 1)
        cap_f = 1  # the init frontier's block: one row a shard
        distinct, generated, depth = 1, 0, 0
        level_sizes = [1]
        trace_levels: list = []
        mult_total = np.zeros(K, np.int64)
        self._gather_keep = 0
        self._cand_hist: list = []
        if int(kit0.inv_scan(fr0)) >= 0:
            name = kit0.bad_invariant_name(fr0, 0)
            return CheckResult(False, 1, 0, 0, (1,),
                               (f"Invariant {name} is violated", self._trace([], 0, 0)), {})
        level = {"all_to_all": self._level_a2a, "all_gather": self._level_gather}[self.exchange]
        if self.host_stores is not None:
            level = self._level_hosted
        while True:
            faults.fire("level.start")
            if resilience.preempt_requested():
                raise resilience.Preempted(None, depth)
            if max_depth is not None and depth >= max_depth:
                break
            if presize and len(level_sizes) > forecast.MIN_LEVELS:
                self._maybe_presize(level_sizes, distinct, max_depth)
            if self.use_hashstore and distinct > D * self.vcap // 2:
                self._grow_visited(self.vcap * 4)
            t_level, copies0 = time.perf_counter(), self.stats.get("exchange_copies", 0)
            cap_c = self.cap_x  # may grow inside the level: read after it
            out = level(frontiers, n_f, cap_f, depth)
            cap_c = self.cap_x
            frontiers = out["frontiers"]
            ex = out["ex"]
            if (ex["abort_at"] < BIG).any():
                dev = int(np.nonzero(ex["abort_at"] < BIG)[0][0])
                gidx = dev * cap_f + int(ex["abort_at"][dev])
                return CheckResult(False, distinct, generated, depth, tuple(level_sizes), (
                    'Assert "split brain" (Raft.tla:185)', self._trace(trace_levels, depth, gidx)))
            mult_total += ex["mult"]
            generated += int(ex["mult"].sum())
            n_new = out["n_new"]
            nloc = np.asarray(out["nloc"], np.int64)
            reconcile("mesh owner exchange", n_new, int(nloc.sum()), level=depth + 1)
            if n_new == 0:
                break
            self.skew.note(depth + 1, rows=nloc)
            distinct += n_new
            level_sizes.append(n_new)
            self._cand_hist.append(out["cand"] / n_new)
            depth += 1
            if self.exchange == "all_gather":
                self._merge_gathered(distinct, out["new_sorted"])
            frontiers, n_f, cap_f = out["children"], [int(x) for x in nloc], cap_c
            gps, sls = out["trace"]
            trace_levels.append((gps, sls, cap_c))
            self.level_log.append(dict(
                level=depth, seconds=time.perf_counter() - t_level,
                exchange_copies=self.stats.get("exchange_copies", 0) - copies0,
                rows=[int(x) for x in nloc], cap_x=self.cap_x, cap_w=self.cap_w,
                vcap=self.vcap if self.use_hashstore else None))
            if self.progress is not None:
                self.progress(dict(level=depth, frontier=n_new, distinct=distinct,
                                   generated=generated, elapsed=time.monotonic() - t0))
            bad = out["bad"]
            if (bad >= 0).any():
                o = int(np.nonzero(bad >= 0)[0][0])
                trace = self._trace(trace_levels, depth, o * cap_c + int(bad[o]))
                name = self._kit(o).bad_invariant_name(frontiers[o], int(bad[o]))
                return CheckResult(False, distinct, generated, depth, tuple(level_sizes),
                                   (f"Invariant {name} is violated", trace))
        return CheckResult(True, distinct, generated, depth, tuple(level_sizes), None,
                           kit0.layout.action_counts(mult_total))
