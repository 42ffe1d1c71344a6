"""Level-synchronous BFS over the Raft state space, on one device.

The port of the single-device run loop of ``tla_raft_tpu/engine/bfs.py``
(``JaxChecker._run`` with late canonicalization and the device hash
store), with the reference's three arms:

* **supersteps** (the default, ``superstep=None`` -> span 4): up to four
  fused levels per CUDA graph, one launch and one read per superstep
  (engine/superstep.py);
* **the per-level fused program** (``superstep=1``): one CUDA graph launch
  and one read per level (engine/megakernel.py);
* **the staged chain** (``megakernel=False``), kept as the A/B and replay
  reference.

Routing follows the reference (bfs.py:4265-4620): a superstep runs while
the span left to ``max_depth`` is above 1 and the level is within the
fused size limit (``16 * G`` chunks, G = 16); a stopped superstep routes
its stopped level once through the per-level fused program, which grows
and redoes.  A level past the size limit runs on the **grouped chain**
(engine/group.py, the reference's ``grouping`` at bfs.py:3522) on every
arm, as in the reference: G chunks at a time through one captured group
graph that also drops the lanes the slab already holds, then one
probe-and-insert over the level's filtered lanes, with one control read.
All arms give the same counts, level sizes and traces.

The staged chain runs, per level:

1. per chunk of parents (``_expand_chunk``): inflate the sparse message
   ids to the bitmask, evaluate every slot's guard (kernel K1), compact
   the valid (parent, slot) lanes to ``cap_x`` lanes in lane order,
   materialize those candidates (K2) and fingerprint them (K3);
2. per level: one probe-and-insert of every candidate into the hash slab
   (K4) resolves uniqueness, visited membership and the min-(fp_full,
   payload) representative, and the fresh lanes compact to a prefix;
3. the survivors are materialized again, slice by slice, into the next
   frontier (K2), and the invariants are scanned.

Payloads are global (``parent * K + slot``), compaction keeps lane order
and the representative is a minimum, so the counts, the slab bytes and
the traces do not depend on the chunk size or on the route.  Every lane
budget grows and redoes the level on overflow: ``cap_x`` (candidates per
chunk), ``cap_g`` (a group's unvisited lanes), the slab (probe depth), K4's
claim rounds and ``cap_m`` (message ids per state).  The split-brain
Assert stops the run with a trace; so does an invariant violation.

Under a device budget for the visited set (``store_bytes``, the CLI's
``--dev-bytes``; store/tiered.py) the hot slab demotes its fingerprints
to a host generation instead of growing past the budget (the reference's
``_slab_grow_or_demote`` :3285, ``_tier_drain`` :3312), and every level's
fresh states are probed against the generations: the fused level skips
that probe when its in-graph sieve probe (B13, now over the spill sieve's
words) counted no hit; a superstep level with hits stops the window on
``FLAG_TIER`` and replays alone; the grouped and staged tails always
probe.  Revisits found there leave the new frontier (``drop_rows``, B16)
and stay in the hot slab (the re-heat), so the counts equal the hot-only
run's.

Under orbit pruning (``orbit=True`` or ``TLA_RAFT_ORBIT=1``, the
reference's flag, bfs.py:721-738) every candidate is fingerprinted by
the canonical-relabel definition (ops/fingerprint.py, B17): the fused
level and the supersteps are off, as in the reference, so a level runs
the staged chain, or the grouped chain past the size limit, with the
orbit kernel and the tied rows' fold (on a ``cap_nd = max(256, cap_x //
4)`` budget; more tied rows than that redo the level as a cap_x overflow)
in place of K3.  The root takes the fold (it is symmetric, not discrete).
The counts, level sizes and traces equal the default definition's; the
fingerprint values do not, so a slab or frontier carried across from the
reference must come from a run with the same flag.

The order-keeping compactions, inflate/deflate of the message sets and
the invariant scan are kernels too (csrc/compact.cu, msgset.cu,
invariants.cu); each function here that wraps one sends CPU tensors to
its plain twin and CUDA tensors to the kernel.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import RaftConfig
from ..device import READS, fetch, resolve_device
from ..models.raft import Frontier, RaftState, core_of, id_dtype, init_batch, to_oracle
from ..ops import hashstore
from ..ops import sieve as sieve_ops
from ..ops.fingerprint import Fingerprinter
from ..ops.hashstore import DeviceHashStore, compact_fresh, probe_and_insert
from ..ops.msg_universe import get_universe
from ..ops.mxu_expand import MXUExpand
from ..ops.successor import GuardTables
from ..store import tiered
from ..u64 import SENT
from . import forecast
from . import group
from . import megakernel as mk
from . import superstep as ss
from .invariants import inv_scan_plain, needs_msgs, resolve_invariant_kernel

I64 = torch.int64
BIG = 1 << 62


class CheckResult(NamedTuple):
    """Same shape as the reference's CheckResult."""

    ok: bool
    distinct: int
    generated: int
    depth: int
    level_sizes: tuple
    violation: tuple | None  # (kind, [(action, OState), ...])
    action_counts: dict | None = None


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _cap_steps(n: int) -> int:
    """Smallest c >= n in {2^k, 3 * 2^(k-1)}."""
    p = _pow2(n)
    half = 3 * (p >> 2)
    return half if half >= n and half > 0 else p


# the main path's lane budget per guard launch: chunk * K at S = 3 (K = 696)
LANE_BUDGET = 16384 * 696


def default_chunk(K: int) -> int:
    """Parents per guard launch for K slots: the largest power of two at or
    below ``LANE_BUDGET / K``, at most 16,384 (S = 3: 16,384; S = 5, K =
    1,900: 4,096; S = 7, K = 3,696: 2,048), so the guard launch keeps the
    S = 3 lane count as S grows, as the reference's bench.py:847-852 scales
    its chunk."""
    return min(16384, 1 << max(0, (LANE_BUDGET // max(K, 1)).bit_length() - 1))


def compact_payloads(valid_flat: torch.Tensor, payload: torch.Tensor, cap_x: int):
    """The valid lanes' payloads packed to ``cap_x`` lanes in lane order.

    Returns (payload i64[cap_x] (-1 beyond the valid prefix), lane
    bool[cap_x], overflow 0-d bool: more valid lanes than ``cap_x``).
    The compaction kernel on the card, the plain twin on the CPU."""
    if valid_flat.device.type == "cpu":
        return compact_payloads_plain(valid_flat, payload, cap_x)
    out, _ob, lane, total = kernels.compact(valid_flat, payload, -1, cap_x, want_lane=True)
    return out, lane, total > cap_x


def compact_payloads_plain(valid_flat: torch.Tensor, payload: torch.Tensor, cap_x: int):
    """Plain twin of ``compact_payloads``: cumsum + trash-slot scatter."""
    dest = torch.cumsum(valid_flat.to(I64), 0) - 1
    n_live = dest[-1] + 1 if dest.numel() else torch.zeros((), dtype=I64, device=payload.device)
    keep = valid_flat & (dest < cap_x)
    tgt = torch.where(keep, dest, torch.full_like(dest, cap_x))
    out = torch.full((cap_x + 1,), -1, dtype=I64, device=payload.device)
    out.scatter_(0, tgt, payload)
    lane = torch.arange(cap_x, device=payload.device) < n_live
    return out[:cap_x], lane, n_live > cap_x


def ids_to_msgs(ids: torch.Tensor, n_words: int) -> torch.Tensor:
    """Sparse ids [n, cap_m] (-1 padded) -> packed int32 words [n, n_words]:
    the inflate kernel on the card, the plain twin on the CPU."""
    if ids.device.type == "cpu":
        return ids_to_msgs_plain(ids, n_words)
    return kernels.inflate(ids, n_words)


def ids_to_msgs_plain(ids: torch.Tensor, n_words: int) -> torch.Tensor:
    """Plain twin of ``ids_to_msgs``.  Ids are unique per state, so
    summing the one-bit words is the OR."""
    n = ids.shape[0]
    idl = ids.to(I64)
    live = idl >= 0
    word = torch.where(live, idl >> 5, torch.full_like(idl, n_words))
    bit = torch.where(live, torch.ones_like(idl) << (idl & 31), torch.zeros_like(idl))
    acc = torch.zeros((n, n_words + 1), dtype=I64, device=ids.device)
    acc.scatter_add_(1, word, bit)
    w = acc[:, :n_words]
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def msgs_to_ids(msgs: torch.Tensor, M: int, cap_m: int, id_dtype):
    """Packed words -> (ascending -1-padded ids [n, cap_m], overflow
    bool[n]): the deflate kernel on the card, the plain twin on the CPU."""
    if msgs.device.type == "cpu":
        return msgs_to_ids_plain(msgs, M, cap_m, id_dtype)
    return kernels.deflate(msgs, M, cap_m, id_dtype)


def msgs_to_ids_plain(msgs: torch.Tensor, M: int, cap_m: int, id_dtype):
    """Plain twin of ``msgs_to_ids``: unpack, cumsum ranks, scatter."""
    sh = torch.arange(32, dtype=torch.int32, device=msgs.device)
    bits = ((msgs[:, :, None] >> sh) & 1).reshape(msgs.shape[0], -1)[:, :M].to(torch.bool)
    n_set = bits.sum(1)
    pos = torch.cumsum(bits.to(I64), 1) - 1
    ar = torch.arange(M, dtype=I64, device=msgs.device).expand_as(pos)
    tgt = torch.where(bits & (pos < cap_m), pos, torch.full_like(pos, cap_m))
    out = torch.full((msgs.shape[0], cap_m + 1), -1, dtype=I64, device=msgs.device)
    out.scatter_(1, tgt, ar)
    return out[:, :cap_m].to(id_dtype), n_set > cap_m


class TorchChecker:
    """The model checker for one RaftConfig on one device.

    Parameters:
      device: ``None`` (the card; raises without CUDA), "cuda" or "cpu".
      chunk: parents expanded per guard launch (``None``: ``default_chunk``).
      cap_x: compacted candidate lanes per chunk (grows on overflow).
      cap_m: message ids per frontier state (grows on overflow).
      progress: optional callable(level_stats_dict).
      megakernel: the fused level (``None``: on); ``False`` selects the
        staged chain.
      superstep: levels per superstep (``None``: 4); 1 selects the
        per-level fused program.
      store_bytes: the hot slab's device budget in bytes (``None``:
        ``TLA_RAFT_STORE_BYTES``; 0: no budget).  Past it the slab demotes
        to host generations (store/tiered.py); the counts do not change.
      orbit: orbit-pruned fingerprints (``None``: ``TLA_RAFT_ORBIT``, as the
        reference reads it); turns the fused level and supersteps off.
    """

    def __init__(
        self,
        cfg: RaftConfig,
        device=None,
        chunk: int | None = None,
        cap_x: int | None = None,
        cap_m: int = 96,
        progress: Callable[[dict], None] | None = None,
        megakernel: bool | None = None,
        superstep: int | None = None,
        store_bytes: int | None = None,
        orbit: bool | None = None,
    ):
        self.cfg = cfg
        if orbit is None:
            env = os.environ.get("TLA_RAFT_ORBIT")
            orbit = bool(int(env)) if env else False
        self.orbit = bool(orbit)
        self.device = resolve_device(device)
        self.uni = get_universe(cfg)
        self.fpr = Fingerprinter(cfg, device=self.device)
        self.mx = MXUExpand(cfg, self.device)
        self.layout = self.mx.layout
        self.tables = GuardTables(cfg, self.device)
        self.K = self.layout.K
        if chunk is None:
            chunk = default_chunk(self.K)
        if chunk & (chunk - 1):
            raise ValueError(f"chunk must be a power of two, got {chunk}")
        self.chunk = int(chunk)
        self.cap_x = int(cap_x or 4 * chunk)
        self.cap_m = min(int(cap_m), self.uni.M)
        self.id_dtype = id_dtype(cfg)
        self.progress = progress
        for name in cfg.invariants:
            resolve_invariant_kernel(name)  # an unknown name raises here
        self.hstore: DeviceHashStore | None = None
        self.frontier: Frontier | None = None  # the last committed level's rows
        self.redos = dict(cap_x=0, slab=0, cap_m=0, cap_g=0)  # every route's redos
        # the fused level and the supersteps fingerprint with K3 alone: orbit
        # runs the staged and grouped chains (bfs.py:738)
        self.megakernel = (megakernel is None or bool(megakernel)) and not self.orbit
        if self.orbit:
            self.fpr.orbit_tables  # on the card now: a first launch may be in a capture
        if superstep is None:
            superstep = ss.DEFAULT_SPAN
        self.superstep_span = max(1, int(superstep)) if self.megakernel else 1
        # chunks per group (bfs.py:558): fused levels hold <= 16 * G chunks,
        # larger ones run grouped; a group keeps <= cap_g unvisited lanes
        self.G = 16
        self.cap_g = self.G * self.cap_x // 2
        self.k4_rounds = mk.DEFAULT_ROUNDS  # claim rounds per K4 call in a graph
        if store_bytes is None:
            store_bytes = tiered.store_bytes_from_env()
        self.store_bytes = int(store_bytes)
        self.tiered: tiered.TieredVisitedStore | None = None  # built in run()
        self._sieve_empty = None  # the 1-word all-miss sentinel
        self._sieve_dev = None  # the spill sieve's device copy, full size once made
        self._sieve_ver = -1
        self.tier_soft_seats = 0  # levels seated past the budget (soft overshoot)
        self._mega_stats = dict(levels=0, redo_out=0, redo_x=0, redo_slab=0, redo_m=0,
                                redo_rounds=0)
        self._ss_stats = dict(supersteps=0, levels=0, stops=0, ring_stops=0)
        self.graph_stats = dict(programs=0, captures=0, capture_seconds=0.0, level_launches=0,
                                level_redo_launches=0, superstep_launches=0, group_launches=0,
                                copies=0, capture_log=[], launch_log=[])
        self.level_timing: dict = {}  # host seconds of the last fused level, by step
        # levels committed by route
        self.routes = dict(superstep=0, fused=0, grouped=0, staged=0)
        self.k4_round_log: list = []  # claim rounds of every fused level run
        self.group_log: list = []  # one record per grouped level
        self._progs = mk.ProgramCache()

    # -- sparse <-> dense message sets ------------------------------------

    def inflate(self, fr: Frontier) -> RaftState:
        return RaftState(msgs=ids_to_msgs(fr.msg_ids, self.uni.n_words), **core_of(fr))

    def deflate(self, st: RaftState):
        ids, ovf = msgs_to_ids(st.msgs, self.uni.M, self.cap_m, self.id_dtype)
        return Frontier(msg_ids=ids, **core_of(st)), ovf

    def widen(self, fr: Frontier) -> Frontier:
        """Pad the frontier's id lists out to ``self.cap_m``."""
        pad = self.cap_m - fr.msg_ids.shape[1]
        if pad <= 0:
            return fr
        fill = torch.full((fr.msg_ids.shape[0], pad), -1, dtype=fr.msg_ids.dtype,
                          device=fr.msg_ids.device)
        return fr._replace(msg_ids=torch.cat([fr.msg_ids, fill], 1))

    # -- invariants ---------------------------------------------------------

    def inv_scan(self, fr: Frontier, offset: int = 0, into=None, names=None) -> torch.Tensor:
        """First row (+ ``offset``) violating a configured invariant (or
        one of ``names``), or -1, as a 0-d tensor; with ``into`` (an
        earlier result) the smaller bad row of the two.  The invariant
        kernel on the card, the plain twin on the CPU."""
        names = list(self.cfg.invariants if names is None else names)
        if fr.msg_ids.device.type == "cuda":
            return kernels.inv_scan(self.cfg, self.uni, fr, names, offset, into)
        st = self.inflate(fr) if any(needs_msgs(n) for n in names) else fr
        bad = inv_scan_plain(self.cfg, st, names, self.tables, offset)
        if into is None:
            return bad
        return torch.where((into >= 0) & ((bad < 0) | (into < bad)), into, bad)

    def bad_invariant_name(self, fr: Frontier, idx: int) -> str:
        one = Frontier(*(x[idx : idx + 1] for x in fr))
        for name in self.cfg.invariants:
            if int(self.inv_scan(one, names=[name])) >= 0:
                return name
        return self.cfg.invariants[0]

    # -- one level ------------------------------------------------------------

    @property
    def cap_nd(self) -> int:
        """Tied candidate rows a chunk folds under orbit pruning (bfs.py:1070)."""
        return max(256, self.cap_x // 4)

    def _fp_states(self, fr: Frontier):
        """(fp_view, fp_full) of a small batch (the root) under the run's
        definition: under orbit both routes, selected by ``discrete``
        (bfs.py:1078)."""
        fv, ff = self.fpr.state_fingerprints(fr)
        if not self.orbit:
            return fv, ff
        ov, of, disc, _rank = self.fpr.state_fingerprints_orbit(fr)
        return torch.where(disc, ov, fv), torch.where(disc, of, ff)

    def _expand_chunk(self, part_f: Frontier, start: int):
        """Guards, compaction, materialize and fingerprints of one chunk."""
        K = self.K
        B = part_f.voted_for.shape[0]
        valid, mult, abort = self.mx.guards(self.inflate(part_f))
        mult_slots = mult.to(I64).sum(0)
        first = start + torch.argmax(abort.to(torch.int32)).to(I64)
        abort_at = torch.where(abort.any(), first, torch.full_like(first, BIG))
        rows = start + torch.arange(B, dtype=I64, device=self.device)
        payload = (rows[:, None] * K + torch.arange(K, dtype=I64, device=self.device)).reshape(-1)
        cp_raw, lane, ovf_x = compact_payloads(valid.reshape(-1), payload, self.cap_x)
        lidx = (torch.div(cp_raw, K, rounding_mode="floor") - start).clamp(0, B - 1)
        children, _added, ovf_rows = self.mx.materialize(part_f, lidx, cp_raw % K)
        if self.orbit:
            # the tied rows' budget overflow redoes the level as a cap_x one
            fv, ff, ovf_nd = self.fpr.orbit_chunk_fps(children, self.cap_nd, lane.sum())
            ovf_x = ovf_x | (ovf_nd > 0)
        else:
            fv, ff = self.fpr.state_fingerprints(children)
        sent = torch.full_like(fv, SENT)
        cv = torch.where(lane, fv, sent)
        cf = torch.where(lane, ff, sent)
        cp = torch.where(lane, cp_raw, torch.full_like(cp_raw, -1))
        return cv, cf, cp, mult_slots, abort_at, ovf_x, (ovf_rows & lane).any()

    def expand_level(self, frontier: Frontier, n_f: int, slab: torch.Tensor) -> dict:
        """Expand every chunk, then dedup the level against ``slab``.

        Returns host-side control values (n_new, abort_at, overflow
        flags, per-slot multiplicities) and the device-side survivors
        (new_fps, new_payload in payload order, and ``slab``, into which
        they were inserted in place).  A level whose candidate or message
        budget overflowed inserts nothing; one whose insert overflowed
        leaves ``slab`` as it was."""
        cvs, cfs, cps = [], [], []
        mult = torch.zeros((self.K,), dtype=I64, device=self.device)
        abort_at = torch.full((), BIG, dtype=I64, device=self.device)
        ovf_x = torch.zeros((), dtype=torch.bool, device=self.device)
        ovf_m = torch.zeros((), dtype=torch.bool, device=self.device)
        for start in range(0, n_f, self.chunk):
            # rows past n_f are not parents (a fused level's buffer is larger)
            part = Frontier(*(x[start : min(start + self.chunk, n_f)] for x in frontier))
            cv, cf, cp, m, ab, ox, om = self._expand_chunk(part, start)
            cvs.append(cv)
            cfs.append(cf)
            cps.append(cp)
            mult = mult + m
            abort_at = torch.minimum(abort_at, ab)
            ovf_x = ovf_x | ox
            ovf_m = ovf_m | om
        ctl = torch.cat([torch.stack([abort_at, ovf_x.to(I64), ovf_m.to(I64)]), mult])
        (ctl,) = fetch(ctl, what="staged_expand")  # the expand pass's one control fetch
        out = dict(abort_at=int(ctl[0]), ovf_x=bool(ctl[1]), ovf_m=bool(ctl[2]), ovf_h=False,
                   mult=ctl[3:].copy(), n_new=0, new_fps=None, new_payload=None, slab=slab)
        if out["ovf_x"] or out["ovf_m"] or out["abort_at"] < n_f:
            return out  # the level is redone or the run stops: insert nothing
        cv, cf, cp = torch.cat(cvs), torch.cat(cfs), torch.cat(cps)
        slab, fresh, n_new, ovf_h = probe_and_insert(slab, cv, cf, cp)
        new_fps, new_payload = compact_fresh(fresh, cv, cp, cv.shape[0])
        (nv,) = fetch(torch.stack([n_new.to(I64), ovf_h.to(I64)]), what="staged_insert")
        n_new, ovf_h = int(nv[0]), int(nv[1])
        out.update(n_new=n_new, ovf_h=bool(ovf_h), new_fps=new_fps, new_payload=new_payload,
                   slab=slab)
        return out

    def materialize_level(self, frontier: Frontier, new_payload: torch.Tensor, n_new: int):
        """The next frontier from the survivors' payloads, slice by slice:
        (frontier, first bad row or -1, cap_m overflow)."""
        K = self.K
        sl = 8 * self.chunk
        parts, ovfs = [], []
        bad = None
        for a in range(0, n_new, sl):
            pay = new_payload[a : min(a + sl, n_new)]
            pidx = torch.div(pay, K, rounding_mode="floor")
            child, _added, ovf = self.mx.materialize(frontier, pidx, pay % K)
            parts.append(child)
            bad = self.inv_scan(child, offset=a, into=bad)
            ovfs.append(ovf.any())
        new = Frontier(*(torch.cat([getattr(p, f) for p in parts]) for f in Frontier._fields))
        (ctl,) = fetch(torch.stack([bad, torch.stack(ovfs).any().to(I64)]), what="staged_mat")
        return new, int(ctl[0]), bool(ctl[1])

    # -- traces -----------------------------------------------------------------

    def trace(self, levels: list, level: int, idx: int) -> list:
        """Walk (parent, slot) records back to Init, replay forward."""
        chain = []
        d, j = level, idx
        while d > 0:
            pidx, slots = levels[d - 1]
            chain.append(int(slots[j]))
            j = int(pidx[j])
            d -= 1
        chain.reverse()
        fr, _ovf = self.deflate(init_batch(self.cfg, 1, self.device))
        out = [("Init", to_oracle(self.cfg, self.inflate(fr))[0])]
        zero = torch.zeros((1,), dtype=I64, device=self.device)
        for slot in chain:
            fr, _added, _ovf = self.mx.materialize(
                fr, zero, torch.full((1,), slot, dtype=I64, device=self.device)
            )
            out.append((self.layout.action_name(slot), to_oracle(self.cfg, self.inflate(fr))[0]))
        return out

    # -- the fused level and supersteps ------------------------------------------

    def _frontier_cap(self, n: int) -> int:
        """Frontier capacity for n states: half-step quantized when the
        step is a chunk multiple, else pow2; at least one chunk."""
        c = _cap_steps(n)
        if c % self.chunk:
            c = _pow2(n)
        return max(c, self.chunk)

    def _rows_cap(self, fr: Frontier) -> int:
        """A frontier buffer's capacity as the fused level seats it: its
        rows rounded up to a chunk multiple."""
        rows = fr.voted_for.shape[0]
        return max(self.chunk, -(-rows // self.chunk) * self.chunk)

    def _mega_level_ok(self, n_f: int) -> bool:
        """Fused levels hold at most 16 * G chunks of parents
        (bfs.py:1166); larger levels run grouped."""
        return self.megakernel and -(-max(n_f, 1) // self.chunk) <= 16 * self.G

    def _mega_cap_out(self, n_f, level_sizes, max_depth, n_lanes, floor) -> int:
        """The fused level's new-frontier capacity (bfs.py:1180): the
        margined forecast when there is signal (at least 2 * n_f), else
        4 * n_f; at least ``floor``, at most the lane budget, quantized,
        and at least 4 chunks."""
        est = 0
        if len(level_sizes) > forecast.MIN_LEVELS:
            fut = forecast.forecast_new_states(level_sizes, max_depth)
            if fut:
                est = max(int(fut[0] * forecast.cap_margin()) + 1, 2 * max(n_f, 1))
        if not est:
            est = 4 * max(n_f, 1)
        est = max(est, floor)
        return max(self._frontier_cap(min(est, max(n_lanes, 1))), 4 * self.chunk)

    def _superstep_span_at(self, max_depth, depth) -> int:
        span = self.superstep_span
        if max_depth is not None:
            span = min(span, max_depth - depth)
        return span

    def _superstep_shapes(self, fut, span, n_rows, cap_cur):
        """One superstep's static (cap_f, ring) (bfs.py:1645)."""
        if fut:
            est = max(int(max(fut) * forecast.cap_margin()) + 1, 2 * max(n_rows, 1))
        else:
            est = 4 * max(n_rows, 1)
        cap_f = max(self._frontier_cap(est), 4 * self.chunk, cap_cur)
        # resident levels stay inside the fused size limit: a bigger level
        # stops the window on FLAG_OVF_OUT and re-enters the routing
        cap_f = min(cap_f, max(16 * self.G * self.chunk, 4 * self.chunk, cap_cur))
        ring = ss.ring_capacity(fut, span, cap_f, forecast.pow2ceil)
        return cap_f, ring

    def _program(self, key, build):
        """The captured program of ``key`` at the current budgets, slab and
        sieve words (a program built for others is dropped: its graph
        holds their addresses)."""
        slab = self.hstore.slab
        sieve = self._sieve_operand()
        sig = (self.cap_x, self.cap_m, self.k4_rounds, slab.data_ptr(), slab.shape[0],
               sieve.data_ptr(), sieve.shape[0])
        self._progs.drop_stale(sig)

        def built():
            self.graph_stats["programs"] += 1
            return build(sig)

        return self._progs.get(key + sig, built)

    def _seat(self, dst: Frontier, src: Frontier, n: int) -> None:
        """The parents into a program's input buffer (a device copy, none
        when they are there already)."""
        if dst.voted_for.data_ptr() == src.voted_for.data_ptr():
            return
        mk.copy_rows(dst, src, n)
        self.graph_stats["copies"] += 1

    def _log_launch(self, prog, levels: int) -> None:
        """[kind, cap_f, kernel launches, levels committed] per graph launch:
        the launches of chunks past n_f and slices past n_new are the
        static shape's dead work."""
        tally = prog.tally.per_replay if prog.tally is not None else {}
        self.graph_stats["launch_log"].append(
            [prog.kind, prog.cap_f, sum(tally.values()), levels])

    def _grow_cap_x(self) -> None:
        """Half-step growth of cap_x; cap_g stays at least G * cap_x / 2
        (bfs.py:4673)."""
        self.cap_x = _cap_steps(self.cap_x + 1)
        self.cap_g = max(self.cap_g, self.G * self.cap_x // 2)
        self.redos["cap_x"] += 1

    def _grow_slab(self, depth: int, expected: int) -> None:
        """A probe overflow's slab growth, or a demotion under the budget."""
        if self._slab_grow_or_demote(depth, expected=expected) == "demoted":
            self.tiered.stats["tier_redos"] += 1
        self.redos["slab"] += 1

    def _check_occupancy(self, slab_live: int) -> None:
        """The conservation signal: the slab's live slots, counted on the
        device, equal the hot tier's count (the distinct states while
        nothing is demoted)."""
        if slab_live != self.hstore.count:
            raise RuntimeError(
                f"device hash slab holds {slab_live} fingerprints, expected {self.hstore.count}"
            )

    def _expand_level_mega(self, frontier, n_f, max_depth, level_sizes) -> dict:
        """One level as one graph launch and one read (bfs.py:1222); every
        overflow grows its budget and redoes the level against the slab as
        it was (the graph gave any claims back)."""
        out_floor = 0
        t = self.level_timing = dict(seat=0.0, launch=0.0, wait=0.0, post=0.0, runs=0)
        while True:
            t0 = time.perf_counter()
            cap_f = self._rows_cap(frontier)
            n_lanes = (cap_f // self.chunk) * self.cap_x
            cap_out = self._mega_cap_out(n_f, level_sizes, max_depth, n_lanes, out_floor)
            key = ("level", cap_f, cap_out, self.chunk)
            prog = self._program(key, lambda sig: mk.LevelProgram(
                self, key + sig, cap_f, cap_out, self.k4_rounds))
            self._seat(prog.fr_in, frontier, n_f)
            # the parents from here on: the launch rewrites its output buffer,
            # which may be where they came from
            frontier = prog.fr_in
            t1 = time.perf_counter()
            prog.run(n_f)
            t2 = time.perf_counter()
            ctrl, lc, mult, fps, pidx, slot = fetch(
                prog.ctrl, prog.lc, prog.mult, prog.fps_out, prog.pidx, prog.slot, what="level")
            t3 = time.perf_counter()
            t["seat"] += t1 - t0
            t["launch"] += t2 - t1
            t["wait"] += t3 - t2
            t["runs"] += 1
            self._log_launch(prog, 1)
            n_new = int(ctrl[mk.CTRL_N_NEW])
            self.k4_round_log.append(int(lc[mk.LC_ROUNDS]))
            if lc[mk.LC_OVF_ROUNDS]:
                self.k4_rounds *= 2
                self._mega_stats["redo_rounds"] += 1
                continue
            if ctrl[mk.CTRL_OVF_SLAB]:
                self._grow_slab(len(level_sizes), max(n_new, n_f))
                self._mega_stats["redo_slab"] += 1
                continue
            if ctrl[mk.CTRL_OVF_X]:
                self._grow_cap_x()
                self._mega_stats["redo_x"] += 1
                continue
            if n_new > cap_out:
                out_floor = n_new  # the exact count is known: one redo lands it
                self._mega_stats["redo_out"] += 1
                continue
            if int(ctrl[mk.CTRL_ABORT]) < n_f:
                break  # the violation stops the run; nothing was inserted
            if ctrl[mk.CTRL_OVF_M]:
                frontier = self._grow_cap_m(frontier)
                self._mega_stats["redo_m"] += 1
                continue
            break
        self._mega_stats["levels"] += 1
        self.graph_stats["level_redo_launches"] += t["runs"] - 1
        t3 = time.perf_counter()
        out = dict(
            n_new=n_new, abort_at=int(ctrl[mk.CTRL_ABORT]), bad_idx=int(ctrl[mk.CTRL_BAD]),
            slab_live=int(ctrl[mk.CTRL_SLAB_LIVE]), tier_hits=int(ctrl[mk.CTRL_TIER_HITS]),
            level_mult=mult.copy(),
            new_frontier=prog.fr_out, parent=frontier,
            fps=fps[:n_new].view(np.uint64),  # valid until the next fused level's read
            pidx=pidx[:n_new].view(np.uint32).copy(),
            slot=slot[:n_new].view(np.uint16).copy(),
        )
        t["post"] += time.perf_counter() - t3
        return out

    def _run_superstep(self, frontier, n_f, max_depth, depth, level_sizes) -> dict:
        """Up to ``superstep_span`` levels as one graph launch and one read
        (bfs.py:1675)."""
        span = self._superstep_span_at(max_depth, depth)
        cap_cur = self._rows_cap(frontier)
        fut = forecast.forecast_new_states(level_sizes, max_depth)[:span]
        cap_f, ring = self._superstep_shapes(fut, self.superstep_span, n_f, cap_cur)
        # slab room for the whole span's inserts before it starts
        if fut:
            m = forecast.cap_margin()
            ins_bound = sum(min(int(f * m) + 1, cap_f) for f in fut)
        else:
            ins_bound = 2 * max(n_f, 1)
        self._tier_reserve(self.hstore.count + max(ins_bound, 2 * max(n_f, 1)))
        # the ring size is a device word: one program per cap_f serves
        # every ring up to its span * cap_f ceiling
        key = ("superstep", cap_f, self.superstep_span, self.chunk)
        ring_max = forecast.pow2ceil(self.superstep_span * cap_f)
        prog = self._program(key, lambda sig: ss.SuperstepProgram(
            self, key + sig, cap_f, ring_max, self.superstep_span, self.k4_rounds))
        self._seat(prog.fr[0], frontier, n_f)
        prog.run(n_f, span, ring)
        ctrl, mn, mm, mr, rf, rp, rs = fetch(
            prog.ss[: ss.SS_CTRL], prog.meta_n, prog.meta_mult, prog.meta_rounds,
            prog.ring_fps[:ring], prog.ring_pidx[:ring], prog.ring_slot[:ring],
            what="superstep")
        recs, reason, n_f_out, slab_live, flags = ss.unpack_ring(ctrl, mn, mm, rf, rp, rs)
        self._log_launch(prog, len(recs))
        ran = min(len(recs) + int(reason == "stop" or reason == "ring"), span)
        self.k4_round_log.extend(int(x) for x in mr[:ran])
        self._ss_stats["supersteps"] += 1
        self._ss_stats["levels"] += len(recs)
        if reason == "stop":
            self._ss_stats["stops"] += 1
        elif reason == "ring":
            self._ss_stats["ring_stops"] += 1
        return dict(recs=recs, frontier=prog.fr[0], n_total=sum(r["n_new"] for r in recs),
                    n_f=n_f_out, reason=reason, slab_live=slab_live, flags=flags)

    def _grow_for_stop(self, flags: int, frontier: Frontier, depth: int, n_f: int) -> Frontier:
        """Grow the budget a stopped superstep names before the per-level
        replay (bfs.py:4495-4569), so the replay's first attempt lands; a
        slab that may not grow demotes instead.  A stop on sieve hits
        (FLAG_TIER) grows nothing: the replay's level tail probes."""
        if flags & ss.FLAG_OVF_X:
            self._grow_cap_x()
            self._mega_stats["redo_x"] += 1
        if flags & ss.FLAG_OVF_SLAB:
            if self._slab_grow_or_demote(depth + 1, expected=max(n_f, 1)) == "demoted":
                self._ss_stats["tier_stops"] = self._ss_stats.get("tier_stops", 0) + 1
                self.tiered.stats["tier_redos"] += 1
            self.redos["slab"] += 1
            self._mega_stats["redo_slab"] += 1
        if flags & ss.FLAG_OVF_M and self.cap_m < self.uni.M:
            frontier = self._grow_cap_m(frontier)
            self._mega_stats["redo_m"] += 1
        if flags & ss.FLAG_OVF_ROUNDS:
            self.k4_rounds *= 2
            self._mega_stats["redo_rounds"] += 1
        if flags & ss.FLAG_TIER:
            self._ss_stats["sieve_stops"] = self._ss_stats.get("sieve_stops", 0) + 1
        return frontier

    # -- the tiered visited store (bfs.py:3207-3375) ---------------------------------

    def _tier_on(self) -> bool:
        """A device budget bounds the hot slab."""
        return self.tiered is not None

    def _tier_active(self) -> bool:
        """At least one generation is demoted: level tails must probe."""
        return self._tier_on() and self.tiered.active

    def _sieve_operand(self) -> torch.Tensor:
        """The sieve words the fused programs probe: the 1-word all-miss
        sentinel, or the spill sieve's device copy, allocated at full size
        once and refreshed in place when the host filter changed (the
        captured graphs keep its address).  The spill sieve holds every
        demoted fingerprint and is always armed (the reference's
        ``_sieve_ready`` without its governor)."""
        if not self._tier_active():
            if self._sieve_empty is None:
                self._sieve_empty = sieve_ops.empty_sieve(self.device)
            return self._sieve_empty
        sv = self.tiered.spill_sieve
        if self._sieve_dev is None:
            self._sieve_dev = torch.zeros((len(sv.words),), dtype=I64, device=self.device)
        if self._sieve_ver != sv.version:
            self._sieve_dev.copy_(torch.from_numpy(sv.words.view(np.int64)))
            self._sieve_ver = sv.version
        return self._sieve_dev

    def _demote_generation(self, depth: int, expected: int = 0) -> None:
        """The hot slab's fingerprints become one warm generation and the
        slab restarts empty, sized to seat the level in flight (past the
        budget if its fresh set alone is larger: the drain at the next
        level top takes it back)."""
        (vb,) = fetch(self.hstore.slab, what="demote")
        self.tiered.demote(vb.view(np.uint64))
        want = hashstore.slab_rows(max(2 * max(expected, 1), hashstore.MIN_CAP // 2))
        if not self.tiered.slab_fits(want):
            want = max(min(want, hashstore.slab_rows(max(expected, 1))), hashstore.MIN_CAP)
        self.hstore = DeviceHashStore(cap=want, device=self.device)
        soft = not self.tiered.slab_fits(self.hstore.cap)
        self.tier_soft_seats += int(soft)
        gens = self.tiered.gens
        print(f"[tiered] hot slab demoted to generation {gens[-1].gid if gens else '-'} at level "
              f"{depth} ({self.tiered.spilled_distinct()} fps across {len(gens)} gen(s)); hot "
              f"restarts at {self.hstore.cap} slots"
              + (" (over the budget for one level's fresh set)" if soft else ""), file=sys.stderr)

    def _slab_grow_or_demote(self, depth: int, expected: int = 0,
                             min_cap: int | None = None) -> str:
        """Grow the slab while the grown slab fits the budget, else demote
        (with content to demote) or seat one level's fresh set past the
        budget, drained at the next level top.  "grew" or "demoted"."""
        want = max(self.hstore.cap * 2, min_cap or 0)
        want = 1 << (want - 1).bit_length()
        if self._tier_on() and not self.tiered.slab_fits(want):
            if self.hstore.count > 0:
                self._demote_generation(depth, expected=expected)
                return "demoted"
            self.tier_soft_seats += 1
            print(f"[tiered] level {depth}: the fresh set exceeds the hot budget even after "
                  f"demotion; seating it at {want} slots", file=sys.stderr)
        self.hstore.grow(min_cap=min_cap)
        return "grew"

    def _tier_drain(self, depth: int, n_next: int) -> None:
        """At the loop top: demote a slab over the budget, or one whose next
        growth would pass it (the superstep windows' only drain site)."""
        if not self._tier_on() or self.hstore.count == 0:
            return
        over = not self.tiered.slab_fits(self.hstore.cap)
        grow_needed = self.hstore.need_grow(extra=2 * max(n_next, 1))
        if over or (grow_needed and not self.tiered.slab_fits(self.hstore.cap * 2)):
            self._demote_generation(depth, expected=2 * max(n_next, 1))

    def _tier_reserve(self, entries: int) -> None:
        """``hstore.reserve`` clamped to the budget's entries."""
        if self._tier_on() and self.tiered.max_hot_entries:
            entries = min(entries, self.tiered.max_hot_entries)
        self.hstore.reserve(int(entries))

    def _tier_filter_level(self, depth: int, n_new: int, fps_np, new_frontier: Frontier):
        """The level tail's generation probe: the fresh rows that revisit a
        demoted fingerprint leave the new frontier (``drop_rows``); their
        fingerprints stay in the hot slab.  (n_keep, keep mask or None,
        new frontier)."""
        hits = self.tiered.probe(fps_np[:n_new])
        n_hit = int(hits.sum())
        if not n_hit:
            return n_new, None, new_frontier
        self.tiered.stats["reheats"] += n_hit
        keep = ~hits
        n_keep = n_new - n_hit
        if n_keep:
            mask = np.zeros(new_frontier.voted_for.shape[0], bool)
            mask[:n_new] = keep
            new_frontier = tiered.drop_rows(new_frontier, torch.from_numpy(mask).to(self.device),
                                            n_keep)
        return n_keep, keep, new_frontier

    # -- the run ------------------------------------------------------------------

    def _grouping(self, n_f: int) -> bool:
        """Levels of more than 16 * G chunks run grouped (bfs.py:3522)."""
        return -(-max(n_f, 1) // self.chunk) > 16 * self.G

    def _expand_level_grouped(self, frontier: Frontier, n_f: int, depth: int) -> tuple:
        """One grouped level with its grow-and-redo (bfs.py:4620-4677):
        (result, parent frontier).  Every redo runs against the slab as it
        was before the level."""
        groups = -(-max(n_f, 1) // (self.G * self.chunk))
        while True:
            # the lane buffer's groups, quantized: one program serves nearby levels
            res = group.expand_level_grouped(self, frontier, n_f, _cap_steps(groups))
            if not (res["ovf_x"] or res["ovf_g"] or res["ovf_h"] or res["ovf_m"]
                    or res["ovf_rounds"]):
                return res, frontier
            if res["ovf_h"]:
                self._grow_slab(depth + 1, max(n_f, res["n_new"]))
            if res["ovf_x"]:
                self._grow_cap_x()
            if res["ovf_g"]:
                self.cap_g *= 2
                self.redos["cap_g"] += 1
            if res["ovf_rounds"]:
                self.k4_rounds *= 2
            if res["ovf_m"]:
                frontier = self._grow_cap_m(frontier)

    def _expand_level_staged(self, frontier: Frontier, n_f: int, depth: int) -> tuple:
        """One ungrouped staged level with its grow-and-redo: (result,
        parent frontier)."""
        while True:
            res = self.expand_level(frontier, n_f, self.hstore.slab)
            if not (res["ovf_x"] or res["ovf_h"] or res["ovf_m"]):
                return res, frontier
            # nothing was inserted, or the insert was undone
            if res["ovf_x"]:
                self._grow_cap_x()
            if res["ovf_h"]:
                self._grow_slab(depth + 1, max(n_f, res["n_new"]))
            if res["ovf_m"]:
                frontier = self._grow_cap_m(frontier)

    def run(self, max_depth: int | None = None) -> CheckResult:
        cfg, K = self.cfg, self.K
        t0 = time.monotonic()
        frontier, ovf0 = self.deflate(init_batch(cfg, 1, self.device))
        if bool(ovf0.any()):
            raise RuntimeError(f"initial state's message set exceeds cap_m={self.cap_m}")
        fv, _ff = self._fp_states(frontier)
        self.hstore = DeviceHashStore.from_fps(
            fv.cpu().numpy().view(np.uint64), device=self.device
        )
        self.tiered = tiered.TieredVisitedStore(self.store_bytes) if self.store_bytes else None
        self._sieve_dev, self._sieve_ver, self.tier_soft_seats = None, -1, 0
        self.frontier = frontier
        n_f, distinct, generated, depth = 1, 1, 0, 0
        level_sizes = [1]
        trace_levels: list = []  # (pidx, slot) per level
        self.trace_levels = trace_levels
        mult_per_slot = np.zeros(K, np.int64)
        if int(self.inv_scan(frontier)) >= 0:
            name = self.bad_invariant_name(frontier, 0)
            return CheckResult(False, 1, 0, 0, (1,), (
                f"Invariant {name} is violated", self.trace(trace_levels, 0, 0)))

        def note(route):
            self.routes[route] += 1
            if self.progress is not None:
                self.progress(dict(level=depth, frontier=n_f, distinct=distinct,
                                   generated=generated, route=route,
                                   elapsed=time.monotonic() - t0))

        # a stopped superstep routes its level once through the per-level
        # paths before supersteps engage again
        skip_superstep = False
        while n_f > 0:
            if max_depth is not None and depth >= max_depth:
                break
            self._tier_drain(depth, n_f)
            if (not skip_superstep and self._superstep_span_at(max_depth, depth) > 1
                    and self._mega_level_ok(n_f)):
                sres = self._run_superstep(frontier, n_f, max_depth, depth, level_sizes)
                frontier = sres["frontier"]
                hit_fixpoint = False
                for rec in sres["recs"]:
                    mult_per_slot = mult_per_slot + rec["mult"]
                    generated += int(rec["mult"].sum())
                    if rec["n_new"] == 0:
                        hit_fixpoint = True  # generated counts, distinct/depth do not
                        break
                    n_f = rec["n_new"]
                    distinct += n_f
                    level_sizes.append(n_f)
                    depth += 1
                    trace_levels.append((rec["pidx"], rec["slot"]))
                    note("superstep")
                if sres["n_total"] or hit_fixpoint:
                    self.hstore.adopt(self.hstore.slab, sres["n_total"])
                    self._check_occupancy(sres["slab_live"])
                self.frontier = mk.rows_of(frontier, 0, n_f)
                if hit_fixpoint:
                    break
                skip_superstep = sres["reason"] == "stop" or (
                    sres["reason"] == "ring" and not sres["recs"])
                if sres["reason"] == "stop":
                    frontier = self._grow_for_stop(sres["flags"], frontier, depth, n_f)
                continue
            skip_superstep = False
            mres = None
            t_level, reads0 = time.perf_counter(), sum(READS.values())
            if self._mega_level_ok(n_f):
                mres = self._expand_level_mega(frontier, n_f, max_depth, level_sizes)
                frontier = mres["parent"]
                res = dict(n_new=mres["n_new"], abort_at=mres["abort_at"],
                           mult=mres["level_mult"], slab_live=mres["slab_live"])
                route = "fused"
            elif self._grouping(n_f):
                launches0 = self.graph_stats["group_launches"]
                res, frontier = self._expand_level_grouped(frontier, n_f, depth)
                route = "grouped"
            else:
                res, frontier = self._expand_level_staged(frontier, n_f, depth)
                route = "staged"
            if res["abort_at"] < n_f:
                return CheckResult(
                    False, distinct, generated, depth, tuple(level_sizes),
                    ('Assert "split brain" (Raft.tla:185)',
                     self.trace(trace_levels, depth, res["abort_at"])),
                )
            mult_per_slot = mult_per_slot + res["mult"]
            generated += int(res["mult"].sum())
            n_new = res["n_new"]
            if n_new == 0:
                break
            if mres is not None:
                new_frontier, bad_idx = mres["new_frontier"], mres["bad_idx"]
                pidx, slot, fps_lvl = mres["pidx"], mres["slot"], mres["fps"]
            else:
                while True:
                    new_frontier, bad_idx, ovf_m = self.materialize_level(
                        frontier, res["new_payload"], n_new
                    )
                    if not ovf_m:
                        break
                    frontier = self._grow_cap_m(frontier)
                # the trace read (the grouped tail split the payloads on the
                # device), with the fresh fps when the tiers probe them
                if route == "grouped":
                    want = [res["pidx"][:n_new], res["slot"][:n_new]]
                else:
                    want = [res["new_payload"][:n_new]]
                if self._tier_active():
                    want.append(res["new_fps"][:n_new])
                got = fetch(*want, what="staged_trace")
                if route == "grouped":
                    pidx, slot = got[0].view(np.uint32).copy(), got[1].view(np.uint16).copy()
                else:
                    pidx, slot = np.divmod(got[0], K)
                fps_lvl = got[-1].view(np.uint64) if self._tier_active() else None
            # the tiered level tail: a fused level with no sieve hit
            # provably revisits nothing demoted; every other route probes
            n_store = n_new  # the slab's own fresh count
            if self._tier_active():
                if mres is not None and mres["tier_hits"] == 0:
                    self.tiered.stats["sieve_skips"] += 1
                else:
                    n_new, keep, new_frontier = self._tier_filter_level(
                        depth, n_new, fps_lvl, new_frontier)
                    if keep is not None:
                        pidx, slot = pidx[keep], slot[keep]
                        if bad_idx >= 0:
                            # a violating row is new: its first visit is here
                            assert keep[bad_idx], "invariant violation on a demoted revisit"
                            bad_idx = int(np.count_nonzero(keep[:bad_idx]))
                    if n_new == 0:
                        # every fresh state revisited a generation: the fixpoint
                        self.hstore.adopt(self.hstore.slab, n_store)
                        n_f = 0
                        break
            if route == "grouped":
                self.group_log.append(dict(
                    level=depth + 1, parents=n_f, groups=res["groups"],
                    graph_launches=self.graph_stats["group_launches"] - launches0,
                    reads=sum(READS.values()) - reads0, k4_rounds=res["rounds"],
                    cap_g=self.cap_g, lanes=res["lanes"],
                    ungrouped_lanes=-(-n_f // self.chunk) * self.cap_x,
                    seconds=time.perf_counter() - t_level))
            frontier = new_frontier
            trace_levels.append((pidx, slot))
            distinct += n_new
            level_sizes.append(n_new)
            depth += 1
            self.hstore.adopt(self.hstore.slab, n_store)
            if route != "staged":
                self._check_occupancy(res["slab_live"])
            if self.hstore.need_grow(extra=2 * n_new) or (
                    self._tier_on() and self.hstore.count > 0
                    and not self.tiered.slab_fits(self.hstore.cap)):
                self._slab_grow_or_demote(depth, expected=2 * n_new)
            n_f = n_new
            self.frontier = mk.rows_of(frontier, 0, n_f)
            note(route)
            if bad_idx >= 0:
                name = self.bad_invariant_name(frontier, bad_idx)
                return CheckResult(
                    False, distinct, generated, depth, tuple(level_sizes),
                    (f"Invariant {name} is violated", self.trace(trace_levels, depth, bad_idx)),
                )
        return CheckResult(
            True, distinct, generated, depth, tuple(level_sizes), None,
            self.layout.action_counts(mult_per_slot),
        )

    def _grow_cap_m(self, frontier: Frontier) -> Frontier:
        if self.cap_m >= self.uni.M:
            raise RuntimeError("message-set width exceeds the whole universe")
        self.cap_m = min(self.cap_m + 32, self.uni.M)
        self.redos["cap_m"] += 1
        return self.widen(frontier)

