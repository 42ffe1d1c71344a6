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
and redoes; a level past the size limit runs on the staged chain (the
reference runs it on its grouped staged chain, which the port does not
have yet; the counts are the same).  All three give the same counts,
level sizes and traces.

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
the traces do not depend on the chunk size.  Every lane budget grows and
redoes the level on overflow: ``cap_x`` (candidates per chunk), the slab
(probe depth) and ``cap_m`` (message ids per state).  The split-brain
Assert stops the run with a trace; so does an invariant violation.

The order-keeping compactions, inflate/deflate of the message sets and
the invariant scan are kernels too (csrc/compact.cu, msgset.cu,
invariants.cu); each function here that wraps one sends CPU tensors to
its plain twin and CUDA tensors to the kernel.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import RaftConfig
from ..device import fetch, resolve_device
from ..models.raft import Frontier, RaftState, core_of, init_batch, to_oracle
from ..ops.fingerprint import Fingerprinter
from ..ops.hashstore import DeviceHashStore, compact_fresh, probe_and_insert
from ..ops.msg_universe import get_universe
from ..ops.mxu_expand import MXUExpand
from ..ops.successor import GuardTables
from ..u64 import SENT
from . import forecast
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
    if id_dtype != torch.int16:
        raise ValueError(f"the deflate kernel writes int16 ids, not {id_dtype}")
    return kernels.deflate(msgs, M, cap_m)


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
      chunk: parents expanded per guard launch.
      cap_x: compacted candidate lanes per chunk (grows on overflow).
      cap_m: message ids per frontier state (grows on overflow).
      progress: optional callable(level_stats_dict).
      megakernel: the fused level (``None``: on); ``False`` selects the
        staged chain.
      superstep: levels per superstep (``None``: 4); 1 selects the
        per-level fused program.
    """

    def __init__(
        self,
        cfg: RaftConfig,
        device=None,
        chunk: int = 16384,
        cap_x: int | None = None,
        cap_m: int = 96,
        progress: Callable[[dict], None] | None = None,
        megakernel: bool | None = None,
        superstep: int | None = None,
    ):
        if chunk & (chunk - 1):
            raise ValueError(f"chunk must be a power of two, got {chunk}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.uni = get_universe(cfg)
        self.fpr = Fingerprinter(cfg, device=self.device)
        self.mx = MXUExpand(cfg, self.device)
        self.layout = self.mx.layout
        self.tables = GuardTables(cfg, self.device)
        self.K = self.layout.K
        self.chunk = int(chunk)
        self.cap_x = int(cap_x or 4 * chunk)
        self.cap_m = min(int(cap_m), self.uni.M)
        self.id_dtype = torch.int16 if self.uni.M < (1 << 15) else torch.int32
        self.progress = progress
        for name in cfg.invariants:
            resolve_invariant_kernel(name)  # an unknown name raises here
        self.hstore: DeviceHashStore | None = None
        self.frontier: Frontier | None = None  # the last committed level's rows
        self.redos = dict(cap_x=0, slab=0, cap_m=0)  # every route's redos
        self.megakernel = megakernel is None or bool(megakernel)
        if superstep is None:
            superstep = ss.DEFAULT_SPAN
        self.superstep_span = max(1, int(superstep)) if self.megakernel else 1
        self.G = 16  # the reference's chunks per group: fused levels hold <= 16 * G chunks
        self.k4_rounds = mk.DEFAULT_ROUNDS  # claim rounds per K4 call in a graph
        self._mega_stats = dict(levels=0, redo_out=0, redo_x=0, redo_slab=0, redo_m=0,
                                redo_rounds=0)
        self._ss_stats = dict(supersteps=0, levels=0, stops=0, ring_stops=0)
        self.graph_stats = dict(programs=0, captures=0, capture_seconds=0.0, level_launches=0,
                                level_redo_launches=0, superstep_launches=0, copies=0,
                                capture_log=[], launch_log=[])
        self.level_timing: dict = {}  # host seconds of the last fused level, by step
        self.routes = dict(superstep=0, fused=0, staged=0)  # levels committed by route
        self.k4_round_log: list = []  # claim rounds of every fused level run
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
        (bfs.py:1166); larger levels run staged."""
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
        slab = self.hstore.slab
        sig = (self.cap_x, self.cap_m, self.k4_rounds, slab.data_ptr(), slab.shape[0])
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
        self.cap_x = _cap_steps(self.cap_x + 1)
        self.redos["cap_x"] += 1
        self._mega_stats["redo_x"] += 1

    def _grow_slab(self) -> None:
        self.hstore.grow()
        self.redos["slab"] += 1
        self._mega_stats["redo_slab"] += 1

    def _check_occupancy(self, slab_live: int) -> None:
        """The conservation signal: the slab's live slots, counted on the
        device, equal the distinct states."""
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
                self._grow_slab()
                continue
            if ctrl[mk.CTRL_OVF_X]:
                self._grow_cap_x()
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
            slab_live=int(ctrl[mk.CTRL_SLAB_LIVE]), level_mult=mult.copy(),
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
        self.hstore.reserve(self.hstore.count + max(ins_bound, 2 * max(n_f, 1)))
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

    def _grow_for_stop(self, flags: int, frontier: Frontier) -> Frontier:
        """Grow the budget a stopped superstep names before the per-level
        replay (bfs.py:4495-4569), so the replay's first attempt lands."""
        if flags & ss.FLAG_OVF_X:
            self._grow_cap_x()
        if flags & ss.FLAG_OVF_SLAB:
            self._grow_slab()
        if flags & ss.FLAG_OVF_M and self.cap_m < self.uni.M:
            frontier = self._grow_cap_m(frontier)
            self._mega_stats["redo_m"] += 1
        if flags & ss.FLAG_OVF_ROUNDS:
            self.k4_rounds *= 2
            self._mega_stats["redo_rounds"] += 1
        return frontier

    # -- the run ------------------------------------------------------------------

    def run(self, max_depth: int | None = None) -> CheckResult:
        cfg, K = self.cfg, self.K
        t0 = time.monotonic()
        frontier, ovf0 = self.deflate(init_batch(cfg, 1, self.device))
        if bool(ovf0.any()):
            raise RuntimeError(f"initial state's message set exceeds cap_m={self.cap_m}")
        fv, _ff = self.fpr.state_fingerprints(frontier)
        self.hstore = DeviceHashStore.from_fps(
            fv.cpu().numpy().view(np.uint64), device=self.device
        )
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
                    frontier = self._grow_for_stop(sres["flags"], frontier)
                continue
            skip_superstep = False
            mres = None
            if self._mega_level_ok(n_f):
                mres = self._expand_level_mega(frontier, n_f, max_depth, level_sizes)
                frontier = mres["parent"]
                res = dict(n_new=mres["n_new"], abort_at=mres["abort_at"],
                           mult=mres["level_mult"])
            else:
                while True:
                    res = self.expand_level(frontier, n_f, self.hstore.slab)
                    if not (res["ovf_x"] or res["ovf_h"] or res["ovf_m"]):
                        break
                    # a lane budget overflowed: grow it and redo the level
                    # (nothing was inserted, or the insert was undone)
                    if res["ovf_x"]:
                        self.cap_x = _cap_steps(self.cap_x + 1)
                        self.redos["cap_x"] += 1
                    if res["ovf_h"]:
                        self.hstore.grow()
                        self.redos["slab"] += 1
                    if res["ovf_m"]:
                        frontier = self._grow_cap_m(frontier)
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
                frontier = mres["new_frontier"]
                bad_idx = mres["bad_idx"]
                trace_levels.append((mres["pidx"], mres["slot"]))
                route = "fused"
            else:
                while True:
                    new_frontier, bad_idx, ovf_m = self.materialize_level(
                        frontier, res["new_payload"], n_new
                    )
                    if not ovf_m:
                        break
                    frontier = self._grow_cap_m(frontier)
                frontier = new_frontier
                (pay,) = fetch(res["new_payload"][:n_new], what="staged_trace")
                trace_levels.append((pay // K, pay % K))
                route = "staged"
            distinct += n_new
            level_sizes.append(n_new)
            depth += 1
            self.hstore.adopt(self.hstore.slab if mres is not None else res["slab"], n_new)
            if mres is not None:
                self._check_occupancy(mres["slab_live"])
            if self.hstore.need_grow(extra=2 * n_new):
                self.hstore.grow()
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

