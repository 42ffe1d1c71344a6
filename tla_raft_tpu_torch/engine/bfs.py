"""Level-synchronous BFS over the Raft state space, on one device.

The port of the staged single-device chain of ``tla_raft_tpu/engine/bfs.py``
(``JaxChecker._run`` with late canonicalization and the device hash
store, the path ``--megakernel 0 --superstep 1`` selects there).  Each
level runs:

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
from ..device import resolve_device
from ..models.raft import Frontier, RaftState, core_of, init_batch, to_oracle
from ..ops.fingerprint import Fingerprinter
from ..ops.hashstore import DeviceHashStore, compact_fresh, probe_and_insert
from ..ops.msg_universe import get_universe
from ..ops.mxu_expand import MXUExpand
from ..ops.successor import GuardTables
from ..u64 import SENT
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
    """

    def __init__(
        self,
        cfg: RaftConfig,
        device=None,
        chunk: int = 16384,
        cap_x: int | None = None,
        cap_m: int = 96,
        progress: Callable[[dict], None] | None = None,
    ):
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
        self.frontier: Frontier | None = None  # the last committed level
        self.redos = dict(cap_x=0, slab=0, cap_m=0)

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
            part = Frontier(*(x[start : start + self.chunk] for x in frontier))
            cv, cf, cp, m, ab, ox, om = self._expand_chunk(part, start)
            cvs.append(cv)
            cfs.append(cf)
            cps.append(cp)
            mult = mult + m
            abort_at = torch.minimum(abort_at, ab)
            ovf_x = ovf_x | ox
            ovf_m = ovf_m | om
        ctl = torch.cat([torch.stack([abort_at, ovf_x.to(I64), ovf_m.to(I64)]), mult])
        ctl = ctl.cpu().numpy()  # the expand pass's one control fetch
        out = dict(abort_at=int(ctl[0]), ovf_x=bool(ctl[1]), ovf_m=bool(ctl[2]), ovf_h=False,
                   mult=ctl[3:], n_new=0, new_fps=None, new_payload=None, slab=slab)
        if out["ovf_x"] or out["ovf_m"] or out["abort_at"] < n_f:
            return out  # the level is redone or the run stops: insert nothing
        cv, cf, cp = torch.cat(cvs), torch.cat(cfs), torch.cat(cps)
        slab, fresh, n_new, ovf_h = probe_and_insert(slab, cv, cf, cp)
        new_fps, new_payload = compact_fresh(fresh, cv, cp, cv.shape[0])
        n_new, ovf_h = torch.stack([n_new.to(I64), ovf_h.to(I64)]).tolist()
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
        ctl = torch.stack([bad, torch.stack(ovfs).any().to(I64)]).cpu().numpy()
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
        trace_levels: list = []
        mult_per_slot = np.zeros(K, np.int64)
        if int(self.inv_scan(frontier)) >= 0:
            name = self.bad_invariant_name(frontier, 0)
            return CheckResult(False, 1, 0, 0, (1,), (
                f"Invariant {name} is violated", self.trace(trace_levels, 0, 0)))

        while n_f > 0:
            if max_depth is not None and depth >= max_depth:
                break
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
            while True:
                new_frontier, bad_idx, ovf_m = self.materialize_level(
                    frontier, res["new_payload"], n_new
                )
                if not ovf_m:
                    break
                frontier = self._grow_cap_m(frontier)
            frontier = new_frontier
            distinct += n_new
            level_sizes.append(n_new)
            depth += 1
            self.hstore.adopt(res["slab"], n_new)
            if self.hstore.need_grow(extra=2 * n_new):
                self.hstore.grow()
            pay = res["new_payload"][:n_new].cpu().numpy()
            trace_levels.append((pay // K, pay % K))
            n_f = n_new
            self.frontier = frontier
            if self.progress is not None:
                self.progress(dict(level=depth, frontier=n_new, distinct=distinct,
                                   generated=generated, elapsed=time.monotonic() - t0))
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

