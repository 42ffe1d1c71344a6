"""The grouped level: levels past the fused size limit, group by group.

The port of the reference's grouped chain: ``_expand_level_device`` with
``grouping = n_chunks > 16 * G`` (tla_raft_tpu/engine/bfs.py:3522), whose
per-group program is ``_expand_group_gfused_impl`` (bfs.py:1144, over
``_expand_span_impl`` :1091: G chunks of expand, then the visited
pre-filter ``_group_filter_hash`` :374 = ``hashstore.probe_impl`` +
``_filter_compact`` :338) and whose tail is one probe-and-insert over
the level's ``n_groups * cap_g`` filtered lanes (``_level_dedup_hash``
:386).  The pre-filter drops the candidate lanes whose view fingerprint
the slab already holds, so the level's lane buffer is bounded by the new
states (deep levels are at most about half fresh), not by the fan-out.

Here a group is G chunks of parents seated in a buffer of ``G * chunk``
rows and run as one captured CUDA graph (``GroupProgram``): per chunk
guards (K1 from the parents' id lists, folding ``mult`` into the level
and the abort into the group), the order-keeping compaction to ``cap_x``
lanes, materialize (K2) and fingerprints (K3) -- or under
``canon="expand"`` the inflate and the dense expand with fingerprints and
the chunk compaction (``mk.op_expand_chunk``); then the membership probe
``hs_probe`` (B8
``probe_impl``) against the slab **as it was before the level** (K4 runs
only in the tail), and the filter compaction (B3 ``_filter_compact``)
of the unvisited lanes into the group's ``cap_g`` slice of the level's
lane buffer, in lane order, with the group's payload base added on the
device.  The group's one control kernel (csrc/level.cu ``lv_group_step``,
at the head of its graph) closes the previous group and opens this one
from the group index that the previous replay left in the level's control
words (the tail closes the last group), so one graph
serves every group of every level that fits its shapes, the last,
partial group included (rows past ``n_f`` are dead by device count).  The
host seats each group's rows (a device copy) and replays the graph.  Under
orbit pruning each chunk's fingerprints are the orbit kernel's, with the
tied rows compacted and folded by K3's indexed mode inside the same graph
(``Fingerprinter.orbit_chunk_fps``); a chunk with more tied rows than the
budget sets the level's cap_x overflow word.

The tail runs on the level's lanes without a host read: the gate (a level
that aborted or overflowed cap_x, cap_m or cap_g inserts nothing), K4
with the fused level's budget of claim rounds, the fresh lanes compacted
to a prefix (payload order), K4's undo gated on a probe or rounds
overflow, the slab's live count, and the survivors' pidx / slot split
from their payloads on the device (the trace read takes 6 B a state).
Then the host makes the level's one control read.  Payloads are global
and every compaction keeps lane order, so K4 sees the lanes in the
reference's order and the slab bytes, the counts and the traces equal
the ungrouped chain's.

The external store route (``--fpstore-dir``) has its own group program,
``HostGroupProgram``: the reference's ``_expand_group_fused_impl``
(bfs.py:1130), the G-chunk span expand (``_expand_span_impl`` :1091)
followed by the group dedup ``_group_unique_impl`` (:437, the
``group_unique`` kernel) with no store access, as one captured graph per
group: one launch and one read of the group's unique lanes, which the host
then filters against the external store.

On the CPU every op runs its plain twin, eagerly, which is what the tests
hold against the reference.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import fetch
from ..models.raft import Frontier, RaftState, core_of
from ..obs import telemetry as _obs
from ..ops.fingerprint import OrbitScratch
from ..ops.hashstore import probe_plain
from ..u64 import SENT
from . import megakernel as mk

I64 = torch.int64

# the grouped level's words in the control vector (common.cuh LevelCtl)
LC_OVF_G = 17    # a group's unvisited lanes overflowed cap_g
LC_GROUP = 18    # the group the next replay runs
LC_G_RUN = 19    # live parent rows of the group's seat
LC_G_PAY = 20    # payload of the seat's row 0, slot 0
LC_G_OUT = 21    # the group's first lane in the level's lane buffer
LC_G_ABORT = 22  # first split-brain row of the seat, BIG if none
LC_G_TOTAL = 23  # the group's unvisited lanes

# the external store route's group control words (HostGroupProgram.ctl),
# also the layout of the per-chunk path's read (bfs.py _host_group_chunks)
HG_ABORT = 0   # first split-brain row of the group's rows, BIG if none
HG_OVF_M = 1   # an expanded child overflowed cap_m
HG_N_U = 2     # the group's unique lanes
HG_N_RUN = 3   # live parent rows of the seat
HG_MULT = 4    # mult i64[K] of the group from here on


# -- B3 filter compaction and B19 group filter: the kernels and their twins ------------


def filter_compact_plain(hit, cv, cf, cp, cap_g: int):
    """Plain twin of ``_filter_compact``: drop SENT and ``hit`` lanes, pack
    the rest in lane order into ``cap_g`` lanes (SENT, SENT, -1 padded);
    (gv, gf, gp, overflow 0-d bool)."""
    keep = (cv != SENT) & ~hit
    dest = torch.cumsum(keep.to(I64), 0) - 1
    n = keep.sum()
    tgt = torch.where(keep & (dest < cap_g), dest, torch.full_like(dest, cap_g))
    outs = []
    for v, pad in ((cv, SENT), (cf, SENT), (cp, -1)):
        o = torch.full((cap_g + 1,), pad, dtype=I64, device=cv.device)
        o.scatter_(0, tgt, v)
        outs.append(o[:cap_g])
    return (*outs, n > cap_g)


def filter_compact(hit, cv, cf, cp, cap_g: int):
    """B3 ``_filter_compact``: the filter compaction kernel on the card,
    the plain twin on the CPU."""
    if cv.device.type == "cpu":
        return filter_compact_plain(hit, cv, cf, cp, cap_g)
    gv, gf, gp, total = kernels.filter_compact((cv != SENT) & ~hit, cv, cf, cp, cap_g)
    return gv, gf, gp, total > cap_g


def group_filter_hash(cv, cf, cp, slab, cap_g: int):
    """B19 ``_group_filter_hash``: the lanes whose view fingerprint the
    slab does not hold, compacted to ``cap_g`` lanes; ``hs_probe`` (writing
    the keep flags) then the filter compaction on the card, the twins on
    the CPU."""
    if cv.device.type == "cpu":
        return filter_compact_plain(probe_plain(slab, cv), cv, cf, cp, cap_g)
    keep = torch.empty(cv.shape, dtype=torch.bool, device=cv.device)
    kernels.hs_probe(slab, cv, keep=keep)
    gv, gf, gp, total = kernels.filter_compact(keep, cv, cf, cp, cap_g)
    return gv, gf, gp, total > cap_g


# -- the group program's ops --------------------------------------------------------


def op_probe_keep(slab, cv, keep):
    """keep = live and not in the slab."""
    if cv.is_cuda:
        kernels.hs_probe(slab, cv, keep=keep)
        return
    keep.copy_((cv != SENT) & ~probe_plain(slab, cv))


def op_filter_compact(keep, cv, cf, cp, out, cap_g: int, lc, tile):
    """The group's kept lanes to ``out[*][lc[G_OUT]:][:cap_g]``, payloads
    plus ``lc[G_PAY]``; ``lc[G_TOTAL]`` the kept count, ``lc[OVF_G]`` set
    on an overflow."""
    if cv.is_cuda:
        kernels.filter_compact(keep, cv, cf, cp, cap_g, out=out, total=lc[LC_G_TOTAL],
                               out_off=lc[LC_G_OUT], pay_off=lc[LC_G_PAY], ovf=lc[LC_OVF_G],
                               tile=tile)
        return
    hit = ~keep | (cv == SENT)
    gv, gf, gp, ovf = filter_compact_plain(hit, cv, cf, cp, cap_g)
    off, n = int(lc[LC_G_OUT]), int(keep.sum())
    gp = torch.where(torch.arange(cap_g) < n, gp + int(lc[LC_G_PAY]), gp)
    for o, v in zip(out, (gv, gf, gp)):
        o[off:off + cap_g] = v
    lc[LC_G_TOTAL] = n
    if bool(ovf):
        lc[LC_OVF_G] = 1


def op_group_step(lc, chunk_total, cap_x: int, rows: int, K: int, cap_g: int):
    (kernels.group_step if lc.is_cuda else group_step_plain)(lc, chunk_total, cap_x, rows, K,
                                                             cap_g)


def close_group_plain(lc, chunk_total, cap_x: int, rows: int):
    """Close group ``lc[LC_GROUP] - 1`` (none while the index is 0): its
    chunk totals past cap_x into OVF_X, its abort into the level's."""
    g = int(lc[LC_GROUP]) - 1
    if g < 0:
        return
    if bool((chunk_total > cap_x).any()):
        lc[mk.LC_OVF_X] = 1
    if int(lc[LC_G_ABORT]) < mk.BIG:
        lc[mk.LC_ABORT] = min(int(lc[mk.LC_ABORT]), g * rows + int(lc[LC_G_ABORT]))


def group_step_plain(lc, chunk_total, cap_x: int, rows: int, K: int, cap_g: int):
    close_group_plain(lc, chunk_total, cap_x, rows)
    g = int(lc[LC_GROUP])
    lc[LC_G_RUN] = max(0, min(rows, int(lc[mk.LC_N_RUN]) - g * rows))
    lc[LC_G_PAY] = g * rows * K
    lc[LC_G_OUT] = g * cap_g
    lc[LC_G_ABORT] = mk.BIG
    lc[LC_G_TOTAL] = 0
    lc[LC_GROUP] = g + 1


def op_tail_gate(lc, chunk_total, cap_x: int, rows: int, lanes: int):
    (kernels.tail_gate if lc.is_cuda else tail_gate_plain)(lc, chunk_total, cap_x, rows, lanes)


def tail_gate_plain(lc, chunk_total, cap_x: int, rows: int, lanes: int):
    close_group_plain(lc, chunk_total, cap_x, rows)
    gate = (bool(lc[mk.LC_OVF_X]) or bool(lc[mk.LC_OVF_MX]) or bool(lc[LC_OVF_G])
            or int(lc[mk.LC_ABORT]) < int(lc[mk.LC_N_RUN]))
    lc[mk.LC_LIVE_LANES] = 0 if gate else lanes


# -- the program --------------------------------------------------------------------


class GroupProgram(mk.GraphProgram):
    """One group of G chunks as a captured graph, and the level's lane
    buffer of ``groups * cap_g`` lanes it writes into (the tail reads it).
    The parents go into ``seat`` (G * chunk rows), one group at a time."""

    kind = "group"

    def __init__(self, eng, key, groups: int):
        super().__init__(eng, key)
        dev = eng.device
        K, chunk, cap_x, cap_m, G = eng.K, eng.chunk, eng.cap_x, eng.cap_m, eng.G
        self.eng = eng
        self.G, self.chunk, self.cap_x, self.cap_g = G, chunk, cap_x, eng.cap_g
        self.rows = G * chunk
        self.groups = groups
        self.cap_f = groups * self.rows  # the parents it serves, for the logs
        self.budget = eng.k4_rounds
        self.slab = eng.hstore.slab
        self.seat = mk.empty_frontier(eng.cfg, self.rows, cap_m, dev)
        self.msgs = mk.mask_buffer(eng, chunk, dev)
        self.valid = torch.zeros((chunk, K), dtype=torch.bool, device=dev)
        self.chunk_total = torch.zeros((G,), dtype=I64, device=dev)
        n = G * cap_x
        self.cv = torch.full((n,), SENT, dtype=I64, device=dev)
        self.cf = torch.full((n,), SENT, dtype=I64, device=dev)
        self.cp = torch.full((n,), -1, dtype=I64, device=dev)
        self.keep = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.children = mk.empty_frontier(eng.cfg, cap_x, cap_m, dev)
        self.added = torch.zeros((cap_x, eng.mx.A), dtype=torch.int32, device=dev)
        self.covf = torch.zeros((cap_x,), dtype=torch.bool, device=dev)
        self.orbit_scr = (OrbitScratch(cap_x, eng.cap_nd, dev)
                          if eng.orbit and dev.type == "cuda" else None)
        self.xs = mk.ExpandScratch(eng, chunk) if eng.canon == "expand" else None
        N = groups * self.cap_g
        self.N = N
        self.lanes = tuple(torch.full((N,), pad, dtype=I64, device=dev)
                           for pad in (SENT, SENT, -1))
        self.k4 = mk.K4Scratch(N, self.slab, self.cap_f * K)
        self.new_fps = torch.full((N,), SENT, dtype=I64, device=dev)
        self.new_pay = torch.full((N,), -1, dtype=I64, device=dev)
        self.pidx = torch.zeros((N,), dtype=torch.int32, device=dev)
        self.slot = torch.zeros((N,), dtype=torch.int16, device=dev)
        self.ctrl = torch.zeros((mk.CTRL_LEN,), dtype=I64, device=dev)
        self.lc = torch.zeros((mk.LC_LEN,), dtype=I64, device=dev)
        self.mult = torch.zeros((K,), dtype=I64, device=dev)
        self.n_f = torch.zeros((), dtype=I64, device=dev)
        self.host_n_f = torch.zeros((), dtype=I64, pin_memory=dev.type == "cuda")
        if dev.type == "cuda":
            self.tile_chunk = torch.zeros((kernels.compact_tiles(chunk * K),), dtype=I64,
                                          device=dev)
            self.tile_group = torch.zeros((kernels.compact_tiles(n),), dtype=I64, device=dev)
            self.tile_fresh = torch.zeros((kernels.compact_tiles(N),), dtype=I64, device=dev)
        else:
            self.tile_chunk = self.tile_group = self.tile_fresh = None

    def record(self) -> None:
        """One group: G chunks, the probe, the filter compaction."""
        eng, lc, K, chunk, cap_x = self.eng, self.lc, self.eng.K, self.chunk, self.cap_x
        # the previous group closed (its chunk totals are still in
        # chunk_total) and this one opened: one control launch a group
        op_group_step(lc, self.chunk_total, cap_x, self.rows, K, self.cap_g)
        n_run = lc[LC_G_RUN]
        for i in range(self.G):
            start = i * chunk
            part = mk.rows_of(self.seat, start, start + chunk)
            seg = slice(i * cap_x, (i + 1) * cap_x)
            total = self.chunk_total[i]
            if eng.canon == "expand":
                mk.op_inflate(eng, part.msg_ids, self.msgs, n_run, start)
                st = RaftState(msgs=self.msgs, **core_of(part))
                mk.op_expand_chunk(eng, st, self.valid, self.xs, n_run, start, self.mult,
                                   lc[LC_G_ABORT], start, (self.cv[seg], self.cf[seg],
                                                           self.cp[seg]), total, cap_x)
                continue
            mk.op_guards(eng, part, self.msgs, self.valid, n_run, start, self.mult,
                         lc[LC_G_ABORT], start)
            mk.op_compact_chunk(self.valid.view(-1), self.cp[seg], total, n_run, start, K,
                                start * K, self.tile_chunk)
            mk.op_materialize(eng, part, self.cp[seg], start,
                              (self.children, self.added, self.covf), total, 0, lc[mk.LC_OVF_MX])
            if eng.orbit:
                eng.fpr.orbit_chunk_fps(self.children, eng.cap_nd, total,
                                        out=(self.cv[seg], self.cf[seg]), ovf=lc[mk.LC_OVF_X],
                                        scratch=self.orbit_scr)
            else:
                mk.op_fingerprints(eng, self.children, (self.cv[seg], self.cf[seg]), total, 0)
        op_probe_keep(self.slab, self.cv, self.keep)
        op_filter_compact(self.keep, self.cv, self.cf, self.cp, self.lanes, self.cap_g, lc,
                          self.tile_group)

    def begin(self, n_f: int) -> None:
        """The level's control words, with n_f written by one host-to-device
        copy (the level's last read has completed the previous one)."""
        self.host_n_f.fill_(n_f)
        self.n_f.copy_(self.host_n_f, non_blocking=True)
        mk.op_level_begin(self.lc, self.mult, self.n_f)

    def tail(self, n_groups: int) -> None:
        """The last group closed, then the level's probe-and-insert over its
        ``n_groups * cap_g`` lanes, the fresh compaction, the gated undo, the
        slab's live count and the survivors' pidx / slot."""
        lc, k4, (cv, cf, cp) = self.lc, self.k4, self.lanes
        op_tail_gate(lc, self.chunk_total, self.cap_x, self.rows, n_groups * self.cap_g)
        mk.op_k4(self.slab, cv, cf, cp, lc, k4, self.budget)
        mk.op_compact_fresh(k4.fresh, cv, cp, self.new_fps, self.new_pay, lc[mk.LC_N_NEW],
                            lc[mk.LC_LIVE_LANES], self.tile_fresh)
        mk.op_level_decide(lc, self.N)
        mk.op_undo(self.slab, k4, lc[mk.LC_LIVE_LANES], lc[mk.LC_UNDO])
        mk.op_slab_live(self.slab, lc[mk.LC_SLAB_LIVE])
        mk.op_level_finalize(lc, self.ctrl, self.new_pay, self.eng.K, self.pidx, self.slot)


def group_key(eng, n_f: int) -> tuple:
    """The grouped level's program key for ``n_f`` parents: its lane buffer
    holds the level's groups quantized (``_cap_steps``), so one program
    serves nearby levels; ``expand_level_grouped`` and the prewarm plan
    both key on it."""
    from .bfs import _cap_steps

    groups = -(-max(n_f, 1) // (eng.G * eng.chunk))
    return ("group", _cap_steps(groups), eng.G, eng.cap_g, eng.chunk)


def group_make(groups_cap: int):
    """The builder of a grouped level's program of ``groups_cap`` groups."""
    return lambda e, k: GroupProgram(e, k, groups_cap)


def expand_level_grouped(eng, frontier: Frontier, n_f: int, groups_cap: int | None = None) -> dict:
    """One grouped level from ``frontier`` (``n_f`` parent rows) against the
    engine's slab: every group's graph, the tail, one control read; the
    program's lane buffer holds ``groups_cap`` groups (its shape key; by
    default the level's groups quantized, ``group_key``).

    Returns host-side control values (n_new, abort_at, the overflow flags,
    mult, the slab's live slots, K4's rounds) and the device-side survivors
    (new_fps, new_payload and its pidx u32 / slot u16 bits, in payload
    order).  A level that aborted or
    overflowed cap_x, cap_m or cap_g inserted nothing; one whose insert
    overflowed the slab or K4's rounds gave its claims back."""
    rows = eng.G * eng.chunk
    n_groups = -(-max(n_f, 1) // rows)
    key = group_key(eng, n_f)
    if groups_cap is not None:
        key = (key[0], groups_cap) + key[2:]
    prog = eng._program(key, group_make(key[1]))
    prog.begin(n_f)
    for g in range(n_groups):
        n = min(rows, n_f - g * rows)
        mk.copy_rows(prog.seat, mk.rows_of(frontier, g * rows, g * rows + n), n)
        prog.launch()
    prog.tail(n_groups)
    _obs.dispatch("group.tail")
    lc, mult = fetch(prog.lc, prog.mult, what="grouped")
    return dict(
        n_new=int(lc[mk.LC_N_NEW]), abort_at=int(lc[mk.LC_ABORT]), ovf_x=bool(lc[mk.LC_OVF_X]),
        ovf_m=bool(lc[mk.LC_OVF_MX]), ovf_g=bool(lc[LC_OVF_G]), ovf_h=bool(lc[mk.LC_OVF_SLAB]),
        ovf_rounds=bool(lc[mk.LC_OVF_ROUNDS]), mult=mult.copy(), rounds=int(lc[mk.LC_ROUNDS]),
        slab_live=int(lc[mk.LC_SLAB_LIVE]), groups=n_groups, lanes=n_groups * prog.cap_g,
        new_fps=prog.new_fps, new_payload=prog.new_pay, pidx=prog.pidx, slot=prog.slot,
    )


# -- the external store route's group program ----------------------------------------


def op_group_unique(cv, cf, cp, out, n_u, scratch):
    """B19 ``_group_unique_impl`` into ``out`` = (gv, gf, gp) and ``n_u``:
    the kernel on the card, the twin on the CPU."""
    if cv.is_cuda:
        kernels.group_unique(cv, cf, cp, out=out, n_u=n_u, scratch=scratch)
        return
    from .bfs import group_unique_plain

    n, *vals = group_unique_plain(cv, cf, cp)
    for o, v in zip(out, vals):
        o.copy_(v)
    n_u.fill_(int(n))


class HostGroupProgram(mk.GraphProgram):
    """One full group of G chunks on the external store route as a captured
    graph: per chunk guards (K1 from the parents' id lists, folding
    ``mult`` and the abort into the control words), the order-keeping compaction to ``cap_x`` lanes,
    materialize (K2) and fingerprints (K3) -- or the inflate, the dense
    expand and the chunk compaction under ``canon="expand"`` -- then ``group_unique`` over
    the group's ``G * cap_x`` lanes.  Rows and payloads are the seat's: the
    host adds the group's first row.  ``run`` seats the group's rows (a
    device copy), writes the control words (one host-to-device copy: the
    live rows, the abort at BIG, the overflow and ``mult`` at 0) and
    launches; the bounds the kernels read are device words, so one graph
    serves every full group of every level."""

    kind = "host_group"

    def __init__(self, eng, key):
        super().__init__(eng, key)
        dev = eng.device
        K, chunk, cap_x, cap_m, G = eng.K, eng.chunk, eng.cap_x, eng.cap_m, eng.G
        self.eng = eng
        self.G, self.chunk, self.cap_x = G, chunk, cap_x
        self.rows = G * chunk
        self.cap_f = self.rows
        self.seat = mk.empty_frontier(eng.cfg, self.rows, cap_m, dev)
        self.msgs = mk.mask_buffer(eng, chunk, dev)
        self.valid = torch.zeros((chunk, K), dtype=torch.bool, device=dev)
        self.chunk_total = torch.zeros((G,), dtype=I64, device=dev)
        n = G * cap_x
        self.cv = torch.full((n,), SENT, dtype=I64, device=dev)
        self.cf = torch.full((n,), SENT, dtype=I64, device=dev)
        self.cp = torch.full((n,), -1, dtype=I64, device=dev)
        self.children = mk.empty_frontier(eng.cfg, cap_x, cap_m, dev)
        self.added = torch.zeros((cap_x, eng.mx.A), dtype=torch.int32, device=dev)
        self.covf = torch.zeros((cap_x,), dtype=torch.bool, device=dev)
        self.xs = mk.ExpandScratch(eng, chunk) if eng.canon == "expand" else None
        self.out = tuple(torch.full((n,), pad, dtype=I64, device=dev) for pad in (SENT, SENT, -1))
        self.ctl = torch.zeros((HG_MULT + K,), dtype=I64, device=dev)
        # the control words' host side, one a group in flight: a group's
        # copy may still be queued when the next group writes its own
        self.host_ctl = [torch.zeros((HG_MULT + K,), dtype=I64, pin_memory=dev.type == "cuda")
                         for _ in range(eng.pipeline_window + 2 if eng.pipeline else 1)]
        self._ctl_slot = 0
        if dev.type == "cuda":
            self.tile_chunk = torch.zeros((kernels.compact_tiles(chunk * K),), dtype=I64,
                                          device=dev)
            self.scratch = kernels.GroupUniqueScratch(n, dev)
        else:
            self.tile_chunk = self.scratch = None

    def record(self) -> None:
        eng, ctl, K, chunk, cap_x = self.eng, self.ctl, self.eng.K, self.chunk, self.cap_x
        n_run, abort, mult = ctl[HG_N_RUN], ctl[HG_ABORT], ctl[HG_MULT:]
        for i in range(self.G):
            start = i * chunk
            part = mk.rows_of(self.seat, start, start + chunk)
            seg = slice(i * cap_x, (i + 1) * cap_x)
            total = self.chunk_total[i]
            if eng.canon == "expand":
                mk.op_inflate(eng, part.msg_ids, self.msgs, n_run, start)
                st = RaftState(msgs=self.msgs, **core_of(part))
                mk.op_expand_chunk(eng, st, self.valid, self.xs, n_run, start, mult, abort, start,
                                   (self.cv[seg], self.cf[seg], self.cp[seg]), total, cap_x)
                continue
            mk.op_guards(eng, part, self.msgs, self.valid, n_run, start, mult, abort, start)
            mk.op_compact_chunk(self.valid.view(-1), self.cp[seg], total, n_run, start, K,
                                start * K, self.tile_chunk)
            mk.op_materialize(eng, part, self.cp[seg], start,
                              (self.children, self.added, self.covf), total, 0, ctl[HG_OVF_M])
            mk.op_fingerprints(eng, self.children, (self.cv[seg], self.cf[seg]), total, 0)
        op_group_unique(self.cv, self.cf, self.cp, self.out, ctl[HG_N_U], self.scratch)

    def run(self, seg: Frontier, off: int, n_run: int) -> None:
        """Seat rows ``off .. off + n_run`` of the segment ``seg`` and launch.
        The control words go through the next of the program's host buffers:
        the buffer comes round again only after the window has completed
        the group that last used it (and with it its copy)."""
        mk.copy_rows(self.seat, mk.rows_of(seg, off, off + n_run), n_run)
        host = self.host_ctl[self._ctl_slot]
        self._ctl_slot = (self._ctl_slot + 1) % len(self.host_ctl)
        host.zero_()
        host[HG_N_RUN] = n_run
        host[HG_ABORT] = mk.BIG
        self.ctl.copy_(host, non_blocking=True)
        self.launch()
