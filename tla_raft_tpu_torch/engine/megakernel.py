"""The whole-level fused program (B11): one BFS level as one CUDA graph.

The port of ``tla_raft_tpu/engine/megakernel.py`` (``fused_level_core``
:170, ``build_level_program`` :311).  The reference traces one jitted XLA
program per level with data-bounded loops inside; here the level is a
fixed sequence of hand-written kernels captured once into a
``torch.cuda.CUDAGraph`` per static shape and replayed:

1. **chunked expand** over ``cap_f / chunk`` chunks of the parent buffer:
   inflate, guards (K1, folding each live row's ``mult`` into the level's
   ``mult i64[K]`` and its split-brain abort into a minimum), the
   order-keeping compaction of the valid (parent, slot) lanes to
   ``cap_x`` lanes, materialize (K2) and fingerprints (K3), written into a
   level lane buffer of ``n_chunks * cap_x`` lanes at stride ``cap_x``;
2. **the gate** (kernel ``level``): a level that aborted or overflowed
   ``cap_x`` or ``cap_m`` inserts nothing, as the staged chain; otherwise
   probe-and-insert (K4) over the live chunks' lanes, with a fixed budget
   of claim rounds (each exits at once when no lane claims), then the
   fresh lanes compacted to a prefix in lane (= payload) order;
3. **the sieve probe** (B13) over the fresh lanes, against the engine's
   sieve words (the all-miss sentinel until the tiered store demotes);
4. **materialize + invariant scan** of the survivors in slices of
   ``mat_slice_width`` rows into the new frontier buffer of ``cap_out``
   rows;
5. **control**: the undo flag, K4's gated undo, the slab's live-slot count
   and ``ctrl i64[8]`` in the reference's layout, plus the survivors'
   pidx u32 / slot u16.

Every grid is sized at its static capacity; every kernel reads its live
count from the level's control words (``LC_*``, common.cuh), so chunks
past ``n_f`` and slices past ``n_new`` cost one near-empty launch each —
the reference's data-bounded ``while_loop`` and ``lax.cond`` — and one
graph serves every level that fits its shapes.  The host writes ``n_f``
(one host-to-device copy), launches the graph, and reads the control
words, ``mult`` and the survivors' fps/pidx/slot back in one counted
read.

The slab is not functional here: K4 inserts in place.  A level that
stops for any reason gives its claims back inside the same graph (K4's
undo gated on the device flag ``LC_UNDO``), so the slab after the graph is
the slab before it plus exactly the committed level's fresh states.

Under ``canon="expand"`` step 1's chunk is the dense expand with
fingerprints and the chunk compaction (``op_expand_chunk``); under
``use_mxu=False`` ``op_guards`` and ``op_materialize`` launch the legacy
kernels (the guards-only dense expand, ``legacy_materialize``).

On the CPU the same sequence runs eagerly through the plain twins (each
``op_*`` below sends CPU tensors to its twin and CUDA tensors to the
kernel), which is what the tests hold against the reference.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from .. import kernels
from ..models.raft import Frontier, RaftState, core_of, id_dtype
from ..ops import sieve as sieve_ops
from ..ops.fingerprint import OrbitScratch
from ..ops.hashstore import compact_fresh_plain, probe_and_insert_plain
from ..u64 import SENT

I64 = torch.int64
BIG = 1 << 62

# the level's control words (i64[LC_LEN]); common.cuh LevelCtl holds the
# same numbers
LC_N_RUN = 0        # live parent rows (0: a dead level)
LC_ABORT = 1        # first split-brain parent, BIG if none
LC_OVF_X = 2        # a chunk overflowed cap_x
LC_OVF_MX = 3       # an expanded child overflowed cap_m (port only)
LC_LIVE_LANES = 4   # candidate lanes K4 takes (0: gated off)
LC_N_NEW = 5        # fresh lanes
LC_OVF_SLAB = 6     # a probe window filled
LC_OVF_M = 7        # a materialized child overflowed cap_m
LC_BAD = 8          # first invariant-violating new row, -1 if none
LC_SLAB_LIVE = 9    # live slab slots after the level
LC_TIER_HITS = 10   # sieve hits among the fresh lanes
LC_W0 = 11          # K4: lanes claiming in even rounds
LC_W1 = 12          # K4: lanes claiming in odd rounds
LC_K4_NEW = 13      # K4's own fresh count
LC_ROUNDS = 14      # claim rounds that ran
LC_OVF_ROUNDS = 15  # lanes still claimed after the rounds budget (port only)
LC_UNDO = 16        # give the level's claims back
LC_LEN = 24

# ctrl i64[CTRL_LEN], the reference's layout (megakernel.py:77-88)
CTRL_N_NEW = 0
CTRL_ABORT = 1
CTRL_OVF_X = 2
CTRL_OVF_SLAB = 3
CTRL_OVF_M = 4      # port: an expanded child, or a survivor with n_new > 0
CTRL_BAD = 5
CTRL_SLAB_LIVE = 6
CTRL_TIER_HITS = 7
CTRL_LEN = 8

# claim rounds per K4 call inside a graph; a level that needs more redoes
# with twice the budget
DEFAULT_ROUNDS = 32
_PROG_CACHE_MAX = 16


def enabled_by_env() -> bool:
    """The fused level's default (megakernel.py:91): on;
    ``TLA_RAFT_MEGAKERNEL=0`` selects the staged chain."""
    return os.environ.get("TLA_RAFT_MEGAKERNEL", "1") != "0"


def mat_slice_width(cap_out: int, chunk: int) -> int:
    """Materialize slice width: the largest chunk multiple <= 8*chunk that
    tiles ``cap_out`` evenly (megakernel.py:108)."""
    if cap_out <= 8 * chunk:
        return cap_out
    for mult in (8, 4, 2, 1):
        if cap_out % (mult * chunk) == 0:
            return mult * chunk
    return chunk


def empty_frontier(cfg, rows: int, cap_m: int, device) -> Frontier:
    """A frontier buffer of ``rows`` empty rows (ids of the config's width)."""
    from ..kernels import _field_shapes

    shapes = _field_shapes(cfg)
    return Frontier(
        msg_ids=torch.full((rows, cap_m), -1, dtype=id_dtype(cfg), device=device),
        **{f: torch.zeros((rows, *shapes[f]), dtype=torch.uint8, device=device)
           for f in shapes},
    )


def rows_of(fr: Frontier, a: int, b: int) -> Frontier:
    return Frontier(*(x[a:b] for x in fr))


def copy_rows(dst: Frontier, src: Frontier, n: int) -> None:
    """dst[:n] = src[:n], field by field (src's id lists may be narrower)."""
    for d, s in zip(dst, src):
        if d.dim() == 2 and d.shape[1] != s.shape[1]:
            d[:n].fill_(-1)
            d[:n, : s.shape[1]].copy_(s[:n])
        else:
            d[:n].copy_(s[:n])


# -- the lane ops: the kernel on the card, the plain twin on the CPU -----------


def _live(cnt, sub: int, n: int, mul: int = 1) -> int:
    """Host twin of common.cuh live_count (cnt a CPU 0-d tensor)."""
    if cnt is None:
        return n
    return max(0, min(n, (int(cnt) - sub) * mul))


def op_inflate(eng, ids, out, cnt, sub):
    if ids.is_cuda:
        kernels.inflate(ids, eng.uni.n_words, out=out, cnt=cnt, sub=sub)
        return
    from .bfs import ids_to_msgs_plain

    n = _live(cnt, sub, ids.shape[0])
    if n:
        out[:n] = ids_to_msgs_plain(ids[:n], eng.uni.n_words)


def op_guards(eng, st, valid, cnt, sub, mult_acc, abort_acc, base):
    """The chunk's guards: K1, or under ``use_mxu=False`` the guards-only
    ``dense_expand`` (the legacy guard)."""
    if st.msgs.is_cuda:
        if eng.use_mxu:
            kernels.guards(eng.mx, st, valid=valid, per_row=False, cnt=cnt, sub=sub,
                           mult_acc=mult_acc, abort_acc=abort_acc, base=base)
        else:
            kernels.dense_expand(eng.dx, st, False, valid=valid, per_row=False, cnt=cnt, sub=sub,
                                 mult_acc=mult_acc, abort_acc=abort_acc, base=base)
        return
    n = _live(cnt, sub, st.msgs.shape[0])
    if not n:
        return
    part = RaftState(*(x[:n] for x in st))
    v, m, a = eng.mx.guards_plain(part) if eng.use_mxu else eng.dx.guards_plain(part)
    valid[:n] = v
    mult_acc += m.to(I64).sum(0)
    if bool(a.any()):
        first = base + int(torch.argmax(a.to(torch.int32)))
        abort_acc.fill_(min(int(abort_acc), first))


def op_compact_chunk(flags, out, total, cnt, sub, mul, iota_base, tile):
    """The valid lanes' payloads (iota_base + lane) to ``out`` (-1 padded)."""
    cap = out.shape[0]
    if flags.is_cuda:
        kernels.compact(flags, None, -1, cap, out_a=out, total=total, cnt=cnt, sub=sub, mul=mul,
                        iota_base=iota_base, tile=tile)
        return
    n = _live(cnt, sub, flags.shape[0], mul)
    idx = torch.nonzero(flags[:n]).reshape(-1)
    k = min(idx.shape[0], cap)
    out.fill_(-1)
    out[:k] = iota_base + idx[:k]
    total.fill_(idx.shape[0])


def op_materialize(eng, parents, pay, pay_base, out, cnt, sub, ovf_any):
    """Children of payload lanes: K2, or under ``use_mxu=False``
    ``legacy_materialize``."""
    if pay.is_cuda:
        kernels.materialize(eng.mx, parents, None, None, pay=pay, pay_base=pay_base, out=out,
                            cnt=cnt, sub=sub, ovf_any=ovf_any, legacy=not eng.use_mxu)
        return
    n = _live(cnt, sub, pay.shape[0])
    if not n:
        return
    K = eng.K
    p = pay[:n]
    child, added, ovf = eng.materialize_plain(
        parents, torch.div(p, K, rounding_mode="floor") - pay_base, torch.remainder(p, K))
    o_child, o_added, o_ovf = out
    for d, s in zip(o_child, child):
        d[:n] = s
    o_added[:n] = added
    o_ovf[:n] = ovf
    if bool(ovf.any()):
        ovf_any.fill_(1)


def op_fingerprints(eng, children, out, cnt, sub):
    if children.msg_ids.is_cuda:
        kernels.fingerprints(eng.fpr, children, out=out, cnt=cnt, sub=sub)
        return
    n = _live(cnt, sub, children.msg_ids.shape[0])
    fv, ff = out
    fv.fill_(SENT)
    ff.fill_(SENT)
    if n:
        a, b = eng.fpr.state_fingerprints_plain(rows_of(children, 0, n))
        fv[:n] = a
        ff[:n] = b


class ExpandScratch:
    """One chunk's canon="expand" buffers: the fan-out's fingerprints
    fp_view / fp_full i64[chunk, K] (SENT where invalid) and the
    compaction's scratch (allocated once per program)."""

    def __init__(self, eng, rows: int):
        dev, K = eng.device, eng.K
        self.fpv = torch.full((rows, K), SENT, dtype=I64, device=dev)
        self.fpf = torch.full((rows, K), SENT, dtype=I64, device=dev)
        if dev.type == "cuda":
            self.tile = torch.zeros((kernels.compact_tiles(rows * K),), dtype=I64, device=dev)
        else:
            self.tile = None


def op_expand_chunk(eng, st, valid, xs: ExpandScratch, cnt, sub, mult_acc, abort_acc, base,
                    out, total, cap_x: int):
    """canon="expand"'s chunk body (bfs.py:986-1001): the dense expand with
    fingerprints (``dense_expand``, folding mult and the abort as the
    guards do), then ``chunk_compact`` of the live lanes (fp_view not
    SENT) with their payloads ``base * K + lane`` into ``out`` = (cv, cf,
    cp) [cap_x]; ``total`` gets the live lanes (the gate's cap_x
    overflow).  No child is materialized and K3 does not run."""
    K = eng.K
    cv, cf, cp = out
    if st.msgs.is_cuda:
        kernels.dense_expand(eng.dx, st, True, valid=valid, per_row=False, fpv=xs.fpv,
                             fpf=xs.fpf, cnt=cnt, sub=sub, mult_acc=mult_acc,
                             abort_acc=abort_acc, base=base)
        kernels.chunk_compact(xs.fpv.view(-1), xs.fpf.view(-1), cap_x, iota_base=base * K,
                              out=(cv, cf, cp), total=total, cnt=cnt, sub=sub, mul=K,
                              tile=xs.tile)
        return
    n = _live(cnt, sub, st.msgs.shape[0])
    cv.fill_(SENT)
    cf.fill_(SENT)
    cp.fill_(-1)
    total.fill_(0)
    if not n:
        return
    v, m, fv, ff, a = eng.dx.expand_plain(RaftState(*(x[:n] for x in st)))
    valid[:n] = v
    mult_acc += m.to(I64).sum(0)
    if bool(a.any()):
        first = base + int(torch.argmax(a.to(torch.int32)))
        abort_acc.fill_(min(int(abort_acc), first))
    from .bfs import chunk_compact_plain

    a_v, a_f, a_p, tot = chunk_compact_plain(fv.reshape(-1), ff.reshape(-1), cap_x, base * K)
    cv.copy_(a_v)
    cf.copy_(a_f)
    cp.copy_(a_p)
    total.fill_(int(tot))


def op_inv_scan(eng, rows, offset, into, cnt, sub):
    names = list(eng.cfg.invariants)
    if rows.msg_ids.is_cuda:
        kernels.inv_scan(eng.cfg, eng.uni, rows, names, offset, into, cnt=cnt, sub=sub)
        return
    n = _live(cnt, sub, rows.msg_ids.shape[0])
    if n:
        into.copy_(eng.inv_scan(rows_of(rows, 0, n), offset=offset, into=into.clone()))


class K4Scratch:
    """K4's per-lane scratch over the level's lane buffer, and the slab's
    representative minima (on the CPU: the slab as it was, for undo)."""

    def __init__(self, n: int, slab: torch.Tensor):
        dev = slab.device
        self.slot = torch.zeros((n,), dtype=I64, device=dev)
        self.tgt = torch.zeros((n,), dtype=I64, device=dev)
        self.flags = torch.zeros((n,), dtype=torch.uint8, device=dev)
        self.fresh = torch.zeros((n,), dtype=torch.bool, device=dev)
        if dev.type == "cuda":
            self.m1, self.m2 = kernels.rep_scratch(dev, slab.shape[0])
        self.backup = None

    def tuple(self):
        return (self.slot, self.tgt, self.flags, self.fresh, self.m1, self.m2)


def op_k4(slab, cv, cf, cp, lc, k4: K4Scratch, budget: int):
    if slab.is_cuda:
        kernels.probe_and_insert_dev(slab, cv, cf, cp, lc, k4.tuple(), budget)
        return
    live = int(lc[LC_LIVE_LANES])
    k4.fresh.zero_()
    k4.backup = None
    if not live:
        return
    k4.backup = slab.clone()
    _s, fresh, n_new, ovf = probe_and_insert_plain(slab, cv[:live], cf[:live], cp[:live])
    k4.fresh[:live] = fresh
    lc[LC_OVF_SLAB] = int(bool(ovf))
    lc[LC_K4_NEW] = int(n_new)


def op_undo(slab, k4: K4Scratch, live, cond):
    if slab.is_cuda:
        kernels.undo_dev(slab, k4.tuple(), live, cond)
        return
    if int(cond) and int(live) and k4.backup is not None:
        slab.copy_(k4.backup)


def op_compact_fresh(fresh, cv, cp, out_f, out_p, total, live, tile):
    cap = out_f.shape[0]
    if fresh.is_cuda:
        kernels.compact(fresh, cv, SENT, cap, vb=cp, pad_b=-1, out_a=out_f, out_b=out_p,
                        total=total, cnt=live, tile=tile)
        return
    n = int(live)
    a, b = compact_fresh_plain(fresh[:n], cv[:n], cp[:n], cap)
    out_f.copy_(a)
    out_p.copy_(b)
    total.fill_(int(fresh[:n].sum()))


# -- B11 control (csrc/level.cu) and its twins --------------------------------------


def op_level_begin(lc, mult, n_run):
    (kernels.level_begin if lc.is_cuda else level_begin_plain)(lc, mult, n_run)


def level_begin_plain(lc, mult, n_run):
    n = int(n_run)
    lc.zero_()
    mult.zero_()
    lc[LC_N_RUN] = n
    lc[LC_ABORT] = BIG
    lc[LC_BAD] = -1


def op_level_gate(lc, chunk_total, cap_x: int, chunk: int):
    (kernels.level_gate if lc.is_cuda else level_gate_plain)(lc, chunk_total, cap_x, chunk)


def level_gate_plain(lc, chunk_total, cap_x: int, chunk: int):
    ovf = bool((chunk_total > cap_x).any())
    n_run = int(lc[LC_N_RUN])
    lc[LC_OVF_X] = int(ovf)
    gate = ovf or bool(lc[LC_OVF_MX]) or int(lc[LC_ABORT]) < n_run
    lc[LC_LIVE_LANES] = 0 if gate else -(-n_run // chunk) * cap_x


def op_level_decide(lc, cap_out: int):
    (kernels.level_decide if lc.is_cuda else level_decide_plain)(lc, cap_out)


def level_decide_plain(lc, cap_out: int):
    undo = int(lc[LC_LIVE_LANES]) > 0 and (
        bool(lc[LC_OVF_SLAB]) or bool(lc[LC_OVF_ROUNDS]) or int(lc[LC_N_NEW]) > cap_out
        or bool(lc[LC_OVF_M]))
    lc[LC_UNDO] = int(undo)


def op_slab_live(slab, out):
    (kernels.slab_live if slab.is_cuda else slab_live_plain)(slab, out)


def slab_live_plain(slab, out):
    out += (slab != SENT).sum()


def op_level_finalize(lc, ctrl, pay, K: int, pidx, slot):
    (kernels.level_finalize if lc.is_cuda else level_finalize_plain)(lc, ctrl, pay, K, pidx, slot)


def level_finalize_plain(lc, ctrl, pay, K: int, pidx, slot):
    n_new = int(lc[LC_N_NEW])
    ovf_m = bool(lc[LC_OVF_MX]) or (bool(lc[LC_OVF_M]) and n_new > 0)
    ctrl.copy_(torch.tensor([n_new, int(lc[LC_ABORT]), int(lc[LC_OVF_X]), int(lc[LC_OVF_SLAB]),
                             int(ovf_m), int(lc[LC_BAD]), int(lc[LC_SLAB_LIVE]),
                             int(lc[LC_TIER_HITS])], dtype=I64, device=ctrl.device))
    q = torch.div(pay, K, rounding_mode="floor")
    pidx.copy_(q.to(torch.int32))
    slot.copy_((pay - q * K).to(torch.int16))


# -- the level body -------------------------------------------------------------------


class LaneBuffers:
    """Everything one fused level writes besides its output frontier,
    allocated once per static shape (nothing is allocated while a graph
    is captured)."""

    def __init__(self, eng, cap_f: int, cap_out: int, slab: torch.Tensor):
        dev = eng.device
        K, chunk, cap_x, cap_m = eng.K, eng.chunk, eng.cap_x, eng.cap_m
        self.chunk, self.cap_x = chunk, cap_x
        self.n_chunks = cap_f // chunk
        N = self.n_chunks * cap_x
        self.N = N
        self.msgs = torch.zeros((chunk, eng.uni.n_words), dtype=torch.int32, device=dev)
        self.valid = torch.zeros((chunk, K), dtype=torch.bool, device=dev)
        self.chunk_total = torch.zeros((self.n_chunks,), dtype=I64, device=dev)
        self.cv = torch.full((N,), SENT, dtype=I64, device=dev)
        self.cf = torch.full((N,), SENT, dtype=I64, device=dev)
        self.cp = torch.full((N,), -1, dtype=I64, device=dev)
        self.children = empty_frontier(eng.cfg, cap_x, cap_m, dev)
        self.added = torch.zeros((cap_x, eng.mx.A), dtype=torch.int32, device=dev)
        self.covf = torch.zeros((cap_x,), dtype=torch.bool, device=dev)
        self.k4 = K4Scratch(N, slab)
        M = max(N, cap_out)
        self.new_fps = torch.full((M,), SENT, dtype=I64, device=dev)
        self.new_pay = torch.full((M,), -1, dtype=I64, device=dev)
        sl = mat_slice_width(cap_out, chunk)
        self.sl = sl
        self.madded = torch.zeros((sl, eng.mx.A), dtype=torch.int32, device=dev)
        self.movf = torch.zeros((sl,), dtype=torch.bool, device=dev)
        self.sieve = eng._sieve_operand()  # its address is part of the program's key
        self.xs = ExpandScratch(eng, chunk) if eng.canon == "expand" else None
        if dev.type == "cuda":
            self.tile_chunk = torch.zeros((kernels.compact_tiles(chunk * K),), dtype=I64,
                                          device=dev)
            self.tile_fresh = torch.zeros((kernels.compact_tiles(N),), dtype=I64, device=dev)
        else:
            self.tile_chunk = self.tile_fresh = None



def _device_bytes(x) -> int:
    """Device bytes a program's buffers hold (not the slab-sized minima,
    which the slab's programs share)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size() if x.is_cuda else 0
    if isinstance(x, (list, tuple)):
        return sum(_device_bytes(y) for y in x)
    if isinstance(x, (LaneBuffers, K4Scratch, OrbitScratch, ExpandScratch)):
        return sum(_device_bytes(v) for k, v in vars(x).items() if k not in ("m1", "m2"))
    return 0


def level_core(eng, B: LaneBuffers, fr_in: Frontier, fr_out: Frontier, cap_out: int,
               slab: torch.Tensor, lc: torch.Tensor, mult: torch.Tensor, budget: int):
    """Issue one fused level (megakernel.py fused_level_core): from the
    parents ``fr_in`` (``lc[LC_N_RUN]`` live rows) to the new frontier
    ``fr_out[:cap_out]``, inserting into ``slab``.  Returns the survivors'
    (fps, payload) lanes [cap_out]."""
    chunk, cap_x, K = B.chunk, B.cap_x, eng.K
    n_run = lc[LC_N_RUN]
    for i in range(B.n_chunks):
        start = i * chunk
        part = rows_of(fr_in, start, start + chunk)
        op_inflate(eng, part.msg_ids, B.msgs, n_run, start)
        st = RaftState(msgs=B.msgs, **core_of(part))
        seg = slice(i * cap_x, (i + 1) * cap_x)
        total = B.chunk_total[i]
        if eng.canon == "expand":
            op_expand_chunk(eng, st, B.valid, B.xs, n_run, start, mult, lc[LC_ABORT], start,
                            (B.cv[seg], B.cf[seg], B.cp[seg]), total, cap_x)
            continue
        op_guards(eng, st, B.valid, n_run, start, mult, lc[LC_ABORT], start)
        op_compact_chunk(B.valid.view(-1), B.cp[seg], total, n_run, start, K, start * K,
                         B.tile_chunk)
        op_materialize(eng, part, B.cp[seg], start, (B.children, B.added, B.covf), total, 0,
                       lc[LC_OVF_MX])
        op_fingerprints(eng, B.children, (B.cv[seg], B.cf[seg]), total, 0)
    op_level_gate(lc, B.chunk_total, cap_x, chunk)
    op_k4(slab, B.cv, B.cf, B.cp, lc, B.k4, budget)
    op_compact_fresh(B.k4.fresh, B.cv, B.cp, B.new_fps, B.new_pay, lc[LC_N_NEW],
                     lc[LC_LIVE_LANES], B.tile_fresh)
    fps_out, pay_out = B.new_fps[:cap_out], B.new_pay[:cap_out]
    sieve_ops.count_hits(B.sieve, fps_out, lc[LC_TIER_HITS])
    sl = B.sl
    for a in range(0, cap_out, sl):
        rows = rows_of(fr_out, a, a + sl)
        op_materialize(eng, fr_in, pay_out[a:a + sl], 0, (rows, B.madded, B.movf),
                       lc[LC_N_NEW], a, lc[LC_OVF_M])
        op_inv_scan(eng, rows, a, lc[LC_BAD], lc[LC_N_NEW], a)
    return fps_out, pay_out


# -- captured programs --------------------------------------------------------------


class GraphProgram:
    """A fused program over static buffers: ``record`` issues its kernels;
    on the card the first ``launch`` captures them into a CUDA graph and
    every launch replays it (a failed capture raises: there is no eager
    fallback); on the CPU every launch runs ``record`` through the twins."""

    kind = "program"

    def __init__(self, eng, key):
        self.key = key
        self.device = eng.device
        self.graph = None
        self.tally = None
        self.stats = eng.graph_stats

    def record(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def launch(self) -> None:
        if self.device.type != "cuda":
            self.record()
            return
        if self.graph is None:
            t0 = time.perf_counter()
            tally = kernels.Tally()
            g = torch.cuda.CUDAGraph()
            # no collection while the stream captures (a collected graph or
            # pinned buffer would invalidate the capture); evicted programs
            # free theirs at once (``release``)
            gc.disable()
            try:
                with torch.cuda.graph(g):
                    self.record()
            finally:
                gc.enable()
            tally.take()
            self.graph, self.tally = g, tally
            secs = time.perf_counter() - t0
            self.stats["captures"] += 1
            self.stats["capture_seconds"] += secs
            self.stats["capture_log"].append(
                [self.kind, getattr(self, "cap_f", None), round(secs, 4),
                 sum(tally.per_replay.values())])
        self.graph.replay()
        self.tally.replay()
        self.stats[f"{self.kind}_launches"] += 1

    def nbytes(self) -> int:
        """Device bytes of the program's own buffers (not the slab)."""
        return sum(_device_bytes(v) for k, v in vars(self).items() if k != "slab")

    def release(self) -> None:
        """Free the graph and every buffer now (evicted from the cache)."""
        self.__dict__.clear()


class LevelProgram(GraphProgram):
    """One fused level at static (cap_f, cap_out): the parents go into
    ``fr_in``, the new frontier comes out in ``fr_out``."""

    kind = "level"

    def __init__(self, eng, key, cap_f: int, cap_out: int, budget: int):
        super().__init__(eng, key)
        dev = eng.device
        self.eng = eng
        self.cap_f, self.cap_out, self.budget = cap_f, cap_out, budget
        self.slab = eng.hstore.slab
        self.fr_in = empty_frontier(eng.cfg, cap_f, eng.cap_m, dev)
        self.fr_out = empty_frontier(eng.cfg, cap_out, eng.cap_m, dev)
        self.B = LaneBuffers(eng, cap_f, cap_out, self.slab)
        self.lc = torch.zeros((LC_LEN,), dtype=I64, device=dev)
        self.mult = torch.zeros((eng.K,), dtype=I64, device=dev)
        self.n_f = torch.zeros((), dtype=I64, device=dev)
        self.ctrl = torch.zeros((CTRL_LEN,), dtype=I64, device=dev)
        self.pidx = torch.zeros((cap_out,), dtype=torch.int32, device=dev)
        self.slot = torch.zeros((cap_out,), dtype=torch.int16, device=dev)
        self.host_n_f = torch.zeros((), dtype=I64, pin_memory=dev.type == "cuda")

    def record(self) -> None:
        eng, B, lc = self.eng, self.B, self.lc
        op_level_begin(lc, self.mult, self.n_f)
        fps_out, pay_out = level_core(eng, B, self.fr_in, self.fr_out, self.cap_out, self.slab,
                                      lc, self.mult, self.budget)
        op_level_decide(lc, self.cap_out)
        op_undo(self.slab, B.k4, lc[LC_LIVE_LANES], lc[LC_UNDO])
        op_slab_live(self.slab, lc[LC_SLAB_LIVE])
        op_level_finalize(lc, self.ctrl, pay_out, eng.K, self.pidx, self.slot)
        self.fps_out = fps_out

    def run(self, n_f: int) -> None:
        """Write n_f (one host-to-device copy) and launch."""
        self.host_n_f.fill_(n_f)
        self.n_f.copy_(self.host_n_f, non_blocking=True)
        self.launch()


class ProgramCache:
    """Captured programs keyed on their static shapes, at most
    ``_PROG_CACHE_MAX`` (least recently used first out).  A key ends with
    the budgets' signature (cap_x, cap_m, rounds, slab address and
    capacity); ``drop_stale`` forgets every program of another signature,
    so a grown slab or budget frees the programs captured before it."""

    def __init__(self):
        self.progs: dict = {}

    def get(self, key, build):
        prog = self.progs.pop(key, None)
        if prog is None:
            prog = build()
        self.progs[key] = prog
        while len(self.progs) > _PROG_CACHE_MAX:
            self.progs.pop(next(iter(self.progs))).release()
        return prog

    def drop_stale(self, sig: tuple) -> None:
        for k in [k for k in self.progs if k[-len(sig):] != sig]:
            self.progs.pop(k).release()

    def clear(self) -> None:
        while self.progs:
            self.progs.popitem()[1].release()
