"""Resident supersteps (B12): up to ``span`` fused levels per CUDA graph.

The port of ``tla_raft_tpu/engine/superstep.py``.  One captured graph runs
``span`` fused levels back to back (engine/megakernel.py ``level_core``,
the same body as the per-level program, so the two cannot drift), each
followed by the commit kernel (csrc/superstep.cu): a level COMMITS only
when it is clean — no abort, no invariant violation, no overflow of any
class (cap_x, slab probe window, cap_m, the frontier seat ``cap_f``, the
ring's high water; the port adds K4's rounds budget).  A committed level's
(fps, pidx, slot) records go to the ring at the running offset, its
``n_new`` and ``mult`` to ``meta_n`` / ``meta_mult``; anything else stops
the loop before the level commits, gives the level's slab claims back
(K4's undo gated on the commit flag) and zeroes the parent count every
later level's kernels read, so they exit at once.  A clean level with no
new state commits as the terminal FIXPOINT record.

The frontier ping-pongs between two buffers of ``cap_f`` rows: level j
reads buffer j % 2 and writes the other.  After the span the committed
frontier (on a STOP: the stopped level's parent, as the reference returns
it) is settled into buffer 0.  The host writes (n_f, lvl_cap) with one
host-to-device copy, launches the graph and reads the ctrl words, the
per-level meta and the ring in one counted read; ``unpack_ring`` turns
them into the per-level records the run loop consumes.  ``lvl_cap`` (the
``--max-depth`` remainder) is a device word, so one graph serves every
remainder.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import forecast
from . import megakernel as mk

I64 = torch.int64

# default levels per superstep
DEFAULT_SPAN = 4

# ctrl words (i64[SS_LEN]); the first six are the reference's ctrl
# (superstep.py:79-88), the rest the port's loop state (csrc/superstep.cu)
SS_LEVELS = 0     # committed levels (incl. a terminal fixpoint level)
SS_REASON = 1     # stop reason (REASON_*)
SS_NF = 2         # frontier rows after the last committed level
SS_OFF = 3        # ring entries used by the committed prefix
SS_SLAB_LIVE = 4  # live slots of the slab after the superstep
SS_FLAGS = 5      # the stopped level's cause bits (FLAG_*)
SS_RUNNING = 6    # the loop still runs
SS_NRUN = 7       # the next level's parent count (0 once stopped)
SS_LVL_CAP = 8    # levels this superstep may commit
SS_APPEND = 9     # ring offset of the current level's records, -1: none
SS_UNDO = 10      # give the current level's claims back
SS_RING = 11      # ring entries this superstep may use
SS_LEN = 16
SS_CTRL = 6

FLAG_OVF_X = 1      # a chunk overflowed its cap_x compaction budget
FLAG_OVF_SLAB = 2   # a probe window filled (grow + redo)
FLAG_OVF_M = 4      # a child overflowed the cap_m msg-id width
FLAG_OVF_OUT = 8    # n_new > cap_f (cannot seat the next frontier)
FLAG_ABORT = 16     # split-brain abort in the stopped level
FLAG_BAD = 32       # invariant violation in the stopped level
FLAG_TIER = 128     # sieve hits (never without a tiered store)
FLAG_OVF_ROUNDS = 256  # port only: K4's claim rounds ran past their budget

REASON_RUN = 0
REASON_STOP = 1
REASON_RING = 2
REASON_FIX = 3

REASON_NAMES = {
    REASON_RUN: "span",
    REASON_STOP: "stop",
    REASON_RING: "ring",
    REASON_FIX: "fixpoint",
}


def unpack_ring(ctrl, meta_n, meta_mult, ring_fps, ring_pidx, ring_slot):
    """The superstep fetch -> per-level records (superstep.py:347).

    Returns ``(recs, reason, n_f, slab_live, flags)``; ``recs`` holds one
    dict per committed level — ``n_new``, ``mult`` i64[K], ``fps``
    u64[n_new], ``pidx``/``slot`` i64[n_new] — in level order.  The
    arrays are copies (the fetch buffers are reused)."""
    ctrl = np.asarray(ctrl, np.int64)
    levels = int(ctrl[SS_LEVELS])
    recs = []
    off = 0
    mn = np.asarray(meta_n, np.int64)
    mm = np.asarray(meta_mult, np.int64)
    for i in range(levels):
        n_new = int(mn[i])
        recs.append(dict(
            n_new=n_new,
            mult=mm[i].copy(),
            fps=np.asarray(ring_fps[off:off + n_new]).view(np.uint64).copy(),
            pidx=np.asarray(ring_pidx[off:off + n_new]).view(np.uint32).astype(np.int64),
            slot=np.asarray(ring_slot[off:off + n_new]).view(np.uint16).astype(np.int64),
        ))
        off += n_new
    reason = REASON_NAMES.get(int(ctrl[SS_REASON]), "stop")
    return (recs, reason, int(ctrl[SS_NF]), int(ctrl[SS_SLAB_LIVE]), int(ctrl[SS_FLAGS]))


def ring_capacity(fut, span: int, cap_f: int, pow2) -> int:
    """Ring slots for one superstep (superstep.py:385): one rung per
    forecast level (margined, clamped at cap_f), padded with the last,
    quantized pow2 and clamped to [cap_f, span * cap_f]; small capacities
    pin the ring at the span * cap_f ceiling."""
    if span * cap_f <= (1 << 16):
        return pow2(span * cap_f)
    if fut:
        m = forecast.cap_margin()
        rungs = [min(int(f * m) + 1, cap_f) for f in fut[:span]]
        rungs += [rungs[-1]] * (span - len(rungs))
        est = sum(rungs)
    else:
        est = span * cap_f
    est = max(est, cap_f)
    return min(pow2(est), pow2(span * cap_f))


# -- B12 control (csrc/superstep.cu) and its twins ---------------------------------


def op_ss_begin(ss, args):
    (kernels.ss_begin if ss.is_cuda else ss_begin_plain)(ss, args)


def ss_begin_plain(ss, args):
    n_f, lvl_cap, ring = int(args[0]), int(args[1]), int(args[2])
    ss.zero_()
    ss[SS_NF] = n_f
    ss[SS_LVL_CAP] = lvl_cap
    ss[SS_RUNNING] = int(lvl_cap > 0)
    ss[SS_NRUN] = n_f if lvl_cap > 0 else 0
    ss[SS_APPEND] = -1
    ss[SS_RING] = ring


def op_ss_commit(ss, lc, mult, cap_f, meta_n, meta_mult, meta_rounds):
    (kernels.ss_commit if ss.is_cuda else ss_commit_plain)(
        ss, lc, mult, cap_f, meta_n, meta_mult, meta_rounds)


def ss_commit_plain(ss, lc, mult, cap_f, meta_n, meta_mult, meta_rounds):
    if not int(ss[SS_RUNNING]):
        ss[SS_APPEND] = -1
        ss[SS_UNDO] = 0
        return
    n_f, off, lvl = int(ss[SS_NF]), int(ss[SS_OFF]), int(ss[SS_LEVELS])
    n_new = int(lc[mk.LC_N_NEW])
    abort = int(lc[mk.LC_ABORT]) < n_f
    ovf_x = bool(lc[mk.LC_OVF_X])
    ovf_slab = bool(lc[mk.LC_OVF_SLAB])
    ovf_m = bool(lc[mk.LC_OVF_MX]) or (bool(lc[mk.LC_OVF_M]) and n_new > 0)
    ovf_out = n_new > cap_f
    ring_ovf = off + n_new > int(ss[SS_RING])
    tier = int(lc[mk.LC_TIER_HITS]) > 0
    bad = int(lc[mk.LC_BAD]) >= 0
    rounds = bool(lc[mk.LC_OVF_ROUNDS])
    stop = abort or ovf_x or ovf_slab or ovf_m or ovf_out or bad or tier or rounds
    commit = not stop and not ring_ovf
    fix = commit and n_new == 0
    reason = (REASON_STOP if stop else REASON_RING if ring_ovf
              else REASON_FIX if fix else REASON_RUN)
    flags = (FLAG_OVF_X * ovf_x + FLAG_OVF_SLAB * ovf_slab + FLAG_OVF_M * ovf_m
             + FLAG_OVF_OUT * ovf_out + FLAG_ABORT * abort + FLAG_BAD * bad + FLAG_TIER * tier
             + FLAG_OVF_ROUNDS * rounds)
    meta_n[lvl] = n_new
    meta_rounds[lvl] = lc[mk.LC_ROUNDS]
    meta_mult[lvl] = mult
    ss[SS_APPEND] = off if commit else -1
    ss[SS_UNDO] = int(not commit)
    lvl2 = lvl + int(commit)
    ss[SS_LEVELS] = lvl2
    ss[SS_OFF] = off + (n_new if commit else 0)
    ss[SS_REASON] = reason
    ss[SS_FLAGS] = flags if stop else 0
    ss[SS_NF] = n_new if commit else n_f
    run = reason == REASON_RUN and lvl2 < int(ss[SS_LVL_CAP])
    ss[SS_RUNNING] = int(run)
    ss[SS_NRUN] = int(ss[SS_NF]) if run else 0


def op_ss_append(ss, lc, fps, pay, K, ring_fps, ring_pidx, ring_slot):
    (kernels.ss_append if ss.is_cuda else ss_append_plain)(
        ss, lc, fps, pay, K, ring_fps, ring_pidx, ring_slot)


def ss_append_plain(ss, lc, fps, pay, K, ring_fps, ring_pidx, ring_slot):
    off = int(ss[SS_APPEND])
    if off < 0:
        return
    n = min(int(lc[mk.LC_N_NEW]), fps.shape[0])
    p = pay[:n]
    q = torch.div(p, K, rounding_mode="floor")
    ring_fps[off:off + n] = fps[:n]
    ring_pidx[off:off + n] = q.to(torch.int32)
    ring_slot[off:off + n] = (p - q * K).to(torch.int16)


def op_ss_settle(ss, src, dst):
    (kernels.ss_settle if ss.is_cuda else ss_settle_plain)(ss, src, dst)


def ss_settle_plain(ss, src, dst):
    if int(ss[SS_LEVELS]) & 1:
        mk.copy_rows(dst, src, int(ss[SS_NF]))


class SuperstepProgram(mk.GraphProgram):
    """``span`` fused levels at a static ``cap_f``: the parents go into
    ``fr[0]``, and the committed frontier comes back there.  The ring
    buffers hold ``ring_max`` entries; the ring size of each launch is a
    device word, so one graph serves every ring up to that."""

    kind = "superstep"

    def __init__(self, eng, key, cap_f: int, ring_max: int, span: int, budget: int):
        super().__init__(eng, key)
        dev = eng.device
        K = eng.K
        self.eng = eng
        self.cap_f, self.ring_max, self.span, self.budget = cap_f, ring_max, span, budget
        self.slab = eng.hstore.slab
        self.fr = [mk.empty_frontier(eng.cfg, cap_f, eng.cap_m, dev) for _ in range(2)]
        self.B = mk.LaneBuffers(eng, cap_f, cap_f, self.slab)
        self.lc = torch.zeros((mk.LC_LEN,), dtype=I64, device=dev)
        self.mult = torch.zeros((K,), dtype=I64, device=dev)
        self.ss = torch.zeros((SS_LEN,), dtype=I64, device=dev)
        self.args = torch.zeros((3,), dtype=I64, device=dev)
        self.host_args = torch.zeros((3,), dtype=I64, pin_memory=dev.type == "cuda")
        self.meta_n = torch.zeros((span,), dtype=I64, device=dev)
        self.meta_mult = torch.zeros((span, K), dtype=I64, device=dev)
        self.meta_rounds = torch.zeros((span,), dtype=I64, device=dev)
        self.ring_fps = torch.full((ring_max,), -1, dtype=I64, device=dev)
        self.ring_pidx = torch.zeros((ring_max,), dtype=torch.int32, device=dev)
        self.ring_slot = torch.zeros((ring_max,), dtype=torch.int16, device=dev)

    def record(self) -> None:
        eng, B, lc, ss = self.eng, self.B, self.lc, self.ss
        op_ss_begin(ss, self.args)
        for j in range(self.span):
            fa, fb = self.fr[j % 2], self.fr[(j + 1) % 2]
            mk.op_level_begin(lc, self.mult, ss[SS_NRUN])
            fps_out, pay_out = mk.level_core(eng, B, fa, fb, self.cap_f, self.slab, lc,
                                             self.mult, self.budget)
            op_ss_commit(ss, lc, self.mult, self.cap_f, self.meta_n, self.meta_mult,
                         self.meta_rounds)
            op_ss_append(ss, lc, fps_out, pay_out, eng.K, self.ring_fps, self.ring_pidx,
                         self.ring_slot)
            mk.op_undo(self.slab, B.k4, lc[mk.LC_LIVE_LANES], ss[SS_UNDO])
        op_ss_settle(ss, self.fr[1], self.fr[0])
        mk.op_slab_live(self.slab, ss[SS_SLAB_LIVE])

    def run(self, n_f: int, lvl_cap: int, ring: int) -> None:
        """Write (n_f, lvl_cap, ring) (one host-to-device copy) and launch."""
        if not 1 <= ring <= self.ring_max:
            raise ValueError(f"ring {ring} outside this program's 1..{self.ring_max}")
        self.host_args[0] = n_f
        self.host_args[1] = lvl_cap
        self.host_args[2] = ring
        self.args.copy_(self.host_args, non_blocking=True)
        self.launch()
