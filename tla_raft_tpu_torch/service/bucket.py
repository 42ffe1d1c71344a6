"""Config-batched checking: many CONSTANT bindings, one device stream (B14).

The port of ``tla_raft_tpu/service/bucket.py``.  A **shape bucket** holds
configs that differ only in MaxRestart (``bucket_key``): every tensor shape
and table derives from (S, Vals, MaxElection), and MaxRestart appears only
as the Restart family's guard threshold.  The bucket stacks its members'
frontiers into one, expands it with the dense expand built at the bucket's
largest MaxRestart, and refines each row's Restart slots by its own config's
bound (``rc < mr_c``: exact, not approximated).  Fingerprints are salted per
config (``fp ^ splitmix64(slot)``) before they enter the one shared hash
slab, so dedup is config-scoped; per-config gen / new / abort sums, liveness
and retirement (depth caps, aborts, fixpoints, invariant violations) keep
the members apart, and each member's distinct / generated / depth /
level_sizes equal a sequential run of its config.

A bucket level is the engine's ``canon="expand"`` chunk chain with a config
column: per chunk of rows, ``inflate``, ``dense_expand`` with fingerprints,
**``bucket_refine``** (the refinement, the salts, gen and abort) and
``chunk_compact`` of the live lanes with their global payloads
``row * K + slot`` (so the min-(fp_full, payload) representative and the
lane order are the reference's, which expands the whole stacked frontier at
once); then K4 over the level's lanes, the fresh compaction (the inserted
salted fingerprints in lane order), **``bucket_tally``** (per-config new,
the keep flags ``fresh & ~(done | abort)[crow]``, the ring append), the
survivors' compaction, K2 (or ``legacy_materialize``) and ``inv_scan``.
Lanes of a config that aborts in the level are inserted all the same: the
probe-and-insert precedes the keep filter, as in the reference.

Three routes, one bookkeeping:

* **supersteps** (default, span 4, ``TLA_RAFT_SUPERSTEP``): up to ``span``
  levels in one CUDA graph with **``bucket_ctrl``** (csrc/bucket.cu) keeping
  the per-config retirement on the device; one launch and one read a
  superstep; a level that is not clean (an overflow, an invariant
  violation) stops the window uncommitted and gives its slab claims back.
  Every level of a superstep runs every chunk of its static seat, live or
  not, so a window whose seat would pass ``SS_MAX_CHUNKS`` chunks runs
  fused levels instead;
* **the fused level** (a stopped or too-wide window's level, or
  ``superstep=1``): one graph launch and one read a level, seated at the
  power of 2 above its parent count, with the exact redo on an overflow;
* the reference's staged step + mat route (``megakernel=False``) is not in
  the port: ``TLA_RAFT_MEGAKERNEL=0`` selects the fused level.

The slab is in place (the reference's is functional): a stopped or redone
level gives its claims back through K4's gated undo, and a grown slab is a
rehash of the old one at the reference's ``_rebuild_slab`` sizing, so the
inserted set (``all_fps``) and the counts are the reference's; the slab's
bytes may differ (they depend on how inserts were batched).  Row r of the
stacked frontier belongs to config ``crow[r]`` and is live when r is below
the level's parent count and its config is not done (the reference's
``live`` mask, kept implicit).

``run(checkpoint_dir=...)`` commits a ``bstate_NNNN.npz`` bucket snapshot
through the atomic manifest writer (dense ``RaftState`` fields, so a
snapshot moves between the two packages), and resumes from the newest
healable one of the same job set.  On the CPU every step runs eagerly
through the plain twins; on the card each program is a captured graph.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time

import numpy as np
import torch

from .. import kernels, resilience
from ..config import RaftConfig
from ..device import fetch
from ..engine import forecast
from ..engine import megakernel as mk
from ..engine import superstep as ss
from ..engine.bfs import TorchChecker, ids_to_msgs, msgs_to_ids
from ..models.raft import Frontier, RaftState, core_of, init_batch
from ..ops import hashstore
from ..u64 import SENT

I64 = torch.int64
# the widest superstep seat, in chunks: past it the dead chunks of a
# window's narrower levels cost more than the per-level reads it saves
SS_MAX_CHUNKS = 16

# the Restart family's id in the slot grid (ops/successor.py's family table)
RESTART_FAMILY = 11

# bucket-state checkpoint records: write-once per-level names, so the
# rename-beat-manifest crash window leaves an unmanifested record (adoptable)
BSTATE_FMT = "bstate_{:04d}.npz"
BSTATE_GLOB = "bstate_*.npz"
_STATE_FIELDS = RaftState._fields

# the bucket's control words (csrc/bucket.cu BucketWord); words 0 and 2 are
# where ss_settle reads the committed levels and rows
BS_LEVELS, BS_REASON, BS_NRUN, BS_OFF, BS_SLAB_LIVE, BS_FLAGS = 0, 1, 2, 3, 4, 5
BS_RUNNING, BS_LRUN, BS_SPAN, BS_RING, BS_UNDO, BS_NG = 6, 7, 8, 9, 10, 11
BS_LEN = 16
BC_BEGIN, BC_PRE, BC_POST, BC_LEVEL = (kernels.BC_BEGIN, kernels.BC_PRE, kernels.BC_POST,
                                       kernels.BC_LEVEL)
SPLIT_BRAIN = 'Assert "split brain" (Raft.tla:185)'


def bucket_key(cfg: RaftConfig) -> RaftConfig:
    """The shape-bucket key: the config with MaxRestart struck out."""
    return dataclasses.replace(cfg, max_restart=0)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer (numpy u64, vectorized)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def config_salts(n: int) -> np.ndarray:
    """Per-config-slot fingerprint salts (bucket.py:107-121)."""
    return _splitmix64(np.arange(1, n + 1, dtype=np.uint64))


# -- the three kernels' plain twins (csrc/bucket.cu) -------------------------------


def bucket_refine_plain(valid, mult, abort, fpv, crow, rc, fam_rs, mr, salt, done, gen, abort_c,
                        cnt=None, sub=0) -> None:
    """Plain twin of ``bucket_refine`` (in place, the same arguments)."""
    rows, K = valid.shape
    live = torch.arange(rows, device=valid.device) < mk._live(cnt, sub, rows)
    c = crow.clamp(0, mr.shape[0] - 1)
    live &= ~done[c].bool() & (crow >= 0)
    ok = valid & live[:, None] & (
        ~fam_rs.bool()[None, :] | (rc.to(torch.int32)[:, None] < mr[c][:, None]))
    m = torch.where(ok, mult.to(I64), torch.zeros_like(mult, dtype=I64)).sum(1)
    gen.index_add_(0, c, torch.where(live, m, torch.zeros_like(m)))
    ab = (abort & live).to(I64)
    hit = torch.zeros_like(abort_c).index_add_(0, c, ab)
    abort_c.copy_(torch.where(hit > 0, torch.ones_like(abort_c), abort_c))
    salted = fpv ^ salt[c][:, None]
    fpv.copy_(torch.where(ok, salted, torch.full_like(fpv, SENT)))


def bucket_tally_plain(fresh, pay, live, crow, K: int, done, abort_c, new_c, keep, ins=None,
                       n_ins=None, ring=None, ring_off=None) -> None:
    """Plain twin of ``bucket_tally`` (in place, the same arguments)."""
    n = fresh.shape[0]
    lv = torch.arange(n, device=fresh.device) < min(int(live), n)
    f = fresh & lv
    row = torch.where(f, torch.div(pay, K, rounding_mode="floor"), torch.zeros_like(pay))
    c = torch.where(f, crow[row], torch.zeros_like(pay))
    new_c.index_add_(0, c, f.to(I64))
    keep.copy_(f & ~done[c].bool() & ~abort_c[c].bool())
    if ring is not None:
        off, m, R = int(ring_off), int(n_ins), ring.shape[0]
        take = max(0, min(m, R - off))
        if take:
            ring[off:off + take] = ins[:take]


def bucket_ctrl_plain(phase: int, bs, lc, args, done, done1, depth, cap, gen_c, new_c, abort_c,
                      meta, g_cap: int, crow_in, crow_out, pay, K: int) -> None:
    """Plain twin of ``bucket_ctrl`` (in place, the same arguments)."""
    if phase == BC_BEGIN:
        bs.zero_()
        bs[BS_NRUN], bs[BS_SPAN], bs[BS_RING] = args[0], args[1], args[2]
        bs[BS_RUNNING] = int(int(args[1]) > 0)
        return
    if phase == BC_PRE:
        run = bool(bs[BS_RUNNING])
        capped = (cap >= 0) & (depth >= cap) & ~done.bool() if run else torch.zeros_like(
            done, dtype=torch.bool)
        done1.copy_((done.bool() | capped).to(I64))
        gen_c.zero_()
        new_c.zero_()
        abort_c.zero_()
        bs[BS_LRUN] = bs[BS_NRUN] if run else 0
        return
    n_g = int(bs[BS_NG])
    if phase == BC_LEVEL:
        bs[BS_UNDO] = int(int(lc[mk.LC_LIVE_LANES]) > 0 and (
            bool(lc[mk.LC_OVF_SLAB]) or bool(lc[mk.LC_OVF_ROUNDS]) or n_g > g_cap
            or (bool(lc[mk.LC_OVF_M]) and n_g > 0)))
    elif bool(bs[BS_RUNNING]):
        m_new, m_gen, m_abort, m_ins, m_ng = meta
        lvl, off = int(bs[BS_LEVELS]), int(bs[BS_OFF])
        n_ins = int(lc[mk.LC_N_NEW])
        ring_ovf = off + n_ins > int(bs[BS_RING])
        ovf_x, ovf_slab = bool(lc[mk.LC_OVF_X]), bool(lc[mk.LC_OVF_SLAB])
        rounds, ovf_g = bool(lc[mk.LC_OVF_ROUNDS]), n_g > g_cap
        ovf_m, bad = bool(lc[mk.LC_OVF_M]) and n_g > 0, int(lc[mk.LC_BAD]) >= 0
        stop = ovf_x or ovf_slab or rounds or ovf_g or ovf_m or bad
        commit = not stop and not ring_ovf
        m_new[lvl] = new_c
        m_gen[lvl] = gen_c
        m_abort[lvl] = (abort_c != 0).to(I64)
        alive = ~done1.bool()
        ab = abort_c.bool()
        d2 = done1.bool() | (alive & ab) | (alive & ~ab & (new_c == 0))
        if commit:
            depth += (alive & ~ab & (new_c > 0)).to(I64)
            done.copy_(d2.to(I64))
        m_ins[lvl] = n_ins
        m_ng[lvl] = n_g
        fix = commit and (bool(d2.all()) or n_g == 0)
        reason = (ss.REASON_STOP if stop else ss.REASON_RING if ring_ovf
                  else ss.REASON_FIX if fix else ss.REASON_RUN)
        lvl2 = lvl + int(commit)
        bs[BS_LEVELS] = lvl2
        bs[BS_OFF] = off + (n_ins if commit else 0)
        bs[BS_REASON] = reason
        bs[BS_FLAGS] = (ss.FLAG_OVF_X * ovf_x + ss.FLAG_OVF_SLAB * ovf_slab
                        + ss.FLAG_OVF_M * ovf_m + ss.FLAG_OVF_OUT * ovf_g + ss.FLAG_BAD * bad
                        + ss.FLAG_OVF_ROUNDS * rounds) if stop else 0
        if commit:
            bs[BS_NRUN] = n_g
        bs[BS_RUNNING] = int(reason == ss.REASON_RUN and lvl2 < int(bs[BS_SPAN]))
        bs[BS_UNDO] = int(not commit)
    else:
        bs[BS_UNDO] = 0
    m = min(n_g, g_cap)
    if m:
        crow_out[:m] = crow_in[torch.div(pay[:m], K, rounding_mode="floor")]


def op_refine(*a, **kw):
    (kernels.bucket_refine if a[0].is_cuda else bucket_refine_plain)(*a, **kw)


def op_tally(*a, **kw):
    (kernels.bucket_tally if a[0].is_cuda else bucket_tally_plain)(*a, **kw)


def op_ctrl(*a):
    (kernels.bucket_ctrl if a[1].is_cuda else bucket_ctrl_plain)(*a)


# -- the level body and its programs -----------------------------------------------


def op_dense_expand(eng, st, B, cnt, sub) -> None:
    """The chunk's dense expand with fingerprints, per row (valid, mult,
    abort, fp_view, fp_full into B's buffers; rows past ``cnt - sub`` not
    written)."""
    if st.msgs.is_cuda:
        kernels.dense_expand(eng.dx, st, True, valid=B.valid, per_row=True, fpv=B.fpv,
                             fpf=B.fpf, cnt=cnt, sub=sub, mult_out=B.mult, abort_out=B.abort)
        return
    n = mk._live(cnt, sub, st.msgs.shape[0])
    if n:
        v, m, fv, ff, a = eng.dx.expand_plain(RaftState(*(x[:n] for x in st)))
        B.valid[:n], B.mult[:n], B.fpv[:n], B.fpf[:n], B.abort[:n] = v, m, fv, ff, a


def op_chunk_compact(B, i: int, base: int, cnt, sub: int, K: int) -> None:
    cap_x = B.cap_x
    seg = slice(i * cap_x, (i + 1) * cap_x)
    out = (B.cv[seg], B.cf[seg], B.cp[seg])
    if B.fpv.is_cuda:
        kernels.chunk_compact(B.fpv.view(-1), B.fpf.view(-1), cap_x, iota_base=base, out=out,
                              total=B.chunk_total[i], cnt=cnt, sub=sub, mul=K, tile=B.tile_chunk)
        return
    from ..engine.bfs import chunk_compact_plain

    n = mk._live(cnt, sub, B.fpv.shape[0]) * K
    fv = B.fpv.view(-1)[:n]
    a_v, a_f, a_p, tot = chunk_compact_plain(fv, B.fpf.view(-1)[:n], cap_x, base)
    for o, x in zip(out, (a_v, a_f, a_p)):
        o.copy_(x)
    B.chunk_total[i].fill_(int(tot))


def op_compact_keep(keep, cp, out, total, live, tile) -> None:
    """The kept lanes' payloads to ``out`` in lane order (-1 padded),
    ``total`` the kept count (may pass the capacity)."""
    cap = out.shape[0]
    if keep.is_cuda:
        kernels.compact(keep, cp, -1, cap, out_a=out, total=total, cnt=live, tile=tile)
        return
    n = int(live)
    idx = torch.nonzero(keep[:n]).reshape(-1)
    k = min(idx.shape[0], cap)
    out.fill_(-1)
    out[:k] = cp[idx[:k]]
    total.fill_(idx.shape[0])


class BucketVecs:
    """The per-config device vectors a bucket's programs read and write
    (their addresses are in the captured graphs): done, done1, depth,
    cap, the gen / new / abort accumulators (i64 [C]), MaxRestart (i32
    [C]), the salts (i64 [C]), and the Restart-family flag of each slot
    (u8 [K])."""

    def __init__(self, C: int, mr: np.ndarray, salts: np.ndarray, fam_rs: np.ndarray, dev):
        z = lambda: torch.zeros((C,), dtype=I64, device=dev)  # noqa: E731
        self.done, self.done1, self.depth, self.cap = z(), z(), z(), z()
        self.gen, self.new, self.abort = z(), z(), z()
        self.mr = torch.from_numpy(np.asarray(mr, np.int32)).to(dev)
        self.salt = torch.from_numpy(np.asarray(salts, np.uint64).view(np.int64)).to(dev)
        self.fam_rs = torch.from_numpy(np.asarray(fam_rs, np.uint8)).to(dev)

    def upload(self, done: np.ndarray, depth: np.ndarray, cap: np.ndarray) -> None:
        for t, v in ((self.done, done), (self.depth, depth), (self.cap, cap)):
            t.copy_(torch.from_numpy(np.asarray(v, np.int64)))


class BucketBuffers:
    """One bucket program's lane buffers at static (cap_in, g_cap)."""

    def __init__(self, eng, cap_in: int, g_cap: int, slab: torch.Tensor):
        dev, K, chunk, cap_x = eng.device, eng.K, eng.chunk, eng.cap_x
        self.cap_x = cap_x
        self.n_chunks = cap_in // chunk
        N = self.n_chunks * cap_x
        self.msgs = torch.zeros((chunk, eng.uni.n_words), dtype=torch.int32, device=dev)
        self.valid = torch.zeros((chunk, K), dtype=torch.bool, device=dev)
        self.mult = torch.zeros((chunk, K), dtype=torch.int32, device=dev)
        self.abort = torch.zeros((chunk,), dtype=torch.bool, device=dev)
        self.fpv = torch.full((chunk, K), SENT, dtype=I64, device=dev)
        self.fpf = torch.full((chunk, K), SENT, dtype=I64, device=dev)
        self.mult_k = torch.zeros((K,), dtype=I64, device=dev)
        self.chunk_total = torch.zeros((self.n_chunks,), dtype=I64, device=dev)
        self.cv = torch.full((N,), SENT, dtype=I64, device=dev)
        self.cf = torch.full((N,), SENT, dtype=I64, device=dev)
        self.cp = torch.full((N,), -1, dtype=I64, device=dev)
        self.k4 = mk.K4Scratch(N, slab)
        self.ins_fps = torch.full((N,), SENT, dtype=I64, device=dev)
        self.ins_pay = torch.full((N,), -1, dtype=I64, device=dev)
        self.keep = torch.zeros((N,), dtype=torch.bool, device=dev)
        self.surv_pay = torch.full((g_cap,), -1, dtype=I64, device=dev)
        self.sl = mk.mat_slice_width(g_cap, chunk)
        self.madded = torch.zeros((self.sl, eng.mx.A), dtype=torch.int32, device=dev)
        self.movf = torch.zeros((self.sl,), dtype=torch.bool, device=dev)
        if dev.type == "cuda":
            self.tile_chunk = torch.zeros((kernels.compact_tiles(chunk * K),), dtype=I64,
                                          device=dev)
            self.tile_lanes = torch.zeros((kernels.compact_tiles(N),), dtype=I64, device=dev)
        else:
            self.tile_chunk = self.tile_lanes = None


def bucket_level_core(eng, B: BucketBuffers, V: BucketVecs, fr_in, crow_in, fr_out,
                      g_cap: int, slab, lc, bs, budget: int, ring=None) -> None:
    """Issue one bucket level (bucket.py:176-266): from the parents
    ``fr_in`` (``bs[BS_LRUN]`` rows; configs ``crow_in``; live unless their
    config is in ``V.done1``) to the survivors' children ``fr_out[:g_cap]``,
    inserting into ``slab``; with a ``ring``, the inserted fingerprints go
    to it at ``bs[BS_OFF]``."""
    chunk, K = eng.chunk, eng.K
    n_run = bs[BS_LRUN]
    mk.op_level_begin(lc, B.mult_k, n_run)
    for i in range(B.n_chunks):
        start = i * chunk
        part = mk.rows_of(fr_in, start, start + chunk)
        mk.op_inflate(eng, part.msg_ids, B.msgs, n_run, start)
        st = RaftState(msgs=B.msgs, **core_of(part))
        op_dense_expand(eng, st, B, n_run, start)
        op_refine(B.valid, B.mult, B.abort, B.fpv, crow_in[start:start + chunk],
                  part.restart_count, V.fam_rs, V.mr, V.salt, V.done1, V.gen, V.abort,
                  cnt=n_run, sub=start)
        op_chunk_compact(B, i, start * K, n_run, start, K)
    # LC_ABORT stays BIG (the aborts are per config): the gate closes on a
    # cap_x overflow only, and an aborting config's lanes are inserted
    mk.op_level_gate(lc, B.chunk_total, B.cap_x, chunk)
    mk.op_k4(slab, B.cv, B.cf, B.cp, lc, B.k4, budget)
    mk.op_compact_fresh(B.k4.fresh, B.cv, B.cp, B.ins_fps, B.ins_pay, lc[mk.LC_N_NEW],
                        lc[mk.LC_LIVE_LANES], B.tile_lanes)
    op_tally(B.k4.fresh, B.cp, lc[mk.LC_LIVE_LANES], crow_in, K, V.done1, V.abort, V.new,
             B.keep, B.ins_fps, lc[mk.LC_N_NEW], ring, bs[BS_OFF] if ring is not None else None)
    op_compact_keep(B.keep, B.cp, B.surv_pay, bs[BS_NG], lc[mk.LC_LIVE_LANES], B.tile_lanes)
    for a in range(0, g_cap, B.sl):
        rows = mk.rows_of(fr_out, a, a + B.sl)
        mk.op_materialize(eng, fr_in, B.surv_pay[a:a + B.sl], 0, (rows, B.madded, B.movf),
                          bs[BS_NG], a, lc[mk.LC_OVF_M])
        mk.op_inv_scan(eng, rows, a, lc[mk.LC_BAD], bs[BS_NG], a)


class _BucketProgram(mk.GraphProgram):
    def _common(self, bc, g_cap: int, span: int):
        eng = bc.eng
        dev = eng.device
        self.eng, self.V, self.K = eng, bc.vec, eng.K
        self.g_cap, self.budget = g_cap, eng.k4_rounds
        self.slab = bc.slab
        self.lc = torch.zeros((mk.LC_LEN,), dtype=I64, device=dev)
        self.bs = torch.zeros((BS_LEN,), dtype=I64, device=dev)
        self.args = torch.zeros((3,), dtype=I64, device=dev)
        self.host_args = torch.zeros((3,), dtype=I64, pin_memory=dev.type == "cuda")
        C = bc.C_pad
        self.meta = (torch.zeros((span, C), dtype=I64, device=dev),
                     torch.zeros((span, C), dtype=I64, device=dev),
                     torch.zeros((span, C), dtype=I64, device=dev),
                     torch.zeros((span,), dtype=I64, device=dev),
                     torch.zeros((span,), dtype=I64, device=dev))

    def _ctrl(self, phase, crow_in, crow_out, pay):
        V = self.V
        op_ctrl(phase, self.bs, self.lc, self.args, V.done, V.done1, V.depth, V.cap, V.gen,
                V.new, V.abort, self.meta, self.g_cap, crow_in, crow_out, pay, self.K)

    def _go(self, n_run: int, span: int, ring: int) -> None:
        self.host_args[0], self.host_args[1], self.host_args[2] = n_run, span, ring
        self.args.copy_(self.host_args, non_blocking=True)
        self.launch()


class BucketLevelProgram(_BucketProgram):
    """One fused bucket level at static (cap_in, g_cap): one graph launch
    and one read (bucket.py:236 ``_fused_level``)."""

    kind = "bucket_level"

    def __init__(self, bc, key, cap_in: int, g_cap: int):
        super().__init__(bc.eng, key)
        self._common(bc, g_cap, 1)
        eng = bc.eng
        self.fr_in = mk.empty_frontier(eng.cfg, cap_in, eng.cap_m, eng.device)
        self.crow_in = torch.zeros((cap_in,), dtype=I64, device=eng.device)
        self.fr_out = mk.empty_frontier(eng.cfg, g_cap, eng.cap_m, eng.device)
        self.crow_out = torch.zeros((g_cap,), dtype=I64, device=eng.device)
        self.B = BucketBuffers(eng, cap_in, g_cap, self.slab)

    def record(self) -> None:
        B, lc, bs = self.B, self.lc, self.bs
        self._ctrl(BC_BEGIN, self.crow_in, self.crow_out, B.surv_pay)
        self._ctrl(BC_PRE, self.crow_in, self.crow_out, B.surv_pay)
        bucket_level_core(self.eng, B, self.V, self.fr_in, self.crow_in, self.fr_out, self.g_cap,
                          self.slab, lc, bs, self.budget)
        self._ctrl(BC_LEVEL, self.crow_in, self.crow_out, B.surv_pay)
        mk.op_undo(self.slab, B.k4, lc[mk.LC_LIVE_LANES], bs[BS_UNDO])
        mk.op_slab_live(self.slab, bs[BS_SLAB_LIVE])

    def run(self, n_run: int) -> None:
        self._go(n_run, 1, 1 << 62)


class BucketSuperstepProgram(_BucketProgram):
    """Up to ``span`` bucket levels as one graph (bucket.py:270
    ``_superstep``): the frontier and its config column ping-pong between
    two buffers of ``g_cap`` rows; the committed ones settle into the
    first."""

    kind = "bucket_superstep"

    def __init__(self, bc, key, g_cap: int, span: int, ring_max: int):
        super().__init__(bc.eng, key)
        self._common(bc, g_cap, span)
        eng = bc.eng
        self.span, self.ring_max = span, ring_max
        self.fr = [mk.empty_frontier(eng.cfg, g_cap, eng.cap_m, eng.device) for _ in range(2)]
        self.crow = [torch.zeros((g_cap,), dtype=I64, device=eng.device) for _ in range(2)]
        self.B = BucketBuffers(eng, g_cap, g_cap, self.slab)
        self.ring = torch.full((ring_max,), SENT, dtype=I64, device=eng.device)

    def record(self) -> None:
        B, lc, bs = self.B, self.lc, self.bs
        self._ctrl(BC_BEGIN, self.crow[0], self.crow[1], B.surv_pay)
        for j in range(self.span):
            fa, fb = self.fr[j % 2], self.fr[(j + 1) % 2]
            ca, cb = self.crow[j % 2], self.crow[(j + 1) % 2]
            self._ctrl(BC_PRE, ca, cb, B.surv_pay)
            bucket_level_core(self.eng, B, self.V, fa, ca, fb, self.g_cap, self.slab, lc, bs,
                              self.budget, ring=self.ring)
            self._ctrl(BC_POST, ca, cb, B.surv_pay)
            mk.op_undo(self.slab, B.k4, lc[mk.LC_LIVE_LANES], bs[BS_UNDO])
        ss.op_ss_settle(bs, (*self.fr[1], self.crow[1]), (*self.fr[0], self.crow[0]))
        mk.op_slab_live(self.slab, bs[BS_SLAB_LIVE])

    def run(self, n_run: int, span: int, ring: int) -> None:
        if not 1 <= ring <= self.ring_max:
            raise ValueError(f"ring {ring} outside this program's 1..{self.ring_max}")
        self._go(n_run, span, ring)


# -- the run ---------------------------------------------------------------------


class BatchedChecker:
    """One bucket run: N same-key configs checked as one device stream.

    Parameters (the reference's, bucket.py:404): ``cfgs`` (every
    ``bucket_key`` equal), ``max_depths`` (per-config depth caps, None =
    fixpoint), ``use_mxu`` (K2, or the legacy materialize), ``megakernel``
    (the reference's lever; the port always runs the fused level),
    ``superstep`` (levels per superstep; 1 = per-level fused programs),
    ``progress`` (callable(stats) per level), plus ``device`` (None: the
    card) and ``chunk`` (parents per dense-expand launch).

    ``run(checkpoint_dir=...)`` commits a ``bstate`` snapshot after every
    level (every 8th past 2M ledger entries) and resumes from the newest
    healable one of the same job set.  Returns one summary dict per config
    in the ``check.py --json`` schema.
    """

    def __init__(self, cfgs: list[RaftConfig], max_depths=None, use_mxu: bool | None = None,
                 megakernel: bool | None = None, superstep: int | None = None, progress=None,
                 device=None, chunk: int | None = None):
        if not cfgs:
            raise ValueError("empty bucket")
        self.cfgs = list(cfgs)
        self.C = len(self.cfgs)
        key = bucket_key(self.cfgs[0])
        for c in self.cfgs[1:]:
            if bucket_key(c) != key:
                raise ValueError(f"bucket mixes shape keys: {bucket_key(c)} != {key}")
        self.kcfg = dataclasses.replace(key, max_restart=max(c.max_restart for c in self.cfgs))
        if megakernel is None:
            megakernel = mk.enabled_by_env()
        self.megakernel = bool(megakernel)
        if superstep is None:
            superstep = ss.span_from_env()
        self.superstep_span = max(1, int(superstep)) if self.megakernel else 1
        # the bucket's engine: the dense expand with fingerprints (built at the
        # largest MaxRestart), K2 / legacy_materialize, inv_scan, K4's budget
        self.eng = TorchChecker(self.kcfg, device=device, chunk=chunk, use_mxu=use_mxu,
                                canon="expand", megakernel=True, superstep=1, orbit=False)
        self.eng.graph_stats.update(bucket_level_launches=0, bucket_superstep_launches=0)
        self.device = self.eng.device
        self.use_mxu = self.eng.use_mxu
        self.K = self.eng.K
        self.C_pad = max(2, forecast.pow2ceil(self.C))
        self.max_depths = list(max_depths or [None] * self.C)
        if len(self.max_depths) != self.C:
            raise ValueError("max_depths length mismatch")
        self.progress = progress
        self.salts = config_salts(self.C_pad)
        mr = [c.max_restart for c in self.cfgs]
        self._mr = np.asarray(mr + [0] * (self.C_pad - self.C), np.int32)
        # the job set is the bucket checkpoint's identity (bucket.py:491)
        self._run_fp = resilience.run_config_fingerprint(
            self.kcfg, engine="service.bucket/1",
            jobs=tuple((int(m), -1 if d is None else int(d)) for m, d in zip(mr, self.max_depths)),
            mxu=self.use_mxu)
        fam_rs = self.eng.layout.slot_family == RESTART_FAMILY
        self.vec = BucketVecs(self.C_pad, self._mr, self.salts, fam_rs, self.device)
        self.slab: torch.Tensor | None = None
        self._progs: dict = {}
        self.stats = dict(levels=0, dispatches=0, programs=0, redos=0, supersteps=0,
                          superstep_levels=0, slab_presizes=0)

    # -- the slab (bucket.py:510-530) ----------------------------------------------

    def _fresh_slab(self, entries: int) -> int:
        return max(hashstore.MIN_CAP, forecast.pow2ceil(hashstore.slab_rows(max(entries, 1),
                                                                             0.25)))

    def _slab_from_fps(self, fps: np.ndarray, cap: int) -> None:
        """The slab rebuilt on the host (``insert_np``, the device layout) at
        the reference's ``_rebuild_slab`` sizing."""
        while cap < 4 * max(len(fps), 1):
            cap *= 2
        arr = hashstore.insert_np(np.full((cap,), hashstore.SENT_U64, np.uint64), fps)
        self._set_slab(torch.from_numpy(arr.view(np.int64)).to(self.device))

    def _grow_slab(self, cap: int, n_led: int) -> None:
        """A bigger slab with the same content (``_rebuild_slab``'s sizing):
        the old slab's slots rehashed through K4 into an empty one."""
        while cap < 4 * max(n_led, 1):
            cap *= 2
        old = self.slab
        self._set_slab(None)
        pays = torch.arange(old.shape[0], dtype=I64, device=self.device)
        slab2, _fresh, _n, ovf = hashstore.probe_and_insert(
            hashstore.make_slab(cap, self.device), old, old, pays)
        if bool(ovf):
            raise RuntimeError(f"bucket slab rehash overflowed at {cap} slots")
        self._set_slab(slab2)

    def _set_slab(self, slab) -> None:
        # every captured program holds the slab's address: a new slab drops them
        for p in self._progs.values():
            p.release()
        self._progs.clear()
        self.slab = slab

    def _program(self, key, build):
        """The program of ``key`` at the current budgets (cap_x, cap_m, K4
        rounds); programs of the same kind at other shapes are released
        (capacities only ratchet up)."""
        eng = self.eng
        key = key + (eng.cap_x, eng.cap_m, eng.k4_rounds)
        prog = self._progs.get(key)
        if prog is None:
            for k in [k for k in self._progs if k[0] == key[0]]:
                self._progs.pop(k).release()
            prog = build(key)
            self._progs[key] = prog
            self.stats["programs"] += 1
        return prog

    # -- the frontier's seat -----------------------------------------------------------

    def _seat(self, fr_dst, crow_dst, n: int) -> None:
        fr, crow = self.cur_fr, self.cur_crow
        if fr_dst.voted_for.data_ptr() != fr.voted_for.data_ptr() and n:
            mk.copy_rows(fr_dst, fr, n)
            crow_dst[:n].copy_(crow[:n])

    # -- checkpointing (bucket.py:532-640) -------------------------------------------

    def _save_bstate(self, ckdir, lvl, n_run, all_fps, gen, depth, level_sizes, done,
                     results) -> None:
        B = max(n_run, 1)
        fr = mk.rows_of(self.cur_fr, 0, B)
        msgs = ids_to_msgs(fr.msg_ids, self.eng.uni.n_words)
        dense = dict(core_of(fr), msgs=msgs)
        got = fetch(*(dense[f] for f in _STATE_FIELDS), self.cur_crow[:B], what="bstate")
        arrays = {f"st_{f}": (a.view(np.uint32) if f == "msgs" else a)
                  for f, a in zip(_STATE_FIELDS, got[:-1])}
        crow = got[-1].astype(np.int64)
        live = (np.arange(B) < n_run) & ~np.asarray(done, bool)[np.clip(crow, 0, self.C - 1)]
        maxlv = max(len(ls) for ls in level_sizes)
        ls_pad = np.full((self.C, maxlv), -1, np.int64)
        for i, ls in enumerate(level_sizes):
            ls_pad[i, : len(ls)] = ls
        arrays.update(
            lvl=np.int64(lvl), live=live, crow=crow,
            all_fps=np.concatenate(all_fps) if all_fps else np.zeros((0,), np.uint64),
            gen=gen, depth=depth, level_sizes=ls_pad, done=done,
            results=np.frombuffer(json.dumps(results).encode(), np.uint8),
            run_fp=np.frombuffer(self._run_fp.encode(), np.uint8),
        )
        resilience.commit_npz(ckdir, BSTATE_FMT.format(int(lvl)), arrays, kind="bstate",
                              depth=int(lvl), run_fp=self._run_fp)
        # keep the latest two records (the older is the fallback if the newest
        # turns out torn on the next resume)
        old = sorted(glob.glob(os.path.join(ckdir, BSTATE_GLOB)))[:-2]
        if old:
            m = resilience.Manifest.load(ckdir)
            for p in old:
                try:
                    os.unlink(p)
                except OSError:
                    pass
                m.forget(os.path.basename(p))
            m.commit()

    @staticmethod
    def _read_bstate(path):
        import zipfile

        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    def _load_bstate(self, ckdir):
        """Newest healable bucket snapshot, or None (bucket.py:575): a
        digest-verified record of this job set is used; an unmanifested one
        (the rename-beat-manifest window) is adopted; anything torn, corrupt
        or of another job set is quarantined and the walk falls back to the
        next older record."""
        resilience.sweep_tmp(ckdir)
        names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ckdir, BSTATE_GLOB)))
        m = resilience.Manifest.load(ckdir)
        dirty = False
        out = None
        for name in reversed(names):
            status = m.verify(name)
            data = self._read_bstate(os.path.join(ckdir, name))
            fp = (bytes(data["run_fp"]).decode()
                  if data is not None and "run_fp" in data else None)
            if fp != self._run_fp:
                resilience.quarantine(ckdir, name, "bstate unreadable" if data is None
                                      else "bstate from another job set", m)
                dirty = True
                continue
            if status == "ok":
                out = data
                break
            if status == "unmanifested":
                if dirty:
                    m.commit()
                    dirty = False
                resilience.adopt_file(ckdir, name, kind="bstate", depth=int(data["lvl"]),
                                      run_fp=self._run_fp)
                out = data
                break
            resilience.quarantine(ckdir, name, f"bstate {status}", m)
            dirty = True
        if dirty:
            m.commit()
        return out

    def _frontier_from_bstate(self, ck) -> tuple:
        """(frontier, crow, n_run) of a snapshot's dense rows: deflated to
        the port's sparse ids (cap_m grows to the widest row)."""
        dev = self.device
        arrs = {f: np.ascontiguousarray(ck[f"st_{f}"]) for f in _STATE_FIELDS}
        arrs["msgs"] = arrs["msgs"].view(np.int32)
        st = RaftState(**{f: torch.from_numpy(a).to(dev) for f, a in arrs.items()})
        eng = self.eng
        while True:
            ids, ovf = msgs_to_ids(st.msgs, eng.uni.M, eng.cap_m, eng.id_dtype)
            if not bool(ovf.any()):
                break
            eng.cap_m = min(eng.cap_m + 32, eng.uni.M)
        fr = Frontier(msg_ids=ids, **core_of(st))
        live = np.asarray(ck["live"], bool)
        n_run = int(np.nonzero(live)[0][-1]) + 1 if live.any() else 0
        crow = torch.from_numpy(np.asarray(ck["crow"], np.int64)).to(dev)
        return fr, crow, n_run

    # -- the run -----------------------------------------------------------------------

    def run(self, checkpoint_dir: str | None = None) -> list[dict]:
        t0 = time.monotonic()
        C, C_pad, K = self.C, self.C_pad, self.K
        eng, dev = self.eng, self.device
        if checkpoint_dir:
            resilience.sweep_tmp(checkpoint_dir)
        results: list = [None] * C
        done = np.zeros(C, bool)
        gen = np.zeros(C, np.int64)
        depth = np.zeros(C, np.int64)
        level_sizes = [[1] for _ in range(C)]

        def finish(c, ok, kind=None):
            done[c] = True
            results[c] = dict(
                ok=bool(ok), distinct=int(sum(level_sizes[c])), generated=int(gen[c]),
                depth=int(depth[c]), level_sizes=[int(x) for x in level_sizes[c]],
                mxu=self.use_mxu, superstep=self.superstep_span,
                seconds=round(time.monotonic() - t0, 3), violation=kind, batched=True,
                bucket_configs=C,
            )

        ck = self._load_bstate(checkpoint_dir) if checkpoint_dir else None
        if ck is not None:
            lvl = int(ck["lvl"])
            gen = np.asarray(ck["gen"], np.int64).copy()
            depth = np.asarray(ck["depth"], np.int64).copy()
            done = np.asarray(ck["done"], bool).copy()
            level_sizes = [[int(x) for x in row[row >= 0]] for row in np.asarray(ck["level_sizes"])]
            for i, r in enumerate(json.loads(bytes(ck["results"]).decode())):
                if r is not None:
                    results[i] = r
            all_fps = [np.asarray(ck["all_fps"], np.uint64)]
            self.cur_fr, self.cur_crow, n_run = self._frontier_from_bstate(ck)
            self._slab_from_fps(all_fps[0], hashstore.MIN_CAP)
        else:
            lvl = 0
            fr1, _ovf = eng.deflate(init_batch(self.kcfg, 1, dev))
            fv0, _ff = eng.fpr.state_fingerprints(fr1)
            fp0 = np.uint64(fv0.cpu().numpy().view(np.uint64)[0])
            salted0 = (fp0 ^ self.salts[:C]).astype(np.uint64)
            all_fps = [salted0]
            self._slab_from_fps(salted0, self._fresh_slab(64 * C))
            if int(eng.inv_scan(fr1)) >= 0:
                name = eng.bad_invariant_name(fr1, 0)
                for c in range(C):
                    finish(c, False, f"Invariant {name} is violated")
                return [r for r in results if r is not None]
            B0 = max(8, forecast.pow2ceil(C))
            self.cur_fr, _ovf = eng.deflate(init_batch(self.kcfg, B0, dev))
            self.cur_crow = torch.from_numpy(
                np.minimum(np.arange(B0), C - 1).astype(np.int64)).to(dev)
            n_run = C
        level_totals = [int(sum(ls[i] for ls in level_sizes if len(ls) > i))
                        for i in range(max(len(ls) for ls in level_sizes))]
        g_floor = 8
        last_n_g = 8
        cap_pad = np.asarray([-1 if d is None else int(d) for d in self.max_depths]
                             + [-1] * (C_pad - C), np.int64)
        no_cap = np.full(C_pad, -1, np.int64)
        skip_ss = False

        def n_led():
            return sum(len(a) for a in all_fps)

        def pads(done_h, depth_h):
            return (np.concatenate([done_h, np.ones(C_pad - C, bool)]),
                    np.concatenate([depth_h, np.zeros(C_pad - C, np.int64)]))

        def g_cap_for(n_g_prev, extra=0):
            g = max(g_floor, forecast.pow2ceil(n_g_prev), extra, eng.chunk)
            if len(level_totals) > forecast.MIN_LEVELS:
                peak = forecast.forecast_peak_new(level_totals, None)
                peak = min(max(peak, 1), 4 * max(n_g_prev, 8), 1 << 20)
                g = max(g, forecast.pow2ceil(peak))
            return forecast.pow2ceil(g)

        def note_level():
            if self.progress is not None:
                self.progress(dict(level=lvl, frontier=last_n_g,
                                   configs_alive=int((~done).sum()),
                                   distinct=int(sum(sum(ls) for ls in level_sizes)),
                                   generated=int(gen.sum()), elapsed=time.monotonic() - t0))

        def maybe_save(lvl_before):
            if checkpoint_dir and lvl > lvl_before:
                every = 1 if 8 * n_led() <= (1 << 24) else 8
                if (lvl // every) > (lvl_before // every):
                    self._save_bstate(checkpoint_dir, lvl, n_run, all_fps, gen, depth,
                                      level_sizes, done, results)

        while True:
            resilience.fault_fire("bucket.level")
            for c in range(C):
                if (not done[c] and self.max_depths[c] is not None
                        and depth[c] >= self.max_depths[c]):
                    finish(c, True)
            crow_h = None
            if done.all() or n_run == 0:
                for c in range(C):
                    if not done[c]:
                        finish(c, True)
                break
            g_cap = g_cap_for(last_n_g, forecast.pow2ceil(n_run))
            if (self.superstep_span > 1 and not skip_ss
                    and g_cap <= SS_MAX_CHUNKS * eng.chunk):
                span = self.superstep_span
                ring = forecast.pow2ceil(2 * span * g_cap)
                need = hashstore.slab_rows(n_led() + span * g_cap, 0.25)
                if need > self.slab.shape[0]:
                    self.stats["slab_presizes"] += 1
                    self._grow_slab(need, n_led())
                prog = self._program(("bucket_superstep", g_cap, span, ring), lambda key: (
                    BucketSuperstepProgram(self, key, g_cap, span, ring)))
                self._seat(prog.fr[0], prog.crow[0], n_run)
                dpad, deppad = pads(done, depth)
                self.vec.upload(dpad, deppad, cap_pad)
                prog.run(n_run, span, ring)
                bsw, m_new, m_gen, m_abort, m_ins, m_ng, rf = fetch(
                    prog.bs, *prog.meta, prog.ring, what="bucket_superstep")
                self.stats["dispatches"] += 1
                levels_done = int(bsw[BS_LEVELS])
                reason = ss.REASON_NAMES.get(int(bsw[BS_REASON]), "stop")
                self.stats["supersteps"] += 1
                self.stats["superstep_levels"] += levels_done
                self.stats["levels"] += levels_done
                lvl_before = lvl
                off = 0
                for i in range(levels_done):
                    for c in range(C):
                        if (not done[c] and self.max_depths[c] is not None
                                and depth[c] >= self.max_depths[c]):
                            finish(c, True)
                    active = ~done
                    for c in range(C):
                        if active[c] and m_abort[i][c]:
                            finish(c, False, SPLIT_BRAIN)
                    for c in range(C):
                        if not done[c]:
                            gen[c] += int(m_gen[i][c])
                    n_ins = int(m_ins[i])
                    if n_ins:
                        all_fps.append(rf[off:off + n_ins].view(np.uint64).copy())
                    off += n_ins
                    for c in range(C):
                        if done[c]:
                            continue
                        if int(m_new[i][c]) == 0:
                            finish(c, True)
                        else:
                            level_sizes[c].append(int(m_new[i][c]))
                            depth[c] += 1
                    level_totals.append(int(sum(int(x) for x in m_new[i][:C])))
                    last_n_g = int(m_ng[i])
                    lvl += 1
                    note_level()
                g_floor = max(g_floor, g_cap)
                n_run = int(bsw[BS_NRUN])
                self.cur_fr, self.cur_crow = prog.fr[0], prog.crow[0]
                self._check_slab(int(bsw[BS_SLAB_LIVE]), n_led())
                if reason == "stop" or (reason == "ring" and levels_done == 0):
                    skip_ss = True
                maybe_save(lvl_before)
                continue
            skip_ss = False
            # ---- the fused bucket level: one graph launch and one read
            g_cap = g_cap_for(last_n_g)
            dpad, deppad = pads(done, depth)
            while True:
                cap_in = max(forecast.pow2ceil(max(n_run, 1)), eng.chunk)
                prog = self._program(("bucket_level", cap_in, g_cap), lambda key: (
                    BucketLevelProgram(self, key, cap_in, g_cap)))
                self._seat(prog.fr_in, prog.crow_in, n_run)
                # the parents now live in the program's input buffers, which
                # the level does not write: a redo seats from there (its
                # output buffers may be where they came from)
                self.cur_fr, self.cur_crow = prog.fr_in, prog.crow_in
                self.vec.upload(dpad, deppad, no_cap)
                prog.run(n_run)
                bsw, lcw, gen_c, new_c, abort_c = fetch(
                    prog.bs, prog.lc, self.vec.gen, self.vec.new, self.vec.abort,
                    what="bucket_level")
                self.stats["dispatches"] += 1
                n_g = int(bsw[BS_NG])
                if lcw[mk.LC_OVF_ROUNDS]:
                    eng.k4_rounds *= 2
                elif lcw[mk.LC_OVF_SLAB]:
                    self._grow_slab(2 * self.slab.shape[0], n_led())
                elif lcw[mk.LC_OVF_X]:
                    eng._grow_cap_x()
                elif n_g > g_cap:
                    g_cap = max(2 * g_cap, forecast.pow2ceil(n_g))
                elif lcw[mk.LC_OVF_M] and n_g:
                    self._widen_cap_m(n_run)
                else:
                    break
                self.stats["redos"] += 1
            g_floor = g_cap
            self.stats["levels"] += 1
            # abort (the in-kernel Assert) retires before the level counts
            for c in range(C):
                if not done[c] and abort_c[c]:
                    finish(c, False, SPLIT_BRAIN)
            for c in range(C):
                if not done[c]:
                    gen[c] += int(gen_c[c])
            n_ins = int(lcw[mk.LC_N_NEW])
            if n_ins:
                (ins,) = fetch(prog.B.ins_fps[:n_ins], what="bucket_ins")
                all_fps.append(ins.view(np.uint64).copy())
            for c in range(C):
                if done[c]:
                    continue
                if int(new_c[c]) == 0:
                    finish(c, True)  # fixpoint: gen counted, depth kept
                else:
                    level_sizes[c].append(int(new_c[c]))
                    depth[c] += 1
            self._check_slab(int(bsw[BS_SLAB_LIVE]), n_led())
            if n_g == 0:
                for c in range(C):
                    if not done[c]:
                        finish(c, True)
                break
            level_totals.append(int(sum(int(x) for x in new_c[:C])))
            last_n_g = n_g
            lvl_before = lvl
            lvl += 1
            note_level()
            self.cur_fr, self.cur_crow, n_run = prog.fr_out, prog.crow_out, n_g
            if int(lcw[mk.LC_BAD]) >= 0:
                self._retire_bad(n_g, done, finish)
            maybe_save(lvl_before)
        self.n_run = n_run  # the last frontier's rows (cur_fr, cur_crow)
        out = [r for r in results if r is not None]
        assert len(out) == C
        return out

    def _check_slab(self, live: int, n_led: int) -> None:
        """Conservation: the slab holds exactly the inserted ledger."""
        resilience.integrity.occupancy_check("bucket hash slab", live, n_led)

    def _widen_cap_m(self, n_run: int) -> None:
        eng = self.eng
        if eng.cap_m >= eng.uni.M:
            raise RuntimeError("message-set width exceeds the whole universe")
        eng.cap_m = min(eng.cap_m + 32, eng.uni.M)
        self.cur_fr = eng.widen(mk.rows_of(self.cur_fr, 0, max(n_run, 1)))
        self.cur_crow = self.cur_crow[:max(n_run, 1)].clone()

    def _retire_bad(self, n_g: int, done, finish) -> None:
        """Invariant violations of the level just counted (bucket.py:1139):
        the first violating row of each live config, in row order, names
        the invariant it fails.  A config's rows are contiguous (children
        keep their parents' order), so one scan per config finds it."""
        eng = self.eng
        (crow,) = fetch(self.cur_crow[:n_g], what="bucket_bad")
        for c in np.unique(crow):
            c = int(c)
            if done[c]:
                continue
            rows = np.nonzero(crow == c)[0]
            a, b = int(rows[0]), int(rows[-1]) + 1
            part = mk.rows_of(self.cur_fr, a, b)
            bad = int(eng.inv_scan(part))
            if bad >= 0:
                name = eng.bad_invariant_name(part, bad)
                finish(c, False, f"Invariant {name} is violated")
