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

The reference's cross-check paths run on every route: ``canon="expand"``
replaces a chunk's guards, compaction, materialize and K3 by the dense
expand with per-lane delta-hash fingerprints and the chunk compaction
(bfs.py:977-1001; the same slab bytes); ``use_mxu=False`` replaces K1 and
K2 by the legacy per-lane kernels; ``audit=N`` re-expands N sampled rows
of every level through those legacy kernels before it commits; a mismatch
rewinds to the delta log when the run checkpoints, and fail-stops after
``audit_retries`` strikes or at once without checkpoints (bfs.py:1864-2082).

With a checkpoint directory (``run(checkpoint_dir=...)``, the CLI's
``--checkpoint-dir``) every committed level appends its delta record
(``delta_NNNN.npz``: the survivors' pidx / slot, their fingerprints, the
level's per-slot mult and ``meta = [depth, n_new, fp_def]``) through the
atomic manifest writer, on every route (a superstep writes one record per
level from its ring), and the hash slab is snapshotted beside it
(``hslab.npz``) at the size-aware cadence; ``run(resume_from=...)`` heals
the directory and replays the records from Init through the port's own
materialize kernels, then loads the snapshot when it matches the resume
point or rebuilds the store from the replayed fingerprints
(bfs.py:2100, 2910).  The bytes are the reference's, so logs and slab
snapshots move between the two packages.  A preemption request
(SIGTERM/SIGINT under the CLI) stops the run at a level boundary with
``resilience.Preempted``.

On the sorted visited store (``use_hashstore=False``, the reference's
``--no-hashstore``, bfs.py:3481-3690 and 4912-4925) the fused level, the
supersteps and the tiers are off: every level runs the staged chain, or
past the size limit the same chain eagerly with each group of G chunks
filtered against the store (``group_filter``, B19 ``_group_filter``), one
``level_dedup`` (B19 ``_level_dedup``: the lanes sorted by (fp_view,
fp_full, payload), the first of each fp_view not in the store kept) and
one ``merge_sorted`` (B19 ``_merge_sorted``) a level; the survivors, the
next frontier and the traces come fp_view-ascending, as in the
reference.  A hash-store run whose slab fails to grow turns onto it
mid-run (``_degrade_hashstore``, bfs.py:3369) with the same counts.

The order-keeping compactions, inflate/deflate of the message sets and
the invariant scan are kernels too (csrc/compact.cu, msgset.cu,
invariants.cu); each function here that wraps one sends CPU tensors to
its plain twin and CUDA tensors to the kernel.
"""

from __future__ import annotations

import gc
import glob
import os
import sys
import time
import zipfile
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import RaftConfig
from ..device import READS, fetch, resolve_device
from ..models.raft import Frontier, RaftState, core_of, id_dtype, init_batch, to_oracle
from ..obs import telemetry as graft_obs
from ..ops import hashstore
from ..ops import sieve as sieve_ops
from ..ops.fingerprint import Fingerprinter
from ..ops.hashstore import DeviceHashStore, compact_fresh, probe_and_insert
from ..ops.msg_universe import get_universe
from ..ops.dense_expand import DenseExpand
from ..ops.mxu_expand import MXUExpand, mxu_enabled_by_env
from ..ops.successor import GuardTables, materialize_legacy_plain
from .. import resilience
from ..resilience import faults
from ..resilience.integrity import AuditFailStop, audit_indices, occupancy_check
from ..store import tiered
from ..u64 import SENT, ukey
from . import forecast
from . import group
from . import megakernel as mk
from . import pipeline as gpipe
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


def _setting(env: str, value, default: bool) -> bool:
    """An on/off setting: the argument, else ``env`` ("0" or "1"), else
    ``default``."""
    if value is not None:
        return bool(value)
    v = os.environ.get(env)
    return bool(int(v)) if v else bool(default)


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


def chunk_compact(fpv: torch.Tensor, fpf: torch.Tensor, cap_x: int, iota_base: int = 0):
    """The live fan-out lanes (``fpv`` not SENT) with their fingerprints and
    payloads (``iota_base + lane``) packed to ``cap_x`` lanes in lane order
    (bfs.py:313 ``_chunk_compact``): (cv, cf, cp, overflow 0-d bool).  The
    ``chunk_compact`` kernel on the card, the plain twin on the CPU."""
    if fpv.device.type == "cpu":
        cv, cf, cp, n_live = chunk_compact_plain(fpv, fpf, cap_x, iota_base)
        return cv, cf, cp, n_live > cap_x
    cv, cf, cp, total = kernels.chunk_compact(fpv, fpf, cap_x, iota_base=iota_base)
    return cv, cf, cp, total > cap_x


def chunk_compact_plain(fpv: torch.Tensor, fpf: torch.Tensor, cap_x: int, iota_base: int = 0):
    """Plain twin of ``chunk_compact``: (cv, cf, cp, n_live 0-d), padded
    SENT, SENT, -1."""
    live = fpv != SENT
    dest = torch.cumsum(live.to(I64), 0) - 1
    keep = live & (dest < cap_x)
    tgt = torch.where(keep, dest, torch.full_like(dest, cap_x))
    lanes = torch.arange(fpv.shape[0], dtype=I64, device=fpv.device) + iota_base
    outs = []
    for vals, pad in ((fpv, SENT), (fpf, SENT), (lanes, -1)):
        o = torch.full((cap_x + 1,), pad, dtype=I64, device=fpv.device)
        o.scatter_(0, tgt, vals)
        outs.append(o[:cap_x])
    return (*outs, live.sum())


# -- B19: the sorted visited store (--no-hashstore, and the grow-failure fallback) -----


def _cap4(n: int) -> int:
    """The next power of 4 at or above n (bfs.py:268): the sorted store's
    capacity steps."""
    c = 1
    while c < n:
        c <<= 2
    return c


def sort_u64_plain(x: torch.Tensor) -> torch.Tensor:
    """Ascending unsigned order of int64-held u64 values (SENT last)."""
    return ukey(torch.sort(ukey(x)).values)


def member_plain(visited: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``sorted_member``: hit bool[n], fps[i] in the sorted
    store (bfs.py:368-369: searchsorted, then the clipped compare)."""
    if visited.shape[0] == 0:
        return torch.zeros(fps.shape, dtype=torch.bool, device=fps.device)
    pos = torch.searchsorted(ukey(visited), ukey(fps)).clamp(0, visited.shape[0] - 1)
    return visited[pos] == fps


def group_filter(cv, cf, cp, visited, cap_g: int):
    """B19 ``_group_filter`` (bfs.py:358): the lanes whose fp_view the
    sorted store does not hold, compacted in lane order to ``cap_g`` lanes:
    (gv, gf, gp, overflow 0-d bool).  ``sorted_member`` (writing the keep
    flags) then the filter compaction on the card, the twins on the CPU."""
    if cv.device.type == "cpu":
        return group.filter_compact_plain(member_plain(visited, cv), cv, cf, cp, cap_g)
    keep = torch.empty(cv.shape, dtype=torch.bool, device=cv.device)
    kernels.sorted_member(visited, cv, keep=keep)
    gv, gf, gp, total = kernels.filter_compact(keep, cv, cf, cp, cap_g)
    return gv, gf, gp, total > cap_g


def level_dedup(cv, cf, cp, visited):
    """B19 ``_level_dedup`` (bfs.py:407): (n_new 0-d, new_fps, new_payload)
    -- the lanes sorted by (fp_view, fp_full, payload), the first lane of
    each fp_view kept unless it is SENT or in the sorted store ``visited``,
    the survivors packed in sorted order (fp_view ascending), padded SENT
    and -1.  The ``level_dedup`` kernel on the card, the twin on the CPU."""
    if cv.device.type == "cpu":
        return level_dedup_plain(cv, cf, cp, visited)
    return kernels.level_dedup(cv, cf, cp, visited)


def level_dedup_plain(cv, cf, cp, visited):
    """Plain twin of ``level_dedup``: three stable sorts (payload signed,
    then fp_full and fp_view unsigned), the first-of-run flags, the
    membership twin and a cumsum scatter."""
    n = cv.shape[0]
    order = torch.argsort(cp, stable=True)
    order = order[torch.argsort(ukey(cf[order]), stable=True)]
    order = order[torch.argsort(ukey(cv[order]), stable=True)]
    sv, sp = cv[order], cp[order]
    first = torch.ones(n, dtype=torch.bool, device=cv.device)
    first[1:] = sv[1:] != sv[:-1]
    new = first & (sv != SENT) & ~member_plain(visited, sv)
    dest = torch.cumsum(new.to(I64), 0) - 1
    tgt = torch.where(new, dest, torch.full_like(dest, n))
    outs = []
    for vals, pad in ((sv, SENT), (sp, -1)):
        o = torch.full((n + 1,), pad, dtype=I64, device=cv.device)
        o.scatter_(0, tgt, vals)
        outs.append(o[:n])
    return (new.sum(), *outs)


def merge_sorted(visited, new_fps, n_out: int):
    """B19 ``_merge_sorted`` (bfs.py:469) with the caller's trim
    (bfs.py:4921-4925): the first ``n_out`` values of the sorted union of
    the store and the level's new fingerprints.  Both are sorted, so the
    kernel merges (merge path) where the reference sorts the concatenation;
    the bytes are the same.  The ``merge_sorted`` kernel on the card, the
    twin on the CPU."""
    if visited.device.type == "cpu":
        return merge_sorted_plain(visited, new_fps, n_out)
    return kernels.merge_sorted(visited, new_fps, n_out)


def merge_sorted_plain(visited, new_fps, n_out: int):
    """Plain twin of ``merge_sorted``: the unsigned sort of the
    concatenation, trimmed."""
    return sort_u64_plain(torch.cat([visited, new_fps]))[:n_out]


def upload_sorted_store(fps: np.ndarray, device) -> torch.Tensor:
    """The sorted store on ``device`` from sorted unique u64 ``fps``,
    SENT-padded to a power-of-4 capacity past them (bfs.py:3394-3399)."""
    pad = np.full(_cap4(len(fps) + 1) - len(fps), hashstore.SENT_U64)
    return torch.from_numpy(np.concatenate([fps, pad]).view(np.int64)).to(device)


# -- B19 _group_unique and the external store's segment lists (--fpstore-dir) ----------


def group_unique(cv, cf, cp):
    """B19 ``_group_unique_impl`` (bfs.py:437): (n_u 0-d, gv, gf, gp) -- of
    every run of equal fp_view that is not SENT, the first lane in
    (fp_view, fp_full, payload) order, packed fp_view-ascending, padded
    SENT, SENT and -1.  No store is read: the external store route filters
    on the host.  The ``group_unique`` kernel on the card, the twin on the
    CPU."""
    if cv.device.type == "cpu":
        return group_unique_plain(cv, cf, cp)
    return kernels.group_unique(cv, cf, cp)


def group_unique_plain(cv, cf, cp):
    """Plain twin of ``group_unique``: three stable sorts (payload signed,
    then fp_full and fp_view unsigned), the first-of-run flags, a cumsum
    scatter."""
    n = cv.shape[0]
    order = torch.argsort(cp, stable=True)
    order = order[torch.argsort(ukey(cf[order]), stable=True)]
    order = order[torch.argsort(ukey(cv[order]), stable=True)]
    sv, sf, sp = cv[order], cf[order], cp[order]
    first = torch.ones(n, dtype=torch.bool, device=cv.device)
    first[1:] = sv[1:] != sv[:-1]
    keep = first & (sv != SENT)
    dest = torch.cumsum(keep.to(I64), 0) - 1
    tgt = torch.where(keep, dest, torch.full_like(dest, n))
    outs = []
    for vals, pad in ((sv, SENT), (sf, SENT), (sp, -1)):
        o = torch.full((n + 1,), pad, dtype=I64, device=cv.device)
        o.scatter_(0, tgt, vals)
        outs.append(o[:n])
    return (keep.sum(), *outs)


# Rows of one frontier segment on the external store route (bfs.py:204): a
# deep level's frontier is a list of segments of this many rows, so a
# chunk never straddles two (chunks are powers of two up to SEG_ROWS) and
# the materialize walk frees and pages whole segments.
SEG_ROWS = 1 << 21


class _HostSeg:
    """A frontier segment paged out to host RAM (bfs.py:134, without the
    reference's disk tier below it): one numpy array a field.  The expand
    and materialize walks consume segments in ascending row order, so the
    segments on the card are a moving window."""

    __slots__ = ("fields", "rows")

    def __init__(self, fields: dict):
        self.fields = fields
        self.rows = fields["voted_for"].shape[0]


def _seg_rows(seg) -> int:
    return seg.rows if isinstance(seg, _HostSeg) else seg.voted_for.shape[0]


def _pad_axis0(x: torch.Tensor, cap: int) -> torch.Tensor:
    """``x`` cut or zero-padded to ``cap`` rows (bfs.py:277)."""
    pad = cap - x.shape[0]
    if pad <= 0:
        return x[:cap]
    return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])


def _concat_fields(segs: list) -> Frontier:
    """One frontier from a segment list, field by field, emptying the list
    (bfs.py:207): each field's sources are dropped as soon as its
    concatenation lands, so the peak is about one frontier plus its widest
    field, not two frontiers."""
    if len(segs) == 1:
        return segs.pop()
    cols = {f: [getattr(s, f) for s in segs] for f in Frontier._fields}
    segs[:] = []
    out = {}
    for f in Frontier._fields:
        out[f] = torch.cat(cols[f])
        cols[f] = None
    return Frontier(**out)


def _host_cap(n: int, chunk: int) -> int:
    """Frontier capacity on the external store route (bfs.py:225): whole
    segments past one segment, else the half-step quantizer (pow2 when the
    half step is no chunk multiple), at least one chunk."""
    if n > SEG_ROWS:
        return -(-n // SEG_ROWS) * SEG_ROWS
    c = _cap_steps(n)
    if c % chunk:
        c = _pow2(n)
    return max(c, chunk)


def segment_settings_refusal(host_store: bool) -> str | None:
    """Why the port refuses the reference's segment settings, or None:
    ``TLA_RAFT_FSEG_BYTES`` (host segments spilled to disk, the
    ``FrontierPager`` tier) is not ported, and ``TLA_RAFT_DEV_BYTES``
    without an external store selects the segment-streamed fused level
    (bfs.py:1417), which is not ported either (ROADMAP A.5).  Ignoring
    either would run another route than the one asked for."""
    if float(os.environ.get("TLA_RAFT_FSEG_BYTES", "0") or 0):
        return ("TLA_RAFT_FSEG_BYTES (spilled frontier segments, the FrontierPager disk tier) "
                "is not ported (ROADMAP A.5); unset it")
    if not host_store and float(os.environ.get("TLA_RAFT_DEV_BYTES", "0") or 0):
        return ("TLA_RAFT_DEV_BYTES without an external store (--fpstore-dir) selects the "
                "segment-streamed fused level, which is not ported (ROADMAP A.5); set it "
                "only with --fpstore-dir")
    return None


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
      canon: "late" (guards, compaction, materialize, then K3 on the
        candidates) or "expand" (every fan-out lane fingerprinted by the
        dense expand's delta hash, then the chunk compaction; the
        reference's independent formulation, bfs.py:977-1001).  Refused
        under orbit, as in the reference.
      use_mxu: the matrix forms' kernels K1/K2 (``None``: ``TLA_RAFT_MXU``,
        on unless "0"); ``False`` takes the legacy per-lane kernels: the
        guards-only dense expand and ``legacy_materialize``.
      audit: rows per level re-expanded through the legacy kernels and
        cross-checked (``--audit N``; 0: off).  Turns supersteps off; a
        mismatch rewinds to the delta log of a checkpointing run, else
        raises ``AuditFailStop``.
      audit_retries: reproducible strikes at one level before the
        fail-stop (and 4x that many rewinds in all).
      use_hashstore: the hash slab as the visited store (``None``:
        ``TLA_RAFT_HASHSTORE``, on unless "0"); ``False`` selects the
        sorted store (the reference's ``--no-hashstore``): the fused level,
        the supersteps and the tiered budget off, every level staged or
        grouped, deduped by ``level_dedup`` and merged into the store by
        ``merge_sorted``.  A failed slab grow turns a hash-store run onto
        it mid-run (``_degrade_hashstore``).
      host_store: a ``native.HostFPStore`` (the reference's ``host_store``,
        ``--fpstore-dir``): the visited set lives in that external store on
        the host and every level runs ``_expand_level_host`` -- per group of
        G chunks the expand and ``group_unique`` on the card, one read, then
        the level-wide representative choice and the store's filter on the
        host; the frontier is a list of ``SEG_ROWS``-row segments, which
        page to host RAM under ``dev_budget`` (``TLA_RAFT_DEV_BYTES``).  No
        hash slab, fused level, superstep or grouped chain.
      pipeline, pipeline_window: the async pipeline (engine/pipeline.py;
        ``None``: ``TLA_RAFT_PIPELINE``, on unless "0", and
        ``TLA_RAFT_PIPELINE_WINDOW``, default 2; a window below 1 is the
        serial chain): the external store route's group reads go through
        an ``AsyncFetchWindow``, the fused level's and the superstep's
        reads through a ``DeferredFetch``.  Counts, traces and checkpoint
        bytes are the same either way.
      prewarm, presize: the forecast prewarm (the programs of the
        forecast's shapes built and captured on a thread of their own,
        ahead of the levels that need them) and the presize (the slab
        reserved to the forecast's entries, the sorted store's width and
        merge input floored): ``None`` reads ``TLA_RAFT_PREWARM`` /
        ``TLA_RAFT_PRESIZE`` ("0" or "1"), else on where the engine's
        device is CUDA (a program's first build there is a graph capture)
        and off on the CPU.  Neither changes what is counted.

    The reference's settings are read where it reads them, an explicit
    argument winning: ``TLA_RAFT_MEGAKERNEL=0`` (the staged chain),
    ``TLA_RAFT_SUPERSTEP`` (the span; <= 1: per-level fused levels; the
    port has no tuner, so without it the span is ``ss.DEFAULT_SPAN``),
    ``TLA_RAFT_CAP_M`` (replaces only the default cap_m of 96),
    ``TLA_RAFT_MXU``, ``TLA_RAFT_ORBIT`` and ``TLA_RAFT_HASHSTORE``.
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
        canon: str = "late",
        use_mxu: bool | None = None,
        audit: int = 0,
        audit_retries: int = 3,
        use_hashstore: bool | None = None,
        host_store=None,
        pipeline: bool | None = None,
        pipeline_window: int | None = None,
        prewarm: bool | None = None,
        presize: bool | None = None,
    ):
        self.cfg = cfg
        if orbit is None:
            env = os.environ.get("TLA_RAFT_ORBIT")
            orbit = bool(int(env)) if env else False
        self.orbit = bool(orbit)
        if canon not in ("late", "expand"):
            raise ValueError(f"canon must be 'late' or 'expand', got {canon!r}")
        if self.orbit and canon != "late":
            raise ValueError("TLA_RAFT_ORBIT requires canon='late'")
        self.canon = canon
        self.use_mxu = mxu_enabled_by_env() if use_mxu is None else bool(use_mxu)
        env_capm = os.environ.get("TLA_RAFT_CAP_M")
        if env_capm is not None and cap_m == 96:
            cap_m = int(env_capm)  # the setting replaces only the default (bfs.py:536-546)
        self.audit = max(0, int(audit))
        self.audit_retries = max(1, int(audit_retries))
        self.audit_stats = dict(levels=0, sampled=0, mismatches=0, rewinds=0)
        self._audit_strikes = 0
        self._audit_strike_depth = None  # the level the strikes belong to
        # the checkpoint manifests' run identity (bfs.py:773): the spec
        # constants only, not tunables and not the fingerprint definition
        # (each delta record's meta[2] guards that, _check_fp_def)
        self._run_fp = resilience.run_config_fingerprint(cfg, log="delta")
        self.device = resolve_device(device)
        self.uni = get_universe(cfg)
        self.fpr = Fingerprinter(cfg, device=self.device)
        self.mx = MXUExpand(cfg, self.device)
        self.layout = self.mx.layout
        self.tables = GuardTables(cfg, self.device)
        self.K = self.layout.K
        # the dense expand: canon="expand"'s chunk expand, and the legacy
        # guard of use_mxu=False and of the audit; its tables on the card
        # now, since a first launch may be inside a graph capture
        self.dx = None
        if canon == "expand" or not self.use_mxu or self.audit:
            self.dx = DenseExpand(cfg, self.uni, self.device, fpr=self.fpr)
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
        if use_hashstore is None:
            use_hashstore = hashstore.enabled_by_env()
        # an external store takes the visited set off the card (bfs.py:586)
        self.host_store = host_store
        self.use_hashstore = bool(use_hashstore) and host_store is None
        refusal = segment_settings_refusal(host_store is not None)
        if refusal:
            raise ValueError(refusal)
        if host_store is not None and self.chunk > SEG_ROWS:
            # the segment walks assume no chunk straddles two segments
            raise ValueError(f"chunk ({self.chunk}) must be <= SEG_ROWS ({SEG_ROWS}) when an "
                             "external host store is attached")
        # the device bytes a level's frontier segments may hold before the
        # sealed ones page out to host RAM (bfs.py:634; 0: no paging)
        self.dev_budget = int(float(os.environ.get("TLA_RAFT_DEV_BYTES", "0") or 0))
        self.paged_out = 0  # sealed child segments paged out to host RAM
        # full groups inside one segment run as the captured group program
        # at chunks of at least this many rows (bfs.py:700); the tests lower
        # it to reach the program at their small chunks
        self.span_min_chunk = 2048
        self.frontier_segs: list | None = None  # the host route's last committed segments
        self.host_stats = dict(levels=0, groups=0, graph_groups=0, chunk_groups=0,
                               saved_groups=0, group_s=0.0, fetch_s=0.0, lexsort_s=0.0,
                               insert_s=0.0, materialize_s=0.0, candidates=0, unique=0,
                               level_log=[])
        self.hstore: DeviceHashStore | None = None
        # the sorted store (use_hashstore=False): u64 ascending, SENT-padded
        # to a power-of-4 length (bfs.py:4216, 4921-4925)
        self.visited: torch.Tensor | None = None
        self.degraded_at: int | None = None  # committed levels when the slab failed
        self.degraded_site: str | None = None  # the route (or "between levels") it failed in
        self.graph_launches_at_degrade: int | None = None
        self.frontier: Frontier | None = None  # the last committed level's rows
        self.redos = dict(cap_x=0, slab=0, cap_m=0, cap_g=0)  # every route's redos
        # the fused level and the supersteps fingerprint with K3 alone and
        # dedup in the hash slab: orbit and the sorted store run the staged
        # and grouped chains (bfs.py:738-742)
        if megakernel is None:
            megakernel = mk.enabled_by_env()
        self.megakernel = bool(megakernel) and not self.orbit and self.use_hashstore
        if self.orbit:
            self.fpr.orbit_tables  # on the card now: a first launch may be in a capture
        if superstep is None:
            superstep = ss.span_from_env()
        # the audit re-expands from each level's parents, which a resident
        # superstep consumes: audited runs go per level (bfs.py:758)
        self.superstep_span = (max(1, int(superstep)) if self.megakernel and not self.audit
                               else 1)
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
                                host_group_launches=0,
                                copies=0, capture_log=[], launch_log=[])
        self.level_timing: dict = {}  # host seconds of the last fused level, by step
        # levels committed by route
        self.routes = dict(superstep=0, fused=0, grouped=0, staged=0)
        if host_store is not None:
            self.routes = dict(host=0)  # every level takes the external store route
        self.k4_round_log: list = []  # claim rounds of every fused level run
        self.group_log: list = []  # one record per grouped level
        # the async pipeline (bfs.py:651-662)
        if pipeline is None:
            pipeline = gpipe.enabled_by_env()
        if pipeline_window is None:
            pipeline_window = gpipe.window_from_env()
        self.pipeline_window = int(pipeline_window)
        self.pipeline = bool(pipeline) and self.pipeline_window >= 1
        # the forecast prewarm and the presize (bfs.py:663-714): on where a
        # program's first build is a costly host step -- on the card, its
        # graph capture (the depth-25 wall measured better with them on:
        # PERF.md §5-§6)
        on_card = self.device.type == "cuda"
        self.prewarm = _setting("TLA_RAFT_PREWARM", prewarm, on_card)
        self.presize = _setting("TLA_RAFT_PRESIZE", presize, on_card)
        self._prewarmer: gpipe.Prewarmer | None = None  # built at the first plan
        self._planned: set | None = None  # the keys the plans named (None: no plan yet)
        self._presize_vcap = 0     # the sorted store's width floor (pow4)
        self._presize_entries = 0  # the slab's entry forecast
        self._presize_merge = 0    # the sorted store's merge-input floor (pow2)
        self.presize_log: list = []  # [depth, slab slots before, after] of each presize grow
        self.slab_grows = 0  # the slab's grows and reserves that moved it, on every route
        self.prewarm_failures: list = []  # (key, error) of each failed prewarm thunk
        self.prewarm_thunks = 0
        self._progs = mk.ProgramCache(forecast.presize_budget())

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

    # -- the arms' kernels ---------------------------------------------------

    def guards(self, st: RaftState):
        """(valid, mult, abort) of a parent batch: K1, or the legacy guard
        (the guards-only dense expand) under ``use_mxu=False``."""
        return self.mx.guards(st) if self.use_mxu else self.dx.guards(st)

    def materialize_plain(self, fr: Frontier, pidx, slots):
        """The arm's materialize twin (K2's or ``legacy_materialize``'s)."""
        if self.use_mxu:
            return self.mx.materialize_plain(fr, pidx, slots)
        return materialize_legacy_plain(self.cfg, fr, pidx, slots)

    def materialize(self, fr: Frontier, pidx, slots, legacy: bool | None = None):
        """(child Frontier, added, overflow) of (parent row, slot) lanes:
        K2, or ``legacy_materialize`` under ``use_mxu=False`` (or
        ``legacy``); the plain twin on the CPU."""
        legacy = (not self.use_mxu) if legacy is None else legacy
        if fr.msg_ids.device.type == "cpu":
            if legacy:
                return materialize_legacy_plain(self.cfg, fr, pidx, slots)
            return self.mx.materialize_plain(fr, pidx, slots)
        return kernels.materialize(self.mx, fr, pidx, slots, legacy=legacy)

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
        if self.canon == "expand":
            # bfs.py:986-1001: fingerprints of every fan-out lane by delta
            # hash, then the live lanes compacted; nothing materialized
            valid, mult, fv, ff, abort = self.dx.expand(self.inflate(part_f))
        else:
            valid, mult, abort = self.guards(self.inflate(part_f))
        mult_slots = mult.to(I64).sum(0)
        first = start + torch.argmax(abort.to(torch.int32)).to(I64)
        abort_at = torch.where(abort.any(), first, torch.full_like(first, BIG))
        if self.canon == "expand":
            cv, cf, cp, ovf_x = chunk_compact(fv.reshape(-1), ff.reshape(-1), self.cap_x,
                                              start * K)
            return cv, cf, cp, mult_slots, abort_at, ovf_x, torch.zeros_like(ovf_x)
        rows = start + torch.arange(B, dtype=I64, device=self.device)
        payload = (rows[:, None] * K + torch.arange(K, dtype=I64, device=self.device)).reshape(-1)
        cp_raw, lane, ovf_x = compact_payloads(valid.reshape(-1), payload, self.cap_x)
        lidx = (torch.div(cp_raw, K, rounding_mode="floor") - start).clamp(0, B - 1)
        children, _added, ovf_rows = self.materialize(part_f, lidx, cp_raw % K)
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

    def expand_level(self, frontier: Frontier, n_f: int, store: torch.Tensor,
                     grouped: bool = False) -> dict:
        """Expand every chunk, then dedup the level against ``store``: the
        hash slab, or the sorted store when ``use_hashstore`` is off.

        Returns host-side control values (n_new, abort_at, overflow
        flags, per-slot multiplicities) and the device-side survivors
        (new_fps, new_payload).  On the hash slab they come in payload
        order and are inserted into ``store`` in place: a level whose
        candidate or message budget overflowed inserts nothing, one whose
        insert overflowed leaves ``store`` as it was.  On the sorted store
        (bfs.py:3640-3684) they come fp_view-ascending and ``store`` is not
        touched (the caller merges); with ``grouped`` every G chunks are
        filtered against it (``group_filter``, each group to ``cap_g``
        lanes; the last group padded to G chunks) before one
        ``level_dedup`` over the groups' lanes, else the chunks' lanes go to
        it whole; either way padded to a half-step lane count
        (``_cap_steps``, bfs.py:3655-3666)."""
        if grouped and self.use_hashstore:
            raise ValueError("the eager grouped level runs on the sorted store only")
        cvs, cfs, cps = [], [], []
        gvs, gfs, gps = [], [], []
        mult = torch.zeros((self.K,), dtype=I64, device=self.device)
        abort_at = torch.full((), BIG, dtype=I64, device=self.device)
        ovf_x = torch.zeros((), dtype=torch.bool, device=self.device)
        ovf_m = torch.zeros((), dtype=torch.bool, device=self.device)
        ovf_g = torch.zeros((), dtype=torch.bool, device=self.device)

        def flush_group():
            pad = (self.G - len(cvs)) * self.cap_x
            lanes = [torch.cat(x + [torch.full((pad,), v, dtype=I64, device=self.device)])
                     for x, v in ((cvs, SENT), (cfs, SENT), (cps, -1))]
            gv, gf, gp, ovf = group_filter(*lanes, store, self.cap_g)
            gvs.append(gv)
            gfs.append(gf)
            gps.append(gp)
            cvs.clear()
            cfs.clear()
            cps.clear()
            return ovf

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
            if grouped and len(cvs) == self.G:
                ovf_g = ovf_g | flush_group()
        if grouped and cvs:
            ovf_g = ovf_g | flush_group()
        ctl = torch.cat([torch.stack([abort_at, ovf_x.to(I64), ovf_m.to(I64), ovf_g.to(I64)]),
                         mult])
        graft_obs.dispatch("staged.expand")
        (ctl,) = fetch(ctl, what="staged_expand")  # the expand pass's one control fetch
        out = dict(abort_at=int(ctl[0]), ovf_x=bool(ctl[1]), ovf_m=bool(ctl[2]),
                   ovf_g=bool(ctl[3]), ovf_h=False, mult=ctl[4:].copy(), n_new=0, new_fps=None,
                   new_payload=None, slab=store, groups=len(gvs), lanes=0)
        if out["ovf_x"] or out["ovf_m"] or out["ovf_g"] or out["abort_at"] < n_f:
            return out  # the level is redone or the run stops: insert nothing
        lanes = (gvs, gfs, gps) if grouped else (cvs, cfs, cps)
        cv, cf, cp = (torch.cat(x) for x in lanes)
        out["lanes"] = cv.shape[0]
        if not self.use_hashstore:
            pad = _cap_steps(max(cv.shape[0], 1)) - cv.shape[0]
            if pad:
                cv, cf, cp = (torch.cat([x, torch.full((pad,), v, dtype=I64, device=self.device)])
                              for x, v in ((cv, SENT), (cf, SENT), (cp, -1)))
            n_new, new_fps, new_payload = level_dedup(cv, cf, cp, store)
            graft_obs.dispatch("staged.dedup")
            (nv,) = fetch(n_new.reshape(1), what="staged_dedup")
            out.update(n_new=int(nv[0]), new_fps=new_fps, new_payload=new_payload)
            return out
        slab, fresh, n_new, ovf_h = probe_and_insert(store, cv, cf, cp)
        new_fps, new_payload = compact_fresh(fresh, cv, cp, cv.shape[0])
        graft_obs.dispatch("staged.insert")
        (nv,) = fetch(torch.stack([n_new.to(I64), ovf_h.to(I64)]), what="staged_insert")
        n_new, ovf_h = int(nv[0]), int(nv[1])
        out.update(n_new=n_new, ovf_h=bool(ovf_h), new_fps=new_fps, new_payload=new_payload,
                   slab=slab)
        return out

    def materialize_level(self, frontier: Frontier, new_payload: torch.Tensor, n_new: int):
        """The next frontier from the survivors' payloads, slice by slice,
        then one invariant scan over it: (frontier, first bad row or -1,
        cap_m overflow)."""
        K = self.K
        sl = 8 * self.chunk
        parts, ovfs = [], []
        for a in range(0, n_new, sl):
            pay = new_payload[a : min(a + sl, n_new)]
            pidx = torch.div(pay, K, rounding_mode="floor")
            child, _added, ovf = self.materialize(frontier, pidx, pay % K)
            parts.append(child)
            ovfs.append(ovf.any())
        new = Frontier(*(torch.cat([getattr(p, f) for p in parts]) for f in Frontier._fields))
        bad = self.inv_scan(new)
        graft_obs.dispatch("staged.mat")
        (ctl,) = fetch(torch.stack([bad, torch.stack(ovfs).any().to(I64)]), what="staged_mat")
        return new, int(ctl[0]), bool(ctl[1])

    # -- the sampled recomputation audit (bfs.py:1864-2082) ---------------------

    @staticmethod
    def _flip_frontier_row(frontier: Frontier) -> Frontier:
        """The ``tensor.flip`` fault: bit 0 of the first frontier row's
        ``current_term[0]`` flips on the device, in place.  Row 0 is always
        live and always in the audit sample (``audit_indices``)."""
        frontier.current_term[0, 0] ^= 1
        return frontier

    def _audit_rows(self, par_rows: Frontier, kid_rows: Frontier, slots: torch.Tensor):
        """The cross-check over gathered rows (bfs.py:1891): (guard_ok,
        fp_view of the legacy re-expansion, fp_view of the stored row).
        The legacy guard is the guards-only dense expand and the child is
        ``legacy_materialize``'s, both independent of K1/K2; K3 (or the
        orbit definition) fingerprints both row sets."""
        n = slots.shape[0]
        ar = torch.arange(n, dtype=I64, device=slots.device)
        valid, _mult, _abort = self.dx.guards(self.inflate(par_rows))
        guard_ok = valid[ar, slots]
        kids, _added, _ovf = self.materialize(par_rows, ar, slots, legacy=True)
        fv_leg, _ff = self._fp_states(kids)
        fv_now, _ff = self._fp_states(kid_rows)
        return guard_ok, fv_leg, fv_now

    def _gather_frontier_rows(self, frontier, idx_np) -> Frontier:
        """Sampled rows of a frontier (a device frontier, or the external
        store route's segment list) as one small batch (bfs.py:1916)."""
        if isinstance(frontier, list):
            parts = [self._seg_row(frontier, i) for i in np.asarray(idx_np).tolist()]
            return Frontier(*(torch.cat(xs) for xs in zip(*parts)))
        rows = torch.from_numpy(np.asarray(idx_np).astype(np.int64)).to(self.device)
        return Frontier(*(x[rows] for x in frontier))

    def _audit_level(self, parents: Frontier, new_frontier: Frontier, pidx_np, slot_np,
                     level_fps, n_new: int, depth: int) -> list:
        """Re-expand the level's deterministic sample through the legacy
        kernels (bfs.py:1938): the problems found (empty: verified).  The
        sample is padded to the fixed ``audit`` width with row 0."""
        idx = audit_indices(n_new, self.audit)
        if idx.size == 0:
            return []
        self.audit_stats["levels"] += 1
        self.audit_stats["sampled"] += int(idx.size)
        n_live = int(idx.size)
        if n_live < self.audit:
            idx = np.concatenate([idx, np.full(self.audit - n_live, idx[0], np.int64)])
        ref = np.asarray(level_fps)[idx].astype(np.uint64)
        slots = torch.from_numpy(np.asarray(slot_np).astype(np.int64)[idx]).to(self.device)
        par_rows = self._gather_frontier_rows(parents, np.asarray(pidx_np)[idx])
        kid_rows = self._gather_frontier_rows(new_frontier, idx)
        guard_ok, fv_leg, fv_now = self._audit_rows(par_rows, kid_rows, slots)
        guard_np, leg_np, now_np = fetch(guard_ok, fv_leg, fv_now, what="audit")
        leg_np, now_np = leg_np.view(np.uint64), now_np.view(np.uint64)
        problems = []
        for j, row in enumerate(idx[:n_live]):
            if not guard_np[j]:
                problems.append(f"row {int(row)}: legacy guard refutes recorded "
                                f"slot {int(np.asarray(slot_np)[row])}")
            if leg_np[j] != ref[j]:
                problems.append(f"row {int(row)}: legacy re-expansion fp "
                                f"{leg_np[j]:#x} != recorded {ref[j]:#x}")
            if now_np[j] != ref[j]:
                problems.append(f"row {int(row)}: materialized frontier row "
                                f"re-fingerprints to {now_np[j]:#x} != recorded "
                                f"{ref[j]:#x} (corrupted frontier tensor)")
        if problems:
            self.audit_stats["mismatches"] += len(problems)
            for msg in problems[:8]:
                print(f"[integrity] audit level {depth + 1}: {msg}", file=sys.stderr)
        return problems

    def _audit_rewind(self, problems: list, depth: int, max_depth, checkpoint_dir,
                      checkpoint_every: int) -> CheckResult:
        """Quarantine the mismatched level and rewind to the delta log
        (bfs.py:2026-2098); fail-stop after ``audit_retries`` strikes at one
        level, or after 4x that many rewinds in all, or at once without a
        checkpoint directory.  The mismatched level never reached the log
        (the audit runs before the commit), so the rewind is a plain
        resume: the replay re-materializes every level from the durable
        (parent, slot) records, and a transient corruption does not
        survive it."""
        if self._audit_strike_depth == depth:
            self._audit_strikes += 1
        else:
            self._audit_strikes = 1
            self._audit_strike_depth = depth
        strikes = self._audit_strikes
        if self.audit_stats["rewinds"] >= 4 * self.audit_retries:
            raise AuditFailStop(
                f"audit mismatches forced {self.audit_stats['rewinds']} rewinds in one run "
                f"(cap {4 * self.audit_retries}): pervasive corruption — fail-stop; latest "
                "problem: " + problems[0])
        if strikes >= self.audit_retries:
            raise AuditFailStop(
                f"audit mismatch at level {depth + 1} reproduced "
                f"{strikes} time(s) (budget {self.audit_retries}): "
                "deterministic corruption — fail-stop; first problem: " + problems[0])
        if not (checkpoint_dir and checkpoint_every):
            raise AuditFailStop(
                f"audit mismatch at level {depth + 1} with no "
                "checkpoint directory to rewind to — fail-stop; first "
                "problem: " + problems[0])
        has_records = bool(glob.glob(os.path.join(checkpoint_dir, "delta_*.npz")))
        self.audit_stats["rewinds"] += 1
        print(f"[integrity] quarantining level {depth + 1} and rewinding to the last "
              f"committed checkpoint (strike {strikes}/{self.audit_retries})", file=sys.stderr)
        # the slab, the sorted store and the frontier hold the quarantined
        # level: drop them (and every captured program on the slab)
        self._drop_run_state()
        if self.host_store is not None and not has_records:
            # a restart from Init inserts the root again (bfs.py:2089)
            self.host_store.clear()
        return self._run(max_depth, checkpoint_dir, checkpoint_every,
                         checkpoint_dir if has_records else None)

    # -- checkpoints: the delta log and the slab snapshot (bfs.py:2100-3160) ------------

    def _drop_run_state(self) -> None:
        self._progs.clear()
        self.hstore = None
        self.visited = None
        self.frontier = self.frontier_segs = None
        self._sieve_dev, self._sieve_ver = None, -1
        gc.collect()

    def _save_delta(self, ckdir: str, depth: int, pidx_np, slot_np, fps_np, level_mult,
                    n_new: int) -> None:
        """One level's record (bfs.py:2100): ``delta_NNNN.npz`` with pidx
        u32, slot u16 (u32 past 65,535 slots), fps u64, mult i64[K] and
        ``meta = [depth, n_new, fp_def]`` (0: min-over-P, 1: orbit),
        through the atomic manifest writer."""
        slot_dt = np.uint16 if self.K <= 0xFFFF else np.uint32
        resilience.commit_npz(
            ckdir, f"delta_{depth:04d}.npz",
            dict(pidx=np.asarray(pidx_np).astype(np.uint32),
                 slot=np.asarray(slot_np).astype(slot_dt),
                 fps=np.asarray(fps_np)[:n_new].astype(np.uint64),
                 mult=np.asarray(level_mult).astype(np.int64),
                 meta=np.asarray([depth, n_new, int(self.orbit)], np.int64)),
            kind="delta", depth=depth, run_fp=self._run_fp,
        )

    def _dump_slab(self, ckdir: str, depth: int, distinct: int) -> None:
        """The slab snapshot beside the log (bfs.py:5065-5096), at the
        size-aware cadence (``hashstore.dump_interval``), after the
        occupancy check: the snapshot a resume trusts counts exactly the
        distinct set."""
        occupancy_check("device hash slab", self.hstore.occupancy(), distinct, level=depth)
        self.hstore.dump(os.path.join(ckdir, "hslab.npz"), depth, int(self.orbit),
                         run_fp=self._run_fp)

    def _check_fp_def(self, fp_def: int, path: str) -> None:
        """Refuse to mix fingerprint definitions in one visited store
        (bfs.py:3406)."""
        if fp_def != int(self.orbit):
            raise ValueError(
                f"fingerprint-definition mismatch: {path} was written "
                f"with {'orbit' if fp_def else 'min-over-P'} fingerprints "
                f"but this run uses "
                f"{'orbit' if self.orbit else 'min-over-P'} "
                "(TLA_RAFT_ORBIT) — resume with the matching setting")

    def _check_checkpoint_dirs(self, checkpoint_dir, resume_from) -> None:
        """The reference's directory checks (bfs.py:4051-4126) for the
        delta log; resuming from a monolith snapshot is not in the port."""
        if resume_from is not None and not os.path.isdir(resume_from):
            raise ValueError(f"{resume_from} is not a checkpoint directory (the port resumes "
                             "from delta logs only; monolith snapshots are not ported)")
        if not checkpoint_dir:
            return
        if resume_from is None and os.path.isdir(checkpoint_dir):
            resilience.sweep_tmp(checkpoint_dir)
        stale = glob.glob(os.path.join(checkpoint_dir, "delta_*.npz"))
        if resume_from is None and stale:
            raise ValueError(
                f"{checkpoint_dir} holds checkpoints from a previous "
                "run; a fresh run would interleave two runs' logs into "
                "one (silently wrong) replay chain — resume with "
                "--recover or clear the directory")
        if (resume_from is not None
                and os.path.abspath(resume_from) != os.path.abspath(checkpoint_dir) and stale):
            raise ValueError(
                f"resuming from {resume_from} but {checkpoint_dir} "
                "already holds another run's checkpoints — the two "
                "logs would interleave; clear it or checkpoint into "
                "the resumed directory itself")

    def _resume_from_deltas(self, ckdir: str) -> dict:
        """Rebuild the run state from the delta log (bfs.py:2910): heal the
        directory (sweep, verify, quarantine, adopt, truncate to the good
        prefix), replay the records from Init through the port's own
        materialize kernels, then load ``hslab.npz`` when it matches the
        resume point, else rebuild the store from the replayed fps."""
        files = resilience.heal_log(ckdir, "delta", run_fp=self._run_fp, slabs=("hslab.npz",))
        if not files and not resilience.Manifest.load(ckdir).exists:
            raise ValueError(f"no delta_*.npz checkpoints under {ckdir}")
        K = self.K
        host = self.host_store is not None
        frontier, _ovf = self.deflate(init_batch(self.cfg, 1, self.device))
        fv0, _ff = self._fp_states(frontier)
        fps_parts = [fv0.cpu().numpy().view(np.uint64)]
        if host:
            # the external store is rebuilt from the log as the replay walks
            # it (bfs.py:2972-2980): cleared first, since it may hold inserts
            # of a level that never reached the log
            self.host_store.clear()
            self.host_store.insert(fps_parts.pop())
            frontier = [Frontier(*(_pad_axis0(x, self.chunk) for x in frontier))]
        trace_levels, level_sizes = [], [1]
        mult_per_slot = np.zeros(K, np.int64)
        depth = 0
        for f in files:
            with np.load(f) as z:
                meta = [int(x) for x in z["meta"]]
                pidx = z["pidx"].astype(np.int64)
                slot = z["slot"].astype(np.int64)
                fps = z["fps"].astype(np.uint64)
                mult = z["mult"].astype(np.int64)
            d, n_new = meta[0], meta[1]
            self._check_fp_def(meta[2] if len(meta) > 2 else 0, f)
            if d != depth + 1:
                raise ValueError(f"delta log gap: expected level {depth + 1}, found level {d} "
                                 f"({f})")
            if host:
                frontier, _bad, _parent = self._materialize_grow_segs(frontier, pidx * K + slot,
                                                                      n_new)
                self.host_store.insert(fps)
            else:
                pay = torch.from_numpy(pidx * K + slot).to(self.device)
                while True:
                    new, _bad, ovf_m = self.materialize_level(frontier, pay, n_new)
                    if not ovf_m:
                        break
                    frontier = self._grow_cap_m(frontier)
                frontier = new
                fps_parts.append(fps)
            trace_levels.append((pidx, slot))
            level_sizes.append(n_new)
            mult_per_slot = mult_per_slot + mult
            depth = d
        distinct = int(sum(level_sizes))
        allf = np.concatenate(fps_parts) if fps_parts else None
        if host:
            if len(self.host_store) != distinct:
                raise ValueError(
                    f"external-store resume rebuilt {len(self.host_store)} distinct fingerprints "
                    f"for {distinct} recorded states — corrupt or mixed log")
        elif self.use_hashstore:
            self.hstore = DeviceHashStore.load(os.path.join(ckdir, "hslab.npz"), depth, distinct,
                                               int(self.orbit), device=self.device)
            if self.hstore is None:
                self.hstore = DeviceHashStore.from_fps(allf, device=self.device)
            if self.hstore.count != distinct:
                raise ValueError(
                    f"hash-store resume rebuilt {self.hstore.count} distinct fingerprints for "
                    f"{distinct} recorded states — corrupt or mixed log")
        else:
            u = np.unique(allf)
            if len(u) != distinct:
                raise ValueError(f"sorted-store resume rebuilt {len(u)} distinct fingerprints "
                                 f"for {distinct} recorded states — corrupt or mixed log")
            self.visited = upload_sorted_store(u, self.device)
        print(f"[resilience] resumed {ckdir} at level {depth} ({distinct} distinct)",
              file=sys.stderr)
        return dict(frontier=frontier, n_f=level_sizes[-1] if depth else 1, distinct=distinct,
                    depth=depth, level_sizes=level_sizes, trace_levels=trace_levels,
                    mult_per_slot=mult_per_slot)

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
        return self.replay(chain)

    def replay(self, chain: list) -> list:
        """The states of a slot chain from Init: [(action, OState), ...]."""
        fr, _ovf = self.deflate(init_batch(self.cfg, 1, self.device))
        out = [("Init", to_oracle(self.cfg, self.inflate(fr))[0])]
        zero = torch.zeros((1,), dtype=I64, device=self.device)
        for slot in chain:
            fr, _added, _ovf = self.materialize(
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

    def _superstep_key(self, cap_f: int) -> tuple:
        return ("superstep", cap_f, self.superstep_span, self.chunk)

    def _superstep_make(self, cap_f: int):
        """The builder of a superstep program at ``cap_f`` (its ring holds
        span * cap_f entries, rounded up to a power of two: the ring size
        is a device word, so one program per cap_f serves every ring)."""
        span = self.superstep_span
        ring_max = forecast.pow2ceil(span * cap_f)
        return lambda eng, k: ss.SuperstepProgram(eng, k, cap_f, ring_max, span, eng.k4_rounds)

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

    def _sig(self) -> tuple:
        """The programs' signature: the budgets, slab and sieve words a
        program binds at build time."""
        return self._sig_of(self.cap_x, self.cap_m, self.k4_rounds, self.hstore.slab,
                            self._sieve_operand())

    def _sig_of(self, cap_x, cap_m, rounds, slab, sieve) -> tuple:
        return (self.canon, self.use_mxu, cap_x, cap_m, rounds, slab.data_ptr(), slab.shape[0],
                sieve.data_ptr(), sieve.shape[0])

    def _program(self, key, make):
        """The captured program of ``key`` at the current budgets, slab and
        sieve words, built by ``make(engine, full key)`` (a program built
        for others is dropped: its graph holds their addresses)."""
        sig = self._sig()
        self._progs.drop_stale(sig)

        def built():
            self.graph_stats["programs"] += 1
            return make(self, key + sig)

        return self._progs.get(key + sig, built, self._planned)

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

    def _redo(self, budget: str, to=None) -> None:
        """A budget grew and the level runs again: counted in ``redos`` and
        published as the reference's ``grow`` + ``redo`` events."""
        self.redos[budget] += 1
        graft_obs.grow(budget, to)
        graft_obs.redo(budget)

    def _grow_cap_x(self) -> None:
        """Half-step growth of cap_x; cap_g stays at least G * cap_x / 2
        (bfs.py:4673)."""
        self.cap_x = _cap_steps(self.cap_x + 1)
        self.cap_g = max(self.cap_g, self.G * self.cap_x // 2)
        self._redo("cap_x", self.cap_x)

    def _grow_slab(self, depth: int, expected: int) -> None:
        """A probe overflow's slab growth, or a demotion under the budget
        (the ``slab_tier`` redo: demote, then redo)."""
        how = self._slab_grow_or_demote(depth, expected=expected)
        if how == "demoted":
            self.tiered.stats["tier_redos"] += 1
        self.redos["slab"] += 1
        graft_obs.redo("slab_tier" if how == "demoted" else "slab")

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
        it was (the graph gave any claims back).  A slab grow that fails
        degrades the run to the sorted store and returns ``degraded`` with
        the parents (bfs.py:1283-1292): the caller redoes the level."""
        out_floor = 0
        t = self.level_timing = dict(seat=0.0, launch=0.0, wait=0.0, post=0.0, runs=0)
        while True:
            t0 = time.perf_counter()
            cap_f = self._rows_cap(frontier)
            n_lanes = (cap_f // self.chunk) * self.cap_x
            cap_out = self._mega_cap_out(n_f, level_sizes, max_depth, n_lanes, out_floor)
            key = ("level", cap_f, cap_out, self.chunk)
            prog = self._program(key, lambda eng, k: mk.LevelProgram(
                eng, k, cap_f, cap_out, eng.k4_rounds))
            self._seat(prog.fr_in, frontier, n_f)
            # the parents from here on: the launch rewrites its output buffer,
            # which may be where they came from
            frontier = prog.fr_in
            t1 = time.perf_counter()
            prog.run(n_f)
            t2 = time.perf_counter()
            ctrl, lc, mult, fps, pidx, slot = gpipe.DeferredFetch(
                self.pipeline, (prog.ctrl, prog.lc, prog.mult, prog.fps_out, prog.pidx,
                                prog.slot), what="level").get()
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
                graft_obs.grow("k4_rounds", self.k4_rounds)
                graft_obs.redo("k4_rounds")
                continue
            if ctrl[mk.CTRL_OVF_SLAB]:
                depth = len(level_sizes) - 1
                prog = None  # its graph holds the slab: no reference through the grow
                if self._grow_or_degrade(lambda: self._grow_slab(depth + 1, max(n_new, n_f)),
                                         depth, "fused") == "degraded":
                    return dict(degraded=True, parent=frontier)
                self._mega_stats["redo_slab"] += 1
                continue
            if ctrl[mk.CTRL_OVF_X]:
                self._grow_cap_x()
                self._mega_stats["redo_x"] += 1
                continue
            if n_new > cap_out:
                out_floor = n_new  # the exact count is known: one redo lands it
                self._mega_stats["redo_out"] += 1
                graft_obs.grow("cap_out", n_new)
                graft_obs.redo("cap_out")
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
        # a failed reserve degrades to the sorted store; the caller runs the
        # level per level (bfs.py:1716-1727)
        if self._grow_or_degrade(lambda: self._tier_reserve(
                self.hstore.count + max(ins_bound, 2 * max(n_f, 1))),
                depth, "superstep") == "degraded":
            return dict(degraded=True, frontier=frontier)
        key = self._superstep_key(cap_f)
        prog = self._program(key, self._superstep_make(cap_f))
        self._seat(prog.fr[0], frontier, n_f)
        # the ring (fps i64 + pidx i32 + slot i16 an entry) is the window's
        # one extra long-lived buffer
        graft_obs.buffer("ring", prog.ring_max * 14)
        graft_obs.superstep_begin(level=depth + 1, span=span, cap_f=cap_f, ring=ring)
        prog.run(n_f, span, ring)
        ctrl, mn, mm, mr, rf, rp, rs = gpipe.DeferredFetch(
            self.pipeline, (prog.ss[: ss.SS_CTRL], prog.meta_n, prog.meta_mult, prog.meta_rounds,
                            prog.ring_fps[:ring], prog.ring_pidx[:ring], prog.ring_slot[:ring]),
            what="superstep").get()
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
            how = self._grow_or_degrade(
                lambda: self._slab_grow_or_demote(depth + 1, expected=max(n_f, 1)), depth,
                "superstep")
            if how == "demoted":
                self._ss_stats["tier_stops"] = self._ss_stats.get("tier_stops", 0) + 1
                self.tiered.stats["tier_redos"] += 1
            if how != "degraded":
                self.redos["slab"] += 1
                self._mega_stats["redo_slab"] += 1
                graft_obs.redo("slab_tier" if how == "demoted" else "slab")
        if flags & ss.FLAG_OVF_M and self.cap_m < self.uni.M:
            frontier = self._grow_cap_m(frontier)
            self._mega_stats["redo_m"] += 1
        if flags & ss.FLAG_OVF_ROUNDS:
            self.k4_rounds *= 2
            self._mega_stats["redo_rounds"] += 1
            graft_obs.grow("k4_rounds", self.k4_rounds)
        if flags & ss.FLAG_TIER:
            self._ss_stats["sieve_stops"] = self._ss_stats.get("sieve_stops", 0) + 1
        return frontier

    # -- the presize and the forecast prewarm (bfs.py:2248-2560, 4289-4324) --------------

    def _update_presize(self, level_sizes, distinct: int, max_depth) -> None:
        """Ratchet the forecast floors over the next ``PRESIZE_HORIZON``
        levels (bfs.py:2248): the slab's entries (each level counted at most
        at the fused limit), the sorted store's width and its merge input,
        each clamped by ``TLA_RAFT_PRESIZE_BYTES``.
        Floors only grow.  (The reference's frontier-capacity floor is not
        taken: a superstep's graph launches every chunk of its capacity, so
        a floored capacity costs launches on every shallower level.)"""
        fut = forecast.forecast_new_states(level_sizes, max_depth)[:forecast.PRESIZE_HORIZON]
        if not fut:
            return
        peak, budget = max(fut), forecast.presize_budget()
        self._presize_vcap = max(self._presize_vcap,
                                 min(_cap4(distinct + sum(fut) + 1), _cap4(budget // 8)))
        # the slab's entries count a level at most at the fused limit: a
        # larger one runs grouped, whose programs are cheap to capture again,
        # so its inserts are left to the between-level grow (the reference's
        # uncapped sum reserved again under the 4,194,304-row superstep at
        # depth 21 and recaptured it: PERF.md §6)
        limit = 16 * self.G * self.chunk
        self._presize_entries = max(self._presize_entries,
                                    min(distinct + sum(min(f, limit) for f in fut), budget // 16))
        self._presize_merge = max(self._presize_merge,
                                  min(_pow2(int(peak * 1.05) + 1), _pow2(budget // 16)))

    def _presize_step(self, level_sizes, distinct: int, max_depth, depth: int) -> None:
        """After a superstep or level, before the next, past
        ``forecast.MIN_LEVELS`` levels: the slab reserved to the forecast's
        entries x 1.1 (a failed reserve degrades as any grow does), or the
        sorted store SENT-padded to its width floor (bfs.py:4289-4315)."""
        if (not self.presize or self.host_store is not None
                or len(level_sizes) <= forecast.MIN_LEVELS):
            return
        self._update_presize(level_sizes, distinct, max_depth)
        if self.use_hashstore:
            if self._presize_entries:
                before = self.hstore.cap
                self._grow_or_degrade(lambda: self._tier_reserve(
                    int(self._presize_entries * 1.1)), depth, "presize")
                if self.hstore is not None and self.hstore.cap != before:
                    self.presize_log.append([depth, before, self.hstore.cap])
        elif self._presize_vcap > self.visited.shape[0]:
            # SENT sorts last: the padded store stays sorted
            pad = torch.full((self._presize_vcap - self.visited.shape[0],), SENT, dtype=I64,
                             device=self.device)
            self.visited = torch.cat([self.visited, pad])

    def _snapshot(self):
        """(signature, engine view) of the budgets as they stand, read on
        the prewarm thread (reads only: nothing is created here); None when
        there is no slab or sieve operand to build against."""
        hs = self.hstore
        sieve = self._sieve_dev if self._tier_active() else self._sieve_empty
        if hs is None or sieve is None:
            return None
        slab, cap_x, cap_m, rounds = hs.slab, self.cap_x, self.cap_m, self.k4_rounds
        return self._sig_of(cap_x, cap_m, rounds, slab, sieve), mk.EngineView(
            self, cap_x=cap_x, cap_m=cap_m, cap_g=self.cap_g, k4_rounds=rounds, slab=slab,
            sieve=sieve)

    def _plan_entry(self, key: tuple, make, sig: tuple) -> tuple:
        """One (key, thunk) pair of the plan: the thunk builds the program of
        ``key`` against the budgets as they stand when it runs and captures
        it, unless they are no longer ``sig`` (the plan's) -- the main
        thread grew one meanwhile, and the program would be stale."""
        def thunk():
            snap = self._snapshot()
            if snap is None or snap[0] != sig:
                return
            view = snap[1]
            if key[0] == "group" and key[3] != view.cap_g:
                return
            if self._progs.prewarm(key + sig, lambda: make(view, key + sig)) == "yielded":
                pw = self._prewarmer
                if pw is not None:
                    pw.forget(key + sig)  # gave way to the main thread: the next plan retries

        return key + sig, thunk

    def _prewarm_plan(self, level_sizes, max_depth, frontier) -> list:
        """(key, thunk) pairs that build and capture the programs of the
        forecast's levels (bfs.py:2308), walking the forecast as the run
        loop will route it: superstep windows through ``_superstep_shapes``
        (the next window, and later ones at the fused limit's capacity; a
        window whose forecast passes its capacity stops there, and that
        level runs fused from the window's buffer: ``_rows_cap`` and
        ``_mega_cap_out``), fused levels where supersteps are off or the
        span is down to 1, and grouped levels past the fused limit
        (``group.group_key``).  The plan is submitted after a superstep or
        level, so its first program is captured while the loop commits.  A
        CUDA graph binds the slab's address, so every program is planned
        against the slab that exists (the presize reserved it); the
        reference's ladder of slab capacities collapses to that one."""
        if (not self.megakernel or not self.use_hashstore or self.host_store is not None
                or self.orbit or self.hstore is None or isinstance(frontier, list)):
            return []
        fut = forecast.forecast_new_states(level_sizes, max_depth)[:forecast.PRESIZE_HORIZON]
        if not fut:
            return []
        sig = self._sig()
        plan, seen = [], set()

        def add(key, make):
            if key not in seen:
                seen.add(key)
                plan.append(self._plan_entry(key, make, sig))

        depth = len(level_sizes) - 1
        sizes = list(level_sizes)
        limit = 16 * self.G * self.chunk  # the fused size limit: a window's largest capacity
        n_par = max(int(level_sizes[-1]), 1)
        cap_in = self._rows_cap(frontier)
        k = 0

        def fused(n_par, cap_in, k):
            n_lanes = (cap_in // self.chunk) * self.cap_x
            cap_out = self._mega_cap_out(n_par, sizes + fut[:k], max_depth, n_lanes, 0)
            add(("level", cap_in, cap_out, self.chunk),
                lambda e, key, a=cap_in, b=cap_out: mk.LevelProgram(e, key, a, b, e.k4_rounds))
            return cap_out

        while k < len(fut):
            if self._grouping(n_par):
                gk = group.group_key(self, n_par)
                add(gk, group.group_make(gk[1]))
                n_par, cap_in, k = fut[k], self.chunk, k + 1
                continue
            span_at = self._superstep_span_at(max_depth, depth + k)
            if span_at > 1:
                fut_w = fut[k:k + span_at]
                cap_f, _ring = self._superstep_shapes(fut_w, self.superstep_span, n_par, cap_in)
                if k == 0 or cap_f >= limit:
                    # past the next window only the fused limit's capacity:
                    # the forecast's overshoot makes a later window under it
                    # a shape the run rarely uses (PERF.md §6)
                    add(self._superstep_key(cap_f), self._superstep_make(cap_f))
                cap_in = cap_f
                stop = False
                for f in fut_w:
                    if f > cap_f:
                        stop = True  # FLAG_OVF_OUT: this level runs fused next
                        break
                    n_par, k = f, k + 1
                if stop:
                    cap_in = fused(n_par, cap_in, k)
                    n_par, k = fut[k], k + 1
                continue
            cap_in = fused(n_par, cap_in, k)
            n_par, k = fut[k], k + 1
        return plan

    def _submit_prewarm(self, level_sizes, max_depth, frontier) -> None:
        """Queue the plan on the prewarm thread (after every superstep and
        level with forecast signal; the thread dedupes keys, so only a
        sharper forecast or a new signature queues anything)."""
        if not self.prewarm or len(level_sizes) <= forecast.MIN_LEVELS or self.hstore is None:
            return
        # the signature the plan keys on is the one the next launch will use
        self._progs.drop_stale(self._sig())
        plan = self._prewarm_plan(level_sizes, max_depth, frontier)
        if not plan:
            if self._prewarmer is not None:
                self._prewarmer.retain(())
            self._progs.retain_fresh(())
            return
        if self._planned is None:
            self._planned = set()
        self._planned.update(k[:-len(self._progs.sig)] for k, _t in plan)
        if self._prewarmer is None or self._prewarmer.stopped:
            self._prewarmer = gpipe.Prewarmer()
        # what the newest forecast no longer expects goes: queued or built
        keys = [k for k, _t in plan]
        self._prewarmer.retain(keys)
        self._progs.retain_fresh(keys)
        self._prewarmer.submit(plan)

    def _stop_prewarm(self) -> None:
        """Drop the prewarm's queue and wait out its capture in flight (the
        run's end, a degrade); its failures stay in ``prewarm_failures``."""
        if self._prewarmer is not None:
            self._prewarmer.shutdown()
            self.prewarm_failures += self._prewarmer.failures
            self.prewarm_thunks += self._prewarmer.n_ok + self._prewarmer.n_failed
            self._prewarmer = None

    def pipeline_stats(self) -> dict:
        """The captures by thread, the recaptures by cause, the prewarm's
        hits, misses, waits and wasted programs, the presize's and the
        slab's grows."""
        g, c = self.graph_stats, self._progs.stats
        return dict(
            prewarm=self.prewarm, presize=self.presize, pipeline=self.pipeline,
            window=self.pipeline_window if self.pipeline else 0,
            main_captures=g.get("main_captures", 0),
            main_capture_seconds=g.get("main_capture_seconds", 0.0),
            main_lock_seconds=g.get("main_lock_seconds", 0.0),
            prewarm_captures=g.get("prewarm_captures", 0),
            prewarm_capture_seconds=g.get("prewarm_capture_seconds", 0.0),
            recaptures=dict(g.get("recaptures", {})),
            hits=c["prewarm_hits"], misses=c["prewarm_misses"],
            misses_unplanned=sum(1 for _k, how in self._progs.misses if how == "unplanned"),
            wasted=c["prewarm_wasted"], unused=len(self._progs.fresh),
            yields=g.get("prewarm_yields", 0), yield_seconds=g.get("prewarm_yield_seconds", 0.0),
            skipped=c["prewarm_skipped"], over_budget=c["prewarm_over_budget"],
            waits=c["prewarm_waits"], wait_seconds=c["prewarm_wait_seconds"],
            thunks=self.prewarm_thunks, failed=len(self.prewarm_failures),
            slab_grows=self.slab_grows, presize_grows=len(self.presize_log))

    # -- the tiered visited store (bfs.py:3207-3375) ---------------------------------

    def _tier_on(self) -> bool:
        """A device budget bounds the hot slab (never the sorted store)."""
        return self.tiered is not None and self.use_hashstore

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
        t0 = time.monotonic()
        (vb,) = fetch(self.hstore.slab, what="demote")
        gen = self.tiered.demote(vb.view(np.uint64))
        graft_obs.tier_demote(depth, gen.n, gen.gid, time.monotonic() - t0)
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
        self.slab_grows += 1
        graft_obs.grow("slab", self.hstore.cap)
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
        before = self.hstore.cap
        self.hstore.reserve(int(entries))
        self.slab_grows += int(self.hstore.cap != before)

    def _tier_filter_level(self, depth: int, n_new: int, fps_np, new_frontier: Frontier):
        """The level tail's generation probe: the fresh rows that revisit a
        demoted fingerprint leave the new frontier (``drop_rows``); their
        fingerprints stay in the hot slab.  (n_keep, keep mask or None,
        new frontier)."""
        w0 = self.tiered.stats["probe_wait_s"]
        hits = self.tiered.probe(fps_np[:n_new])
        n_hit = int(hits.sum())
        graft_obs.tier_probe(depth + 1, n_new, n_hit,
                             wait_s=self.tiered.stats["probe_wait_s"] - w0)
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

    # -- the sorted store's fallback (bfs.py:3369-3404) -------------------------------

    def _graph_launches(self) -> int:
        g = self.graph_stats
        return g["level_launches"] + g["superstep_launches"] + g["group_launches"]

    def _grow_or_degrade(self, grow: Callable[[], object], depth: int, site: str):
        """Run a slab grow and return what it returns; any exception from it
        (an allocation failure on a full card, an injected ``hashstore.grow``
        fault) degrades the run to the sorted store instead of ending it,
        and returns "degraded".  ``site`` (the route, or "between levels")
        is kept for the logs."""
        try:
            return grow()
        except Exception as e:  # noqa: BLE001 - every grow failure degrades (bfs.py:4655)
            why = f"{type(e).__name__}: {e}"
        # out of the handler: the traceback, and with it whatever the failed
        # grow had allocated, is gone before the degrade allocates
        self._degrade_hashstore(why, depth)
        self.degraded_site = site
        return "degraded"

    def _degrade_hashstore(self, why, depth: int) -> None:
        """The automatic ``--no-hashstore`` (bfs.py:3369): the slab's live
        slots are the visited set (with every demoted generation under a
        budget), so one read and a host sort rebuild the sorted store; the
        tiers, the fused level and the supersteps go, and so does every
        captured program (its graph holds the old slab's address): none is
        launched again in this run.  ``depth`` is the committed levels; the
        next level runs on the sorted store.

        The grow failed on a full card, so everything of the hash store --
        the slab, the representative's slab-sized minima, the sieve's
        device copy, every program and its graph pool -- is released
        before the sorted store is allocated (``upload_sorted_store``); the
        callers hold no reference to the slab across a grow."""
        print(f"[resilience] hash-store grow failed ({why}); degrading to the sort-based "
              "visited path (--no-hashstore equivalent) for the rest of the run",
              file=sys.stderr)
        self._stop_prewarm()  # no capture may be in flight while the programs go
        (vb,) = fetch(self.hstore.slab, what="degrade")
        vb = vb.view(np.uint64)
        vb = vb[vb != hashstore.SENT_U64]
        if self._tier_active():
            vb = np.union1d(vb, self.tiered.all_fps())
            self.tiered = None
        vb = np.unique(vb)
        self.graph_launches_at_degrade = self._graph_launches()
        self.use_hashstore = False
        self.hstore = None
        self.megakernel = False
        self.superstep_span = 1
        self._progs.clear()
        self._sieve_dev, self._sieve_ver = None, -1
        kernels.drop_rep_scratch()
        gc.collect()  # a cycle that still holds a program frees its pool now
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.visited = upload_sorted_store(vb, self.device)
        self.degraded_at = depth

    def _merge_level(self, new_fps: torch.Tensor, n_new: int, distinct: int) -> None:
        """The level's new fingerprints into the sorted store, trimmed to a
        power-of-4 capacity past ``distinct`` (bfs.py:4912-4925: the merge
        input is the first max(pow2(n_new), chunk) lanes)."""
        w = min(max(_pow2(n_new), self.chunk), new_fps.shape[0])
        if self._presize_merge:
            # the presize floors pin both widths (bfs.py:4916-4924)
            w = max(w, min(self._presize_merge, new_fps.shape[0]))
        n_out = min(self.visited.shape[0] + w, max(_cap4(distinct + 1), self._presize_vcap))
        self.visited = merge_sorted(self.visited, new_fps[:w], n_out)

    # -- the external store route (--fpstore-dir; bfs.py:3713-4000, 2562-2830) -----------

    def _seg_to_host(self, seg: Frontier) -> _HostSeg:
        """A sealed device segment paged out to host RAM (bfs.py:2765)."""
        arrs = fetch(*seg, what="page_out")
        return _HostSeg({f: a.copy() for f, a in zip(Frontier._fields, arrs)})

    def _seg_to_dev(self, seg) -> Frontier:
        """A segment on the card: a host segment paged back in (bfs.py:2799)."""
        if not isinstance(seg, _HostSeg):
            return seg
        return Frontier(**{f: torch.from_numpy(v).to(self.device) for f, v in seg.fields.items()})

    def _widen_seg(self, seg):
        """A segment's id lists padded out to ``cap_m`` (bfs.py:2742)."""
        if not isinstance(seg, _HostSeg):
            return self.widen(seg)
        ids = seg.fields["msg_ids"]
        pad = self.cap_m - ids.shape[1]
        if pad <= 0:
            return seg
        fields = dict(seg.fields)
        fields["msg_ids"] = np.concatenate([ids, np.full((ids.shape[0], pad), -1, ids.dtype)],
                                           axis=1)
        return _HostSeg(fields)

    def _grow_cap_m_segs(self, segs: list) -> list:
        if self.cap_m >= self.uni.M:
            raise RuntimeError("message-set width exceeds the whole universe")
        self.cap_m = min(self.cap_m + 32, self.uni.M)
        self._redo("cap_m", self.cap_m)
        return [self._widen_seg(s) for s in segs]

    def _seg_row(self, segs: list, idx: int) -> Frontier:
        """Row ``idx`` of a segment list as a one-row frontier on the card."""
        si, off = divmod(int(idx), _seg_rows(segs[0]))
        seg = segs[si]
        if isinstance(seg, _HostSeg):
            return Frontier(**{f: torch.from_numpy(v[off:off + 1].copy()).to(self.device)
                               for f, v in seg.fields.items()})
        return mk.rows_of(seg, off, off + 1)

    def _host_program(self):
        """The captured group program at the current budgets (bfs.py:1130
        ``_expand_group_fused_impl``); one serves every full group."""
        sig = (self.canon, self.use_mxu, self.cap_x, self.cap_m)
        self._progs.drop_stale(sig)
        key = ("host_group", self.G, self.chunk) + sig

        def built():
            self.graph_stats["programs"] += 1
            return group.HostGroupProgram(self, key)

        return self._progs.get(key, built)

    def _expand_level_host(self, segs: list, n_f: int, ckdir, depth: int) -> dict:
        """One level on the external store route (bfs.py:3713).

        Per group of G chunks: the expand and ``group_unique`` on the card,
        as the captured group program where the reference's ``span_ok``
        holds (a full group inside one segment at chunks of at least
        ``span_min_chunk`` rows, not under orbit), else chunk by chunk and
        padded to G chunks (the tail group, orbit, small chunks); then one
        counted read of (n_u, abort, overflows, mult, gv, gf, gp) through the
        pipeline's ``AsyncFetchWindow`` (bfs.py:3739-3790): a group's copies
        are queued behind its launches, and the card runs the next groups
        while up to ``pipeline_window`` reads are open; the groups complete
        in order.  ``group_s`` is the groups' device seconds by CUDA events
        (the host's seconds issuing them on the CPU), ``fetch_s`` the host's
        seconds in the window (its waits and the groups' consumes).  A completed
        group's lanes are saved as a partial record when the run
        checkpoints, and a matching partial of an earlier, crashed run
        stands in for its group.

        An abort (split brain) or a cap_x / cap_m overflow stops the walk
        before anything reaches the store (bfs.py:3752-3785); the groups
        already issued past it are read and dropped (``discard``), as the
        serial chain never reached them.  The window drains before the
        store's insert.  Otherwise the
        host makes the level-wide choice: the groups' lanes lexsorted by
        (fp_view, fp_full, payload), the first of each fp_view kept, the
        store's insert keeps the unvisited ones, and the survivors come out
        ascending by payload -- the order the delta record, the trace and
        the segment walk of the materialize rely on (bfs.py:3907-3916).

        Returns host values: abort_at, ovf_x, ovf_m, mult, n_new, and the
        survivors' new_fps (u64) and new_payload (i64) numpy arrays."""
        K, G, chunk = self.K, self.G, self.chunk
        hs = self.host_stats
        seg_len = _seg_rows(segs[0])
        n_chunks = -(-max(n_f, 1) // chunk)
        n_groups = -(-n_chunks // G)
        level = depth + 1
        hv, hf, hp = [], [], []
        mult = np.zeros(K, np.int64)
        saved = self._load_partials(ckdir, level, n_f) if ckdir else {}
        page = {"j": -1, "dev": None}  # the one host segment paged in
        t_level = time.perf_counter()
        reads0, launches0 = sum(READS.values()), self.graph_stats["host_group_launches"]
        level_stats = dict(group_s=0.0, fetch_s=0.0, lexsort_s=0.0, insert_s=0.0)
        graph_groups = 0

        def seg_dev(sj):
            s = segs[sj]
            if not isinstance(s, _HostSeg):
                return s
            if page["j"] != sj:
                page["j"], page["dev"] = sj, self._seg_to_dev(s)
            return page["dev"]

        stop: dict = {}
        win = gpipe.AsyncFetchWindow(self.pipeline_window if self.pipeline else 0)
        on_card = self.device.type == "cuda"

        def consume(gi, base, timing, host):
            """A completed group's read (in group order): the serial chain's
            stop rule, then its unique lanes kept and saved as a partial."""
            if on_card:  # the group's device seconds (its events are behind the read)
                level_stats["group_s"] += timing[0].elapsed_time(timing[1]) / 1e3
            if stop:
                return  # a group before it stopped the level
            ctl, chunk_total, gv, gf, gp = host
            hs["groups"] += 1
            n_u = int(ctl[group.HG_N_U])
            abort = int(ctl[group.HG_ABORT])
            mult_g = ctl[group.HG_MULT:].astype(np.int64)
            mult[:] += mult_g
            ovf_x = bool((chunk_total > self.cap_x).any())
            ovf_m = bool(ctl[group.HG_OVF_M])
            if abort < BIG or ovf_x or ovf_m:
                # nothing reached the store: the caller reports the trace or
                # grows the budget and redoes the level; completed groups'
                # partials stay valid for the redo (_load_partials)
                stop.update(abort_at=base + abort if abort < BIG else BIG, ovf_x=ovf_x,
                            ovf_m=ovf_m)
                return
            gv_c = gv[:n_u].view(np.uint64).copy()
            gf_c = gf[:n_u].view(np.uint64).copy()
            gp_c = gp[:n_u] + base * K
            hv.append(gv_c)
            hf.append(gf_c)
            hp.append(gp_c)
            if ckdir:
                self._save_partial(ckdir, level, gi, gv_c, gf_c, gp_c, mult_g, n_f)

        try:
            for gi in range(n_groups):
                if stop:
                    break
                if gi in saved:
                    # in group order: the open groups before it complete first
                    t0 = time.perf_counter()
                    win.drain()
                    level_stats["fetch_s"] += time.perf_counter() - t0
                    if stop:
                        break
                    z = saved[gi]
                    hv.append(z["hv"])
                    hf.append(z["hf"])
                    hp.append(z["hp"])
                    mult += z["mult"]
                    hs["saved_groups"] += 1
                    continue
                g_lo = gi * G * chunk
                g_hi = g_lo + G * chunk
                span_ok = (chunk >= self.span_min_chunk and not self.orbit
                           and (gi + 1) * G <= n_chunks
                           and g_lo // seg_len == (g_hi - 1) // seg_len)
                t0 = time.perf_counter()
                timing = None
                if on_card:
                    timing = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    timing[0].record()
                if span_ok:
                    sj, off = divmod(g_lo, seg_len)
                    prog = self._host_program()
                    prog.run(seg_dev(sj), off, min(G * chunk, n_f - g_lo))
                    want = (prog.ctl, prog.chunk_total, *prog.out)
                    graph_groups += 1
                else:
                    want = self._host_group_chunks(seg_dev, seg_len, gi, n_f, n_chunks)
                    hs["chunk_groups"] += 1
                if on_card:
                    timing[1].record()
                else:
                    level_stats["group_s"] += time.perf_counter() - t0
                # the copies are queued behind the group's launches and before the
                # next group's, which overwrite the program's output buffers
                base = g_lo if span_ok else 0  # the program's rows and payloads are seat-relative
                t0 = time.perf_counter()
                win.submit(want, lambda host, gi=gi, base=base, timing=timing:
                           consume(gi, base, timing, host), what="host_group")
                level_stats["fetch_s"] += time.perf_counter() - t0
        except BaseException:
            win.discard()  # a raised group (a fault, a failed write) leaves no read open
            raise
        t0 = time.perf_counter()
        if stop:
            win.discard()
        else:
            win.drain()  # the level barrier: every group is on the host before the store
        level_stats["fetch_s"] += time.perf_counter() - t0
        page["dev"] = None
        hs["graph_groups"] += graph_groups
        hs["group_s"] += level_stats["group_s"]
        hs["fetch_s"] += level_stats["fetch_s"]
        out = dict(abort_at=BIG, ovf_x=False, ovf_m=False, mult=mult, n_new=0, new_fps=None,
                   new_payload=None)
        if stop:
            out.update(stop)
            return out
        # the level-wide representative choice and the store's filter
        t0 = time.perf_counter()
        av = np.concatenate(hv) if hv else np.empty(0, np.uint64)
        af = np.concatenate(hf) if hf else np.empty(0, np.uint64)
        ap = np.concatenate(hp) if hp else np.empty(0, np.int64)
        hv = hf = hp = None
        order = np.lexsort((ap, af, av))
        sv, sp = av[order], ap[order]
        first = np.ones(len(sv), bool)
        first[1:] = sv[1:] != sv[:-1]
        uniq_v, uniq_p = sv[first], sp[first]
        t1 = time.perf_counter()
        is_new = self.host_store.insert(uniq_v)
        t2 = time.perf_counter()
        new_fps, new_pay = uniq_v[is_new], uniq_p[is_new]
        o = np.argsort(new_pay)
        level_stats["lexsort_s"] = t1 - t0
        level_stats["insert_s"] = t2 - t1
        hs["lexsort_s"] += t1 - t0
        hs["insert_s"] += t2 - t1
        hs["candidates"] += len(av)
        hs["unique"] += len(uniq_v)
        hs["levels"] += 1
        hs["level_log"].append(dict(
            level=level, parents=n_f, groups=n_groups, saved=len(saved),
            graph_groups=graph_groups, lanes=len(av),
            unique=len(uniq_v), new=int(len(new_fps)),
            graph_launches=self.graph_stats["host_group_launches"] - launches0,
            reads=sum(READS.values()) - reads0, store_runs=self.host_store.num_runs,
            seconds=time.perf_counter() - t_level,
            **{k: round(v, 6) for k, v in level_stats.items()}))
        out.update(n_new=len(new_fps), new_fps=np.ascontiguousarray(new_fps[o]),
                   new_payload=np.ascontiguousarray(new_pay[o]))
        return out

    def _host_group_chunks(self, seg_dev, seg_len: int, gi: int, n_f: int, n_chunks: int):
        """One group chunk by chunk (bfs.py:3830-3860): each chunk's lanes,
        padded to G chunks, then ``group_unique``.  Device values in the
        group program's read layout, with global rows and payloads."""
        K, G, chunk, cap_x = self.K, self.G, self.chunk, self.cap_x
        dev = self.device
        cvs, cfs, cps, totals = [], [], [], []
        mult = torch.zeros((K,), dtype=I64, device=dev)
        abort_at = torch.full((), BIG, dtype=I64, device=dev)
        ovf_x = torch.zeros((), dtype=torch.bool, device=dev)
        ovf_m = torch.zeros((), dtype=torch.bool, device=dev)
        for ci in range(gi * G, min((gi + 1) * G, n_chunks)):
            start = ci * chunk
            sj, off = divmod(start, seg_len)
            live = min(chunk, n_f - start)
            part = mk.rows_of(seg_dev(sj), off, off + live)
            cv, cf, cp, m, ab, ox, om = self._expand_chunk(part, start)
            cvs.append(cv)
            cfs.append(cf)
            cps.append(cp)
            mult = mult + m
            abort_at = torch.minimum(abort_at, ab)
            ovf_x = ovf_x | ox
            ovf_m = ovf_m | om
        pad = (G - len(cvs)) * cap_x
        lanes = [torch.cat(x + [torch.full((pad,), v, dtype=I64, device=dev)])
                 for x, v in ((cvs, SENT), (cfs, SENT), (cps, -1))]
        n_u, gv, gf, gp = group_unique(*lanes)
        zero = torch.zeros((), dtype=I64, device=dev)
        ctl = torch.cat([torch.stack([abort_at, ovf_m.to(I64), n_u.to(I64), zero]), mult])
        # the overflow as a chunk total past cap_x, as the program reports it
        totals = torch.where(ovf_x, torch.full((1,), cap_x + 1, dtype=I64, device=dev),
                             torch.zeros((1,), dtype=I64, device=dev))
        return ctl, totals, gv, gf, gp

    def _host_slice(self) -> int:
        """Survivors a materialize slice takes on the external store route:
        one chunk at the main path's chunks, four at small ones
        (bfs.py:2588), and never more than a segment, so slices tile the
        destination segments."""
        return min(self.chunk if self.chunk >= 2048 else 4 * self.chunk, SEG_ROWS)

    def _materialize_segs(self, segs: list, pay_np, pay_dev, n_new: int):
        """The next frontier as a segment list, walking the parent segments
        in (j, j+1) windows of one-chunk slices (bfs.py:2562): the survivors
        are ascending by payload, so each slice's parents lie in a window of
        two segments, and a segment the walk has passed is set to None in
        ``segs`` (freed; kept under ``audit``, which re-reads parents).  The
        slice's lanes in each segment go through the materialize kernel
        against that segment, and the children are written into the
        destination segment, sealed when the walk reaches its end -- and
        paged out to host RAM when the live segments would pass
        ``dev_budget`` (bfs.py:2655-2677).  Returns (segments, first bad row
        or -1, cap_m overflow), or None when a precondition fails (payloads
        not ascending, a slice's parents past the two-segment window, or a
        slice tiling past the capacity): the caller then takes the
        whole-parent walk."""
        K = self.K
        sl = self._host_slice()
        n_slices = -(-n_new // sl)
        cap_f = _host_cap(n_new, self.chunk)
        if n_slices * sl > cap_f:
            return None
        if not bool(np.all(np.diff(pay_np[:n_new].astype(np.int64)) > 0)):
            return None
        L = _seg_rows(segs[0])
        n_par = len(segs)
        j_los = []
        for si in range(n_slices):
            a, b = si * sl, min(si * sl + sl, n_new)
            j_lo = min(int(pay_np[a]) // K // L, n_par - 1)
            if int(pay_np[b - 1]) // K >= min(j_lo + 2, n_par) * L:
                return None  # the slice's parents pass the two-segment window
            j_los.append(j_lo)
        seg_d = SEG_ROWS if cap_f > SEG_ROWS else cap_f
        n_seg_d = cap_f // seg_d
        per_seg = seg_d // sl if n_seg_d > 1 else n_slices
        dst = [None] * n_seg_d
        paged: dict = {}  # host parent segments paged in for the window
        cur, seg_b = None, None
        bad, ovfs = None, []

        def par(j):
            s = segs[j]
            if isinstance(s, _HostSeg):
                if j not in paged:
                    paged[j] = self._seg_to_dev(s)
                return paged[j]
            return s

        for si in range(n_slices):
            a, b = si * sl, min(si * sl + sl, n_new)
            dj = a // seg_d
            if cur is None:
                cur = mk.empty_frontier(self.cfg, seg_d, self.cap_m, self.device)
            j = j_los[si]
            cut = a + int(np.searchsorted(pay_np[a:b], (j + 1) * L * K))
            for x, y, sj in ((a, cut, j), (cut, b, j + 1)):
                if x == y:
                    continue
                pay = pay_dev[x:y]
                pidx = torch.div(pay, K, rounding_mode="floor") - sj * L
                child, _added, ovf = self.materialize(par(sj), pidx, pay % K)
                mk.copy_rows(mk.rows_of(cur, x - dj * seg_d, y - dj * seg_d), child, y - x)
                bad = self.inv_scan(child, offset=x, into=bad)
                ovfs.append(ovf.any())
            if (si + 1) % per_seg == 0 or si == n_slices - 1:
                sealed, cur = cur, None
                if self.dev_budget:
                    if seg_b is None:
                        seg_b = sum(x.numel() * x.element_size() for x in sealed)
                    # the live segments on the card (the reference's count,
                    # with its pipeline window of 0): parents not yet freed,
                    # sealed destinations, and the two transients
                    live = (sum(1 for k, s in enumerate(segs) if s is not None
                                and (not isinstance(s, _HostSeg) or k in paged))
                            + sum(1 for d in dst if d is not None and not isinstance(d, _HostSeg))
                            + 2)
                    if (live + 1) * seg_b > self.dev_budget:
                        sealed = self._seg_to_host(sealed)
                        self.paged_out += 1
                dst[dj] = sealed
            if not self.audit:
                for k in range(j):  # the walk has passed these parents for good
                    segs[k] = None
                    paged.pop(k, None)
        paged.clear()
        for dj in range(n_seg_d):  # an untouched capacity tail
            if dst[dj] is None:
                dst[dj] = mk.empty_frontier(self.cfg, seg_d, self.cap_m, self.device)
        (ctl,) = fetch(torch.stack([bad, torch.stack(ovfs).any().to(I64)]), what="host_mat")
        return dst, int(ctl[0]), bool(ctl[1])

    def _materialize_fallback_segs(self, whole: Frontier, pay_dev, n_new: int):
        """The whole-parent materialize that still emits a segment list
        (bfs.py:2700): for payloads that are not ascending and for slices
        whose parents pass the two-segment window."""
        K = self.K
        sl = self._host_slice()
        n_slices = -(-n_new // sl)
        cap_f = _host_cap(n_new, self.chunk)
        if n_slices * sl > cap_f:
            seg_d, n_seg_d = cap_f, 1  # rows past n_new are never written
        else:
            seg_d = SEG_ROWS if cap_f > SEG_ROWS else cap_f
            n_seg_d = cap_f // seg_d
        dst = [mk.empty_frontier(self.cfg, seg_d, self.cap_m, self.device)
               for _ in range(n_seg_d)]
        bad, ovfs = None, []
        for si in range(n_slices):
            a, b = si * sl, min(si * sl + sl, n_new)
            pay = pay_dev[a:b]
            child, _added, ovf = self.materialize(whole, torch.div(pay, K, rounding_mode="floor"),
                                                  pay % K)
            dj = min(a // seg_d, n_seg_d - 1)
            mk.copy_rows(mk.rows_of(dst[dj], a - dj * seg_d, b - dj * seg_d), child, b - a)
            bad = self.inv_scan(child, offset=a, into=bad)
            ovfs.append(ovf.any())
        (ctl,) = fetch(torch.stack([bad, torch.stack(ovfs).any().to(I64)]), what="host_mat")
        return dst, int(ctl[0]), bool(ctl[1])

    def _materialize_grow_segs(self, segs: list, pay_np, n_new: int):
        """Materialize the survivors into a segment list, growing cap_m on an
        overflow (bfs.py:2812): (new segments, first bad row or -1, the
        parent segments).  A walk that already freed parent segments cannot
        redo: it raises with the width to restart at (the delta log resumes
        the run)."""
        pay_dev = torch.from_numpy(np.ascontiguousarray(pay_np[:n_new], np.int64)).to(self.device)
        while True:
            retry_parent = None
            res = self._materialize_segs(segs, pay_np, pay_dev, n_new) if pay_np is not None \
                else None
            segged = res is not None
            if res is None:
                for i, s in enumerate(segs):
                    segs[i] = self._seg_to_dev(s)
                whole = _concat_fields(segs)
                res = self._materialize_fallback_segs(whole, pay_dev, n_new)
                retry_parent = whole
                segs = [whole]
            out, bad, ovf = res
            if not ovf:
                return out, bad, segs
            if segged and any(s is None for s in segs):
                raise RuntimeError(
                    f"cap_m={self.cap_m} overflowed after parent segments were released; "
                    f"restart with TLA_RAFT_CAP_M={self.cap_m + 32} -- the delta log resumes "
                    "the run")
            out = None  # the overflowed level's segments go before the parents widen
            if retry_parent is not None:
                pay_np = None  # the retry takes the whole-parent walk again
            segs = self._grow_cap_m_segs(segs)

    def _expand_level_host_redo(self, segs: list, n_f: int, depth: int, ckdir) -> tuple:
        """One host level with its grow-and-redo: (result, parent segments)."""
        while True:
            res = self._expand_level_host(segs, n_f, ckdir, depth)
            if not (res["ovf_x"] or res["ovf_m"]):
                return res, segs
            if res["ovf_x"]:
                self._grow_cap_x()
            if res["ovf_m"]:
                segs = self._grow_cap_m_segs(segs)

    def _save_partial(self, ckdir: str, level: int, gi: int, hv, hf, hp, mult, n_f: int) -> None:
        """A completed group's lanes (bfs.py:3922): ``partial_LLLL_GGGGG.npz``
        with hv / hf u64, hp i64, mult i64[K] and the reference's 9-word meta
        [level, group, chunk, cap_x, G, K, n_f, fp_def, window] (window 0:
        the groups are read serially), through the atomic writer."""
        resilience.commit_npz(
            ckdir, f"partial_{level:04d}_{gi:05d}.npz",
            dict(hv=hv, hf=hf, hp=np.asarray(hp, np.int64), mult=np.asarray(mult, np.int64),
                 meta=np.asarray([level, gi, self.chunk, self.cap_x, self.G, self.K, n_f,
                                  int(self.orbit), 0], np.int64)),
            kind="partial", depth=level, run_fp=self._run_fp)

    def _load_partials(self, ckdir: str, level: int, n_f: int) -> dict:
        """This level's completed groups from an earlier, crashed run
        (bfs.py:3948): a partial counts only when (level, group, chunk, G,
        K, n_f, fp_def) match; cap_x and the window are not matched (a
        completed group's lanes do not depend on them).  Stale and torn
        partials are wiped."""
        out, stale = {}, []
        for f in sorted(glob.glob(os.path.join(ckdir, "partial_*.npz"))):
            try:
                with np.load(f) as z:
                    meta = tuple(int(x) for x in z["meta"])
                    fp_def = meta[7] if len(meta) > 7 else 0
                    want = (level, meta[1], self.chunk, self.G, self.K, n_f, int(self.orbit))
                    got = (meta[0], meta[1], meta[2], meta[4], meta[5], meta[6], fp_def)
                    if got != want:
                        stale.append(os.path.basename(f))
                        continue
                    rec = dict(hv=z["hv"].astype(np.uint64), hf=z["hf"].astype(np.uint64),
                               hp=z["hp"].astype(np.int64), mult=z["mult"].astype(np.int64))
            except (OSError, ValueError, KeyError, EOFError, IndexError, zipfile.BadZipFile):
                stale.append(os.path.basename(f))  # torn by a crash mid-write
                continue
            out[meta[1]] = rec
        if stale:
            resilience.discard_artifacts(ckdir, stale)
        return out

    def _wipe_partials(self, ckdir: str) -> None:
        """Drop every partial record (bfs.py:3997): a committed level's delta
        record supersedes its partials."""
        resilience.discard_artifacts(
            ckdir, [os.path.basename(f) for f in glob.glob(os.path.join(ckdir, "partial_*.npz"))])

    # -- the run ------------------------------------------------------------------

    def _grouping(self, n_f: int) -> bool:
        """Levels of more than 16 * G chunks run grouped (bfs.py:3522)."""
        return -(-max(n_f, 1) // self.chunk) > 16 * self.G

    def _expand_level_grouped(self, frontier: Frontier, n_f: int, depth: int) -> tuple:
        """One grouped level with its grow-and-redo (bfs.py:4620-4677):
        (result, parent frontier).  Every redo runs against the store as it
        was before the level.  On the hash slab the group graph
        (engine/group.py), on the sorted store the eager chain of
        ``expand_level(grouped=True)``; a slab grow that fails degrades and
        the redo runs on the latter."""
        while True:
            if self.use_hashstore:
                res = group.expand_level_grouped(self, frontier, n_f)
            else:
                res = self.expand_level(frontier, n_f, self.visited, grouped=True)
                res.update(ovf_rounds=False, rounds=0)
            if not (res["ovf_x"] or res["ovf_g"] or res["ovf_h"] or res["ovf_m"]
                    or res["ovf_rounds"]):
                return res, frontier
            # the flags only: nothing of the attempt goes through a grow
            ovf, res = {k: res[k] for k in ("ovf_x", "ovf_g", "ovf_h", "ovf_m", "ovf_rounds",
                                            "n_new")}, None
            if ovf["ovf_h"]:
                n_new = ovf["n_new"]
                self._grow_or_degrade(
                    lambda: self._grow_slab(depth + 1, max(n_f, n_new)), depth, "grouped")
            if ovf["ovf_x"]:
                self._grow_cap_x()
            if ovf["ovf_g"]:
                self.cap_g *= 2
                self._redo("cap_g", self.cap_g)
            if ovf["ovf_rounds"]:
                self.k4_rounds *= 2
                graft_obs.grow("k4_rounds", self.k4_rounds)
                graft_obs.redo("k4_rounds")
            if ovf["ovf_m"]:
                frontier = self._grow_cap_m(frontier)

    def _expand_level_staged(self, frontier: Frontier, n_f: int, depth: int) -> tuple:
        """One ungrouped staged level with its grow-and-redo: (result,
        parent frontier)."""
        while True:
            res = self.expand_level(frontier, n_f,
                                    self.hstore.slab if self.use_hashstore else self.visited)
            if not (res["ovf_x"] or res["ovf_h"] or res["ovf_m"]):
                return res, frontier
            # nothing was inserted, or the insert was undone; the attempt's
            # dict holds the slab: only its flags go through a grow
            ovf, res = {k: res[k] for k in ("ovf_x", "ovf_h", "ovf_m", "n_new")}, None
            if ovf["ovf_x"]:
                self._grow_cap_x()
            if ovf["ovf_h"]:
                self._grow_or_degrade(
                    lambda: self._grow_slab(depth + 1, max(n_f, ovf["n_new"])), depth, "staged")
            if ovf["ovf_m"]:
                frontier = self._grow_cap_m(frontier)

    def run(self, max_depth: int | None = None, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1, resume_from: str | None = None) -> CheckResult:
        """Check to ``max_depth`` (None: the fixpoint).  With
        ``checkpoint_dir`` (and ``checkpoint_every`` not 0) every committed
        level appends its delta record there, and the slab snapshot lands
        beside it at the dump cadence; ``resume_from`` (a checkpoint
        directory) continues the run its log records.  Raises
        ``resilience.Preempted`` at a level boundary after a preemption
        request."""
        self._audit_strikes, self._audit_strike_depth = 0, None
        try:
            return self._run(max_depth, checkpoint_dir, checkpoint_every, resume_from)
        finally:
            self._stop_prewarm()  # done, raised or preempted (bfs.py:4030-4038)

    def _run(self, max_depth, checkpoint_dir, checkpoint_every, resume_from) -> CheckResult:
        cfg, K = self.cfg, self.K
        t0 = time.monotonic()
        ck_on = bool(checkpoint_dir and checkpoint_every)
        if self.store_bytes and self.use_hashstore and (ck_on or resume_from):
            # the resume of a tiered run rebuilds the warm and cold tiers
            # from the log (bfs.py:3085-3110), which comes with the cold tier
            raise ValueError("checkpoints under a device budget (--dev-bytes) need the tiered "
                             "store's resume rebuild, which the port does not have yet")
        self._check_checkpoint_dirs(checkpoint_dir if ck_on else None, resume_from)
        self.tiered = (tiered.TieredVisitedStore(self.store_bytes)
                       if self.store_bytes and self.use_hashstore else None)
        budget = self.store_bytes if self.tiered is not None else self.dev_budget
        if budget:
            graft_obs.hbm_budget(budget)
        self._sieve_dev, self._sieve_ver, self.tier_soft_seats = None, -1, 0
        if resume_from is not None:
            ck = self._resume_from_deltas(resume_from)
            frontier, n_f, distinct, depth = ck["frontier"], ck["n_f"], ck["distinct"], ck["depth"]
            level_sizes, trace_levels = ck["level_sizes"], ck["trace_levels"]
            mult_per_slot = ck["mult_per_slot"]
            generated = int(mult_per_slot.sum())
        else:
            frontier, ovf0 = self.deflate(init_batch(cfg, 1, self.device))
            if bool(ovf0.any()):
                raise RuntimeError(f"initial state's message set exceeds cap_m={self.cap_m}")
            fv, _ff = self._fp_states(frontier)
            if self.host_store is not None:
                self.host_store.insert(fv.cpu().numpy().view(np.uint64))
            elif self.use_hashstore:
                self.hstore = DeviceHashStore.from_fps(
                    fv.cpu().numpy().view(np.uint64), device=self.device
                )
            else:
                # the root and 63 pads: sorted, as SENT sorts last (bfs.py:4216)
                self.visited = torch.cat([fv, torch.full((63,), SENT, dtype=I64,
                                                         device=self.device)])
            n_f, distinct, generated, depth = 1, 1, 0, 0
            level_sizes = [1]
            trace_levels = []  # (pidx, slot) per level
            mult_per_slot = np.zeros(K, np.int64)
            if int(self.inv_scan(frontier)) >= 0:
                name = self.bad_invariant_name(frontier, 0)
                return CheckResult(False, 1, 0, 0, (1,), (
                    f"Invariant {name} is violated", self.trace(trace_levels, 0, 0)))
            if self.host_store is not None:
                # the external store route's frontier is a segment list
                frontier = [Frontier(*(_pad_axis0(x, self.chunk) for x in frontier))]
        self._keep_frontier(frontier, n_f)
        self.trace_levels = trace_levels

        def commit_log(pidx, slot, fps, level_mult, n_new):
            """The committed level's delta record, and the slab snapshot at
            its cadence (bfs.py:5040-5096)."""
            if not ck_on:
                return
            self._save_delta(checkpoint_dir, depth, pidx, slot, fps, level_mult, n_new)
            every = hashstore.dump_interval(self.hstore.cap * 8) if self.use_hashstore else 0
            if every and depth % every == 0:
                self._dump_slab(checkpoint_dir, depth, distinct)
            if self.host_store is not None:
                # the level's partial records are superseded by its delta record
                self._wipe_partials(checkpoint_dir)

        def note(route):
            """The level committed: its ``level_commit`` event (bfs.py:4403,
            :4937) and its progress line."""
            self.routes[route] += 1
            graft_obs.level_commit(
                depth, n_f, distinct, generated,
                slab_cap=(self.hstore.cap if self.host_store is None and self.use_hashstore
                          and self.hstore is not None else 0))
            if self.progress is not None:
                self.progress(dict(level=depth, frontier=n_f, distinct=distinct,
                                   generated=generated, route=route,
                                   elapsed=time.monotonic() - t0))

        def between(frontier):
            """After every superstep and level, before the next: the presize,
            then the prewarm plan against the slab it left (bfs.py:4289-4324),
            so the plan's first program is captured while the loop commits."""
            if max_depth is None or depth < max_depth:
                self._presize_step(level_sizes, distinct, max_depth, depth)
                self._submit_prewarm(level_sizes, max_depth, frontier)

        # a stopped superstep routes its level once through the per-level
        # paths before supersteps engage again
        skip_superstep = False
        while n_f > 0:
            faults.fire("level.start")
            if resilience.preempt_requested():
                # every committed level's record is already durable
                raise resilience.Preempted(checkpoint_dir if ck_on else None, depth)
            if max_depth is not None and depth >= max_depth:
                break
            graft_obs.level_begin(depth + 1, n_f)
            self._hbm_note(frontier)
            self._tier_drain(depth, n_f)
            if (not skip_superstep and self._superstep_span_at(max_depth, depth) > 1
                    and self._mega_level_ok(n_f)):
                sres = self._run_superstep(frontier, n_f, max_depth, depth, level_sizes)
                frontier = sres["frontier"]
            else:
                sres = None
            if sres is not None and not sres.get("degraded"):
                hit_fixpoint = False
                depth0 = depth  # the window's entry, for the slab dump cadence
                for li, rec in enumerate(sres["recs"]):
                    if li:
                        faults.fire("level.start")  # once a level, as the staged loop
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
                    if ck_on:
                        self._save_delta(checkpoint_dir, depth, rec["pidx"], rec["slot"],
                                         rec["fps"], rec["mult"], n_f)
                graft_obs.superstep_commit(len(sres["recs"]), reason=sres["reason"])
                if sres["n_total"] or hit_fixpoint:
                    self.hstore.adopt(self.hstore.slab, sres["n_total"])
                    self._check_occupancy(sres["slab_live"])
                if ck_on and sres["recs"]:
                    # floor-crossing: any cadence point the window crossed
                    # earns the one end-of-window dump (bfs.py:4454-4470)
                    every = hashstore.dump_interval(self.hstore.cap * 8)
                    if every and depth // every > depth0 // every:
                        self._dump_slab(checkpoint_dir, depth, distinct)
                self._keep_frontier(frontier, n_f)
                if hit_fixpoint:
                    break
                skip_superstep = sres["reason"] == "stop" or (
                    sres["reason"] == "ring" and not sres["recs"])
                if sres["reason"] == "stop":
                    frontier = self._grow_for_stop(sres["flags"], frontier, depth, n_f)
                between(frontier)
                continue
            # a superstep that degraded to the sorted store runs its level per level
            skip_superstep = False
            mres = None
            t_level, reads0 = time.perf_counter(), sum(READS.values())
            if self._mega_level_ok(n_f):
                mres = self._expand_level_mega(frontier, n_f, max_depth, level_sizes)
                frontier = mres["parent"]
                if mres.get("degraded"):
                    mres = None  # the slab failed to grow: the level is redone below
                else:
                    res = dict(n_new=mres["n_new"], abort_at=mres["abort_at"],
                               mult=mres["level_mult"], slab_live=mres["slab_live"])
                    route = "fused"
            if self.host_store is not None:
                res, frontier = self._expand_level_host_redo(
                    frontier, n_f, depth, checkpoint_dir if ck_on else None)
                route = "host"
            elif mres is None and self._grouping(n_f):
                launches0 = self.graph_stats["group_launches"]
                res, frontier = self._expand_level_grouped(frontier, n_f, depth)
                route = "grouped"
            elif mres is None:
                res, frontier = self._expand_level_staged(frontier, n_f, depth)
                route = "staged"
            if res["abort_at"] < n_f:
                return CheckResult(
                    False, distinct, generated, depth, tuple(level_sizes),
                    ('Assert "split brain" (Raft.tla:185)',
                     self.trace(trace_levels, depth, res["abort_at"])),
                )
            res_mult = res["mult"]
            mult_per_slot = mult_per_slot + res_mult
            generated += int(res_mult.sum())
            n_new = res["n_new"]
            if n_new == 0:
                if self.host_store is not None and ck_on:
                    # the empty level's partials have no delta record to supersede them
                    self._wipe_partials(checkpoint_dir)
                break
            if mres is not None:
                new_frontier, bad_idx = mres["new_frontier"], mres["bad_idx"]
                pidx, slot, fps_lvl = mres["pidx"], mres["slot"], mres["fps"]
            elif route == "host":
                # the survivors are host-side, ascending by payload
                t_mat = time.perf_counter()
                pay_np = res["new_payload"]
                new_frontier, bad_idx, frontier = self._materialize_grow_segs(
                    frontier, pay_np, n_new)
                self.host_stats["materialize_s"] += time.perf_counter() - t_mat
                pidx, slot = pay_np // K, pay_np % K
                fps_lvl = res["new_fps"]
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
                split = "pidx" in res
                if split:
                    want = [res["pidx"][:n_new], res["slot"][:n_new]]
                else:
                    want = [res["new_payload"][:n_new]]
                want_fps = self._tier_active() or bool(self.audit) or ck_on
                if want_fps:
                    want.append(res["new_fps"][:n_new])
                got = fetch(*want, what="staged_trace")
                if split:
                    pidx, slot = got[0].view(np.uint32).copy(), got[1].view(np.uint16).copy()
                else:
                    pidx, slot = np.divmod(got[0], K)
                fps_lvl = got[-1].view(np.uint64) if want_fps else None
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
                        fps_lvl = np.asarray(fps_lvl)[:len(keep)][keep]
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
            parent_prev = frontier if self.audit else None
            frontier = new_frontier
            if faults.fire_flag("tensor.flip") and not isinstance(frontier, list):
                # injected silent corruption after materialize: the recorded
                # fingerprints disagree with the row from here on
                frontier = self._flip_frontier_row(frontier)
            trace_levels.append((pidx, slot))
            distinct += n_new
            level_sizes.append(n_new)
            depth += 1
            if self.host_store is not None:
                pass  # the level's insert into the external store is done
            elif not self.use_hashstore:
                self._merge_level(res["new_fps"], n_new, distinct)
            else:
                self.hstore.adopt(self.hstore.slab, n_store)
                if route != "staged":
                    self._check_occupancy(res["slab_live"])
                res = None  # a staged level's holds the slab: no reference through a grow
                if self.hstore.need_grow(extra=2 * n_new) or (
                        self._tier_on() and self.hstore.count > 0
                        and not self.tiered.slab_fits(self.hstore.cap)):
                    # the level is committed: a failed grow degrades before
                    # the next (bfs.py:4903-4909)
                    self._grow_or_degrade(
                        lambda: self._slab_grow_or_demote(depth, expected=2 * n_new), depth,
                        "between levels")
            n_f = n_new
            self._keep_frontier(frontier, n_f)
            note(route)
            if bad_idx >= 0:
                if isinstance(frontier, list):
                    name = self.bad_invariant_name(self._seg_row(frontier, bad_idx), 0)
                else:
                    name = self.bad_invariant_name(frontier, bad_idx)
                return CheckResult(
                    False, distinct, generated, depth, tuple(level_sizes),
                    (f"Invariant {name} is violated", self.trace(trace_levels, depth, bad_idx)),
                )
            if self.audit and n_new:
                # before the level would commit (bfs.py:5009-5032)
                problems = self._audit_level(parent_prev, frontier, pidx, slot, fps_lvl,
                                             n_new, depth)
                graft_obs.audit(depth, min(self.audit, n_new), len(problems or []))
                if problems:
                    return self._audit_rewind(problems, depth, max_depth, checkpoint_dir,
                                              checkpoint_every)
            # only invariant-clean, audited levels reach the log: a resumed
            # run never re-checks its replayed frontier
            commit_log(pidx, slot, fps_lvl, res_mult, n_new)
            between(frontier)
        return CheckResult(
            True, distinct, generated, depth, tuple(level_sizes), None,
            self.layout.action_counts(mult_per_slot),
        )

    def _hbm_note(self, frontier) -> None:
        """The live device-memory gauge's frontier entry (the loop top, once
        a pass; bfs.py:2172): the bytes of the frontier's device buffers,
        from their shapes (host segments are host RAM).  One global read
        when telemetry is off."""
        if graft_obs.current() is None:
            return
        nbytes = 0
        for seg in frontier if isinstance(frontier, list) else [frontier]:
            if not isinstance(seg, _HostSeg):
                nbytes += sum(x.numel() * x.element_size() for x in seg)
        graft_obs.buffer("frontier", nbytes)

    def _keep_frontier(self, frontier, n_f: int) -> None:
        """The last committed level's rows: ``frontier`` (its first ``n_f``
        rows), or on the external store route ``frontier_segs``, the
        segment list."""
        if isinstance(frontier, list):
            self.frontier, self.frontier_segs = None, frontier
        else:
            self.frontier = mk.rows_of(frontier, 0, n_f)

    def _grow_cap_m(self, frontier: Frontier) -> Frontier:
        if self.cap_m >= self.uni.M:
            raise RuntimeError("message-set width exceeds the whole universe")
        self.cap_m = min(self.cap_m + 32, self.uni.M)
        self._redo("cap_m", self.cap_m)
        return self.widen(frontier)

