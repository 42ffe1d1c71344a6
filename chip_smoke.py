#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed as JSON lines:

1. build      — compile every CUDA kernel from tla_raft_tpu_torch/csrc
                (one nvcc per source, all at once);
2. staged     — the staged chain (``megakernel=False``) on the Raft.cfg
                constants (S=3, V=2, MaxElection=3, MaxRestart=3, symmetry +
                VIEW) to depth 20, every level held against the golden
                per-level counts and the depth-12 prefix against its golden
                generated count;
3. default    — the default path (supersteps of span 4, the per-level
                fused program for a stopped window, the grouped chain past
                the fused size limit: levels 23-25) on the same constants to
                depth 25, every level golden (48,760,187 distinct); then the
                per-level pidx/slot digests of its depth-20 prefix held
                against the staged phase's;
4. fixpoint   — (3,1,2,1) to its fixpoint on the default path: 180,582
                distinct, 747,500 generated, depth 35;
5. trace      — the median-bug mutation on (3,1,2,0), default path: the
                pinned violation depth, level sizes and counterexample;
6. drill      — (3,1,1,1) on the default path with every stop class forced
                (cap_x, slab, cap_m, ring, the frontier seat, K4's rounds
                budget) and the double-vote abort on (3,1,2,0): the counts
                never move;
7. grouped    — from a staged run's depth-22 frontier (5,099,018 parents),
                one level on the grouped chain and one on the ungrouped
                staged chain, each from a copy of the slab: the same n_new,
                new payloads and slab bytes;
8. tiered     — the reference constants to depth 22 on the default path
                under a 64 MiB hot-slab budget: every level golden, at least
                two demotions, the fused levels' in-graph sieve hits equal
                to the host SpillSieve's on the same fingerprints, revisits
                dropped from frontiers (drop_rows), and a level's fresh set
                seated past the budget (the soft overshoot);
9. scale      — the Raft.cfg constants at 5 servers to depth 16 (2,457,226
                distinct, 9,353,884 generated) and at 7 servers to depth 9
                (3,736 / 22,776) on the default path at the default chunk,
                every level golden; K3 (its tensor-core MMAs over P = 120
                and 5,040 permutations) fingerprints both, with its
                pair-block factored message part at 7 servers (int32
                message ids);
10. orbit     — orbit pruning (``orbit=True``, the reference's
                TLA_RAFT_ORBIT=1): the Raft.cfg constants at 7 servers to
                depth 15 (levels 0-9 golden, and every level and the
                generated count equal to a default-path run to the same
                depth, whose wall is printed beside), at 5 servers to depth
                16 and at 3 servers to depth 23 (level 23 on the grouped
                chain, the orbit op inside the group graph), every level
                golden; the per-level share of tied candidates of each run,
                the launches of orbit, orbit_fold and K3's factored mode,
                and the tied fold's device ms summed over each run (CUDA
                events around its launches; ``orbit_s7_walls``);
   Each of phases 2-11 sets every kernel's launch count to 0 just before it
   runs, prints the counts just after, and fails if a kernel of its path
   did not launch (the staged phase: the staged chain's eight; the default
   phase: every kernel but drop_rows, K3's factored mode, the orbit pair,
   the cross-check arms' three, the sorted store's three, the bucket
   core's three and group_unique; the tiered
   phase: the fused path's eleven and drop_rows; the
   grouped phase: the staged chain's, level, hs_probe and filter_compact;
   the scale phase: the fused path's eleven and K3's factored mode; the
   orbit phase: the staged chain's, the grouped level's, K3's factored
   mode, orbit and orbit_fold; the canon phase: dense_expand,
   chunk_compact, K2, superstep and the fused and grouped paths' tail
   kernels, with K1 never and K3 far less than dense_expand; the legacy
   phase: dense_expand, legacy_materialize, K3, superstep and the tail,
   with K1 and K2 never; the legacy fixpoint: the canon and legacy
   arms' kernels, K1 and K2 never; the audit phase: the legacy pair, the
   tail and K1, K2, K3; the flip drill: the legacy pair; the sorted and
   degrade phases: the sorted store's three, filter_compact and the eager
   chain's kernels, with K4, level, superstep and sieve never launched on
   the sorted phase; the fpstore phases: group_unique and the staged
   chain's kernels but K4, with K4, hs_probe, filter_compact, the fused
   level's, the sieve and the sorted store's three never launched; the
   cli, checkpoint, fpstore_kill and mesh_cli phases run in processes of
   their own; the default phase's list now holds insert_only (the slab's
   growth) and not route or route_back; the mesh phases: route,
   route_back, K1-K4 and group_unique (all_gather: sorted_member and
   merge_sorted, no route and no K4; the host stores: no K4), never the
   fused level's, the grouped level's, level_dedup, drop_rows or the
   bucket core's; the bucket phase: the three bucket kernels and the chain
   around them (dense_expand, chunk_compact, K4, the compactions,
   inflate, K2, inv_scan, the level and superstep control); the service
   phase: those and the fused path's eleven; the others: the fused
   path's eleven).  Every arm's run and every run beside it (the
   baselines, the fixpoint, the drill) is a phase of its own, so an
   arm's counts are its run's alone.  The
   default phase also prints graph launches and device-to-host reads per
   superstep and per fused level, each grouped level's reads, graph
   launches, K4 rounds, cap_g, lanes (against the ungrouped lane count)
   and seconds, the levels by route, the graph captures and their
   seconds, and peak device memory.
11. canon     — ``canon="expand"`` (every fan-out lane fingerprinted by
                the dense expand's delta hash, B18, then the chunk
                compaction, B3) on the Raft.cfg constants to depth 23 on
                the default routes (level 23 grouped), every level golden;
    canon_baseline — a default run to the same depth: golden, its wall,
                and its slab bytes and (pidx, slot) records equal to the
                canon run's;
    legacy    — ``use_mxu=False`` (the guards-only dense expand and the
                legacy per-lane materialize, B20) to depth 22, golden;
    legacy_baseline — a default run to depth 22 (its wall);
    legacy_fixpoint — canon="expand" with the legacy kernels on (3,1,2,1)
                to its fixpoint;
    audit     — ``audit=64`` to depth 20 (per-level fused levels), every
                level audited with no mismatch;
    audit_baseline — a default run to depth 20 (its wall);
    flip_drill — the tensor.flip drill on (3,1,1,1), which must stop
                with the CPU's message;
    sorted    — the sorted visited store (``use_hashstore=False``, the
                reference's ``--no-hashstore``) to depth 25, every level
                golden, levels 23-25 grouped (``group_filter``: sorted_member
                then the filter compaction), each level deduped by
                ``level_dedup`` and merged into the store by ``merge_sorted``;
                K4, the fused level and the supersteps never launched;
                ``level_dedup``'s launches equal to
                ``kernels.level_dedup_launches`` of each call's lanes (14 a
                call); its wall beside the default phase's to the same depth;
    degrade   — the default path to depth 23 with ``hashstore.grow:fail@1``:
                golden, the depth and route at which the slab's grow failed
                and the run turned onto the sorted store, and no captured
                program launched after it;
    cli       — ``python -m tla_raft_tpu_torch.check --config <Raft.cfg>
                --max-depth 20 --json`` in a subprocess, on a cfg file written
                from the Raft.cfg constants: golden;
    checkpoint — the delta log in CLI subprocesses: the Raft.cfg constants
                to depth 22 plain and with ``--checkpoint-dir`` (the
                checkpoint cost and the bytes written), killed by
                ``--fault delta.commit:kill@18`` (exit by SIGKILL) and
                resumed with ``--recover``: golden, every delta record equal
                to the clean run's, the slab snapshots' live sets equal; then
                ``--audit 64 --fault tensor.flip:flip@5`` with checkpoints to
                20: one rewind, golden;
    bucket    — the sweep service's batched core (B14: bucket_refine,
                bucket_tally, bucket_ctrl with the canon="expand" chain):
                (a) the Raft.cfg key, MaxRestart 0-3, to depth 20 (the
                MaxRestart-3 member golden), (b) (3,1,2) MaxRestart 0-3 to the
                fixpoint (MaxRestart 1 and 2 equal GOLDEN_FULL), (c) the
                double-vote pair; each bucket's wall, routes and captures;
    bucket_sequential — every member's sequential default-path run: equal
                to its bucket result, the walls beside the bucket's;
    service   — the Scheduler over the reference bench's 40-job synthetic
                queue plus a median-bug pair, batched and ``--no-batch``
                (jobs per hour of each; every job's counts equal; the pair's
                traces equal the sequential runs'), and the SIGKILL drill at
                the 4th bstate commit in ``service run --once`` subprocesses,
                then a converging second pass;
    fpstore   — the external store route (``--fpstore-dir``: the native
                store under build/smoke/, B19 ``group_unique`` per group of
                16 chunks, the level-wide choice and the store's filter on
                the host, segment-list frontiers) on the Raft.cfg constants
                to depth 26, every level golden (22,959,572 new at 26;
                71,719,759 distinct), the store holding every distinct state
                and spilling sorted runs to disk past its 64 MiB buffer, one
                read and, for a full group inside a segment, one graph
                launch a group, no device-store kernel launched; the wall and
                per-level seconds (the depth-25 wall beside the default
                phase's), peak device memory, host seconds by part (the
                groups on the card, the reads, the lexsort, the store's
                insert, the materialize walk), runs and bloom skips;
    fpstore_paged — the same route to depth 22 under TLA_RAFT_DEV_BYTES =
                1e9, with checkpoints: golden, segments paged out to host
                RAM, the per-level (pidx, slot) digests equal to the fpstore
                phase's;
    fpstore_kill — the route through the CLI to depth 22, killed by
                ``partial.commit:kill@N`` after the 6th partial of level 22,
                then ``--recover``: golden, the level's committed attempt
                loading the saved groups and expanding the rest, every delta
                record equal to the paged phase's, no partial left;
    mesh_baseline — the default path to depths 18 and 20, the witnesses of
                the mesh and mesh_hosted phases (their slabs' fingerprints);
    mesh      — the device mesh (parallel/sharded.py ``ShardedChecker``, its
                8 shards placed on the one card): all_to_all on the Raft.cfg
                constants to depth 20, every level golden (5,512,586
                distinct), ``generated`` equal to a default-path run to 20 in
                this process, the union of the 8 slab shards equal to that
                run's slab and each shard holding only its own fingerprints
                (fp % 8); the wall and per-level seconds, the last level's
                rows a shard (the skew), the exchange's copies a level,
                reactive grows, the final cap_x, cap_w and vcap, peak device
                memory (at most 60 GB and 120 s, or the depth comes down);
                route, route_back, K1-K4, group_unique launched, none of the
                single-device route's own kernels;
    mesh_exchange — the mesh phase's run again with CUDA events around every
                collective: the exchange's device milliseconds beside the
                wall;
    mesh_gather — all_gather on 4 shards to 18 (2,008,354 distinct),
                golden; no route, route_back or K4 launched;
    mesh_hosted — the host-store mode (one native store per owner under
                build/smoke/mesh_fps/) on 8 shards to 18, golden; the
                stores' sizes sum to distinct and each holds exactly the
                reachable fingerprints it owns; no K4 launched;
    mesh_trace — the median-bug mutation on (3,1,2,0) over 8 shards: the
                default path's verdict and counts, and the mesh's pinned
                counterexample (the reference mesh's);
    mesh_cli  — ``--mesh 1 --max-depth 16 --json`` in a subprocess, golden,
                then ``--mesh 2`` on the one card: nonzero, with the
                too-few-devices message;
    mesh_deep — the sharded deep sweep (``ShardedChecker(deep=True)``, 8
                shards on the card, one native store per owner under
                build/smoke/deep_fps/) at the default seg_rows (32,768),
                the hash sieve and the packed stream, to depth 22: every
                level golden (13,961,621 distinct), ``generated`` equal to
                a default-path run to 22 (mesh_baseline's third depth), each
                store holding exactly the fingerprints it owns, the sieve
                fired, exchanged bytes below raw and every level's reduction
                >= 1, at least three levels of more than one round; rounds a
                level, peak_dev_rows beside the largest level, the level
                seconds by part (phase 1, finalize and fetch, host inserts,
                phase 2, repack, sieve), the wall beside the fpstore phase's
                to 22, peak device memory; pack_deltas, deep_verdict,
                deep_repack, hs_probe, insert_only, route, route_back and
                the expand's kernels launched, K4, the fused level's,
                level_dedup, sieve_merge and the bucket core's never;
    mesh_deep_sorted — the sorted sieve with raw fetches to 20: golden,
                sieve_merge and sorted_member launched, insert_only, hs_probe
                and pack_deltas never;
    mesh_deep_nosieve — ``sieve=False`` to 18: golden, nothing sieved, no
                sieve kernel launched;
    mesh_deep_trace — the median-bug mutation on (3,1,2,0), deep, 8 shards
                at seg_rows 16: the pinned trace (the reference deep mesh's);
    mesh_deep_cli — ``--mesh 1 --mesh-deep --fpstore-dir D --max-depth 16
                --json`` in a subprocess: golden, with the Exchange lines;
12. twins     — one fused level and one superstep (two levels) on the
                card against the CPU twins from the same carried depth-9
                frontier and slab: every output equal;
13. kernels   — each kernel against its plain torch twin on the card, at
                the main path's shapes, with times, bounds and the launches
                of its phase (K1 also in the counted form every fused level
                launches, held against the twin's summed mult and first
                abort, and K2 at both of a fused level's passes: the
                chunk's candidates at cap_x and one 8-chunk survivor slice,
                ``k1k2_forms``, timed by CUDA-graph replay; drop_rows: the
                tiered phase; K3's factored
                mode: the scale phase; orbit and orbit_fold: the orbit
                phase, on a chunk of its 7-server run's last frontier,
                with K3's full fold of the same chunk timed beside;
                dense_expand and chunk_compact: the canon phase;
                bucket_refine, bucket_tally and bucket_ctrl: the bucket phase,
                at bucket (a)'s shapes (refine over one chunk of its depth-20
                frontier, tally and ctrl over one more bucket level's lane
                buffer from that frontier);
                legacy_materialize: the legacy phase; sorted_member,
                level_dedup and merge_sorted: the sorted phase, each on the
                inputs of its depth-25 call in a second sorted run that keeps
                only that level's; group_unique: the fpstore phase, on the
                lanes of level 25's last full group, and on a copy with SENT
                lanes and ties; route and route_back: the mesh phase, on one
                shard's lanes of its level 20, and on adversarial lanes;
                insert_only: a 2^24-entry slab rehashed into 2^25 slots,
                its launches the default phase's (the slab's growth);
                pack_deltas, deep_verdict, deep_repack: the mesh_deep
                phase, on its deepest level's inputs; sieve_merge: the
                mesh_deep_sorted phase, on mesh_deep's last round of
                candidates into a sorted sieve of its capacity; the rest:
                the default phase); then
                the kernels again at 5 and 7 servers on the scale runs'
                frontiers (K1 at K = 1,900 / 3,696, K2, inflate and deflate
                with int32 ids, K3 at P = 120 and factored at P = 5,040,
                inv_scan, K4, hs_probe, filter_compact, level control),
                and the cross-check arms' three (dense_expand both modes,
                chunk_compact, legacy_materialize) on a depth-20 chunk,
                all in one ``kernels`` line;
14. profile   — one deep level (2,150,466 parents) on the staged chain and
                as one fused-level graph, under torch.profiler: kernel time
                by name and the device's idle share.

Then the card's name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits nonzero and prints
no result; so does a machine without CUDA, or a directory without the
package.  The golden numbers are constants here: this script imports
nothing of the JAX package.
"""

from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import time

import numpy as np

GOLDEN_FULL_3121 = (180_582, 747_500, 35)
GOLDEN_LEVELS_REF = [
    1, 1, 3, 9, 22, 57, 136, 345, 931, 2468, 5881, 12505, 24705, 47599,
    91014, 169607, 301664, 511609, 839797, 1353766, 2150466, 3350017,
    5099018, 7596394, 11125029, 16077143,
]
GENERATED_AT_12 = 112_939
MEDIAN_BUG = dict(
    depth=11,
    distinct=2556,
    generated=5912,
    level_sizes=(1, 1, 3, 6, 12, 21, 43, 93, 204, 398, 691, 1083),
    actions=[
        "Init", "BecomeCandidate(1)", "UpdateTerm(2)", "ResponseVote(2)",
        "BecomeCandidate(2)", "UpdateTerm(3)", "ResponseVote(3)",
        "BecomeLeader(1)", "BecomeLeader(2)", "ClientReq(1)",
        "LeaderCanCommit(1)", "UpdateTerm(1)",
    ],
    # sha256 of "\n".join(f"{action!r} {state!r}") over the trace steps
    trace_sha256="bacbf70789c240c765b1b5a4220d64ca33bc919f3232d9814244f10f4632c757",
)
DEPTH = 20  # of the staged reference prefix
DEPTH_DEFAULT = 25  # of the default path's reference prefix
DEPTH_GROUPED = 22  # the grouped phase's parents: the depth-22 frontier
DEPTH_TIERED = 22
TIER_BYTES = 64 << 20  # the tiered phase's hot-slab budget
# the Raft.cfg constants at 5 and 7 servers, golden level by level
# (docs/BENCH_S5_r05.json(.log), docs/BENCH_S7_r05.json / BENCH_S7_r05b.log)
SCALE_GOLDEN = {
    5: dict(depth=16, distinct=2_457_226, generated=9_353_884, levels=[
        1, 1, 3, 9, 24, 66, 169, 401, 859, 1797, 4018, 10484, 30763, 90919, 250982, 629645,
        1437085]),
    7: dict(depth=9, distinct=3_736, generated=22_776, levels=[
        1, 1, 3, 9, 24, 66, 171, 418, 960, 2083]),
}
# the orbit phase's depths: 7 servers past the reference's record (depth 9)
# to 15, 5 servers to the scale cell's 16, 3 servers to 23 (level 23
# grouped)
ORBIT_DEPTHS = {7: 15, 5: 16, 3: 23}
DOUBLE_VOTE = dict(result=(False, 359, 707, 8),
                   trace_sha256="54144ebf556e93bb8f6c0f2eab315032283bd583ed12112600368de2d9e73662")
# the cross-check arms' depths: canon="expand" to 23 (level 23 grouped),
# the legacy kernels to 22, the audit to 20
DEPTH_CANON, DEPTH_LEGACY, DEPTH_AUDIT = 23, 22, 20
AUDIT_ROWS = 64
# the flip drill's stop on (3,1,1,1) under TLA_RAFT_FAULT=tensor.flip:flip@4,
# audit=8, chunk=64: the reference's message on the CPU, pinned by
# tests/test_torch_audit.py
FLIP_STOP = (
    "audit mismatch at level 5 with no checkpoint directory to rewind to — fail-stop; "
    "first problem: row 0: materialized frontier row re-fingerprints to 0x881833cfb10cf06 "
    "!= recorded 0x2083c782df2f3e63 (corrupted frontier tensor)")
# the sorted store's fallback drill: the default path to depth 23 (level 23
# grouped on the sorted store) with the first slab grow failing
DEPTH_DEGRADE = 23
# the checkpoint phase: the Raft.cfg constants to depth 22 through the CLI
DEPTH_CHECKPOINT = 22
# the external store route (--fpstore-dir): the Raft.cfg constants to depth
# 26, the port's first level past 25 (GOLDEN_LEVELS[(3,2,3,3)] at 26:
# 22,959,572 new, 71,719,759 distinct); paged and killed to 22
DEPTH_FPSTORE = 26
GOLDEN_LEVEL_26 = 22_959_572
DEPTH_FPSTORE_PAGED = 22
FPSTORE_DEV_BYTES = 1e9  # the paged phase's TLA_RAFT_DEV_BYTES: the deep levels page
FPSTORE_KILL_LEVEL = 22  # the kill lands in this level, after KILL_SAVED of its partials
FPSTORE_KILL_SAVED = 6
# the device mesh: D shards placed on the one card
MESH_SHARDS = 8
DEPTH_MESH = 20  # all_to_all, 5,512,586 distinct
MESH_GATHER_SHARDS, DEPTH_MESH_GATHER = 4, 18  # all_gather, 2,008,354 distinct
DEPTH_MESH_HOSTED = 18  # the per-owner external stores
DEPTH_MESH_CLI = 16
MESH_PEAK_BYTES = 60e9  # the mesh phase's reckoned ceiling of device memory
MESH_SECONDS = 120.0  # and of its wall
# the median-bug counterexample on 8 shards: the first owner's first bad row,
# as the reference's ShardedChecker finds it (not the single-device path's;
# tests/test_torch_sharded.py::test_median_bug_mesh_trace_equals_the_reference)
MESH_MEDIAN_BUG = dict(
    actions=["Init", "BecomeCandidate(1)", "UpdateTerm(2)", "ResponseVote(2)",
             "BecomeLeader(1)", "ClientReq(1)", "BecomeCandidate(2)", "UpdateTerm(3)",
             "ResponseVote(3)", "LeaderCanCommit(1)", "UpdateTerm(1)", "BecomeLeader(2)"],
    trace_sha256="90a7d2f9ddec41c7212959b1cad1c7ebc3e2fe2c85d8cf17ad4e2d0a46b7b97a",
)
# the sharded deep sweep (ShardedChecker(deep=True), --mesh-deep): 8 shards on the
# one card at the default seg_rows, the hash sieve and the packed stream to 22
# (13,961,621 distinct); the sorted sieve with raw fetches to 20, no sieve to 18,
# and --mesh 1 --mesh-deep through the CLI to 16
DEPTH_MESH_DEEP = 22
DEPTH_MESH_DEEP_SORTED = 20
DEPTH_MESH_DEEP_NOSIEVE = 18
DEPTH_MESH_DEEP_CLI = 16
MESH_DEEP_SECONDS = 120.0  # past it, mesh_deep's depth comes down to 21
# the median-bug counterexample of the deep mesh on 8 shards at seg_rows 16, computed
# from the reference's deep ShardedChecker on the CPU and pinned on its own: the owner
# keeps the least (fp_full, receive index) lane of a view, not the least (fp_full,
# payload) of the resident mesh (here the two traces happen to agree; tests/
# test_torch_deep.py::test_deep_median_bug_trace_is_the_pinned_one)
MESH_DEEP_MEDIAN_BUG = dict(
    seg_rows=16,
    actions=["Init", "BecomeCandidate(1)", "UpdateTerm(2)", "ResponseVote(2)",
             "BecomeLeader(1)", "ClientReq(1)", "BecomeCandidate(2)", "UpdateTerm(3)",
             "ResponseVote(3)", "LeaderCanCommit(1)", "UpdateTerm(1)", "BecomeLeader(2)"],
    trace_sha256="90a7d2f9ddec41c7212959b1cad1c7ebc3e2fe2c85d8cf17ad4e2d0a46b7b97a",
)
# TLC's Raft.cfg (the reference constants), for the cli phase's --config
RAFT_CFG = """CONSTANTS
    MaxTerm = 3
    MaxRestart = 3
    MaxElection = 3
    Follower = Follower
    Candidate = Candidate
    Leader = Leader
    None = None
    VoteReq = VoteReq
    VoteResp = VoteResp
    AppendReq = AppendReq
    AppendResp = AppendResp
    s1 = s1
    s2 = s2
    s3 = s3
    Servers = {s1, s2, s3}
    v1 = v1
    v2 = v2
    Vals = {v1, v2}

SYMMETRY symmServers

VIEW view

INIT Init
NEXT Next

INVARIANT
Inv
"""
WALLS: dict = {}  # seconds of the phases' runs, by phase
CHUNK = 16384  # parents per guard launch on the main path
SEED = 0  # of the random kernel inputs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate
INT8_TENSOR_OPS_PER_S = 1979e12


class Failed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed calls (CUDA
    events around each call, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, reps: int, inner: int = 20) -> float:
    """Median device milliseconds of one ``fn`` call: ``inner`` calls
    captured into one CUDA graph, replayed ``reps`` times between CUDA
    events, so no host gap between launches counts (``cuda_ms`` times one
    call from the host, which for a kernel of tens of microseconds is
    mostly the wrapper's own launch time)."""
    import torch

    from tla_raft_tpu_torch import kernels

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    tally = kernels.Tally()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    tally.take()  # a timing replay is not a launch of the main path
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del g
    return float(np.median(times))


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


# -- phases -------------------------------------------------------------------


def level_digests(chk) -> list:
    """sha256 of each level's (pidx, slot) records, in level order."""
    out = []
    for pidx, slot in chk.trace_levels:
        h = hashlib.sha256(np.asarray(pidx, np.int64).tobytes())
        h.update(np.asarray(slot, np.int64).tobytes())
        out.append(h.hexdigest())
    return out


def _reads_total(reads: dict, prefix: str = "") -> int:
    return sum(v for k, v in reads.items() if k.startswith(prefix))


def _run_reference(depth: int, chunk: int, **kw):
    """The reference constants to ``depth``: (checker, result, per-level
    progress records, seconds)."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    levels = []
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=chunk, progress=levels.append, **kw)
    D.READS.clear()
    kernels.K4_ROUNDS.clear()
    torch.cuda.reset_peak_memory_stats()
    WALLS["base_bytes"] = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    return chk, res, levels, time.perf_counter() - t0


def _common(res, levels, secs, depth):
    import torch

    gen12 = next((lv["generated"] for lv in levels if lv["level"] == 12), None)
    elapsed = [lv["elapsed"] for lv in levels]
    return dict(depth=res.depth, distinct=res.distinct, generated=res.generated,
                level_sizes=list(res.level_sizes), generated_at_12=gen12, seconds=secs,
                distinct_per_s=res.distinct / secs, peak_bytes=torch.cuda.max_memory_allocated(),
                run_peak_bytes=torch.cuda.max_memory_allocated() - WALLS.get("base_bytes", 0),
                level_seconds=[b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)])


def _check_golden(out: dict, res, depth: int) -> None:
    want = GOLDEN_LEVELS_REF[: depth + 1]
    check(res.ok, "reference run reported a violation")
    check(list(res.level_sizes) == want, f"level sizes {res.level_sizes} != golden {want}")
    check(depth < 12 or out["generated_at_12"] == GENERATED_AT_12,
          f"generated at depth 12: {out['generated_at_12']}")


def phase_staged(depth: int, chunk: int):
    """The staged chain to ``depth``: (checker, level digests)."""
    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels

    chk, res, levels, secs = _run_reference(depth, chunk, megakernel=False)
    reads = dict(D.READS)
    rounds = list(kernels.K4_ROUNDS)
    out = dict(phase="staged", **_common(res, levels, secs, depth),
               slab_rows=chk.hstore.cap, cap_x=chk.cap_x, cap_m=chk.cap_m, redos=chk.redos,
               routes=chk.routes, reads=reads,
               reads_per_level=_reads_total(reads) / max(res.depth, 1),
               k4_rounds_per_call=dict(max=max(rounds, default=0),
                                       mean=float(np.mean(rounds)) if rounds else 0.0,
                                       calls=len(rounds)))
    emit(out)
    _check_golden(out, res, depth)
    return chk, level_digests(chk)


def phase_default(depth: int, chunk: int):
    """The default path to ``depth``: level digests.  Steady state is one
    graph launch and one read per superstep and per fused level."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels

    chk, res, levels, secs = _run_reference(depth, chunk)
    reads = dict(D.READS)
    g, ss, mg = chk.graph_stats, chk._ss_stats, chk._mega_stats
    fused_runs = mg["levels"] + g["level_redo_launches"]
    rounds = chk.k4_round_log
    staged_rounds = list(kernels.K4_ROUNDS)
    staged_levels = chk.routes["staged"]
    out = dict(
        phase="default", **_common(res, levels, secs, depth),
        routes=chk.routes, superstep_stats=ss, mega_stats=mg, graph_stats=g, reads=reads,
        per_superstep=dict(graph_launches=g["superstep_launches"] / max(ss["supersteps"], 1),
                           reads=reads.get("superstep", 0) / max(ss["supersteps"], 1),
                           levels=ss["levels"] / max(ss["supersteps"], 1)),
        per_fused_level=dict(graph_launches=g["level_launches"] / max(mg["levels"], 1),
                             reads=reads.get("level", 0) / max(mg["levels"], 1),
                             runs=fused_runs),
        per_staged_level=dict(reads=(_reads_total(reads, "staged") + reads.get("k4_round", 0))
                              / max(staged_levels, 1), levels=staged_levels),
        k4_rounds_per_fused_level=dict(max=max(rounds, default=0),
                                       mean=float(np.mean(rounds)) if rounds else 0.0,
                                       budget=chk.k4_rounds),
        k4_rounds_per_staged_call=dict(max=max(staged_rounds, default=0),
                                       mean=float(np.mean(staged_rounds)) if staged_rounds
                                       else 0.0),
        route_seconds={r: sum(b["elapsed"] - a["elapsed"] for a, b in zip(
            [dict(elapsed=0.0)] + levels[:-1], levels) if b["route"] == r) for r in chk.routes},
        slab_rows=chk.hstore.cap, cap_x=chk.cap_x, cap_m=chk.cap_m,
        k4_rounds_log=rounds,
        grouped_levels=chk.group_log,
        program_cache_bytes=sum(p.nbytes() for p in chk._progs.progs.values()),
        memory_reserved=torch.cuda.memory_reserved(),
    )
    emit(out)
    WALLS["default"] = secs
    chk._progs.clear()  # free the captured programs' buffers for the phases after
    _check_golden(out, res, depth)
    # every level past the fused limit ran grouped: one graph launch per
    # group and attempt, one control read per attempt, then the materialize
    # and trace reads (none per K4 claim round; the slab's growth between
    # levels is not the level's)
    past = [n for n in res.level_sizes[:-1] if -(-n // chunk) > 16 * chk.G]
    check(chk.routes["grouped"] == len(past),
          f"levels past the fused limit {len(past)}, grouped {chk.routes['grouped']}")
    for lv in chk.group_log:
        attempts = lv["graph_launches"] // lv["groups"]
        check(lv["graph_launches"] == attempts * lv["groups"] and lv["reads"] == attempts + 2,
              f"grouped level {lv['level']}: {lv}")
    # one graph launch per superstep and per fused level run; one read each
    check(g["superstep_launches"] == ss["supersteps"] == reads.get("superstep", 0),
          f"supersteps {ss['supersteps']}: graph launches {g['superstep_launches']}, "
          f"reads {reads.get('superstep', 0)}")
    check(g["level_launches"] == fused_runs == reads.get("level", 0),
          f"fused levels {mg['levels']} + redos {g['level_redo_launches']}: graph launches "
          f"{g['level_launches']}, reads {reads.get('level', 0)}")
    return level_digests(chk)


def phase_grouped(depth: int, chunk: int) -> None:
    """One level past the fused limit from a staged run's depth-22 frontier
    on the grouped chain and on the ungrouped staged chain, each from a
    copy of the run's slab: the same n_new, new payloads and slab bytes."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch.ops import hashstore as hs

    chk, res, _levels, secs = _run_reference(depth, chunk, megakernel=False)
    check(list(res.level_sizes) == GOLDEN_LEVELS_REF[: depth + 1], "grouped phase: staged run")
    fr, n = chk.frontier, chk.frontier.voted_for.shape[0]
    base = (chk.hstore.slab.clone(), chk.hstore.cap, chk.hstore.count)
    outs, rows = {}, []
    for route in ("grouped", "staged"):
        chk.hstore = hs.DeviceHashStore(base[1], base[2], "cuda")
        chk.hstore.slab = base[0].clone()
        D.READS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "grouped":
            out, _fr = chk._expand_level_grouped(fr, n, depth)
        else:
            out, _fr = chk._expand_level_staged(fr, n, depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_new = out["n_new"]
        outs[route] = (n_new, out["new_payload"][:n_new].clone(), chk.hstore.slab.clone())
        rows.append(dict(route=route, n_new=n_new, seconds=secs, reads=dict(D.READS),
                         slab_rows=chk.hstore.cap, cap_x=chk.cap_x, cap_g=chk.cap_g,
                         lanes=out.get("lanes"), k4_rounds=out.get("rounds")))
    g, st = outs["grouped"], outs["staged"]
    same = dict(n_new=g[0] == st[0], payloads=_equal(g[1], st[1]), slab=_equal(g[2], st[2]))
    emit(dict(phase="grouped", parents=n, routes=rows, equal=same))
    check(g[0] == GOLDEN_LEVELS_REF[depth + 1] and all(same.values()),
          f"grouped level differs from the ungrouped one: {same}, n_new {g[0]} / {st[0]}")

    # the whole grouped level (expand, tail, materialize, trace read), warm:
    # its budgets grown and its programs captured by the run above; the slab
    # is restored in place before each run, so no program is captured again
    from tla_raft_tpu_torch.device import fetch

    split = {}

    def level():
        chk.hstore.slab.copy_(base[0])
        t0 = time.perf_counter()
        out, _fr = chk._expand_level_grouped(fr, n, depth)
        t1 = time.perf_counter()
        new, _bad, _ovf = chk.materialize_level(fr, out["new_payload"], out["n_new"])
        t2 = time.perf_counter()
        fetch(out["pidx"][:out["n_new"]], out["slot"][:out["n_new"]], what="staged_trace")
        t3 = time.perf_counter()
        split.update(expand_and_insert=t1 - t0, materialize=t2 - t1, trace=t3 - t2)
        return out["n_new"]

    level()
    captures = chk.graph_stats["captures"]
    wall = wall_ms(level)
    timing = dict(split)
    D.READS.clear()
    n_new, pwall, busy, top = _profiled(level)
    emit(dict(phase="profile", path="grouped", parents=n, n_new=n_new, wall_ms=wall,
              host_seconds=timing, profiled_wall_ms=pwall, device_busy_ms=busy,
              device_idle_share=max(0.0, 1 - busy / wall), reads=_reads_total(D.READS),
              recaptures=chk.graph_stats["captures"] - captures, top=top))


def phase_tiered(depth: int, chunk: int, dev_bytes: int) -> None:
    """The default path to ``depth`` under a hot-slab budget of
    ``dev_bytes``: golden counts, demotions, the in-graph sieve hits of
    every fused level held against the host SpillSieve on its fresh
    fingerprints, and the soft overshoot."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    levels, sieve_rows = [], []
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=chunk, progress=levels.append,
                       store_bytes=dev_bytes)
    mega = chk._expand_level_mega

    def spy(*a, **k):
        mres = mega(*a, **k)
        if chk._tier_active():  # the graph probed the spill sieve's words
            sv = chk.tiered.spill_sieve
            sieve_rows.append(dict(
                level=len(a[3]), fresh=mres["n_new"], device_hits=mres["tier_hits"],
                host_hits=int(sv.contains(np.asarray(mres["fps"][:mres["n_new"]])).sum()),
                words=len(sv.words), words_set=int((sv.words != 0).sum())))
        return mres

    chk._expand_level_mega = spy
    D.READS.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = chk.tiered.stats
    out = dict(phase="tiered", **_common(res, levels, secs, depth), dev_bytes=dev_bytes,
               tiered=dict(st, generations=len(chk.tiered.gens)),
               soft_seats=chk.tier_soft_seats, routes=chk.routes, superstep_stats=chk._ss_stats,
               sieve_levels=sieve_rows, hot_count=chk.hstore.count,
               hot_occupancy=chk.hstore.occupancy(), slab_rows=chk.hstore.cap,
               drop_rows_launches=kernels.DROP_ROWS.launches)
    emit(out)
    chk._progs.clear()
    _check_golden(out, res, depth)
    check(st["demotions"] >= 2 and st["reheats"] == st["probe_hits"] > 0,
          f"tiered: demotions {st['demotions']}, hits {st['probe_hits']}, reheats {st['reheats']}")
    check(sieve_rows and all(r["device_hits"] == r["host_hits"] for r in sieve_rows)
          and any(r["words_set"] for r in sieve_rows),
          f"tiered: sieve hits on the card differ from the host mirror: {sieve_rows}")
    check(chk.tier_soft_seats > 0, "tiered: no level was seated past the budget")
    check(chk.hstore.occupancy() == chk.hstore.count, "tiered: hot count != slab occupancy")


def phase_scale() -> dict:
    """The Raft.cfg constants at 5 servers to depth 16 and at 7 servers to
    depth 9 on the default path (``TorchChecker`` at its default chunk),
    every level golden; K3 fingerprints both (P = 120, 5,040), with its
    factored message part at 7.  Returns the two checkers."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    runs, rows = {}, []
    for S, want in SCALE_GOLDEN.items():
        # the earlier phases' cached device blocks go back first: a graph
        # capture empties the allocator's cache, which would charge their
        # release to this run's first capture
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        release_s = time.perf_counter() - t0
        before = kernels.launch_counts()
        levels = []
        chk = TorchChecker(RaftConfig(n_servers=S), device="cuda", progress=levels.append)
        D.READS.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = chk.run(max_depth=want["depth"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = kernels.launch_counts()
        k3 = {k: after[k] - before[k] for k in ("fingerprint", "msg_hash_factored")}
        elapsed = [lv["elapsed"] for lv in levels]
        rows.append(dict(
            servers=S, depth=res.depth, distinct=res.distinct, generated=res.generated,
            level_sizes=list(res.level_sizes), seconds=secs, distinct_per_s=res.distinct / secs,
            peak_bytes=torch.cuda.max_memory_allocated(), K=chk.K, P=chk.fpr.P,
            M=chk.uni.M, id_dtype=str(chk.id_dtype), factored=chk.fpr.factored_msgs,
            chunk=chk.chunk, cap_x=chk.cap_x, cap_m=chk.cap_m, slab_rows=chk.hstore.cap,
            routes=dict(chk.routes), superstep_stats=dict(chk._ss_stats),
            mega_stats=dict(chk._mega_stats), reads=dict(D.READS), k3_launches=k3,
            captures=chk.graph_stats["captures"],
            capture_seconds=chk.graph_stats["capture_seconds"],
            capture_log=chk.graph_stats["capture_log"], cache_release_seconds=release_s,
            level_seconds=[b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)]))
        emit(dict(phase="scale", **rows[-1]))
        chk._progs.clear()  # the captured programs' buffers
        check(res.ok and list(res.level_sizes) == want["levels"]
              and (res.distinct, res.generated) == (want["distinct"], want["generated"]),
              f"S={S}: {res.level_sizes} {res.distinct} / {res.generated} != {want}")
        # every fingerprint from K3, with its factored part at S=7
        check(k3["fingerprint"] > 0
              and k3["msg_hash_factored"] == (k3["fingerprint"] if S == 7 else 0),
              f"S={S}: K3 launches {k3}")
        runs[S] = chk
    return runs


def _release_cache() -> float:
    """The earlier runs' cached device blocks back to the card (a graph
    capture would charge their release to a run's first capture): the
    seconds it took."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _orbit_run(S: int, depth: int, orbit: bool, tied_log: list | None = None):
    """The Raft.cfg constants at ``S`` servers to ``depth``, orbit pruning on
    or off (the default path): (checker, result, record).  With
    ``tied_log`` the orbit run's tied and live candidates are summed on the
    card per level, over every attempt of a level (in the group graphs
    too), and read once a level into it (the orbit wall includes those
    reads)."""
    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.ops.fingerprint import OrbitScratch

    release_s = _release_cache()
    levels = []
    acc = torch.zeros((2,), dtype=torch.int64, device="cuda")

    def progress(lv):
        levels.append(lv)
        if tied_log is not None:
            tied, live = (int(x) for x in acc.tolist())
            tied_log.append(dict(level=lv["level"], tied=tied, live=live,
                                 share=tied / max(live, 1)))
            acc.zero_()

    chk = TorchChecker(RaftConfig(n_servers=S), device="cuda", orbit=orbit, progress=progress)
    if tied_log is not None:
        fold = chk.fpr.orbit_chunk_fps

        def counted(children, cap_nd, cnt, **kw):
            if kw.get("scratch") is None:
                kw["scratch"] = OrbitScratch(children.msg_ids.shape[0], cap_nd, "cuda")
            out = fold(children, cap_nd, cnt, **kw)
            acc[0] += kw["scratch"].n_tied
            acc[1] += cnt
            return out

        chk.fpr.orbit_chunk_fps = counted
    # the tied fold's (K3's indexed mode) device time, summed over the run:
    # CUDA events around each launch outside a graph capture
    fold_events, fold_in_graphs = [], [0]
    real_fp = kernels.fingerprints

    def timed_fp(fpr, fr, **kw):
        if kw.get("idx") is None:
            return real_fp(fpr, fr, **kw)
        if torch.cuda.is_current_stream_capturing():
            fold_in_graphs[0] += 1
            return real_fp(fpr, fr, **kw)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_fp(fpr, fr, **kw)
        ev[1].record()
        fold_events.append(ev)
        return out

    before = kernels.launch_counts()
    D.READS.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels.fingerprints = timed_fp
    try:
        t0 = time.perf_counter()
        res = chk.run(max_depth=depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        kernels.fingerprints = real_fp
    fold_ms = sum(a.elapsed_time(b) for a, b in fold_events)
    after = kernels.launch_counts()
    elapsed = [lv["elapsed"] for lv in levels]
    rec = dict(servers=S, orbit=orbit, depth=res.depth, distinct=res.distinct,
               generated=res.generated, level_sizes=list(res.level_sizes), seconds=secs,
               distinct_per_s=res.distinct / secs, peak_bytes=torch.cuda.max_memory_allocated(),
               chunk=chk.chunk, cap_x=chk.cap_x, cap_nd=chk.cap_nd, cap_m=chk.cap_m,
               slab_rows=chk.hstore.cap, routes=dict(chk.routes), redos=dict(chk.redos),
               reads=dict(D.READS), grouped_levels=chk.group_log,
               captures=chk.graph_stats["captures"],
               capture_seconds=chk.graph_stats["capture_seconds"],
               cache_release_seconds=release_s, fold_device_ms=fold_ms,
               fold_timed_launches=len(fold_events), fold_graph_captures=fold_in_graphs[0],
               launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
               level_seconds=[b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)])
    return chk, res, rec


def phase_orbit() -> dict:
    """Orbit pruning on the staged and grouped chains: 7 servers to depth
    15 against the default path to the same depth (levels 0-9 golden), 5
    servers to depth 16 and 3 servers to depth 23, golden.  Returns the
    7-server orbit checker (the kernels phase's inputs)."""
    from tla_raft_tpu_torch import kernels

    out = {}
    for S, depth in ORBIT_DEPTHS.items():
        golden = GOLDEN_LEVELS_REF if S == 3 else SCALE_GOLDEN[S]["levels"]
        tied: list = []
        chk, res, rec = _orbit_run(S, depth, True, tied)
        rec["tied_per_level"] = tied
        emit(dict(phase="orbit", **rec))
        n_gold = min(depth, len(golden) - 1) + 1
        check(res.ok and list(res.level_sizes)[:n_gold] == golden[:n_gold]
              and res.depth == depth, f"orbit S={S}: levels {res.level_sizes} != golden")
        check(S != 5 or (res.distinct, res.generated) == (SCALE_GOLDEN[5]["distinct"],
                                                          SCALE_GOLDEN[5]["generated"]),
              f"orbit S=5: {res.distinct} / {res.generated}")
        L = rec["launches"]
        fp = L.get("fingerprint", 0)
        check(L.get("orbit", 0) > 0 and L.get("orbit_fold", 0) > 0 and fp == 1
              and L.get("msg_hash_factored", 0) == (L["orbit_fold"] + fp if S == 7 else 0),
              f"orbit S={S}: launches {L} (K3 only at the root, every fold factored at S=7)")
        # no fused level or superstep; the level kernel only as group control
        check(not L.get("superstep") and not L.get("sieve") and (S == 3 or not L.get("level")),
              f"orbit S={S}: a fused program ran {L}")
        if S == 3:
            check(chk.routes["grouped"] == 1 and chk.group_log[0]["level"] == 23
                  and chk.group_log[0]["parents"] == GOLDEN_LEVELS_REF[22],
                  f"orbit S=3: grouped levels {chk.group_log}")
        if S == 7:
            _c, want, base = _orbit_run(7, depth, False)
            base.pop("grouped_levels")
            emit(dict(phase="orbit_baseline", **base))
            check(list(want.level_sizes) == list(res.level_sizes)
                  and (want.distinct, want.generated) == (res.distinct, res.generated)
                  and want.action_counts == res.action_counts,
                  f"orbit S=7: {res.level_sizes} / {res.generated} != the default path's "
                  f"{want.level_sizes} / {want.generated}")
            emit(dict(phase="orbit_s7_walls", orbit_seconds=rec["seconds"],
                      default_seconds=base["seconds"], tied_share=[t["share"] for t in tied],
                      fold_device_ms=rec["fold_device_ms"],
                      fold_timed_launches=rec["fold_timed_launches"],
                      launches={k: rec["launches"].get(k, 0) for k in
                                ("orbit", "orbit_fold", "msg_hash_factored")}))
            out[7] = chk
        chk._progs.clear()
    return out


def phase_orbit_kernels(chk, launches: dict) -> list:
    """``orbit`` and K3's indexed mode (``orbit_fold``) against their twins
    on one chunk of candidates expanded from the 7-server orbit run's last
    frontier (the main path's shapes: chunk 2,048 parents, cap_x lanes),
    plus the whole chunk path and K3's full fold of the same lanes timed
    beside: (records, shapes)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops.fingerprint import OrbitScratch

    dev = torch.device("cuda")
    fr, mx, fpr, K, B = chk.frontier, chk.mx, chk.fpr, chk.K, chk.chunk
    part = Frontier(*(x[:B] for x in fr))
    nb = part.voted_for.shape[0]
    valid, _m, _a = mx.guards(chk.inflate(part))
    payload = (torch.arange(nb, device=dev)[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    cp, lane, _o = bfs.compact_payloads(valid.reshape(-1), payload, chk.cap_x)
    live = int(lane.sum())
    children = mx.materialize(part, torch.div(cp, K, rounding_mode="floor").clamp(0, nb - 1),
                              cp % K)[0]
    G = children.voted_for.shape[0]
    cnt = torch.tensor(live, device=dev)
    idb = children.msg_ids.element_size()
    row_b = _core_bytes(children) + idb * children.msg_ids.shape[1]
    lv = Frontier(*(x[:live] for x in children))
    out = []
    # orbit: every live row against the twin (on the card)
    outs = (torch.empty(G, dtype=torch.int64, device=dev), torch.empty(G, dtype=torch.int64,
                                                                         device=dev))
    disc = torch.empty(G, dtype=torch.bool, device=dev)
    rank = torch.empty(G, dtype=torch.int32, device=dev)
    kernels.orbit(fpr, children, out=outs, discrete=disc, rank=rank, cnt=cnt)
    pv, pf, pd, pr = fpr.state_fingerprints_orbit_plain(lv)
    check(_equal(outs[0][:live], pv) and _equal(outs[1][:live], pf) and _equal(disc[:live], pd)
          and _equal(rank[:live].long(), pr) and bool((outs[0][live:] == -1).all()),
          "orbit differs from its twin")
    ms = cuda_ms(lambda: kernels.orbit(fpr, children, out=outs, discrete=disc, rank=rank,
                                       cnt=cnt), 10)
    plain = wall_ms(lambda: fpr.state_fingerprints_orbit_plain(lv))
    F, f_pad, S, P, NP = fpr.spec.F, fpr.ktab["f_pad"], chk.cfg.S, fpr.P, fpr.NP
    ids = lv.msg_ids.long()
    n_ids = int((ids >= 0).sum())
    # the table entries this chunk reads: the plane rows of its ranks and one
    # message entry per distinct (id, rank) (16 B each), W once
    rk = rank[:live].long()
    ranks = int(torch.unique(rk).numel())
    keys = torch.where(ids >= 0, ids * P + rk[:, None], torch.full_like(ids, -1))
    entries = int(torch.unique(keys).numel()) - int(bool((keys < 0).any()))
    bytes_ = live * (row_b + 22) + ranks * 16 * f_pad + entries * 16 + 4 * fpr.orbit_tables[
        "w_cat"].numel()
    ops = live * (8 * F + 3 * 2 * S * (S - 1) * 12 + 2 * S * S) + 5 * n_ids
    rec = _entry(out, launches, kernels.ORBIT, ms, plain, bytes_, None, ops)
    tied = live - int(disc[:live].sum())
    rec.update(servers=S, lanes=live, set_ids=n_ids, tied=tied, distinct_ranks=ranks)
    # K3's indexed mode over the chunk's tied rows, and the whole chunk path
    scr = OrbitScratch(G, chk.cap_nd, dev)
    fpr.orbit_chunk_fps(children, chk.cap_nd, cnt, out=outs, scratch=scr)
    n_t = min(int(scr.n_tied), chk.cap_nd)
    rows = scr.idx[:n_t]
    sv, sf = fpr.state_fingerprints_plain(Frontier(*(x[rows] for x in children)))
    check(n_t > 0 and _equal(outs[0][rows], sv) and _equal(outs[1][rows], sf),
          f"orbit_fold differs from its twin ({n_t} tied rows)")
    fold_out = (outs[0].clone(), outs[1].clone())
    ms_f = cuda_ms(lambda: kernels.fingerprints(fpr, children, out=fold_out, idx=scr.idx,
                                                cnt=scr.n_tied), 10)
    tied_rows = Frontier(*(x[rows] for x in children))
    plain_f = wall_ms(lambda: fpr.state_fingerprints_plain(tied_rows))
    t_ids = int((tied_rows.msg_ids >= 0).sum())
    tab = fpr.ktab
    tab_b = tab["ct"].numel() + (tab["gt_eff"].numel() * 4 + tab["pperm"].numel()
                                 if fpr.factored_msgs else tab["msg_eff"].numel() * 4)
    int8_ms = 2 * n_t * f_pad * P * 16 / INT8_TENSOR_OPS_PER_S * 1e3
    add_ms = t_ids * P * 4 / INT_OPS_PER_S * 1e3
    rec_f = _entry(out, launches, kernels.ORBIT_FOLD, ms_f, plain_f,
                   n_t * (row_b + 8 + 16) + tab_b, None, ops_ms=int8_ms + add_ms)
    rec_f.update(servers=S, tied_rows=n_t, set_ids=t_ids, P=P)
    if fpr.factored_msgs:
        rec_f.update(_k3_design(fpr, tied_rows.msg_ids))
    chunk_ms = cuda_ms(lambda: fpr.orbit_chunk_fps(children, chk.cap_nd, cnt, out=outs,
                                                   scratch=scr), 10)
    k3 = (torch.empty(G, dtype=torch.int64, device=dev), torch.empty(G, dtype=torch.int64,
                                                                       device=dev))
    k3_ms = cuda_ms(lambda: kernels.fingerprints(fpr, children, out=k3, cnt=cnt), 3)
    return out, dict(servers=S, frontier_rows=fr.voted_for.shape[0], parents=nb, lanes=live,
                     cap_x=G, cap_nd=chk.cap_nd, tied=tied, orbit_chunk_path_ms=chunk_ms,
                     k3_full_fold_ms=k3_ms)


def _slab_digest(chk) -> str:
    from tla_raft_tpu_torch import carry

    return hashlib.sha256(carry.slab_to_numpy(chk.hstore.slab).tobytes()).hexdigest()


def phase_baseline(name: str, depth: int, chunk: int, arm: dict | None = None) -> dict:
    """The default path (canon="late", K1/K2) to ``depth``, golden, its
    wall beside an arm's (the arms' phases run after the default phase, so
    both find the kernels loaded).  With ``arm`` (the canon phase's
    result) the two slabs' bytes are equal (every fingerprint of the delta
    hash equals K3's of the whole state) and so are the per-level (pidx,
    slot) records."""
    import torch

    base, res, levels, secs = _run_reference(depth, chunk)
    out = dict(phase=name, **_common(res, levels, secs, depth), routes=base.routes)
    if arm is not None:
        out.update(slab_equal=_slab_digest(base) == arm["slab_digest"],
                   records_equal=level_digests(base) == arm["records"])
    base = None
    torch.cuda.empty_cache()
    emit(out)
    _check_golden(out, res, depth)
    if arm is not None:
        check(out["slab_equal"], "canon=expand slab bytes differ from the late run's")
        check(out["records_equal"],
              "canon=expand (pidx, slot) records differ from the late run's")
    return out


def phase_canon(depth: int, chunk: int) -> dict:
    """canon="expand" on the default routes to ``depth`` (supersteps, a
    fused level for a stopped window, level 23 grouped), every level
    golden.  K3 fingerprints only the root on this arm (its launch count
    is checked by ``canon_counts``); the slab digest and the records go to
    the baseline phase."""
    import torch

    chk, res, levels, secs = _run_reference(depth, chunk, canon="expand")
    out = dict(phase="canon", **_common(res, levels, secs, depth), routes=chk.routes,
               cap_x=chk.cap_x, redos=chk.redos)
    digest, records = _slab_digest(chk), level_digests(chk)
    chk = None
    torch.cuda.empty_cache()
    emit(out)
    _check_golden(out, res, depth)
    check(out["routes"]["grouped"] >= 1, "no grouped level on the canon arm")
    return dict(out, slab_digest=digest, records=records)


def canon_counts(c: dict) -> None:
    check(c["fingerprint"] * 10 < c["dense_expand"],
          f"K3 launched {c['fingerprint']} times beside {c['dense_expand']} dense expands")
    check(c["guards"] == 0, "K1 launched on the canon=expand arm")


def legacy_counts(c: dict) -> None:
    check(c["guards"] == 0 and c["materialize"] == 0,
          f"K1/K2 launched on the legacy arm: guards {c['guards']}, "
          f"materialize {c['materialize']}")


def phase_legacy(depth: int, chunk: int) -> dict:
    """use_mxu=False (the legacy per-lane kernels) on the default routes to
    ``depth``, golden (``legacy_counts``: K1 and K2 never launched)."""
    chk, res, levels, secs = _run_reference(depth, chunk, use_mxu=False)
    out = dict(phase="legacy", **_common(res, levels, secs, depth), routes=chk.routes)
    chk = None
    emit(out)
    _check_golden(out, res, depth)
    return out


def phase_legacy_fixpoint(chunk: int) -> dict:
    """canon="expand" with use_mxu=False on (3,1,2,1) to its fixpoint."""
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    t0 = time.perf_counter()
    r = TorchChecker(RaftConfig(3, 1, 2, 1), device="cuda", chunk=chunk, canon="expand",
                     use_mxu=False).run()
    out = dict(phase="legacy_fixpoint", config=[3, 1, 2, 1], distinct=r.distinct,
               generated=r.generated, depth=r.depth, seconds=time.perf_counter() - t0)
    emit(out)
    check((r.distinct, r.generated, r.depth) == GOLDEN_FULL_3121,
          f"canon=expand + legacy fixpoint {out}")
    return out


def phase_audit(depth: int, chunk: int, rows: int) -> dict:
    """audit=``rows`` on the default routes to ``depth`` (per-level fused
    levels: the audit turns supersteps off): golden, every level audited,
    no mismatch."""
    chk, res, levels, secs = _run_reference(depth, chunk, audit=rows)
    out = dict(phase="audit", **_common(res, levels, secs, depth), routes=chk.routes,
               audit_stats=dict(chk.audit_stats))
    chk = None
    emit(out)
    _check_golden(out, res, depth)
    a = out["audit_stats"]
    check(a["levels"] == depth and a["mismatches"] == 0 and a["rewinds"] == 0,
          f"audit stats {a}")
    check(out["routes"]["superstep"] == 0, "supersteps ran under the audit")
    return out


def phase_flip_drill() -> dict:
    """The tensor.flip drill on (3,1,1,1) with audit=8: it must stop at the
    CPU's level with the CPU's first problem."""
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.resilience import faults
    from tla_raft_tpu_torch.resilience.integrity import AuditFailStop

    stop = None
    faults.install("tensor.flip:flip@4")
    try:
        TorchChecker(RaftConfig(3, 1, 1, 1), device="cuda", chunk=64, audit=8).run()
    except AuditFailStop as e:
        stop = str(e)
    finally:
        faults.reset()
    out = dict(phase="flip_drill", flip_stop=stop)
    emit(out)
    check(stop is not None, "the flip drill did not stop the run")
    check(stop == FLIP_STOP, f"flip drill stop {stop!r} != the CPU's {FLIP_STOP!r}")
    return out


def sorted_counts(c: dict) -> None:
    check(c["hashstore"] == 0 and c["hs_probe"] == 0 and c["level"] == 0
          and c["superstep"] == 0 and c["sieve"] == 0,
          f"hash-store or fused kernels launched on the sorted store: hashstore "
          f"{c['hashstore']}, hs_probe {c['hs_probe']}, level {c['level']}, superstep "
          f"{c['superstep']}, sieve {c['sieve']}")


def phase_sorted(depth: int, chunk: int) -> dict:
    """The sorted visited store to ``depth`` (``sorted_counts``: no K4, no
    fused level, no superstep), golden, its wall and peak memory beside the
    default phase's: a plain run, nothing of it kept for the kernels'
    timings (``capture_sorted_inputs`` makes those in a run of its own)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs

    lanes, real = [], bfs.level_dedup

    def level_dedup(cv, *a):
        lanes.append(cv.shape[0])
        return real(cv, *a)

    before = kernels.launch_counts()["level_dedup"]
    bfs.level_dedup = level_dedup
    try:
        chk, res, levels, secs = _run_reference(depth, chunk, use_hashstore=False)
    finally:
        bfs.level_dedup = real
    dedup_launches = kernels.launch_counts()["level_dedup"] - before
    default = WALLS.get("default")
    out = dict(phase="sorted", **_common(res, levels, secs, depth), routes=chk.routes,
               cap_x=chk.cap_x, cap_g=chk.cap_g, redos=chk.redos,
               store_slots=chk.visited.shape[0], default_seconds=default,
               wall_ratio=secs / default if default else None, level_dedup_calls=len(lanes),
               level_dedup_launches=dedup_launches,
               level_dedup_launches_per_call=sorted({kernels.level_dedup_launches(n)
                                                     for n in lanes}))
    live = int((chk.visited != -1).sum())
    chk = None
    torch.cuda.empty_cache()
    emit(out)
    _check_golden(out, res, depth)
    check(live == res.distinct, f"the sorted store holds {live} fingerprints, not {res.distinct}")
    check(out["routes"]["grouped"] >= 1 and out["routes"]["staged"] >= 1
          and out["routes"]["superstep"] == out["routes"]["fused"] == 0,
          f"sorted store routes {out['routes']}")
    check(len(lanes) >= depth and dedup_launches == sum(kernels.level_dedup_launches(n)
                                                         for n in lanes),
          f"level_dedup: {dedup_launches} launches over {len(lanes)} calls, not "
          f"{kernels.level_dedup_launches(1)} a call")
    return out


def capture_sorted_inputs(depth: int, chunk: int) -> dict:
    """A second sorted-store run to ``depth`` that keeps the inputs of the
    last level's first ``group_filter`` call and of its ``level_dedup``
    and ``merge_sorted`` calls, and nothing of an earlier level: the
    kernels' timings at those shapes.  The level being expanded is one past
    the merges made so far (one merge a committed level)."""
    from tla_raft_tpu_torch.engine import bfs

    captured, merges = {}, [0]
    real = {n: getattr(bfs, n) for n in ("group_filter", "level_dedup", "merge_sorted")}

    def last() -> bool:
        return merges[0] == depth - 1

    def group_filter(*a):
        if last() and "group_filter" not in captured:
            captured["group_filter"] = a
        return real["group_filter"](*a)

    def level_dedup(*a):
        if last():
            captured["level_dedup"] = a
        return real["level_dedup"](*a)

    def merge_sorted(*a):
        if last():
            captured["merge_sorted"] = a
        merges[0] += 1
        return real["merge_sorted"](*a)

    bfs.group_filter, bfs.level_dedup, bfs.merge_sorted = group_filter, level_dedup, merge_sorted
    try:
        _chk, res, _levels, _secs = _run_reference(depth, chunk, use_hashstore=False)
    finally:
        for n, fn in real.items():
            setattr(bfs, n, fn)
    check(res.depth == depth and set(captured) == set(real),
          f"the capture run reached depth {res.depth} and kept {sorted(captured)}")
    return captured


def phase_degrade(depth: int, chunk: int) -> dict:
    """The default path to ``depth`` with the first slab grow failing
    (``hashstore.grow:fail@1``): golden; the run turned onto the sorted
    store where it failed, and no captured program was launched after."""
    from tla_raft_tpu_torch.resilience import faults

    faults.install("hashstore.grow:fail@1")
    try:
        chk, res, levels, secs = _run_reference(depth, chunk)
    finally:
        faults.reset()
    d = chk.degraded_at
    after = [lv["route"] for lv in levels[d:]] if d is not None else []
    out = dict(phase="degrade", **_common(res, levels, secs, depth), routes=chk.routes,
               degraded_at=d, degraded_site=chk.degraded_site, routes_after=sorted(set(after)),
               graph_launches=chk._graph_launches(),
               graph_launches_at_degrade=chk.graph_launches_at_degrade,
               store_slots=None if chk.visited is None else chk.visited.shape[0])
    chk = None
    emit(out)
    _check_golden(out, res, depth)
    check(d is not None, "the run did not degrade")
    check(out["graph_launches"] == out["graph_launches_at_degrade"],
          f"captured programs launched after the degrade: {out['graph_launches_at_degrade']} "
          f"-> {out['graph_launches']}")
    check(set(after) <= {"staged", "grouped"} and "grouped" in after,
          f"routes after the degrade: {after}")
    return out


def phase_cli(depth: int) -> dict:
    """``python -m tla_raft_tpu_torch.check --config Raft.cfg --max-depth
    depth --json`` in a subprocess, the cfg written under build/: golden."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    cfg = root / "build" / "smoke" / "Raft.cfg"
    cfg.parent.mkdir(parents=True, exist_ok=True)
    cfg.write_text(RAFT_CFG)
    rc, got, secs, err = _check_cli(["--config", str(cfg), "--max-depth", str(depth), "--json"])
    out = dict(phase="cli", rc=rc, seconds=secs, run_seconds=got.get("seconds"),
               config_line=got.get("_config_line"),
               **{k: got.get(k) for k in ("distinct", "generated", "depth", "level_sizes",
                                          "hashstore", "routes")})
    emit(out)
    check(rc == 0, f"the CLI exited {rc}: {err}")
    check(got["level_sizes"] == GOLDEN_LEVELS_REF[: depth + 1] and got["depth"] == depth,
          f"cli level sizes {got['level_sizes']}")
    check(out["config_line"] is not None and "S=3 V=2 MaxElection=3 MaxRestart=3"
          in out["config_line"], f"cli config line {out['config_line']}")
    return out


# -- slice 8: checkpoints, the bucket core, the sweep service ----------------------------


def _smoke_dir(name: str):
    """A fresh directory under build/smoke/ (gitignored) for a phase's files."""
    import shutil
    from pathlib import Path

    d = Path(__file__).resolve().parent / "build" / "smoke" / name
    shutil.rmtree(d, ignore_errors=True)
    d.parent.mkdir(parents=True, exist_ok=True)
    return d


def _check_cli(args: list, timeout: int = 600, env: dict | None = None):
    """``python -m tla_raft_tpu_torch.check args`` in a subprocess: (return
    code, its --json line or {}, process seconds, stderr tail)."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.check", *args],
                          capture_output=True, text=True, cwd=root, timeout=timeout,
                          env=dict(os.environ, **(env or {})))
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    got = {}
    if lines and lines[-1].startswith("{"):
        got = json.loads(lines[-1])
    # "Progress: level L, frontier F, distinct D, generated G, R states/s":
    # the run's elapsed seconds at each level are D / R
    got["_config_line"] = next((x for x in lines if x.startswith("Config ")), None)
    got["_elapsed"] = [int(x.split("distinct ")[1].split(",")[0])
                       / max(float(x.rsplit(", ", 1)[1].split(" ")[0].replace(",", "")), 1e-9)
                       for x in lines if x.startswith("Progress: level")]
    return proc.returncode, got, secs, proc.stderr[-1500:]


def _delta_arrays(d) -> dict:
    out = {}
    for f in sorted(d.glob("delta_*.npz")):
        with np.load(f) as z:
            out[f.name] = {k: z[k].copy() for k in z.files}
    return out


def _slab_live(d):
    """(depth, sorted live fingerprints) of a directory's hslab.npz."""
    with np.load(d / "hslab.npz") as z:
        slab, meta = z["slab"], z["meta"]
        return int(meta[1]), np.sort(slab[slab != np.uint64(0xFFFFFFFFFFFFFFFF)])


def phase_checkpoint(depth: int) -> dict:
    """The delta log on the card, in subprocesses of the CLI: a plain run to
    ``depth`` and a checkpointed one (the cost of checkpointing, the bytes
    written), a run killed by ``delta.commit:kill@18`` (it must die by
    SIGKILL) and its ``--recover`` to ``depth``: every run golden, every
    delta record's arrays equal to the clean run's, the last slab
    snapshots' live sets equal (and equal to the log's fingerprints); then
    ``--audit 64 --fault tensor.flip:flip@5`` with checkpoints to 20: one
    rewind, golden."""
    import signal

    a, b, c = _smoke_dir("ck_clean"), _smoke_dir("ck_kill"), _smoke_dir("ck_audit")
    base = ["--max-depth", str(depth), "--json"]
    runs = {}
    for name, args in (("plain", base), ("clean", base + ["--checkpoint-dir", str(a)]),
                       ("kill", base + ["--checkpoint-dir", str(b), "--fault",
                                        "delta.commit:kill@18"]),
                       ("resume", base + ["--checkpoint-dir", str(b), "--recover", str(b)])):
        rc, got, secs, err = _check_cli(args)
        el = got.get("_elapsed") or [0.0]
        runs[name] = dict(rc=rc, process_s=secs, run_s=got.get("seconds"),
                          first_level_s=el[0], levels_s=el[-1] - el[0],
                          routes=got.get("routes"), level_sizes=got.get("level_sizes"))
        want_rc = -signal.SIGKILL if name == "kill" else 0
        check(rc == want_rc, f"checkpoint {name}: exit {rc} (want {want_rc}): {err}")
        if name != "kill":
            check(got["level_sizes"] == GOLDEN_LEVELS_REF[: depth + 1],
                  f"checkpoint {name} level sizes {got['level_sizes']}")
    da, db = _delta_arrays(a), _delta_arrays(b)
    check(sorted(da) == sorted(db) and len(da) == depth, f"delta records {sorted(db)}")
    for name in da:
        for k, v in da[name].items():
            check(np.array_equal(v, db[name][k]) and v.dtype == db[name][k].dtype,
                  f"{name}:{k} differs after the kill and resume")
    (sa_d, sa), (sb_d, sb) = _slab_live(a), _slab_live(b)
    log_fps = np.concatenate([da[f"delta_{i:04d}.npz"]["fps"] for i in range(1, sa_d + 1)])
    check(sa_d == sb_d and np.array_equal(sa, sb), "the slab snapshots' live sets differ")
    check(len(sa) == sum(GOLDEN_LEVELS_REF[: sa_d + 1]) and np.isin(log_fps, sa).all(),
          "the slab snapshot does not hold the log's fingerprints")
    written = sum(f.stat().st_size for f in a.iterdir() if f.is_file())
    rc, got, secs, err = _check_cli(["--max-depth", "20", "--audit", "64", "--fault",
                                     "tensor.flip:flip@5", "--checkpoint-dir", str(c), "--json"])
    check(rc == 0, f"audit drill exit {rc}: {err}")
    check(got["level_sizes"] == GOLDEN_LEVELS_REF[:21], "audit drill not golden")
    check(got.get("audit", {}).get("rewinds") == 1, f"audit drill: {got.get('audit')}")
    out = dict(phase="checkpoint", depth=depth, runs=runs, delta_records=len(da),
               bytes_written=written, slab_snapshot_depth=sa_d,
               checkpoint_cost=runs["clean"]["levels_s"] / runs["plain"]["levels_s"],
               audit=dict(got["audit"], run_s=got.get("seconds"), process_s=secs))
    emit(out)
    return out


BUCKET_DEPTH = 20  # bucket (a): the Raft.cfg key, MaxRestart 0-3
GOLDEN_FULL_3122 = (223_437, 936_729, 36)
# the service phase's queue (synth_jobs(40, seed=1, mr_width=16, chunk=64) and the
# median-bug pair (3,1,2) MaxRestart {0,1}), job by job: (ok, distinct, generated,
# depth) from the reference package's JaxChecker runs of the same configs and caps
SERVICE_REF = [
    (True, 23, 34, 9), (True, 109, 145, 9), (True, 276, 1015, 18), (True, 203, 542, 16),
    (True, 14, 14, 6), (True, 181, 255, 9), (True, 545, 2028, 19), (True, 402, 1071, 17),
    (True, 39, 59, 9), (True, 1061, 2058, 22), (True, 128, 291, 9), (True, 21, 21, 6),
    (True, 50, 97, 12), (True, 37, 46, 6), (True, 128, 291, 9), (True, 21, 21, 6),
    (True, 50, 97, 12), (True, 181, 255, 9), (True, 128, 291, 9), (True, 402, 1071, 17),
    (True, 39, 59, 9), (True, 1061, 2058, 22), (True, 545, 2028, 19), (True, 136, 207, 9),
    (True, 14, 14, 6), (True, 1061, 2058, 22), (True, 545, 2028, 19), (True, 402, 1071, 17),
    (True, 50, 97, 12), (True, 1061, 2058, 22), (True, 27, 39, 6), (True, 402, 1071, 17),
    (True, 14, 14, 6), (True, 1061, 2058, 22), (True, 545, 2028, 19), (True, 402, 1071, 17),
    (True, 39, 59, 9), (True, 181, 255, 9), (True, 128, 291, 9), (True, 21, 21, 6),
    (False, 2556, 5912, 11), (False, 4204, 9717, 11),
]


def _bucket_groups():
    from tla_raft_tpu_torch.config import RaftConfig

    return {
        "a": ([RaftConfig(max_restart=m) for m in range(4)], [BUCKET_DEPTH] * 4),
        "b": ([RaftConfig(3, 1, 2, m) for m in range(4)], [None] * 4),
        "c": ([RaftConfig(3, 1, 2, m, mutations=("double-vote",)) for m in (0, 1)], [None] * 2),
    }


def _brief(r: dict) -> tuple:
    return (r["ok"], r["distinct"], r["generated"], r["depth"], tuple(r["level_sizes"]),
            r["violation"])


def phase_bucket(chunk: int):
    """BatchedChecker on the card, three buckets: (a) the Raft.cfg key with
    MaxRestart 0-3 to depth 20 (the MaxRestart-3 member golden), (b)
    (3,1,2) MaxRestart 0-3 to the fixpoint (MaxRestart 1 and 2 equal
    GOLDEN_FULL), (c) the double-vote pair (3,1,2) MaxRestart {0,1}, its
    split-brain stops.  Returns the results by group."""
    import torch

    from tla_raft_tpu_torch.service.bucket import BatchedChecker

    results = {}
    for name, (cfgs, depths) in _bucket_groups().items():
        torch.cuda.reset_peak_memory_stats()
        bc = BatchedChecker(cfgs, max_depths=depths, device="cuda", chunk=chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = bc.eng.graph_stats
        WALLS[f"bucket_{name}"] = wall
        emit(dict(phase="bucket", group=name, configs=[c.describe() for c in cfgs],
                  depth_caps=depths, wall_s=wall, stats=bc.stats,
                  graph_launches=dict(superstep=g["bucket_superstep_launches"],
                                      level=g["bucket_level_launches"]),
                  captures=g["captures"], capture_s=g["capture_seconds"],
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  results=[_brief(r)[:4] + (r["violation"],) for r in out]))
        results[name] = out
        bc = None
    a, b = results["a"], results["b"]
    check(list(a[3]["level_sizes"]) == GOLDEN_LEVELS_REF[: BUCKET_DEPTH + 1] and a[3]["ok"],
          f"bucket (a) MaxRestart 3: {a[3]['level_sizes']}")
    check((b[1]["distinct"], b[1]["generated"], b[1]["depth"]) == GOLDEN_FULL_3121,
          f"bucket (b) MaxRestart 1: {_brief(b[1])[:4]}")
    check((b[2]["distinct"], b[2]["generated"], b[2]["depth"]) == GOLDEN_FULL_3122,
          f"bucket (b) MaxRestart 2: {_brief(b[2])[:4]}")
    check(all(r["violation"] == 'Assert "split brain" (Raft.tla:185)' for r in results["c"]),
          "bucket (c): no split-brain stop")
    WALLS["bucket_a_results"] = results["a"]
    return results


def bucket_results_a() -> list:
    return WALLS["bucket_a_results"]


def phase_bucket_sequential(chunk: int, results: dict) -> dict:
    """Each bucket member's sequential default-path run on the card: equal
    to its bucket result config by config; the bucket walls beside the sum
    of their members'."""
    import torch

    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    out = {}
    for name, (cfgs, depths) in _bucket_groups().items():
        walls, rows = [], []
        for cfg, d in zip(cfgs, depths):
            chk = TorchChecker(cfg, device="cuda", chunk=chunk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = chk.run(max_depth=d)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rows.append((r.ok, r.distinct, r.generated, r.depth, tuple(r.level_sizes),
                         r.violation[0] if r.violation else None))
            del chk
        got = [_brief(r) for r in results[name]]
        check(got == rows, f"bucket ({name}) differs from its sequential runs: {got} != {rows}")
        out[name] = dict(bucket_s=WALLS[f"bucket_{name}"], sequential_s=sum(walls),
                         member_s=walls)
    emit(dict(phase="bucket_sequential", walls=out))
    return out


def phase_service(chunk: int) -> dict:
    """The port's Scheduler on the card over the reference bench's queue
    (``synth_jobs(40, seed=1, mr_width=16, chunk=64)``) plus the median-bug
    pair (3,1,2) MaxRestart {0,1}, drained batched and ``--no-batch``: jobs
    per hour of each; each arm on its own route (the batched one in one
    bucket a shape key and no job run alone, the other all jobs alone), no
    job ending in an error and only the pair failing; every job's (ok,
    distinct, generated, depth) equal to the reference's (``SERVICE_REF``)
    and its level sizes equal between the two arms; the pair's result.json
    traces equal to the sequential runs'; then the kill drill:
    ``run --once`` killed at its 4th bstate commit (SIGKILL), and a second
    pass that requeues, resumes and converges."""
    import os
    import signal
    from pathlib import Path

    from tla_raft_tpu_torch.check import run_check, trace_doc
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.service.bucket import bucket_key
    from tla_raft_tpu_torch.service.daemon import Scheduler
    from tla_raft_tpu_torch.service.queue import JobQueue
    from tla_raft_tpu_torch.service.synth import synth_jobs

    jobs = synth_jobs(40, seed=1, mr_width=16, chunk=64)
    pair = [RaftConfig(3, 1, 2, m, mutations=("median-bug",)) for m in (0, 1)]
    jobs = jobs + [(c, None, dict(chunk=64)) for c in pair]
    check(len(jobs) == len(SERVICE_REF), "service: the pinned counts do not cover the queue")
    n_keys = len({bucket_key(c) for c, _, _ in jobs})  # every key holds >= 2 jobs: 5 buckets
    arms = {}
    for arm in ("batched", "sequential"):
        q = JobQueue(str(_smoke_dir(f"service_{arm}")))
        jids = [q.submit(c, max_depth=d, options=o) for c, d, o in jobs]
        sched = Scheduler(q, batch=arm == "batched", device="cuda", out=sys.stderr)
        planned, singles = sched.plan(jids)
        t0 = time.perf_counter()
        stats = sched.run_once()
        wall = time.perf_counter() - t0
        res = [q.load_result(j) for j in jids]
        arms[arm] = dict(wall_s=wall, jobs_per_hour=len(jobs) / wall * 3600.0,
                         stats={k: stats[k] for k in ("jobs_done", "jobs_failed", "buckets",
                                                       "batched_jobs", "sequential_jobs",
                                                       "dispatches", "traces")},
                         results=res)
        check(all(r is not None for r in res), f"service {arm}: a job has no result")
        # every job ran on its arm's route: a bucket that failed on the card
        # degrades to sequential runs, which the stats would show
        st = arms[arm]["stats"]
        want = ((len(planned), len(jobs), 0) if arm == "batched" else (0, 0, len(jobs)))
        check((st["buckets"], st["batched_jobs"], st["sequential_jobs"]) == want
              and (arm == "sequential" or (len(planned) == n_keys and not singles)),
              f"service {arm}: routes {st}, planned {len(planned)} buckets")
        check((st["jobs_done"], st["jobs_failed"]) == (len(jobs) - 2, 2),
              f"service {arm}: done/failed {st}")
        errors = [i for i, r in enumerate(res) if str(r.get("violation") or "").startswith("error:")]
        check(not errors, f"service {arm}: jobs {errors} ended in an error")
        got = [(r["ok"], r["distinct"], r["generated"], r["depth"]) for r in res]
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, SERVICE_REF)) if g != w]
        check(not bad, f"service {arm}: jobs differ from the reference's counts: {bad[:4]}")
    keys = ("ok", "distinct", "generated", "depth", "level_sizes")
    for i, (rb, rs) in enumerate(zip(arms["batched"]["results"], arms["sequential"]["results"])):
        check({k: rb[k] for k in keys} == {k: rs[k] for k in keys},
              f"service job {i}: batched {rb} != sequential {rs}")
    for i, cfg in enumerate(pair):
        full = run_check(cfg, chunk=64, device="cuda")
        want = trace_doc(cfg, full["_res"].violation[1])
        for arm in arms:
            got = arms[arm]["results"][40 + i]
            check(got.get("trace") == want, f"service {arm}: median-bug MaxRestart {i} trace")
    # the kill drill (tests/test_service.py:297) in subprocesses
    root = _smoke_dir("service_kill")
    q = JobQueue(str(root))
    for m in (0, 1, 2):
        q.submit(RaftConfig(2, 1, 1, m), options=dict(chunk=64))
    here = Path(__file__).resolve().parent

    def service(*args, env=None):
        return subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.service", *args],
                              capture_output=True, text=True, cwd=here, timeout=600,
                              env=dict(os.environ, **(env or {})))

    p1 = service("run", "--root", str(root), "--once",
                 env={"TLA_RAFT_FAULT": "bstate.commit:kill@4"})
    check(p1.returncode == -signal.SIGKILL, f"kill drill: first pass exit {p1.returncode}: "
          f"{p1.stderr[-1500:]}")
    p2 = service("run", "--root", str(root), "--once", "--lease-ttl", "0.1")
    check(p2.returncode == 0, f"kill drill: second pass exit {p2.returncode}: {p2.stderr[-1500:]}")
    stats = json.loads(p2.stdout.strip().splitlines()[-1])
    golden = {0: (27, 11), 1: (50, 12), 2: (50, 12)}
    for jid in q.list_jobs():
        r = q.load_result(jid)
        check(r is not None and r["ok"] and (r["distinct"], r["depth"])
              == golden[q.job_cfg(jid).max_restart], f"kill drill job {jid}: {r}")
    out = dict(phase="service", jobs=len(jobs),
               arms={k: {kk: vv for kk, vv in v.items() if kk != "results"}
                     for k, v in arms.items()},
               kill_drill=dict(first_exit=p1.returncode, recovered=stats["recovered"],
                               counts=stats["counts"]))
    emit(out)
    return out


# -- slice 9: the external store route (--fpstore-dir) ------------------------------


def _golden_to(depth: int) -> list:
    return (GOLDEN_LEVELS_REF + [GOLDEN_LEVEL_26])[: depth + 1]


def host_counts(c: dict) -> None:
    never = ("hashstore", "hs_probe", "filter_compact", "level", "superstep", "sieve",
             "sorted_member", "level_dedup", "merge_sorted")
    check(all(c[k] == 0 for k in never),
          "device-store kernels launched on the external store route: "
          + str({k: c[k] for k in never if c[k]}))


def _fpstore_run(name: str, depth: int, chunk: int, dev_bytes: float = 0,
                 checkpoint: bool = False, keep_level: int | None = None):
    """The Raft.cfg constants to ``depth`` on the external store route (a
    native store under build/smoke/<name>/, ``TLA_RAFT_DEV_BYTES`` =
    ``dev_bytes`` while the checker is built): (checker, result, levels,
    seconds, the phase directory, the group program's lanes of the last
    full group of level ``keep_level``)."""
    import os

    import torch

    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.native import HostFPStore

    d = _smoke_dir(name)
    store = HostFPStore(str(d / "fps"))
    levels = []
    old = os.environ.pop("TLA_RAFT_DEV_BYTES", None)
    if dev_bytes:
        os.environ["TLA_RAFT_DEV_BYTES"] = repr(dev_bytes)
    try:
        chk = TorchChecker(RaftConfig(), device="cuda", chunk=chunk, progress=levels.append,
                           host_store=store)
    finally:
        os.environ.pop("TLA_RAFT_DEV_BYTES", None)
        if old is not None:
            os.environ["TLA_RAFT_DEV_BYTES"] = old
    kept = {}
    if keep_level is not None:
        real = chk._expand_level_host

        def expand(segs, n_f, ckdir, depth):
            res = real(segs, n_f, ckdir, depth)
            if depth + 1 == keep_level:
                prog = next(p for p in chk._progs.progs.values() if p.kind == "host_group")
                kept.update(cv=prog.cv.clone(), cf=prog.cf.clone(), cp=prog.cp.clone())
            return res

        chk._expand_level_host = expand
    D.READS.clear()
    torch.cuda.reset_peak_memory_stats()
    WALLS["base_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth, checkpoint_dir=str(d / "ck") if checkpoint else None)
    torch.cuda.synchronize()
    return chk, res, levels, time.perf_counter() - t0, d, kept


def _host_out(chk, res, levels, secs, depth) -> dict:
    hs = chk.host_stats
    st = chk.host_store
    return dict(
        **_common(res, levels, secs, depth), routes=chk.routes, cap_x=chk.cap_x,
        cap_m=chk.cap_m, redos=chk.redos, paged_out=chk.paged_out, dev_budget=chk.dev_budget,
        store=dict(entries=len(st), runs=st.num_runs, bloom_skips=st.bloom_skips),
        host_seconds={k: hs[k] for k in ("group_s", "fetch_s", "lexsort_s", "insert_s",
                                          "materialize_s")},
        groups=dict(all=hs["groups"], graph=hs["graph_groups"], chunks=hs["chunk_groups"],
                    saved=hs["saved_groups"]),
        candidates=hs["candidates"], unique=hs["unique"],
        graph_captures=chk.graph_stats["captures"],
        capture_seconds=chk.graph_stats["capture_seconds"],
        level_log=hs["level_log"])


def _check_host_run(out: dict, res, depth: int) -> None:
    want = _golden_to(depth)
    check(res.ok and list(res.level_sizes) == want,
          f"level sizes {list(res.level_sizes)} != golden {want}")
    check(out["store"]["entries"] == res.distinct,
          f"the external store holds {out['store']['entries']} fingerprints, not {res.distinct}")
    check(out["routes"]["host"] == depth and sum(out["routes"].values()) == depth,
          f"routes {out['routes']}")
    for lv in out["level_log"]:
        # one read a group (the level's materialize read comes after)
        check(lv["reads"] == lv["groups"] - lv["saved"],
              f"level {lv['level']}: {lv['reads']} reads for {lv['groups']} groups")
        check(lv["graph_launches"] == lv["graph_groups"],
              f"level {lv['level']}: {lv['graph_launches']} graph launches for "
              f"{lv['graph_groups']} program groups")


def phase_fpstore(depth: int, chunk: int) -> dict:
    """The external store route to ``depth``: golden level by level, the
    store holding every distinct state and spilling runs to disk past its
    64 MiB buffer, one read and (for a full group inside a segment) one
    graph launch a group; the wall and per-level seconds (the depth-25 wall
    beside the default phase's), peak device memory, the host seconds by
    part.  Keeps the lanes of level 25's last full group for the kernels
    line."""
    import torch

    chk, res, levels, secs, d, kept = _fpstore_run("fpstore", depth, chunk,
                                                   keep_level=min(25, depth))
    out = dict(phase="fpstore", **_host_out(chk, res, levels, secs, depth),
               wall_to_25=next((lv["elapsed"] for lv in levels if lv["level"] == 25), None),
               default_wall_to_25=WALLS.get("default"))
    digests = level_digests(chk)
    WALLS["fpstore_at"] = {lv["level"]: lv["elapsed"] for lv in levels}
    chk.host_store.close()  # its run files go with it
    chk = None
    torch.cuda.empty_cache()
    emit(out)
    _check_host_run(out, res, depth)
    check(out["store"]["runs"] >= 1, "the store never spilled a sorted run")
    check(out["groups"]["graph"] > 0 and out["paged_out"] == 0, f"groups {out['groups']}")
    check(set(kept) == {"cv", "cf", "cp"}, "no group program lanes kept at level 25")
    kept["level"] = min(25, depth)
    WALLS["fpstore"] = secs
    return dict(digests=digests, lanes=kept)


def phase_fpstore_paged(depth: int, chunk: int, digests: list) -> dict:
    """The external store route to ``depth`` under TLA_RAFT_DEV_BYTES =
    FPSTORE_DEV_BYTES, with checkpoints: golden, segments paged out to host
    RAM, the per-level (pidx, slot) digests equal to the fpstore phase's;
    its delta records are the kill phase's clean run."""
    import torch

    chk, res, levels, secs, d, _ = _fpstore_run("fpstore_paged", depth, chunk,
                                                dev_bytes=FPSTORE_DEV_BYTES, checkpoint=True)
    out = dict(phase="fpstore_paged", **_host_out(chk, res, levels, secs, depth))
    mine = level_digests(chk)
    chk.host_store.close()
    chk = None
    torch.cuda.empty_cache()
    emit(out)
    _check_host_run(out, res, depth)
    check(out["paged_out"] > 0, "no segment was paged out under the budget")
    check(digests is None or mine == digests[:depth],
          "the paged run's (pidx, slot) records differ from the fpstore phase's")
    return dict(ck=d / "ck", paged_out=out["paged_out"])


def phase_fpstore_kill(depth: int, clean) -> dict:
    """The external store route through the CLI: killed by
    ``partial.commit:kill@N`` (N: the FPSTORE_KILL_SAVED-th partial of level
    FPSTORE_KILL_LEVEL, each level writing one partial a group), then
    ``--recover``: golden, only the unsaved groups of that level expanded,
    every delta record equal to the paged phase's, no partial left."""
    import signal

    G, rows = 16, 16 * CHUNK
    groups = [-(-GOLDEN_LEVELS_REF[lv - 1] // rows) for lv in range(1, FPSTORE_KILL_LEVEL + 1)]
    check(groups[-1] > FPSTORE_KILL_SAVED, f"level {FPSTORE_KILL_LEVEL} has {groups[-1]} groups")
    n_kill = sum(groups[:-1]) + FPSTORE_KILL_SAVED
    d = _smoke_dir("fpstore_kill")
    base = ["--max-depth", str(depth), "--json", "--fpstore-dir", str(d / "fps"),
            "--checkpoint-dir", str(d / "ck")]
    rc, got, secs_kill, err = _check_cli(base + ["--fault", f"partial.commit:kill@{n_kill}"])
    check(rc == -signal.SIGKILL, f"fpstore kill: exit {rc} (want {-signal.SIGKILL}): {err}")
    left = sorted(p.name for p in (d / "ck").glob("partial_*.npz"))
    rc, got, secs, err = _check_cli(base + ["--recover", str(d / "ck")])
    check(rc == 0, f"fpstore recover: exit {rc}: {err}")
    hs = got.get("host_store", {})
    last = hs.get("last_level", {})
    out = dict(phase="fpstore_kill", kill_at_partial=n_kill, groups_per_level=groups,
               partials_at_kill=left, kill_process_s=secs_kill, resume_process_s=secs,
               resume_run_s=got.get("seconds"), last_level=last,
               groups_expanded_in_all_attempts=hs.get("groups"),
               groups_loaded_in_all_attempts=hs.get("saved_groups"),
               level_sizes=got.get("level_sizes"))
    emit(out)
    check(got["level_sizes"] == _golden_to(depth), f"fpstore recover level sizes {got}")
    check(len(left) == FPSTORE_KILL_SAVED
          and all(n.startswith(f"partial_{FPSTORE_KILL_LEVEL:04d}_") for n in left),
          f"partials at the kill: {left}")
    # the committed attempt of the resumed level loaded the saved groups and
    # expanded the rest (a fresh process's cap_x may overflow there first:
    # the redo loads the groups completed before the overflow too)
    check(last.get("level") == FPSTORE_KILL_LEVEL
          and last.get("saved", -1) >= FPSTORE_KILL_SAVED and last.get("groups") == groups[-1],
          f"the resumed level's committed attempt: {last}; want {FPSTORE_KILL_SAVED} of "
          f"{groups[-1]} groups loaded")
    check(not list((d / "ck").glob("partial_*.npz")), "partials left after the level")
    da, db = _delta_arrays(clean), _delta_arrays(d / "ck")
    check(sorted(da) == sorted(db) and len(da) == depth, f"delta records {sorted(db)}")
    for name in da:
        for k, v in da[name].items():
            check(np.array_equal(v, db[name][k]) and v.dtype == db[name][k].dtype,
                  f"{name}:{k} differs after the kill and resume")
    return out


def phase_host_kernels(lanes: dict, launches: dict, seed: int) -> list:
    """``group_unique`` against its twin on the lanes of level 25's last
    full group (G * cap_x = 1,048,576 lanes at the main path's chunk) and on
    a copy with a third of the lanes SENT and ties in fp_view with other
    fp_full and payloads, with times: the twin, the library (three stable
    ``torch.argsort``, the lexsort, then ``torch.masked_select`` of the
    first lanes), and the bound of 48 B a lane (each input read once, each
    output written once)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.u64 import SENT, ukey

    cv, cf, cp = lanes["cv"], lanes["cf"], lanes["cp"]
    n = cv.shape[0]
    k = bfs.group_unique(cv, cf, cp)
    p = bfs.group_unique_plain(cv, cf, cp)
    check(int(k[0]) == int(p[0]) and all(_equal(a, b) for a, b in zip(k[1:], p[1:])),
          "group_unique differs from its twin on level 25's lanes")
    n_u = int(k[0])
    # ties and SENT: a third SENT, the rest's fp_view drawn from 1,024 values
    gen = np.random.default_rng(seed)
    dev = cv.device
    tie_v = cv[torch.from_numpy(gen.integers(0, n, 1024)).to(dev)]
    av = tie_v[torch.from_numpy(gen.integers(0, 1024, n)).to(dev)]
    av = torch.where(torch.from_numpy(gen.random(n) < 1 / 3).to(dev), torch.full_like(av, SENT),
                     av)
    af = torch.from_numpy(gen.integers(-(1 << 62), 1 << 62, n)).to(dev)
    ap = torch.from_numpy(gen.integers(-1, 1 << 40, n)).to(dev)
    ka = bfs.group_unique(av, af, ap)
    pa = bfs.group_unique_plain(av, af, ap)
    check(int(ka[0]) == int(pa[0]) and all(_equal(a, b) for a, b in zip(ka[1:], pa[1:])),
          "group_unique differs from its twin with ties and SENT lanes")
    ties_u = int(ka[0])
    k = p = ka = pa = av = af = ap = None
    scratch = kernels.GroupUniqueScratch(n, dev)
    outs = tuple(torch.empty_like(cv) for _ in range(3))
    n_out = torch.empty((), dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: kernels.group_unique(cv, cf, cp, out=outs, n_u=n_out, scratch=scratch),
                 10)
    plain = wall_ms(lambda: bfs.group_unique_plain(cv, cf, cp))

    def library():
        order = torch.argsort(cp, stable=True)
        order = order[torch.argsort(ukey(cf[order]), stable=True)]
        order = order[torch.argsort(ukey(cv[order]), stable=True)]
        sv = cv[order]
        keep = torch.ones_like(sv, dtype=torch.bool)
        keep[1:] = sv[1:] != sv[:-1]
        keep &= sv != SENT
        return [torch.masked_select(x, keep) for x in (sv, cf[order], cp[order])]

    lib = cuda_ms(library, 5)
    out = []
    rec = _entry(out, launches, kernels.GROUP_UNIQUE, ms, plain, n * 48, lib)
    rec.update(lanes=n, n_u=n_u, ties_case_n_u=ties_u)
    return out


def phase_bucket_kernels(chunk: int, launches: dict) -> list:
    """bucket_refine, bucket_tally and bucket_ctrl against their twins on the
    card, at bucket (a)'s shapes: refine over chunks of its depth-20
    frontier's dense expand (16,384 x 696 lanes) that straddle a config
    boundary, one of them with a config done, tally and ctrl over the
    lane buffer of one more bucket level from that frontier (the widest:
    about 7.6 M parents), timed as the median of 10 CUDA-event calls.  The
    frontier comes from a second bucket (a) run on the per-level route,
    which keeps its depth-20 frontier (a superstep retires the capped
    members on the card and drops it)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.models.raft import RaftState, core_of
    from tla_raft_tpu_torch.service import bucket as bk

    cfgs, depths = _bucket_groups()["a"]
    bc = bk.BatchedChecker(cfgs, max_depths=depths, device="cuda", chunk=chunk, superstep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_level = bc.run()
    torch.cuda.synchronize()
    per_level_s = time.perf_counter() - t0
    check([r["level_sizes"] for r in per_level] == [r["level_sizes"] for r in
                                                     bucket_results_a()],
          "bucket (a) on the per-level route differs from the superstep route")
    eng, V, K, C = bc.eng, bc.vec, bc.K, bc.C_pad
    dev = torch.device("cuda")
    out = []
    n_run = bc.n_run
    # refine: chunks of real parents across a config boundary (a frontier's
    # rows are grouped by config), the first with no config done, the
    # second across the next boundary with the config below it done, as a
    # level's done1 has it; the first is timed
    chunk = eng.chunk
    z = lambda: torch.zeros((C,), dtype=torch.int64, device=dev)  # noqa: E731
    crow_all = bc.cur_crow[:n_run]
    edges = (torch.nonzero(crow_all[1:] != crow_all[:-1]).reshape(-1) + 1).tolist()
    check(bool(edges), "bucket_refine: the depth-20 frontier holds one config only")
    refine_cases = []
    for j, e in enumerate((edges + edges)[:2]):
        start = min(max(e - chunk // 2, 0), max(n_run - chunk, 0))
        part = mk.rows_of(bc.cur_fr, start, start + chunk)
        st = RaftState(msgs=eng.inflate(part).msgs, **core_of(part))
        valid, mult, fpv0, _fpf, abort = kernels.dense_expand(eng.dx, st, True)
        crow = bc.cur_crow[start:start + chunk].contiguous()
        done = z()
        if j:
            done[int(crow_all[e - 1])] = 1
        args = (valid, mult, abort, None, crow, part.restart_count.contiguous(), V.fam_rs,
                V.mr, V.salt, done)
        res = []
        for fn in (kernels.bucket_refine, bk.bucket_refine_plain):
            fpv, gen, ab = fpv0.clone(), z(), z()
            fn(*args[:3], fpv, *args[4:], gen, ab)
            res.append((fpv, gen, ab))
        check(all(torch.equal(x, y) for x, y in zip(*res)),
              f"bucket_refine differs from its twin on rows {start}+{chunk}")
        configs = sorted(set(crow.tolist()))
        check(len(configs) > 1 and int(res[0][1][configs[-1]]) > 0,
              f"bucket_refine rows {start}+{chunk}: configs {configs}, gen {res[0][1].tolist()}")
        refine_cases.append(dict(start=start, configs=configs, done=done.nonzero().reshape(-1)
                                 .tolist(), gen=res[0][1].tolist()))
        if j == 0:
            timed = (args, fpv0)
        else:
            del valid, mult, fpv0, _fpf, abort, res
    args, fpv0 = timed
    fpv, gen, ab = fpv0.clone(), z(), z()
    ms = cuda_ms(lambda: kernels.bucket_refine(*args[:3], fpv, *args[4:], gen, ab), 10)
    plain_ms = cuda_ms(lambda: bk.bucket_refine_plain(*args[:3], fpv, *args[4:], gen, ab), 10)
    lanes = chunk * K
    _entry(out, launches, kernels.BUCKET_REFINE, ms, plain_ms, lanes * 21 + chunk * 10 + K, None)
    del args, timed, fpv0, fpv
    # one bucket level from the depth-20 frontier: its lane buffer feeds tally and ctrl
    cap_in = max(1 << max(n_run - 1, 0).bit_length(), chunk)
    g_cap = 1 << 24
    from tla_raft_tpu_torch.ops import hashstore as hs

    held = int((bc.slab != -1).sum())
    need = hs.slab_rows(held + 4 * n_run, 0.25)
    if need > bc.slab.shape[0]:
        bc._grow_slab(need, held)  # room for the level's inserts at the bucket's load
    prog = bk.BucketLevelProgram(bc, ("kernels",), cap_in, g_cap)
    mk.copy_rows(prog.fr_in, bc.cur_fr, n_run)
    prog.crow_in[:n_run].copy_(bc.cur_crow[:n_run])
    V.upload(np.zeros(C, bool), np.zeros(C, np.int64), np.full(C, -1))
    prog.run(n_run)
    torch.cuda.synchronize()
    B, lc, bs = prog.B, prog.lc, prog.bs
    live, n_ins, n_g = int(lc[mk.LC_LIVE_LANES]), int(lc[mk.LC_N_NEW]), int(bs[bk.BS_NG])
    check(live > 0 and not int(lc[mk.LC_OVF_SLAB]), f"kernel level: live {live}, lc {lc.tolist()}")
    ring = torch.full((max(n_ins, 1),), -1, dtype=torch.int64, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    targs = (B.k4.fresh, B.cp, lc[mk.LC_LIVE_LANES], prog.crow_in, K, V.done1, V.abort)
    res = []
    for fn in (kernels.bucket_tally, bk.bucket_tally_plain):
        new_c, keep, rg = z(), torch.zeros_like(B.keep), ring.clone()
        fn(*targs, new_c, keep, B.ins_fps, lc[mk.LC_N_NEW], rg, off)
        res.append((new_c, keep, rg))
    check(all(torch.equal(x, y) for x, y in zip(*res)), "bucket_tally differs from its twin")
    new_c, keep = z(), torch.zeros_like(B.keep)
    ms = cuda_ms(lambda: kernels.bucket_tally(*targs, new_c, keep, B.ins_fps, lc[mk.LC_N_NEW],
                                              ring, off), 10)
    plain_ms = cuda_ms(lambda: bk.bucket_tally_plain(*targs, new_c, keep, B.ins_fps,
                                                     lc[mk.LC_N_NEW], ring, off), 10)
    fresh_lanes = B.k4.fresh[:live]
    cfg_of = prog.crow_in[torch.div(B.cp[:live][fresh_lanes], K, rounding_mode="floor")]
    lib_ms = cuda_ms(lambda: torch.bincount(cfg_of, minlength=C), 10)
    _entry(out, launches, kernels.BUCKET_TALLY, ms, plain_ms,
           live * 10 + n_run * 8 + n_ins * 16 + 4 * C * 8, lib_ms)
    # ctrl POST: the commit algebra of a 4-level superstep's first level and the gather
    meta = [torch.zeros((4, C), dtype=torch.int64, device=dev) for _ in range(3)] + [
        torch.zeros((4,), dtype=torch.int64, device=dev) for _ in range(2)]
    bs0 = bs.clone()
    bs0[bk.BS_LEVELS], bs0[bk.BS_OFF], bs0[bk.BS_RUNNING] = 0, 0, 1
    bs0[bk.BS_SPAN], bs0[bk.BS_RING] = 4, 1 << 40
    vec0 = [t.clone() for t in (V.done, V.done1, V.depth, V.cap, V.gen, V.new, V.abort)]
    crow_out = torch.zeros((g_cap,), dtype=torch.int64, device=dev)

    def ctrl(fn):
        bsx = bs0.clone()
        vs = [t.clone() for t in vec0]
        m = [t.clone() for t in meta]
        co = crow_out.clone()
        fn(bk.BC_POST, bsx, lc, prog.args, *vs, m, g_cap, prog.crow_in, co, B.surv_pay, K)
        return [bsx, *vs, *m, co]

    got, want = ctrl(kernels.bucket_ctrl), ctrl(bk.bucket_ctrl_plain)
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "bucket_ctrl differs from its twin")
    bsx = bs0.clone()
    vs = [t.clone() for t in vec0]

    def post(fn):
        bsx.copy_(bs0)  # the commit advances the words: each timed call starts from level 0
        fn(bk.BC_POST, bsx, lc, prog.args, *vs, meta, g_cap, prog.crow_in, crow_out, B.surv_pay,
           K)

    ms = cuda_ms(lambda: post(kernels.bucket_ctrl), 10)
    plain_ms = cuda_ms(lambda: post(bk.bucket_ctrl_plain), 10)
    m = min(n_g, g_cap)
    _entry(out, launches, kernels.BUCKET_CTRL, ms, plain_ms, m * 24 + 16 * C * 8, None)
    emit(dict(phase="bucket_kernels", parents=n_run, lanes=live, inserted=n_ins, survivors=n_g,
              refine_lanes=lanes, refine_cases=refine_cases, g_cap=g_cap,
              per_level_route_s=per_level_s,
              per_level_stats=bc.stats))
    prog.release()
    return out


def phase_sorted_kernels(launches: dict) -> list:
    """The sorted store's three kernels against their twins on the inputs
    of their depth-25 calls (``capture_sorted_inputs``), with times,
    bounds, twin and library times: ``sorted_member`` on one group's lanes
    against the depth-24 store (library: ``torch.searchsorted`` on
    sign-flipped keys; the bound counts at most one 32-byte sector of the
    store a lane, since a lane's search needs no more of it),
    ``level_dedup`` on level 25's grouped lanes (library: the three stable
    ``torch.argsort`` of the lexsort), ``merge_sorted`` of that store and
    level 25's survivors (library: ``torch.sort`` of the concatenation, sign
    flipped)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.u64 import ukey

    captured = capture_sorted_inputs(DEPTH_DEFAULT, CHUNK)
    out = []
    # sorted_member: one group of level 25 against the store after level 24
    cv, cf, cp, store, cap_g = captured.pop("group_filter")
    n, V = cv.shape[0], store.shape[0]
    hit = kernels.sorted_member(store, cv)
    check(_equal(hit, bfs.member_plain(store, cv)), "sorted_member differs from its twin")
    kg = bfs.group_filter(cv, cf, cp, store, cap_g)
    pg = bfs.group.filter_compact_plain(bfs.member_plain(store, cv), cv, cf, cp, cap_g)
    check(all(_equal(a, b) for a, b in zip(kg[:3], pg[:3])) and bool(kg[3]) == bool(pg[3]),
          "group_filter differs from its twin")
    ms = cuda_ms(lambda: kernels.sorted_member(store, cv), 10)
    plain = wall_ms(lambda: bfs.member_plain(store, cv))
    ks, kx = ukey(store), ukey(cv)
    lib = cuda_ms(lambda: torch.searchsorted(ks, kx), 10)
    rec = _entry(out, launches, kernels.SORTED_MEMBER, ms, plain, n * 9 + min(V * 8, n * 32),
                 lib)
    rec.update(lanes=n, store_slots=V, hits=int(hit.sum()))
    cv = cf = cp = store = kg = pg = hit = ks = kx = None
    # level_dedup: level 25's grouped lanes against the store after level 24
    cv, cf, cp, store = captured.pop("level_dedup")
    n, V = cv.shape[0], store.shape[0]
    k = bfs.level_dedup(cv, cf, cp, store)
    p = bfs.level_dedup_plain(cv, cf, cp, store)
    check(int(k[0]) == int(p[0]) and _equal(k[1], p[1]) and _equal(k[2], p[2]),
          "level_dedup differs from its twin")
    n_new = int(k[0])
    k = p = None
    before = kernels.launch_counts()["level_dedup"]
    bfs.level_dedup(cv, cf, cp, store)
    per_call = kernels.launch_counts()["level_dedup"] - before
    check(per_call == kernels.level_dedup_launches(n),
          f"level_dedup launched {per_call} kernels a call, not {kernels.level_dedup_launches(n)}")
    ms = cuda_ms(lambda: bfs.level_dedup(cv, cf, cp, store), 5)
    plain = wall_ms(lambda: bfs.level_dedup_plain(cv, cf, cp, store))

    def lexsort():
        order = torch.argsort(cp, stable=True)
        order = order[torch.argsort(ukey(cf[order]), stable=True)]
        return order[torch.argsort(ukey(cv[order]), stable=True)]

    lib = cuda_ms(lexsort, 5)
    rec = _entry(out, launches, kernels.LEVEL_DEDUP, ms, plain, n * 24 + V * 8 + n * 16, lib)
    # the design's own traffic: the keys read twice, the live pairs written,
    # 8 passes reading and writing 12 B a live pair, the heads' reads and
    # gathers (16 B a live lane) with one 32-B store sector a view, the
    # survivors' pack and the 16-B pad of every lane
    live = int((cv != -1).sum())
    views = int(torch.unique(cv[cv != -1]).numel())
    design = (16 * n + 12 * live + 8 * 24 * live + (12 + 16 + 1) * live + 32 * views
              + 3 * n_new * 16 + 16 * n)
    rec.update(lanes=n, store_slots=V, n_new=n_new, live_lanes=live, views=views,
               launches_per_call=per_call, design_bytes=design,
               design_ms_at_hbm=design / HBM_BYTES_PER_S * 1e3)
    cv = cf = cp = store = None
    # merge_sorted: the store after level 24 and level 25's survivor slice
    store, new, n_out = captured.pop("merge_sorted")
    A, B = store.shape[0], new.shape[0]
    m = bfs.merge_sorted(store, new, n_out)
    check(_equal(m, bfs.merge_sorted_plain(store, new, n_out)),
          "merge_sorted differs from its twin")
    m = None
    ms = cuda_ms(lambda: bfs.merge_sorted(store, new, n_out), 10)
    plain = wall_ms(lambda: bfs.merge_sorted_plain(store, new, n_out))
    both = torch.cat([ukey(store), ukey(new)])
    lib = cuda_ms(lambda: torch.sort(both), 10)
    rec = _entry(out, launches, kernels.MERGE_SORTED, ms, plain, (A + B + n_out) * 8, lib)
    rec.update(store_slots=A, new_lanes=B, n_out=n_out)
    return out


def phase_cross_kernels(chk, launches: dict, seed: int) -> list:
    """The cross-check arms' kernels against their twins on a depth-20
    chunk of parents (``chk``: the staged run's last frontier) and on
    seeded random inputs, with times, bounds, twin and library times:
    ``dense_expand`` with fingerprints and guards-only, ``chunk_compact``
    of its fan-out (and a forced overflow), ``legacy_materialize`` on the
    chunk's compacted candidates (and random lanes)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops.dense_expand import DenseExpand
    from tla_raft_tpu_torch.ops.successor import materialize_legacy_plain

    gen = np.random.default_rng(seed)
    dev = torch.device("cuda")
    fr, fpr, uni, cfg = chk.frontier, chk.fpr, chk.uni, chk.cfg
    n, K, B, G = fr.voted_for.shape[0], chk.K, chk.chunk, chk.cap_x
    dx = DenseExpand(cfg, uni, dev, fpr=fpr)
    real = _frontier_rows(fr, torch.arange(min(B, n), device=dev))
    st = chk.inflate(real)
    nb = real.voted_for.shape[0]
    core_b = _core_bytes(real)
    out = []

    def twin_blocks(fn, rows=2048):
        parts = [fn(type(st)(*(x[i:i + rows] for x in st))) for i in range(0, nb, rows)]
        return [torch.cat(z) if z[0] is not None else None for z in zip(*parts)]

    # dense_expand, both modes
    kv, km, kfv, kff, ka = dx.expand(st)
    pv, pm, pfv, pff, pa = twin_blocks(dx.expand_plain)
    ok = all(_equal(a, b) for a, b in ((kv, pv), (km, pm), (kfv, pfv), (kff, pff), (ka, pa)))
    gv, gm, ga = dx.guards(st)
    qv, qm, qa = twin_blocks(dx.guards_plain)
    ok &= _equal(gv, qv) and _equal(gm, qm) and _equal(ga, qa) and _equal(gv, kv)
    check(ok, "dense_expand differs from its twin")
    valid_n = int(kv.sum())
    ms = cuda_ms(lambda: dx.expand(st), 10)
    plain = wall_ms(lambda: twin_blocks(dx.expand_plain))
    in_b = nb * (core_b + uni.n_words * 4)
    # per valid lane: P permutations of (4 base words + the feature deltas and
    # added ids' mix32 coefficients): about 60 32-bit operations each
    rec = _entry(out, launches, kernels.DENSE_EXPAND, ms, plain, in_b + nb * K * 21,
                 None, nb * K * 40 + valid_n * fpr.P * 60)
    rec.update(mode="fingerprints", valid_lanes=valid_n)
    ms_g = cuda_ms(lambda: dx.guards(st), 10)
    plain_g = wall_ms(lambda: twin_blocks(dx.guards_plain))
    rec["guards_only"] = dict(ms=ms_g, plain_ms=plain_g,
                              bound_ms=max((in_b + nb * K * 5) / HBM_BYTES_PER_S * 1e3,
                                           nb * K * 40 / INT_OPS_PER_S * 1e3))

    # chunk_compact: the chunk's fan-out fingerprints to cap_x lanes, and a
    # random fan-out into a small cap (overflow)
    fvf, fff = kfv.reshape(-1), kff.reshape(-1)
    C = fvf.shape[0]
    rnd = torch.from_numpy(np.where(gen.random(C) < 0.01, gen.integers(0, 1 << 62, C), -1)).to(dev)
    ok = True
    for a_v, a_f, cap in ((fvf, fff, G), (rnd, rnd, 1024)):
        k = bfs.chunk_compact(a_v, a_f, cap, 7 * K)
        q = bfs.chunk_compact_plain(a_v, a_f, cap, 7 * K)
        ok &= all(_equal(x, y) for x, y in zip(k[:3], q[:3])) and bool(k[3]) == bool(q[3] > cap)
    check(ok, "chunk_compact differs from its twin")
    ms = cuda_ms(lambda: bfs.chunk_compact(fvf, fff, G, 7 * K), 10)
    plain = wall_ms(lambda: bfs.chunk_compact_plain(fvf, fff, G, 7 * K))
    pay = torch.arange(C, dtype=torch.int64, device=dev) + 7 * K
    live = fvf != -1
    lib = cuda_ms(lambda: (torch.masked_select(fvf, live), torch.masked_select(fff, live),
                           torch.masked_select(pay, live)), 10)
    rec = _entry(out, launches, kernels.CHUNK_COMPACT, ms, plain, C * 8 + valid_n * 8 + G * 24,
                 lib, C * 4)
    rec.update(lanes=C, live=valid_n)

    # legacy_materialize: the chunk's compacted candidates, and random lanes
    cp, lane, _o = bfs.compact_payloads(kv.reshape(-1), torch.arange(
        C, dtype=torch.int64, device=dev), G)
    lidx, slots = torch.div(cp, K, rounding_mode="floor").clamp(0, nb - 1), cp.clamp(min=0) % K
    cases = [(real, lidx, slots),
             (fr, torch.from_numpy(gen.integers(0, n, G)).to(dev),
              torch.from_numpy(gen.integers(0, K, G)).to(dev))]
    ok = True
    for par, pi, sl in cases:
        kc, ka2, ko = chk.materialize(par, pi, sl, legacy=True)
        pc, pa2, po = materialize_legacy_plain(cfg, par, pi, sl)
        ok &= all(_equal(x, y) for x, y in zip(kc, pc)) and _equal(ka2, pa2) and _equal(ko, po)
    check(ok, "legacy_materialize differs from its twin")
    ms = cuda_ms(lambda: chk.materialize(real, lidx, slots, legacy=True), 10)
    plain = wall_ms(lambda: materialize_legacy_plain(cfg, real, lidx, slots))
    cap_m = real.msg_ids.shape[1]
    row_b = core_b + 2 * cap_m
    _entry(out, launches, kernels.LEGACY, ms, plain, G * (2 * row_b + 16 + 4 * chk.mx.A + 1),
           None, G * (cap_m * 4 + 64))
    return out


# -- the device mesh --------------------------------------------------------------------


def _mesh_run(name: str, D: int, depth: int, chunk: int, **kw):
    """The Raft.cfg constants to ``depth`` on a ``ShardedChecker`` over D
    shards of the one card: (checker, result, progress records, seconds)."""
    import torch

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    levels = []
    chk = ShardedChecker(RaftConfig(), make_mesh(D, devices=["cuda"] * D), chunk=chunk,
                         progress=levels.append, **kw)
    check(all(d.type == "cuda" for d in chk.devices), f"{name}: a shard off the card")
    torch.cuda.reset_peak_memory_stats()
    WALLS["base_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    return chk, res, levels, time.perf_counter() - t0


def _mesh_out(name, chk, res, levels, secs, depth) -> dict:
    log = chk.level_log
    return dict(
        phase=name, shards=chk.D, exchange=chk.exchange, **_common(res, levels, secs, depth),
        last_level_rows=log[-1]["rows"] if log else None, straggler=chk.skew.summary(),
        exchange_copies_per_level=[lv["exchange_copies"] for lv in log],
        reactive_grows=chk.reactive_grows, cap_x=chk.cap_x, cap_w=chk.cap_w,
        vcap=chk.vcap if chk.use_hashstore else None,
        note="D shards on one card: the exchange is device-local copies; multi-GPU speed "
             "is not measured (the card's host has one GPU)")


def _mesh_golden(res, depth: int) -> None:
    want = GOLDEN_LEVELS_REF[: depth + 1]
    check(res.ok and list(res.level_sizes) == want,
          f"level sizes {list(res.level_sizes)} != golden {want}")


def phase_mesh_baseline(depths: tuple, chunk: int) -> dict:
    """Default-path runs to each of ``depths``, the mesh phases' witnesses:
    {depth: (result, the slab's live fingerprints, seconds)}."""
    import torch

    from tla_raft_tpu_torch.u64 import SENT

    out = {}
    for depth in depths:
        base, res, _levels, secs = _run_reference(depth, chunk)
        slab = base.hstore.slab
        out[depth] = (res, np.sort(slab[slab != SENT].cpu().numpy().view(np.uint64)), secs)
        base._progs.clear()
        base = slab = None
        torch.cuda.empty_cache()
        emit(dict(phase="mesh_baseline", depth=depth, distinct=res.distinct,
                  generated=res.generated, seconds=secs))
        _mesh_golden(res, depth)
    return out


def phase_mesh(depth: int, chunk: int, base: dict) -> dict:
    """all_to_all on 8 shards to ``depth``: golden level by level;
    ``generated`` equal to the default-path run to the same depth in this
    process (``base``), and the union of the 8 slab shards' live entries
    equal to that run's slab, each shard holding only the fingerprints it
    owns.  Keeps one shard's lanes of the last level (its routed
    candidates, their owners and ranks, and the verdict tiles returned to
    it) for the kernels line."""
    import torch

    kept = {}

    def wrap(chk):
        route, winners = chk._route_candidates, chk._winners

        def route_candidates(lanes):
            recv, meta, counts = route(lanes)
            kept.update(lanes=lanes[0], meta=meta[0])
            return recv, meta, counts

        def keep_winners(back, lanes, meta):
            kept["back"] = back[0]
            return winners(back, lanes, meta)

        chk._route_candidates, chk._winners = route_candidates, keep_winners

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    levels = []
    chk = ShardedChecker(RaftConfig(), make_mesh(MESH_SHARDS, devices=["cuda"] * MESH_SHARDS),
                         chunk=chunk, progress=levels.append)
    wrap(chk)
    torch.cuda.reset_peak_memory_stats()
    WALLS["base_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = _mesh_out("mesh", chk, res, levels, secs, depth)
    out["level_log"] = chk.level_log
    shards = chk.slab_contents()
    chk.slabs = None
    bres, live, bsecs = base[depth]
    out.update(default_seconds=bsecs, default_generated=bres.generated)
    emit(out)
    WALLS["mesh"] = secs
    _mesh_golden(res, depth)
    check(res.generated == bres.generated and res.distinct == bres.distinct,
          f"mesh generated {res.generated} / distinct {res.distinct}, default path "
          f"{bres.generated} / {bres.distinct}")
    for o, sh in enumerate(shards):
        check(bool((sh % np.uint64(MESH_SHARDS) == np.uint64(o)).all()),
              f"slab shard {o} holds a fingerprint it does not own")
    union = np.sort(np.concatenate(shards))
    check(np.array_equal(union, live),
          f"the slab shards hold {len(union)} fingerprints, not the default slab's {len(live)}")
    check(out["run_peak_bytes"] <= MESH_PEAK_BYTES and secs <= MESH_SECONDS,
          f"mesh phase: {out['run_peak_bytes']} B at peak, {secs:.1f} s (lower its depth)")
    check(set(kept) == {"lanes", "meta", "back"}, "no routed lanes kept")
    kept.update(D=MESH_SHARDS, cap_r=chk.cap_r, cap_w=chk.cap_w, level=depth)
    return kept


def phase_mesh_exchange(depth: int, chunk: int) -> dict:
    """The mesh phase's run again, with CUDA events around every collective
    (the tiles' all_to_all and all_gather, and the owners' concatenation of
    the shipped rows): the device milliseconds between each pair of events
    are the exchange's copies, set beside the run's wall (the events add no
    synchronization)."""
    import torch

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh
    from tla_raft_tpu_torch.parallel import mesh as meshlib
    from tla_raft_tpu_torch.parallel import sharded

    pairs = []

    def timed(fn):
        def wrapped(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            pairs.append((e0, e1))
            return out
        return wrapped

    saved = meshlib.all_to_all, meshlib.all_gather, sharded._cat_frontiers
    meshlib.all_to_all, meshlib.all_gather, sharded._cat_frontiers = (timed(f) for f in saved)
    try:
        chk = ShardedChecker(RaftConfig(), make_mesh(MESH_SHARDS,
                                                     devices=["cuda"] * MESH_SHARDS),
                             chunk=chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = chk.run(max_depth=depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        meshlib.all_to_all, meshlib.all_gather, sharded._cat_frontiers = saved
    ex_ms = sum(a.elapsed_time(b) for a, b in pairs)
    out = dict(phase="mesh_exchange", seconds=wall, exchange_device_ms=ex_ms,
               exchange_calls=len(pairs), exchange_share=ex_ms / 1e3 / wall)
    emit(out)
    _mesh_golden(res, depth)
    return out


def phase_mesh_gather(depth: int, chunk: int) -> dict:
    """all_gather on 4 shards to ``depth``: golden, no route and no K4."""
    chk, res, levels, secs = _mesh_run("mesh_gather", MESH_GATHER_SHARDS, depth, chunk,
                                       exchange="all_gather")
    out = _mesh_out("mesh_gather", chk, res, levels, secs, depth)
    out["store_slots"] = chk.visited[0].shape[0]
    emit(out)
    _mesh_golden(res, depth)
    return out


def mesh_gather_counts(c: dict) -> None:
    check(c["route"] == c["route_back"] == c["hashstore"] == 0,
          f"all_gather launched route {c['route']}, route_back {c['route_back']}, "
          f"hashstore {c['hashstore']}")


def phase_mesh_hosted(depth: int, chunk: int, base: dict) -> dict:
    """The host-store mode on 8 shards to ``depth`` (one native store per
    owner under build/smoke/mesh_fps/): golden; the stores' sizes sum to
    distinct, and each holds exactly the reachable fingerprints it owns
    (the default-path run's slab to the same depth, ``base``, probed in
    every store); the conservation checks pass every level (a failure
    raises)."""
    d = _smoke_dir("mesh_fps")
    chk, res, levels, secs = _mesh_run("mesh_hosted", MESH_SHARDS, depth, chunk,
                                       host_store_dir=str(d))
    out = _mesh_out("mesh_hosted", chk, res, levels, secs, depth)
    stores = chk.host_stores
    out.update(store_entries=[len(s) for s in stores], store_runs=[s.num_runs for s in stores],
               host_filter_seconds=chk.host_seconds,
               exchange_bytes=chk.meter.summary()["exchanged_bytes"])
    live = base[depth][1]
    emit(out)
    _mesh_golden(res, depth)
    check(sum(out["store_entries"]) == res.distinct == len(live),
          f"stores hold {sum(out['store_entries'])}, distinct {res.distinct}")
    for o, st in enumerate(stores):
        mine = live % np.uint64(MESH_SHARDS) == np.uint64(o)
        check(np.array_equal(st.contains(live), mine) and len(st) == int(mine.sum()),
              f"store {o} does not hold exactly the fingerprints it owns")
    for st in stores:
        st.close()
    return out


def phase_mesh_trace(chunk: int) -> None:
    """The median-bug mutation on (3,1,2,0) over 8 shards: the default
    path's violation, counts and level sizes, and the mesh's pinned trace
    (the reference mesh's: the first owner's first bad row)."""
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    cfg = RaftConfig(3, 1, 2, 0, mutations=("median-bug",))
    res = ShardedChecker(cfg, make_mesh(MESH_SHARDS, devices=["cuda"] * MESH_SHARDS),
                         chunk=chunk).run()
    kind, trace = res.violation if res.violation else (None, [])
    sha = hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()
    emit(dict(phase="mesh_trace", violation=kind, depth=res.depth, distinct=res.distinct,
              actions=[a for a, _ in trace], trace_sha256=sha))
    check(kind == "Invariant Inv is violated", f"median-bug violation: {kind}")
    check(res.depth == MEDIAN_BUG["depth"] and res.distinct == MEDIAN_BUG["distinct"]
          and res.generated == MEDIAN_BUG["generated"]
          and tuple(res.level_sizes) == MEDIAN_BUG["level_sizes"], "median-bug counts")
    check([a for a, _ in trace] == MESH_MEDIAN_BUG["actions"], "mesh median-bug trace actions")
    check(sha == MESH_MEDIAN_BUG["trace_sha256"], "mesh median-bug trace states")


def phase_mesh_cli(depth: int) -> dict:
    """``--mesh 1 --max-depth depth --json`` in a subprocess: golden; then
    ``--mesh 2`` on the one card exits nonzero with the too-few-devices
    message."""
    import torch

    rc, got, secs, err = _check_cli(["--mesh", "1", "--max-depth", str(depth), "--json"])
    n_gpu = torch.cuda.device_count()
    proc = subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.check", "--mesh",
                           str(n_gpu + 1), "--max-depth", "2"], capture_output=True, text=True,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parent),
                          timeout=600)
    out = dict(phase="mesh_cli", rc=rc, seconds=secs, run_seconds=got.get("seconds"),
               **{k: got.get(k) for k in ("distinct", "generated", "depth", "level_sizes",
                                          "mesh", "exchange", "straggler")},
               too_many_rc=proc.returncode, too_many_line=proc.stdout.strip()[-300:])
    emit(out)
    check(rc == 0, f"the mesh CLI exited {rc}: {err}")
    check(got["level_sizes"] == GOLDEN_LEVELS_REF[: depth + 1] and got["mesh"] == 1,
          f"mesh cli level sizes {got['level_sizes']}")
    check(proc.returncode != 0 and "device(s) are visible" in proc.stdout,
          f"--mesh {n_gpu + 1} on {n_gpu} GPU(s): rc {proc.returncode}")
    return out


def phase_mesh_kernels(kept: dict, launches: dict, seed: int) -> list:
    """``route`` and ``route_back`` against their twins on one shard's lanes
    of the mesh phase's last level (its pre-deduped candidates, the verdict
    tiles returned to it), then on adversarial lanes: a quarter SENT, an
    empty owner, and a capacity some owners pass (overflow set); and
    ``insert_only`` rehashing a 2^24-entry slab into 2^25 slots against its
    twin, and on a slab with a full probe window.  Times: the kernels, the
    twins, the library (``route``: a stable ``torch.argsort`` by owner,
    ``torch.bincount`` and the gathers; ``route_back``: one gather; none for
    ``insert_only``), and the bounds: route 36 B a lane (24 B in, its owner
    and rank out) plus every row slot written once (D * cap * 24 B: the
    fill is written too), route_back 13 B a lane plus its tiles, insert_only
    8 B an old slot plus one 32-B sector of the new slab a live one."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.ops import hashstore as hs
    from tla_raft_tpu_torch.parallel import sharded
    from tla_raft_tpu_torch.u64 import SENT

    D, cap_r = kept["D"], kept["cap_r"]
    gv, gf, gp = kept["lanes"]
    lane_owner, lane_rank = kept["meta"]
    back = kept["back"]
    n = gv.shape[0]
    fills = [SENT, SENT, -1]

    def same_route(cols, cap, **kw):
        a = kernels.route(cols, fills[:len(cols)], D, cap, **kw)
        b = sharded.route_plain([c for c in cols], fills[:len(cols)], D, cap, **kw)
        ok = all(_equal(x, y) for x, y in zip(a[0], b[0])) and all(
            _equal(x, y) for x, y in zip(a[1:4], b[1:4])) and bool(a[4]) == bool(b[4])
        return ok, bool(a[4])

    ok, _ovf = same_route([gv, gf, gp], cap_r)
    check(ok, "route differs from its twin on the mesh's lanes")
    gen = np.random.default_rng(seed)
    dev = gv.device
    av = gv.clone()
    own = sharded.owner_of_fp(av, D)
    av[(own == D - 1) | torch.from_numpy(gen.random(n) < 0.25).to(dev)] = SENT
    ok, ovf = same_route([av, gf, gp], max(1, n // (2 * D)))
    check(ok and ovf, "route differs from its twin (or sets no overflow) on adversarial lanes")
    win = kernels.route_back(back, lane_owner, lane_rank, D, cap_r)
    check(_equal(win, sharded.route_back_plain(back, lane_owner, lane_rank, D, cap_r)),
          "route_back differs from its twin")
    wa = kernels.route([gp], [-1], D, kept["cap_w"], owner=lane_owner, mask=win)
    wb = sharded.route_plain([gp], [-1], D, kept["cap_w"], owner=lane_owner, mask=win)
    check(_equal(wa[0][0], wb[0][0]) and _equal(wa[1], wb[1]),
          "route (the winners' grouping) differs from its twin")
    ms = cuda_ms(lambda: kernels.route([gv, gf, gp], fills, D, cap_r), 10)
    plain = cuda_ms(lambda: sharded.route_plain([gv, gf, gp], fills, D, cap_r), 5)

    def library():
        g = sharded.owner_of_fp(gv, D)
        order = torch.argsort(g, stable=True)
        counts = torch.bincount(g, minlength=D + 1)
        return [c[order] for c in (gv, gf, gp)], counts

    lib = cuda_ms(library, 5)
    out = []
    # each input lane read once (24 B), its owner and rank written (12 B), and
    # every row slot written once, filled or not (D * cap * 24 B)
    rec = _entry(out, launches, kernels.ROUTE, ms, plain, n * 36 + D * cap_r * 24 + 8 * (D + 1),
                 lib)
    rec.update(lanes=n, shards=D, cap=cap_r, level=kept["level"], live=int((gv != SENT).sum()))
    ms = cuda_ms(lambda: kernels.route_back(back, lane_owner, lane_rank, D, cap_r), 10)
    plain = cuda_ms(lambda: sharded.route_back_plain(back, lane_owner, lane_rank, D, cap_r), 5)
    lib = cuda_ms(lambda: back[lane_owner.long().clamp(max=D - 1), lane_rank.clamp(0, cap_r - 1)],
                  5)
    rec = _entry(out, launches, kernels.ROUTE_BACK, ms, plain, n * 13 + D * cap_r, lib)
    rec.update(lanes=n, tiles=D * cap_r)
    kept.clear()
    # insert_only: the grow of a 2^24-entry slab into 2^25 slots
    old = hs.make_slab(1 << 25, "cuda")
    fps = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, 1 << 24,
                                        dtype=np.int64)).to("cuda")
    hs.insert_only(old, fps)  # the old slab, at its 1/2 load
    fps = None
    a = kernels.insert_only(hs.make_slab(1 << 25, "cuda"), old)
    got = []  # the twin's one call is both its comparison and its time
    plain = wall_ms(lambda: got.append(hs.insert_only_plain(hs.make_slab(1 << 25, "cuda"), old)))
    b = got[0]
    check(_equal(a[0], b[0]) and int(a[1]) == int(b[1]) and bool(a[2]) == bool(b[2]),
          "insert_only differs from its twin on the 2^25 rehash")
    n_ins = int(a[1])
    a = b = None
    small = hs.make_slab(1 << 12, "cuda")
    small[100:300] = torch.arange(1, 201, device="cuda")
    f2 = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, 1800, dtype=np.int64)).cuda()
    a = kernels.insert_only(small.clone(), f2)
    b = hs.insert_only_plain(small.clone(), f2)
    check(_equal(a[0], b[0]) and int(a[1]) == int(b[1]) and bool(a[2]) == bool(b[2])
          and bool(a[2]), "insert_only differs from its twin (or no overflow) on a full window")
    ms = _timed_insert(lambda s, x: kernels.insert_only(s, x), hs.make_slab(1 << 25, "cuda"),
                       (old,), 5)
    # each old slot read once (8 B), one 32-B sector of the new slab a live one
    rec = _entry(out, launches, kernels.INSERT_ONLY, ms, plain, (1 << 25) * 8 + n_ins * 32, None)
    rec.update(lanes=1 << 25, inserted=n_ins, slots=1 << 25)
    old = None
    torch.cuda.empty_cache()
    return out


# -- slice 11: the sharded deep sweep (--mesh-deep) ---------------------------------------


def _deep_golden(res, depth: int) -> None:
    want = GOLDEN_LEVELS_REF[: depth + 1]
    check(res.ok and list(res.level_sizes) == want,
          f"level sizes {list(res.level_sizes)} != golden {want}")


def _deep_run(name: str, depth: int, chunk: int, keep: dict | None = None, **kw):
    """The Raft.cfg constants to ``depth`` on the deep sweep over 8 shards
    of the one card, one native store per owner under build/smoke/<name>/:
    (checker, result, progress records, seconds).  With ``keep``, the
    inputs of the new kernels' last calls are kept for the kernels line:
    the finalize's unique stream of the last owner of the last level
    (pack_deltas), the verdict bits and winners (deep_verdict), the last
    owner's repack sources and blocks (deep_repack), the last round's
    candidates of shard 0 (sieve_merge), and its sieve."""
    import torch

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh
    from tla_raft_tpu_torch.parallel import sharded

    d = _smoke_dir(name)
    levels = []
    chk = ShardedChecker(RaftConfig(), make_mesh(MESH_SHARDS, devices=["cuda"] * MESH_SHARDS),
                         chunk=chunk, progress=levels.append, deep=True,
                         host_store_dir=str(d), **kw)
    check(all(x.type == "cuda" for x in chk.devices), f"{name}: a shard off the card")
    saved = sharded.pack_fp_deltas, sharded.deep_verdict, sharded.repack
    if keep is not None:
        def pack(fps, n):
            keep["pack"] = (fps, n)
            return saved[0](fps, n)

        def verdict(bits, gp, n_u, n_recv):
            keep["verdict"] = (bits, gp, n_u, n_recv)
            return saved[1](bits, gp, n_u, n_recv)

        def repack(sources, segs):
            keep["repack"] = (sources, segs)
            return saved[2](sources, segs)

        sharded.pack_fp_deltas, sharded.deep_verdict, sharded.repack = pack, verdict, repack
        sieve_update = chk._deep_sieve_update

        def keep_sieve(rounds, depth, parts):
            keep["cv"] = rounds[-1]["lanes"][0][0]
            return sieve_update(rounds, depth, parts)

        chk._deep_sieve_update = keep_sieve
    torch.cuda.reset_peak_memory_stats()
    WALLS["base_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        res = chk.run(max_depth=depth)
        torch.cuda.synchronize()
    finally:
        sharded.pack_fp_deltas, sharded.deep_verdict, sharded.repack = saved
    return chk, res, levels, time.perf_counter() - t0


def _deep_out(name, chk, res, levels, secs, depth) -> dict:
    s = chk.meter.summary()
    log = chk.level_log
    return dict(
        phase=name, shards=chk.D, **_common(res, levels, secs, depth),
        seg_rows=chk.seg_rows, peak_dev_rows=chk.peak_dev_rows,
        largest_level=max(res.level_sizes), cap_x=chk.cap_x, cap_w=chk.cap_w,
        cap_c=chk.cap_c_deep, scap=chk.scap, reactive_grows=chk.reactive_grows,
        sieve=chk.sieve, compress=chk.compress, hash_sieve=chk.use_hashstore,
        rounds_per_level=[lv["rounds"] for lv in log],
        level_parts=[dict(level=lv["level"], **{k: round(v, 4) for k, v in lv["parts"].items()})
                     for lv in log],
        parts_total={k: sum(lv["parts"][k] for lv in log) for k in log[0]["parts"]} if log
        else {},
        exchange=dict((k, v) for k, v in s.items() if k != "per_level"),
        reductions=[lv["reduction"] for lv in s["per_level"]],
        packed=[lv["packed"] for lv in s["per_level"]],
        store_entries=[len(x) for x in chk.host_stores],
        store_runs=[x.num_runs for x in chk.host_stores],
        note="8 shards on one card: the exchange is device-local copies; multi-GPU speed is "
             "not measured (the card's host has one GPU)")


def phase_mesh_deep(depth: int, chunk: int, base: dict) -> dict:
    """The deep sweep on 8 shards to ``depth`` at the default seg_rows,
    the hash sieve and the packed stream: golden; the stores' sizes sum to
    distinct and each holds exactly the reachable fingerprints it owns (the
    default-path run to the same depth, ``base``); the sieve fired,
    exchanged bytes below raw, every level's reduction >= 1, at least three
    levels of more than one round; peak_dev_rows beside the largest level,
    the per-level seconds by part, the wall beside the fpstore phase's to
    the same depth, peak device memory.  Keeps the new kernels' inputs."""
    import torch

    kept = {}
    chk, res, levels, secs = _deep_run("deep_fps", depth, chunk, keep=kept)
    out = _deep_out("mesh_deep", chk, res, levels, secs, depth)
    out["fpstore_wall_same_depth"] = WALLS.get("fpstore_at", {}).get(depth)
    out["resident_mesh_wall_20"] = WALLS.get("mesh")
    bres, live, bsecs = base[depth]
    out.update(default_seconds=bsecs, default_generated=bres.generated)
    emit(out)
    WALLS["mesh_deep"] = secs
    _deep_golden(res, depth)
    check(res.generated == bres.generated, f"deep generated {res.generated}, default path "
                                           f"{bres.generated}")
    check(sum(out["store_entries"]) == res.distinct == len(live),
          f"stores hold {sum(out['store_entries'])}, distinct {res.distinct}")
    for o, st in enumerate(chk.host_stores):
        mine = live[live % np.uint64(MESH_SHARDS) == np.uint64(o)]
        check(len(st) == len(mine) and bool(st.contains(mine).all()),
              f"store {o} does not hold exactly the fingerprints it owns")
    ex = out["exchange"]
    check(ex["sieved"] > 0, "the sieve never fired")
    check(ex["exchanged_bytes"] < ex["raw_bytes"], f"exchange {ex}")
    check(all(r is not None and r >= 1 for r in out["reductions"]),
          f"a level's reduction below 1: {out['reductions']}")
    check(sum(r > 1 for r in out["rounds_per_level"]) >= 3,
          f"rounds a level {out['rounds_per_level']}")
    check(secs <= MESH_DEEP_SECONDS, f"mesh_deep took {secs:.1f} s (cut its depth to 21)")
    check(set(kept) >= {"pack", "verdict", "repack", "cv"}, f"kept {sorted(kept)}")
    kept["sieve"] = chk.sieves[0]
    for st in chk.host_stores:
        st.close()
    chk = None
    torch.cuda.empty_cache()
    return kept


def deep_counts(c: dict) -> None:
    never = ("hashstore", "level", "superstep", "sieve", "level_dedup", "sieve_merge",
             "drop_rows", "filter_compact", "bucket_refine", "bucket_tally", "bucket_ctrl")
    check(all(c[k] == 0 for k in never),
          "kernels off the deep sweep's path launched: " + str({k: c[k] for k in never if c[k]}))


def deep_sorted_counts(c: dict) -> None:
    never = ("insert_only", "hs_probe", "pack_deltas", "hashstore", "level", "superstep",
             "sieve", "level_dedup")
    check(all(c[k] == 0 for k in never),
          "kernels off the sorted sieve's raw path launched: "
          + str({k: c[k] for k in never if c[k]}))


def deep_nosieve_counts(c: dict) -> None:
    never = ("insert_only", "hs_probe", "sorted_member", "sieve_merge", "hashstore", "level",
             "superstep", "sieve", "level_dedup")
    check(all(c[k] == 0 for k in never),
          "sieve kernels launched with sieve=False: " + str({k: c[k] for k in never if c[k]}))


def phase_mesh_deep_sorted(depth: int, chunk: int) -> dict:
    """The sorted sieve (use_hashstore=False) with raw u64 fetches
    (compress=False) to ``depth``: golden, the sieve fired, no level
    packed."""
    chk, res, levels, secs = _deep_run("deep_sorted_fps", depth, chunk, use_hashstore=False,
                                       compress=False)
    out = _deep_out("mesh_deep_sorted", chk, res, levels, secs, depth)
    emit(out)
    _deep_golden(res, depth)
    check(out["exchange"]["sieved"] > 0 and not any(out["packed"]),
          f"sorted sieve: {out['exchange']}, packed {out['packed']}")
    check(sum(out["store_entries"]) == res.distinct, "the stores do not hold distinct")
    for st in chk.host_stores:
        st.close()
    return out


def phase_mesh_deep_nosieve(depth: int, chunk: int) -> dict:
    """sieve=False to ``depth``: golden, nothing sieved."""
    chk, res, levels, secs = _deep_run("deep_nosieve_fps", depth, chunk, sieve=False)
    out = _deep_out("mesh_deep_nosieve", chk, res, levels, secs, depth)
    emit(out)
    _deep_golden(res, depth)
    check(out["exchange"]["sieved"] == 0, f"sieve=False sieved {out['exchange']['sieved']}")
    for st in chk.host_stores:
        st.close()
    return out


def phase_mesh_deep_trace(chunk: int) -> None:
    """The median-bug mutation on (3,1,2,0), deep, 8 shards at seg_rows 16:
    the default path's counts and the pinned trace (the reference's deep
    mesh's, computed once on the CPU)."""
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.parallel import ShardedChecker, make_mesh

    d = _smoke_dir("deep_trace_fps")
    cfg = RaftConfig(3, 1, 2, 0, mutations=("median-bug",))
    res = ShardedChecker(cfg, make_mesh(MESH_SHARDS, devices=["cuda"] * MESH_SHARDS),
                         chunk=chunk, deep=True, host_store_dir=str(d),
                         seg_rows=MESH_DEEP_MEDIAN_BUG["seg_rows"]).run()
    kind, trace = res.violation if res.violation else (None, [])
    sha = hashlib.sha256("\n".join(f"{a!r} {s!r}" for a, s in trace).encode()).hexdigest()
    emit(dict(phase="mesh_deep_trace", violation=kind, depth=res.depth, distinct=res.distinct,
              actions=[a for a, _ in trace], trace_sha256=sha))
    check(kind == "Invariant Inv is violated", f"median-bug violation: {kind}")
    check(res.depth == MEDIAN_BUG["depth"] and res.distinct == MEDIAN_BUG["distinct"]
          and res.generated == MEDIAN_BUG["generated"]
          and tuple(res.level_sizes) == MEDIAN_BUG["level_sizes"], "median-bug counts")
    check([a for a, _ in trace] == MESH_DEEP_MEDIAN_BUG["actions"],
          "deep median-bug trace actions")
    check(sha == MESH_DEEP_MEDIAN_BUG["trace_sha256"], "deep median-bug trace states")


def phase_mesh_deep_cli(depth: int) -> dict:
    """``--mesh 1 --mesh-deep --fpstore-dir D --max-depth depth --json`` in a
    subprocess: exit 0, golden, the Exchange lines printed."""
    from pathlib import Path

    d = _smoke_dir("deep_cli_fps")
    args = ["--mesh", "1", "--mesh-deep", "--fpstore-dir", str(d), "--max-depth", str(depth),
            "--json"]
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tla_raft_tpu_torch.check", *args],
                          capture_output=True, text=True, cwd=root, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    ex_lines = [x for x in lines if x.startswith(("Exchange:", "  level "))]
    out = dict(phase="mesh_deep_cli", rc=proc.returncode, seconds=secs,
               run_seconds=got.get("seconds"),
               **{k: got.get(k) for k in ("distinct", "generated", "depth", "level_sizes",
                                          "mesh", "deep", "seg_rows", "peak_dev_rows")},
               exchange_line=ex_lines[0] if ex_lines else None, exchange_lines=len(ex_lines))
    emit(out)
    check(proc.returncode == 0, f"the deep mesh CLI exited {proc.returncode}: "
                                f"{proc.stderr[-1500:]}")
    check(got.get("level_sizes") == GOLDEN_LEVELS_REF[: depth + 1] and got.get("deep") is True,
          f"deep cli level sizes {got.get('level_sizes')}")
    check(len(ex_lines) == depth + 1, f"{len(ex_lines)} Exchange lines")
    return out


def phase_deep_kernels(kept: dict, launches: dict) -> list:
    """The four new kernels against their twins on the card, on the deep
    phase's inputs of its deepest level: ``pack_deltas`` on the last
    owner's unique stream, ``deep_verdict`` on its bits and winners,
    ``deep_repack`` on its sources and blocks, ``sieve_merge`` on shard 0's
    last round of candidates (holes included) into a sorted sieve of the
    run's capacity holding the hash sieve's entries.  Times: the kernels, the twins and the
    library calls (``deep_verdict``: ``index_put_`` of the unpacked bits on
    a zeroed mask; ``deep_repack``: ``torch.cat`` of the blocks, field by
    field; ``sieve_merge``: ``torch.unique`` of the sign-flipped
    concatenation; none for ``pack_deltas``).  Bounds: bytes (each input
    read once, each output written once)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.parallel import exchange, sharded
    from tla_raft_tpu_torch.u64 import SENT

    out = []
    fps, n = kept["pack"]
    n_i = int(n)
    a = kernels.pack_deltas(fps, n)
    b = exchange.pack_fp_deltas_plain(fps, n_i)
    check(all(_equal(x, y) for x, y in zip(a[:2], b[:2])) and int(a[2]) == int(b[2]),
          "pack_deltas differs from its twin")
    ms = cuda_ms(lambda: kernels.pack_deltas(fps, n), 10)
    plain = cuda_ms(lambda: exchange.pack_fp_deltas_plain(fps, n_i), 5)
    cap = fps.shape[0]
    rec = _entry(out, launches, kernels.PACK_DELTAS, ms, plain,
                 n_i * 8 + cap * 8 + cap // 2 + 8, None)
    rec.update(lanes=cap, unique=n_i, stream_bytes=int(a[2]))
    bits, gp, n_u, n_recv = kept["verdict"]
    n_u = int(n_u)
    a = kernels.deep_verdict(bits, gp, n_u, n_recv)
    b = sharded.deep_verdict_plain(bits, gp, n_u, n_recv)
    check(_equal(a, b), "deep_verdict differs from its twin")
    ms = cuda_ms(lambda: kernels.deep_verdict(bits, gp, n_u, n_recv), 10)
    plain = cuda_ms(lambda: sharded.deep_verdict_plain(bits, gp, n_u, n_recv), 5)
    idx = torch.arange(n_u, device=gp.device)
    vals = ((bits.long()[idx >> 3] >> (idx & 7)) & 1).bool()
    gpu = gp[:n_u]
    lib = cuda_ms(lambda: torch.zeros((n_recv,), dtype=torch.bool, device=gp.device)
                  .index_put_((gpu,), vals), 5)
    rec = _entry(out, launches, kernels.DEEP_VERDICT, ms, plain,
                 n_u * 8 + (n_u + 7) // 8 + n_recv, lib)
    rec.update(unique=n_u, lanes=n_recv)
    sources, segs = kept["repack"]
    a = kernels.deep_repack(sources, segs)
    b = sharded.repack_plain(sources, segs)
    check(all(_equal(x, y) for x, y in zip(a, b)), "deep_repack differs from its twin")
    ms = cuda_ms(lambda: kernels.deep_repack(sources, segs), 10)
    plain = cuda_ms(lambda: sharded.repack_plain(sources, segs), 5)
    nbytes = sum(x.numel() * x.element_size() for x in a)
    rec = _entry(out, launches, kernels.DEEP_REPACK, ms, plain, 2 * nbytes, plain)
    rec.update(blocks=len(segs), sources=len(sources), rows=int(a[0].shape[0]),
               fields=len(a), bytes=nbytes,
               library_is="torch.cat of each field's blocks (the twin)")
    slab = kept["sieve"]
    live = slab[slab != SENT]
    sieve = torch.full_like(slab, SENT)
    sieve[:live.shape[0]] = live[torch.argsort(live ^ (-(1 << 63)))]
    cv = kept["cv"]
    a = kernels.sieve_merge(sieve, cv)
    b = sharded.sieve_merge_plain(sieve, cv)
    check(_equal(a[0], b[0]) and bool(a[1]) == bool(b[1]), "sieve_merge differs from its twin")
    ms = cuda_ms(lambda: kernels.sieve_merge(sieve, cv), 10)
    plain = cuda_ms(lambda: sharded.sieve_merge_plain(sieve, cv), 5)
    flip = -(1 << 63)
    lib = cuda_ms(lambda: torch.unique(torch.cat([sieve, cv]) ^ flip), 5)
    S = sieve.shape[0]
    rec = _entry(out, launches, kernels.SIEVE_MERGE, ms, plain, (S + cv.shape[0]) * 8 + S * 8 + 16,
                 lib)
    rec.update(sieve=S, sieve_live=int(live.shape[0]), lanes=int(cv.shape[0]),
               live_lanes=int((cv != SENT).sum()), overflow=bool(a[1]))
    kept.clear()
    return out


def phase_digests(staged: list, default: list, depth: int) -> None:
    same = [a == b for a, b in zip(staged[:depth], default[:depth])]
    emit(dict(phase="digests", levels=len(same), equal=sum(same)))
    check(len(same) == depth and all(same),
          f"pidx/slot digests differ at levels {[i + 1 for i, x in enumerate(same) if not x]}")


def phase_fixpoint(chunk: int) -> None:
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    t0 = time.perf_counter()
    res = TorchChecker(RaftConfig(3, 1, 2, 1), device="cuda", chunk=chunk).run()
    got = (res.distinct, res.generated, res.depth)
    emit(dict(phase="fixpoint", config=[3, 1, 2, 1], distinct=got[0], generated=got[1],
              depth=got[2], seconds=time.perf_counter() - t0))
    check(res.ok and got == GOLDEN_FULL_3121, f"(3,1,2,1) fixpoint {got} != {GOLDEN_FULL_3121}")


def phase_trace(chunk: int) -> None:
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    cfg = RaftConfig(3, 1, 2, 0, mutations=("median-bug",))
    res = TorchChecker(cfg, device="cuda", chunk=chunk).run()
    kind, trace = res.violation if res.violation else (None, [])
    lines = "\n".join(f"{a!r} {s!r}" for a, s in trace)
    sha = hashlib.sha256(lines.encode()).hexdigest()
    emit(dict(phase="trace", violation=kind, depth=res.depth, distinct=res.distinct,
              actions=[a for a, _ in trace], trace_sha256=sha))
    check(kind == "Invariant Inv is violated", f"median-bug violation: {kind}")
    check(res.depth == MEDIAN_BUG["depth"] and res.distinct == MEDIAN_BUG["distinct"]
          and res.generated == MEDIAN_BUG["generated"]
          and tuple(res.level_sizes) == MEDIAN_BUG["level_sizes"], "median-bug counts")
    check([a for a, _ in trace] == MEDIAN_BUG["actions"], "median-bug trace actions")
    check(sha == MEDIAN_BUG["trace_sha256"], "median-bug trace states")


def phase_drill() -> None:
    """Every stop class of the superstep commit forced on (3,1,1,1), and the
    double-vote abort on (3,1,2,0): the counts never move."""
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine import superstep as ss
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.ops import hashstore as hs

    cfg = RaftConfig(3, 1, 1, 1)
    want = (True, 545, 2028, 19)
    rows = []

    def case(name, expect, **kw):
        flags = []
        chk = TorchChecker(cfg, device="cuda", **{"chunk": 256, **kw.pop("ctor", {})})
        for k, v in kw.items():
            setattr(chk, k, v)
        grow = chk._grow_for_stop

        def spy(f, *rest):
            flags.append(f)
            return grow(f, *rest)

        chk._grow_for_stop = spy
        res = chk.run()
        got = (res.ok, res.distinct, res.generated, res.depth)
        rows.append(dict(case=name, counts=list(got), stops=chk._ss_stats["stops"],
                         ring_stops=chk._ss_stats["ring_stops"], flags=sorted(set(flags)),
                         redo={k: v for k, v in chk._mega_stats.items() if v}))
        check(got == want, f"drill {name}: counts {got} != {want}")
        check(expect(chk, flags), f"drill {name}: the stop class did not fire {rows[-1]}")

    case("base", lambda c, f: c._ss_stats["stops"] == 0)
    case("cap_x", lambda c, f: any(x & ss.FLAG_OVF_X for x in f), ctor=dict(cap_x=16))
    case("cap_m", lambda c, f: any(x & ss.FLAG_OVF_M for x in f), ctor=dict(cap_m=4))
    case("rounds", lambda c, f: any(x & ss.FLAG_OVF_ROUNDS for x in f), k4_rounds=1)
    saved = (hs.MIN_CAP, hs.DeviceHashStore.need_grow, ss.ring_capacity,
             TorchChecker._superstep_shapes)
    try:
        hs.MIN_CAP = 16
        hs.DeviceHashStore.need_grow = lambda self, extra=0: False
        case("slab", lambda c, f: any(x & ss.FLAG_OVF_SLAB for x in f))
        hs.MIN_CAP, hs.DeviceHashStore.need_grow = saved[0], saved[1]
        ss.ring_capacity = lambda fut, span, cap_f, pow2: 4
        case("ring", lambda c, f: c._ss_stats["ring_stops"] > 0)
        ss.ring_capacity = saved[2]

        def small_seat(self, fut, span, n_rows, cap_cur):
            cap_f = max(4 * self.chunk, cap_cur)
            return cap_f, ss.ring_capacity(fut, span, cap_f,
                                           lambda x: 1 << max(0, x - 1).bit_length())

        TorchChecker._superstep_shapes = small_seat
        case("seat", lambda c, f: any(x & ss.FLAG_OVF_OUT for x in f), ctor=dict(chunk=8))
    finally:
        hs.MIN_CAP, hs.DeviceHashStore.need_grow, ss.ring_capacity = saved[:3]
        TorchChecker._superstep_shapes = saved[3]
    chk = TorchChecker(RaftConfig(3, 1, 2, 0, mutations=("double-vote",)), device="cuda",
                       chunk=256)
    res = chk.run()
    lines = "\n".join(f"{a!r} {s!r}" for a, s in res.violation[1])
    rows.append(dict(case="abort", counts=list(res[:4]), stops=chk._ss_stats["stops"]))
    emit(dict(phase="drill", cases=rows))
    check(tuple(res[:4]) == DOUBLE_VOTE["result"]
          and hashlib.sha256(lines.encode()).hexdigest() == DOUBLE_VOTE["trace_sha256"]
          and chk._ss_stats["stops"] == 1, "drill abort: the double-vote stop point or trace")


def phase_twins(chunk: int) -> None:
    """One fused level and one superstep of two levels on the card against
    the CPU twins, from the depth-9 frontier and slab of the reference
    constants: every output equal."""
    import torch

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.engine import superstep as ss
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops import hashstore as hs

    base = TorchChecker(RaftConfig(), device="cuda", chunk=chunk)
    base.run(max_depth=9)
    n_f = base.frontier.voted_for.shape[0]
    base.hstore.reserve(base.hstore.count + 8 * n_f)  # room for two more levels

    def carried(device):
        chk = TorchChecker(RaftConfig(), device=device, chunk=chunk, cap_x=base.cap_x,
                           cap_m=base.cap_m)
        chk.hstore = hs.DeviceHashStore(base.hstore.cap, base.hstore.count, device)
        chk.hstore.slab = base.hstore.slab.to(device).clone()
        return chk, Frontier(*(x.to(device) for x in base.frontier))

    outs, secs = {}, {}
    for device in ("cuda", "cpu"):
        chk, fr = carried(device)
        cap_f = chk._rows_cap(fr)
        t0 = time.perf_counter()
        prog = mk.LevelProgram(chk, ("twin",), cap_f, 4 * chunk, mk.DEFAULT_ROUNDS)
        mk.copy_rows(prog.fr_in, fr, n_f)
        prog.run(n_f)
        n_new = int(prog.ctrl[0])
        level = [prog.ctrl, prog.mult, prog.fps_out, prog.pidx, prog.slot, chk.hstore.slab,
                 *(x[:n_new] for x in prog.fr_out)]
        chk2, fr2 = carried(device)
        prog2 = ss.SuperstepProgram(chk2, ("twin",), 4 * chunk, 16 * chunk, 4, mk.DEFAULT_ROUNDS)
        mk.copy_rows(prog2.fr[0], fr2, n_f)
        prog2.run(n_f, 2, 16 * chunk)
        n2 = int(prog2.ss[ss.SS_NF])
        sstep = [prog2.ss[: ss.SS_CTRL], prog2.meta_n, prog2.meta_mult, prog2.ring_fps,
                 prog2.ring_pidx, prog2.ring_slot, chk2.hstore.slab,
                 *(x[:n2] for x in prog2.fr[0])]
        outs[device] = [t.cpu() for t in level + sstep]
        secs[device] = time.perf_counter() - t0
        if device == "cuda":
            meta = dict(n_new=n_new, superstep_levels=prog2.meta_n.tolist()[:2])
        del prog, prog2
        torch.cuda.empty_cache()
    same = [bool(torch.equal(a, b)) for a, b in zip(outs["cuda"], outs["cpu"])]
    emit(dict(phase="twins", parents=n_f, **meta, outputs=len(same), equal=sum(same),
              seconds=secs))
    check(meta["n_new"] == GOLDEN_LEVELS_REF[10]
          and meta["superstep_levels"] == GOLDEN_LEVELS_REF[10:12], f"twins counts {meta}")
    check(all(same), f"fused level / superstep differ from the CPU twins: {same}")


def _equal(a, b) -> bool:
    import torch

    torch.cuda.synchronize()
    return a.shape == b.shape and bool(torch.equal(a, b))


def _frontier_rows(fr, rows):
    from tla_raft_tpu_torch.models.raft import Frontier

    return Frontier(*(x[rows].contiguous() for x in fr))


def _core_bytes(fr) -> int:
    return sum(x[0].numel() * x.element_size() for x in fr[:-1])


def _mix_rows(fr, gen):
    """A Frontier whose every field comes from an independently chosen row
    of ``fr``: plausible values in new combinations (many break Inv)."""
    import torch

    from tla_raft_tpu_torch.models.raft import Frontier

    n = fr.voted_for.shape[0]
    dev = fr.voted_for.device
    return Frontier(*(x[torch.from_numpy(gen.integers(0, n, n)).to(dev)].contiguous() for x in fr))


def _timed_insert(insert, slab, args, reps: int) -> float:
    """Median ms of ``insert(copy of slab, *args)``: each call gets a fresh
    copy of the slab (the insert works in place), made outside the timed
    span."""
    import torch

    times = []
    for _ in range(reps + 1):
        s2 = slab.clone()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        insert(s2, *args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def _k3_design(fpr, ids) -> dict:
    """K3's factored design's own counts for a launch over the rows whose id
    lists are ``ids`` ([n, cap_m], -1 padded): bytes (the feature table's
    columns each block stages, each state's gt rows once a block of its 20
    ranges of 256 permutations, half a row a pass, the blocks' PPERM rows)
    and operations (the int8 MMAs; the u32 adds of the R rows and of the
    fold, one a present digit, permutation and channel)."""
    import torch

    uni, P, NP, f_pad = fpr.uni, fpr.P, fpr.NP, fpr.ktab["f_pad"]
    n = ids.shape[0]
    idl = ids.long()
    live = idl >= 0
    offs = torch.tensor(uni.type_offsets, device=ids.device)
    strides = torch.tensor(uni.type_strides, device=ids.device)
    t = (idl >= offs[1]).long() + (idl >= offs[2]).long() + (idl >= offs[3]).long()
    q = torch.where(live, (idl - offs[t]) // strides[t], torch.full_like(idl, NP))
    present = torch.zeros((n, NP + 1), dtype=torch.bool, device=ids.device)
    present.scatter_(1, q, True)
    n_q, n_ids = int(present[:, :NP].sum()), int(live.sum())
    gx, tiles = -(-n // 64), -(-P // 8)
    gy = -(-tiles // 32)
    bytes_ = gx * tiles * 128 * f_pad + n_ids * gy * NP * 16 + gx * gy * 256 * NP
    int8_ops = 2 * gx * 64 * f_pad * 16 * P
    u32_ops = n_ids * gy * NP * 4 + n_q * P * 4
    return dict(design_bytes=bytes_, design_int8_ops=int8_ops, design_u32_ops=u32_ops,
                present_digits=n_q, design_ms=max(bytes_ / HBM_BYTES_PER_S,
                                                  int8_ops / INT8_TENSOR_OPS_PER_S
                                                  + u32_ops / INT_OPS_PER_S) * 1e3)


def _entry(out: list, launches: dict, k, ms, plain_ms, bytes_, lib_ms, ops=0,
           ops_rate=None, ops_ms=None) -> dict:
    """One kernel's record of the ``kernels`` line: its bound is the larger
    of bytes / the HBM rate and the operations' time (``ops`` at
    ``ops_rate``, or ``ops_ms`` given)."""
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = ops_ms if ops_ms is not None else ops / (ops_rate or INT_OPS_PER_S) * 1e3
    out.append(dict(
        name=k.name, route="cuda", source=f"tla_raft_tpu_torch/{k.source}",
        replaces=k.replaces, launches=launches[k.name], equal=True, max_abs_err=0, ms=ms,
        plain_ms=plain_ms, bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms
        else "operations", library_ms=lib_ms,
    ))
    return out[-1]


def k1k2_forms(chk, reps: int = 10) -> dict:
    """K1 and K2 in the forms a fused level launches them, on ``chk``'s
    frontier: K1's counted form (``valid``, ``mult_acc``, ``abort_acc``,
    ``cnt``) over its first chunk, held against the twin's summed mult and
    first abort, beside the same launch without the sums and the per-row
    form; K2's candidate pass (that chunk's candidates as payloads, cap_x
    lanes under a count) and one ``mat_slice_width`` slice of the level's
    survivors (payloads into the whole frontier, under n_new), each held
    against the twin.  Device ms (``graph_ms``) and each form's byte bound;
    ``inputs`` holds the tensors for callers that time them again."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.models.raft import Frontier

    dev = torch.device("cuda")
    fr, mx, uni = chk.frontier, chk.mx, chk.uni
    n, K, B, G = fr.voted_for.shape[0], chk.K, chk.chunk, chk.cap_x
    real = _frontier_rows(fr, torch.arange(min(B, n), device=dev))
    nb = real.voted_for.shape[0]
    st = chk.inflate(real)
    core_b = _core_bytes(fr)
    parts = [mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 2048] for x in real))))
             for i in range(0, nb, 2048)]
    pv, pm, pa = (torch.cat(x) for x in zip(*parts))
    big = 1 << 62
    valid = torch.zeros((nb, K), dtype=torch.bool, device=dev)
    acc = torch.zeros((K,), dtype=torch.int64, device=dev)
    first = torch.full((), big, dtype=torch.int64, device=dev)
    cnt = torch.tensor(nb + 3, dtype=torch.int64, device=dev)  # live rows: cnt - sub

    def counted(sums=True):
        kernels.guards(mx, st, valid=valid, per_row=False, cnt=cnt, sub=3,
                       mult_acc=acc if sums else None, abort_acc=first if sums else None)

    counted()
    want_first = int(torch.nonzero(pa)[0, 0]) if bool(pa.any()) else big
    check(_equal(valid, pv) and _equal(acc, pm.to(torch.int64).sum(0))
          and int(first) == want_first, "K1's counted form differs from its twin")
    out = dict(parents=nb, slots=K, valid_slots=int(pv.sum()), aborts=int(pa.sum()))
    out["guards_counted_ms"] = graph_ms(counted, reps)
    out["guards_valid_only_ms"] = graph_ms(lambda: counted(False), reps)
    out["guards_per_row_ms"] = graph_ms(lambda: mx.guards(st), reps)
    # each parent's fields and mask read once, its valid row written once;
    # the sums' K words
    out["guards_counted_bound_ms"] = (nb * (core_b + uni.n_words * 4 + K) + K * 8) \
        / HBM_BYTES_PER_S * 1e3

    # K2, candidate pass: the chunk's valid lanes at cap_x, payloads into the chunk
    payload = (torch.arange(nb, device=dev)[:, None] * K
               + torch.arange(K, device=dev)).reshape(-1)
    cp, lane, _o = bfs.compact_payloads(pv.reshape(-1), payload, G)
    live = int(lane.sum())
    row_b = core_b + fr.msg_ids.element_size() * fr.msg_ids.shape[1]

    def mat_bound_ms(pay):
        # each distinct parent's row read once (a block's lanes share their
        # parents); per live lane its payload read, its child row, added ids
        # and ovf flag written
        parents = int(torch.unique(torch.div(pay, K, rounding_mode="floor")).numel())
        return (parents * row_b + pay.numel() * (row_b + 8 + 4 * mx.A + 1)) \
            / HBM_BYTES_PER_S * 1e3

    def mat_pass(parents, pay, lanes, total):
        child = Frontier(*(torch.empty((lanes, *x.shape[1:]), dtype=x.dtype, device=dev)
                           for x in parents))
        buf = (child, torch.empty((lanes, mx.A), dtype=torch.int32, device=dev),
               torch.empty((lanes,), dtype=torch.bool, device=dev))
        t = torch.tensor(total, dtype=torch.int64, device=dev)
        ovf = torch.zeros((), dtype=torch.int64, device=dev)

        def call():
            kernels.materialize(mx, parents, None, None, pay=pay, out=buf, cnt=t, ovf_any=ovf)

        call()
        p = pay[:total]
        pc, pad, po = mx.materialize_plain(parents, torch.div(p, K, rounding_mode="floor"),
                                           torch.remainder(p, K))
        ok = all(_equal(x[:total], y) for x, y in zip(buf[0], pc))
        ok &= _equal(buf[1][:total], pad) and _equal(buf[2][:total], po)
        ok &= int(ovf) == int(po.any())
        return ok, graph_ms(call, reps)

    ok, out["materialize_candidates_ms"] = mat_pass(real, cp, G, live)
    check(ok, "K2's candidate pass differs from its twin")
    out.update(candidate_lanes=G, candidates=live,
               materialize_candidates_bound_ms=mat_bound_ms(cp[:live]))
    # K2, survivor pass: a level's fresh payloads into the whole frontier,
    # one slice of mat_slice_width's width past 8 chunks (8 * chunk)
    res = chk.expand_level(fr, n, chk.hstore.slab.clone())
    sl = 8 * B
    surv = res["new_payload"][:sl].contiguous()
    surv_live = min(sl, res["n_new"])
    ok, out["materialize_survivors_ms"] = mat_pass(fr, surv, sl, surv_live)
    check(ok, "K2's survivor pass differs from its twin")
    out.update(survivor_lanes=sl, level_new=res["n_new"],
               materialize_survivors_bound_ms=mat_bound_ms(surv[:surv_live]))
    out["inputs"] = dict(st=st, real=real, cp=cp, live=live, surv=surv, surv_live=surv_live)
    return out


def k3_compact_forms(chk, reps: int = 10, seed: int = 3) -> dict:
    """K3 and the order-keeping compaction in the forms a fused level
    launches them, on ``chk``'s frontier's first chunk: the compaction of
    the chunk's K1 flags (rows * K lanes under a row count, ``mul`` = K)
    into cap_x payload lanes (B3 ``_compact_payloads``); K3 counted over the
    materialized candidates at cap_x lanes (dead lanes SENT); B9's
    two-array form over those lanes' fingerprints (seeded fresh flags
    under the live count); and the filter form (B3 ``_filter_compact``:
    three arrays, a device lane offset, a payload offset, the overflow
    word).  Each is held against its twin; device ms by ``graph_ms`` with
    each form's byte bound; ``inputs`` holds the calls for callers that
    profile them again."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops import hashstore as hs

    gen = np.random.default_rng(seed)
    dev = torch.device("cuda")
    fr, mx, fpr = chk.frontier, chk.mx, chk.fpr
    n, K, B, G = fr.voted_for.shape[0], chk.K, chk.chunk, chk.cap_x
    real = _frontier_rows(fr, torch.arange(min(B, n), device=dev))
    nb = real.voted_for.shape[0]
    valid = mx.guards(chk.inflate(real))[0].reshape(-1)
    payload = (torch.arange(nb, device=dev)[:, None] * K
               + torch.arange(K, device=dev)).reshape(-1)
    rows_t = torch.tensor(nb, dtype=torch.int64, device=dev)
    cp = torch.empty((G,), dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    tile = torch.zeros((kernels.compact_tiles(nb * K),), dtype=torch.int64, device=dev)

    def chunk_flags():
        kernels.compact(valid, None, -1, G, out_a=cp, total=total, cnt=rows_t, mul=K, tile=tile)

    chunk_flags()
    want, _lane, _o = bfs.compact_payloads_plain(valid, payload, G)
    kept = int(valid.sum())
    check(_equal(cp, want) and int(total) == kept, "the chunk compaction differs from its twin")
    live = min(kept, G)
    out = dict(parents=nb, flag_lanes=nb * K, candidates=live, cap_x=G)
    out["compact_chunk_ms"] = graph_ms(chunk_flags, reps)
    # the flags read once, the cap_x payload lanes written once
    out["compact_chunk_bound_ms"] = (nb * K + G * 8) / HBM_BYTES_PER_S * 1e3

    # K3 over the materialized candidates, counted at cap_x lanes
    children = mx.materialize(real, torch.div(cp, K, rounding_mode="floor").clamp(0, nb - 1),
                              cp % K)[0]
    live_t = torch.tensor(live, dtype=torch.int64, device=dev)
    fps = (torch.empty((G,), dtype=torch.int64, device=dev),
           torch.empty((G,), dtype=torch.int64, device=dev))

    def k3():
        kernels.fingerprints(fpr, children, out=fps, cnt=live_t)

    k3()
    pv, pf = fpr.state_fingerprints_plain(Frontier(*(x[:live] for x in children)))
    check(_equal(fps[0][:live], pv) and _equal(fps[1][:live], pf)
          and bool((fps[0][live:] == -1).all()) and bool((fps[1][live:] == -1).all()),
          "K3's counted launch differs from its twin")
    out["k3_ms"] = graph_ms(k3, reps)
    out["k3_events_ms"] = cuda_ms(k3, reps)
    row_b = _core_bytes(fr) + fr.msg_ids.element_size() * fr.msg_ids.shape[1]
    ids_set = int((children.msg_ids[:live] >= 0).sum())
    # each live state's row read once, 16 B out a lane, the tables once
    out["k3_bound_ms"] = (live * row_b + G * 16 + fpr.ktab["ct"].numel()) \
        / HBM_BYTES_PER_S * 1e3
    out["k3_ids_a_state"] = ids_set / max(live, 1)

    # B9: the candidates' fresh lanes (fingerprints, payloads) packed
    fresh = torch.from_numpy(gen.random(G) < 0.4).to(dev) & (torch.arange(G, device=dev) < live)
    nf, np_ = (torch.empty((G,), dtype=torch.int64, device=dev) for _ in range(2))
    ftot = torch.empty((), dtype=torch.int64, device=dev)
    ftile = torch.zeros((kernels.compact_tiles(G),), dtype=torch.int64, device=dev)

    def b9():
        kernels.compact(fresh, fps[0], -1, G, vb=cp, pad_b=-1, out_a=nf, out_b=np_,
                        total=ftot, cnt=live_t, tile=ftile)

    b9()
    wf, wp = hs.compact_fresh_plain(fresh[:live], fps[0][:live], cp[:live], G)
    check(_equal(nf, wf) and _equal(np_, wp), "B9's compaction differs from its twin")
    nfresh = int(fresh.sum())
    out["b9_ms"] = graph_ms(b9, reps)
    # the flags read once, the kept lanes' two values read, cap_x lanes of two written
    out["b9_bound_ms"] = (live + nfresh * 16 + G * 16) / HBM_BYTES_PER_S * 1e3

    # the filter form: keep flags over the candidates, written at a device
    # lane offset of a larger buffer, payloads offset, into half of cap_x
    cap = G // 2
    keep = torch.from_numpy(gen.random(G) < 0.45).to(dev)
    bufs = tuple(torch.full((3 * cap,), 5, dtype=torch.int64, device=dev) for _ in range(3))
    off = torch.tensor(cap, dtype=torch.int64, device=dev)
    pay_off = torch.tensor(1 << 33, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    ktot = torch.empty((), dtype=torch.int64, device=dev)
    ktile = torch.zeros((kernels.compact_tiles(G),), dtype=torch.int64, device=dev)

    def filt():
        kernels.filter_compact(keep, fps[0], fps[1], cp, cap, out=bufs, total=ktot, out_off=off,
                               pay_off=pay_off, ovf=ovf, tile=ktile)

    filt()
    kidx = torch.nonzero(keep).reshape(-1)
    nk = kidx.shape[0]
    ok = int(ktot) == nk and int(ovf) == int(nk > cap)
    for b, v, pad, add in ((bufs[0], fps[0], -1, 0), (bufs[1], fps[1], -1, 0),
                           (bufs[2], cp, -1, 1 << 33)):
        w = torch.full((cap,), pad, dtype=torch.int64, device=dev)
        k = min(nk, cap)
        w[:k] = v[kidx[:k]] + add
        ok &= _equal(b[cap:2 * cap], w) and bool((b[:cap] == 5).all()) \
            and bool((b[2 * cap:] == 5).all())
    check(ok, "the filter compaction differs from its twin")
    out["filter_ms"] = graph_ms(filt, reps)
    out["filter_bound_ms"] = (G + min(nk, cap) * 24 + cap * 24) / HBM_BYTES_PER_S * 1e3
    out["inputs"] = dict(chunk_flags=chunk_flags, k3=k3, b9=b9, filter=filt)
    return out


def phase_kernels(chk, launches: dict, seed: int):
    """Each kernel against its plain twin on real and seeded random inputs:
    (the kernels' records, the shapes)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, inv_scan_plain
    from tla_raft_tpu_torch.models.raft import Frontier, init_batch
    from tla_raft_tpu_torch.ops import hashstore as hs

    gen = np.random.default_rng(seed)
    dev = torch.device("cuda")
    fr, mx, fpr, uni = chk.frontier, chk.mx, chk.fpr, chk.uni
    n, K, B = fr.voted_for.shape[0], chk.K, chk.chunk
    G = chk.cap_x
    cap_m = fr.msg_ids.shape[1]
    core_b = _core_bytes(fr)
    out = []
    bytes_of = {}

    def entry(k, _equal_ok, ms, plain_ms, bytes_, ops, lib_ms, ops_rate=INT_OPS_PER_S):
        # every caller checked the kernel equal to its twin before timing it
        _entry(out, launches, k, ms, plain_ms, bytes_, lib_ms, ops, ops_rate)

    # K1 guards: one chunk of real parents, and a seeded random sample
    def guards_case(part):
        st = chk.inflate(part)
        kv, km, ka = mx.guards(st)
        pv, pm, pa = zip(*(mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 2048] for x in part))))
                           for i in range(0, part.voted_for.shape[0], 2048)))
        ok = (_equal(kv, torch.cat(pv)) and _equal(km, torch.cat(pm))
              and _equal(ka, torch.cat(pa)))
        return st, ok

    real = _frontier_rows(fr, torch.arange(min(B, n), device=dev))
    rand = _frontier_rows(fr, torch.from_numpy(gen.integers(0, n, B)).to(dev))
    st_real, ok1 = guards_case(real)
    _st, ok2 = guards_case(rand)
    check(ok1 and ok2, "K1 guards differs from its twin")
    # K1 and K2 are timed by CUDA-graph replay (``graph_ms``): their device
    # time is tens of microseconds, below the wrappers' own launch time that
    # ``cuda_ms`` also counts (kept as events_ms)
    forms = k1k2_forms(chk)
    forms.pop("inputs")
    events = cuda_ms(lambda: mx.guards(st_real), 10)
    plain = wall_ms(lambda: [mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 2048] for x in real))))
                             for i in range(0, real.voted_for.shape[0], 2048)])
    nb = real.voted_for.shape[0]
    entry(kernels.GUARDS, True, forms["guards_per_row_ms"], plain,
          nb * (core_b + uni.n_words * 4) + K * 24 + nb * K * 5 + nb, nb * K * 32, None)
    out[-1].update(events_ms=events, counted_ms=forms["guards_counted_ms"],
                   counted_bound_ms=forms["guards_counted_bound_ms"],
                   valid_only_ms=forms["guards_valid_only_ms"])

    # compaction (B3 shape): the real chunk's valid lanes to cap_x lanes;
    # random flags over the same lanes into a smaller cap (overflow); and
    # the B9 form (two value arrays) on random fresh lanes
    valid, _m, _a = mx.guards(st_real)
    vflat = valid.reshape(-1)
    rows = torch.arange(nb, dtype=torch.int64, device=dev)
    payload = (rows[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    ok = True
    for flags, cap in ((vflat, G), (torch.from_numpy(gen.random(vflat.shape[0]) < 0.3).to(dev),
                                    G)):
        a = bfs.compact_payloads(flags, payload, cap)
        b = bfs.compact_payloads_plain(flags, payload, cap)
        ok &= all(_equal(x, y) for x, y in zip(a, b))
    fresh = torch.from_numpy(gen.random(vflat.shape[0]) < 0.1).to(dev)
    rfp = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, vflat.shape[0],
                                        dtype=np.int64)).to(dev)
    for n_out in (vflat.shape[0], G):
        a = hs.compact_fresh(fresh, rfp, payload, n_out)
        b = hs.compact_fresh_plain(fresh, rfp, payload, n_out)
        ok &= all(_equal(x, y) for x, y in zip(a, b))
    check(ok, "compaction differs from its twin")
    # the compaction and K3 are timed by CUDA-graph replay as K1 and K2 are
    # (CUDA events kept as events_ms); k3_compact_forms adds the forms a
    # fused level launches (the chunk's flags under a row count, B9's and
    # the filter form, K3 counted over the candidates)
    k3c = k3_compact_forms(chk)
    k3c.pop("inputs")
    ms = graph_ms(lambda: bfs.compact_payloads(vflat, payload, G), 10)
    events = cuda_ms(lambda: bfs.compact_payloads(vflat, payload, G), 10)
    plain = wall_ms(lambda: bfs.compact_payloads_plain(vflat, payload, G))
    lib = cuda_ms(lambda: torch.masked_select(payload, vflat), 10)
    kept = int(vflat.sum())
    entry(kernels.COMPACT, True, ms, plain, vflat.shape[0] + kept * 8 + G * 9,
          vflat.shape[0] * 4, lib)
    out[-1].update(events_ms=events, chunk_form_ms=k3c["compact_chunk_ms"],
                   chunk_form_bound_ms=k3c["compact_chunk_bound_ms"],
                   fresh_form_ms=k3c["b9_ms"], fresh_form_bound_ms=k3c["b9_bound_ms"],
                   filter_form_ms=k3c["filter_ms"], filter_form_bound_ms=k3c["filter_bound_ms"],
                   launches_per_call=kernels.compact_launches(vflat.shape[0]))

    # K2 materialize: the real chunk's compacted candidates, and random lanes
    cp, lane, _o = bfs.compact_payloads(vflat, payload, G)
    lidx, slots = torch.div(cp, K, rounding_mode="floor").clamp(0, nb - 1), cp % K
    cases = [(real, lidx, slots),
             (fr, torch.from_numpy(gen.integers(0, n, G)).to(dev),
              torch.from_numpy(gen.integers(0, K, G)).to(dev))]
    ok = True
    for par, pi, sl in cases:
        kc, ka, ko = mx.materialize(par, pi, sl)
        pc, pa, po = mx.materialize_plain(par, pi, sl)
        ok &= all(_equal(x, y) for x, y in zip(kc, pc)) and _equal(ka, pa) and _equal(ko, po)
    check(ok, "K2 materialize differs from its twin")
    children = mx.materialize(real, lidx, slots)[0]
    ms = graph_ms(lambda: mx.materialize(real, lidx, slots), 10)
    events = cuda_ms(lambda: mx.materialize(real, lidx, slots), 10)
    plain = wall_ms(lambda: mx.materialize_plain(real, lidx, slots))
    # each distinct parent's row read once, each lane's (pidx, slot) read and
    # child row, added ids and ovf flag written
    row_b = core_b + fr.msg_ids.element_size() * cap_m
    entry(kernels.MATERIALIZE, True, ms, plain,
          int(torch.unique(lidx).numel()) * row_b + G * (row_b + 16 + 4 * mx.A + 1),
          G * (cap_m * 4 + 64), None)
    out[-1]["events_ms"] = events
    out[-1].update({k: forms[k] for k in (
        "materialize_candidates_ms", "materialize_candidates_bound_ms", "candidates",
        "materialize_survivors_ms", "materialize_survivors_bound_ms", "survivor_lanes")})

    # K3 fingerprints: the real children, and random states with random ids
    rnd_core = [torch.from_numpy(gen.integers(0, 256, x.shape, dtype=np.uint8)).to(dev)
                for x in children[:-1]]
    ids = np.full((G, cap_m), -1, np.int16)
    for i, k in enumerate(gen.integers(0, cap_m + 1, G)):
        ids[i, :k] = np.sort(gen.choice(uni.M, k, replace=False))
    rnd = Frontier(*rnd_core, torch.from_numpy(ids).to(dev))
    ok = True
    for case in (children, rnd):
        kv, kf = fpr.state_fingerprints(case)
        pv, pf = fpr.state_fingerprints_plain(case)
        ok &= _equal(kv, pv) and _equal(kf, pf)
    check(ok, "K3 fingerprints differ from the twin")
    ms = graph_ms(lambda: fpr.state_fingerprints(children), 10)
    events = cuda_ms(lambda: fpr.state_fingerprints(children), 10)
    plain = wall_ms(lambda: fpr.state_fingerprints_plain(children))
    F, ncols = fpr.C_planes.shape
    n_ids = int((children.msg_ids >= 0).sum())
    x8 = torch.cat([fpr.spec.features(children), fpr.ids_to_bits(children.msg_ids)], 1)
    pad = (-x8.shape[1]) % 8
    x8 = torch.nn.functional.pad(x8, (0, pad))
    y8 = torch.nn.functional.pad(torch.cat([fpr.C_planes, fpr.G_planes]), (0, 0, 0, pad))
    lib = cuda_ms(lambda: torch._int_mm(x8, y8), 10)
    entry(kernels.FINGERPRINT, True, ms, plain,
          G * (row_b + 16) + F * ncols + fpr.G_planes.numel(),
          2 * (G * F + n_ids) * ncols, lib, ops_rate=INT8_TENSOR_OPS_PER_S)
    out[-1].update(events_ms=events, counted_ms=k3c["k3_ms"],
                   counted_events_ms=k3c["k3_events_ms"], counted_bound_ms=k3c["k3_bound_ms"],
                   candidates=k3c["candidates"], ids_a_state=k3c["k3_ids_a_state"])

    # inflate / deflate: the whole last frontier, random id lists, and
    # random masks with rows over cap_m (deflate's overflow)
    ok = _equal(bfs.ids_to_msgs(fr.msg_ids, uni.n_words),
                bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words))
    ok &= _equal(bfs.ids_to_msgs(rnd.msg_ids, uni.n_words),
                 bfs.ids_to_msgs_plain(rnd.msg_ids, uni.n_words))
    check(ok, "inflate differs from its twin")
    # timed at the main path's shape: one chunk of parents
    ms = cuda_ms(lambda: bfs.ids_to_msgs(real.msg_ids, uni.n_words), 10)
    plain = wall_ms(lambda: bfs.ids_to_msgs_plain(real.msg_ids, uni.n_words))
    entry(kernels.INFLATE, True, ms, plain, nb * (2 * cap_m + 4 * uni.n_words), nb * cap_m * 4,
          None)
    msgs = bfs.ids_to_msgs(fr.msg_ids, uni.n_words)
    dense = torch.from_numpy(gen.integers(-(1 << 31), (1 << 31) - 1, (G, uni.n_words),
                                          dtype=np.int64).astype(np.int32))
    density = gen.random((G, 1)) * 0.1  # per row: from a few ids to ~240 (> cap_m)
    dense &= torch.from_numpy((gen.random((G, uni.n_words)) < density).astype(np.int32) * -1)

    def deflate_plain(m):  # in row slices: the twin unpacks every bit
        parts = [bfs.msgs_to_ids_plain(m[i:i + 16384], uni.M, cap_m, torch.int16)
                 for i in range(0, m.shape[0], 16384)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    init = init_batch(chk.cfg, 1, dev).msgs  # the main path deflates the initial state
    ok = True
    for m in (msgs, dense.to(dev), init):
        a = bfs.msgs_to_ids(m, uni.M, cap_m, torch.int16)
        b = deflate_plain(m)
        ok &= _equal(a[0], b[0]) and _equal(a[1], b[1])
    check(ok, "deflate differs from its twin")
    # timed on one chunk of real states (the main path's one row is all launch cost)
    chunk_msgs = msgs[:nb]
    ms = cuda_ms(lambda: bfs.msgs_to_ids(chunk_msgs, uni.M, cap_m, torch.int16), 10)
    plain = wall_ms(lambda: deflate_plain(chunk_msgs))
    entry(kernels.DEFLATE, True, ms, plain, nb * (4 * uni.n_words + 2 * cap_m + 1),
          nb * uni.n_words * 8, None)

    # the invariant scan: every predicate (and two negations) on the real
    # frontier and on mixed rows, which break Inv
    names = sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]
    mixed = _mix_rows(fr, gen)
    ok = True
    for case in (fr, mixed):
        st = chk.inflate(case)
        for nm in names:
            a = chk.inv_scan(case, names=[nm])
            b = inv_scan_plain(chk.cfg, st, [nm], chk.tables)
            ok &= int(a) == int(b)
    a = chk.inv_scan(mixed, offset=7)
    ok &= int(a) >= 7 and int(a) == int(inv_scan_plain(chk.cfg, mixed, ["Inv"], chk.tables, 7))
    check(ok, "inv_scan differs from its twin")
    # timed at the main path's shape: one materialize slice of 8 chunks
    sl = _frontier_rows(fr, torch.arange(min(8 * B, n), device=dev))
    ns = sl.voted_for.shape[0]
    ms = cuda_ms(lambda: chk.inv_scan(sl), 10)
    plain = wall_ms(lambda: inv_scan_plain(chk.cfg, sl, ["Inv"], chk.tables))
    read_b = sum(getattr(fr, f)[0].numel() for f in
                 ("role", "current_term", "commit_index", "log_len", "log_term", "log_val"))
    S, L = chk.cfg.S, chk.cfg.L
    entry(kernels.INV_SCAN, True, ms, plain, ns * read_b + 8, ns * S * S * L * 4, None)

    # K4 probe-and-insert: a real level's candidates into the real slab,
    # and random fingerprints (duplicates, SENT lanes, slab members); each
    # call inserts into its own copy of the slab
    slab = chk.hstore.slab
    cvs, cfs, cps = [], [], []
    for start in range(0, min(n, 16 * B), B):
        part = Frontier(*(x[start:start + B] for x in fr))
        cv, cf, cp_, *_ = chk._expand_chunk(part, start)
        cvs.append(cv)
        cfs.append(cf)
        cps.append(cp_)
    cv, cf, cp_ = torch.cat(cvs), torch.cat(cfs), torch.cat(cps)
    N = cv.shape[0]
    live = slab[slab != -1]
    pool = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, N // 4, dtype=np.int64)).to(dev)
    rf = pool[torch.from_numpy(gen.integers(0, pool.shape[0], N)).to(dev)]
    take = torch.from_numpy(gen.random(N) < 0.3).to(dev)
    rf = torch.where(take, live[torch.from_numpy(gen.integers(0, live.shape[0], N)).to(dev)], rf)
    rf = torch.where(torch.from_numpy(gen.random(N) < 0.05).to(dev), torch.full_like(rf, -1), rf)
    rk = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, N, dtype=np.int64)).to(dev)
    rp = torch.from_numpy(gen.permutation(N).astype(np.int64)).to(dev)
    ok = True
    n_new = 0
    for args in ((cv, cf, cp_), (rf, rk, rp)):
        ks, kfr, kn, ko = kernels.probe_and_insert(slab.clone(), *args)
        ps, pfr, pn, po = hs.probe_and_insert_plain(slab.clone(), *args)
        ok &= (_equal(ks, ps) and _equal(kfr, pfr) and int(kn) == int(pn)
               and bool(ko) == bool(po))
        n_new = n_new or int(kn)
    check(ok, "K4 probe_and_insert differs from its twin")
    ms = _timed_insert(kernels.probe_and_insert, slab, (cv, cf, cp_), 10)
    plain = _timed_insert(hs.probe_and_insert_plain, slab, (cv, cf, cp_), 1)
    n_live = int((cv != -1).sum())
    # lanes: fp, key, payload in, fresh out; slab: at least one 32-B
    # sector read per live lane and one written per new fingerprint
    entry(kernels.HASHSTORE, True, ms, plain, N * 25 + (n_live + n_new) * 32, N * 64, None)

    # B9 (the compaction kernel's two-array form): the real insert's fresh
    # lanes packed to a prefix, as the level's dedup tail runs it; its own
    # time and bound go into the compact entry
    fresh = kernels.probe_and_insert(slab.clone(), cv, cf, cp_)[1]
    a = hs.compact_fresh(fresh, cv, cp_, N)
    b = hs.compact_fresh_plain(fresh, cv, cp_, N)
    check(all(_equal(x, y) for x, y in zip(a, b)), "B9 compact_fresh differs from its twin")
    kept = int(fresh.sum())
    b9_bytes = 2 * N + kept * 16 + N * 16
    comp = next(e for e in out if e["name"] == "compact")
    comp["b9"] = dict(
        ms=graph_ms(lambda: hs.compact_fresh(fresh, cv, cp_, N), 10),
        events_ms=cuda_ms(lambda: hs.compact_fresh(fresh, cv, cp_, N), 10),
        plain_ms=wall_ms(lambda: hs.compact_fresh_plain(fresh, cv, cp_, N)),
        bound_ms=b9_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: (torch.masked_select(cv, fresh),
                                    torch.masked_select(cp_, fresh)), 10),
        lanes=N, kept=kept)

    # B8 probe and B3 filter compaction at a grouped level's shapes: one
    # group's lanes (G * cap_x, the 16 chunks above) against the run's
    # slab into cap_g = G * cap_x / 2 lanes; B19 is the two in sequence
    from tla_raft_tpu_torch.engine import group
    from tla_raft_tpu_torch.u64 import mix64

    cap_g = 16 * G // 2
    ok = True
    for lanes_v in (cv, rf):
        ok &= _equal(hs.probe(slab, lanes_v), hs.probe_plain(slab, lanes_v))
    hit = hs.probe(slab, cv)
    keep = (cv != -1) & ~hit
    for cap in (cap_g, int(keep.sum()) // 2):  # fits; overflows
        ok &= all(_equal(a, b) for a, b in zip(group.filter_compact(hit, cv, cf, cp_, cap),
                                                group.filter_compact_plain(hit, cv, cf, cp_, cap)))
        ok &= all(_equal(a, b) for a, b in zip(
            group.group_filter_hash(cv, cf, cp_, slab, cap),
            group.filter_compact_plain(hs.probe_plain(slab, cv), cv, cf, cp_, cap)))
    check(ok, "hs_probe / filter_compact / group_filter_hash differ from their twins")
    keep_buf = torch.empty_like(keep)
    ms = cuda_ms(lambda: kernels.hs_probe(slab, cv, keep=keep_buf), 10)
    plain = wall_ms(lambda: hs.probe_plain(slab, cv))
    # the slab words each live lane's walk touches (one 32-B sector each)
    live_l = cv != -1
    idx = hs._probe_rounds(slab, cv)[0]
    walk = (((idx - (mix64(cv) & (slab.shape[0] - 1))) & (slab.shape[0] - 1)) + 1)[live_l]
    n_words_touched = int(walk.sum())
    # the library's membership test gives the same keep flags: SENT lanes
    # are never kept, since the slab (at most half full) holds SENT slots
    check(_equal(torch.isin(cv, slab, invert=True), keep), "isin differs from hs_probe's keep")
    lib = cuda_ms(lambda: torch.isin(cv, slab, invert=True), 10)
    entry(kernels.HS_PROBE, True, ms, plain, N * 9 + n_words_touched * 32, N * 40, lib)
    kept = int(keep.sum())
    ms = graph_ms(lambda: kernels.filter_compact(keep, cv, cf, cp_, cap_g), 10)
    events = cuda_ms(lambda: kernels.filter_compact(keep, cv, cf, cp_, cap_g), 10)
    plain = wall_ms(lambda: group.filter_compact_plain(hit, cv, cf, cp_, cap_g))
    lib = cuda_ms(lambda: (torch.masked_select(cv, keep), torch.masked_select(cf, keep),
                           torch.masked_select(cp_, keep)), 10)
    entry(kernels.FILTER_COMPACT, True, ms, plain, N + min(kept, cap_g) * 24 + cap_g * 24,
          N * 4, lib)
    fc = out[-1]
    fc["events_ms"] = events
    fc["b19"] = dict(
        ms=cuda_ms(lambda: group.group_filter_hash(cv, cf, cp_, slab, cap_g), 10),
        plain_ms=wall_ms(lambda: group.filter_compact_plain(hs.probe_plain(slab, cv), cv, cf,
                                                            cp_, cap_g)),
        bound_ms=(N * 8 + n_words_touched * 32 + min(kept, cap_g) * 24 + cap_g * 24)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None, lanes=N, kept=kept,
        cap_g=cap_g, slab_words_touched=n_words_touched)

    # B11 level control at the deep fused level's shapes: 256 chunks, the
    # run's slab, the survivors of a level of 2,150,466 (cap_out 2^22)
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.engine import superstep as ss
    from tla_raft_tpu_torch.ops import sieve

    cap_out = 1 << 22
    pidx_l, slot_l = chk.trace_levels[-1]
    n_lvl = len(pidx_l)
    pay = torch.full((cap_out,), -1, dtype=torch.int64, device=dev)
    pay[:n_lvl] = torch.from_numpy(pidx_l * K + slot_l).to(dev)
    totals = torch.from_numpy(gen.integers(0, G + 1, 256)).to(dev)
    n_run = torch.tensor(n, device=dev)

    def level_ctl(begin, gate, decide, live, fin):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=dev)
        mult = torch.ones((K,), dtype=torch.int64, device=dev)
        ctrl = torch.zeros((8,), dtype=torch.int64, device=dev)
        pidx = torch.zeros((cap_out,), dtype=torch.int32, device=dev)
        slot = torch.zeros((cap_out,), dtype=torch.int16, device=dev)

        def go():
            begin(lc, mult, n_run)
            gate(lc, totals, G, B)
            lc[mk.LC_N_NEW] = n_lvl
            decide(lc, cap_out)
            live(slab, lc[mk.LC_SLAB_LIVE])
            fin(lc, ctrl, pay, K, pidx, slot)

        return go, (lc, mult, ctrl, pidx, slot)

    kgo, kout = level_ctl(kernels.level_begin, kernels.level_gate, kernels.level_decide,
                          kernels.slab_live, kernels.level_finalize)
    pgo, pout = level_ctl(mk.level_begin_plain, mk.level_gate_plain, mk.level_decide_plain,
                          mk.slab_live_plain, mk.level_finalize_plain)
    kgo()
    pgo()
    check(all(_equal(x, y) for x, y in zip(kout, pout))
          and int(kout[0][mk.LC_SLAB_LIVE]) == chk.hstore.count,
          "B11 level control differs from its twin")
    ms = cuda_ms(kgo, 10)
    plain = wall_ms(pgo)
    entry(kernels.LEVEL, True, ms, plain, slab.shape[0] * 8 + cap_out * 14 + 256 * 8 + K * 16,
          slab.shape[0] + cap_out * 4, None)

    # the grouped level's control (lv_group_begin, lv_group_end per group,
    # then lv_tail_gate) over a depth-23 level's 20 groups of 16 chunks,
    # with the 16 real chunk totals above; then with one group's totals
    # past cap_x and another group's abort, which close the tail's gate
    rows_g, n_par = 16 * B, GOLDEN_LEVELS_REF[22]
    n_groups = -(-n_par // rows_g)
    real_tot = (cp_.view(-1, G) >= 0).sum(1)
    bad_tot = real_tot.clone()
    bad_tot[3] = G + 1
    n_par_t = torch.tensor(n_par, device=dev)

    def group_ctl(level_begin, begin, end, gate, bad):
        lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=dev)
        mult = torch.zeros((K,), dtype=torch.int64, device=dev)

        def go():
            level_begin(lc, mult, n_par_t)
            for g in range(n_groups):
                begin(lc, rows_g, K, cap_g)
                if bad and g == 7:
                    lc[group.LC_G_ABORT] = 12_345
                end(lc, bad_tot if bad and g == 5 else real_tot, G, rows_g)
            gate(lc, n_groups * cap_g)

        return go, lc

    kern = (kernels.level_begin, kernels.group_begin, kernels.group_end, kernels.tail_gate)
    twin = (mk.level_begin_plain, group.group_begin_plain, group.group_end_plain,
             group.tail_gate_plain)
    ok = True
    for bad in (False, True):
        (kgo, klc), (pgo, plc) = group_ctl(*kern, bad), group_ctl(*twin, bad)
        kgo()
        pgo()
        ok &= _equal(klc, plc) and int(klc[group.LC_GROUP]) == n_groups
        ok &= int(klc[mk.LC_LIVE_LANES]) == (0 if bad else n_groups * cap_g)
    check(ok, "grouped level control differs from its twin")
    kgo, pgo = group_ctl(*kern, False)[0], group_ctl(*twin, False)[0]
    # per group: the control words read and written, the 16 totals read
    ctl_b = n_groups * (2 * mk.LC_LEN * 8 + 16 * 8) + 2 * mk.LC_LEN * 8 + K * 8
    out[-1]["group"] = dict(
        ms=cuda_ms(kgo, 10), plain_ms=wall_ms(pgo), bound_ms=ctl_b / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, groups=n_groups, rows=rows_g, cap_g=cap_g)

    # B12 commit, ring append and frontier settle at the deep superstep's
    # shapes: cap_f 2^22, a committed level of 3,350,017 after one of
    # 2,150,466, a ring of 2^24, the frontier rows settled into buffer 0
    cap_f, ring, n_new2 = 1 << 22, 1 << 24, GOLDEN_LEVELS_REF[21]
    fps2 = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, cap_f,
                                         dtype=np.int64)).to(dev)
    pay2 = torch.from_numpy(gen.integers(0, n * K, cap_f)).to(dev)
    lc2 = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=dev)
    mk.level_begin_plain(lc2, torch.zeros((K,), dtype=torch.int64, device=dev), n_run)
    lc2[mk.LC_N_NEW] = n_new2
    mult2 = torch.from_numpy(gen.integers(0, 1 << 20, K)).to(dev)
    args2 = torch.tensor([n, 4, ring], device=dev)
    src = mk.empty_frontier(chk.cfg, cap_f, cap_m, dev)
    mk.copy_rows(src, fr, n)

    def superstep_ctl(begin, commit, append, settle):
        st = torch.zeros((ss.SS_LEN,), dtype=torch.int64, device=dev)
        mn = torch.zeros((4,), dtype=torch.int64, device=dev)
        mm = torch.zeros((4, K), dtype=torch.int64, device=dev)
        mr = torch.zeros((4,), dtype=torch.int64, device=dev)
        rf = torch.full((ring,), -1, dtype=torch.int64, device=dev)
        rp = torch.zeros((ring,), dtype=torch.int32, device=dev)
        rs = torch.zeros((ring,), dtype=torch.int16, device=dev)
        dst = mk.empty_frontier(chk.cfg, cap_f, cap_m, dev)

        def go():
            begin(st, args2)
            commit(st, lc2, mult2, cap_f, mn, mm, mr)
            append(st, lc2, fps2, pay2, K, rf, rp, rs)
            settle(st, src, dst)

        return go, (st, mn, mm, mr, rf, rp, rs, *dst)

    kgo, kout = superstep_ctl(kernels.ss_begin, kernels.ss_commit, kernels.ss_append,
                              kernels.ss_settle)
    pgo, pout = superstep_ctl(ss.ss_begin_plain, ss.ss_commit_plain, ss.ss_append_plain,
                              ss.ss_settle_plain)
    kgo()
    pgo()
    check(all(_equal(x, y) for x, y in zip(kout, pout)) and int(kout[0][ss.SS_LEVELS]) == 1,
          "B12 superstep commit / ring / settle differs from its twin")
    ms = cuda_ms(kgo, 10)
    plain = wall_ms(pgo)
    row_b = _core_bytes(fr) + 2 * cap_m
    entry(kernels.SUPERSTEP, True, ms, plain, K * 16 + n_new2 * 30 + 2 * n_new2 * row_b,
          n_new2 * 4, None)
    del src, kout, pout
    torch.cuda.empty_cache()

    # B13 sieve probe over a fused level's fresh lanes (cap_out, SENT past
    # n_new): the main path's all-miss sentinel, and a 2^20-word filter
    fps3 = torch.full((cap_out,), -1, dtype=torch.int64, device=dev)
    fps3[:n_lvl] = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, n_lvl,
                                                 dtype=np.int64)).to(dev)
    words = torch.from_numpy(gen.integers(-(1 << 63), (1 << 63) - 1, 1 << 20, dtype=np.int64)
                             & gen.integers(-(1 << 63), (1 << 63) - 1, 1 << 20,
                                            dtype=np.int64)).to(dev)
    ok = True
    for w in (sieve.empty_sieve(dev), words):
        kc = torch.zeros((), dtype=torch.int64, device=dev)
        pc = torch.zeros((), dtype=torch.int64, device=dev)
        kernels.sieve_probe(w, fps3, count=kc)
        pc += (sieve.probe_plain(w, fps3) & (fps3 != -1)).sum()
        ok &= int(kc) == int(pc) and _equal(sieve.probe(w, fps3), sieve.probe_plain(w, fps3))
    check(ok, "B13 sieve probe differs from its twin")
    empty, cnt = sieve.empty_sieve(dev), torch.zeros((), dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: kernels.sieve_probe(empty, fps3, count=cnt), 10)
    plain = wall_ms(lambda: (sieve.probe_plain(empty, fps3) & (fps3 != -1)).sum())
    entry(kernels.SIEVE, True, ms, plain, cap_out * 8 + 8, cap_out * 40, None)

    # B16 drop_rows over the depth-20 frontier (2,150,466 rows, a fused
    # level's output size) with 90 % of its rows kept, and the edge cases
    from tla_raft_tpu_torch.store import tiered

    ok = True
    for p in (0.0, 0.9, 1.0):
        kp = torch.from_numpy(gen.random(n) < p).to(dev)
        a = tiered.drop_rows(fr, kp, int(kp.sum()))
        b = tiered.drop_rows_plain(fr, kp, int(kp.sum()))
        ok &= all(_equal(x, y) for x, y in zip(a, b))
    check(ok, "B16 drop_rows differs from its twin")
    kp = torch.from_numpy(gen.random(n) < 0.9).to(dev)
    n_keep = int(kp.sum())
    ms = cuda_ms(lambda: tiered.drop_rows(fr, kp, n_keep), 10)
    plain = wall_ms(lambda: tiered.drop_rows_plain(fr, kp, n_keep))

    def library():
        rows_k = torch.nonzero(kp).reshape(-1)
        return [x.index_select(0, rows_k) for x in fr]

    lib = cuda_ms(library, 10)
    row_b = _core_bytes(fr) + 2 * cap_m
    entry(kernels.DROP_ROWS, True, ms, plain, n + n_keep * row_b + n * row_b, n * 4, lib)

    return out, dict(chunk=B, cap_x=G, cap_m=cap_m, slab_rows=slab.shape[0], dedup_lanes=N,
                     dedup_new=n_new, frontier_rows=n)


def phase_scale_kernels(runs: dict, launches: dict, seed: int) -> list:
    """The kernels at 5 and 7 servers against their twins, on the scale
    runs' last frontiers and on random id lists (ids >= 2^15 at S=7): K1 at
    K = 1,900 / 3,696, the compaction, K2, K3 (monolithic at S=5, factored
    at S=7), inflate and deflate with the config's id width, the invariant
    scan, K4, the grouped level's probe and filter, and the fused level's
    control: (the record of K3's factored mode (S=7), per-kernel times at
    both shapes with K3's at S=5 in full)."""
    import torch

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.engine import bfs, group
    from tla_raft_tpu_torch.engine import megakernel as mk
    from tla_raft_tpu_torch.engine.invariants import INVARIANT_KERNELS, inv_scan_plain
    from tla_raft_tpu_torch.models.raft import Frontier
    from tla_raft_tpu_torch.ops import hashstore as hs

    gen = np.random.default_rng(seed)
    dev = torch.device("cuda")
    out, times = [], {}
    for S, chk in runs.items():
        fr, mx, fpr, uni, K, B = chk.frontier, chk.mx, chk.fpr, chk.uni, chk.K, chk.chunk
        n, cap_m, G = fr.voted_for.shape[0], fr.msg_ids.shape[1], chk.cap_x
        idb = fr.msg_ids.element_size()
        row_b = _core_bytes(fr) + idb * cap_m
        t = times[S] = dict(frontier_rows=n, chunk=B, cap_x=G, cap_m=cap_m, id_bytes=idb)
        real = _frontier_rows(fr, torch.arange(min(B, n), device=dev))
        nb = real.voted_for.shape[0]
        rnd_ids = np.full((n, cap_m), -1, np.int64)
        for i, k in enumerate(gen.integers(0, cap_m + 1, n)):
            rnd_ids[i, :k] = np.sort(gen.choice(uni.M, k, replace=False))
        rnd = fr._replace(msg_ids=torch.from_numpy(rnd_ids).to(chk.id_dtype).to(dev))
        check(S != 7 or int(rnd.msg_ids.max()) >= 1 << 15, "S=7 random ids below 2^15")
        # K1
        st = chk.inflate(real)
        pv, pm, pa = zip(*(mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 1024] for x in real))))
                           for i in range(0, nb, 1024)))
        kv, km, ka = mx.guards(st)
        check(_equal(kv, torch.cat(pv)) and _equal(km, torch.cat(pm)) and _equal(ka, torch.cat(pa)),
              f"S={S}: K1 guards differs from its twin")
        t["guards_ms"] = graph_ms(lambda: mx.guards(st), 10)
        t["guards_events_ms"] = cuda_ms(lambda: mx.guards(st), 10)
        # the compaction and K2 (real candidates and random lanes over random ids)
        vflat = kv.reshape(-1)
        payload = (torch.arange(nb, device=dev)[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
        a = bfs.compact_payloads(vflat, payload, G)
        b = bfs.compact_payloads_plain(vflat, payload, G)
        check(all(_equal(x, y) for x, y in zip(a, b)), f"S={S}: compaction differs")
        cp, lane, _o = a
        live = int(lane.sum())
        lidx, slots = torch.div(cp, K, rounding_mode="floor").clamp(0, nb - 1), cp % K
        for par, pi, sl in ((real, lidx, slots),
                            (rnd, torch.from_numpy(gen.integers(0, n, G)).to(dev),
                             torch.from_numpy(gen.integers(0, K, G)).to(dev))):
            kc, kad, ko = mx.materialize(par, pi, sl)
            pc, pad_, po = mx.materialize_plain(par, pi, sl)
            check(all(_equal(x, y) for x, y in zip(kc, pc)) and _equal(kad, pad_)
                  and _equal(ko, po), f"S={S}: K2 materialize differs from its twin")
        children = mx.materialize(real, lidx, slots)[0]
        t["materialize_ms"] = graph_ms(lambda: mx.materialize(real, lidx, slots), 10)
        t["materialize_events_ms"] = cuda_ms(lambda: mx.materialize(real, lidx, slots), 10)
        # K3, counted as the fused level counts it: the live candidates
        cnt = torch.tensor(live, device=dev)
        outv = (torch.empty(G, dtype=torch.int64, device=dev),
                torch.empty(G, dtype=torch.int64, device=dev))
        kernels.fingerprints(fpr, children, out=outv, cnt=cnt)
        lv = Frontier(*(x[:live] for x in children))
        wv, wf = fpr.state_fingerprints_plain(lv)
        ok = _equal(outv[0][:live], wv) and _equal(outv[1][:live], wf)
        ok &= bool((outv[0][live:] == -1).all()) and bool((outv[1][live:] == -1).all())
        for case in (_frontier_rows(rnd, torch.arange(min(G, n), device=dev)),
                     _mix_rows(_frontier_rows(fr, torch.arange(min(G, n), device=dev)), gen)):
            ok &= all(_equal(x, y) for x, y in zip(fpr.state_fingerprints(case),
                                                   fpr.state_fingerprints_plain(case)))
        check(ok, f"S={S}: K3 differs from its twin")
        ms = graph_ms(lambda: kernels.fingerprints(fpr, children, out=outv, cnt=cnt), 10)
        events = cuda_ms(lambda: kernels.fingerprints(fpr, children, out=outv, cnt=cnt), 10)
        plain = wall_ms(lambda: fpr.state_fingerprints_plain(lv))
        F, ncols = fpr.C_planes.shape
        f_pad = fpr.ktab["f_pad"]
        n_ids = int((lv.msg_ids >= 0).sum())
        int8_ms = 2 * live * f_pad * ncols / INT8_TENSOR_OPS_PER_S * 1e3
        add_ms = n_ids * fpr.P * 4 / INT_OPS_PER_S * 1e3
        tab = fpr.ktab
        tab_b = tab["ct"].numel() + (tab["gt_eff"].numel() * 4 + tab["pperm"].numel()
                                     if fpr.factored_msgs else tab["msg_eff"].numel() * 4)
        feats = torch.nn.functional.pad(fpr.spec.features(lv), (0, f_pad - F))
        ct_t = tab["ct"].t().contiguous()
        lib = cuda_ms(lambda: torch._int_mm(feats, ct_t), 10) if live > 16 else None
        rec = _entry([], launches, kernels.MSG_FACTORED if S == 7 else kernels.FINGERPRINT,
                     ms, plain, live * (row_b + 16) + tab_b, None if S == 7 else lib,
                     ops_ms=int8_ms + add_ms)
        rec.update(servers=S, lanes=live, P=fpr.P, F=F, f_pad=f_pad, set_ids=n_ids,
                   feature_int_mm_ms=lib, events_ms=events)
        if fpr.factored_msgs:
            rec.update(_k3_design(fpr, lv.msg_ids))
        if S == 7:
            out.append(rec)
        t["fingerprint"] = rec
        # inflate / deflate with the config's id width
        msgs = bfs.ids_to_msgs(fr.msg_ids, uni.n_words)
        ok = _equal(msgs, bfs.ids_to_msgs_plain(fr.msg_ids, uni.n_words))
        rmsgs = bfs.ids_to_msgs(rnd.msg_ids, uni.n_words)
        ok &= _equal(rmsgs, bfs.ids_to_msgs_plain(rnd.msg_ids, uni.n_words))
        for m in (msgs[:16384], rmsgs[:16384]):
            for cm in (cap_m, 6):
                x = bfs.msgs_to_ids(m, uni.M, cm, chk.id_dtype)
                y = bfs.msgs_to_ids_plain(m, uni.M, cm, chk.id_dtype)
                ok &= _equal(x[0], y[0]) and _equal(x[1], y[1])
        check(ok, f"S={S}: inflate / deflate differ from their twins")
        t["inflate_ms"] = cuda_ms(lambda: bfs.ids_to_msgs(real.msg_ids, uni.n_words), 10)
        t["deflate_ms"] = cuda_ms(lambda: bfs.msgs_to_ids(msgs[:nb], uni.M, cap_m, chk.id_dtype),
                                  10)
        # the invariant scan: every predicate on the frontier and mixed rows
        mixed = _mix_rows(fr, gen)
        ok = True
        for case in (fr, mixed):
            cst = chk.inflate(case)
            for nm in sorted(INVARIANT_KERNELS) + ["~NoSplitVote", "~CommitAll"]:
                ok &= int(chk.inv_scan(case, names=[nm])) == int(
                    inv_scan_plain(chk.cfg, cst, [nm], chk.tables))
        check(ok, f"S={S}: inv_scan differs from its twin")
        sl = _frontier_rows(fr, torch.arange(min(8 * B, n), device=dev))
        t["inv_scan_ms"] = cuda_ms(lambda: chk.inv_scan(sl), 10)
        # K4, the grouped level's probe and filter, over up to 16 chunks' candidates
        slab = chk.hstore.slab
        lanes = [chk._expand_chunk(Frontier(*(x[a:a + B] for x in fr)), a)[:3]
                 for a in range(0, min(n, 16 * B), B)]
        cv, cf, cpp = (torch.cat(z) for z in zip(*lanes))
        ks_, kfr, kn, ko = kernels.probe_and_insert(slab.clone(), cv, cf, cpp)
        ps_, pfr, pn, po = hs.probe_and_insert_plain(slab.clone(), cv, cf, cpp)
        check(_equal(ks_, ps_) and _equal(kfr, pfr) and int(kn) == int(pn)
              and bool(ko) == bool(po), f"S={S}: K4 differs from its twin")
        hit = hs.probe(slab, cv)
        ok = _equal(hit, hs.probe_plain(slab, cv))
        cap_g = chk.G * G // 2
        ok &= all(_equal(x, y) for x, y in zip(group.filter_compact(hit, cv, cf, cpp, cap_g),
                                                group.filter_compact_plain(hit, cv, cf, cpp,
                                                                           cap_g)))
        check(ok, f"S={S}: hs_probe / filter_compact differ from their twins")
        t["hashstore_ms"] = _timed_insert(kernels.probe_and_insert, slab, (cv, cf, cpp), 5)
        t["k4_lanes"] = cv.shape[0]
        # the fused level's control over K slots
        n_run = torch.tensor(n, device=dev)
        totals = torch.from_numpy(gen.integers(0, G + 1, 16)).to(dev)
        res = []
        for fns in ((kernels.level_begin, kernels.level_gate, kernels.level_decide,
                     kernels.slab_live, kernels.level_finalize),
                    (mk.level_begin_plain, mk.level_gate_plain, mk.level_decide_plain,
                     mk.slab_live_plain, mk.level_finalize_plain)):
            lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device=dev)
            mult = torch.ones((K,), dtype=torch.int64, device=dev)
            ctrl = torch.zeros((8,), dtype=torch.int64, device=dev)
            pidx = torch.zeros((cpp.shape[0],), dtype=torch.int32, device=dev)
            slot = torch.zeros((cpp.shape[0],), dtype=torch.int16, device=dev)
            fns[0](lc, mult, n_run)
            fns[1](lc, totals, G, B)
            lc[mk.LC_N_NEW] = int(kn)
            fns[2](lc, cpp.shape[0])
            fns[3](slab, lc[mk.LC_SLAB_LIVE])
            fns[4](lc, ctrl, cpp, K, pidx, slot)
            res.append((lc, mult, ctrl, pidx, slot))
        check(all(_equal(x, y) for x, y in zip(*res)), f"S={S}: level control differs")
    return out, times


def _profiled(fn):
    """(result, wall ms, device busy ms, top kernels) of ``fn`` under
    torch.profiler; busy = the sum of kernel times (graph-launched
    kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel records only: the CPU op that launched a kernel reports
        # the same device time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return res, wall, sum(r[1] for r in rows), [[k, round(ms, 4), c] for k, ms, c in rows[:14]]


def phase_profile(chk) -> None:
    """One more level from the staged run's depth-20 frontier (2,150,466
    parents), on the staged chain and as one fused-level graph (captured
    first), each on its own copy of the slab: the wall of a timed run, then
    kernel time by name under torch.profiler, and the device's idle share
    (1 - kernel time / the timed wall; the profiler's own tracing slows the
    host, so its wall is printed apart).  Reported, not gated."""
    from tla_raft_tpu_torch import device as D
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker
    from tla_raft_tpu_torch.ops import hashstore as hs

    fr = chk.frontier
    n = fr.voted_for.shape[0]

    def staged():
        res = chk.expand_level(fr, n, chk.hstore.slab.clone())
        if res["n_new"]:  # an overflowed level inserts nothing (the run would redo it)
            chk.materialize_level(fr, res["new_payload"], res["n_new"])
        return res

    staged()  # warm
    wall = wall_ms(staged)
    D.READS.clear()
    res, pwall, busy, top = _profiled(staged)
    emit(dict(phase="profile", path="staged", parents=n, n_new=res["n_new"],
              overflow=[res["ovf_x"], res["ovf_h"], res["ovf_m"]], wall_ms=wall,
              profiled_wall_ms=pwall, device_busy_ms=busy,
              device_idle_share=max(0.0, 1 - busy / wall), reads=_reads_total(D.READS),
              top=top))

    fchk = TorchChecker(RaftConfig(), device="cuda", chunk=chk.chunk, cap_x=chk.cap_x,
                        cap_m=chk.cap_m, superstep=1)
    fchk.hstore = hs.DeviceHashStore(chk.hstore.cap, chk.hstore.count, "cuda")
    fchk.hstore.slab = chk.hstore.slab.clone()
    slab0 = fchk.hstore.slab.clone()
    sizes = GOLDEN_LEVELS_REF[: DEPTH + 1]

    def fused():
        out = fchk._expand_level_mega(fr, n, None, sizes)
        timing = dict(fchk.level_timing)
        if fchk.hstore.slab.shape == slab0.shape:
            fchk.hstore.slab.copy_(slab0)  # in place: the captured graph keeps its slab
        else:  # the run grew the slab: the next run captures again
            fchk.hstore.slab = slab0.clone()
        return out, timing

    fused()  # capture (and any redo) outside the timed runs
    captures = fchk.graph_stats["captures"]
    wall = wall_ms(fused)
    timing = dict(fchk.level_timing)
    D.READS.clear()
    launches = fchk.graph_stats["level_launches"]
    (res, _t), pwall, busy, top = _profiled(fused)
    emit(dict(phase="profile", path="fused", parents=n, n_new=res["n_new"], wall_ms=wall,
              profiled_wall_ms=pwall, device_busy_ms=busy,
              device_idle_share=max(0.0, 1 - busy / wall),
              host_seconds=timing, graph_launches=fchk.graph_stats["level_launches"] - launches,
              reads=_reads_total(D.READS), captures=captures,
              recaptures=fchk.graph_stats["captures"] - captures,
              capture_seconds=fchk.graph_stats["capture_seconds"], top=top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from tla_raft_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the tla_raft_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    failures = []

    def run(name, need, fn, *a, counts_check=None):
        """One main-path phase, with its own launch counts: every count is
        set to 0 just before the phase and read just after it; every
        kernel in ``need`` must have launched, and ``counts_check`` (if
        any) holds the counts to what the phase's route may launch."""
        kernels.reset_launches()
        try:
            res = fn(*a)
        except Failed as e:
            failures.append(f"{name}: {e}")
            emit(dict(phase=name, failed=str(e)))
            res = None
        counts = kernels.launch_counts()
        emit(dict(phase=f"{name}_launches", launches=counts))
        idle = sorted(k for k in need if counts[k] == 0)
        if idle:
            failures.append(f"{name}: kernels never launched on this path: {idle}")
        if counts_check is not None:
            try:
                counts_check(counts)
            except Failed as e:
                failures.append(f"{name}: {e}")
                emit(dict(phase=name, failed=str(e)))
        return res, counts

    t0 = time.perf_counter()
    kernels.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels=sorted(kernels.KERNELS)))
    fused = kernels.FUSED
    staged, _ = run("staged", kernels.STAGED, phase_staged, DEPTH, CHUNK)
    chk, staged_digests = staged if staged else (None, None)
    default_digests, launches = run(
        "default", [k for k in kernels.KERNELS
                    if k not in ("drop_rows",) + kernels.SCALE + kernels.ORBIT_PATH
                    + kernels.EXPAND_PATH + kernels.LEGACY_PATH + kernels.SORTED_PATH
                    + kernels.BUCKET_PATH + kernels.HOST_PATH + kernels.MESH_PATH
                    + kernels.DEEP_PATH],
        phase_default, DEPTH_DEFAULT, CHUNK)
    if staged_digests and default_digests:
        try:
            phase_digests(staged_digests, default_digests, DEPTH)
        except Failed as e:
            failures.append(f"digests: {e}")
    run("fixpoint", fused, phase_fixpoint, CHUNK)
    run("trace", fused, phase_trace, CHUNK)
    run("drill", fused, phase_drill)
    run("grouped", kernels.STAGED + ("level",) + kernels.GROUPED, phase_grouped, DEPTH_GROUPED,
        CHUNK)
    _res, tier_launches = run("tiered", fused + ("drop_rows",), phase_tiered, DEPTH_TIERED, CHUNK,
                              TIER_BYTES)
    launches = dict(launches, drop_rows=tier_launches["drop_rows"])
    # 5 and 7 servers: K3 with its factored message part at 7
    runs, scale_launches = run("scale", fused + kernels.SCALE, phase_scale)
    launches.update({k: scale_launches[k] for k in kernels.SCALE})
    # orbit pruning: the staged and grouped chains with the orbit pair
    orbit_runs, orbit_launches = run(
        "orbit", ("guards", "materialize", "fingerprint", "hashstore", "compact", "inflate",
                  "deflate", "inv_scan", "level") + kernels.GROUPED + kernels.SCALE
        + kernels.ORBIT_PATH, phase_orbit)
    launches.update({k: orbit_launches[k] for k in kernels.ORBIT_PATH})
    # the cross-check arms: canon="expand", the legacy kernels, the audit;
    # each arm's run is a phase of its own, and so is each run beside it
    tail = ("hashstore", "compact", "inflate", "deflate", "inv_scan", "level")
    canon, canon_launches = run(
        "canon", kernels.EXPAND_PATH + tail + ("materialize", "superstep") + kernels.GROUPED,
        phase_canon, DEPTH_CANON, CHUNK, counts_check=canon_counts)
    launches.update({k: canon_launches[k] for k in kernels.EXPAND_PATH})
    if canon is not None:
        run("canon_baseline", fused, phase_baseline, "canon_baseline", DEPTH_CANON, CHUNK, canon)
    canon = None
    _res, legacy_launches = run("legacy", kernels.LEGACY_PATH + tail + ("fingerprint", "superstep"),
                                phase_legacy, DEPTH_LEGACY, CHUNK, counts_check=legacy_counts)
    launches["legacy_materialize"] = legacy_launches["legacy_materialize"]
    run("legacy_baseline", fused, phase_baseline, "legacy_baseline", DEPTH_LEGACY, CHUNK)
    run("legacy_fixpoint", kernels.EXPAND_PATH + kernels.LEGACY_PATH, phase_legacy_fixpoint,
        CHUNK, counts_check=legacy_counts)
    run("audit", kernels.LEGACY_PATH + tail + ("guards", "materialize", "fingerprint"),
        phase_audit, DEPTH_AUDIT, CHUNK, AUDIT_ROWS)
    run("audit_baseline", fused, phase_baseline, "audit_baseline", DEPTH_AUDIT, CHUNK)
    run("flip_drill", kernels.LEGACY_PATH, phase_flip_drill)
    # the sorted visited store, its fallback from the hash slab, the CLI on a cfg
    eager = ("guards", "materialize", "fingerprint", "compact", "inflate", "inv_scan",
             "filter_compact")
    sorted_out, sorted_launches = run("sorted", kernels.SORTED_PATH + eager, phase_sorted,
                                      DEPTH_DEFAULT, CHUNK, counts_check=sorted_counts)
    launches.update({k: sorted_launches[k] for k in kernels.SORTED_PATH})
    run("degrade", kernels.SORTED_PATH + eager, phase_degrade, DEPTH_DEGRADE, CHUNK)
    run("cli", (), phase_cli, DEPTH)
    # slice 8: the delta log (in CLI subprocesses: no launch in this process),
    # the bucket core, its members' sequential runs, the sweep service
    run("checkpoint", (), phase_checkpoint, DEPTH_CHECKPOINT)
    bucket_path = kernels.BUCKET_PATH + ("dense_expand", "chunk_compact", "hashstore", "compact",
                                         "inflate", "materialize", "inv_scan", "level",
                                         "superstep")
    bucket_results, bucket_launches = run("bucket", bucket_path, phase_bucket, CHUNK)
    launches.update({k: bucket_launches[k] for k in kernels.BUCKET_PATH})
    if bucket_results:
        run("bucket_sequential", fused, phase_bucket_sequential, CHUNK, bucket_results)
    run("service", bucket_path + fused, phase_service, CHUNK)
    # slice 9: the external store route (--fpstore-dir)
    host_path = kernels.HOST_PATH + ("guards", "compact", "inflate", "materialize",
                                     "fingerprint", "deflate", "inv_scan")
    fps_out, fps_launches = run("fpstore", host_path, phase_fpstore, DEPTH_FPSTORE, CHUNK,
                                counts_check=host_counts)
    launches.update({k: fps_launches[k] for k in kernels.HOST_PATH})
    paged, _ = run("fpstore_paged", host_path, phase_fpstore_paged, DEPTH_FPSTORE_PAGED, CHUNK,
                   fps_out["digests"] if fps_out else None, counts_check=host_counts)
    if paged:
        run("fpstore_kill", (), phase_fpstore_kill, DEPTH_FPSTORE_PAGED, paged["ck"])
    else:
        failures.append("fpstore_kill: no clean checkpointed run to compare with")
    # the device mesh, D shards on the one card
    mesh_path = kernels.MESH_PATH + ("guards", "compact", "inflate", "materialize",
                                     "fingerprint", "group_unique", "hashstore", "deflate",
                                     "inv_scan")
    never_mesh = ("level", "superstep", "hs_probe", "filter_compact", "level_dedup", "sieve",
                  "drop_rows") + kernels.BUCKET_PATH

    def mesh_counts(c: dict) -> None:
        check(all(c[k] == 0 for k in never_mesh),
              "single-device kernels launched on the mesh: "
              + str({k: c[k] for k in never_mesh if c[k]}))

    def hosted_counts(c: dict) -> None:
        mesh_counts(c)
        check(c["hashstore"] == 0, f"K4 launched {c['hashstore']} times on the host stores")

    def gather_counts(c: dict) -> None:
        mesh_counts(c)
        mesh_gather_counts(c)

    mesh_base, _ = run("mesh_baseline", fused, phase_mesh_baseline,
                       (DEPTH_MESH_HOSTED, DEPTH_MESH, DEPTH_MESH_DEEP), CHUNK)
    mesh_kept = None
    if mesh_base:
        mesh_kept, mesh_launches = run("mesh", mesh_path, phase_mesh, DEPTH_MESH, CHUNK,
                                       mesh_base, counts_check=mesh_counts)
        launches.update({k: mesh_launches[k] for k in kernels.MESH_PATH})
    run("mesh_exchange", mesh_path, phase_mesh_exchange, DEPTH_MESH, CHUNK,
        counts_check=mesh_counts)
    run("mesh_gather", ("guards", "compact", "materialize", "fingerprint", "group_unique",
                        "sorted_member", "merge_sorted", "inv_scan"),
        phase_mesh_gather, DEPTH_MESH_GATHER, CHUNK, counts_check=gather_counts)
    if mesh_base:
        run("mesh_hosted", kernels.MESH_PATH + ("guards", "compact", "materialize",
                                                "fingerprint", "group_unique", "inv_scan"),
            phase_mesh_hosted, DEPTH_MESH_HOSTED, CHUNK, mesh_base, counts_check=hosted_counts)
    else:
        failures.append("mesh, mesh_hosted: no default-path witness to compare with")
    # slice 11: the sharded deep sweep
    deep_core = kernels.MESH_PATH + ("guards", "compact", "inflate", "materialize",
                                     "fingerprint", "group_unique", "inv_scan")
    deep_kept = None
    if mesh_base:
        deep_kept, deep_launches = run(
            "mesh_deep", deep_core + ("pack_deltas", "deep_verdict", "deep_repack", "hs_probe",
                                      "insert_only"),
            phase_mesh_deep, DEPTH_MESH_DEEP, CHUNK, mesh_base, counts_check=deep_counts)
        launches.update({k: deep_launches[k] for k in ("pack_deltas", "deep_verdict",
                                                       "deep_repack")})
    else:
        failures.append("mesh_deep: no default-path witness to compare with")
    mesh_base = None
    _res, sorted_deep_launches = run(
        "mesh_deep_sorted", deep_core + ("sieve_merge", "sorted_member", "deep_verdict",
                                         "deep_repack"),
        phase_mesh_deep_sorted, DEPTH_MESH_DEEP_SORTED, CHUNK, counts_check=deep_sorted_counts)
    launches["sieve_merge"] = sorted_deep_launches["sieve_merge"]
    run("mesh_deep_nosieve", deep_core + ("pack_deltas", "deep_verdict", "deep_repack"),
        phase_mesh_deep_nosieve, DEPTH_MESH_DEEP_NOSIEVE, CHUNK, counts_check=deep_nosieve_counts)
    run("mesh_deep_trace", deep_core + ("deep_verdict", "deep_repack"), phase_mesh_deep_trace,
        CHUNK, counts_check=deep_counts)
    run("mesh_deep_cli", (), phase_mesh_deep_cli, DEPTH_MESH_DEEP_CLI)
    run("mesh_trace", kernels.MESH_PATH + ("hashstore", "group_unique"), phase_mesh_trace,
        CHUNK, counts_check=mesh_counts)
    run("mesh_cli", (), phase_mesh_cli, DEPTH_MESH_CLI)
    records, shapes, scale_times, orbit_shapes = [], None, None, None
    if not mesh_kept:
        failures.append("mesh_kernels: no mesh run to test on")
    else:
        try:
            records += phase_mesh_kernels(mesh_kept, launches, SEED)
        except Failed as e:
            failures.append(f"mesh_kernels: {e}")
            emit(dict(phase="mesh_kernels", failed=str(e)))
    mesh_kept = None
    if not deep_kept:
        failures.append("deep_kernels: no deep run to test on")
    else:
        try:
            records += phase_deep_kernels(deep_kept, launches)
        except Failed as e:
            failures.append(f"deep_kernels: {e}")
            emit(dict(phase="deep_kernels", failed=str(e)))
    deep_kept = None
    if not bucket_results:
        failures.append("bucket_kernels: no bucket run to test on")
    else:
        try:
            records += phase_bucket_kernels(CHUNK, launches)
        except Failed as e:
            failures.append(f"bucket_kernels: {e}")
            emit(dict(phase="bucket_kernels", failed=str(e)))
    torch.cuda.empty_cache()
    for name, fn, args in (("twins", phase_twins, (CHUNK,)),
                           ("kernels", phase_kernels, (chk, launches, SEED)),
                           ("scale_kernels", phase_scale_kernels, (runs, launches, SEED)),
                           ("orbit_kernels", phase_orbit_kernels,
                            ((orbit_runs or {}).get(7), launches)),
                           ("cross_kernels", phase_cross_kernels, (chk, launches, SEED)),
                           ("sorted_kernels", phase_sorted_kernels, (launches,)),
                           ("host_kernels", phase_host_kernels,
                            ((fps_out or {}).get("lanes"), launches, SEED))):
        if chk is None or (name == "scale_kernels" and not runs) or (
                name == "orbit_kernels" and not orbit_runs) or (
                name == "sorted_kernels" and not sorted_out) or (
                name == "host_kernels" and not fps_out):
            failures.append(f"{name}: no reference run to test on")
            continue
        try:
            res = fn(*args)
        except Failed as e:
            failures.append(f"{name}: {e}")
            emit(dict(phase=name, failed=str(e)))
            continue
        if name == "kernels":
            records, shapes = records + res[0], res[1]
        elif name == "scale_kernels":
            records += res[0]
            scale_times = res[1]
        elif name == "orbit_kernels":
            records += res[0]
            orbit_shapes = res[1]
        elif name in ("cross_kernels", "sorted_kernels", "host_kernels"):
            records += res
    runs = orbit_runs = fps_out = None  # free the runs' frontiers, slabs and lanes
    torch.cuda.empty_cache()
    emit(dict(kernels=records, shapes=shapes, scale=scale_times, orbit=orbit_shapes))
    if chk is not None:
        phase_profile(chk)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    emit(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
