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
                golden; the per-level share of tied candidates of each run
                and the launches of orbit, orbit_fold and K3's factored mode;
   Each of phases 2-10 sets every kernel's launch count to 0 just before it
   runs, prints the counts just after, and fails if a kernel of its path
   did not launch (the staged phase: the staged chain's eight; the default
   phase: every kernel but drop_rows, K3's factored mode and the orbit
   pair; the tiered phase: the fused path's eleven and drop_rows; the
   grouped phase: the staged chain's, level, hs_probe and filter_compact;
   the scale phase: the fused path's eleven and K3's factored mode; the
   orbit phase: the staged chain's, the grouped level's, K3's factored
   mode, orbit and orbit_fold; the others: the fused path's eleven).  The
   default phase also prints graph launches and device-to-host reads per
   superstep and per fused level, each grouped level's reads, graph
   launches, K4 rounds, cap_g, lanes (against the ungrouped lane count)
   and seconds, the levels by route, the graph captures and their
   seconds, and peak device memory.
11. twins     — one fused level and one superstep (two levels) on the
                card against the CPU twins from the same carried depth-9
                frontier and slab: every output equal;
12. kernels   — each kernel against its plain torch twin on the card, at
                the main path's shapes, with times, bounds and the launches
                of its phase (drop_rows: the tiered phase; K3's factored
                mode: the scale phase; orbit and orbit_fold: the orbit
                phase, on a chunk of its 7-server run's last frontier,
                with K3's full fold of the same chunk timed beside; the
                rest: the default phase); then
                the kernels again at 5 and 7 servers on the scale runs'
                frontiers (K1 at K = 1,900 / 3,696, K2, inflate and deflate
                with int32 ids, K3 at P = 120 and factored at P = 5,040,
                inv_scan, K4, hs_probe, filter_compact, level control),
                all in one ``kernels`` line;
13. profile   — one deep level (2,150,466 parents) on the staged chain and
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
    before = kernels.launch_counts()
    D.READS.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
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
               cache_release_seconds=release_s,
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
    chunk_ms = cuda_ms(lambda: fpr.orbit_chunk_fps(children, chk.cap_nd, cnt, out=outs,
                                                   scratch=scr), 10)
    k3 = (torch.empty(G, dtype=torch.int64, device=dev), torch.empty(G, dtype=torch.int64,
                                                                       device=dev))
    k3_ms = cuda_ms(lambda: kernels.fingerprints(fpr, children, out=k3, cnt=cnt), 3)
    return out, dict(servers=S, frontier_rows=fr.voted_for.shape[0], parents=nb, lanes=live,
                     cap_x=G, cap_nd=chk.cap_nd, tied=tied, orbit_chunk_path_ms=chunk_ms,
                     k3_full_fold_ms=k3_ms)


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
    ms = cuda_ms(lambda: mx.guards(st_real), 10)
    plain = wall_ms(lambda: [mx.guards_plain(chk.inflate(Frontier(*(x[i:i + 2048] for x in real))))
                             for i in range(0, real.voted_for.shape[0], 2048)])
    nb = real.voted_for.shape[0]
    entry(kernels.GUARDS, True, ms, plain,
          nb * (core_b + uni.n_words * 4) + K * 24 + nb * K * 5 + nb, nb * K * 32, None)

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
    ms = cuda_ms(lambda: bfs.compact_payloads(vflat, payload, G), 10)
    plain = wall_ms(lambda: bfs.compact_payloads_plain(vflat, payload, G))
    lib = cuda_ms(lambda: torch.masked_select(payload, vflat), 10)
    kept = int(vflat.sum())
    entry(kernels.COMPACT, True, ms, plain, vflat.shape[0] + kept * 8 + G * 9,
          vflat.shape[0] * 4, lib)

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
    ms = cuda_ms(lambda: mx.materialize(real, lidx, slots), 10)
    plain = wall_ms(lambda: mx.materialize_plain(real, lidx, slots))
    row_b = core_b + 2 * cap_m
    entry(kernels.MATERIALIZE, True, ms, plain, G * (2 * row_b + 16 + 4 * mx.A + 1),
          G * (cap_m * 4 + 64), None)

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
    ms = cuda_ms(lambda: fpr.state_fingerprints(children), 10)
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
        ms=cuda_ms(lambda: hs.compact_fresh(fresh, cv, cp_, N), 10),
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
    ms = cuda_ms(lambda: kernels.filter_compact(keep, cv, cf, cp_, cap_g), 10)
    plain = wall_ms(lambda: group.filter_compact_plain(hit, cv, cf, cp_, cap_g))
    lib = cuda_ms(lambda: (torch.masked_select(cv, keep), torch.masked_select(cf, keep),
                           torch.masked_select(cp_, keep)), 10)
    entry(kernels.FILTER_COMPACT, True, ms, plain, N + min(kept, cap_g) * 24 + cap_g * 24,
          N * 4, lib)
    fc = out[-1]
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
        t["guards_ms"] = cuda_ms(lambda: mx.guards(st), 10)
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
        t["materialize_ms"] = cuda_ms(lambda: mx.materialize(real, lidx, slots), 10)
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
        ms = cuda_ms(lambda: kernels.fingerprints(fpr, children, out=outv, cnt=cnt), 10)
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
                   feature_int_mm_ms=lib)
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

    def run(name, need, fn, *a):
        """One main-path phase, with its own launch counts: every count is
        set to 0 just before the phase and read just after it; every
        kernel in ``need`` must have launched."""
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
                    if k not in ("drop_rows",) + kernels.SCALE + kernels.ORBIT_PATH],
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
    records, shapes, scale_times, orbit_shapes = [], None, None, None
    for name, fn, args in (("twins", phase_twins, (CHUNK,)),
                           ("kernels", phase_kernels, (chk, launches, SEED)),
                           ("scale_kernels", phase_scale_kernels, (runs, launches, SEED)),
                           ("orbit_kernels", phase_orbit_kernels,
                            ((orbit_runs or {}).get(7), launches))):
        if chk is None or (name == "scale_kernels" and not runs) or (
                name == "orbit_kernels" and not orbit_runs):
            failures.append(f"{name}: no reference run to test on")
            continue
        try:
            res = fn(*args)
        except Failed as e:
            failures.append(f"{name}: {e}")
            emit(dict(phase=name, failed=str(e)))
            continue
        if name == "kernels":
            records, shapes = res
        elif name == "scale_kernels":
            records += res[0]
            scale_times = res[1]
        elif name == "orbit_kernels":
            records += res[0]
            orbit_shapes = res[1]
    runs = orbit_runs = None  # free the scale and orbit runs' frontiers and slabs
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
