#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build      — compile every CUDA kernel from tla_raft_tpu_torch/csrc
                (one nvcc per source, all at once);
2. reference  — the Raft.cfg constants (S=3, V=2, MaxElection=3,
                MaxRestart=3, symmetry + VIEW) to depth 20, every level
                held against the golden per-level counts, and the
                depth-12 prefix against its golden generated count;
3. fixpoint   — (3,1,2,1) to its fixpoint: 180,582 distinct, 747,500
                generated, depth 35;
4. trace      — the median-bug mutation on (3,1,2,0): the pinned
                violation depth, level sizes and counterexample trace;
   Each of phases 2-4 sets every kernel's launch count to 0 just before
   it runs, prints the counts just after, and fails if a kernel did not
   launch: the proof that each path ran through the kernels.
5. kernels    — each kernel against its plain torch twin on the card, at
                the main path's shapes, on seeded random inputs and on
                the reference run's last frontier: exact equality of
                every output, with times and bounds, and the launches of
                the reference run;
6. profile    — one more level from that frontier under torch.profiler:
                kernel time by name and the device's busy share.

Then the card's name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits nonzero and prints
no result; so does a machine without CUDA, or a directory without the
package.  The golden numbers are constants here: this script imports
nothing of the JAX package.
"""

from __future__ import annotations

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
DEPTH = 20  # of the reference prefix
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


def phase_reference(depth: int, chunk: int):
    import torch

    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    levels = []
    chk = TorchChecker(RaftConfig(), device="cuda", chunk=chunk, progress=levels.append)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = chk.run(max_depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = GOLDEN_LEVELS_REF[: depth + 1]
    gen12 = next((lv["generated"] for lv in levels if lv["level"] == 12), None)
    elapsed = [lv["elapsed"] for lv in levels]
    emit(dict(
        phase="reference", depth=res.depth, distinct=res.distinct, generated=res.generated,
        level_sizes=list(res.level_sizes), generated_at_12=gen12, seconds=secs,
        distinct_per_s=res.distinct / secs,
        peak_bytes=torch.cuda.max_memory_allocated(),
        level_seconds=[b - a for a, b in zip([0.0] + elapsed[:-1], elapsed)],
        slab_rows=chk.hstore.cap, cap_x=chk.cap_x, cap_m=chk.cap_m, redos=chk.redos,
    ))
    check(res.ok, "reference run reported a violation")
    check(list(res.level_sizes) == want, f"level sizes {res.level_sizes} != golden {want}")
    check(depth < 12 or gen12 == GENERATED_AT_12, f"generated at depth 12: {gen12}")
    return chk


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


def phase_kernels(chk, launches: dict, seed: int) -> None:
    """Each kernel against its plain twin on real and seeded random inputs."""
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

    def entry(k, err_ok, ms, plain_ms, bytes_, ops, lib_ms, ops_rate=INT_OPS_PER_S):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
        out.append(dict(
            name=k.name, route="cuda", source=f"tla_raft_tpu_torch/{k.source}",
            replaces=k.replaces, launches=launches[k.name], equal=err_ok,
            max_abs_err=0 if err_ok else None, ms=ms, plain_ms=plain_ms,
            bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
            library_ms=lib_ms,
        ))

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
    emit(dict(kernels=out, shapes=dict(chunk=B, cap_x=G, cap_m=cap_m, slab_rows=slab.shape[0],
                                        dedup_lanes=N, dedup_new=n_new, frontier_rows=n)))


def phase_profile(chk) -> None:
    """One more level from the reference run's last frontier (expand,
    dedup, materialize) under torch.profiler: kernel time by name and the
    device's busy share of the wall time.  Reported, not gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fr = chk.frontier
    n = fr.voted_for.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = chk.expand_level(fr, n, chk.hstore.slab.clone())
        t1 = time.perf_counter()
        if res["n_new"]:  # an overflowed level inserts nothing (the run would redo it)
            chk.materialize_level(fr, res["new_payload"], res["n_new"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
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
    busy = sum(r[1] for r in rows)
    wall = (t2 - t0) * 1e3
    emit(dict(phase="profile", parents=n, n_new=res["n_new"], overflow=[res["ovf_x"],
              res["ovf_h"], res["ovf_m"]], expand_ms=(t1 - t0) * 1e3,
              materialize_ms=(t2 - t1) * 1e3, wall_ms=wall, device_busy_ms=busy,
              device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
              top=[[k, round(ms, 4), c] for k, ms, c in rows[:14]]))


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

    def run(name, fn, *a):
        """One main-path phase, with its own launch counts: every count is
        set to 0 just before the phase and read just after it."""
        kernels.reset_launches()
        try:
            res = fn(*a)
        except Failed as e:
            failures.append(f"{name}: {e}")
            emit(dict(phase=name, failed=str(e)))
            res = None
        counts = {k: v.launches for k, v in kernels.KERNELS.items()}
        emit(dict(phase=f"{name}_launches", launches=counts))
        idle = sorted(k for k, c in counts.items() if c == 0)
        if idle:
            failures.append(f"{name}: kernels never launched on this path: {idle}")
        return res, counts

    t0 = time.perf_counter()
    kernels.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels=sorted(kernels.KERNELS)))
    chk, ref_launches = run("reference", phase_reference, DEPTH, CHUNK)
    run("fixpoint", phase_fixpoint, CHUNK)
    run("trace", phase_trace, CHUNK)
    if chk is not None:
        try:
            phase_kernels(chk, ref_launches, SEED)
        except Failed as e:
            failures.append(f"kernels: {e}")
            emit(dict(phase="kernels", failed=str(e)))
        phase_profile(chk)
    else:
        failures.append("kernels: no reference frontier to test on")
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
