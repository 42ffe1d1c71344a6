#!/usr/bin/env python3
"""Where the time of the redesigned port kernels goes on the GPU, kernel
launch by kernel launch (torch.profiler's device times, averaged over
calls), and what the deep levels and the default path's wall make of it:

* ``k1k2``: K1 ``guards`` in its counted form (as every fused, grouped and
  superstep level launches it), the same launch without the sums, and its
  per-row form, over the first 16,384-parent chunk of the reference
  constants' depth-20 frontier; K2 ``materialize``'s two passes of a fused
  level, that chunk's candidates at cap_x lanes and one 8-chunk slice of
  the level's survivors (``chip_smoke.k1k2_forms``, each held against its
  twin first);
* ``levels``: the deep fused level (from depth 20, 2,150,466 parents) and
  the warm grouped level (from depth 22, 5,099,018 parents), with K1's and
  K2's device ms (``chip_smoke.phase_profile`` / ``phase_grouped``);
* ``k1phases``: where K1's counted form spends its time, by ablation: the
  package's ``csrc/guards.cu`` rebuilt with the slots off family 7, the
  family-7 runs, the count tables, or all three left out (their loops run
  no iteration), each timed on the same chunk (outputs then wrong; only
  the full build is the kernel);
* ``wall``: the default path's wall to depth 25 (graph captures included);
* ``dedup``: ``level_dedup`` over the level-25 lanes against the store
  after level 24 (the sorted kernels phase's inputs);
* ``k3``: K3 with its factored message part at 7 servers over one chunk of
  candidates of a depth-9 frontier;
* ``k3s3``: K3 at 3 servers as a fused level launches it: counted over the
  first 16,384-parent chunk's candidates of the depth-20 frontier at cap_x
  lanes (``chip_smoke.k3_compact_forms``, held against its twin first);
* ``compact``: the order-keeping compaction on that chunk: its K1 flags
  into cap_x payload lanes (B3), B9's two-array form, the filter form and
  ``chunk_compact`` over the chunk's fan-out lanes (their fp_view, SENT
  where K1 finds no valid slot);
* ``k3s5``: K3 at 5 servers (the tiled form) counted over the first
  chunk's candidates of the depth-16 frontier, as ``k3s3``;
* ``k3phases``: where that K3 launch spends its time, by ablation: the
  tree's ``csrc/fingerprint.cu`` rebuilt with the feature staging, the
  feature table's column staging, the message part or the MMAs and
  epilogue left out, or all four, each timed on the same launch (outputs
  then wrong; only the full build is the kernel).

    python scripts/torch_redesign_profile.py [--tree DIR] [--parts levels,k3s3,compact]
                                             [--reps N]

``--tree`` runs the ``tla_raft_tpu_torch`` package of another checkout (a
parent commit unpacked with ``git archive``, say) under this checkout's
``chip_smoke.py``, so two trees are measured by the same code in one call;
each builds its kernels into its own ``build/kernels``.  One JSON line a
part, then the card's name and power limit.  Exits 2 without a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("k1k2", "k1phases", "levels", "wall", "dedup", "k3", "k3s3", "compact", "k3phases",
         "k3s5")
# K1's phase loops (csrc/guards.cu), by the header each ablation empties
K1_LOOPS = {
    name: [(h, h.replace("i < np *", "i < 0 *"))]
    for name, h in dict(
        off_family_7="for (int i = t; i < np * n_other; i += TPB) {",
        family_7_runs="for (int i = t; i < np * n_runs; i += TPB) {",
        count_tables="for (int i = t; i < np * g.npt; i += TPB) {",
    ).items()
}
# K3's phases at S=3 (csrc/fingerprint.cu), each emptied the same way: a
# phase's loop headers in the tiled form of the earlier design, or in the
# S <= 3 form (every one that is in the source).  The S <= 3 form's
# feature_staging empties the features' build from the staged fields; the
# fields' and id lists' copy stays (the message part reads the ids there)
K3_LOOPS = dict(
    feature_staging=[
        ("for (int i = threadIdx.x; i < TB_STATES * f_pad; i += NT) {",
         "for (int i = threadIdx.x; i < 0 * f_pad; i += NT) {"),
        ("for (int i = t; i < TB_STATES * n_cw; i += NT) {",
         "for (int i = t; i < 0 * n_cw; i += NT) {"),
    ],
    column_staging=[
        ("for (int i = threadIdx.x; i < ncol * vec_per_row; i += NT) {",
         "for (int i = threadIdx.x; i < 0 * vec_per_row; i += NT) {"),
        ("for (int i = t; i < ncols * vec; i += S3_THREADS) {",
         "for (int i = t; i < 0 * vec; i += S3_THREADS) {"),
    ],
    message_part=[
        ("for (int r = 0; r < 16; ++r) {", "for (int r = 0; r < 0; ++r) {"),
        ("for (int it = t; it < TB_STATES * nperm; it += S3_THREADS) {",
         "for (int it = t; it < 0 * nperm; it += S3_THREADS) {"),
    ],
    mma_epilogue=[
        ("for (int pl = 0; pl < TB_PERMS; ++pl) {", "for (int pl = 0; pl < 0; ++pl) {"),
        ("for (int p = pset; p < nperm; p += S3_PSETS) {",
         "for (int p = pset; p < 0; p += S3_PSETS) {"),
    ],
)


def _ablations(kernels, kern, loops: dict, out_dir: Path, every: str) -> dict:
    """{variant: ctypes library} of ``kern``'s source with each phase of
    ``loops`` emptied (its first header that is in the source), and all of
    them (``every``), built by nvcc in parallel into ``out_dir``.  Raises
    when the source has none of a phase's headers (another design)."""
    import ctypes

    path = kernels.CSRC / Path(kern.source).name
    src = path.read_text()
    cuts = {}
    for name, alts in loops.items():
        hit = [(h, r) for h, r in alts if h in src]
        if not hit:
            raise RuntimeError(f"{path} has no loop for {name}: this ablation knows "
                               f"{[h for h, _r in alts]}")
        cuts[name] = hit
    cut = {}
    for name, hit in cuts.items():
        text = src
        for h, r in hit:
            text = text.replace(h, r)
        cut[name] = text
    text = src
    for hit in cuts.values():
        for h, r in hit:
            text = text.replace(h, r)
    cut[every] = text
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, body in cut.items():
        (out_dir / f"{name}.cu").write_text(body)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} ablation of {path.name}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, args in kern.entries.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib.lib_warm.restype = ctypes.c_int
        if lib.lib_warm() != 0:
            raise RuntimeError(f"the {name} ablation of {path.name} failed to load")
        libs[name] = lib
    return libs


def _variant_ms(cs, kern, libs: dict, call) -> dict:
    """graph_ms of ``call`` with ``kern`` bound to each library in turn
    (the package's own first, as ``full``)."""
    full = kern.lib()
    ms = {}
    try:
        for name, lib in [("full", full), *libs.items()]:
            kern._lib = lib
            ms[name] = cs.graph_ms(call, 10)
    finally:
        kern._lib = full
    return ms


def _fan_out_compact(cs, chk, kernels, bfs) -> dict:
    """B3 ``_chunk_compact`` (canon="expand") at the fused level's shape:
    the first chunk's fan-out lanes with a fingerprint where K1 finds the
    slot valid (seeded values), SENT elsewhere, packed into cap_x under a
    row count; held against the twin; graph-replay ms and its byte bound
    (8 B of fp_view a lane read, the kept lanes' fp_full read, cap_x lanes
    of three written)."""
    import numpy as np
    import torch

    fr, K, B, G = chk.frontier, chk.K, chk.chunk, chk.cap_x
    real = cs._frontier_rows(fr, torch.arange(min(B, fr.voted_for.shape[0]), device="cuda"))
    nb = real.voted_for.shape[0]
    valid = chk.mx.guards(chk.inflate(real))[0].reshape(-1)
    g = np.random.default_rng(4)
    vals = torch.from_numpy(g.integers(0, (1 << 63) - 1, valid.shape[0], dtype=np.int64)).cuda()
    fpv = torch.where(valid, vals, torch.full_like(vals, -1))
    out = tuple(torch.empty((G,), dtype=torch.int64, device="cuda") for _ in range(3))
    total = torch.empty((), dtype=torch.int64, device="cuda")
    rows = torch.tensor(nb, dtype=torch.int64, device="cuda")
    tile = torch.zeros((kernels.compact_tiles(fpv.shape[0]),), dtype=torch.int64, device="cuda")

    def call():
        kernels.chunk_compact(fpv, fpv, G, out=out, total=total, cnt=rows, mul=K, tile=tile)

    call()
    want = bfs.chunk_compact_plain(fpv, fpv, G)
    kept = int(valid.sum())
    cs.check(all(cs._equal(a, b) for a, b in zip(out, want[:3])) and int(total) == kept,
             "chunk_compact differs from its twin")
    bound = (fpv.shape[0] * 8 + min(kept, G) * 8 + G * 24) / cs.HBM_BYTES_PER_S * 1e3
    return dict(call=call, times=dict(fan_out_ms=cs.graph_ms(call, 10),
                                      fan_out_bound_ms=bound, fan_out_lanes=fpv.shape[0]))


def _by_kernel(prof, reps: int) -> dict:
    """Device milliseconds a call, by kernel name."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0 and not e.key.startswith(("aten::", "cuda")):
            out[e.key.split("(")[0]] = us / reps / 1e3
    return out


def _kernel_ms(top: list, word: str) -> float:
    """Summed ms of the profiled kernels whose name holds ``word``."""
    return sum(ms for name, ms, _c in top if word in name.split("(")[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose package runs")
    ap.add_argument("--parts", default=",".join(PARTS), help="comma list of " + ", ".join(PARTS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    parts = [p for p in args.parts.split(",") if p]
    if any(p not in PARTS for p in parts):
        ap.error(f"--parts: choose from {PARTS}")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("torch_redesign_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    kernels.build_all()
    reps = args.reps
    head = dict(tree=str(tree), package=str(Path(kernels.__file__).parents[1]))

    def run(fn) -> dict:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = _by_kernel(prof, reps)
        return dict(ms_a_call_by_kernel=by, ms_a_call=sum(by.values()))

    def release():
        cs._release_cache()

    if any(p in parts for p in ("k1k2", "k1phases", "levels", "k3s3", "compact", "k3phases")):
        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH, cs.CHUNK, megakernel=False)
        if any(p in parts for p in ("k3s3", "compact", "k3phases")):
            f = cs.k3_compact_forms(chk)
            calls = f.pop("inputs")
            if "k3s3" in parts:
                f3 = {k: v for k, v in f.items() if not k.startswith(("compact", "b9", "filter"))}
                print(json.dumps(dict(part="k3s3", **head, **f3,
                                      by_kernel=run(calls["k3"]))), flush=True)
            if "compact" in parts:
                fc = {k: v for k, v in f.items() if not k.startswith("k3")}
                fan = _fan_out_compact(cs, chk, kernels, bfs)
                fc.update(fan.pop("times"))
                calls["fan_out"] = fan.pop("call")
                fc["by_kernel"] = {k: run(calls[k]) for k in ("chunk_flags", "b9", "filter",
                                                              "fan_out")}
                print(json.dumps(dict(part="compact", **head, **fc)), flush=True)
            if "k3phases" in parts:
                libs = _ablations(kernels, kernels.FINGERPRINT, K3_LOOPS,
                                  tree / "build" / "k3phases", "launch_and_stores")
                ms = _variant_ms(cs, kernels.FINGERPRINT, libs, calls["k3"])
                print(json.dumps(dict(part="k3phases", **head, lanes=f["cap_x"],
                                      live=f["candidates"], ms_by_variant=ms)), flush=True)
            calls = None
        if "k1phases" in parts:
            libs = _ablations(kernels, kernels.GUARDS, K1_LOOPS, tree / "build" / "k1phases",
                              "staging_and_write_out")
            real = cs._frontier_rows(chk.frontier, torch.arange(cs.CHUNK, device="cuda"))
            st, K = chk.inflate(real), chk.K
            valid = torch.zeros((cs.CHUNK, K), dtype=torch.bool, device="cuda")
            acc = torch.zeros((K,), dtype=torch.int64, device="cuda")
            first = torch.full((), 1 << 62, dtype=torch.int64, device="cuda")
            cnt = torch.tensor(cs.CHUNK, dtype=torch.int64, device="cuda")
            ms = _variant_ms(cs, kernels.GUARDS, libs, lambda: kernels.guards(
                chk.mx, st, valid=valid, per_row=False, cnt=cnt, mult_acc=acc, abort_acc=first))
            print(json.dumps(dict(part="k1phases", **head, parents=cs.CHUNK,
                                  counted_ms_by_variant=ms)), flush=True)
            st = valid = None
        if "k1k2" in parts:
            f = cs.k1k2_forms(chk, reps=10)
            x = f.pop("inputs")
            mx, K, G = chk.mx, chk.K, chk.cap_x
            st, fr = x["st"], chk.frontier
            valid = torch.zeros((st.msgs.shape[0], K), dtype=torch.bool, device="cuda")
            acc = torch.zeros((K,), dtype=torch.int64, device="cuda")
            first = torch.full((), 1 << 62, dtype=torch.int64, device="cuda")
            cnt = torch.tensor(st.msgs.shape[0], dtype=torch.int64, device="cuda")
            n_cand = torch.tensor(x["live"], dtype=torch.int64, device="cuda")
            n_surv = torch.tensor(x["surv_live"], dtype=torch.int64, device="cuda")
            f["by_kernel"] = dict(
                guards_counted=run(lambda: kernels.guards(
                    mx, st, valid=valid, per_row=False, cnt=cnt, mult_acc=acc,
                    abort_acc=first)),
                guards_valid_only=run(lambda: kernels.guards(
                    mx, st, valid=valid, per_row=False, cnt=cnt)),
                guards_per_row=run(lambda: kernels.guards(mx, st)),
                materialize_candidates=run(lambda: kernels.materialize(
                    mx, x["real"], None, None, pay=x["cp"], cnt=n_cand)),
                materialize_survivors=run(lambda: kernels.materialize(
                    mx, fr, None, None, pay=x["surv"], cnt=n_surv)),
            )
            print(json.dumps(dict(part="k1k2", **head, cap_x=G, **f)), flush=True)
            x = st = valid = None
        if "levels" in parts:
            got = []
            saved, cs.emit = cs.emit, got.append
            try:
                cs.phase_profile(chk)
                chk = None
                release()
                cs.phase_grouped(cs.DEPTH_GROUPED, cs.CHUNK)
            finally:
                cs.emit = saved
            for rec in got:
                if rec.get("phase") == "profile":
                    print(json.dumps(dict(
                        part="levels", **head, path=rec["path"], parents=rec["parents"],
                        wall_ms=rec["wall_ms"], device_busy_ms=rec["device_busy_ms"],
                        device_idle_share=rec["device_idle_share"],
                        guards_ms=_kernel_ms(rec["top"], "guards"),
                        materialize_ms=_kernel_ms(rec["top"], "materialize"),
                        top=rec["top"])), flush=True)
        chk = None
        release()

    if "wall" in parts:
        chk, res, _lv, secs = cs._run_reference(cs.DEPTH_DEFAULT, cs.CHUNK)
        check = list(res.level_sizes) == cs.GOLDEN_LEVELS_REF[: cs.DEPTH_DEFAULT + 1]
        print(json.dumps(dict(part="wall", **head, depth=res.depth, distinct=res.distinct,
                              golden=check, seconds=secs, routes=chk.routes,
                              capture_seconds=chk.graph_stats["capture_seconds"])), flush=True)
        chk = None
        release()

    if "dedup" in parts:
        cv, cf, cp, store = cs.capture_sorted_inputs(cs.DEPTH_DEFAULT, cs.CHUNK).pop(
            "level_dedup")
        rec = run(lambda: bfs.level_dedup(cv, cf, cp, store))
        print(json.dumps(dict(part="dedup", **head, kernel="level_dedup", lanes=cv.shape[0],
                              live_lanes=int((cv != -1).sum()), store_slots=store.shape[0],
                              reps=reps, **rec)), flush=True)
        cv = cf = cp = store = None
        release()

    if "k3s5" in parts:
        chk = TorchChecker(RaftConfig(n_servers=5), device="cuda")
        chk.run(max_depth=16)
        f = cs.k3_compact_forms(chk)
        calls = f.pop("inputs")
        f3 = {k: v for k, v in f.items() if not k.startswith(("compact", "b9", "filter"))}
        print(json.dumps(dict(part="k3s5", **head, servers=5, **f3,
                              by_kernel=run(calls["k3"]))), flush=True)
        chk = calls = None
        release()

    if "k3" in parts:
        chk = TorchChecker(RaftConfig(n_servers=7), device="cuda")
        chk.run(max_depth=9)
        fr, mx, K, B, G = chk.frontier, chk.mx, chk.K, chk.chunk, chk.cap_x
        real = cs._frontier_rows(fr, torch.arange(min(B, fr.voted_for.shape[0]), device="cuda"))
        nb = real.voted_for.shape[0]
        valid, _m, _a = mx.guards(chk.inflate(real))
        payload = (torch.arange(nb, device="cuda")[:, None] * K
                   + torch.arange(K, device="cuda")).reshape(-1)
        lanes, lane, _o = bfs.compact_payloads(valid.reshape(-1), payload, G)
        live = int(lane.sum())
        children = mx.materialize(real, torch.div(lanes, K, rounding_mode="floor").clamp(0, nb - 1),
                                  lanes % K)[0]
        cnt = torch.tensor(live, device="cuda")
        out = (torch.empty(G, dtype=torch.int64, device="cuda"),
               torch.empty(G, dtype=torch.int64, device="cuda"))
        rec = run(lambda: kernels.fingerprints(chk.fpr, children, out=out, cnt=cnt))
        print(json.dumps(dict(part="k3", **head, kernel="msg_hash_factored", servers=7,
                              lanes=live, reps=reps, **rec)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
