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
  candidates of a depth-9 frontier.

    python scripts/torch_redesign_profile.py [--tree DIR] [--parts k1k2,levels,wall]
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
PARTS = ("k1k2", "k1phases", "levels", "wall", "dedup", "k3")
# K1's phase loops (csrc/guards.cu), by the header each ablation empties
K1_LOOPS = dict(
    off_family_7="for (int i = t; i < np * n_other; i += TPB) {",
    family_7_runs="for (int i = t; i < np * n_runs; i += TPB) {",
    count_tables="for (int i = t; i < np * g.npt; i += TPB) {",
)


def _k1_ablations(kernels, out_dir: Path) -> dict:
    """{variant: ctypes library} of csrc/guards.cu with each of K1_LOOPS
    emptied, and all of them ("staging_and_write_out"), built by nvcc in
    parallel into ``out_dir``.  Raises when the source lacks one of the
    loops (another tree's design)."""
    import ctypes

    src = (kernels.CSRC / "guards.cu").read_text()
    missing = [k for k, h in K1_LOOPS.items() if h not in src]
    if missing:
        raise RuntimeError(f"{kernels.CSRC / 'guards.cu'} has no loop for {missing}: "
                           "k1phases ablates the grouped design's loops only")
    cut = {k: src.replace(h, h.replace("i < np *", "i < 0 *")) for k, h in K1_LOOPS.items()}
    every = src
    for h in K1_LOOPS.values():
        every = every.replace(h, h.replace("i < np *", "i < 0 *"))
    cut["staging_and_write_out"] = every
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in cut.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} ablation of guards.cu")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, args in kernels.GUARDS.entries.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


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

    if "k1k2" in parts or "k1phases" in parts or "levels" in parts:
        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH, cs.CHUNK, megakernel=False)
        if "k1phases" in parts:
            libs = _k1_ablations(kernels, tree / "build" / "k1phases")
            real = cs._frontier_rows(chk.frontier, torch.arange(cs.CHUNK, device="cuda"))
            st, K = chk.inflate(real), chk.K
            valid = torch.zeros((cs.CHUNK, K), dtype=torch.bool, device="cuda")
            acc = torch.zeros((K,), dtype=torch.int64, device="cuda")
            first = torch.full((), 1 << 62, dtype=torch.int64, device="cuda")
            cnt = torch.tensor(cs.CHUNK, dtype=torch.int64, device="cuda")
            full = kernels.GUARDS.lib()
            ms = {}
            for name, lib in [("full", full), *libs.items()]:
                kernels.GUARDS._lib = lib
                ms[name] = cs.graph_ms(lambda: kernels.guards(
                    chk.mx, st, valid=valid, per_row=False, cnt=cnt, mult_acc=acc,
                    abort_acc=first), 10)
            kernels.GUARDS._lib = full
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
