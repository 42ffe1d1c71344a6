#!/usr/bin/env python3
"""Where the time of the redesigned port kernels goes on the GPU, kernel
launch by kernel launch (torch.profiler's device times, averaged over
calls), and what the deep levels and the default path's wall make of it:

* ``k1k2``: K1 ``guards`` in its counted form (as every fused, grouped and
  superstep level launches it: from the parents' id lists where the
  package's K1 takes them, and from their inflated masks), the inflate
  kernel with the mask form after it, the mask form without the sums, and
  its per-row form, over the first 16,384-parent chunk of the reference
  constants' depth-20 frontier; K2 ``materialize``'s two passes of a fused
  level, that chunk's candidates at cap_x lanes and one 8-chunk slice of
  the level's survivors (``chip_smoke.k1k2_forms``, each held against its
  twin first);
* ``levels``: the deep fused level (from depth 20, 2,150,466 parents) and
  the warm grouped level (from depth 22, 5,099,018 parents), with K1's,
  K2's, inflate's, the invariant scan's and the level control's device ms
  and the launches by kernel
  (``chip_smoke.phase_profile`` / ``phase_grouped``);
* ``levels5``: the deep fused level at 5 servers (level 16 from the
  depth-15 frontier, 629,645 parents) split by kernel
  (``chip_smoke.profile_fused_level``), with K3's device ms;
* ``k1phases``: where K1's counted form spends its time, by ablation: the
  package's ``csrc/guards.cu`` rebuilt with the slots off family 7, the
  family-7 runs, the count tables, or all three left out (their loops run
  no iteration), each timed on the same chunk (outputs then wrong; only
  the full build is the kernel);
* ``wall``: the default path's wall to depth 25 (graph captures included,
  their count and seconds by program kind);
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
* ``k3s5``, ``k3s4``: K3 at 5 servers (P = 120) and 4 servers (P = 24)
  counted over the first chunk's candidates of the depth-16 and depth-14
  frontiers, as ``k3s3`` (the pair-digit form; the tiled form in trees
  before it);
* ``k4``: K4 probe-and-insert as a level's program runs it (no host
  read), by CUDA-graph replay and split by kernel (torch.profiler, the
  slab's restoring copy included), over the deep fused level's lane buffer
  (level 21 from the depth-20 frontier, every chunk at cap_x lanes) and
  over the warm grouped level's tail (level 23's filtered lanes), with the
  lanes, rounds and launches of one call; and ``insert_only`` rehashing a
  2^24-entry slab into 2^25 slots (CUDA events; graph replay where the
  call makes no host read);
* ``k4phases``: where K4 spends its time over the deep fused level's
  lane buffer, by ablation: the tree's ``csrc/hashstore.cu`` rebuilt
  without the representative's CAS-min, with the CAS as a plain store,
  with the grid rounds on 4,096 blocks, or with 10 grid rounds before the
  finisher in place of 6, each timed by graph replay (outputs then wrong
  but for the wider grid and the 10 rounds; only the full build is the
  kernel), with the registers ptxas gave each kernel; and the 2^24-entry
  rehash of ``insert_only`` with 6 and with 10 grid rounds;
* ``k3variants5``: the ``k3s5`` launch with the pair-digit form's other
  settings (ids gathered at once, warps a block; outputs unchanged), each
  timed on the same launch;
* ``inv``: the invariant scan (csrc/invariants.cu) over the deep fused
  level's survivors (level 21 from the depth-20 frontier: 3,350,017 rows of
  a 2^22-row buffer, ``chip_smoke.deep_level_survivors``) and over the warm
  grouped level's (level 23: 7,596,394 rows), each as one launch bounded by
  the device count, as a launch a slice of 8 chunks to the buffer's end,
  and over one slice, by CUDA-graph replay with CUDA events beside
  (``chip_smoke.inv_scan_forms``; ``level_form`` names the form the tree's
  levels take), with the bound on the live rows;
* ``ctl``: B11 level control (csrc/level.cu): the deep fused level's
  (lv_begin, lv_gate, lv_decide, slab_live, lv_finalize over those
  survivors' 2^22 payload lanes), the grouped level's group control (a
  depth-23 level's 20 groups of 16 chunks: ``lv_group_step`` a group and
  the tail gate, or in trees before it lv_group_begin and lv_group_end a
  group) and its tail (lv_begin, lv_decide, slab_live, lv_finalize over
  level 23's 37,748,736 payload lanes, 7,596,394 survivors), each by
  graph replay, events beside, with the bound on the live work;
* ``invvariants``: the ``inv`` part's deep-level launch (one over the
  buffer) with other settings of the tree's ``csrc/invariants.cu``
  (outputs unchanged): tiles of 256 or 1,024 states, 4 blocks an SM (32
  registers a thread), 3 tiles in flight a block; and with its evaluation or its staging copies left
  out (outputs then wrong); each timed by graph replay on the same launch;
* ``k3phases``, ``k3phases5``: where that K3 launch (at 3 servers; at 5,
  the ``k3s5`` launch) spends its time, by ablation: the tree's
  ``csrc/fingerprint.cu`` rebuilt with the feature staging, the feature
  table's column staging, the message part or the MMAs and epilogue left
  out, or all four, each timed on the same launch (outputs then wrong;
  only the full build is the kernel);
* ``probe``: the grouped level's visited pre-filter over one group of the
  warm grouped level (the first 16 chunks of the depth-22 frontier at cap_x
  lanes each, level 23) against the slab after level 22
  (``chip_smoke.probe_filter_forms``): ``hs_probe`` alone, and ``hs_probe``
  then the filter compaction into cap_g as the group program runs them,
  each held against the twins, by CUDA-graph replay with CUDA events
  beside, with the bounds on the live work (the distinct slab sectors the
  live lanes' walks touch);
* ``sieve``: B13 over the deep fused level's ``new_fps[:2^22]`` (level 21,
  3,350,017 live) and the same buffer cut to level 18's 839,797 (a
  superstep level), against the sentinel and a 2^20-word filter, as the
  tree's fused level issues it (``chip_smoke.sieve_forms``), by graph
  replay, events beside;
* ``sievevariants`` (with ``sieve``): those calls with other settings of
  the tree's ``csrc/sieve.cu`` (a fixed grid, a register cap; outputs
  unchanged, each variant's count held against the twin's), by graph
  replay.

    python scripts/torch_redesign_profile.py [--tree DIR] [--parts levels,k3s3,compact]
                                             [--reps N]

``--tree`` runs the ``tla_raft_tpu_torch`` package of another checkout (a
parent commit unpacked with ``git archive``, say) under this checkout's
``chip_smoke.py``, so two trees are measured by the same code in one call;
each builds its kernels into its own ``build/kernels``.  The ``k3*`` parts
need a tree whose K3 tables carry their form (``ktab["form"]``); ``k1k2``
times K1's id-list form where the tree's package has ``kernels.k3_form``
(the two came together).  One JSON line a
part, then the card's name and power limit.  Exits 2 without a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("k1k2", "k1phases", "levels", "levels5", "wall", "dedup", "k3", "k3s3", "compact",
         "k3phases", "k3s5", "k3s4", "k3phases5", "k3variants5", "k4", "k4phases", "inv", "ctl",
         "invvariants", "probe", "sieve", "sievevariants")
# K1's phase loops (csrc/guards.cu), by the header each ablation empties
K1_LOOPS = {
    name: [(h, h.replace("i < np *", "i < 0 *"))]
    for name, h in dict(
        off_family_7="for (int i = t; i < np * n_other; i += TPB) {",
        family_7_runs="for (int i = t; i < np * n_runs; i += TPB) {",
        count_tables="for (int i = t; i < np * g.npt; i += TPB) {",
    ).items()
}
# K4's parts (csrc/hashstore.cu), each cut by a text edit of the source
K4_CUTS = dict(
    representative=[("                               int64_t* ctl, ulonglong2 cur) {\n  if (pay",
                     "                               int64_t* ctl, ulonglong2 cur) {\n  return;\n"
                     "  if (pay")],
    cas_as_store=[("    if (cas128(w, k, l, key, lo)) return;",
                   "    w[0] = key;\n    w[1] = lo;\n    return;")],
    wide_grid=[("constexpr unsigned ROUND_BLOCKS = 1056;", "constexpr unsigned ROUND_BLOCKS = 4096;")],
    grid_rounds_10=[("constexpr int GRID_ROUNDS = 6;", "constexpr int GRID_ROUNDS = 10;")],
)
# K3's phases (csrc/fingerprint.cu), each emptied the same way: a phase's
# loop headers in the tiled form of earlier trees, in the S <= 3 form and
# in the pair-digit form (every one that is in the source).  feature_staging
# empties the features' build from the staged fields; the fields' and id
# lists' copy stays (the message part reads the ids there)
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
        ("for (int r = w; r < nrows; r += PR_WARPS) {", "for (int r = w; r < 0; r += PR_WARPS) {"),
        ("for (int r = w * (TB_STATES / PR_WARPS); r < r_end; ++r) {",
         "for (int r = w * (TB_STATES / PR_WARPS); r < 0; ++r) {"),
    ],
    mma_epilogue=[
        ("for (int pl = 0; pl < TB_PERMS; ++pl) {", "for (int pl = 0; pl < 0; ++pl) {"),
        ("for (int p = pset; p < nperm; p += S3_PSETS) {",
         "for (int p = pset; p < 0; p += S3_PSETS) {"),
        ("for (int p = w; p < nperm; p += PR_WARPS) {", "for (int p = w; p < 0; p += PR_WARPS) {"),
    ],
)


# the pair-digit form's message part (csrc/fingerprint.cu fingerprint_pairs),
# by part: every state's sums rebuilt from its own ids (no update from the
# last state's), the gathers of the ids' parts left out (their values a
# function of the indices)
K3PAIRS_CUTS = dict(
    rebuild_each=[("const bool rebuild = !prid || n_cur + n_prev - 2 * common >= n_cur;",
                   "const bool rebuild = true;")],
    gathers=[("__ldg(gt4 + (long long)rk * mt.np + pperm_byte(ppw[i], qk))",
              "make_uint4(rk, qk, i, 0)")],
)
# other settings of the pair-digit form (outputs unchanged): ids gathered at
# once, and the block's warps
K3PAIRS_VARIANTS = dict(
    ids_1=[("constexpr int PR_IDS = 2;", "constexpr int PR_IDS = 1;")],
    ids_4=[("constexpr int PR_IDS = 2;", "constexpr int PR_IDS = 4;")],
    threads_256=[("constexpr int PR_THREADS = 512;", "constexpr int PR_THREADS = 256;")],
)

# other settings of the sieve probe (csrc/sieve.cu; outputs unchanged): a
# fixed grid of 1,056 or 528 blocks in place of one wave of resident ones,
# and a register cap of 8 blocks an SM
_SV_GRID = ("const unsigned grid = resident_blocks((const void*)fn, SV_THREADS, 0, "
            "(n + span - 1) / span);")
SIEVE_VARIANTS = {
    f"blocks_{b}": [(_SV_GRID, "const long long tiles = (n + span - 1) / span; const unsigned "
                               f"grid = (unsigned)(tiles < {b} ? tiles : {b});")]
    for b in (1056, 528)}
SIEVE_VARIANTS["bounds_8"] = [("__global__ void __launch_bounds__(SV_THREADS)\n",
                               "__global__ void __launch_bounds__(SV_THREADS, 8)\n")]

# other settings of the invariant scan (csrc/invariants.cu; outputs unchanged)
INV_VARIANTS = dict(
    rows_256=[("constexpr int IV_ROWS = 512;", "constexpr int IV_ROWS = 256;")],
    rows_1024=[("constexpr int IV_ROWS = 512;", "constexpr int IV_ROWS = 1024;")],
    stages_3=[("constexpr int IV_STAGES = 2;", "constexpr int IV_STAGES = 3;")],
    blocks_4=[("__launch_bounds__(IV_ROWS)\n", "__launch_bounds__(IV_ROWS, 4)\n")],
)
# and its parts, each left out (outputs then wrong): the predicates'
# evaluation, the staging copies
INV_CUTS = dict(
    no_evaluation=[("    if (base + t < live) {", "    if (false) {")],
    no_staging=[("    stage_rows<IV_ROWS, true>(smem + k * buf_b,",
                 "    if (0) stage_rows<IV_ROWS, true>(smem + k * buf_b,")],
)


def _ablations(kernels, kern, loops: dict, out_dir: Path, every: str | None) -> dict:
    """{variant: ctypes library} of ``kern``'s source with each phase of
    ``loops`` emptied (its first header that is in the source), and all of
    them (``every``, unless None), built by nvcc in parallel into
    ``out_dir``.  Raises when the source has none of a phase's headers
    (another design)."""
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
    if every is not None:
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


def _level_form(kernels, rec: dict) -> dict:
    """``rec`` (``chip_smoke.inv_scan_forms``) with ``level_form``, the form
    the tree's levels issue (one launch a level where the package has
    ``kernels.INV_ROWS``, a launch a slice in earlier trees), and that
    form's ``ms`` and ``events_ms``."""
    form = "one" if hasattr(kernels, "INV_ROWS") else "slices"
    return dict(rec, level_form=form, ms=rec[f"{form}_ms"], events_ms=rec[f"{form}_events_ms"])


def _group_ctl(cs, kernels, K: int, n_par: int, rows_g: int, cap_g: int, cap_x: int, totals):
    """The grouped level's group control as the tree issues it:
    ``chip_smoke.group_ctl_call``'s kernel form (lv_group_step a group), or
    in trees before it lv_begin, then lv_group_begin and lv_group_end a
    group, then their tail gate: (call, groups, launches a group)."""
    if hasattr(kernels, "group_step"):
        go, _lc, n_groups = cs.group_ctl_call(True, K, n_par, rows_g, cap_g, cap_x, totals)
        return go, n_groups, 1
    import torch

    from tla_raft_tpu_torch.engine import megakernel as mk

    n_groups = -(-n_par // rows_g)
    lc = torch.zeros((mk.LC_LEN,), dtype=torch.int64, device="cuda")
    mult = torch.zeros((K,), dtype=torch.int64, device="cuda")
    n_t = torch.tensor(n_par, device="cuda")

    def go():
        kernels.level_begin(lc, mult, n_t)
        for _g in range(n_groups):
            kernels.group_begin(lc, rows_g, K, cap_g)
            kernels.group_end(lc, totals, cap_x, rows_g)
        kernels.tail_gate(lc, n_groups * cap_g)

    return go, n_groups, 2


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
            # K1 reads id lists in the trees whose K3 tables carry their form
            f = cs.k1k2_forms(chk, reps=10, ids_form=hasattr(kernels, "k3_form"))
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
                        inflate_ms=_kernel_ms(rec["top"], "inflate"),
                        inv_scan_ms=_kernel_ms(rec["top"], "inv_scan"),
                        level_control_ms=_kernel_ms(rec["top"], "lv_")
                        + _kernel_ms(rec["top"], "slab_live"),
                        launches=rec.get("launches"), top=rec["top"])), flush=True)
        chk = None
        release()

    if "k4" in parts:
        import numpy as np

        from tla_raft_tpu_torch.engine.megakernel import DEFAULT_ROUNDS
        from tla_raft_tpu_torch.ops import hashstore as hs

        for depth, form in ((cs.DEPTH, "deep_fused_level"), (cs.DEPTH_GROUPED, "grouped_tail")):
            chk, _res, _lv, _s = cs._run_reference(depth, cs.CHUNK, megakernel=False)
            if form == "deep_fused_level":
                lanes, slab = cs.k4_level_lanes(chk), chk.hstore.slab
                live, budget = lanes[0].shape[0], DEFAULT_ROUNDS
            else:
                fr = chk.frontier
                lanes, live, budget, slab = cs.k4_grouped_tail(
                    chk, fr, fr.voted_for.shape[0], depth, chk.hstore.slab.clone())
            rec, call = cs.k4_level_timing(slab, lanes, live, budget, reps=10)
            print(json.dumps(dict(part="k4", **head, form=form, level=depth + 1, **rec,
                                  by_kernel=run(call))), flush=True)
            chk = lanes = slab = call = None
            release()
        g = np.random.default_rng(5)
        old = hs.make_slab(1 << 25, "cuda")
        hs.insert_only(old, torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 1 << 24,
                                                        dtype=np.int64)).cuda())
        new = hs.make_slab(1 << 25, "cuda")
        events = cs._timed_insert(lambda s_, x: kernels.insert_only(s_, x), new, (old,), 5)
        ms = "not measured: the call reads the device each round"
        if hasattr(kernels, "KC_LEN"):  # the rounds without a host read
            fill = cs.graph_ms(lambda: new.fill_(-1), 10)
            ms = cs.graph_ms(lambda: (new.fill_(-1), kernels.insert_only(new, old)), 10) - fill
        print(json.dumps(dict(part="k4", **head, form="insert_only_rehash", lanes=1 << 25,
                              slots=1 << 25, events_ms=events, ms=ms,
                              by_kernel=run(lambda: kernels.insert_only(new.fill_(-1), old)))),
              flush=True)
        old = new = None
        release()

    if "k4phases" in parts:
        import re

        from tla_raft_tpu_torch.engine.megakernel import DEFAULT_ROUNDS

        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH, cs.CHUNK, megakernel=False)
        lanes = cs.k4_level_lanes(chk)
        rec, call = cs.k4_level_timing(chk.hstore.slab, lanes, lanes[0].shape[0], DEFAULT_ROUNDS)
        libs = _ablations(kernels, kernels.HASHSTORE, K4_CUTS, tree / "build" / "k4phases",
                          "all_cuts")
        ms = _variant_ms(cs, kernels.HASHSTORE, libs, call)
        log = (kernels.build_all()["hashstore"].parent / "hashstore.log").read_text()
        regs = dict(re.findall(r"Compiling entry function '(\w+)' for 'sm_90a'"
                               r"[\s\S]*?Used (\d+) registers", log))
        print(json.dumps(dict(part="k4phases", **head, lanes=rec["lanes"], ms=rec["ms"],
                              ms_by_variant=ms, registers=regs, ptxas=log[-6000:])), flush=True)
        chk = lanes = call = None
        release()
        # insert_only's rehash with 6 (the tree's) and 10 grid rounds
        import numpy as np

        from tla_raft_tpu_torch.ops import hashstore as hs

        g = np.random.default_rng(5)
        old = hs.make_slab(1 << 25, "cuda")
        hs.insert_only(old, torch.from_numpy(g.integers(-(1 << 63), (1 << 63) - 1, 1 << 24,
                                                        dtype=np.int64)).cuda())
        new = hs.make_slab(1 << 25, "cuda")
        libs = _ablations(kernels, kernels.INSERT_ONLY,
                          dict(grid_rounds_10=K4_CUTS["grid_rounds_10"]),
                          tree / "build" / "k4phases_insert", None)
        ctl = {}
        for name, lib in [("full", kernels.INSERT_ONLY.lib()), *libs.items()]:
            full, kernels.INSERT_ONLY._lib = kernels.INSERT_ONLY.lib(), lib
            try:
                kernels.insert_only(new.fill_(-1), old)
                ctl[name] = kernels.INSERT_CTL.cpu().tolist()
            finally:
                kernels.INSERT_ONLY._lib = full
        fill = cs.graph_ms(lambda: new.fill_(-1), 10)
        ms = _variant_ms(cs, kernels.INSERT_ONLY, libs,
                         lambda: (new.fill_(-1), kernels.insert_only(new, old)))
        print(json.dumps(dict(part="k4phases", **head, form="insert_only_rehash", lanes=1 << 25,
                              fill_ms=fill, ms_by_variant={k: v - fill for k, v in ms.items()},
                              grid_rounds={k: c[kernels.KC_GRID] for k, c in ctl.items()},
                              finisher_rounds={k: c[kernels.KC_FIN] for k, c in ctl.items()})),
              flush=True)
        old = new = None
        release()

    if any(p in parts for p in ("inv", "ctl", "invvariants")):
        import numpy as np

        from tla_raft_tpu_torch.engine import megakernel as mk

        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH, cs.CHUNK, megakernel=False)
        rows, n_new, pay = cs.deep_level_survivors(chk)
        if "inv" in parts or "invvariants" in parts:
            calls = {}
            rec = _level_form(kernels, cs.inv_scan_forms(
                chk, rows, n_new, mk.mat_slice_width(1 << 22, cs.CHUNK), calls=calls))
            if "inv" in parts:
                print(json.dumps(dict(part="inv", **head, form="deep_fused_level",
                                      level=cs.DEPTH + 1, **rec,
                                      by_kernel=run(calls[rec["level_form"]]))), flush=True)
            if "invvariants" in parts:
                libs = _ablations(kernels, kernels.INV_SCAN, {**INV_VARIANTS, **INV_CUTS},
                                  tree / "build" / "invvariants", None)
                ms = _variant_ms(cs, kernels.INV_SCAN, libs, calls["one"])
                print(json.dumps(dict(part="invvariants", **head, rows=rec["rows"],
                                      live=n_new, ms_by_variant=ms)), flush=True)
            calls = None
        rows = None
        if "ctl" in parts:
            K, B, G, slab = chk.K, chk.chunk, chk.cap_x, chk.hstore.slab
            n = chk.frontier.voted_for.shape[0]
            totals = torch.from_numpy(np.random.default_rng(5).integers(0, G + 1, 256)).cuda()
            go, _o = cs.level_ctl_call(True, slab, pay, n_new, K, n, (totals, G, B))
            nb = slab.shape[0] * 8 + n_new * 14 + 256 * 8 + K * 16
            print(json.dumps(dict(part="ctl", **head, form="deep_fused_level", lanes=pay.shape[0],
                                  survivors=n_new, slab_slots=slab.shape[0],
                                  ms=cs.graph_ms(go, 10), events_ms=cs.cuda_ms(go, 10),
                                  bound_ms=nb / cs.HBM_BYTES_PER_S * 1e3, by_kernel=run(go))),
                  flush=True)
            rows_g, n_par, cap_g = 16 * B, cs.GOLDEN_LEVELS_REF[22], 16 * G // 2
            go, n_groups, a_group = _group_ctl(cs, kernels, K, n_par, rows_g, cap_g, G,
                                               totals[:16])
            nb = n_groups * (2 * mk.LC_LEN * 8 + 16 * 8) + 2 * mk.LC_LEN * 8 + K * 8
            ms = cs.graph_ms(go, 10)
            print(json.dumps(dict(part="ctl", **head, form="group_control", groups=n_groups,
                                  rows=rows_g, ms=ms, ms_a_group=ms / n_groups,
                                  events_ms=cs.cuda_ms(go, 10),
                                  launches_a_group=a_group,
                                  bound_ms=nb / cs.HBM_BYTES_PER_S * 1e3, by_kernel=run(go))),
                  flush=True)
        chk = pay = None
        release()
    if "inv" in parts or "ctl" in parts:
        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH_GROUPED, cs.CHUNK, megakernel=False)
        fr = chk.frontier
        forms = cs.grouped_level_forms(chk, fr, fr.voted_for.shape[0], cs.DEPTH_GROUPED,
                                       cs.CHUNK, chk.hstore.slab.clone())
        if "inv" in parts:
            print(json.dumps(dict(part="inv", **head, form="grouped_level",
                                  **_level_form(kernels, forms["inv_scan"]))), flush=True)
        if "ctl" in parts:
            print(json.dumps(dict(part="ctl", **head, form="grouped_tail", **forms["tail"])),
                  flush=True)
        chk = fr = forms = None
        release()

    if "probe" in parts:
        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH_GROUPED, cs.CHUNK, megakernel=False)
        calls = {}
        rec = cs.probe_filter_forms(chk.hstore.slab, cs.chunk_lanes(chk, 0, chk.G), chk.cap_g,
                                    calls=calls)
        print(json.dumps(dict(part="probe", **head, level=cs.DEPTH_GROUPED + 1, **rec,
                              by_kernel={k: run(c) for k, c in calls.items()})), flush=True)
        chk = calls = None
        release()

    if "sieve" in parts:
        chk, _res, _lv, _s = cs._run_reference(cs.DEPTH, cs.CHUNK, megakernel=False)
        fps, _pay, n_new = cs.deep_level_fresh(chk)
        fps, chk = fps[:1 << 22], None
        calls = {}
        rec = cs.sieve_forms(fps, (n_new, cs.GOLDEN_LEVELS_REF[18]), calls=calls)
        print(json.dumps(dict(part="sieve", **head, level=cs.DEPTH + 1, **rec,
                              by_kernel={f"{k[0]}_{k[1]}": run(c) for k, c in calls.items()})),
              flush=True)
        if "sievevariants" in parts:
            from tla_raft_tpu_torch.ops import sieve

            libs = _ablations(kernels, kernels.SIEVE, SIEVE_VARIANTS,
                              tree / "build" / "sievevariants", None)
            full = kernels.SIEVE.lib()
            f = fps.clone()
            f[n_new:] = -1
            words = torch.full((1 << 20,), -1, dtype=torch.int64, device="cuda")
            want = int((f[:n_new] != -1).sum())
            for name, lib in libs.items():  # each variant's count, against the twin's
                kernels.SIEVE._lib = lib
                try:
                    count = torch.zeros((), dtype=torch.int64, device="cuda")
                    sieve.count_hits(words, f, count, torch.tensor(n_new, device="cuda"))
                finally:
                    kernels.SIEVE._lib = full
                cs.check(int(count) == want, f"sieve variant {name} counts {int(count)}")
            ms = {f"{k[0]}_{k[1]}_{v}": t for k, c in calls.items()
                  for v, t in _variant_ms(cs, kernels.SIEVE, libs, c).items()}
            print(json.dumps(dict(part="sievevariants", **head, ms_by_variant=ms)), flush=True)
        fps = calls = None
        release()

    if "wall" in parts:
        chk, res, _lv, secs = cs._run_reference(cs.DEPTH_DEFAULT, cs.CHUNK)
        check = list(res.level_sizes) == cs.GOLDEN_LEVELS_REF[: cs.DEPTH_DEFAULT + 1]
        by_kind = {}
        for kind, _cap_f, c_secs, *_rest in chk.graph_stats["capture_log"]:
            k = by_kind.setdefault(kind, dict(captures=0, seconds=0.0, max_seconds=0.0))
            k["captures"] += 1
            k["seconds"] += c_secs
            k["max_seconds"] = max(k["max_seconds"], c_secs)
        print(json.dumps(dict(part="wall", **head, depth=res.depth, distinct=res.distinct,
                              golden=check, seconds=secs, routes=chk.routes,
                              capture_seconds=chk.graph_stats["capture_seconds"],
                              captures_by_kind=by_kind)), flush=True)
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

    for part, S, depth in (("k3s5", 5, 16), ("k3s4", 4, cs.DEPTH_S4_K3)):
        if part not in parts and not (S == 5 and ("k3phases5" in parts
                                                  or "k3variants5" in parts)):
            continue
        chk = TorchChecker(RaftConfig(n_servers=S), device="cuda")
        chk.run(max_depth=depth)
        f = cs.k3_compact_forms(chk)
        calls = f.pop("inputs")
        f3 = {k: v for k, v in f.items() if not k.startswith(("compact", "b9", "filter"))}
        if part in parts:
            print(json.dumps(dict(part=part, **head, servers=S, P=chk.fpr.P, **f3,
                                  by_kernel=run(calls["k3"]))), flush=True)
        if S == 5 and "k3phases5" in parts:
            libs = _ablations(kernels, kernels.FINGERPRINT, {**K3_LOOPS, **K3PAIRS_CUTS},
                              tree / "build" / "k3phases5", "launch_and_stores")
            ms = _variant_ms(cs, kernels.FINGERPRINT, libs, calls["k3"])
            print(json.dumps(dict(part="k3phases5", **head, lanes=f["cap_x"],
                                  live=f["candidates"], ms_by_variant=ms)), flush=True)
        if S == 5 and "k3variants5" in parts:
            libs = _ablations(kernels, kernels.FINGERPRINT, K3PAIRS_VARIANTS,
                              tree / "build" / "k3variants5", None)
            ms = _variant_ms(cs, kernels.FINGERPRINT, libs, calls["k3"])
            print(json.dumps(dict(part="k3variants5", **head, lanes=f["cap_x"],
                                  live=f["candidates"], ms_by_variant=ms)), flush=True)
        chk = calls = None
        release()

    if "levels5" in parts:
        want = cs.SCALE_GOLDEN[5]["levels"]
        chk = TorchChecker(RaftConfig(n_servers=5), device="cuda", megakernel=False)
        res = chk.run(max_depth=15)
        cs.check(list(res.level_sizes) == want[:16], "levels5: the S=5 staged run")
        rec = cs.profile_fused_level(chk, want[:16])
        cs.check(rec["n_new"] == want[16], f"levels5: level 16 gave {rec['n_new']}")
        print(json.dumps(dict(part="levels5", **head, **{k: v for k, v in rec.items()
                                                          if k != "phase"},
                              fingerprint_ms=_kernel_ms(rec["top"], "fingerprint"),
                              guards_ms=_kernel_ms(rec["top"], "guards"),
                              inflate_ms=_kernel_ms(rec["top"], "inflate"))), flush=True)
        chk = None
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
