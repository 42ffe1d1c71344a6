"""Build, bind and launch the port's hand-written CUDA kernels.

Each kernel source in ``tla_raft_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``.  The build runs at first use (or through ``build_all``,
one ``nvcc`` process per source, all started together) into
``build/kernels/<digest>/`` at the repo root, keyed by a digest of the
sources and flags, so an edited source rebuilds and an unchanged one
loads.  Nothing is imported or built when this module is imported.

Every wrapper checks device, dtype, shape and contiguity and raises on
anything it does not take; allocates its outputs and scratch with
``torch.empty`` unless the caller passes them (``out=``); launches on
``torch.cuda.current_stream()``; raises if the C entry point returns a
CUDA error; and adds to its kernel's ``launches`` count the number of CUDA
kernels it launched, where it launches them.  There is no fallback: the
callers send CPU tensors to the plain twins and CUDA tensors here.

The fused level (engine/megakernel.py) captures these launches into a
CUDA graph, so its wrappers take *device counts*: ``cnt`` (an int64 0-d
CUDA tensor) with ``sub`` bounds the live rows or lanes at
``min(n, max(0, cnt - sub) * mul)`` on the device (common.cuh
``live_count``), and the grid stays at the static capacity.  A capture
adds its launches to the counts once per replay, not at capture time
(``Tally``): while a thread captures, the launches its wrappers count go
to that thread's own tally, so a capture on one thread (the prewarm's)
never touches the counts the main thread's launches add to.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

# a capturing thread's tallies: a stack of {(kernel, "launches" | "calls"): n}
_TL = threading.local()
_LIB_LOCK = threading.Lock()  # the build and the first load of a library


def _tally() -> dict | None:
    stack = getattr(_TL, "stack", None)
    return stack[-1] if stack else None


class CaptureYield(Exception):
    """Raised inside a yielding capture (``Tally(yield_if=...)``) at its
    next counted launch once ``yield_if()`` is true: the capture gives way."""


class Kernel:
    """One kernel library: its source, what it replaces, its C entry
    points (name -> argtypes) and its launch count on the main path.
    ``launches`` and ``calls`` read and write the process-wide counts,
    except on a thread inside a ``Tally`` (a capture), where they are that
    tally's."""

    def __init__(self, name: str, source: str, replaces: str, entries: dict):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entries = entries
        self._counts = dict(launches=0, calls=0)  # calls: the wrapper's, where counted (K4)
        self._lib = None

    def _get(self, what: str) -> int:
        t = _tally()
        return self._counts[what] if t is None else t.get((self.name, what), 0)

    def _set(self, what: str, v: int) -> None:
        t = _tally()
        if t is None:
            self._counts[what] = v
            return
        t[(self.name, what)] = v
        stop = t.get("yield_if")
        if stop is not None and stop():
            raise CaptureYield(f"a capture gave way after {self.name}")

    launches = property(lambda self: self._get("launches"),
                        lambda self, v: self._set("launches", v))
    calls = property(lambda self: self._get("calls"), lambda self, v: self._set("calls", v))

    @property
    def stem(self) -> str:
        return Path(self.source).stem

    def lib(self):
        if self._lib is None:
            with _LIB_LOCK:
                if self._lib is None:
                    self._load()
        return self._lib

    def _load(self) -> None:
        path = build_all()[self.stem]
        lib = ctypes.CDLL(str(path))
        for fn, args in self.entries.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = I32
        lib.error_string.argtypes = [I32]
        lib.error_string.restype = ctypes.c_char_p
        lib.lib_warm.restype = I32
        self.check_rc(lib, lib.lib_warm())
        self._lib = lib

    def check(self, rc: int) -> None:
        if rc != 0:
            self.check_rc(self.lib(), rc)

    def check_rc(self, lib, rc: int) -> None:
        if rc != 0:
            msg = lib.error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({rc})")


GUARDS = Kernel(
    "guards", "csrc/guards.cu",
    "tla_raft_tpu/ops/mxu_expand.py:398 (MXUExpand.guards + _guard_features:342, "
    "dense_expand.py:184 msg_guard_parts)",
    {"launch_guards": [VP, VP, VP, I32, I32, I32, VP, I32, I32, I32, VP, VP, VP, VP, VP, I64,
                       VP, VP, I64, VP],
     "guards_group_parents": [VP, I32, I32, I32, I32]},
)
MATERIALIZE = Kernel(
    "materialize", "csrc/materialize.cu",
    "tla_raft_tpu/ops/mxu_expand.py:416 (MXUExpand.materialize_added, "
    "+ engine/bfs.py:861 _ids_insert)",
    {"launch_materialize": [VP, VP, I32, I32, I64, VP, VP, I64, VP, I32, VP, VP, VP, VP, VP,
                            VP, I64, VP, I64, VP, VP]},
)
_K3_ARGS = [VP, VP, I32, I32, I64, I32, VP, I32, I32, I32, VP, VP, I32, VP, VP, VP, VP, VP, I64,
            VP, VP, VP]
# K3, every launch but the indexed mode's (any symmetry group: P = 6, 24,
# 120, 5,040 at S = 3, 4, 5, 7; its form by ``k3_form``)
FINGERPRINT = Kernel(
    "fingerprint", "csrc/fingerprint.cu",
    "tla_raft_tpu/ops/fingerprint.py:517 (Fingerprinter.state_fingerprints: "
    "features:102, _plane_matmul:398, msg_hash:418, finalize:505)",
    {"launch_fingerprints": _K3_ARGS},
)
# K3's launches in its factored form (``k3_form``: past 120 permutations,
# S = 7), the indexed mode's included
MSG_FACTORED = Kernel(
    "msg_hash_factored", "csrc/fingerprint.cu",
    "tla_raft_tpu/ops/fingerprint.py:424 (_msg_hash_factored, tables "
    "_build_pair_block_tables:332)",
    {"launch_fingerprints": _K3_ARGS},
)
# K3's indexed mode: the exact fold of orbit pruning's tied rows
ORBIT_FOLD = Kernel(
    "orbit_fold", "csrc/fingerprint.cu",
    "tla_raft_tpu/engine/bfs.py:1056 (_orbit_chunk_fps: the tied rows' min-over-P fold, "
    "state_fingerprints over argsort(~need)[:cap_nd])",
    {"launch_fingerprints": _K3_ARGS},
)
ORBIT = Kernel(
    "orbit", "csrc/orbit.cu",
    "tla_raft_tpu/ops/fingerprint.py:721 (state_fingerprints_orbit: _orbit_pairh:619, "
    "_orbit_colors:634, _orbit_rank:690, _plane_matmul_flat:710)",
    {"launch_orbit": [VP, VP, I32, I32, I64, VP, VP, I32, I32, I32, VP, VP, I32, VP, VP, VP, VP,
                      VP, VP, VP, VP, I64, VP]},
)
_HS_K4 = [VP, I64, VP, VP, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, I64, VP]
HASHSTORE = Kernel(
    "hashstore", "csrc/hashstore.cu",
    "tla_raft_tpu/ops/hashstore.py:270 (probe_and_insert_impl: _probe_rounds:160, "
    "_claim_loop:226)",
    {"hs_k4": _HS_K4, "hs_undo": [VP, I64, VP, VP, VP, VP, VP, VP]},
)
COMPACT = Kernel(
    "compact", "csrc/compact.cu",
    "tla_raft_tpu/engine/bfs.py:287 (_compact_payloads) and "
    "tla_raft_tpu/ops/hashstore.py:351 (compact_fresh)",
    {"launch_compact": [VP, I64, VP, VP, I64, I64, I64, VP, VP, VP, VP, VP, VP, I64, I64, I64,
                        VP],
     "compact_scratch": [I64]},
)
INFLATE = Kernel(
    "inflate", "csrc/msgset.cu",
    "tla_raft_tpu/engine/bfs.py:833 (_ids_to_msgs, under _inflate:894)",
    {"launch_inflate": [VP, I32, I32, I64, I32, VP, VP, I64, VP]},
)
DEFLATE = Kernel(
    "deflate", "csrc/msgset.cu",
    "tla_raft_tpu/engine/bfs.py:847 (_msgs_to_ids, under _deflate:899)",
    {"launch_deflate": [VP, I32, I32, I64, I32, VP, I32, VP, VP]},
)
INV_SCAN = Kernel(
    "inv_scan", "csrc/invariants.cu",
    "tla_raft_tpu/engine/bfs.py:1794 (_inv_scan_impl over "
    "tla_raft_tpu/engine/invariants.py:21-149)",
    {"launch_inv_scan": [VP, VP, I32, I32, I64, VP, VP, I32, VP, I64, I32, VP, VP, I64, VP]},
)
LEVEL = Kernel(
    "level", "csrc/level.cu",
    "tla_raft_tpu/engine/megakernel.py:170 (fused_level_core's carried reductions and "
    "build_level_program:311's ctrl / pidx / slot outputs; the grouped level's group and "
    "tail control, engine/bfs.py:1144, 3522-3690)",
    {
        "lv_begin_launch": [VP, VP, I32, VP, VP],
        "lv_gate_launch": [VP, VP, I32, I64, I64, VP],
        "lv_decide_launch": [VP, I64, VP],
        "slab_live_launch": [VP, I64, VP, VP],
        "lv_finalize_launch": [VP, VP, VP, I64, I32, VP, VP, VP],
        "lv_group_step_launch": [VP, VP, I32, I64, I64, I32, I64, VP],
        "lv_tail_gate_launch": [VP, VP, I32, I64, I64, I64, VP],
    },
)
SUPERSTEP = Kernel(
    "superstep", "csrc/superstep.cu",
    "tla_raft_tpu/engine/superstep.py:181 (build_superstep_program: commit algebra "
    ":258-300, ring append :272-279, meta :280-283)",
    {
        "ss_begin_launch": [VP, VP, VP],
        "ss_commit_launch": [VP, VP, VP, I32, I64, VP, VP, VP, VP],
        "ss_append_launch": [VP, VP, VP, VP, I64, I32, VP, VP, VP, VP],
        "ss_settle_launch": [VP, VP, VP, VP, I32, I64, VP],
    },
)
SIEVE = Kernel(
    "sieve", "csrc/sieve.cu",
    "tla_raft_tpu/ops/sieve.py:194 (probe_impl over _word_and_mask:80)",
    {"sieve_probe_launch": [VP, I64, VP, I64, VP, VP, VP, VP]},
)
HS_PROBE = Kernel(
    "hs_probe", "csrc/hashstore.cu",
    "tla_raft_tpu/ops/hashstore.py:210 (probe_impl over _probe_rounds:160)",
    {"hs_probe": [VP, I64, VP, I64, VP, VP, VP, VP]},
)
FILTER_COMPACT = Kernel(
    "filter_compact", "csrc/compact.cu",
    "tla_raft_tpu/engine/bfs.py:338 (_filter_compact; after hs_probe it is "
    "_group_filter_hash:374)",
    {"launch_filter_compact": [VP, I64, VP, VP, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP, VP],
     "compact_scratch": [I64]},
)
DROP_ROWS = Kernel(
    "drop_rows", "csrc/tiered.cu",
    "tla_raft_tpu/store/tiered.py:810 (drop_rows_impl)",
    {"drop_rows_launch": [VP, I64, VP, VP, VP, I32, VP, VP, VP, VP], "drop_rows_tile": []},
)
DENSE_EXPAND = Kernel(
    "dense_expand", "csrc/dense_expand.cu",
    "tla_raft_tpu/ops/dense_expand.py:330 (DenseExpand.__call__, with "
    "ops/fingerprint.py:392 msg_coef_eff, :456 delta_hash, :528 child_fingerprints; "
    "guards-only: ops/successor.py:339 _expand_guards)",
    {"launch_dense_expand": [VP, VP, I32, VP, I32, VP, I32, VP, I32, I32, VP, VP, VP, I32, VP,
                             I64, VP, VP, VP, VP, VP, VP, I64, VP, VP, I64, VP]},
)
CHUNK_COMPACT = Kernel(
    "chunk_compact", "csrc/compact.cu",
    "tla_raft_tpu/engine/bfs.py:313 (_chunk_compact)",
    {"launch_chunk_compact": [VP, VP, I64, I64, VP, VP, VP, VP, VP, VP, VP, I64, I64, I64, VP],
     "compact_scratch": [I64]},
)
LEGACY = Kernel(
    "legacy_materialize", "csrc/legacy.cu",
    "tla_raft_tpu/ops/successor.py:701-748 (_materialize_one / _materialize / "
    "_materialize_added over the scalar actions :364-665)",
    {"launch_legacy": [VP, VP, I32, I32, I64, VP, VP, I64, VP, I32, VP, VP, VP, VP, VP, VP, I64,
                       VP, I64, VP, VP]},
)
SORTED_MEMBER = Kernel(
    "sorted_member", "csrc/sortstore.cu",
    "tla_raft_tpu/engine/bfs.py:358 (_group_filter: searchsorted against the sorted store; "
    "then the filter compaction, _filter_compact:338)",
    {"launch_sorted_member": [VP, I64, VP, I64, VP, VP, VP]},
)
LEVEL_DEDUP = Kernel(
    "level_dedup", "csrc/sortstore.cu",
    "tla_raft_tpu/engine/bfs.py:407 (_level_dedup: lexsort by (fp_view, fp_full, payload), "
    "first of each fp_view, searchsorted against the store, stable compaction)",
    {"launch_level_dedup": [VP, VP, VP, I64, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP,
                            VP, VP],
     "ld_tile": [], "ld_passes": [], "rs_scan_tile": []},
)
MERGE_SORTED = Kernel(
    "merge_sorted", "csrc/sortstore.cu",
    "tla_raft_tpu/engine/bfs.py:469 (_merge_sorted: jnp.sort of the store and the level's "
    "new fingerprints)",
    {"launch_merge_sorted": [VP, I64, VP, I64, VP, I64, VP]},
)
GROUP_UNIQUE = Kernel(
    "group_unique", "csrc/sortstore.cu",
    "tla_raft_tpu/engine/bfs.py:437 (_group_unique_impl: lexsort of one group's lanes by "
    "(fp_view, fp_full, payload), the first lane of each fp_view, SENT dropped, stable "
    "compaction; jitted as _group_unique :465, fused into _expand_group_fused_impl :1130)",
    {"launch_group_unique": [VP, VP, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP,
                             VP],
     "rs_tile": [], "rs_scan_tile": []},
)
INSERT_ONLY = Kernel(
    "insert_only", "csrc/hashstore.cu",
    "tla_raft_tpu/ops/hashstore.py:325 (insert_only_impl: _claim_loop:226 and the two live "
    "counts; on HashStore.grow :511-531)",
    {"hs_insert": [VP, I64, VP, I64, VP, VP, VP, VP, VP], "hs_live": [VP, I64, VP, VP]},
)
_ROUTE_ARGS = [I32, VP, VP, VP, I64, I32, VP, VP, VP, VP, VP, VP, I64, I64, I64, I64, VP, VP, VP,
               VP, VP, VP]
ROUTE = Kernel(
    "route", "csrc/route.cu",
    "tla_raft_tpu/parallel/sharded.py:659-684 (_body_all_to_all's owner routing; "
    "_body_a2a_phase1 :753-770; the winner grouping of _ship_winners_to_owners :506-518)",
    {"route_launch": _ROUTE_ARGS, "route_tile": [], "route_max_owners": []},
)
ROUTE_BACK = Kernel(
    "route_back", "csrc/route.cu",
    "tla_raft_tpu/parallel/sharded.py:725-726 (the verdicts back to the origin's lanes: "
    "back[owner, rank] & ok_lane; _body_a2a_phase2 :796-797)",
    {"route_back_launch": [VP, VP, VP, I64, I32, I64, VP, VP]},
)
_SHARDED = "tla_raft_tpu/parallel/sharded.py"
PACK_DELTAS = Kernel(
    "pack_deltas", "csrc/deep.cu",
    "tla_raft_tpu/parallel/exchange.py:38 (pack_fp_deltas: the delta/varint stream, its "
    "length nibbles and int64 offsets; in _deep_finalize_body, sharded.py:1156)",
    {"launch_pack_deltas": [VP, I64, VP, I64, VP, VP, VP, VP, VP], "pd_tile": []},
)
DEEP_VERDICT = Kernel(
    "deep_verdict", "csrc/deep.cu",
    f"{_SHARDED}:1159 (_deep_verdict_body: the owner's is-new bits back on its received "
    "lanes)",
    {"launch_deep_verdict": [VP, I64, VP, I64, VP, I64, VP, VP]},
)
DEEP_REPACK = Kernel(
    "deep_repack", "csrc/deep.cu",
    f"{_SHARDED}:1283 (_deep_repack_body: the rounds' shipped children, round-major, into "
    "the next level's segments with gpidx and slots)",
    {"launch_deep_repack": [VP, VP, VP, I32, I32, I32, I64, VP], "rp_chunk": []},
)
SIEVE_MERGE = Kernel(
    "sieve_merge", "csrc/sortstore.cu",
    f"{_SHARDED}:1322 (_deep_sieve_merge_body: the sorted sieve's merge of a round's "
    "candidates, dedup, SENT dropped, the first scap kept, the overflow)",
    {"launch_sieve_merge": [VP, I64, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP, VP]},
)
_BUCKET = "tla_raft_tpu/service/bucket.py"
BUCKET_REFINE = Kernel(
    "bucket_refine", "csrc/bucket.cu",
    f"{_BUCKET}:176 (BucketPrograms._level_step: the per-config MaxRestart refinement, the "
    "salts, the gen / abort segment sums)",
    {"bucket_refine_launch": [VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, I32, I64, I32, VP, I64,
                              VP, VP, VP]},
)
BUCKET_TALLY = Kernel(
    "bucket_tally", "csrc/bucket.cu",
    f"{_BUCKET}:212-266 (_level_step's new segment sum, _fused_level:236's keep filter, "
    "_superstep:336-340's ring append)",
    {"bucket_tally_launch": [VP, VP, I64, VP, VP, I32, VP, VP, I32, VP, VP, VP, VP, VP, I64, VP,
                             VP]},
)
BUCKET_CTRL = Kernel(
    "bucket_ctrl", "csrc/bucket.cu",
    f"{_BUCKET}:270 (_superstep: the while_loop body's retirement and commit algebra "
    ":320-399, the meta rows, crow = crow[rows])",
    {"bucket_ctrl_launch": [I32, VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, I32, VP, VP, VP, VP, VP,
                            I64, VP, VP, VP, I32, VP]},
)
KERNELS = {k.name: k for k in (GUARDS, MATERIALIZE, FINGERPRINT, HASHSTORE, COMPACT, INFLATE,
                               DEFLATE, INV_SCAN, LEVEL, SUPERSTEP, SIEVE, HS_PROBE,
                               FILTER_COMPACT, DROP_ROWS, MSG_FACTORED, ORBIT, ORBIT_FOLD,
                               DENSE_EXPAND, CHUNK_COMPACT, LEGACY, SORTED_MEMBER, LEVEL_DEDUP,
                               MERGE_SORTED, BUCKET_REFINE, BUCKET_TALLY, BUCKET_CTRL,
                               GROUP_UNIQUE, INSERT_ONLY, ROUTE, ROUTE_BACK, PACK_DELTAS,
                               DEEP_VERDICT, DEEP_REPACK, SIEVE_MERGE)}
# the kernels the staged chain launches below the grouping limit
STAGED = ("guards", "materialize", "fingerprint", "hashstore", "compact", "inflate", "deflate",
          "inv_scan")
# the kernels of the fused level and the supersteps (K1 reads the parents'
# id lists there: no inflate)
FUSED = tuple(k for k in STAGED if k != "inflate") + ("level", "superstep", "sieve")
# the grouped level's own (levels past 16 * G chunks)
GROUPED = ("hs_probe", "filter_compact")
# K3's factored message part (where the folded table passes 64 MiB: S = 7)
SCALE = ("msg_hash_factored",)
# orbit pruning (TLA_RAFT_ORBIT=1): the canonical relabel and the tied fold
ORBIT_PATH = ("orbit", "orbit_fold")
# canon="expand" (the fan-out's fingerprints by delta hash), and the legacy
# per-lane kernels of use_mxu=False and --audit
EXPAND_PATH = ("dense_expand", "chunk_compact")
LEGACY_PATH = ("dense_expand", "legacy_materialize")
# the sorted visited store (--no-hashstore, and the grow-failure fallback)
SORTED_PATH = ("sorted_member", "level_dedup", "merge_sorted")
# the sweep service's batched bucket core (service/bucket.py)
BUCKET_PATH = ("bucket_refine", "bucket_tally", "bucket_ctrl")
# the external-store route (--fpstore-dir): the group dedup, then the host
HOST_PATH = ("group_unique",)
# the device mesh's owner routing (parallel/sharded.py; all_to_all and the
# host-store mode: all_gather routes nothing)
MESH_PATH = ("route", "route_back")
# the sharded deep sweep's own (--mesh-deep; sieve_merge: the sorted sieve)
DEEP_PATH = ("pack_deltas", "deep_verdict", "deep_repack", "sieve_merge")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = k.calls = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS.values()}


class Tally:
    """The launches (and calls) of one captured CUDA graph.  From its
    construction to ``take`` (after the capture) the wrappers this thread
    calls count into the tally, not into the counts -- a capture launches
    nothing -- and ``replay`` adds them to the counts once per replay, when
    the graph launches them.  Tallies nest on a thread.  ``yield_if`` (a
    callable): a counted launch after which it is true raises
    ``CaptureYield``, so a capture that may wait (the prewarm's) gives way."""

    def __init__(self, yield_if=None):
        if not hasattr(_TL, "stack"):
            _TL.stack = []
        self._mine: dict = {} if yield_if is None else {"yield_if": yield_if}
        _TL.stack.append(self._mine)
        self.per_replay: dict = {}
        self.calls_per_replay: dict = {}

    def take(self) -> None:
        stack = _TL.stack
        if self._mine in stack:
            stack.remove(self._mine)
        self.per_replay = {k: self._mine.get((k, "launches"), 0) for k in KERNELS}
        self.calls_per_replay = {k: self._mine.get((k, "calls"), 0) for k in KERNELS}

    def replay(self) -> None:
        for k, v in self.per_replay.items():
            KERNELS[k].launches += v
            KERNELS[k].calls += self.calls_per_replay[k]


# -- build ---------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


_BUILT: dict = {}


def build_all() -> dict:
    """Build every kernel library that is not built yet, one nvcc per
    source, all at once; returns {source stem: path}.  Raises if any
    fails."""
    if _BUILT:
        return _BUILT
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    stems = sorted({k.stem for k in KERNELS.values()})
    for stem in stems:
        so = out_dir / f"lib{stem}.so"
        if so.exists():
            continue
        tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
        log = open(out_dir / f"{stem}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name}: {(out_dir / f'{name}.log').read_text()[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    _BUILT.update({stem: out_dir / f"lib{stem}.so" for stem in stems})
    return _BUILT


# -- argument checks -------------------------------------------------------------


def _need(t: torch.Tensor, what: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _core_ptrs(st, n: int, dims: dict):
    from ..models.raft import _CORE_FIELDS

    ptrs = []
    for f in _CORE_FIELDS:
        t = getattr(st, f)
        _need(t, f, torch.uint8, (n, *dims[f]))
        ptrs.append(t.data_ptr())
    return (VP * len(ptrs))(*ptrs)


_SHAPES: dict = {}
_DIMS: dict = {}


def _field_shapes(cfg) -> dict:
    if cfg not in _SHAPES:
        _SHAPES[cfg] = _field_shapes_of(cfg)
    return _SHAPES[cfg]


def _field_shapes_of(cfg) -> dict:
    S, L, V = cfg.S, cfg.L, cfg.V
    return dict(
        voted_for=(S,), current_term=(S,), role=(S,), log_term=(S, L), log_val=(S, L),
        log_len=(S,), match_index=(S, S), next_index=(S, S), commit_index=(S,),
        election_count=(), restart_count=(), pending=(S, S), val_sent=(V,),
    )


def dims_array(cfg, uni):
    """The C ``Dims`` struct of common.cuh, as a ctypes int array (one per
    config: the entry points copy it)."""
    if cfg not in _DIMS:
        _DIMS[cfg] = _dims_array_of(cfg, uni)
    return _DIMS[cfg]


def _dims_array_of(cfg, uni):
    vals = [
        cfg.S, cfg.T, cfg.L, cfg.V, uni.n_entry, uni.ap_npli, uni.ap_pli_min,
        uni.vq_off, uni.vp_off, uni.aq_off, uni.ap_off, uni.M, uni.n_words,
        cfg.majority, cfg.median_index, cfg.max_election, cfg.max_restart,
        int("double-vote" in cfg.mutations), int("legacy-append" in cfg.mutations),
        int("become-follower" in cfg.mutations),
    ]
    return (I32 * len(vals))(*vals)


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream() -> int:
    """The current CUDA stream's handle (the capture stream inside a graph
    capture), read without building a Stream object where torch allows."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch._C._cuda_getDevice())
    return torch.cuda.current_stream().cuda_stream


def _check_cfg(cfg, uni) -> None:
    if not 2 <= cfg.S <= 8:
        raise ValueError(f"the CUDA kernels take 2 <= S <= 8: {cfg.describe()}")


# csrc/dense_expand.cu's per-lane lists: MAX_DELTAS feature deltas and 8
# added message ids
DENSE_MAX_DELTAS, DENSE_MAX_ADDED = 40, 8


def check_dense_cfg(cfg) -> None:
    """Refuse a config whose widest action would overflow dense_expand's
    per-lane lists: FollowerAcceptEntry's truncation writes 2L + 2 feature
    deltas, BecomeLeader 3S + 1, and BecomeCandidate adds S - 1 ids."""
    deltas = max(2 * cfg.L + 2, 3 * cfg.S + 1)
    if deltas > DENSE_MAX_DELTAS or cfg.S - 1 > DENSE_MAX_ADDED:
        raise ValueError(
            f"dense_expand holds {DENSE_MAX_DELTAS} feature deltas and "
            f"{DENSE_MAX_ADDED} added ids a lane; {cfg.describe()} needs {deltas} "
            f"and {cfg.S - 1}")


_ID_BYTES = {torch.int16: 2, torch.int32: 4}


def _ids(t: torch.Tensor, what: str, shape) -> int:
    """Check a message-id list (int16 or int32, the universe's id width) and
    return its width in bytes."""
    if t.dtype not in _ID_BYTES:
        raise ValueError(f"{what}: expected int16 or int32 ids, got {t.dtype}")
    _need(t, what, t.dtype, shape)
    return _ID_BYTES[t.dtype]


# -- wrappers --------------------------------------------------------------------


def _p(t):
    """A tensor's data pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _cnt(cnt):
    if cnt is not None:
        _need(cnt, "cnt", torch.int64, ())
    return _p(cnt)


def guards(mx, st, *, valid=None, per_row=True, cnt=None, sub=0, mult_acc=None, abort_acc=None,
           base=0):
    """K1: (valid bool[B,K], mult i32[B,K], abort bool[B]) of a RaftState
    (its packed message words ``msgs``) or of a Frontier (its id lists
    ``msg_ids``: K1 ORs them into its shared masks, the inflate folded in).

    Counted form (the fused level): ``valid`` given, ``per_row=False``
    (no per-row mult/abort), rows past the device count ``cnt - sub``
    dead; each live row's mult adds into ``mult_acc`` i64[K] and its
    abort (+ ``base``) minimizes into ``abort_acc`` (int64 0-d)."""
    cfg, uni = mx.cfg, mx.uni
    _check_cfg(cfg, uni)
    K = mx.K
    from_ids = hasattr(st, "msg_ids")
    if from_ids:
        B, cap_m = st.msg_ids.shape
        id_bytes = _ids(st.msg_ids, "msg_ids", (B, cap_m))
        msgs, ids, dev = None, st.msg_ids, st.msg_ids.device
    else:
        B, cap_m, id_bytes = st.msgs.shape[0], 0, 0
        _need(st.msgs, "msgs", torch.int32, (B, uni.n_words))
        msgs, ids, dev = st.msgs, None, st.msgs.device
    core = _core_ptrs(st, B, _field_shapes(cfg))
    _need(mx.slot_table, "slot_table", torch.int32, (K, 6))
    if valid is None:
        valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    _need(valid, "valid", torch.bool, (B, K))
    mult = torch.empty((B, K), dtype=torch.int32, device=dev) if per_row else None
    abort = torch.empty((B,), dtype=torch.bool, device=dev) if per_row else None
    if mult_acc is not None:
        _need(mult_acc, "mult_acc", torch.int64, (K,))
    if abort_acc is not None:
        _need(abort_acc, "abort_acc", torch.int64, ())
    lib = GUARDS.lib()
    GUARDS.check(lib.launch_guards(
        core, _p(msgs), _p(ids), id_bytes, cap_m, B, mx.slot_table.data_ptr(), K,
        *mx.layout.accept_runs, dims_array(cfg, uni),
        valid.data_ptr(), _p(mult), _p(abort), _cnt(cnt), sub, _p(mult_acc), _p(abort_acc), base,
        _stream(),
    ))
    GUARDS.launches += int(B > 0)
    return valid, mult, abort


def guards_group_parents(mx, per_row: bool = True) -> int:
    """The parents one block of K1 takes for ``mx``'s config in the per-row
    or the counted form (from the shared-memory budget; 16 at the
    reference constants)."""
    return int(GUARDS.lib().guards_group_parents(dims_array(mx.cfg, mx.uni), mx.K,
                                                 *mx.layout.accept_runs, int(per_row)))


def materialize(mx, fr, pidx, slots, *, pay=None, pay_base=0, out=None, cnt=None, sub=0,
                ovf_any=None, legacy=False):
    """K2: (child Frontier [G], added i32[G, A], overflow bool[G]).

    Lanes are (``pidx``, ``slots``), or payloads ``pay`` =
    (parent + ``pay_base``) * K + slot.  ``out`` = (Frontier, added, ovf)
    to write into; lanes past the device count ``cnt - sub`` are dead, and
    ``ovf_any`` (int64 0-d) is set to 1 when a live lane overflows.

    ``legacy`` launches ``legacy_materialize`` (csrc/legacy.cu, B20: the
    scalar actions, one thread per lane) through the same interface."""
    from ..models.raft import Frontier, _CORE_FIELDS

    cfg, uni = mx.cfg, mx.uni
    _check_cfg(cfg, uni)
    lanes = pay if pay is not None else pidx
    N, G, K, A = fr.msg_ids.shape[0], lanes.shape[0], mx.K, mx.A
    if N == 0:
        raise ValueError("materialize: empty parent frontier")
    shapes = _field_shapes(cfg)
    core = _core_ptrs(fr, N, shapes)
    cap_m = fr.msg_ids.shape[1]
    id_bytes = _ids(fr.msg_ids, "msg_ids", (N, cap_m))
    if pay is not None:
        _need(pay, "pay", torch.int64, (G,))
    else:
        _need(pidx, "pidx", torch.int64, (G,))
        _need(slots, "slots", torch.int64, (G,))
    dev = lanes.device
    if out is None:
        child = Frontier(msg_ids=torch.empty((G, cap_m), dtype=fr.msg_ids.dtype, device=dev),
                         **{f: torch.empty((G, *shapes[f]), dtype=torch.uint8, device=dev)
                            for f in _CORE_FIELDS})
        added = torch.empty((G, A), dtype=torch.int32, device=dev)
        ovf = torch.empty((G,), dtype=torch.bool, device=dev)
    else:
        child, added, ovf = out
        _need(child.msg_ids, "child msg_ids", fr.msg_ids.dtype, (G, cap_m))
        _need(added, "added", torch.int32, (G, A))
        _need(ovf, "ovf", torch.bool, (G,))
    out_ptrs = _core_ptrs(child, G, shapes)
    if ovf_any is not None:
        _need(ovf_any, "ovf_any", torch.int64, ())
    kern = LEGACY if legacy else MATERIALIZE
    lib = kern.lib()
    kern.check(getattr(lib, "launch_legacy" if legacy else "launch_materialize")(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, N, _p(pidx if pay is None else None),
        _p(slots if pay is None else None), G, mx.slot_table.data_ptr(), K,
        dims_array(cfg, uni), out_ptrs, added.data_ptr(), child.msg_ids.data_ptr(),
        ovf.data_ptr(), _p(pay), pay_base, _cnt(cnt), sub, _p(ovf_any), _stream(),
    ))
    kern.launches += int(G > 0)
    return child, added, ovf


def _msg_table(fpr, uni):
    """The orbit kernel's message-part table (``fpr.ktab``), checked: (eff,
    pperm or None, the type layout off[4], stride[4], row_base[4] as a
    ctypes array): the pair-digit table under the factored hash, else the
    folded table."""
    tab = fpr.ktab
    _need(tab["ct"], "ct", torch.int8, (fpr.P * fpr.N_CHAN * 4, tab["f_pad"]))
    if fpr.factored_msgs:
        eff, pperm = tab["gt_eff"], tab["pperm"]
        _need(eff, "gt_eff", torch.int32, (sum(uni.type_strides), fpr.NP, fpr.N_CHAN))
        _need(pperm, "pperm", torch.uint8, (fpr.P, fpr.NP))
    else:
        eff, pperm = tab["msg_eff"], None
        _need(eff, "msg_eff", torch.int32, (uni.M, fpr.P, fpr.N_CHAN))
    row_base = [sum(uni.type_strides[:t]) for t in range(4)]
    return eff, pperm, (I32 * 12)(*uni.type_offsets, *uni.type_strides, *row_base)


# K3's forms, by launch_fingerprints' form code (csrc/fingerprint.cu
# refuses a form asked past its limits)
K3_FORMS = ("s3", "pairs", "factored")


def k3_form(factored: bool, P: int, f_pad: int) -> str:
    """K3's form for a hash of P permutations with an f_pad-wide feature
    table (``Fingerprinter.kernel_tables_np`` keeps it as ``ktab["form"]``
    and builds that form's tables): ``"s3"`` (the folded table: at most 8
    permutations, 128 feature columns, the monolithic hash; S <= 3),
    ``"pairs"`` (the pair-digit fold with every permutation in one block,
    at most 120: S = 4, 5, and S <= 3 under the factored hash or a wide
    feature table) or ``"factored"`` (the pair-digit fold in ranges of 256
    permutations and channel halves, S >= 6)."""
    if not factored and P <= 8 and f_pad <= 128:
        return "s3"
    return "pairs" if P <= 120 else "factored"


def fingerprints(fpr, fr, *, out=None, cnt=None, sub=0, idx=None, ovf=None):
    """K3: (fp_view i64[N], fp_full i64[N]) of a Frontier batch of N rows,
    from the Fingerprinter's kernel tables (``fpr.ktab``) in the form
    they were built for (``k3_form``); lanes past the device count ``cnt - sub`` get SENT.
    Launches of the factored form also count as ``msg_hash_factored``.

    Indexed mode (``idx`` i64[G], with ``cnt``, into ``out``; counted as
    ``orbit_fold``): launch row i < ``cnt - sub`` folds state ``idx[i]``
    into ``out[*][idx[i]]``, every other output keeps its value; ``ovf``
    (int64 0-d) is set to 1 when ``cnt - sub`` passes G."""
    cfg, uni = fpr.cfg, fpr.uni
    _check_cfg(cfg, uni)
    N = fr.msg_ids.shape[0]
    core = _core_ptrs(fr, N, _field_shapes(cfg))
    cap_m = fr.msg_ids.shape[1]
    id_bytes = _ids(fr.msg_ids, "msg_ids", (N, cap_m))
    if fpr.C_planes.device != fr.msg_ids.device:
        raise ValueError("fingerprints: tables and states on different devices")
    dev = fr.msg_ids.device
    G = N
    if idx is not None:
        if out is None or cnt is None:
            raise ValueError("fingerprints: the indexed mode writes into out under a count")
        G = idx.shape[0]
        _need(idx, "idx", torch.int64, (G,))
    if ovf is not None:
        _need(ovf, "ovf", torch.int64, ())
    if out is None:
        out = (torch.empty((N,), dtype=torch.int64, device=dev),
               torch.empty((N,), dtype=torch.int64, device=dev))
    fpv, fpf = out
    _need(fpv, "fp_view", torch.int64, (N,))
    _need(fpf, "fp_full", torch.int64, (N,))
    tab, rows = fpr.ktab, sum(uni.type_strides)
    form = tab["form"]
    _need(tab["ct"], "ct", torch.int8, (fpr.P * fpr.N_CHAN * 4, tab["f_pad"]))
    if form == "s3":
        eff, pperm = tab["msg_eff"], None
        _need(eff, "msg_eff", torch.int32, (uni.M, fpr.P, fpr.N_CHAN))
    else:
        pperm = tab["pperm"]
        _need(pperm, "pperm", torch.uint8, (fpr.P, fpr.NP))
        if form == "pairs":
            eff = tab["gt_eff"]
            _need(eff, "gt_eff", torch.int32, (rows, fpr.NP, fpr.N_CHAN))
        else:  # the factored form reads a gt row's channel halves apart
            eff = tab["gt_half"]
            _need(eff, "gt_half", torch.int32, (rows, 2, fpr.NP, 2))
    tdims = (I32 * 12)(*uni.type_offsets, *uni.type_strides, *tab["row_base"])
    lib = FINGERPRINT.lib()
    FINGERPRINT.check(lib.launch_fingerprints(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, G, K3_FORMS.index(form),
        tab["ct"].data_ptr(), tab["f_pad"], fpr.spec.F, fpr.P, eff.data_ptr(), _p(pperm), fpr.NP,
        tdims, dims_array(cfg, uni), fpv.data_ptr(), fpf.data_ptr(), _cnt(cnt), sub, _p(idx), _p(ovf), _stream(),
    ))
    (ORBIT_FOLD if idx is not None else FINGERPRINT).launches += int(G > 0)
    if form == "factored":
        MSG_FACTORED.launches += int(G > 0)
    return fpv, fpf


def orbit(fpr, fr, *, out=None, discrete=None, rank=None, tied=None, cnt=None, sub=0):
    """B17: (fp_view i64[G], fp_full i64[G], discrete bool[G], rank i32[G])
    of a Frontier batch under orbit pruning: the hash at each state's
    canonical permutation, from K3's tables and the orbit tables' pair-hash
    coefficients.  Rows past the device count ``cnt - sub`` get SENT,
    discrete False, rank 0; ``tied`` (bool[G], optional) is written as
    live and not discrete."""
    cfg, uni = fpr.cfg, fpr.uni
    _check_cfg(cfg, uni)
    G = fr.msg_ids.shape[0]
    core = _core_ptrs(fr, G, _field_shapes(cfg))
    cap_m = fr.msg_ids.shape[1]
    id_bytes = _ids(fr.msg_ids, "msg_ids", (G, cap_m))
    if fpr.C_planes.device != fr.msg_ids.device:
        raise ValueError("orbit: tables and states on different devices")
    dev = fr.msg_ids.device
    if out is None:
        out = (torch.empty((G,), dtype=torch.int64, device=dev),
               torch.empty((G,), dtype=torch.int64, device=dev))
    if discrete is None:
        discrete = torch.empty((G,), dtype=torch.bool, device=dev)
    if rank is None:
        rank = torch.empty((G,), dtype=torch.int32, device=dev)
    fpv, fpf = out
    for name, t, dt in (("fp_view", fpv, torch.int64), ("fp_full", fpf, torch.int64),
                        ("discrete", discrete, torch.bool), ("rank", rank, torch.int32)):
        _need(t, name, dt, (G,))
    if tied is not None:
        _need(tied, "tied", torch.bool, (G,))
    w = fpr.orbit_tables["w_cat"]
    _need(w, "w_cat", torch.int32, (sum(uni.type_strides),))
    eff, pperm, tdims = _msg_table(fpr, uni)
    tab = fpr.ktab
    lib = ORBIT.lib()
    ORBIT.check(lib.launch_orbit(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, G, w.data_ptr(), tab["ct"].data_ptr(),
        tab["f_pad"], fpr.spec.F, fpr.P, eff.data_ptr(), _p(pperm), fpr.NP, tdims,
        dims_array(cfg, uni), fpv.data_ptr(), fpf.data_ptr(), discrete.data_ptr(),
        rank.data_ptr(), _p(tied), _cnt(cnt), sub, _stream(),
    ))
    ORBIT.launches += int(G > 0)
    return fpv, fpf, discrete, rank


# K4's claim rounds (csrc/hashstore.cu, whose constants these mirror): a
# call's control words, i64[KC_LEN]
(KC_CNT0, KC_CNT1, KC_GSTOP, KC_GCUR, KC_GRID, KC_FIRST, KC_BADPAY, KC_FIN, KC_OVF, KC_ROUNDS,
 KC_LEFT, KC_NNEW) = range(12)
KC_LEN = 12
GRID_ROUNDS = 6      # grid-wide rounds a call launches before its finisher
FIN_LANES = 4096     # a pending list this short goes to the one-block finisher
NO_BUDGET = 1 << 62  # the host-driven calls' rounds: until none claims
PAY_BITS = 44        # a payload's field in the representative's word

_SCRATCH: dict = {}  # (device, cap) -> the representative's words and epoch
_SCRATCH_LOCK = threading.Lock()  # the prewarm thread builds programs too
K4_ROUNDS: list = []  # the claim rounds of every host-driven K4 call
INSERT_CTL = None     # the control words of the last insert_only call (device)


def k4_launches(budget: int = NO_BUDGET) -> int:
    """Kernels one K4 call launches: hs_begin, probe_first, the grid
    rounds' claim and verify pairs (at most the budget's), the finisher and
    the fresh pass."""
    return 4 + 2 * min(GRID_ROUNDS, budget)


def check_pay_bound(pay_max: int) -> None:
    """Raise unless every payload below ``pay_max`` fits the representative
    word's 44-bit field (a caller's static bound on its payloads)."""
    if pay_max > 1 << PAY_BITS:
        raise ValueError(f"K4 payloads up to {pay_max} do not fit {PAY_BITS} bits")


def rep_scratch(dev, cap: int):
    """The representative's slab-sized words (i64[2 * cap]: a slot's min
    key, then its payload << 20 | the call's epoch; 16 B a slot) and the
    epoch word (i64[1]), zeroed once per slab size: each call's new epoch
    makes every earlier call's word read as empty, and the epoch's wrap
    clears them (``hs_begin``).  The fused level takes them before its
    capture."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (str(dev), cap)
    with _SCRATCH_LOCK:
        if key not in _SCRATCH:
            _SCRATCH.clear()  # the slab grew: the old size is not used again
            _SCRATCH[key] = (torch.zeros((2 * cap,), dtype=torch.int64, device=dev),
                             torch.zeros((1,), dtype=torch.int64, device=dev))
        return _SCRATCH[key]


def drop_rep_scratch() -> None:
    """Free the representative's words (the slab went: a degrade)."""
    _SCRATCH.clear()


def k4_lanes(n: int, dev) -> tuple:
    """K4's per-lane scratch over ``n`` lanes: (tgt i64 (a lane's claim
    target, then a group lane's slot), flags u8, fresh bool, lists
    int32[2, n] (the pending lanes of even and odd rounds), ctl
    i64[KC_LEN])."""
    if n >= 1 << 32:
        raise ValueError(f"K4 takes fewer than 2^32 lanes, got {n}")
    return (torch.zeros((n,), dtype=torch.int64, device=dev),
            torch.zeros((n,), dtype=torch.uint8, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            torch.zeros((2, n), dtype=torch.int32, device=dev),
            torch.zeros((KC_LEN,), dtype=torch.int64, device=dev))


def _hs_check(slab, fps, keys, pays):
    cap = slab.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"slab capacity must be a power of two, got {cap}")
    n = fps.shape[0]
    _need(slab, "slab", torch.int64, (cap,))
    for name, t in (("fps", fps), ("keys", keys), ("pays", pays)):
        _need(t, name, torch.int64, (n,))
    return cap, n


def _hs_k4(slab, fps, keys, pays, lanes, words, ep, out, cnt, budget: int) -> None:
    cap, n = _hs_check(slab, fps, keys, pays)
    tgt, flags, fresh, lists, ctl = lanes
    for name, t, dt, shape in (("tgt", tgt, torch.int64, (n,)),
                               ("flags", flags, torch.uint8, (n,)),
                               ("fresh", fresh, torch.bool, (n,)),
                               ("lists", lists, torch.int32, (2, n)),
                               ("ctl", ctl, torch.int64, (KC_LEN,)),
                               ("words", words, torch.int64, (2 * cap,)),
                               ("ep", ep, torch.int64, (1,))):
        _need(t, name, dt, shape)
    HASHSTORE.check(HASHSTORE.lib().hs_k4(
        slab.data_ptr(), cap, fps.data_ptr(), keys.data_ptr(), pays.data_ptr(), n,
        tgt.data_ptr(), flags.data_ptr(), lists[0].data_ptr(),
        lists[1].data_ptr(), words.data_ptr(), ep.data_ptr(), ctl.data_ptr(), fresh.data_ptr(),
        *(_p(t) for t in out), _p(cnt), int(budget), _stream(),
    ))
    HASHSTORE.launches += 1 + (k4_launches(budget) - 1 if n else 0)
    HASHSTORE.calls += 1


def probe_and_insert(slab, fps, keys, pays):
    """K4: (slab, fresh bool[N], n_new i64 0-d, overflow bool 0-d).

    Inserts into ``slab`` in place and returns it.  On a probe-depth
    overflow the slots this call claimed are emptied again, so ``slab`` is
    as it was and the caller can grow it and redo the batch.  The claim
    rounds run on the device until none claims; the call reads its control
    words once, after them (the rounds into ``K4_ROUNDS``)."""
    from ..device import fetch

    cap, n = _hs_check(slab, fps, keys, pays)
    lanes = k4_lanes(n, slab.device)
    tgt, flags, fresh, _lists, ctl = lanes
    if n == 0:
        return slab, fresh, ctl[KC_NNEW].clone(), ctl[KC_OVF] > 0
    words, ep = rep_scratch(slab.device, cap)
    _hs_k4(slab, fps, keys, pays, lanes, words, ep, (None,) * 4, None, NO_BUDGET)
    c = fetch(ctl, what="k4")[0]
    if c[KC_BADPAY]:
        raise ValueError(f"K4: a payload outside [0, 2^{PAY_BITS})")
    K4_ROUNDS.append(int(c[KC_ROUNDS]))
    if c[KC_OVF]:
        HASHSTORE.check(HASHSTORE.lib().hs_undo(slab.data_ptr(), n, fps.data_ptr(),
                                                tgt.data_ptr(), flags.data_ptr(), None, None,
                                                _stream()))
        HASHSTORE.launches += 1
    return slab, fresh, ctl[KC_NNEW].clone(), ctl[KC_OVF] > 0


def probe_and_insert_dev(slab, fps, keys, pays, lc, scratch, budget: int):
    """K4 with no host read (the fused level): the live lanes are the first
    ``lc[LC_LIVE_LANES]``; at most ``budget`` claim rounds; the control
    words get the overflow, the rounds that ran, the rounds overflow and
    K4's fresh count.  ``scratch`` = ``k4_lanes(N)`` + (words, ep) of
    ``rep_scratch``."""
    from ..engine import megakernel as mk

    _need(lc, "lc", torch.int64, (mk.LC_LEN,))
    *lanes, words, ep = scratch
    out = tuple(lc[i] for i in (mk.LC_OVF_SLAB, mk.LC_ROUNDS, mk.LC_OVF_ROUNDS, mk.LC_K4_NEW))
    _hs_k4(slab, fps, keys, pays, tuple(lanes), words, ep, out, lc[mk.LC_LIVE_LANES], budget)
    return lanes[2]


def undo_dev(slab, fps, scratch, live, cond):
    """K4's undo, gated on the device flag ``cond`` (int64 0-d), over the
    first ``live`` (int64 0-d) lanes ``fps`` of the last
    ``probe_and_insert_dev``."""
    tgt, flags, *_ = scratch
    n = tgt.shape[0]
    _need(fps, "fps", torch.int64, (n,))
    lib = HASHSTORE.lib()
    HASHSTORE.check(lib.hs_undo(slab.data_ptr(), n, fps.data_ptr(), tgt.data_ptr(),
                                flags.data_ptr(), _cnt(live), _cnt(cond), _stream()))
    HASHSTORE.launches += int(n > 0)


def insert_only(slab, fps):
    """B8 ``insert_only_impl``: (slab, n_inserted i64 0-d, overflow bool
    0-d).  K4's claim rounds alone, into ``slab`` in place: a lane whose
    probe window is full is skipped and raises the overflow, as does a load
    past 1/2 after the insert; n_inserted is the live-count delta.  SENT
    lanes never enter the pending list; no representative, no undo, and no
    host read.  The call's control words stay in ``INSERT_CTL``."""
    global INSERT_CTL
    cap, n = slab.shape[0], fps.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"slab capacity must be a power of two, got {cap}")
    if n >= 1 << 32:
        raise ValueError(f"insert_only takes fewer than 2^32 lanes, got {n}")
    _need(slab, "slab", torch.int64, (cap,))
    _need(fps, "fps", torch.int64, (n,))
    dev = slab.device
    lib = INSERT_ONLY.lib()
    st = _stream()
    ctl = INSERT_CTL = torch.zeros((KC_LEN,), dtype=torch.int64, device=dev)
    live = torch.empty((2,), dtype=torch.int64, device=dev)
    INSERT_ONLY.check(lib.hs_live(slab.data_ptr(), cap, live[0].data_ptr(), st))
    if n:
        tgt = torch.empty((n,), dtype=torch.int64, device=dev)
        lists = torch.empty((2, n), dtype=torch.int32, device=dev)
        INSERT_ONLY.check(lib.hs_insert(slab.data_ptr(), cap, fps.data_ptr(), n, tgt.data_ptr(),
                                        lists[0].data_ptr(), lists[1].data_ptr(),
                                        ctl.data_ptr(), st))
    INSERT_ONLY.check(lib.hs_live(slab.data_ptr(), cap, live[1].data_ptr(), st))
    # live, then hs_begin, probe_first, the grid rounds and the finisher, then live
    INSERT_ONLY.launches += 2 + (3 + 2 * GRID_ROUNDS if n else 0)
    return slab, live[1] - live[0], (ctl[KC_OVF] > 0) | (live[1] * 2 > cap)


def route(cols, fills, D: int, cap: int, *, owner=None, mask=None):
    """B15's owner routing: the stable D-way partition of a shard's lanes.

    Owners are ``fp % D`` (unsigned) of ``cols[0]`` with SENT lanes to the
    virtual owner D, or, with ``owner`` (int32[n]) and ``mask`` (bool[n]),
    ``owner`` where ``mask`` holds and D elsewhere.  Returns (rows: one
    i64[D, cap] per column, lane ``k`` of owner ``o`` at ``[o, k]`` in input
    order, the rest ``fills``; counts i64[D + 1]; lane_owner int32[n];
    lane_rank i64[n]; overflow bool 0-d, an owner below D with more than
    ``cap`` lanes)."""
    n = cols[0].shape[0]
    if not 1 <= len(cols) <= 3 or len(fills) != len(cols):
        raise ValueError("route takes one to three columns and a fill each")
    for k, c in enumerate(cols):
        _need(c, f"cols[{k}]", torch.int64, (n,))
    lib = ROUTE.lib()
    if not 1 <= D <= lib.route_max_owners():
        raise ValueError(f"route takes 1 <= D <= {lib.route_max_owners()}, got {D}")
    if (owner is None) != (mask is None):
        raise ValueError("route: owner and mask come together")
    if owner is not None:
        _need(owner, "owner", torch.int32, (n,))
        _need(mask, "mask", torch.bool, (n,))
    dev = cols[0].device
    rows = [torch.empty((D, cap), dtype=torch.int64, device=dev) for _ in cols]
    counts = torch.empty((D + 1,), dtype=torch.int64, device=dev)
    lane_owner = torch.empty((n,), dtype=torch.int32, device=dev)
    lane_rank = torch.empty((n,), dtype=torch.int64, device=dev)
    ovf = torch.empty((1,), dtype=torch.int64, device=dev)
    n_tiles = (n + lib.route_tile() - 1) // lib.route_tile()
    tile = torch.empty((max((D + 1) * n_tiles, 1),), dtype=torch.int64, device=dev)
    v = [c.data_ptr() for c in cols] + [None] * (3 - len(cols))
    o = [r.data_ptr() for r in rows] + [None] * (3 - len(cols))
    f = list(fills) + [0] * (3 - len(cols))
    ROUTE.check(lib.route_launch(
        0 if owner is None else 1, cols[0].data_ptr(), _p(mask), _p(owner), n, D, *v, *o, *f,
        cap, counts.data_ptr(), lane_owner.data_ptr(), lane_rank.data_ptr(), ovf.data_ptr(),
        tile.data_ptr(), _stream()))
    # count, scan, scatter, pad (the overflow word's memset is no kernel)
    ROUTE.launches += 2 * int(n_tiles > 0) + 1 + int(D * cap > 0)
    return rows, counts, lane_owner, lane_rank, ovf[0] > 0


def route_back(back, lane_owner, lane_rank, D: int, cap: int):
    """The verdicts returned to an origin (bool[D, cap], owner-major as the
    origin sent them) mapped to its lanes: win bool[n] = back[owner, rank]
    for a lane that was sent (owner < D, rank < cap)."""
    n = lane_owner.shape[0]
    _need(back, "back", torch.bool, (D, cap))
    _need(lane_owner, "lane_owner", torch.int32, (n,))
    _need(lane_rank, "lane_rank", torch.int64, (n,))
    win = torch.empty((n,), dtype=torch.bool, device=back.device)
    ROUTE_BACK.check(ROUTE_BACK.lib().route_back_launch(
        back.data_ptr(), lane_owner.data_ptr(), lane_rank.data_ptr(), n, D, cap,
        win.data_ptr(), _stream()))
    ROUTE_BACK.launches += int(n > 0)
    return win


def compact(flags, va, pad_a, cap, vb=None, pad_b=0, want_lane=False, *, out_a=None,
            out_b=None, total=None, cnt=None, sub=0, mul=1, iota_base=0, tile=None):
    """Order-keeping compaction of the flagged lanes' values to ``cap``
    lanes: (out_a i64[cap] (pad_a past the kept prefix), out_b or None,
    lane bool[cap] or None, total i64 0-d = the number of flagged lanes).
    ``va`` None means the values are ``iota_base + lane``; with ``cnt``
    only the first ``(cnt - sub) * mul`` flag lanes count.  ``tile`` (the
    scratch of ``compact_tiles(n)`` words, zero when allocated and kept for
    compactions alone) may be given, as a captured graph does."""
    n = flags.shape[0]
    _need(flags, "flags", torch.bool, (n,))
    if va is not None:
        _need(va, "va", torch.int64, (n,))
    if vb is not None:
        _need(vb, "vb", torch.int64, (n,))
    dev = flags.device
    lib = COMPACT.lib()
    oa = torch.empty((cap,), dtype=torch.int64, device=dev) if out_a is None else out_a
    ob = out_b
    if vb is not None and ob is None:
        ob = torch.empty((cap,), dtype=torch.int64, device=dev)
    _need(oa, "out_a", torch.int64, (cap,))
    if ob is not None:
        _need(ob, "out_b", torch.int64, (cap,))
    lane = torch.empty((cap,), dtype=torch.bool, device=dev) if want_lane else None
    tile = _compact_scratch(COMPACT, tile, n, dev)
    if total is None:
        total = torch.empty((), dtype=torch.int64, device=dev)
    _need(total, "total", torch.int64, ())
    COMPACT.check(lib.launch_compact(
        flags.data_ptr(), n, _p(va), _p(vb), pad_a, pad_b, cap, oa.data_ptr(), _p(ob),
        _p(lane), tile.data_ptr(), total.data_ptr(), _cnt(cnt), sub, mul, iota_base, _stream(),
    ))
    COMPACT.launches += compact_launches(n)
    return oa, ob, lane, total


def dense_expand(dx, st, want_fp: bool, *, valid=None, per_row=True, fpv=None, fpf=None,
                 cnt=None, sub=0, mult_acc=None, abort_acc=None, base=0, mult_out=None,
                 abort_out=None):
    """B18: (valid bool[B,K], mult i32[B,K], fp_view i64[B,K], fp_full
    i64[B,K], abort bool[B]) of a RaftState, fingerprints (SENT where
    invalid) only with ``want_fp`` (else None).

    Counted form (the fused level): ``per_row=False`` (no per-row mult /
    abort), rows past the device count ``cnt - sub`` dead (nothing written);
    each live row's mult adds into ``mult_acc`` i64[K] and its abort (+
    ``base``) minimizes into ``abort_acc`` (int64 0-d)."""
    cfg, uni = dx.cfg, dx.uni
    _check_cfg(cfg, uni)
    check_dense_cfg(cfg)
    fpr = dx.fpr
    B, K = st.msgs.shape[0], dx.K
    core = _core_ptrs(st, B, _field_shapes(cfg))
    _need(st.msgs, "msgs", torch.int32, (B, uni.n_words))
    _need(dx.slot_table, "slot_table", torch.int32, (K, 6))
    dev = st.msgs.device
    if valid is None:
        valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    _need(valid, "valid", torch.bool, (B, K))
    mult = abort = None
    if per_row:  # the per-row outputs, into the caller's buffers when given
        mult = torch.empty((B, K), dtype=torch.int32, device=dev) if mult_out is None else mult_out
        abort = torch.empty((B,), dtype=torch.bool, device=dev) if abort_out is None else abort_out
        _need(mult, "mult", torch.int32, (B, K))
        _need(abort, "abort", torch.bool, (B,))
    if mult_acc is not None:
        _need(mult_acc, "mult_acc", torch.int64, (K,))
    if abort_acc is not None:
        _need(abort_acc, "abort_acc", torch.int64, ())
    F = P = NP = 0
    ceff = eff = gt = pperm = None
    tdims = (I32 * 12)(*([0] * 12))
    if want_fp:
        if fpv is None:
            fpv = torch.empty((B, K), dtype=torch.int64, device=dev)
        if fpf is None:
            fpf = torch.empty((B, K), dtype=torch.int64, device=dev)
        _need(fpv, "fp_view", torch.int64, (B, K))
        _need(fpf, "fp_full", torch.int64, (B, K))
        F, P, NP = fpr.spec.F, fpr.P, fpr.NP
        ceff, pperm = fpr.ceff, dx.pperm32
        _need(ceff, "ceff", torch.int32, (F, P, fpr.N_CHAN))
        _need(pperm, "pperm", torch.int32, (P, NP))
        tab, _pp8, tdims = _msg_table(fpr, uni)
        if fpr.factored_msgs:
            gt = tab
        else:
            eff = tab
    else:
        fpv = fpf = None
    lib = DENSE_EXPAND.lib()
    DENSE_EXPAND.check(lib.launch_dense_expand(
        core, st.msgs.data_ptr(), B, dx.slot_table.data_ptr(), K, dims_array(cfg, uni),
        int(want_fp), _p(ceff), F, P, _p(eff), _p(gt), _p(pperm), NP, tdims, int(fpr.seed),
        valid.data_ptr(), _p(mult), _p(abort), _p(fpv), _p(fpf), _cnt(cnt), sub, _p(mult_acc),
        _p(abort_acc), base, _stream(),
    ))
    DENSE_EXPAND.launches += int(B > 0)
    return valid, mult, fpv, fpf, abort


def chunk_compact(fpv, fpf, cap, *, iota_base=0, out=None, total=None, ovf=None, cnt=None,
                  sub=0, mul=1, flags=None, tile=None):
    """B3 ``_chunk_compact``: the lanes of ``fpv`` that are not SENT, in
    lane order, to ``cap`` lanes (ov, of, op) padded (SENT, SENT, -1), the
    payload of lane i being ``iota_base + i``; returns (ov, of, op, total
    i64 0-d).  ``ovf`` (int64 0-d) is set to 1 when more than ``cap`` lanes
    live; with ``cnt`` only the first ``(cnt - sub) * mul`` lanes count.
    ``tile``: as ``compact``'s.  The kernel reads its flags from ``fpv``
    (not SENT), so ``flags``, a flag scratch the earlier design wrote, is
    taken and not used."""
    del flags
    n = fpv.shape[0]
    _need(fpv, "fp_view", torch.int64, (n,))
    _need(fpf, "fp_full", torch.int64, (n,))
    dev = fpv.device
    if out is None:
        out = tuple(torch.empty((cap,), dtype=torch.int64, device=dev) for _ in range(3))
    for name, t in zip(("ov", "of", "op"), out):
        _need(t, name, torch.int64, (cap,))
    lib = CHUNK_COMPACT.lib()
    tile = _compact_scratch(CHUNK_COMPACT, tile, n, dev)
    if total is None:
        total = torch.empty((), dtype=torch.int64, device=dev)
    _need(total, "total", torch.int64, ())
    if ovf is not None:
        _need(ovf, "ovf", torch.int64, ())
    CHUNK_COMPACT.check(lib.launch_chunk_compact(
        fpv.data_ptr(), fpf.data_ptr(), n, cap, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), tile.data_ptr(), total.data_ptr(), _p(ovf), _cnt(cnt), sub, mul,
        iota_base, _stream()))
    CHUNK_COMPACT.launches += compact_launches(n)
    return (*out, total)


def compact_tiles(n: int) -> int:
    """Scratch words a compaction of ``n`` lanes needs (``compact``,
    ``chunk_compact``, ``filter_compact``): its ticket, epoch and a status
    word each 8,192 lanes (csrc/compact.cuh).  The count grows with ``n``,
    so a scratch sized for ``n`` serves every compaction of at most ``n``
    lanes.  Allocate them zeroed, and use them for compactions alone: the
    words carry over from call to call."""
    return int(COMPACT.lib().compact_scratch(n))


def compact_launches(n: int) -> int:
    """The CUDA kernels one compaction of ``n`` lanes launches:
    compact_pass (over at least one lane) and compact_pad."""
    return int(n > 0) + 1


def _compact_scratch(kern: Kernel, tile, n: int, dev):
    """A compaction's scratch: ``tile`` checked, or a zeroed new one."""
    words = int(kern.lib().compact_scratch(n))
    if tile is None:
        return torch.zeros((words,), dtype=torch.int64, device=dev)
    _need(tile, "tile", torch.int64, (tile.shape[0],))
    if tile.numel() < words:
        raise ValueError(f"{kern.name}: tile scratch of {tile.numel()} words, needs {words}")
    return tile


def inflate(ids, n_words: int, *, out=None, cnt=None, sub=0):
    """Sparse ids int16/int32 [n, cap_m] (-1 padded) -> packed int32 words
    [n, n_words]."""
    n, cap_m = ids.shape
    id_bytes = _ids(ids, "msg_ids", (n, cap_m))
    msgs = torch.empty((n, n_words), dtype=torch.int32, device=ids.device) if out is None else out
    _need(msgs, "msgs", torch.int32, (n, n_words))
    lib = INFLATE.lib()
    INFLATE.check(lib.launch_inflate(ids.data_ptr(), id_bytes, cap_m, n, n_words,
                                     msgs.data_ptr(), _cnt(cnt), sub, _stream()))
    INFLATE.launches += int(n > 0)
    return msgs


def deflate(msgs, M: int, cap_m: int, id_dtype):
    """Packed words int32[n, n_words] -> (ascending -1-padded ids
    [n, cap_m] of ``id_dtype`` (int16 for M < 2^15, else int32),
    overflow bool[n])."""
    n, n_words = msgs.shape
    if id_dtype not in _ID_BYTES or M > 1 << (8 * _ID_BYTES[id_dtype] - 1) or n_words * 32 < M:
        raise ValueError(f"deflate: M={M} ids do not fit {id_dtype} or {n_words} words")
    _need(msgs, "msgs", torch.int32, (n, n_words))
    ids = torch.empty((n, cap_m), dtype=id_dtype, device=msgs.device)
    ovf = torch.empty((n,), dtype=torch.bool, device=msgs.device)
    lib = DEFLATE.lib()
    DEFLATE.check(lib.launch_deflate(msgs.data_ptr(), n_words, M, n, cap_m, ids.data_ptr(),
                                     _ID_BYTES[id_dtype], ovf.data_ptr(), _stream()))
    DEFLATE.launches += int(n > 0)
    return ids, ovf


INV_CODES = {
    "Inv": 0, "LeaderHasAllCommittedEntries": 0, "RaftCanCommt": 1, "FollowerCanCommit": 2,
    "CommitAll": 3, "NoSplitVote": 4, "NoAllCommit": 5, "ExistLeaderAndCandidate": 6,
}


# the invariant scan's tile: states a block stages and evaluates at once
# (csrc/invariants.cu IV_ROWS)
INV_ROWS = 512


def inv_scan(cfg, uni, fr, names, offset: int = 0, into=None, *, cnt=None, sub=0):
    """First row (+ ``offset``) of a Frontier that violates one of the
    invariants ``names`` (``~Name`` negates), or -1: an int64 0-d tensor.
    With ``into`` (an earlier result) the smaller bad row of the two is
    kept, in ``into`` itself; rows past the device count ``cnt - sub`` are
    not scanned.  One launch of a persistent grid over tiles of
    ``INV_ROWS`` rows, however many rows are live."""
    _check_cfg(cfg, uni)
    names = list(names)
    if not 1 <= len(names) <= 8:
        raise ValueError(f"inv_scan takes 1 to 8 invariants, got {len(names)}")
    n = fr.msg_ids.shape[0]
    core = _core_ptrs(fr, n, _field_shapes(cfg))
    cap_m = fr.msg_ids.shape[1]
    id_bytes = _ids(fr.msg_ids, "msg_ids", (n, cap_m))
    codes = (I32 * len(names))(*(INV_CODES[nm.lstrip("~")] for nm in names))
    neg = (I32 * len(names))(*(int(nm.startswith("~")) for nm in names))
    if into is None:
        out = torch.empty((), dtype=torch.int64, device=fr.msg_ids.device)
    else:
        _need(into, "into", torch.int64, ())
        out = into
    lib = INV_SCAN.lib()
    INV_SCAN.check(lib.launch_inv_scan(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, n, codes, neg, len(names),
        dims_array(cfg, uni),
        offset, int(into is None), out.data_ptr(), _cnt(cnt), sub, _stream(),
    ))
    INV_SCAN.launches += int(n > 0)
    return out


# -- B11: level control (csrc/level.cu) --------------------------------------------


def level_begin(lc, mult, n_run) -> None:
    """The level's control words and mult[K] to their empty values, the
    parent count from the device word ``n_run``."""
    _need(mult, "mult", torch.int64, (mult.shape[0],))
    LEVEL.check(LEVEL.lib().lv_begin_launch(lc.data_ptr(), mult.data_ptr(), mult.shape[0],
                                            _cnt(n_run), _stream()))
    LEVEL.launches += 1


def level_gate(lc, chunk_total, cap_x: int, chunk: int) -> None:
    """OVF_X from the chunks' totals; LIVE_LANES, 0 when K4 must not run."""
    _need(chunk_total, "chunk_total", torch.int64, (chunk_total.shape[0],))
    LEVEL.check(LEVEL.lib().lv_gate_launch(lc.data_ptr(), chunk_total.data_ptr(),
                                           chunk_total.shape[0], cap_x, chunk, _stream()))
    LEVEL.launches += 1


def level_decide(lc, cap_out: int) -> None:
    """The per-level undo flag."""
    LEVEL.check(LEVEL.lib().lv_decide_launch(lc.data_ptr(), cap_out, _stream()))
    LEVEL.launches += 1


def slab_live(slab, out) -> None:
    """``out`` (int64 0-d, zeroed by the caller) += the slab's live slots."""
    _need(slab, "slab", torch.int64, (slab.shape[0],))
    _need(out, "out", torch.int64, ())
    LEVEL.check(LEVEL.lib().slab_live_launch(slab.data_ptr(), slab.shape[0], out.data_ptr(),
                                             _stream()))
    LEVEL.launches += 1


def level_finalize(lc, ctrl, pay, K: int, pidx, slot) -> None:
    """ctrl i64[8] (the reference's layout) and the survivors' pidx u32 /
    slot u16 (int32 / int16 bit patterns) from their payloads, for the
    first ``lc[LC_N_NEW]`` lanes only (the rest are left as they were)."""
    n = pay.shape[0]
    _need(ctrl, "ctrl", torch.int64, (8,))
    _need(pay, "pay", torch.int64, (n,))
    _need(pidx, "pidx", torch.int32, (n,))
    _need(slot, "slot", torch.int16, (n,))
    LEVEL.check(LEVEL.lib().lv_finalize_launch(lc.data_ptr(), ctrl.data_ptr(), pay.data_ptr(), n,
                                               K, pidx.data_ptr(), slot.data_ptr(), _stream()))
    LEVEL.launches += 1


# -- B12: superstep commit and ring (csrc/superstep.cu) ------------------------------


def ss_begin(ss, args) -> None:
    _need(args, "args", torch.int64, (3,))
    SUPERSTEP.check(SUPERSTEP.lib().ss_begin_launch(ss.data_ptr(), args.data_ptr(), _stream()))
    SUPERSTEP.launches += 1


def ss_commit(ss, lc, mult, cap_f: int, meta_n, meta_mult, meta_rounds) -> None:
    K = mult.shape[0]
    _need(meta_mult, "meta_mult", torch.int64, (meta_n.shape[0], K))
    SUPERSTEP.check(SUPERSTEP.lib().ss_commit_launch(
        ss.data_ptr(), lc.data_ptr(), mult.data_ptr(), K, cap_f, meta_n.data_ptr(),
        meta_mult.data_ptr(), meta_rounds.data_ptr(), _stream()))
    SUPERSTEP.launches += 1


def ss_append(ss, lc, fps, pay, K: int, ring_fps, ring_pidx, ring_slot) -> None:
    n = fps.shape[0]
    _need(pay, "pay", torch.int64, (n,))
    _need(ring_pidx, "ring_pidx", torch.int32, (ring_fps.shape[0],))
    _need(ring_slot, "ring_slot", torch.int16, (ring_fps.shape[0],))
    SUPERSTEP.check(SUPERSTEP.lib().ss_append_launch(
        ss.data_ptr(), lc.data_ptr(), fps.data_ptr(), pay.data_ptr(), n, K, ring_fps.data_ptr(),
        ring_pidx.data_ptr(), ring_slot.data_ptr(), _stream()))
    SUPERSTEP.launches += 1


def ss_settle(ss, src, dst) -> None:
    """Copy the committed frontier rows from ``src`` into ``dst`` (two
    Frontiers of one capacity) when an odd number of levels committed."""
    if len(src) > 16:
        raise ValueError("ss_settle takes at most 16 fields")
    widths = []
    for a, b in zip(src, dst):
        if a.shape != b.shape or a.dtype != b.dtype or not (a.is_contiguous() and
                                                            b.is_contiguous()):
            raise ValueError("ss_settle: mismatched frontier buffers")
        widths.append(a[0].numel() * a.element_size())
    rows = src[0].shape[0]
    n = len(widths)
    SUPERSTEP.check(SUPERSTEP.lib().ss_settle_launch(
        ss.data_ptr(), (VP * n)(*(a.data_ptr() for a in src)),
        (VP * n)(*(b.data_ptr() for b in dst)), (ctypes.c_longlong * n)(*widths), n, rows,
        _stream()))
    SUPERSTEP.launches += 1


# -- B13: sieve probe (csrc/sieve.cu) -------------------------------------------


def sieve_probe(words, fps, *, hit=None, count=None, cnt=None) -> None:
    """Blocked-bloom probe of the lanes of ``fps``: ``hit`` bool[n] per
    lane and/or ``count`` (int64 0-d) += the live lanes (not SENT) that
    hit.  With ``cnt`` (int64 0-d, the level's n_new) only the first
    ``cnt`` lanes are probed; the flags past it are 0."""
    m, n = words.shape[0], fps.shape[0]
    _need(words, "words", torch.int64, (m,))
    _need(fps, "fps", torch.int64, (n,))
    if hit is not None:
        _need(hit, "hit", torch.bool, (n,))
    SIEVE.check(SIEVE.lib().sieve_probe_launch(words.data_ptr(), m, fps.data_ptr(), n, _p(hit),
                                               _cnt(count), _cnt(cnt), _stream()))
    SIEVE.launches += int(n > 0)


# -- B8 membership, B3 filter compaction (the grouped level) -------------------------


def hs_probe(slab, fps, *, hit=None, keep=None, cnt=None):
    """B8 probe: ``hit`` bool[n] (fps[i] is in the slab) and/or ``keep``
    bool[n] (live and not in the slab); lanes past the device count
    ``cnt`` are neither.  Allocates ``hit`` when neither is given."""
    cap, n = slab.shape[0], fps.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"slab capacity must be a power of two, got {cap}")
    _need(slab, "slab", torch.int64, (cap,))
    _need(fps, "fps", torch.int64, (n,))
    if hit is None and keep is None:
        hit = torch.empty((n,), dtype=torch.bool, device=fps.device)
    for name, t in (("hit", hit), ("keep", keep)):
        if t is not None:
            _need(t, name, torch.bool, (n,))
    HS_PROBE.check(HS_PROBE.lib().hs_probe(slab.data_ptr(), cap, fps.data_ptr(), n, _p(hit),
                                           _p(keep), _cnt(cnt), _stream()))
    HS_PROBE.launches += int(n > 0)
    return hit


def filter_compact(keep, cv, cf, cp, cap, *, out=None, total=None, out_off=None, pay_off=None,
                   ovf=None, tile=None):
    """B3 filter compaction: the ``keep`` lanes of (cv, cf, cp) packed in
    lane order to ``cap`` lanes padded (SENT, SENT, -1): (ov, of, op,
    total i64 0-d).  With ``out`` = (ov, of, op) they are written at lane
    ``*out_off`` of those buffers; ``pay_off`` (int64 0-d) is added to
    every kept payload; ``ovf`` (int64 0-d) is set to 1 when more than
    ``cap`` lanes are kept."""
    n = keep.shape[0]
    _need(keep, "keep", torch.bool, (n,))
    for name, t in (("cv", cv), ("cf", cf), ("cp", cp)):
        _need(t, name, torch.int64, (n,))
    dev = keep.device
    if out is None:
        out = tuple(torch.empty((cap,), dtype=torch.int64, device=dev) for _ in range(3))
    for name, t in zip(("ov", "of", "op"), out):
        _need(t, name, torch.int64, (t.shape[0],))
        if t.shape[0] < cap or (out_off is None and t.shape[0] != cap):
            raise ValueError(f"filter_compact: {name} holds {t.shape[0]} lanes, cap is {cap}")
    for name, t in (("out_off", out_off), ("pay_off", pay_off), ("ovf", ovf)):
        if t is not None:
            _need(t, name, torch.int64, ())
    lib = FILTER_COMPACT.lib()
    tile = _compact_scratch(FILTER_COMPACT, tile, n, dev)
    if total is None:
        total = torch.empty((), dtype=torch.int64, device=dev)
    _need(total, "total", torch.int64, ())
    FILTER_COMPACT.check(lib.launch_filter_compact(
        keep.data_ptr(), n, cv.data_ptr(), cf.data_ptr(), cp.data_ptr(), cap, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), tile.data_ptr(), total.data_ptr(), _p(out_off),
        _p(pay_off), _p(ovf), _stream()))
    FILTER_COMPACT.launches += compact_launches(n)
    return (*out, total)


def group_step(lc, chunk_total, cap_x: int, rows: int, K: int, cap_g: int) -> None:
    """One control launch at the head of a group: the previous group closed
    (its ``chunk_total`` past cap_x into OVF_X, its abort into the
    level's), then this group's live rows, payload base and lane offset
    from the group index in ``lc`` (``LC_GROUP``), and the index advanced."""
    _need(chunk_total, "chunk_total", torch.int64, (chunk_total.shape[0],))
    LEVEL.check(LEVEL.lib().lv_group_step_launch(lc.data_ptr(), chunk_total.data_ptr(),
                                                 chunk_total.shape[0], cap_x, rows, K, cap_g,
                                                 _stream()))
    LEVEL.launches += 1


def tail_gate(lc, chunk_total, cap_x: int, rows: int, lanes: int) -> None:
    """The last group closed as ``group_step`` closes one, then LIVE_LANES
    of the grouped level's probe-and-insert: ``lanes``, or 0 when the
    level aborted or overflowed cap_x, cap_m or cap_g."""
    _need(chunk_total, "chunk_total", torch.int64, (chunk_total.shape[0],))
    LEVEL.check(LEVEL.lib().lv_tail_gate_launch(lc.data_ptr(), chunk_total.data_ptr(),
                                                chunk_total.shape[0], cap_x, rows, lanes,
                                                _stream()))
    LEVEL.launches += 1


# -- B16: frontier row compaction (csrc/tiered.cu) ---------------------------------


def drop_rows(keep, src, dst):
    """B16: the ``keep`` rows of the buffers ``src`` (a Frontier, every
    field with ``rows`` rows) packed in order to the front of ``dst`` (the
    same shapes), every later row zero; returns the kept count (int64
    0-d)."""
    rows = keep.shape[0]
    _need(keep, "keep", torch.bool, (rows,))
    if len(src) > 16:
        raise ValueError("drop_rows takes at most 16 fields")
    widths = []
    for a, b in zip(src, dst):
        if a.shape != b.shape or a.dtype != b.dtype or a.shape[0] != rows or not (
                a.is_cuda and a.is_contiguous() and b.is_contiguous()):
            raise ValueError("drop_rows: mismatched frontier buffers")
        widths.append(a[0].numel() * a.element_size() if rows else 0)
    lib = DROP_ROWS.lib()
    dev = keep.device
    tile = torch.empty((max((rows + lib.drop_rows_tile() - 1) // lib.drop_rows_tile(), 1),),
                       dtype=torch.int64, device=dev)
    idx = torch.empty((max(rows, 1),), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    n = len(widths)
    DROP_ROWS.check(lib.drop_rows_launch(
        keep.data_ptr(), rows, (VP * n)(*(a.data_ptr() for a in src)),
        (VP * n)(*(b.data_ptr() for b in dst)), (ctypes.c_longlong * n)(*widths), n,
        tile.data_ptr(), idx.data_ptr(), total.data_ptr(), _stream()))
    # count_tiles, scan_offsets, scatter_rows, gather_rows
    DROP_ROWS.launches += 3 * int(rows > 0) + 1
    return total


# -- B19: the sorted visited store (csrc/sortstore.cu) -------------------------------


def sorted_member(visited, fps, *, hit=None, keep=None):
    """B19 membership against the sorted store ``visited`` (u64 in int64,
    ascending as unsigned): ``hit`` bool[n] (fps[i] is in it) and/or
    ``keep`` bool[n] (not SENT and not in it).  Allocates ``hit`` when
    neither is given."""
    V, n = visited.shape[0], fps.shape[0]
    _need(visited, "visited", torch.int64, (V,))
    _need(fps, "fps", torch.int64, (n,))
    if hit is None and keep is None:
        hit = torch.empty((n,), dtype=torch.bool, device=fps.device)
    for name, t in (("hit", hit), ("keep", keep)):
        if t is not None:
            _need(t, name, torch.bool, (n,))
    SORTED_MEMBER.check(SORTED_MEMBER.lib().launch_sorted_member(
        visited.data_ptr(), V, fps.data_ptr(), n, _p(hit), _p(keep), _stream()))
    SORTED_MEMBER.launches += int(n > 0)
    return hit


def level_dedup(cv, cf, cp, visited):
    """B19 ``_level_dedup``: (n_new i64 0-d, new_fps i64[n], new_pay
    i64[n]) -- the first lane of each fp_view in (fp_view, fp_full,
    payload) order that is neither SENT nor in ``visited``, packed in that
    order, padded SENT and -1."""
    n, V = cv.shape[0], visited.shape[0]
    for name, t in (("cv", cv), ("cf", cf), ("cp", cp)):
        _need(t, name, torch.int64, (n,))
    _need(visited, "visited", torch.int64, (V,))
    if n >= 1 << 31:
        raise ValueError(f"level_dedup takes fewer than 2^31 lanes, got {n}")
    dev = cv.device
    lib = LEVEL_DEDUP.lib()
    nb = (n + lib.ld_tile() - 1) // lib.ld_tile()
    scan_t = lib.rs_scan_tile()
    passes = lib.ld_passes()
    new_fps = torch.empty((n,), dtype=torch.int64, device=dev)
    new_pay = torch.empty((n,), dtype=torch.int64, device=dev)
    n_new = torch.empty((), dtype=torch.int64, device=dev)
    keys = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    idx = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    status = torch.empty((max(256 * nb, 1),), dtype=torch.int64, device=dev)
    aux = torch.empty((passes * 256 + 8,), dtype=torch.int64, device=dev)
    flags = torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)
    sp = torch.empty((max(n, 1),), dtype=torch.int64, device=dev)
    tile = torch.empty((max((n + scan_t - 1) // scan_t, 1),), dtype=torch.int64, device=dev)
    cscr = torch.zeros((compact_tiles(n),), dtype=torch.int64, device=dev)
    LEVEL_DEDUP.check(lib.launch_level_dedup(
        cv.data_ptr(), cf.data_ptr(), cp.data_ptr(), n, visited.data_ptr(), V,
        new_fps.data_ptr(), new_pay.data_ptr(), n_new.data_ptr(), keys.data_ptr(),
        idx.data_ptr(), status.data_ptr(), aux.data_ptr(), flags.data_ptr(), sp.data_ptr(),
        tile.data_ptr(), cscr.data_ptr(), _stream()))
    LEVEL_DEDUP.launches += level_dedup_launches(n, passes)
    return n_new, new_fps, new_pay


def level_dedup_launches(n: int, passes: int = 8) -> int:
    """The CUDA kernels one ``level_dedup`` call of ``n`` lanes launches:
    ld_count, ld_scan, ld_live, a pass a digit and ld_heads, then the
    compaction's two (of an empty call, its pad alone)."""
    return 3 + passes + 1 + compact_launches(n) if n > 0 else compact_launches(0)


def merge_sorted(a, b, n_out: int):
    """B19 ``_merge_sorted``: the first ``n_out`` values of the sorted
    union of ``a`` and ``b`` (each ascending as unsigned u64)."""
    A, B = a.shape[0], b.shape[0]
    _need(a, "a", torch.int64, (A,))
    _need(b, "b", torch.int64, (B,))
    if not 0 <= n_out <= A + B:
        raise ValueError(f"merge_sorted: n_out {n_out} outside [0, {A + B}]")
    out = torch.empty((n_out,), dtype=torch.int64, device=a.device)
    MERGE_SORTED.check(MERGE_SORTED.lib().launch_merge_sorted(
        a.data_ptr(), A, b.data_ptr(), B, out.data_ptr(), n_out, _stream()))
    MERGE_SORTED.launches += int(n_out > 0)
    return out


class GroupUniqueScratch:
    """``group_unique``'s scratch for ``n`` lanes, allocated once (a group
    program's graph keeps the addresses)."""

    def __init__(self, n: int, device):
        lib = GROUP_UNIQUE.lib()
        nb = (n + lib.rs_tile() - 1) // lib.rs_tile()
        scan_t = lib.rs_scan_tile()
        n_parts = (256 * nb + scan_t - 1) // scan_t
        self.n = n
        self.keys = torch.empty((2 * n,), dtype=torch.int64, device=device)
        self.idx = torch.empty((2 * n,), dtype=torch.int32, device=device)
        self.counts = torch.empty((max(256 * nb, 1),), dtype=torch.int32, device=device)
        self.part = torch.empty((n_parts + 1,), dtype=torch.int64, device=device)
        self.flags = torch.empty((max(n, 1),), dtype=torch.uint8, device=device)
        self.bf = torch.empty((max(n, 1),), dtype=torch.int64, device=device)
        self.bp = torch.empty((max(n, 1),), dtype=torch.int64, device=device)
        self.tile = torch.zeros((compact_tiles(n),), dtype=torch.int64, device=device)


def group_unique(cv, cf, cp, *, out=None, n_u=None, scratch=None):
    """B19 ``_group_unique_impl``: (n_u i64 0-d, gv i64[n], gf i64[n], gp
    i64[n]) -- of every run of equal fp_view that is not SENT, the first
    lane in (fp_view, fp_full, payload) order, packed fp_view-ascending,
    padded SENT, SENT and -1.  ``out`` (gv, gf, gp), ``n_u`` and
    ``scratch`` (a ``GroupUniqueScratch`` of n lanes) may be given, as a
    captured graph does; else they are allocated."""
    n = cv.shape[0]
    for name, t in (("cv", cv), ("cf", cf), ("cp", cp)):
        _need(t, name, torch.int64, (n,))
    if n >= 1 << 31:
        raise ValueError(f"group_unique takes fewer than 2^31 lanes, got {n}")
    dev = cv.device
    if out is None:
        out = tuple(torch.empty((n,), dtype=torch.int64, device=dev) for _ in range(3))
    for name, t in zip(("gv", "gf", "gp"), out):
        _need(t, name, torch.int64, (n,))
    if n_u is None:
        n_u = torch.empty((), dtype=torch.int64, device=dev)
    _need(n_u, "n_u", torch.int64, ())
    if scratch is None:
        scratch = GroupUniqueScratch(n, dev)
    if scratch.n != n:
        raise ValueError(f"group_unique: scratch for {scratch.n} lanes, got {n}")
    sc = scratch
    GROUP_UNIQUE.check(GROUP_UNIQUE.lib().launch_group_unique(
        cv.data_ptr(), cf.data_ptr(), cp.data_ptr(), n, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), n_u.data_ptr(), sc.keys.data_ptr(), sc.idx.data_ptr(),
        sc.counts.data_ptr(), sc.part.data_ptr(), sc.flags.data_ptr(), sc.bf.data_ptr(),
        sc.bp.data_ptr(), sc.tile.data_ptr(), _stream()))
    # gu_init, 8 passes of (hist, scan_local, scan_offsets, scatter) and
    # gu_heads; then the compaction's
    GROUP_UNIQUE.launches += int(n > 0) * (1 + 8 * 4 + 1) + compact_launches(n)
    return (n_u, *out)


# -- B14: the batched bucket core (csrc/bucket.cu) ------------------------------------


def _bucket_vec(t, what: str, C: int, dtype=torch.int64) -> int:
    _need(t, what, dtype, (C,))
    return t.data_ptr()


def bucket_refine(valid, mult, abort, fpv, crow, rc, fam_rs, mr, salt, done, gen, abort_c, *,
                  cnt=None, sub=0) -> None:
    """B14 ``_level_step``'s refinement of one chunk's dense-expand output
    [rows, K], in place: lanes of dead rows (past ``cnt - sub``, or of a
    done config), and Restart lanes of rows with ``rc >= mr[crow]``, turn
    invalid; ``fpv`` is salted with ``salt[crow]`` where valid and SENT
    elsewhere; ``gen[c]`` += the valid lanes' mult and ``abort_c[c]`` = 1
    where a live row of c aborts (i64 [C] accumulators)."""
    rows, K = valid.shape
    C = mr.shape[0]
    _need(valid, "valid", torch.bool, (rows, K))
    _need(mult, "mult", torch.int32, (rows, K))
    _need(abort, "abort", torch.bool, (rows,))
    _need(fpv, "fp_view", torch.int64, (rows, K))
    _need(crow, "crow", torch.int64, (rows,))
    _need(rc, "restart_count", torch.uint8, (rows,))
    _need(fam_rs, "fam_rs", torch.uint8, (K,))
    BUCKET_REFINE.check(BUCKET_REFINE.lib().bucket_refine_launch(
        valid.data_ptr(), mult.data_ptr(), abort.data_ptr(), fpv.data_ptr(), crow.data_ptr(),
        rc.data_ptr(), fam_rs.data_ptr(), _bucket_vec(mr, "mr", C, torch.int32),
        _bucket_vec(salt, "salt", C), _bucket_vec(done, "done", C), C, rows, K, _cnt(cnt), sub,
        _bucket_vec(gen, "gen", C), _bucket_vec(abort_c, "abort_c", C), _stream()))
    BUCKET_REFINE.launches += 1


def bucket_tally(fresh, pay, live, crow, K: int, done, abort_c, new_c, keep, ins=None,
                 n_ins=None, ring=None, ring_off=None) -> None:
    """B14 after K4, over the level's lanes (the first ``live`` count,
    an int64 0-d device word): ``new_c[c]`` += the fresh lanes of config c
    (``crow[pay // K]``), ``keep`` = fresh & !(done | abort)[config]; with
    a ``ring``, the inserted fingerprints ``ins[:n_ins]`` (the fresh
    compaction's prefix) go to ``ring[off:]`` (``ring_off`` a device word),
    dropped past its end."""
    n = fresh.shape[0]
    C = done.shape[0]
    _need(fresh, "fresh", torch.bool, (n,))
    _need(pay, "pay", torch.int64, (n,))
    _need(keep, "keep", torch.bool, (n,))
    _need(crow, "crow", torch.int64, (crow.shape[0],))
    R = 0
    if ring is not None:
        _need(ring, "ring", torch.int64, (ring.shape[0],))
        R = ring.shape[0]
    BUCKET_TALLY.check(BUCKET_TALLY.lib().bucket_tally_launch(
        fresh.data_ptr(), pay.data_ptr(), n, _cnt(live), crow.data_ptr(), K,
        _bucket_vec(done, "done", C), _bucket_vec(abort_c, "abort_c", C), C,
        _bucket_vec(new_c, "new_c", C), keep.data_ptr(), _p(ins), _cnt(n_ins), _p(ring), R,
        _cnt(ring_off), _stream()))
    BUCKET_TALLY.launches += 1


BC_BEGIN, BC_PRE, BC_POST, BC_LEVEL = 0, 1, 2, 3


def bucket_ctrl(phase: int, bs, lc, args, done, done1, depth, cap, gen_c, new_c, abort_c, meta,
                g_cap: int, crow_in, crow_out, pay, K: int) -> None:
    """B14 ``_superstep``'s control (csrc/bucket.cu ``bucket_ctrl``) in one
    of its phases: BEGIN, PRE, POST (the commit algebra and the gather
    crow_out = crow_in[pay // K] of the survivors) or LEVEL (the per-level
    program's undo decision and the same gather).  ``meta`` = (m_new,
    m_gen, m_abort [span, C], m_ins, m_ng [span])."""
    C = done.shape[0]
    m_new, m_gen, m_abort, m_ins, m_ng = meta
    span = m_ins.shape[0]
    for name, t in (("m_new", m_new), ("m_gen", m_gen), ("m_abort", m_abort)):
        _need(t, name, torch.int64, (span, C))
    _need(m_ng, "m_ng", torch.int64, (span,))
    _need(pay, "pay", torch.int64, (g_cap,))
    _need(crow_out, "crow_out", torch.int64, (crow_out.shape[0],))
    if crow_out.shape[0] < g_cap:
        raise ValueError("bucket_ctrl: crow_out shorter than g_cap")
    BUCKET_CTRL.check(BUCKET_CTRL.lib().bucket_ctrl_launch(
        phase, bs.data_ptr(), lc.data_ptr(), args.data_ptr(), _bucket_vec(done, "done", C),
        _bucket_vec(done1, "done1", C), _bucket_vec(depth, "depth", C),
        _bucket_vec(cap, "cap", C), _bucket_vec(gen_c, "gen_c", C),
        _bucket_vec(new_c, "new_c", C), _bucket_vec(abort_c, "abort_c", C), C, m_new.data_ptr(),
        m_gen.data_ptr(), m_abort.data_ptr(), m_ins.data_ptr(), m_ng.data_ptr(), g_cap,
        crow_in.data_ptr(), crow_out.data_ptr(), pay.data_ptr(), K, _stream()))
    BUCKET_CTRL.launches += 1


# -- B15's deep bodies (csrc/deep.cu) and the sorted sieve (csrc/sortstore.cu) -----------


def _n_arg(n, cap: int):
    """A live count given as an int (at most ``cap``) or as a 0-d int64
    CUDA tensor (read on the device): (device pointer or None, the host
    count, or ``cap`` for a device count)."""
    if isinstance(n, torch.Tensor):
        _need(n, "n", torch.int64, ())
        return n.data_ptr(), cap
    n = int(n)
    if not 0 <= n <= cap:
        raise ValueError(f"count {n} outside [0, {cap}]")
    return None, n


def pack_deltas(fps, n):
    """``pack_fp_deltas`` of the ascending prefix ``fps[:n]`` (``n`` an int
    or a 0-d int64 CUDA tensor): (stream u8[cap * 8], nibbles u8[cap // 2],
    total i64 0-d).  ``cap`` must be even."""
    cap = fps.shape[0]
    if cap % 2:
        raise ValueError(f"pack capacity must be even (nibble pairing), got {cap}")
    _need(fps, "fps", torch.int64, (cap,))
    n_dev, n_host = _n_arg(n, cap)
    dev = fps.device
    stream = torch.empty((cap * 8,), dtype=torch.uint8, device=dev)
    nib = torch.empty((cap // 2,), dtype=torch.uint8, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    lib = PACK_DELTAS.lib()
    tile = torch.empty((max(-(-cap // lib.pd_tile()), 1),), dtype=torch.int64, device=dev)
    PACK_DELTAS.check(lib.launch_pack_deltas(
        fps.data_ptr(), cap, n_dev, n_host, stream.data_ptr(), nib.data_ptr(),
        total.data_ptr(), tile.data_ptr(), _stream()))
    # pd_tiles, scan_offsets, pd_write (the stream's memset is no kernel)
    PACK_DELTAS.launches += 1 + 2 * int(cap > 0)
    return stream, nib, total


def deep_verdict(bits, gp, n_u, n_recv: int):
    """The owner's verdict bits (u8, bit i = unique i is new, LSB first)
    on its received lanes: win bool[n_recv] = bit i at lane ``gp[i]`` for
    ``i < n_u`` (an int or a 0-d int64 CUDA tensor), False elsewhere."""
    cap_u = gp.shape[0]
    _need(bits, "bits", torch.uint8, (bits.shape[0],))
    _need(gp, "gp", torch.int64, (cap_u,))
    n_dev, n_host = _n_arg(n_u, cap_u)
    win = torch.empty((n_recv,), dtype=torch.bool, device=gp.device)
    # a host count bounds the lanes read: it passes as their capacity
    DEEP_VERDICT.check(DEEP_VERDICT.lib().launch_deep_verdict(
        bits.data_ptr(), bits.shape[0], gp.data_ptr(), n_host, n_dev, n_recv, win.data_ptr(),
        _stream()))
    DEEP_VERDICT.launches += int(cap_u > 0)
    return win


def deep_repack(sources: list, segs):
    """Blocks of rows concatenated in order, field by field: ``sources`` is
    a list of equal-structure tuples of CUDA tensors (each field's rows on
    dim 0, the same trailing shape and dtype in every source), ``segs`` an
    int array [B, 3] of (source, first row, rows), one block a row, in
    output order.  Returns the tuple of concatenated fields."""
    if not sources:
        raise ValueError("deep_repack takes at least one source")
    F = len(sources[0])
    dev = sources[0][0].device
    for s in sources:
        if len(s) != F:
            raise ValueError("deep_repack: every source has the same fields")
        for f, (x, y) in enumerate(zip(s, sources[0])):
            _need(x, f"field {f}", y.dtype, (s[0].shape[0], *y.shape[1:]))
    segs = np.asarray(segs, np.int64).reshape(-1, 3)
    B = segs.shape[0]
    rows = np.asarray([s[0].shape[0] for s in sources], np.int64)
    if B == 0 or (segs[:, 0] < 0).any() or (segs[:, 0] >= len(sources)).any() or (
            segs[:, 1:] < 0).any() or (segs[:, 1] + segs[:, 2] > rows[segs[:, 0]]).any():
        raise ValueError("deep_repack: a block outside its source's rows")
    outs = tuple(torch.empty((int(segs[:, 2].sum()), *x.shape[1:]), dtype=x.dtype, device=dev)
                 for x in sources[0])
    widths = np.asarray([math.prod(x.shape[1:]) * x.element_size() for x in sources[0]],
                        np.int64)
    lib = DEEP_REPACK.lib()
    chunk = lib.rp_chunk()
    # each (block, field) pair's first chunk of the copy grid
    per_pair = (segs[:, 2:3] * widths[None, :] + chunk - 1) // chunk
    chunk0 = np.concatenate([[0], np.cumsum(per_pair.reshape(-1))])
    # one upload: the source pointers, the blocks, widths, outputs and chunks
    table = torch.from_numpy(np.concatenate([
        np.asarray([x.data_ptr() for s in sources for x in s], np.int64),
        segs[:, 0], segs[:, 1], segs[:, 2], widths,
        np.asarray([o.data_ptr() for o in outs], np.int64), chunk0])).to(dev)
    offs = torch.empty((B,), dtype=torch.int64, device=dev)
    n_out = torch.empty((), dtype=torch.int64, device=dev)
    DEEP_REPACK.check(lib.launch_deep_repack(
        table.data_ptr(), offs.data_ptr(), n_out.data_ptr(), len(sources), B, F,
        int(chunk0[-1]), _stream()))
    # scan_offsets, rp_copy
    DEEP_REPACK.launches += 1 + int(chunk0[-1] > 0)
    return outs


def sieve_merge(sieve, cv):
    """``_deep_sieve_merge_body``: (the first ``scap`` sorted unique
    non-SENT values of ``sieve`` (sorted) and ``cv`` (ascending where not
    SENT), SENT-padded to ``scap``; overflow bool 0-d: more were unique)."""
    S, n = sieve.shape[0], cv.shape[0]
    _need(sieve, "sieve", torch.int64, (S,))
    _need(cv, "cv", torch.int64, (n,))
    dev = sieve.device
    out = torch.empty((S,), dtype=torch.int64, device=dev)
    n_unique = torch.empty((), dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.int64, device=dev)
    flags = torch.empty((max(S + n, 1),), dtype=torch.uint8, device=dev)
    live = torch.empty((max(n, 1),), dtype=torch.int64, device=dev)
    merged = torch.empty((max(S + n, 1),), dtype=torch.int64, device=dev)
    tile = torch.zeros((compact_tiles(S + n),), dtype=torch.int64, device=dev)
    n_live = torch.empty((), dtype=torch.int64, device=dev)
    SIEVE_MERGE.check(SIEVE_MERGE.lib().launch_sieve_merge(
        sieve.data_ptr(), S, cv.data_ptr(), n, out.data_ptr(), n_unique.data_ptr(),
        ovf.data_ptr(), flags.data_ptr(), live.data_ptr(), merged.data_ptr(), tile.data_ptr(),
        n_live.data_ptr(), _stream()))
    # sm_live and the compaction; merge_sorted and sm_first; the compaction
    # into scap
    SIEVE_MERGE.launches += (int(n > 0) + compact_launches(n) + 2 * int(S + n > 0)
                             + compact_launches(S + n))
    return out, ovf > 0
