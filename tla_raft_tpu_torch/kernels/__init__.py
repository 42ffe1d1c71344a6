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
(``Tally``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


class Kernel:
    """One kernel library: its source, what it replaces, its C entry
    points (name -> argtypes) and its launch count on the main path."""

    def __init__(self, name: str, source: str, replaces: str, entries: dict):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entries = entries
        self.launches = 0
        self._lib = None

    @property
    def stem(self) -> str:
        return Path(self.source).stem

    def lib(self):
        if self._lib is None:
            path = build_all()[self.stem]
            lib = ctypes.CDLL(str(path))
            for fn, args in self.entries.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = I32
            lib.error_string.argtypes = [I32]
            lib.error_string.restype = ctypes.c_char_p
            lib.lib_warm.restype = I32
            self._lib = lib
            self.check(lib.lib_warm())
        return self._lib

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self.lib().error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({rc})")


GUARDS = Kernel(
    "guards", "csrc/guards.cu",
    "tla_raft_tpu/ops/mxu_expand.py:398 (MXUExpand.guards + _guard_features:342, "
    "dense_expand.py:184 msg_guard_parts)",
    {"launch_guards": [VP, VP, I32, VP, I32, VP, VP, VP, VP, VP, I64, VP, VP, I64, VP]},
)
MATERIALIZE = Kernel(
    "materialize", "csrc/materialize.cu",
    "tla_raft_tpu/ops/mxu_expand.py:416 (MXUExpand.materialize_added, "
    "+ engine/bfs.py:861 _ids_insert)",
    {"launch_materialize": [VP, VP, I32, I32, I64, VP, VP, I64, VP, I32, VP, VP, VP, VP, VP,
                            VP, I64, VP, I64, VP, VP]},
)
_K3_ARGS = [VP, VP, I32, I32, I64, VP, I32, I32, I32, VP, VP, I32, VP, VP, VP, VP, VP, I64, VP, VP,
            VP]
# K3, every launch but the indexed mode's (any symmetry group: P = 6, 120,
# 5,040 at S = 3, 5, 7)
FINGERPRINT = Kernel(
    "fingerprint", "csrc/fingerprint.cu",
    "tla_raft_tpu/ops/fingerprint.py:517 (Fingerprinter.state_fingerprints: "
    "features:102, _plane_matmul:398, msg_hash:418, finalize:505)",
    {"launch_fingerprints": _K3_ARGS},
)
# K3's launches whose message part is the pair-block factored hash (S = 7),
# the indexed mode's included
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
HASHSTORE = Kernel(
    "hashstore", "csrc/hashstore.cu",
    "tla_raft_tpu/ops/hashstore.py:270 (probe_and_insert_impl: _probe_rounds:160, "
    "_claim_loop:226)",
    {
        "hs_probe_first": [VP, I64, VP, I64, VP, VP, VP, VP, VP, VP, VP],
        "hs_round": [VP, I64, VP, I64, VP, VP, VP, VP, VP],
        "hs_rounds_dev": [VP, I64, VP, I64, VP, VP, VP, VP, VP, VP, VP, I32, VP],
        "hs_represent": [VP, VP, I64, VP, VP, VP, VP, VP, VP, VP, VP],
        "hs_undo": [VP, I64, VP, VP, VP, VP, VP],
    },
)
COMPACT = Kernel(
    "compact", "csrc/compact.cu",
    "tla_raft_tpu/engine/bfs.py:287 (_compact_payloads) and "
    "tla_raft_tpu/ops/hashstore.py:351 (compact_fresh)",
    {"launch_compact": [VP, I64, VP, VP, I64, I64, I64, VP, VP, VP, VP, VP, VP, I64, I64, I64,
                        VP],
     "compact_tile": []},
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
        "lv_group_begin_launch": [VP, I64, I32, I64, VP],
        "lv_group_end_launch": [VP, VP, I32, I64, I64, VP],
        "lv_tail_gate_launch": [VP, I64, VP],
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
    {"sieve_probe_launch": [VP, I64, VP, I64, VP, VP, VP]},
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
     "compact_tile": []},
)
DROP_ROWS = Kernel(
    "drop_rows", "csrc/tiered.cu",
    "tla_raft_tpu/store/tiered.py:810 (drop_rows_impl)",
    {"drop_rows_launch": [VP, I64, VP, VP, VP, I32, VP, VP, VP, VP], "drop_rows_tile": []},
)
KERNELS = {k.name: k for k in (GUARDS, MATERIALIZE, FINGERPRINT, HASHSTORE, COMPACT, INFLATE,
                               DEFLATE, INV_SCAN, LEVEL, SUPERSTEP, SIEVE, HS_PROBE,
                               FILTER_COMPACT, DROP_ROWS, MSG_FACTORED, ORBIT, ORBIT_FOLD)}
# the kernels the staged chain launches below the grouping limit
STAGED = ("guards", "materialize", "fingerprint", "hashstore", "compact", "inflate", "deflate",
          "inv_scan")
# the kernels of the fused level and the supersteps
FUSED = STAGED + ("level", "superstep", "sieve")
# the grouped level's own (levels past 16 * G chunks)
GROUPED = ("hs_probe", "filter_compact")
# K3's factored message part (where the folded table passes 64 MiB: S = 7)
SCALE = ("msg_hash_factored",)
# orbit pruning (TLA_RAFT_ORBIT=1): the canonical relabel and the tied fold
ORBIT_PATH = ("orbit", "orbit_fold")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS.values()}


class Tally:
    """The launches of one captured CUDA graph.  ``take`` (after the
    capture) moves the launches the wrappers counted while capturing out
    of the counts — a capture launches nothing — and ``replay`` adds them
    back once per replay, when the graph launches them."""

    def __init__(self):
        self.before = launch_counts()
        self.per_replay: dict = {}

    def take(self) -> None:
        after = launch_counts()
        self.per_replay = {k: after[k] - self.before[k] for k in after}
        for k, v in self.before.items():
            KERNELS[k].launches = v

    def replay(self) -> None:
        for k, v in self.per_replay.items():
            KERNELS[k].launches += v


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
    """K1: (valid bool[B,K], mult i32[B,K], abort bool[B]) of a RaftState.

    Counted form (the fused level): ``valid`` given, ``per_row=False``
    (no per-row mult/abort), rows past the device count ``cnt - sub``
    dead; each live row's mult adds into ``mult_acc`` i64[K] and its
    abort (+ ``base``) minimizes into ``abort_acc`` (int64 0-d)."""
    cfg, uni = mx.cfg, mx.uni
    _check_cfg(cfg, uni)
    B, K = st.msgs.shape[0], mx.K
    core = _core_ptrs(st, B, _field_shapes(cfg))
    _need(st.msgs, "msgs", torch.int32, (B, uni.n_words))
    _need(mx.slot_table, "slot_table", torch.int32, (K, 6))
    dev = st.msgs.device
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
        core, st.msgs.data_ptr(), B, mx.slot_table.data_ptr(), K, dims_array(cfg, uni),
        valid.data_ptr(), _p(mult), _p(abort), _cnt(cnt), sub, _p(mult_acc), _p(abort_acc), base,
        _stream(),
    ))
    GUARDS.launches += int(B > 0)
    return valid, mult, abort


def materialize(mx, fr, pidx, slots, *, pay=None, pay_base=0, out=None, cnt=None, sub=0,
                ovf_any=None):
    """K2: (child Frontier [G], added i32[G, A], overflow bool[G]).

    Lanes are (``pidx``, ``slots``), or payloads ``pay`` =
    (parent + ``pay_base``) * K + slot.  ``out`` = (Frontier, added, ovf)
    to write into; lanes past the device count ``cnt - sub`` are dead, and
    ``ovf_any`` (int64 0-d) is set to 1 when a live lane overflows."""
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
    lib = MATERIALIZE.lib()
    MATERIALIZE.check(lib.launch_materialize(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, N, _p(pidx if pay is None else None),
        _p(slots if pay is None else None), G, mx.slot_table.data_ptr(), K,
        dims_array(cfg, uni), out_ptrs, added.data_ptr(), child.msg_ids.data_ptr(),
        ovf.data_ptr(), _p(pay), pay_base, _cnt(cnt), sub, _p(ovf_any), _stream(),
    ))
    MATERIALIZE.launches += int(G > 0)
    return child, added, ovf


def _msg_table(fpr, uni):
    """K3's message-part table (``fpr.ktab``), checked: (eff, pperm or None,
    the type layout off[4], stride[4], row_base[4] as a ctypes array)."""
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


def fingerprints(fpr, fr, *, out=None, cnt=None, sub=0, idx=None, ovf=None):
    """K3: (fp_view i64[N], fp_full i64[N]) of a Frontier batch of N rows,
    from the Fingerprinter's kernel tables (``fpr.ktab``); lanes past the
    device count ``cnt - sub`` get SENT.  Launches with the factored
    message hash also count as ``msg_hash_factored``.

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
    eff, pperm, tdims = _msg_table(fpr, uni)
    tab = fpr.ktab
    lib = FINGERPRINT.lib()
    FINGERPRINT.check(lib.launch_fingerprints(
        core, fr.msg_ids.data_ptr(), id_bytes, cap_m, G, tab["ct"].data_ptr(), tab["f_pad"],
        fpr.spec.F, fpr.P, eff.data_ptr(), _p(pperm), fpr.NP, tdims, dims_array(cfg, uni),
        fpv.data_ptr(), fpf.data_ptr(), _cnt(cnt), sub, _p(idx), _p(ovf), _stream(),
    ))
    (ORBIT_FOLD if idx is not None else FINGERPRINT).launches += int(G > 0)
    if fpr.factored_msgs:
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


_SCRATCH: dict = {}  # (device, cap) -> the representative's scratch minima
K4_ROUNDS: list = []  # the claim rounds of every host-driven K4 call


def rep_scratch(dev, cap: int):
    """The two slab-sized minima of the representative pass, filled once
    per slab size; every call leaves them empty again (``rep_reset``).
    The fused level takes them before its capture."""
    key = (str(dev), cap)
    if key not in _SCRATCH:
        _SCRATCH.clear()  # the slab grew: the old size is not used again
        _SCRATCH[key] = (torch.full((cap,), -1, dtype=torch.int64, device=dev),
                         torch.full((cap,), 1 << 62, dtype=torch.int64, device=dev))
    return _SCRATCH[key]


def _hs_check(slab, fps, keys, pays):
    cap = slab.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"slab capacity must be a power of two, got {cap}")
    n = fps.shape[0]
    _need(slab, "slab", torch.int64, (cap,))
    for name, t in (("fps", fps), ("keys", keys), ("pays", pays)):
        _need(t, name, torch.int64, (n,))
    return cap, n


def probe_and_insert(slab, fps, keys, pays):
    """K4: (slab, fresh bool[N], n_new i64 0-d, overflow bool 0-d).

    Inserts into ``slab`` in place and returns it.  On a probe-depth
    overflow the slots this call claimed are emptied again, so ``slab`` is
    as it was and the caller can grow it and redo the batch.  The claim
    rounds run until none claims, with one host read a round."""
    from ..device import fetch

    cap, n = _hs_check(slab, fps, keys, pays)
    dev = slab.device
    lib = HASHSTORE.lib()
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    tgt = torch.empty((n,), dtype=torch.int64, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    fresh = torch.empty((n,), dtype=torch.bool, device=dev)
    ctr = torch.zeros((3,), dtype=torch.int64, device=dev)
    if n == 0:
        return slab, fresh, ctr[2].clone(), ctr[1] > 0
    m1, m2 = rep_scratch(dev, cap)
    st = _stream()
    HASHSTORE.check(lib.hs_probe_first(
        slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
        flags.data_ptr(), ctr[0].data_ptr(), ctr[1].data_ptr(), None, st,
    ))
    HASHSTORE.launches += 1
    rounds = 0
    while True:
        claiming, overflow = (int(x) for x in fetch(ctr[:2], what="k4_round")[0])
        if not claiming:
            break
        rounds += 1
        HASHSTORE.check(lib.hs_round(  # one more round: claim, then verify_probe
            slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
            flags.data_ptr(), ctr.data_ptr(), st,
        ))
        HASHSTORE.launches += 2
    K4_ROUNDS.append(rounds)
    HASHSTORE.check(lib.hs_represent(  # rep_key, rep_pay, rep_fresh, rep_reset
        keys.data_ptr(), pays.data_ptr(), n, slot.data_ptr(), flags.data_ptr(),
        m1.data_ptr(), m2.data_ptr(), fresh.data_ptr(), ctr[2].data_ptr(), None, st,
    ))
    HASHSTORE.launches += 4
    if overflow:
        HASHSTORE.check(lib.hs_undo(slab.data_ptr(), n, slot.data_ptr(), flags.data_ptr(), None,
                                    None, st))
        HASHSTORE.launches += 1
    return slab, fresh, ctr[2].clone(), ctr[1] > 0


def probe_and_insert_dev(slab, fps, keys, pays, lc, scratch, budget: int):
    """K4 with no host read (the fused level): the live lanes are the first
    ``lc[LC_LIVE_LANES]``; ``budget`` claim rounds, each exiting at once
    when no lane claims; the control words get the overflow, the rounds
    that ran, the rounds overflow and K4's fresh count.  ``scratch`` =
    (slot i64[N], tgt i64[N], flags u8[N], fresh bool[N], m1, m2)."""
    from ..engine import megakernel as mk

    cap, n = _hs_check(slab, fps, keys, pays)
    slot, tgt, flags, fresh, m1, m2 = scratch
    _need(lc, "lc", torch.int64, (mk.LC_LEN,))
    lib = HASHSTORE.lib()
    st = _stream()
    cnt = lc[mk.LC_LIVE_LANES].data_ptr()

    def w(i):
        return lc[i].data_ptr()

    HASHSTORE.check(lib.hs_probe_first(
        slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
        flags.data_ptr(), w(mk.LC_W0), w(mk.LC_OVF_SLAB), cnt, st,
    ))
    HASHSTORE.check(lib.hs_rounds_dev(
        slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
        flags.data_ptr(), w(mk.LC_W0), w(mk.LC_OVF_SLAB), w(mk.LC_ROUNDS),
        w(mk.LC_OVF_ROUNDS), int(budget), st,
    ))
    HASHSTORE.check(lib.hs_represent(
        keys.data_ptr(), pays.data_ptr(), n, slot.data_ptr(), flags.data_ptr(),
        m1.data_ptr(), m2.data_ptr(), fresh.data_ptr(), w(mk.LC_K4_NEW), cnt, st,
    ))
    HASHSTORE.launches += 1 + 2 * int(budget) + 1 + 4
    return fresh


def undo_dev(slab, scratch, live, cond):
    """K4's undo, gated on the device flag ``cond`` (int64 0-d), over the
    first ``live`` (int64 0-d) lanes of the last ``probe_and_insert_dev``."""
    slot, _tgt, flags, *_ = scratch
    n = slot.shape[0]
    lib = HASHSTORE.lib()
    HASHSTORE.check(lib.hs_undo(slab.data_ptr(), n, slot.data_ptr(), flags.data_ptr(),
                                _cnt(live), _cnt(cond), _stream()))
    HASHSTORE.launches += int(n > 0)


def compact(flags, va, pad_a, cap, vb=None, pad_b=0, want_lane=False, *, out_a=None,
            out_b=None, total=None, cnt=None, sub=0, mul=1, iota_base=0, tile=None):
    """Order-keeping compaction of the flagged lanes' values to ``cap``
    lanes: (out_a i64[cap] (pad_a past the kept prefix), out_b or None,
    lane bool[cap] or None, total i64 0-d = the number of flagged lanes).
    ``va`` None means the values are ``iota_base + lane``; with ``cnt``
    only the first ``(cnt - sub) * mul`` flag lanes count."""
    n = flags.shape[0]
    _need(flags, "flags", torch.bool, (n,))
    if va is not None:
        _need(va, "va", torch.int64, (n,))
    if vb is not None:
        _need(vb, "vb", torch.int64, (n,))
    dev = flags.device
    lib = COMPACT.lib()
    tile_n = lib.compact_tile()
    n_tiles = (n + tile_n - 1) // tile_n
    oa = torch.empty((cap,), dtype=torch.int64, device=dev) if out_a is None else out_a
    ob = out_b
    if vb is not None and ob is None:
        ob = torch.empty((cap,), dtype=torch.int64, device=dev)
    _need(oa, "out_a", torch.int64, (cap,))
    if ob is not None:
        _need(ob, "out_b", torch.int64, (cap,))
    lane = torch.empty((cap,), dtype=torch.bool, device=dev) if want_lane else None
    if tile is None:
        tile = torch.empty((max(n_tiles, 1),), dtype=torch.int64, device=dev)
    if total is None:
        total = torch.empty((), dtype=torch.int64, device=dev)
    _need(total, "total", torch.int64, ())
    if tile.numel() < max(n_tiles, 1):
        raise ValueError("compact: tile scratch too small")
    COMPACT.check(lib.launch_compact(
        flags.data_ptr(), n, _p(va), _p(vb), pad_a, pad_b, cap, oa.data_ptr(), _p(ob),
        _p(lane), tile.data_ptr(), total.data_ptr(), _cnt(cnt), sub, mul, iota_base, _stream(),
    ))
    # count_tiles and scatter_tiles per tile pass, scan_offsets, pad_tail
    COMPACT.launches += 2 * int(n_tiles > 0) + 1 + int(cap > 0)
    return oa, ob, lane, total


def compact_tiles(n: int) -> int:
    """Scratch words ``compact`` needs for ``n`` flag lanes."""
    t = COMPACT.lib().compact_tile()
    return max((n + t - 1) // t, 1)


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


def inv_scan(cfg, uni, fr, names, offset: int = 0, into=None, *, cnt=None, sub=0):
    """First row (+ ``offset``) of a Frontier that violates one of the
    invariants ``names`` (``~Name`` negates), or -1: an int64 0-d tensor.
    With ``into`` (an earlier result) the smaller bad row of the two is
    kept, in ``into`` itself; rows past the device count ``cnt - sub`` are
    not scanned."""
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
    slot u16 (int32 / int16 bit patterns) from their payloads."""
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


def sieve_probe(words, fps, *, hit=None, count=None) -> None:
    """Blocked-bloom probe of every lane of ``fps``: ``hit`` bool[n] per
    lane and/or ``count`` (int64 0-d) += the live lanes that hit."""
    m, n = words.shape[0], fps.shape[0]
    _need(words, "words", torch.int64, (m,))
    _need(fps, "fps", torch.int64, (n,))
    if hit is not None:
        _need(hit, "hit", torch.bool, (n,))
    SIEVE.check(SIEVE.lib().sieve_probe_launch(words.data_ptr(), m, fps.data_ptr(), n, _p(hit),
                                               _cnt(count), _stream()))
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
    n_tiles = max((n + lib.compact_tile() - 1) // lib.compact_tile(), 1)
    if tile is None:
        tile = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    if tile.numel() < n_tiles:
        raise ValueError("filter_compact: tile scratch too small")
    if total is None:
        total = torch.empty((), dtype=torch.int64, device=dev)
    _need(total, "total", torch.int64, ())
    FILTER_COMPACT.check(lib.launch_filter_compact(
        keep.data_ptr(), n, cv.data_ptr(), cf.data_ptr(), cp.data_ptr(), cap, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), tile.data_ptr(), total.data_ptr(), _p(out_off),
        _p(pay_off), _p(ovf), _stream()))
    # count_tiles, scan_offsets, scatter_tiles, pad_tail
    FILTER_COMPACT.launches += 2 * int(n > 0) + 1 + int(cap > 0)
    return (*out, total)


def group_begin(lc, rows: int, K: int, cap_g: int) -> None:
    """The group's live rows, payload base and lane offset, from the group
    index in ``lc`` (``LC_GROUP``)."""
    LEVEL.check(LEVEL.lib().lv_group_begin_launch(lc.data_ptr(), rows, K, cap_g, _stream()))
    LEVEL.launches += 1


def group_end(lc, chunk_total, cap_x: int, rows: int) -> None:
    """OVF_X from the group's chunk totals, its abort into the level's, and
    the group index advanced."""
    _need(chunk_total, "chunk_total", torch.int64, (chunk_total.shape[0],))
    LEVEL.check(LEVEL.lib().lv_group_end_launch(lc.data_ptr(), chunk_total.data_ptr(),
                                                chunk_total.shape[0], cap_x, rows, _stream()))
    LEVEL.launches += 1


def tail_gate(lc, lanes: int) -> None:
    """LIVE_LANES of the grouped level's probe-and-insert: ``lanes``, or 0
    when the level aborted or overflowed cap_x, cap_m or cap_g."""
    LEVEL.check(LEVEL.lib().lv_tail_gate_launch(lc.data_ptr(), lanes, _stream()))
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
