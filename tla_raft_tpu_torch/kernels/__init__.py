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
``torch.empty``; launches on ``torch.cuda.current_stream()``; raises if the
C entry point returns a CUDA error; and adds to its kernel's ``launches``
count the number of CUDA kernels it launched, where it launches them.
There is no fallback: the callers send CPU tensors to the plain twins and
CUDA tensors here.
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
            self._lib = lib
        return self._lib

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self.lib().error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({rc})")


GUARDS = Kernel(
    "guards", "csrc/guards.cu",
    "tla_raft_tpu/ops/mxu_expand.py:398 (MXUExpand.guards + _guard_features:342, "
    "dense_expand.py:184 msg_guard_parts)",
    {"launch_guards": [VP, VP, I32, VP, I32, VP, VP, VP, VP, VP]},
)
MATERIALIZE = Kernel(
    "materialize", "csrc/materialize.cu",
    "tla_raft_tpu/ops/mxu_expand.py:416 (MXUExpand.materialize_added, "
    "+ engine/bfs.py:861 _ids_insert)",
    {"launch_materialize": [VP, VP, I32, I64, VP, VP, I64, VP, I32, VP, VP, VP, VP, VP, VP]},
)
FINGERPRINT = Kernel(
    "fingerprint", "csrc/fingerprint.cu",
    "tla_raft_tpu/ops/fingerprint.py:517 (Fingerprinter.state_fingerprints: "
    "features:102, _plane_matmul:398, msg_hash:418, finalize:505)",
    {"launch_fingerprints": [VP, VP, I32, I64, VP, VP, I32, I32, I32, VP, VP, VP, VP]},
)
HASHSTORE = Kernel(
    "hashstore", "csrc/hashstore.cu",
    "tla_raft_tpu/ops/hashstore.py:270 (probe_and_insert_impl: _probe_rounds:160, "
    "_claim_loop:226)",
    {
        "hs_probe_first": [VP, I64, VP, I64, VP, VP, VP, VP, VP],
        "hs_round": [VP, I64, VP, I64, VP, VP, VP, VP, VP],
        "hs_represent": [VP, VP, I64, VP, VP, VP, VP, VP, VP, VP],
        "hs_undo": [VP, I64, VP, VP, VP],
    },
)
COMPACT = Kernel(
    "compact", "csrc/compact.cu",
    "tla_raft_tpu/engine/bfs.py:287 (_compact_payloads) and "
    "tla_raft_tpu/ops/hashstore.py:351 (compact_fresh)",
    {"launch_compact": [VP, I64, VP, VP, I64, I64, I64, VP, VP, VP, VP, VP, VP],
     "compact_tile": []},
)
INFLATE = Kernel(
    "inflate", "csrc/msgset.cu",
    "tla_raft_tpu/engine/bfs.py:833 (_ids_to_msgs, under _inflate:894)",
    {"launch_inflate": [VP, I32, I64, I32, VP, VP]},
)
DEFLATE = Kernel(
    "deflate", "csrc/msgset.cu",
    "tla_raft_tpu/engine/bfs.py:847 (_msgs_to_ids, under _deflate:899)",
    {"launch_deflate": [VP, I32, I32, I64, I32, VP, VP, VP]},
)
INV_SCAN = Kernel(
    "inv_scan", "csrc/invariants.cu",
    "tla_raft_tpu/engine/bfs.py:1794 (_inv_scan_impl over "
    "tla_raft_tpu/engine/invariants.py:21-149)",
    {"launch_inv_scan": [VP, VP, I32, I64, VP, VP, I32, VP, I64, I32, VP, VP]},
)
KERNELS = {k.name: k for k in (GUARDS, MATERIALIZE, FINGERPRINT, HASHSTORE, COMPACT, INFLATE,
                               DEFLATE, INV_SCAN)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


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
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
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


def _field_shapes(cfg) -> dict:
    S, L, V = cfg.S, cfg.L, cfg.V
    return dict(
        voted_for=(S,), current_term=(S,), role=(S,), log_term=(S, L), log_val=(S, L),
        log_len=(S,), match_index=(S, S), next_index=(S, S), commit_index=(S,),
        election_count=(), restart_count=(), pending=(S, S), val_sent=(V,),
    )


def dims_array(cfg, uni):
    """The C ``Dims`` struct of common.cuh, as a ctypes int array."""
    vals = [
        cfg.S, cfg.T, cfg.L, cfg.V, uni.n_entry, uni.ap_npli, uni.ap_pli_min,
        uni.vq_off, uni.vp_off, uni.aq_off, uni.ap_off, uni.M, uni.n_words,
        cfg.majority, cfg.median_index, cfg.max_election, cfg.max_restart,
        int("double-vote" in cfg.mutations), int("legacy-append" in cfg.mutations),
        int("become-follower" in cfg.mutations),
    ]
    return (I32 * len(vals))(*vals)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_cfg(cfg, uni) -> None:
    if not 2 <= cfg.S <= 8 or uni.M >= (1 << 15):
        raise ValueError(f"the CUDA kernels take 2 <= S <= 8 and M < 2^15: {cfg.describe()}")


# -- wrappers --------------------------------------------------------------------


def guards(mx, st):
    """K1: (valid bool[B,K], mult i32[B,K], abort bool[B]) of a RaftState."""
    cfg, uni = mx.cfg, mx.uni
    _check_cfg(cfg, uni)
    B, K = st.msgs.shape[0], mx.K
    core = _core_ptrs(st, B, _field_shapes(cfg))
    _need(st.msgs, "msgs", torch.int32, (B, uni.n_words))
    _need(mx.slot_table, "slot_table", torch.int32, (K, 6))
    dev = st.msgs.device
    valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    mult = torch.empty((B, K), dtype=torch.int32, device=dev)
    abort = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = GUARDS.lib()
    GUARDS.check(lib.launch_guards(
        core, st.msgs.data_ptr(), B, mx.slot_table.data_ptr(), K, dims_array(cfg, uni),
        valid.data_ptr(), mult.data_ptr(), abort.data_ptr(), _stream(),
    ))
    GUARDS.launches += int(B > 0)
    return valid, mult, abort


def materialize(mx, fr, pidx, slots):
    """K2: (child Frontier [G], added i32[G, A], overflow bool[G])."""
    from ..models.raft import Frontier, _CORE_FIELDS

    cfg, uni = mx.cfg, mx.uni
    _check_cfg(cfg, uni)
    N, G, K, A = fr.msg_ids.shape[0], pidx.shape[0], mx.K, mx.A
    if N == 0:
        raise ValueError("materialize: empty parent frontier")
    shapes = _field_shapes(cfg)
    core = _core_ptrs(fr, N, shapes)
    cap_m = fr.msg_ids.shape[1]
    _need(fr.msg_ids, "msg_ids", torch.int16, (N, cap_m))
    _need(pidx, "pidx", torch.int64, (G,))
    _need(slots, "slots", torch.int64, (G,))
    dev = pidx.device
    out = {f: torch.empty((G, *shapes[f]), dtype=torch.uint8, device=dev) for f in _CORE_FIELDS}
    out_ptrs = (VP * len(_CORE_FIELDS))(*(out[f].data_ptr() for f in _CORE_FIELDS))
    added = torch.empty((G, A), dtype=torch.int32, device=dev)
    child_ids = torch.empty((G, cap_m), dtype=torch.int16, device=dev)
    ovf = torch.empty((G,), dtype=torch.bool, device=dev)
    lib = MATERIALIZE.lib()
    MATERIALIZE.check(lib.launch_materialize(
        core, fr.msg_ids.data_ptr(), cap_m, N, pidx.data_ptr(), slots.data_ptr(), G,
        mx.slot_table.data_ptr(), K, dims_array(cfg, uni), out_ptrs, added.data_ptr(),
        child_ids.data_ptr(), ovf.data_ptr(), _stream(),
    ))
    MATERIALIZE.launches += int(G > 0)
    return Frontier(msg_ids=child_ids, **out), added, ovf


def fingerprints(fpr, fr):
    """K3: (fp_view i64[G], fp_full i64[G]) of a Frontier batch."""
    cfg, uni = fpr.cfg, fpr.uni
    _check_cfg(cfg, uni)
    G = fr.msg_ids.shape[0]
    core = _core_ptrs(fr, G, _field_shapes(cfg))
    cap_m = fr.msg_ids.shape[1]
    _need(fr.msg_ids, "msg_ids", torch.int16, (G, cap_m))
    F, ncols = fpr.C_planes.shape
    _need(fpr.C_planes, "C_planes", torch.int8, (F, ncols))
    _need(fpr.G_planes, "G_planes", torch.int8, (uni.M, ncols))
    if fpr.C_planes.device != fr.msg_ids.device:
        raise ValueError("fingerprints: tables and states on different devices")
    dev = fr.msg_ids.device
    fpv = torch.empty((G,), dtype=torch.int64, device=dev)
    fpf = torch.empty((G,), dtype=torch.int64, device=dev)
    lib = FINGERPRINT.lib()
    FINGERPRINT.check(lib.launch_fingerprints(
        core, fr.msg_ids.data_ptr(), cap_m, G, fpr.C_planes.data_ptr(),
        fpr.G_planes.data_ptr(), F, ncols, fpr.P, dims_array(cfg, uni),
        fpv.data_ptr(), fpf.data_ptr(), _stream(),
    ))
    FINGERPRINT.launches += int(G > 0)
    return fpv, fpf


_SCRATCH: dict = {}  # (device, cap) -> the representative's scratch minima


def _rep_scratch(dev, cap: int):
    """The two slab-sized minima of the representative pass, filled once
    per slab size; every call leaves them empty again (``rep_reset``)."""
    key = (str(dev), cap)
    if key not in _SCRATCH:
        _SCRATCH.clear()  # the slab grew: the old size is not used again
        _SCRATCH[key] = (torch.full((cap,), -1, dtype=torch.int64, device=dev),
                         torch.full((cap,), 1 << 62, dtype=torch.int64, device=dev))
    return _SCRATCH[key]


def probe_and_insert(slab, fps, keys, pays):
    """K4: (slab, fresh bool[N], n_new i64 0-d, overflow bool 0-d).

    Inserts into ``slab`` in place and returns it.  On a probe-depth
    overflow the slots this call claimed are emptied again, so ``slab`` is
    as it was and the caller can grow it and redo the batch."""
    cap = slab.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"slab capacity must be a power of two, got {cap}")
    n = fps.shape[0]
    _need(slab, "slab", torch.int64, (cap,))
    for name, t in (("fps", fps), ("keys", keys), ("pays", pays)):
        _need(t, name, torch.int64, (n,))
    dev = slab.device
    lib = HASHSTORE.lib()
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    tgt = torch.empty((n,), dtype=torch.int64, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    fresh = torch.empty((n,), dtype=torch.bool, device=dev)
    ctr = torch.zeros((3,), dtype=torch.int64, device=dev)
    if n == 0:
        return slab, fresh, ctr[2].clone(), ctr[1] > 0
    m1, m2 = _rep_scratch(dev, cap)
    st = _stream()
    HASHSTORE.check(lib.hs_probe_first(
        slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
        flags.data_ptr(), ctr.data_ptr(), st,
    ))
    HASHSTORE.launches += 1
    while True:
        claiming, overflow = ctr[:2].tolist()
        if not claiming:
            break
        HASHSTORE.check(lib.hs_round(  # one more round: claim, then verify_probe
            slab.data_ptr(), cap, fps.data_ptr(), n, slot.data_ptr(), tgt.data_ptr(),
            flags.data_ptr(), ctr.data_ptr(), st,
        ))
        HASHSTORE.launches += 2
    HASHSTORE.check(lib.hs_represent(  # rep_key, rep_pay, rep_fresh, rep_reset
        keys.data_ptr(), pays.data_ptr(), n, slot.data_ptr(), flags.data_ptr(),
        m1.data_ptr(), m2.data_ptr(), fresh.data_ptr(), ctr.data_ptr(), st,
    ))
    HASHSTORE.launches += 4
    if overflow:
        HASHSTORE.check(lib.hs_undo(slab.data_ptr(), n, slot.data_ptr(), flags.data_ptr(), st))
        HASHSTORE.launches += 1
    return slab, fresh, ctr[2].clone(), ctr[1] > 0


def compact(flags, va, pad_a, cap, vb=None, pad_b=0, want_lane=False):
    """Order-keeping compaction of the flagged lanes' values to ``cap``
    lanes: (out_a i64[cap] (pad_a past the kept prefix), out_b or None,
    lane bool[cap] or None, total i64 0-d = the number of flagged lanes)."""
    n = flags.shape[0]
    _need(flags, "flags", torch.bool, (n,))
    _need(va, "va", torch.int64, (n,))
    if vb is not None:
        _need(vb, "vb", torch.int64, (n,))
    dev = flags.device
    lib = COMPACT.lib()
    tile_n = lib.compact_tile()
    n_tiles = (n + tile_n - 1) // tile_n
    oa = torch.empty((cap,), dtype=torch.int64, device=dev)
    ob = torch.empty((cap,), dtype=torch.int64, device=dev) if vb is not None else None
    lane = torch.empty((cap,), dtype=torch.bool, device=dev) if want_lane else None
    tile = torch.empty((max(n_tiles, 1),), dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    COMPACT.check(lib.launch_compact(
        flags.data_ptr(), n, va.data_ptr(), ptr(vb), pad_a, pad_b, cap, oa.data_ptr(), ptr(ob),
        ptr(lane), tile.data_ptr(), total.data_ptr(), _stream(),
    ))
    # count_tiles and scatter_tiles per tile pass, scan_offsets, pad_tail
    COMPACT.launches += 2 * int(n_tiles > 0) + 1 + int(cap > 0)
    return oa, ob, lane, total


def inflate(ids, n_words: int):
    """Sparse ids int16[n, cap_m] (-1 padded) -> packed int32 words [n, n_words]."""
    n, cap_m = ids.shape
    _need(ids, "msg_ids", torch.int16, (n, cap_m))
    msgs = torch.empty((n, n_words), dtype=torch.int32, device=ids.device)
    lib = INFLATE.lib()
    INFLATE.check(lib.launch_inflate(ids.data_ptr(), cap_m, n, n_words, msgs.data_ptr(),
                                     _stream()))
    INFLATE.launches += int(n > 0)
    return msgs


def deflate(msgs, M: int, cap_m: int):
    """Packed words int32[n, n_words] -> (ascending -1-padded ids
    int16[n, cap_m], overflow bool[n])."""
    n, n_words = msgs.shape
    if M >= (1 << 15) or n_words * 32 < M:
        raise ValueError(f"deflate takes M < 2^15 ids in n_words * 32 >= M bits, got M={M}")
    _need(msgs, "msgs", torch.int32, (n, n_words))
    ids = torch.empty((n, cap_m), dtype=torch.int16, device=msgs.device)
    ovf = torch.empty((n,), dtype=torch.bool, device=msgs.device)
    lib = DEFLATE.lib()
    DEFLATE.check(lib.launch_deflate(msgs.data_ptr(), n_words, M, n, cap_m, ids.data_ptr(),
                                     ovf.data_ptr(), _stream()))
    DEFLATE.launches += int(n > 0)
    return ids, ovf


INV_CODES = {
    "Inv": 0, "LeaderHasAllCommittedEntries": 0, "RaftCanCommt": 1, "FollowerCanCommit": 2,
    "CommitAll": 3, "NoSplitVote": 4, "NoAllCommit": 5, "ExistLeaderAndCandidate": 6,
}


def inv_scan(cfg, uni, fr, names, offset: int = 0, into=None):
    """First row (+ ``offset``) of a Frontier that violates one of the
    invariants ``names`` (``~Name`` negates), or -1: an int64 0-d tensor.
    With ``into`` (an earlier result) the smaller bad row of the two is
    kept, in ``into`` itself."""
    _check_cfg(cfg, uni)
    names = list(names)
    if not 1 <= len(names) <= 8:
        raise ValueError(f"inv_scan takes 1 to 8 invariants, got {len(names)}")
    n = fr.msg_ids.shape[0]
    core = _core_ptrs(fr, n, _field_shapes(cfg))
    cap_m = fr.msg_ids.shape[1]
    _need(fr.msg_ids, "msg_ids", torch.int16, (n, cap_m))
    codes = (I32 * len(names))(*(INV_CODES[nm.lstrip("~")] for nm in names))
    neg = (I32 * len(names))(*(int(nm.startswith("~")) for nm in names))
    if into is None:
        out = torch.empty((), dtype=torch.int64, device=fr.msg_ids.device)
    else:
        _need(into, "into", torch.int64, ())
        out = into
    lib = INV_SCAN.lib()
    INV_SCAN.check(lib.launch_inv_scan(
        core, fr.msg_ids.data_ptr(), cap_m, n, codes, neg, len(names), dims_array(cfg, uni),
        offset, int(into is None), out.data_ptr(), _stream(),
    ))
    INV_SCAN.launches += int(n > 0)
    return out
