"""The native external-memory fingerprint store, bound through ctypes.

The port's copy of ``tla_raft_tpu/native/__init__.py``'s ``build_native``
(:25) and ``HostFPStore`` (:100) over its own copy of ``fpstore.cpp``:
the same C interface, the same ctypes signatures (``_load``, :71) and the
same on-disk run format.  The store is the visited set of the
``--fpstore-dir`` route (engine/bfs.py ``TorchChecker._expand_level_host``):
sorted runs on disk, each with an in-memory bloom, over a sorted buffer of
``mem_budget_entries`` fingerprints in RAM (0: the native 64 MiB default).

The library is built with ``g++ -O2 -std=c++17 -shared -fPIC`` at first
use, into ``build/native/<digest of the source>/libfpstore.so`` under the
repo root (never next to the source); a failed build raises with g++'s
output.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fpstore.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def build_native(force: bool = False) -> str:
    """Compile fpstore.cpp into ``build/native/<digest>/libfpstore.so``
    (the digest covers the source and the flags) and return its path; an
    existing build of the same digest is reused unless ``force``.  Raises
    ``RuntimeError`` with g++'s output when the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libfpstore.so"
    if so.exists() and not force:
        return str(so)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libfpstore.{os.getpid()}.tmp.so"
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return str(so)


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        lib.fpstore_open.restype = ctypes.c_void_p
        lib.fpstore_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.fpstore_count.restype = ctypes.c_uint64
        lib.fpstore_count.argtypes = [ctypes.c_void_p]
        lib.fpstore_num_runs.restype = ctypes.c_uint64
        lib.fpstore_num_runs.argtypes = [ctypes.c_void_p]
        lib.fpstore_bloom_skips.restype = ctypes.c_uint64
        lib.fpstore_bloom_skips.argtypes = [ctypes.c_void_p]
        lib.fpstore_contains.restype = None
        lib.fpstore_contains.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fpstore_insert.restype = ctypes.c_uint64
        lib.fpstore_insert.argtypes = lib.fpstore_contains.argtypes
        lib.fpstore_compact.restype = ctypes.c_int
        lib.fpstore_compact.argtypes = [ctypes.c_void_p]
        lib.fpstore_close.restype = None
        lib.fpstore_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class HostFPStore:
    """Sorted-run external-memory u64 set with batched insert/membership."""

    def __init__(self, dirpath: str, mem_budget_entries: int = 0):
        os.makedirs(dirpath, exist_ok=True)
        self._dir = dirpath
        self._budget = int(mem_budget_entries)
        self._lib = _load()
        self._h = self._lib.fpstore_open(dirpath.encode(), ctypes.c_uint64(self._budget))
        if not self._h:
            raise RuntimeError("fpstore_open failed")

    @property
    def mem_budget_entries(self) -> int:
        """The in-RAM buffer's entries before a spill (0: the native 64 MiB
        default, 8,388,608 entries)."""
        return self._budget

    def __len__(self) -> int:
        return int(self._lib.fpstore_count(self._h))

    @property
    def num_runs(self) -> int:
        return int(self._lib.fpstore_num_runs(self._h))

    @property
    def bloom_skips(self) -> int:
        """Run binary searches the per-run blooms avoided (built when a run
        is written, in memory only).  A bloom hit is no proof of membership:
        the filter only skips a run's search, it never decides a verdict."""
        return int(self._lib.fpstore_bloom_skips(self._h))

    @staticmethod
    def _ptrs(fps: np.ndarray):
        fps = np.ascontiguousarray(fps, np.uint64)
        out = np.zeros(len(fps), np.uint8)
        return (fps, out, fps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    def contains(self, fps: np.ndarray) -> np.ndarray:
        fps, out, p_in, p_out = self._ptrs(fps)
        self._lib.fpstore_contains(self._h, p_in, len(fps), p_out)
        return out.astype(bool)

    def insert(self, fps: np.ndarray) -> np.ndarray:
        """Insert a batch; returns the is-new mask (False: already seen,
        including a duplicate earlier in the same batch)."""
        fps, out, p_in, p_out = self._ptrs(fps)
        added = self._lib.fpstore_insert(self._h, p_in, len(fps), p_out)
        if added == 0xFFFFFFFFFFFFFFFF:
            raise IOError("fpstore spill failed")
        return out.astype(bool)

    def compact(self) -> None:
        if self._lib.fpstore_compact(self._h) != 0:
            raise IOError("fpstore compact failed")

    def clear(self) -> None:
        """Empty the store in place (a delta-log resume rebuilds it): a
        fresh native handle (closing unlinks this handle's run files), and
        every ``run_*.fp`` a crashed process left behind is removed."""
        self.close()
        for f in glob.glob(os.path.join(self._dir, "run_*.fp")):
            os.unlink(f)
        self._h = self._lib.fpstore_open(self._dir.encode(), ctypes.c_uint64(self._budget))
        if not self._h:
            raise RuntimeError("fpstore_open failed")

    def close(self) -> None:
        if self._h:
            self._lib.fpstore_close(self._h)
            self._h = None

    def __del__(self):
        # interpreter teardown may have unloaded ctypes' globals already
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.fpstore_close(h)
            self._h = None
