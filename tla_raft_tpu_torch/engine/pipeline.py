"""The async pipeline: bounded windows of device-to-host reads, and the
forecast prewarm's capture thread (the reference's engine/pipeline.py).

* :class:`AsyncFetchWindow` — a bounded in-flight window of read groups.
  ``submit`` starts a group's device-to-host copies into pinned buffers on
  the current stream and records a CUDA event behind them
  (``device.fetch_start``); the group completes (``event.synchronize()``,
  then ``consume`` on the calling thread) once more than ``window`` groups
  are in flight, or at ``drain`` (the level barrier: a store insert never
  runs with a group in flight; ``AsyncFetchWindow.live`` counts every
  instance's open groups, the tests' hook).  The window starts no thread:
  the overlap is the copy engine's, so all launches stay on the thread
  that submits.  ``window=0`` completes every group at its submit: the
  serial chain.  On the CPU a group's copies are made at submit (there is
  nothing to overlap); its ``consume`` still waits for the window.

* :class:`Prewarmer` — one daemon thread that runs ``(key, thunk)`` pairs
  in order, each key once.  The engine's thunks build a program of a
  forecast shape and capture its CUDA graph (engine/megakernel.py), so the
  main thread finds it captured when its level arrives.  A failed thunk is
  printed and counted, never raised: the main thread then captures the
  same kernels in line.

``TLA_RAFT_PIPELINE=0`` turns the windows off (every read serial);
``TLA_RAFT_PIPELINE_WINDOW`` sets the window (default 2).  Counts, traces
and checkpoint bytes are the same with any window.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
from collections import deque

from ..device import fetch_complete, fetch_start
from ..resilience import faults

# two groups in flight: one streams over the host link while the next one's
# kernels run; deeper windows only pin more host and device buffers
DEFAULT_WINDOW = 2


def enabled_by_env() -> bool:
    """The pipeline's default: on; ``TLA_RAFT_PIPELINE=0`` is the serial chain."""
    return os.environ.get("TLA_RAFT_PIPELINE", "1") != "0"


def window_from_env(default: int = DEFAULT_WINDOW) -> int:
    """``TLA_RAFT_PIPELINE_WINDOW``, else ``default`` (the port has no
    tuner registry yet: ROADMAP A.8)."""
    v = os.environ.get("TLA_RAFT_PIPELINE_WINDOW")
    return int(v) if v else int(default)


class AsyncFetchWindow:
    """Bounded in-flight window of read groups.

    ``submit(tensors, consume, what=)`` starts one group's copies; once
    more than ``window`` groups are in flight the oldest completes and
    ``consume(host_arrays)`` runs on the calling thread.  A group's host
    arrays are views of one of ``window + 1`` rotating sets of pinned
    buffers (``what`` plus the set's index), valid until that set comes
    round again: ``consume`` copies what it keeps.  Each group counts one
    read in ``device.READS[what]``."""

    live = 0  # open groups across every instance (the level-barrier hook)

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = max(0, int(window))
        self._q: deque = deque()
        self._slot = 0
        self.submitted = 0
        self.max_inflight = 0

    @property
    def inflight(self) -> int:
        return len(self._q)

    def submit(self, tensors, consume, what: str = "window") -> None:
        faults.fire("pipeline.window")
        slot = f"{what}#{self._slot}"
        self._slot = (self._slot + 1) % (self.window + 1)
        self._q.append((fetch_start(*tensors, what=what, slot=slot), consume))
        AsyncFetchWindow.live += 1
        self.submitted += 1
        self.max_inflight = max(self.max_inflight, len(self._q))
        while len(self._q) > self.window:
            self._complete_one(True)

    def _complete_one(self, run_consume: bool) -> None:
        pending, consume = self._q.popleft()
        AsyncFetchWindow.live -= 1
        host = fetch_complete(pending)
        if run_consume:
            consume(host)

    def drain(self) -> None:
        """Complete every open group in order (the level barrier)."""
        while self._q:
            self._complete_one(True)

    def discard(self) -> None:
        """Complete every open group's copies without consuming them (the
        abort and redo paths)."""
        while self._q:
            self._complete_one(False)


class DeferredFetch:
    """One read, started now and completed by ``get`` (the level tails):
    ``enabled=False`` completes it at once, the serial chain."""

    def __init__(self, enabled: bool, tensors, what: str = "read"):
        self._win = AsyncFetchWindow(1 if enabled else 0)
        self._h: dict = {}
        self._win.submit(tensors, lambda h: self._h.update(h=h), what=what)

    def get(self) -> list:
        self._win.drain()
        return self._h["h"]

    def discard(self) -> None:
        self._win.discard()


class Prewarmer:
    """One daemon thread running ``(key, thunk)`` pairs in submit order;
    keys dedupe across submissions (the engine re-plans every level as
    its forecast sharpens, and only new shapes queue).  A thunk that
    raises is printed and counted in ``n_failed``; the run goes on."""

    def __init__(self, name: str = "tla-raft-prewarm"):
        self._name = name
        self._lock = threading.Lock()
        self._seen: set = set()
        self._pending: list = []
        self._thread: threading.Thread | None = None
        self._running = False  # the worker loop is live (set and cleared under _lock)
        self._stopping = False
        self.n_ok = 0
        self.n_failed = 0
        self.failures: list = []  # (key, "Type: message") of each failed thunk
        # a daemon thread inside a capture at interpreter exit would touch a
        # dying runtime: exit drops the queue and waits out the one in flight
        atexit.register(self.shutdown)

    def submit(self, plan) -> int:
        """Queue the pairs of keys not seen before; returns how many."""
        with self._lock:
            fresh = [(k, t) for k, t in plan if k not in self._seen]
            self._seen.update(k for k, _t in fresh)
            self._pending.extend(fresh)
            if self._pending and not self._running and not self._stopping:
                self._running = True
                self._thread = threading.Thread(target=self._run, name=self._name, daemon=True)
                self._thread.start()
        return len(fresh)

    def retain(self, keys) -> int:
        """Drop the queued pairs whose key is not in ``keys`` (the newest
        plan no longer expects them; a later plan may queue them again);
        returns how many were dropped."""
        keys = set(keys)
        with self._lock:
            drop = [k for k, _t in self._pending if k not in keys]
            self._pending = [(k, t) for k, t in self._pending if k in keys]
            self._seen.difference_update(drop)
        return len(drop)

    def forget(self, key) -> None:
        """Let a later ``submit`` queue ``key`` again (its thunk gave way)."""
        with self._lock:
            self._seen.discard(key)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping or not self._pending:
                    self._running = False
                    return
                key, thunk = self._pending.pop(0)
            try:
                thunk()
                self.n_ok += 1
            except Exception as e:  # noqa: BLE001 - a failed prewarm is captured in line
                self.n_failed += 1
                self.failures.append((key, f"{type(e).__name__}: {e}"))
                print(f"[pipeline] prewarm {key!r} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def stopped(self) -> bool:
        """True once ``shutdown`` ran: a stopped prewarmer runs nothing more."""
        with self._lock:
            return self._stopping

    def join(self, timeout: float | None = None) -> None:
        """Wait for the queue to empty (tests and the run's end)."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    def shutdown(self, timeout: float = 120.0) -> None:
        """Drop the queued thunks and wait out the one running.  Idempotent."""
        with self._lock:
            self._stopping = True
            self._pending.clear()
        self.join(timeout)
        atexit.unregister(self.shutdown)
