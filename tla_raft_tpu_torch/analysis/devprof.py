"""The ``--profile N`` profiler window (the port's copy of the capture half
of ``tla_raft_tpu/analysis/devprof.py``, on ``torch.profiler``).

A :class:`ProfilerCapture` opens a ``torch.profiler`` session (CPU
activities, and CUDA ones on the card: the kernels, memcpys and runtime
calls CUPTI reports, the kernels of replayed CUDA graphs among them),
counts ``N`` dispatch windows and then stops, exporting the session's
Chrome trace to ``<run_dir>/profile/``.  A dispatch window is one
completed device read (``device.fetch_complete`` calls
:func:`profile_tick`): a superstep on the default path, a fused level,
a launch group elsewhere.  ``python -m tla_raft_tpu_torch.obs trace``
merges the trace beside the host lanes of ``events.jsonl``.

Clock alignment: right after the profiler starts, the capture records a
``record_function`` range named :data:`ANCHOR` and publishes
``profile_begin`` inside it, so the event's hub timestamp and the range's
profiler timestamp are the same instant (obs/tracefile.py shifts the
trace by their difference).

torch is imported when a capture starts, never at module import.
"""

from __future__ import annotations

import os

from ..obs import telemetry as _obs

PROFILE_DIRNAME = "profile"
ANCHOR = "tla_raft::profile_begin"

_PROFILER: "ProfilerCapture | None" = None


def install_profiler(p: "ProfilerCapture | None") -> None:
    global _PROFILER
    _PROFILER = p


def current_profiler() -> "ProfilerCapture | None":
    return _PROFILER


def profile_tick() -> None:
    """One dispatch window completed (called from the one device-read
    completion site): advance the capture, stopping it after its budgeted
    windows.  No-op unless a capture is live."""
    p = _PROFILER
    if p is not None:
        p.tick()


class ProfilerCapture:
    """One ``--profile N`` capture session.

    ``start()`` opens the profiler (CUDA activities when ``cuda``), every
    :func:`profile_tick` counts one dispatch window, and after ``windows``
    ticks ``stop()`` exports the trace to ``trace_dir`` and publishes
    ``profile_end``.  ``stop`` is idempotent; a profiler that fails to
    start or stop sets ``failed`` and ``error`` and never takes the run
    down (the caller reports it)."""

    def __init__(self, run_dir: str, windows: int = 1, cuda: bool = False):
        self.trace_dir = os.path.join(run_dir, PROFILE_DIRNAME)
        self.windows = max(1, int(windows))
        self.cuda = bool(cuda)
        self.done = 0
        self.running = False
        self.failed = False
        self.error: str | None = None
        self.path: str | None = None
        self._prof = None

    def _next_path(self) -> str:
        n = 0
        while True:
            p = os.path.join(self.trace_dir, f"torch_trace.{n}.json")
            if not os.path.exists(p):
                return p
            n += 1

    def start(self) -> bool:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            self.path = self._next_path()
            self._prof = profile(activities=acts)
            self._prof.start()
        except Exception as e:  # noqa: BLE001 - a profiler that cannot start is reported
            self.failed, self.error = True, f"{type(e).__name__}: {e}"
            return False
        self.running = True
        with record_function(ANCHOR):
            _obs.profile_begin(self.trace_dir, self.windows, file=self.path, anchor=ANCHOR,
                               cuda=self.cuda)
        return True

    def tick(self) -> None:
        if not self.running:
            return
        self.done += 1
        if self.done >= self.windows:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(self.path)
        except Exception as e:  # noqa: BLE001 - stop mirrors start's report-only contract
            self.failed, self.error = True, f"{type(e).__name__}: {e}"
            return
        finally:
            self._prof = None
        _obs.profile_end(self.trace_dir, self.done)
