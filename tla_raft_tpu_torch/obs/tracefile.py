"""Chrome trace-event export: the run timeline, Perfetto-loadable (the
port's copy of ``tla_raft_tpu/obs/tracefile.py``).

Converts an ``events.jsonl`` stream (obs/telemetry.py) into the Chrome
trace-event JSON format — load the output in https://ui.perfetto.dev
(or ``chrome://tracing``) to SEE superstep launch amortization and
the expand/fetch/checkpoint overlap the async pipeline buys; with a
``--profile`` capture beside the stream, the profiler's host and device
lanes (the kernels by name) merge in on the same clock.

Track layout (one pid, one tid per track):

=====  ==================  ==========================================
tid    track               events
=====  ==================  ==========================================
1      levels              one ``X`` slice per committed level
                           (boundary-to-boundary wall time)
2      superstep windows   ``B``/``E`` pairs per resident dispatch
                           window
3      device dispatch     instants, one per graph launch or staged
                           launch group (tag)
4      fetch window        ``X`` slices, one per counted device read
                           (the measured wait)
5      checkpoint I/O      ``X`` slices, one per atomic commit
6      compile             ``X`` slices, one per CUDA-graph capture
7      grow/redo           instants (named budget)
8      watchdog/audit      instants (arm/trip, audit, retire,
                           integrity)
9      tiered store        ``X`` slices per demotion and per warm/cold
                           generation probe (spill-overlap readout)
=====  ==================  ==========================================

Timestamps are microseconds on the hub's monotonic clock, so every
``ts`` is non-negative and non-decreasing per track, and every ``B``
has a matching ``E`` (a window left open by a crash is closed at the
stream's last timestamp).  Host-only: stdlib only.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

from .telemetry import read_events

PID = 1
TRACKS = {
    1: "levels",
    2: "superstep windows",
    3: "device dispatch",
    4: "fetch window",
    5: "checkpoint I/O",
    6: "compile",
    7: "grow/redo",
    8: "watchdog/audit",
    9: "tiered store",
    10: "device cost",
    11: "lock contention",
}


def _us(t: float) -> int:
    return max(0, int(round(float(t) * 1e6)))


def to_chrome_trace(events: list[dict]) -> dict:
    """Event stream -> Chrome trace-event JSON document."""
    out: list[dict] = []
    for tid, name in TRACKS.items():
        out.append(dict(
            ph="M", pid=PID, tid=tid, name="thread_name",
            args=dict(name=name),
        ))

    def ev(ph, tid, name, t, dur=None, args=None):
        e = dict(ph=ph, pid=PID, tid=tid, name=str(name), ts=_us(t),
                 cat="tla-raft")
        if dur is not None:
            e["dur"] = max(0, int(round(dur * 1e6)))
        if args:
            e["args"] = args
        out.append(e)

    boundary = 0.0
    open_window = None
    last_t = 0.0
    for doc in events:
        t = float(doc.get("t", 0.0))
        last_t = max(last_t, t)
        kind = doc.get("ev")
        if kind == "run_begin":
            boundary = t
            ev("i", 1, "run_begin", t, args={
                k: v for k, v in doc.items() if k not in ("t", "ev")
            })
        elif kind == "run_end":
            ev("i", 1, "run_end", t, args={
                k: v for k, v in doc.items() if k not in ("t", "ev")
            })
        elif kind == "level_commit":
            ev("X", 1, f"level {doc.get('level')}", boundary,
               dur=t - boundary,
               args=dict(n_new=doc.get("n_new"),
                         distinct=doc.get("distinct"),
                         generated=doc.get("generated")))
            boundary = t
        elif kind == "superstep_begin":
            if open_window is not None:
                # a begin with no commit (stopped window re-entered):
                # close the dangling B so pairs stay matched
                ev("E", 2, "superstep", t)
            ev("B", 2, "superstep", t)
            open_window = t
        elif kind == "superstep_commit":
            if open_window is None:
                ev("B", 2, "superstep", t)
            ev("E", 2, "superstep", t,
               args=dict(levels=doc.get("levels")))
            open_window = None
        elif kind == "dispatch":
            ev("i", 3, doc.get("tag", "dispatch"), t)
        elif kind == "fetch":
            s = float(doc.get("s") or 0.0)
            ev("X", 4, "fetch", t - s, dur=s,
               args=dict(bytes=doc.get("b")))
        elif kind == "lock_wait":
            # GRAFT_TSAN contention: the slice spans the blocked
            # acquire (t is the acquisition instant)
            s = float(doc.get("wait_s") or 0.0)
            ev("X", 11, f"wait {doc.get('name')}", t - s, dur=s,
               args=dict(name=doc.get("name")))
        elif kind == "checkpoint":
            s = float(doc.get("s") or 0.0)
            ev("X", 5, f"commit {doc.get('kind')}", t - s, dur=s,
               args=dict(name=doc.get("name"), bytes=doc.get("b")))
        elif kind == "compile":
            s = float(doc.get("s") or 0.0)
            ev("X", 6,
               "prewarm compile" if doc.get("declared") else "compile",
               t - s, dur=s)
        elif kind in ("grow", "redo"):
            ev("i", 7, f"{kind} {doc.get('budget')}", t)
        elif kind == "watchdog_arm":
            ev("i", 8, "watchdog arm", t,
               args=dict(ctx=doc.get("ctx"), budget=doc.get("budget")))
        elif kind == "watchdog_trip":
            ev("i", 8, f"WATCHDOG TRIP ({doc.get('stage')})", t,
               args=dict(ctx=doc.get("ctx")))
        elif kind == "tier_demote":
            s = float(doc.get("s") or 0.0)
            ev("X", 9, f"demote gen {doc.get('gen')}", t - s, dur=s,
               args=dict(level=doc.get("level"), n=doc.get("n"),
                         cold=doc.get("cold")))
        elif kind == "tier_probe":
            s = float(doc.get("s") or 0.0)
            ev("X", 9, "gen probe", t - s, dur=s,
               args=dict(level=doc.get("level"),
                         lanes=doc.get("lanes"),
                         hits=doc.get("hits")))
        elif kind in ("program_profile", "buffer", "hbm_budget",
                      "pre_oom_forecast", "profile_begin",
                      "profile_end"):
            name = {
                "program_profile":
                    f"profile {doc.get('tag')}",
                "buffer": f"buffer {doc.get('name')}",
                "hbm_budget": "hbm budget",
                "pre_oom_forecast":
                    f"PRE-OOM FORECAST (level {doc.get('level')})",
                "profile_begin": "profiler start",
                "profile_end": "profiler stop",
            }[kind]
            ev("i", 10, name, t, args={
                k: v for k, v in doc.items() if k not in ("t", "ev")
            })
        elif kind in ("audit", "retire", "integrity", "shape",
                      "exchange", "skew"):
            ev("i", 8, kind, t, args={
                k: v for k, v in doc.items() if k not in ("t", "ev")
            })
    if open_window is not None:
        ev("E", 2, "superstep", last_t)
    return dict(
        traceEvents=out,
        displayTimeUnit="ms",
        otherData=dict(source="tla_raft_tpu_torch.obs"),
    )


# device lanes from --profile captures merge in as separate processes
# starting at this pid (host lanes stay at PID=1)
DEVICE_PID_BASE = 100

_MERGE_PHASES = {"X", "M", "i", "I", "B", "E", "C"}


def _profile_dirs(events: list[dict], run_dir: str | None) -> list[str]:
    """Capture dirs named by profile_begin events, plus the run dir's
    conventional ``profile/`` (covers a relocated run dir whose events
    recorded the original path)."""
    dirs: list[str] = []
    for ev in events:
        if ev.get("ev") == "profile_begin" and ev.get("dir"):
            dirs.append(str(ev["dir"]))
    if run_dir:
        dirs.append(os.path.join(run_dir, "profile"))
    out, seen = [], set()
    for d in dirs:
        if not os.path.isdir(d):
            continue
        # dedup by resolved path: the profile_begin event records the
        # original (possibly relative) dir and the run-dir convention
        # adds another spelling of the same directory
        real = os.path.realpath(d)
        if real not in seen:
            seen.add(real)
            out.append(d)
    return out


def _load_trace(path: str):
    """One exported profiler trace (``.json`` or ``.json.gz``), or None
    when it is missing or torn."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8", errors="replace") as fh:
            return json.load(fh)
    except (OSError, ValueError, EOFError):
        return None


def _anchor_ts(evs: list, anchor: str | None) -> float | None:
    """The profiler-clock timestamp of the capture's anchor marker (the
    ``record_function`` range devprof opens right after the profiler
    starts), else of its earliest event."""
    first = None
    for e in evs:
        if not isinstance(e, dict) or e.get("ph") == "M":
            continue
        try:
            ts = float(e.get("ts"))
        except (TypeError, ValueError):
            continue
        if anchor and e.get("name") == anchor:
            return ts
        first = ts if first is None else min(first, ts)
    return first


# device-lane merge budget: past it the SHORTEST slices are dropped
# first — the timeline keeps the compute that matters and the drop is
# reported, never silent
MAX_DEVICE_EVENTS = 250_000


def merge_device_lanes(doc: dict, events: list[dict],
                       run_dir: str | None = None,
                       max_events: int = MAX_DEVICE_EVENTS
                       ) -> tuple[int, int]:
    """Merge ``--profile`` captures into the host timeline.

    A capture is the Chrome trace ``torch.profiler`` exports (its host
    operators and, on the card, its kernels, memcpys and runtime calls).
    Its ``profile_begin`` event carries the trace file's name, the hub
    timestamp ``t`` of the profiler's start and the name of the anchor
    marker recorded at that instant, so shifting every profiler event by
    ``t - anchor.ts`` lands the lanes on the hub's clock: graph launch
    instant -> kernels -> read wait on one timeline.  The profiler's
    processes are re-pinned to pids >= ``DEVICE_PID_BASE`` (the host
    tracks keep PID 1) and their names prefixed ``device:``; each event
    keeps its profiler category in ``args.cat`` (``kernel`` for a CUDA
    kernel).  Missing or torn captures merge nothing — the host trace
    stays valid.  Returns ``(merged, dropped)`` profiler-event counts.
    """
    out = doc["traceEvents"]
    pid_map: dict = {}
    meta: list[dict] = []
    slices: list[dict] = []
    begins = {
        os.path.basename(str(ev.get("file"))): ev
        for ev in events
        if ev.get("ev") == "profile_begin" and ev.get("file")
    }
    default_t = min(
        (float(ev.get("t") or 0.0) for ev in begins.values()), default=0.0
    )
    merged: set = set()
    for d in _profile_dirs(events, run_dir):
        for path in sorted(glob.glob(os.path.join(d, "*.json"))
                           + glob.glob(os.path.join(d, "*.json.gz"))):
            if os.path.basename(path) in merged:
                continue  # the same capture under the run dir's other spelling
            merged.add(os.path.basename(path))
            dev = _load_trace(path)
            if dev is None:
                continue  # torn capture: keep the host trace valid
            evs = (
                dev.get("traceEvents", [])
                if isinstance(dev, dict) else dev
            )
            if not isinstance(evs, list):
                continue
            begin = begins.get(os.path.basename(path), {})
            t = float(begin.get("t") or default_t)
            a = _anchor_ts(evs, begin.get("anchor"))
            off_us = t * 1e6 - (a if a is not None else 0.0)
            for e in evs:
                if not isinstance(e, dict):
                    continue
                ph, pid = e.get("ph"), e.get("pid")
                if ph not in _MERGE_PHASES or pid is None:
                    continue
                key = (path, pid)
                if key not in pid_map:
                    pid_map[key] = DEVICE_PID_BASE + len(pid_map)
                args = e.get("args") if isinstance(e.get("args"), dict) else {}
                e2 = dict(e, pid=pid_map[key], cat="device",
                          args=dict(args, cat=e.get("cat")))
                if ph == "M":
                    if e.get("name") == "process_name":
                        e2["args"] = dict(
                            args, name=f"device: {args.get('name')}",
                        )
                    meta.append(e2)
                    continue
                try:
                    ts = float(e.get("ts") or 0.0)
                except (TypeError, ValueError):
                    continue
                e2["ts"] = max(0.0, ts + off_us)
                if ph in ("B", "E"):
                    # B/E pairs are never droppable: losing one side
                    # of a pair breaks the nesting the merged trace
                    # guarantees (they ride with the metadata)
                    meta.append(e2)
                else:
                    slices.append(e2)
    dropped = 0
    if max_events and len(slices) > max_events:
        # keep the longest slices (instants/counters sort as dur 0 but
        # are few); the drop is REPORTED by the caller, never silent
        slices.sort(key=lambda e: -float(e.get("dur") or 0.0))
        dropped = len(slices) - max_events
        slices = slices[:max_events]
    out.extend(meta)
    out.extend(slices)
    return len(meta) + len(slices), dropped


def export(events_path: str, out_path: str,
           run_dir: str | None = None,
           max_device_events: int = MAX_DEVICE_EVENTS) -> dict:
    """events.jsonl -> Chrome trace JSON file; returns small stats.

    ``run_dir`` (when given) also merges any ``--profile`` capture found
    beside the stream into the same timeline."""
    events, dropped = read_events(events_path)
    doc = to_chrome_trace(events)
    device_events, device_dropped = merge_device_lanes(
        doc, events, run_dir, max_events=max_device_events
    )
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return dict(
        events=len(events), dropped=dropped,
        trace_events=len(doc["traceEvents"]),
        device_events=device_events,
        device_dropped=device_dropped, out=out_path,
    )
