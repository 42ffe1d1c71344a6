"""Process-wide telemetry hub: the run flight recorder (the port's copy
of ``tla_raft_tpu/obs/telemetry.py``).

The level loop, the CUDA-graph programs, the device reads, the atomic
checkpoint writer and the tiered store publish typed, monotonic-timestamped
run events into one process-global hub (:func:`install` / :func:`current`).
The hub

* appends each event crash-tolerantly to ``events.jsonl`` in the run
  directory — tmp-free ``"a"``-mode appends of self-checking lines
  (each line carries a CRC of its own payload in ``"d"``), so a torn
  tail is detected and tolerated on read instead of poisoning the
  stream (:func:`read_events`), and a resumed run heals the tail
  before appending (:func:`_heal_tail`);
* aggregates the per-level accounting (level wall times, launches,
  read waits, grow/redo counts, checkpoint I/O, captures, superstep
  amortization) host-side, so ``check.py --json``'s ``telemetry``
  block reads ONE bookkeeping (:meth:`TelemetryHub.snapshot`).

Host-only: this module — the whole ``obs/`` package — imports neither
torch nor the device code, reads no tensor and launches nothing.  Every
field is a value the host already holds (a level's ``n_new`` from its
control read, capacities, buffer sizes).  Publishing is a plain function
call with a ``CURRENT is None`` fast path: with telemetry off every hook
is one global read and one branch, and with it on the run makes the same
launches and the same counted reads (``device.READS``).

The reference's taxonomy, mapped onto the port:

================  ======================================================
``run_begin``     config + engine flags, wall-clock anchor
``run_end``       verdict, distinct/generated/depth
``level_begin``   ``level`` (1-based), ``frontier`` rows entering it
                  (once a loop pass: a superstep window's first level)
``level_commit``  ``level``, ``n_new``, ``distinct``, ``generated``,
                  ``slab_cap`` (0 = no device hash slab); one a
                  committed level on every route, the levels of a
                  superstep window included
``superstep_begin/commit``  one superstep window (one graph launch
                  over up to ``span`` levels); ``levels`` committed
``dispatch``      one CUDA graph launch (``tag`` = the program's
                  ``kind``: level, superstep, group, host_group), or one
                  launch group of the staged chain (``staged.expand``,
                  ``staged.insert``, ``staged.dedup``, ``staged.mat``:
                  the launches that end in one counted read)
``fetch``         one wait in ``device.fetch_complete``: ``s`` seconds
                  waited, ``b`` bytes read
``compile``       one CUDA-graph capture: ``s`` its seconds,
                  ``declared`` true when the prewarm thread captured it
``program``       a program was built (its buffers allocated): ``kind``
                  and its static shapes
``checkpoint``    one atomic artifact commit: ``kind``, ``name``,
                  ``s``, ``b``
``grow``/``redo`` a named capacity budget grew / a level re-ran
                  (the reference's names: slab, slab_tier, cap_x,
                  cap_out, cap_m, cap_g, k4_rounds)
``audit``         one sampled-recomputation audit: ``rows``,
                  ``problems``
``integrity``     a conservation/audit fail-stop fired
``tier_demote``   one hot-slab generation demotion (tiered store):
                  ``level``, ``n`` fps, ``gen`` id, ``s``
``tier_probe``    one warm generation probe: ``level``, ``lanes``,
                  ``hits``, ``s`` wait (the spill-overlap metric)
``buffer``        one registered long-lived device buffer (``hslab``,
                  ``frontier``, ``ring``): ``name``, ``b`` bytes
``hbm_budget``    the run's device-memory budget (``--dev-bytes``)
``profile_begin``/``profile_end``  one ``--profile N`` torch.profiler
                  window (``dir`` holds its Chrome trace; the begin
                  event's ``t`` and the trace's ``anchor`` marker line
                  the two clocks up)
================  ======================================================

Kept with no caller in the port yet (A.8's analysis ledgers, the mesh and
the service): ``program_profile``, ``pre_oom_forecast``, ``lock_held``,
``lock_wait``, ``watchdog_arm``/``watchdog_trip``, ``retire``,
``worker``, ``exchange``, ``skew``, ``shape``, ``tier_compact``,
``sieve_refresh``, ``sieve_stop``, ``fseg_page``.

Rotation: the stream is capped at ``TLA_RAFT_TELEMETRY_BYTES``
(default 64 MiB, 0 = unbounded); past the cap the file rotates to
``events.1.jsonl`` (older generations shift up) at level/superstep
boundaries, and :func:`read_events` follows the chain oldest-first.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

# flush the append buffer every N events (level boundaries flush too);
# small enough that a SIGKILL loses at most a level's tail of events
FLUSH_EVERY = 64

EVENTS_NAME = "events.jsonl"

# rotation cap: a long tiered run would otherwise append unbounded
DEFAULT_MAX_BYTES = 64 << 20

CURRENT: "TelemetryHub | None" = None


def enabled_by_env() -> bool:
    """Telemetry default: ON; ``TLA_RAFT_TELEMETRY=0`` disables."""
    return os.environ.get("TLA_RAFT_TELEMETRY", "1") != "0"


def max_bytes_from_env() -> int:
    """Rotation byte budget (``TLA_RAFT_TELEMETRY_BYTES``; 0 = never
    rotate)."""
    v = os.environ.get("TLA_RAFT_TELEMETRY_BYTES")
    if v is None or v == "":
        return DEFAULT_MAX_BYTES
    return max(0, int(float(v)))


def rotated_paths(path: str) -> list[str]:
    """The sealed rotation chain of ``path``, OLDEST first
    (``events.N.jsonl`` ... ``events.1.jsonl``); empty when the stream
    never rotated."""
    base, ext = os.path.splitext(path)
    out: list[str] = []
    n = 1
    while os.path.exists(f"{base}.{n}{ext}"):
        out.append(f"{base}.{n}{ext}")
        n += 1
    return list(reversed(out))


def install(hub: "TelemetryHub | None") -> None:
    """Set the process-global hub (None = every hook is a no-op)."""
    global CURRENT
    CURRENT = hub


def current() -> "TelemetryHub | None":
    return CURRENT


def _clean(v):
    """JSON-safe field coercion (numpy scalars arrive from engines)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return item()
        except (TypeError, ValueError):
            pass
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _clean(x) for k, x in v.items()}
    return str(v)


def hbm_gauge(buffers: dict, program_temp: dict,
              budget: int = 0) -> dict:
    """The live device-memory gauge: registered long-lived buffers
    (slab, ring, frontier caps) + the worst profiled program's temp
    bytes.  Pure arithmetic — the one place the ``--json`` ``hbm``
    block and ``--progress`` compute occupancy, so the two can never
    disagree.  ``headroom_bytes`` is present only under a budget and
    may be negative (a transiently over-budget working set — the
    pre-OOM forecast's trigger condition)."""
    resident = int(sum(buffers.values()))
    temp_tag, temp_peak = None, 0
    for tag, b in program_temp.items():
        if b > temp_peak:
            temp_tag, temp_peak = tag, int(b)
    out = dict(
        buffers={k: int(v) for k, v in sorted(buffers.items())},
        resident_bytes=resident,
        temp_peak_bytes=temp_peak,
        temp_peak_program=temp_tag,
        working_set_bytes=resident + temp_peak,
    )
    if budget:
        out["budget_bytes"] = int(budget)
        out["headroom_bytes"] = int(budget) - resident - temp_peak
        out["used_frac"] = round(
            (resident + temp_peak) / budget, 4
        )
    return out


def _line_digest(core: str) -> str:
    return format(zlib.crc32(core.encode("utf-8")) & 0xFFFFFFFF, "08x")


def encode_event(ev: dict) -> str:
    """One self-checking JSONL line: payload + CRC of the payload."""
    core = json.dumps(ev, sort_keys=True, separators=(",", ":"))
    return json.dumps(
        dict(ev, d=_line_digest(core)),
        sort_keys=True, separators=(",", ":"),
    )


def decode_line(line: str) -> dict | None:
    """Parse + digest-check one line; None = torn/corrupt."""
    try:
        doc = json.loads(line)
    except ValueError:
        return None
    if not isinstance(doc, dict):
        return None
    d = doc.pop("d", None)
    core = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    if d != _line_digest(core):
        return None
    return doc


def _read_one(path: str) -> tuple[list[dict], int]:
    events: list[dict] = []
    dropped = 0
    try:
        with open(path, encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
    except (FileNotFoundError, OSError):
        return [], 0
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        doc = decode_line(line)
        if doc is None:
            dropped = sum(1 for x in lines[i:] if x.strip())
            break
        events.append(doc)
    return events, dropped


def read_events(path: str, follow_rotation: bool = True
                ) -> tuple[list[dict], int]:
    """Read an event stream, tolerating a torn tail.

    Returns ``(events, dropped)``: every digest-verified event up to
    the first bad line per file, and the count of lines dropped (0 on
    a clean stream).  Never raises on torn/corrupt content — a crashed
    writer's half-line is the EXPECTED failure mode.  A rotated stream
    (``events.N.jsonl`` siblings) is spliced back together oldest-
    first, so ``report``/``trace`` see the whole run.
    """
    events: list[dict] = []
    dropped = 0
    chain = rotated_paths(path) if follow_rotation else []
    for p in chain + [path]:
        ev, dr = _read_one(p)
        events.extend(ev)
        dropped += dr
    return events, dropped


def _heal_tail(path: str) -> int:
    """Truncate a torn tail so a resumed run appends after the last
    good, newline-terminated line (an unterminated tail is torn even
    if it happens to parse — appending after it would corrupt the next
    line).  Returns the number of lines dropped."""
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as fh:
        data = fh.read()
    keep = 0  # byte offset after the last good terminated line
    dropped = 0
    off, n = 0, len(data)
    while off < n:
        nl = data.find(b"\n", off)
        if nl < 0:
            if data[off:].strip():
                dropped += 1
            break
        raw = data[off:nl]
        if raw.strip() and decode_line(
            raw.decode("utf-8", "replace")
        ) is None:
            dropped += sum(
                1 for x in data[off:].split(b"\n") if x.strip()
            )
            break
        off = nl + 1
        keep = off
    if keep < n:
        with open(path, "r+b") as fh:
            fh.truncate(keep)
    return dropped


def _last_event_t(path: str, tail_bytes: int = 1 << 16) -> float | None:
    """Timestamp of the last verified event line (reads only the tail;
    None on an empty/unreadable stream)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - tail_bytes))
            chunk = fh.read()
    except OSError:
        return None
    for raw in reversed(chunk.split(b"\n")):
        if not raw.strip():
            continue
        doc = decode_line(raw.decode("utf-8", "replace"))
        if doc is not None:
            try:
                return float(doc.get("t", 0.0))
            except (TypeError, ValueError):
                return None
    return None


class TelemetryHub:
    """One run's flight recorder + host-side aggregate accounting.

    ``run_dir=None`` keeps the stream in memory only (the aggregates —
    the ``--json`` ``telemetry`` block — still work); with a run dir
    the stream appends to ``<run_dir>/events.jsonl``.  Usable as a
    context manager: installs itself as the process hub on enter,
    uninstalls + flushes on exit.
    """

    def __init__(self, run_dir: str | None = None,
                 path: str | None = None,
                 max_bytes: int | None = None):
        if path is None and run_dir is not None:
            path = os.path.join(run_dir, EVENTS_NAME)
        self.path = path
        self.max_bytes = (
            max_bytes_from_env() if max_bytes is None else max(0, max_bytes)
        )
        self.rotations = 0
        self._size = 0  # active file's byte size (approx, append-only)
        self.healed_lines = 0
        self._fh = None
        self._buf: list[str] = []
        # two locks: _lock guards the in-memory buffer + aggregates
        # (held only for list/dict ops — emit can never block on a
        # hung filesystem), _io_lock serializes the actual file writes
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._t0 = time.monotonic()
        # resumed stream: rebase this run's clock past the existing
        # stream's last timestamp so the spliced events.jsonl stays
        # monotonic and the exported trace never overlays the crashed
        # run with the resumed one.  Healing the torn tail happens NOW
        # (eagerly) so the rebase reads only verified lines.
        self._t_off = 0.0
        if path is not None and os.path.exists(path):
            self.healed_lines = _heal_tail(path)
            self._size = os.path.getsize(path)
            last = _last_event_t(path)
            if last is None:
                # active file healed to empty (crash right after a
                # rotation): the clock rebase reads the newest SEALED
                # generation so the spliced chain stays monotonic
                for p in reversed(rotated_paths(path)):
                    last = _last_event_t(p)
                    if last is not None:
                        break
            if last is not None:
                self._t_off = last + 1e-6
        elif path is not None:
            # fresh active file, but a rotated chain may survive from
            # a crashed predecessor — rebase past it
            for p in reversed(rotated_paths(path)):
                last = _last_event_t(p)
                if last is not None:
                    self._t_off = last + 1e-6
                    break
        self.n_events = 0
        # -- aggregates (the --json telemetry block) ----------------------
        self.levels = 0
        self.level_seconds: list[float] = []
        self.level_new: list[int] = []
        self.dispatches_per_level: list[int] = []
        self.fetches_per_level: list[int] = []
        self.dispatches = 0
        self.fetches = 0
        self.fetch_wait_s = 0.0
        self.fetch_bytes = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.prewarm_compiles = 0
        self.checkpoints = 0
        self.checkpoint_s = 0.0
        self.checkpoint_bytes = 0
        self.grows: dict[str, int] = {}
        self.redos = 0
        self.supersteps = 0
        self.superstep_levels = 0
        self.watchdog_armed = 0
        self.watchdog_trips = 0
        self.audit_levels = 0
        self.audit_rows = 0
        self.audit_problems = 0
        # graftsync lock profiler (analysis/tsan.py): per-lock
        # hold/wait aggregates published at disarm + threshold
        # contention events published at the blocking acquire
        self.locks: dict[str, dict] = {}
        self.lock_waits = 0
        self.lock_wait_s = 0.0
        self.retired = 0
        self.exchange_bytes = 0
        self.exchange_raw_bytes = 0
        self.integrity_failures = 0
        # tiered visited store (store/tiered.py): demotions + per-tier
        # probe accounting — probe-wait vs level wall is the
        # spill-overlap acceptance metric (docs/PERF.md)
        self.tier_demotions = 0
        self.tier_spilled = 0
        self.tier_probes = 0
        self.tier_probe_lanes = 0
        self.tier_probe_hits = 0
        self.tier_probe_wait_s = 0.0
        # device-cost ledgers (per-program cost/memory, no caller in the
        # port yet) + the live device-memory gauge assembled from the
        # registered long-lived buffers and the worst program temp
        self.programs_profiled = 0
        self.program_temp: dict[str, int] = {}  # tag -> max temp bytes
        self.program_flops: dict[str, float] = {}  # tag -> max flops
        self.hbm_buffers: dict[str, int] = {}  # name -> live bytes
        self.hbm_budget = 0
        self.pre_oom_forecasts = 0
        self.last_pre_oom: dict | None = None
        self.profile_windows = 0
        self.slab_cap = 0
        self.distinct = 0
        self._last_boundary = self._t_off
        self._lvl_dispatches = 0
        self._lvl_fetches = 0

    # -- lifecycle --------------------------------------------------------

    def __enter__(self):
        install(self)
        return self

    def __exit__(self, *exc):
        install(None)
        self.close()
        return False

    def _open(self):
        if self._fh is None and self.path is not None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # append-mode flight recorder: the torn-tail heal already
            # ran at construction, so this append lands cleanly
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def flush(self) -> None:
        if self.path is None:
            return
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        data = "".join(buf)
        with self._io_lock:
            fh = self._open()
            fh.write(data)
            fh.flush()
            self._size += len(data)

    def flush_best_effort(self, timeout: float = 2.0) -> None:
        """Bounded-time flush for paths that must never block (the
        watchdog's hard-exit ladder): the write runs on a daemon side
        thread and is abandoned after ``timeout`` — a hung filesystem
        must not wedge the thread whose whole job is converting hangs
        into clean exits."""
        t = threading.Thread(target=self.flush, daemon=True)
        t.start()
        t.join(timeout)

    def close(self) -> None:
        self.flush()
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- publishing -------------------------------------------------------

    def emit(self, ev: str, **fields) -> None:
        t = round(self._t_off + time.monotonic() - self._t0, 6)
        doc = {"t": t, "ev": ev}
        for k, v in fields.items():
            doc[k] = _clean(v)
        line = encode_event(doc) + "\n"
        with self._lock:
            self._buf.append(line)
            self.n_events += 1
            do_flush = len(self._buf) >= FLUSH_EVERY
            self._aggregate(ev, t, doc)
        # NOTE: watchdog_trip is deliberately NOT in the force-flush
        # set — the watchdog thread must never block on a hung
        # filesystem (it uses flush_best_effort instead)
        if do_flush or ev in (
            "level_commit", "superstep_commit", "run_end",
            "checkpoint", "integrity",
        ):
            self.flush()
            # rotation happens only at these committed boundaries, so
            # a generation never splits a level's events mid-window
            if ev in ("level_commit", "superstep_commit"):
                self._maybe_rotate()

    def _maybe_rotate(self) -> None:
        """Rotate ``events.jsonl`` -> ``events.1.jsonl`` (older
        generations shift up) once the active file exceeds the byte
        budget.  Called at level/superstep boundaries only."""
        if (self.path is None or not self.max_bytes
                or self._size < self.max_bytes):
            return
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            base, ext = os.path.splitext(self.path)
            n = 1
            while os.path.exists(f"{base}.{n}{ext}"):
                n += 1
            for i in range(n, 1, -1):
                # the stream is already self-checking per line, so a
                # rotation rename is not a checkpoint commit
                os.replace(f"{base}.{i - 1}{ext}", f"{base}.{i}{ext}")
            if os.path.exists(self.path):
                os.replace(self.path, f"{base}.1{ext}")
            self._size = 0
            self.rotations += 1

    def _aggregate(self, ev: str, t: float, doc: dict) -> None:
        if ev == "dispatch":
            self.dispatches += 1
            self._lvl_dispatches += 1
        elif ev == "fetch":
            self.fetches += 1
            self._lvl_fetches += 1
            self.fetch_wait_s += float(doc.get("s") or 0.0)
            self.fetch_bytes += int(doc.get("b") or 0)
        elif ev == "level_commit":
            self.levels += 1
            self.level_seconds.append(round(t - self._last_boundary, 6))
            self._last_boundary = t
            self.level_new.append(int(doc.get("n_new") or 0))
            self.dispatches_per_level.append(self._lvl_dispatches)
            self.fetches_per_level.append(self._lvl_fetches)
            self._lvl_dispatches = 0
            self._lvl_fetches = 0
            self.slab_cap = int(doc.get("slab_cap") or 0)
            self.distinct = int(doc.get("distinct") or 0)
        elif ev == "compile":
            if doc.get("declared"):
                self.prewarm_compiles += 1
            else:
                self.compiles += 1
            self.compile_s += float(doc.get("s") or 0.0)
        elif ev == "checkpoint":
            self.checkpoints += 1
            self.checkpoint_s += float(doc.get("s") or 0.0)
            self.checkpoint_bytes += int(doc.get("b") or 0)
        elif ev == "grow":
            b = str(doc.get("budget"))
            self.grows[b] = self.grows.get(b, 0) + 1
        elif ev == "redo":
            self.redos += 1
        elif ev == "superstep_commit":
            self.supersteps += 1
            self.superstep_levels += int(doc.get("levels") or 0)
        elif ev == "lock_held":
            self.locks[str(doc.get("name"))] = dict(
                n=int(doc.get("n") or 0),
                wait_s=float(doc.get("wait_s") or 0.0),
                held_s=float(doc.get("held_s") or 0.0),
                max_wait_s=float(doc.get("max_wait_s") or 0.0),
                max_held_s=float(doc.get("max_held_s") or 0.0),
            )
        elif ev == "lock_wait":
            self.lock_waits += 1
            self.lock_wait_s += float(doc.get("wait_s") or 0.0)
        elif ev == "watchdog_arm":
            self.watchdog_armed += 1
        elif ev == "watchdog_trip":
            self.watchdog_trips += 1
        elif ev == "audit":
            self.audit_levels += 1
            self.audit_rows += int(doc.get("rows") or 0)
            self.audit_problems += int(doc.get("problems") or 0)
        elif ev == "retire":
            self.retired += 1
        elif ev == "exchange":
            self.exchange_bytes += int(doc.get("bytes") or 0)
            self.exchange_raw_bytes += int(doc.get("raw") or 0)
        elif ev == "integrity":
            self.integrity_failures += 1
        elif ev == "tier_demote":
            self.tier_demotions += 1
            self.tier_spilled += int(doc.get("n") or 0)
        elif ev == "tier_probe":
            self.tier_probes += 1
            self.tier_probe_lanes += int(doc.get("lanes") or 0)
            self.tier_probe_hits += int(doc.get("hits") or 0)
            self.tier_probe_wait_s += float(doc.get("s") or 0.0)
        elif ev == "program_profile":
            self.programs_profiled += 1
            tag = str(doc.get("tag"))
            tmp = int(doc.get("tmp_b") or 0)
            if tmp > self.program_temp.get(tag, -1):
                self.program_temp[tag] = tmp
            fl = float(doc.get("flops") or 0.0)
            if fl > self.program_flops.get(tag, -1.0):
                self.program_flops[tag] = fl
        elif ev == "buffer":
            self.hbm_buffers[str(doc.get("name"))] = int(
                doc.get("b") or 0
            )
        elif ev == "hbm_budget":
            self.hbm_budget = int(doc.get("b") or 0)
        elif ev == "pre_oom_forecast":
            self.pre_oom_forecasts += 1
            self.last_pre_oom = dict(
                level=doc.get("level"), need=doc.get("need"),
                budget=doc.get("budget"),
            )
        elif ev == "profile_end":
            self.profile_windows += int(doc.get("windows") or 0)
        elif ev == "run_begin":
            self._last_boundary = t

    # -- reporting --------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``--json`` ``telemetry`` block: ``level_seconds``,
        ``dispatches_per_level`` and ``fetch_wait_s`` among it."""
        with self._lock:
            out = dict(
                events=self.n_events,
                file=self.path,
                levels=self.levels,
                level_seconds=list(self.level_seconds),
                level_new=list(self.level_new),
                dispatches=self.dispatches,
                dispatches_per_level=list(self.dispatches_per_level),
                fetches=self.fetches,
                fetches_per_level=list(self.fetches_per_level),
                fetch_wait_s=round(self.fetch_wait_s, 6),
                fetch_bytes=self.fetch_bytes,
                compiles=self.compiles,
                prewarm_compiles=self.prewarm_compiles,
                compile_s=round(self.compile_s, 3),
                checkpoints=self.checkpoints,
                checkpoint_s=round(self.checkpoint_s, 6),
                checkpoint_bytes=self.checkpoint_bytes,
                grows=dict(self.grows),
                redos=self.redos,
                supersteps=self.supersteps,
                superstep_levels=self.superstep_levels,
                levels_per_dispatch=round(
                    self.levels / max(self.dispatches, 1), 3
                ),
                watchdog=dict(
                    armed=self.watchdog_armed, trips=self.watchdog_trips
                ),
                retired=self.retired,
                integrity_failures=self.integrity_failures,
            )
            if self.audit_levels:
                out["audit"] = dict(
                    levels=self.audit_levels, rows=self.audit_rows,
                    problems=self.audit_problems,
                )
            if self.exchange_bytes or self.exchange_raw_bytes:
                out["exchange_bytes"] = self.exchange_bytes
                out["exchange_raw_bytes"] = self.exchange_raw_bytes
            if self.programs_profiled:
                out["programs_profiled"] = self.programs_profiled
                out["program_temp_bytes"] = dict(self.program_temp)
            if self.locks:
                out["locks"] = {k: dict(v) for k, v in self.locks.items()}
            if self.lock_waits:
                out["lock_waits"] = self.lock_waits
                out["lock_wait_s"] = round(self.lock_wait_s, 6)
            if self.rotations:
                out["rotations"] = self.rotations
            if self.profile_windows:
                out["profile_windows"] = self.profile_windows
            if self.hbm_buffers or self.hbm_budget:
                hbm = hbm_gauge(
                    self.hbm_buffers, self.program_temp,
                    self.hbm_budget,
                )
                if self.pre_oom_forecasts:
                    hbm["pre_oom_forecasts"] = self.pre_oom_forecasts
                    hbm["last_pre_oom"] = dict(self.last_pre_oom or {})
                out["hbm"] = hbm
            if self.tier_demotions or self.tier_probes:
                out["tiered"] = dict(
                    demotions=self.tier_demotions,
                    spilled=self.tier_spilled,
                    probes=self.tier_probes,
                    probe_lanes=self.tier_probe_lanes,
                    probe_hits=self.tier_probe_hits,
                    probe_wait_s=round(self.tier_probe_wait_s, 6),
                )
            if self.slab_cap:
                out["slab_cap"] = self.slab_cap
                out["slab_load"] = round(
                    self.distinct / max(self.slab_cap, 1), 4
                )
            return out


# -- publishing hooks (each is a no-op unless a hub is installed) ---------
# The fast path is ONE global read + ONE branch: with telemetry off the
# engines pay nothing measurable per event site.

def emit(ev: str, **fields) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit(ev, **fields)


def run_begin(**fields) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("run_begin", wall=time.time(), **fields)


def run_end(**fields) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("run_end", **fields)


def level_begin(level, frontier) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("level_begin", level=level, frontier=frontier)


def level_commit(level, n_new, distinct, generated,
                 slab_cap: int = 0) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("level_commit", level=level, n_new=n_new,
                 distinct=distinct, generated=generated,
                 slab_cap=slab_cap)


def superstep_begin(**fields) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("superstep_begin", **fields)


def superstep_commit(levels, **fields) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("superstep_commit", levels=levels, **fields)


def dispatch(tag: str) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("dispatch", tag=tag)


def fetch_done(seconds: float, nbytes: int = 0) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("fetch", s=round(seconds, 6), b=nbytes)


def compile_done(seconds: float, declared: bool) -> None:
    """One CUDA-graph capture (``declared``: on the prewarm thread)."""
    hub = CURRENT
    if hub is not None:
        hub.emit("compile", s=round(seconds, 4), declared=declared)


def checkpoint(kind: str, name: str, seconds: float,
               nbytes: int) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("checkpoint", kind=kind, name=name,
                 s=round(seconds, 6), b=nbytes)


def grow(budget: str, to=None) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("grow", budget=budget, to=to)


def redo(budget: str) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("redo", budget=budget)


def watchdog_arm(context: str, budget: float) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("watchdog_arm", ctx=context, budget=round(budget, 3))


def watchdog_trip(context: str, stage: str) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("watchdog_trip", ctx=context, stage=stage)


def audit(level, rows, problems) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("audit", level=level, rows=rows, problems=problems)


def retire(slot, ok, depth, violation=None) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("retire", slot=slot, ok=ok, depth=depth,
                 violation=violation)


def worker_lifecycle(name: str, status: str, serial: int,
                     **fields) -> None:
    """Pool-membership transition (service/pool.py): register / beat /
    drain / deregister / swept-dead, keyed by the worker's record
    status so a fleet timeline can be reconstructed from the event
    stream alone."""
    hub = CURRENT
    if hub is not None:
        hub.emit("worker", name=name, status=status, serial=serial,
                 **fields)


def exchange(level, nbytes, raw, candidates=0, sieved=0) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("exchange", level=level, bytes=nbytes, raw=raw,
                 candidates=candidates, sieved=sieved)


def skew(level, value) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("skew", level=level, skew=round(float(value), 4))


def shape(reason: str) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("shape", reason=reason)


def integrity(what: str) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("integrity", what=what)


def tier_demote(level, n, gen, seconds, cold: bool = False) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("tier_demote", level=level, n=n, gen=gen,
                 s=round(seconds, 6), cold=cold)


def tier_probe(level, lanes, hits, sieve: int = 0,
               wait_s: float = 0.0) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("tier_probe", level=level, lanes=lanes, hits=hits,
                 sieve=sieve, s=round(wait_s, 6))


def tier_compact(level, runs, n, seconds) -> None:
    """One LSM generation merge (store/tiered.py _maybe_compact):
    ``runs`` cold runs folded into one ``n``-fingerprint sorted run
    (+ its bloom side-car) in ``seconds`` of host wall."""
    hub = CURRENT
    if hub is not None:
        hub.emit("tier_compact", level=level, runs=runs, n=n,
                 s=round(seconds, 6))


def sieve_refresh(level, words, n_added, fp_rate) -> None:
    """The engine re-uploaded the spill sieve to the device (a demotion
    bumped the host filter's version): filter size, keys added, and the
    predicted false-positive rate at the new load."""
    hub = CURRENT
    if hub is not None:
        hub.emit("sieve_refresh", level=level, words=int(words),
                 n=int(n_added), fp_rate=round(float(fp_rate), 6))


def sieve_stop(level, hits) -> None:
    """A resident superstep stopped on in-kernel sieve hits (FLAG_TIER):
    the stopped level replays per-level through the exact generation
    probe.  ``hits`` is the device-counted filter-hit lanes (true
    revisits + false positives; the replay's tier_probe event tells
    them apart), or -1 when the stop path did not fetch the count (the
    superstep control vector carries only the FLAG_TIER bit)."""
    hub = CURRENT
    if hub is not None:
        hub.emit("sieve_stop", level=level, hits=int(hits))


def fseg_page(token, rows, seconds) -> None:
    """One spilled frontier segment paged back from the warm tier
    (store/tiered.py FrontierPager.load); the matching spill is already
    visible as the ``checkpoint`` event its ``kind="fseg"`` commit
    emits."""
    hub = CURRENT
    if hub is not None:
        hub.emit("fseg_page", token=int(token), rows=int(rows),
                 s=round(seconds, 6))


def program_profile(tag: str, **metrics) -> None:
    """One program's cost/memory ledger (flops, bytes accessed,
    argument/output/temp/code bytes), once per program shape (the
    analysis ledgers that publish it are not ported yet)."""
    hub = CURRENT
    if hub is not None:
        hub.emit("program_profile", tag=tag, **metrics)


def buffer(name: str, nbytes) -> None:
    """Register/resize one long-lived device buffer (the HBM gauge):
    the newest ``b`` per name wins — emit 0 to retire a buffer."""
    hub = CURRENT
    if hub is not None:
        hub.emit("buffer", name=name, b=int(nbytes))


def hbm_budget(nbytes) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("hbm_budget", b=int(nbytes))


def pre_oom(level, need_bytes, budget_bytes, **fields) -> None:
    """The forecast next level's working set would bust the device
    budget — the predictive twin of the reactive overflow-redo."""
    hub = CURRENT
    if hub is not None:
        hub.emit("pre_oom_forecast", level=level, need=int(need_bytes),
                 budget=int(budget_bytes), **fields)


def profile_begin(trace_dir: str, windows: int, **fields) -> None:
    """One profiler window opened: ``fields`` carry the trace's clock
    anchor (analysis/devprof.py), so its lanes land on the hub's clock."""
    hub = CURRENT
    if hub is not None:
        hub.emit("profile_begin", dir=trace_dir, windows=windows, **fields)


def profile_end(trace_dir: str, windows: int) -> None:
    hub = CURRENT
    if hub is not None:
        hub.emit("profile_end", dir=trace_dir, windows=windows)
