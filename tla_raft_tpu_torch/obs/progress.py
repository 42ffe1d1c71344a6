"""Live progress line + fixpoint ETA forecasting (the port's copy of
``tla_raft_tpu/obs/progress.py``).

``check.py --progress`` renders one carriage-return-updated status line
per committed level:

    level 9  frontier 12,408  distinct 54,201  3,412 st/s  slab 31%
    2.8 lvl/disp  ETA 0:48

The ETA comes from the level-size trend: BFS frontiers of these state
spaces grow geometrically, peak, then decay toward the fixpoint.  Once
the growth ratio decays, the remaining states are forecast by
projecting the ratio's own decay forward (a second-order geometric
model — the same shape engine/forecast.py fits for capacity planning)
and dividing by the observed steady states/second.  While the frontier
is still growing with no decay signal, the honest answer is "unknown"
(rendered ``ETA —``).

Host-only and dependency-free: arithmetic over the stats dicts the
engine already publishes, plus the telemetry hub's aggregate snapshot
when one is installed.
"""

from __future__ import annotations

import sys

# forecast horizon: project at most this many future levels (a model
# that needs more is extrapolating noise — report unknown instead)
MAX_HORIZON = 64


def forecast_remaining_states(level_sizes) -> float | None:
    """Forecast NEW states still to be found before the fixpoint.

    Second-order geometric projection: with recent level sizes
    ``..., a, b, c`` the growth ratio is ``r = c/b`` and its per-level
    decay ``d = (c/b)/(b/a)`` (clamped to <= 1 — acceleration is not a
    convergence signal).  Future sizes are ``c*r*d, c*r*d^2*r*d,
    ...`` summed until they fall below one state.  Returns None while
    the trend gives no finite forecast (still growing, too few
    levels).
    """
    s = [float(x) for x in level_sizes if x and x > 0]
    if len(s) < 3:
        return None
    a, b, c = s[-3], s[-2], s[-1]
    r = c / b
    d = min((c / b) / (b / a), 1.0) if a > 0 else 1.0
    if r >= 1.0 and d >= 1.0:
        return None  # still growing, no decay signal yet
    rem, size = 0.0, c
    for _ in range(MAX_HORIZON):
        r *= d
        size *= r
        if size < 1.0:
            break
        rem += size
    else:
        if r >= 1.0:
            return None  # never converged inside the horizon
        # slow but subcritical decay: close the geometric tail
        rem += size * r / (1.0 - r)
    return rem


def eta_seconds(level_sizes, rate: float) -> float | None:
    """Seconds to fixpoint at ``rate`` states/s; None = unknown."""
    rem = forecast_remaining_states(level_sizes)
    if rem is None or rate <= 0:
        return None
    return rem / rate


def fmt_eta(seconds: float | None) -> str:
    if seconds is None:
        return "—"
    seconds = max(0, int(round(seconds)))
    h, rest = divmod(seconds, 3600)
    m, s = divmod(rest, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


class ProgressLine:
    """Render engine progress stats as one live status line.

    Feed it the per-level stats dict the engines already emit
    (``level``/``frontier``/``distinct``/``generated``/``elapsed``);
    it keeps the level-size history for the ETA forecast and reads
    levels/dispatch + slab load off the installed telemetry hub when
    there is one.  ``update()`` returns the rendered line;
    ``write()`` paints it over the previous one (CR, no newline);
    ``clear()`` blanks it (the port's addition: the CLI prints its
    Progress lines to stdout and the log between two paints);
    ``done()`` terminates the line.
    """

    def __init__(self, stream=None, width: int = 100):
        self.stream = stream if stream is not None else sys.stderr
        self.width = width
        self.level_sizes: list[int] = []
        self._painted = False
        self.last_line = ""

    def update(self, stats: dict, snap: dict | None = None) -> str:
        if snap is None:
            from . import telemetry

            hub = telemetry.current()
            snap = hub.snapshot() if hub is not None else None
        lvl = stats.get("level", 0)
        frontier = int(stats.get("frontier", 0))
        distinct = int(stats.get("distinct", 0))
        elapsed = float(stats.get("elapsed", 0.0)) or 1e-9
        self.level_sizes.append(frontier)
        rate = distinct / elapsed
        parts = [
            f"level {lvl}",
            f"frontier {frontier:,}",
            f"distinct {distinct:,}",
            f"{rate:,.0f} st/s",
        ]
        if snap:
            if snap.get("slab_cap"):
                parts.append(f"slab {100 * snap['slab_load']:.0f}%")
            if snap.get("dispatches"):
                parts.append(f"{snap['levels_per_dispatch']:.2f} lvl/disp")
            hbm = snap.get("hbm") or {}
            if hbm.get("budget_bytes"):
                # live device-memory gauge vs the --dev-bytes budget;
                # the pre-OOM forecast flags the line before the
                # reactive overflow machinery would trip
                parts.append(f"hbm {100 * hbm.get('used_frac', 0):.0f}%")
                if hbm.get("pre_oom_forecasts"):
                    parts.append("PRE-OOM")
            elif hbm.get("working_set_bytes"):
                parts.append(
                    f"hbm {hbm['working_set_bytes'] / 1e6:.0f}MB"
                )
        if "configs_alive" in stats:  # service bucket progress
            parts.append(f"{stats['configs_alive']} cfg alive")
        parts.append(
            f"ETA {fmt_eta(eta_seconds(self.level_sizes, rate))}"
        )
        self.last_line = "  ".join(parts)[: self.width]
        return self.last_line

    def write(self, stats: dict, snap: dict | None = None) -> None:
        line = self.update(stats, snap)
        pad = " " * max(0, self.width - len(line))
        self.stream.write("\r" + line + pad)
        self.stream.flush()
        self._painted = True

    def clear(self) -> None:
        """Blank the painted line (before another stream prints a line of
        its own to the same terminal); ``write`` paints it again."""
        if self._painted:
            self.stream.write("\r" + " " * self.width + "\r")
            self.stream.flush()
            self._painted = False

    def done(self) -> None:
        if self._painted:
            self.stream.write("\n")
            self.stream.flush()
            self._painted = False
