"""Service metrics: counters, gauges, histograms + atomic snapshots (the
port's copy of ``tla_raft_tpu/obs/metrics.py``).

The sweep-service daemon keeps one :class:`Metrics` registry and
commits its snapshot to ``<root>/metrics.json`` each scheduler pass
through the resilience layer's atomic JSON writer (tmp -> digest ->
rename -> manifest), so a metrics read never sees a torn document and
a scrape survives the daemon dying mid-pass.  ``service status
--metrics`` renders it.

Host-pure; ``resilience`` is imported lazily inside :meth:`Metrics.commit`
(a stdlib-only module import).
"""

from __future__ import annotations

import threading
import time

METRICS_NAME = "metrics.json"
SCHEMA = "tla-raft-metrics/1"


class Counter:
    """Monotonic event count."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)

    def set(self, v) -> None:
        """Adopt an externally-accumulated total (the scheduler's
        stats dict counts some events itself)."""
        self.value = int(v)


class Gauge:
    """Last-written value."""

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary: count/sum/min/max (+ mean in the snapshot)."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> dict:
        return dict(
            count=self.count,
            sum=round(self.sum, 6),
            min=self.min,
            max=self.max,
            mean=round(self.sum / self.count, 6) if self.count else None,
        )


class Metrics:
    """Named metric registry -> JSON snapshot -> atomic commit."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self._t0 = time.time()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self.histograms.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                schema=SCHEMA,
                wall=round(time.time(), 3),
                uptime_s=round(time.time() - self._t0, 3),
                counters={k: c.value for k, c in
                          sorted(self.counters.items())},
                gauges={k: g.value for k, g in
                        sorted(self.gauges.items())},
                histograms={k: h.summary() for k, h in
                            sorted(self.histograms.items())},
            )

    def commit(self, root: str, name: str = METRICS_NAME) -> str:
        """Atomically commit the snapshot to ``<root>/<name>``."""
        from .. import resilience

        return resilience.commit_json(
            root, name, self.snapshot(), kind="metrics",
        )


def load(root: str, name: str = METRICS_NAME) -> dict | None:
    """Digest-verified read side of :meth:`Metrics.commit`."""
    from .. import resilience

    return resilience.load_json_verified(root, name)


def render(doc: dict, out=None) -> None:
    """Human table for ``service status --metrics``."""
    import sys

    out = out if out is not None else sys.stdout
    if not doc:
        print("no metrics.json (daemon not started?)", file=out)
        return
    print(
        f"metrics @ {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(doc.get('wall', 0)))}"
        f" (uptime {doc.get('uptime_s', 0):.0f}s)",
        file=out,
    )
    for k, v in (doc.get("counters") or {}).items():
        print(f"  {k:>28}: {v}", file=out)
    for k, v in (doc.get("gauges") or {}).items():
        print(f"  {k:>28}: {v:g}", file=out)
    for k, h in (doc.get("histograms") or {}).items():
        if h.get("count"):
            print(
                f"  {k:>28}: n={h['count']} mean={h['mean']:g} "
                f"min={h['min']:g} max={h['max']:g}",
                file=out,
            )
        else:
            print(f"  {k:>28}: n=0", file=out)
